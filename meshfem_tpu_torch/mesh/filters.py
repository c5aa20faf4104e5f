"""Mesh processing filters (counterpart of ``meshfem_tpu/mesh/filters.py``;
parity with the reference library's ``filters/``): subdivide, extrude,
reflect (periodic tiling into 2^d copies), merge duplicate vertices, remove
dangling vertices, remove small components, reorient negative elements,
connected components, boundary polygons and holes, quad and hex
subdivision into simplices, voxels to simplices.  Host numpy and scipy,
the reference's algorithm line for line: the filters that number new
vertices (``np.unique`` of edge keys, the dicts keyed by edges of
``quad_subdiv_high_aspect``) number them in the reference's order, so
vertex and element arrays come out equal to the bit."""

from __future__ import annotations

import numpy as np

from ..fem import simplex


def merge_duplicate_vertices(V, F, eps: float = 0.0):
    """(``filters/merge_duplicate_vertices.hh``)."""
    V = np.asarray(V, dtype=np.float64)
    key = V if eps == 0 else np.round(V / max(eps, 1e-300))
    uniq, index, inverse = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(index)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    V2 = V[index[order]]
    F2 = rank[inverse][np.asarray(F)]
    return V2, F2.astype(np.int64)


def remove_dangling_vertices(V, F):
    """(``filters/remove_dangling_vertices.hh``)."""
    F = np.asarray(F)
    used = np.unique(F)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return np.asarray(V)[used], remap[F]


def reorient_negative_elements(V, F):
    """Flip elements with negative orientation
    (``filters/reorient_negative_elements.hh``)."""
    V = np.asarray(V)
    F = np.asarray(F).copy()
    X = V[F]
    if F.shape[1] == 3 and V.shape[1] == 2:
        a, b = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
        det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    elif F.shape[1] == 4:
        det = np.linalg.det(X[:, 1:] - X[:, :1])
    else:
        return V, F
    neg = det < 0
    F[neg, -1], F[neg, -2] = F[neg, -2], F[neg, -1].copy()
    return V, F


def get_element_components(F):
    """Connected components of elements (shared facet adjacency),
    (``algorithms/get_element_components``)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    F = np.asarray(F)
    K = F.shape[1] - 1
    # elements sharing a vertex are adjacent (coarser but adequate)
    rows = np.repeat(np.arange(len(F)), F.shape[1])
    cols = F.ravel()
    M = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(len(F), F.max() + 1)).tocsr()
    adj = M @ M.T
    n, labels = csgraph.connected_components(adj, directed=False)
    return n, labels


def remove_small_components(V, F, min_elems: int | None = None):
    """Keep the largest component (``filters/remove_small_components.hh``)."""
    n, labels = get_element_components(F)
    if n <= 1:
        return np.asarray(V), np.asarray(F)
    counts = np.bincount(labels)
    if min_elems is None:
        keep = labels == counts.argmax()
    else:
        keep = counts[labels] >= min_elems
    return remove_dangling_vertices(V, np.asarray(F)[keep])


def subdivide(V, F, iterations: int = 1):
    """Uniform 1-to-4 triangle (or 1-to-8 tet) subdivision
    (``filters/subdivide.hh``)."""
    for _ in range(iterations):
        V, F = _subdivide_once(np.asarray(V, dtype=np.float64),
                               np.asarray(F))
    return V, F


def _subdivide_once(V, F):
    K = F.shape[1] - 1
    nv = len(V)
    pairs = np.asarray(simplex.simplex_edges(K))
    ev = np.stack([F[:, pairs[:, 0]], F[:, pairs[:, 1]]], axis=-1)
    ev = ev.reshape(-1, 2)
    key = np.min(ev, axis=1) * nv + np.max(ev, axis=1)
    uniq, inverse = np.unique(key, return_inverse=True)
    mid = 0.5 * (V[uniq // nv] + V[uniq % nv])
    V2 = np.vstack([V, mid])
    em = nv + inverse.reshape(len(F), -1)    # edge midpoint ids per element
    out = []
    if K == 2:
        # corners: (v0, m01, m20), (v1, m12, m01), (v2, m20, m12), center
        m01, m12, m20 = em[:, 0], em[:, 1], em[:, 2]
        v0, v1, v2 = F[:, 0], F[:, 1], F[:, 2]
        out = [np.stack(t, axis=1) for t in (
            (v0, m01, m20), (m01, v1, m12), (m20, m12, v2),
            (m01, m12, m20))]
    else:
        # Tet 1->8 (Freudenthal): 4 corner tets + central octahedron split.
        v = [F[:, i] for i in range(4)]
        # edge order per Simplex: (0,1),(1,2),(2,0),(0,3),(2,3),(1,3)
        m = {(0, 1): em[:, 0], (1, 2): em[:, 1], (0, 2): em[:, 2],
             (0, 3): em[:, 3], (2, 3): em[:, 4], (1, 3): em[:, 5]}
        def M(a, b):
            return m[(min(a, b), max(a, b))]
        corner = [
            (v[0], M(0, 1), M(0, 2), M(0, 3)),
            (M(0, 1), v[1], M(1, 2), M(1, 3)),
            (M(0, 2), M(1, 2), v[2], M(2, 3)),
            (M(0, 3), M(1, 3), M(2, 3), v[3]),
        ]
        # Octahedron: vertices m01 m02 m03 m12 m13 m23, split along m02-m13.
        a, b = M(0, 2), M(1, 3)
        octa = [
            (a, b, M(0, 1), M(0, 3)),
            (a, b, M(0, 3), M(2, 3)),
            (a, b, M(2, 3), M(1, 2)),
            (a, b, M(1, 2), M(0, 1)),
        ]
        out = [np.stack(t, axis=1) for t in corner + octa]
    F2 = np.concatenate(out, axis=0)
    V2, F2 = reorient_negative_elements(V2, F2) if V2.shape[1] == F2.shape[1] - 1 \
        else (V2, F2)
    return V2, F2


def reflect(V, F, axes=None):
    """Reflect into 2^d copies tiling the period cell
    (``filters/reflect.hh``): mesh in [min, max] -> reflected about each
    max-face, producing the full cell for an orthotropic base cell."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F)
    dim = V.shape[1]
    axes = range(dim) if axes is None else axes
    for d in axes:
        hi = V[:, d].max()
        V_ref = V.copy()
        V_ref[:, d] = 2 * hi - V_ref[:, d]
        F_ref = F + len(V)
        V = np.vstack([V, V_ref])
        F = np.vstack([F, F_ref])
        V, F = merge_duplicate_vertices(V, F, eps=1e-12)
        V, F = reorient_negative_elements(V, F)
    return V, F


def extrude(V, F, height: float = 1.0, layers: int = 1):
    """Extrude a 2D triangle mesh into tetrahedra
    (``filters/extrude.hh``): each prism splits into 3 tets with a
    diagonal convention consistent across neighbors."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F)
    n = len(V)
    zs = np.linspace(0.0, height, layers + 1)
    V3 = np.vstack([np.column_stack([V, np.full(n, z)]) for z in zs])
    tets = []
    for layer in range(layers):
        lo = layer * n
        hi = (layer + 1) * n
        for tri in F:
            # global-index-ordered prism split (conforming).
            i, j, k = sorted(tri.tolist())
            a, b, c = lo + i, lo + j, lo + k
            d, e, f = hi + i, hi + j, hi + k
            tets += [(a, b, c, d), (b, c, d, e), (c, d, e, f)]
    T = np.asarray(tets, dtype=np.int64)
    V3, T = reorient_negative_elements(V3, T)
    return V3, T


def voxels_to_simplices(occupancy):
    """Boolean voxel grid [nx, ny, nz] -> tet mesh of occupied cells
    (``filters/voxels_to_simplices.hh``)."""
    from .generators import grid_tet

    occ = np.asarray(occupancy, dtype=bool)
    nx, ny, nz = occ.shape
    V, T = grid_tet(nx, ny, nz, hi=(float(nx), float(ny), float(nz)))
    centers = V[T].mean(axis=1)
    idx = np.floor(centers).astype(int)
    keep = occ[np.clip(idx[:, 0], 0, nx - 1),
               np.clip(idx[:, 1], 0, ny - 1),
               np.clip(idx[:, 2], 0, nz - 1)]
    return remove_dangling_vertices(V, T[keep])


def quad_tri_split_diagonal(V, Q):
    """Quads -> triangles split along the shorter diagonal (convenience;
    see quad_tri_subdiv / quad_tri_subdiv_asymmetric for reference parity)."""
    V = np.asarray(V)
    Q = np.asarray(Q)
    d02 = ((V[Q[:, 0]] - V[Q[:, 2]]) ** 2).sum(1)
    d13 = ((V[Q[:, 1]] - V[Q[:, 3]]) ** 2).sum(1)
    use02 = d02 <= d13
    tris = np.where(
        use02[:, None, None],
        np.stack([Q[:, [0, 1, 2]], Q[:, [0, 2, 3]]], axis=1),
        np.stack([Q[:, [0, 1, 3]], Q[:, [1, 2, 3]]], axis=1))
    return V, tris.reshape(-1, 3)


def hex_tet_subdiv(V, H):
    """Hexahedra -> 6 tets each (``filters/hex_tet_subdiv.hh``), Kuhn
    path subdivision on the hex corner ordering (x-fastest binary)."""
    import itertools

    V = np.asarray(V)
    H = np.asarray(H)
    tets = []
    for perm in itertools.permutations(range(3)):
        path = [0]
        cur = [0, 0, 0]
        for ax in perm:
            cur[ax] = 1
            path.append(cur[0] + 2 * cur[1] + 4 * cur[2])
        tets.append(H[:, path])
    T = np.concatenate(tets, axis=0)
    return reorient_negative_elements(V, T)


def extract_boundary_polygons(mesh):
    """Ordered boundary loops of a triangle mesh
    (``filters/extract_polygons.hh``)."""
    return mesh.cell.boundary_loops()


def highlight_dangling_vertices(V, F):
    used = np.zeros(len(V), dtype=bool)
    used[np.unique(F)] = True
    return np.flatnonzero(~used)


def resample_curve(points, target_len: float, closed: bool = True):
    """Resample a polyline/polygon to roughly uniform segment lengths
    (``filters/ResampleCurve.hh``)."""
    P = np.asarray(points, dtype=np.float64)
    if closed:
        P = np.vstack([P, P[:1]])
    seg = np.linalg.norm(np.diff(P, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    k = max(3, int(round(total / target_len)))
    ts = np.linspace(0.0, total, k, endpoint=not closed) if not closed \
        else np.linspace(0.0, total, k + 1)[:-1]
    out = np.empty((len(ts), P.shape[1]))
    for d in range(P.shape[1]):
        out[:, d] = np.interp(ts, s, P[:, d])
    return out


def curve_cleanup(points, min_len: float = 0.0, collinear_tol: float = 1e-10,
                  closed: bool = True):
    """Remove near-duplicate points and collinear vertices from a curve
    (``filters/CurveCleanup.hh``)."""
    P = np.asarray(points, dtype=np.float64)
    keep = [0]
    for i in range(1, len(P)):
        if np.linalg.norm(P[i] - P[keep[-1]]) > min_len:
            keep.append(i)
    P = P[keep]
    # Drop collinear vertices.
    n = len(P)
    out = []
    for i in range(n):
        a = P[(i - 1) % n] if closed else P[max(i - 1, 0)]
        b = P[i]
        c = P[(i + 1) % n] if closed else P[min(i + 1, n - 1)]
        u, v = b - a, c - b
        cross = u[0] * v[1] - u[1] * v[0]
        if not closed and (i == 0 or i == n - 1):
            out.append(i)
        elif abs(cross) > collinear_tol * max(np.linalg.norm(u)
                                              * np.linalg.norm(v), 1e-300):
            out.append(i)
    return P[out]


# ---------------------------------------------------------------------------
# Quad subdivision family (filters/quad_subdiv.hh, quad_tri_subdiv.hh,
# quad_tri_subdiv_asymmetric.hh, quad_subdiv_high_aspect.hh)
# ---------------------------------------------------------------------------

def _quad_edge_midpoints(V, Q):
    """Unique midpoint vertex per quad edge; returns (V2, mid [m, 4])."""
    e = np.stack([Q, np.roll(Q, -1, axis=1)], axis=-1)      # [m, 4, 2]
    key = np.sort(e.reshape(-1, 2), axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    V2 = np.vstack([V, 0.5 * (V[uniq[:, 0]] + V[uniq[:, 1]])])
    return V2, (len(V) + inv).reshape(Q.shape)


def quad_subdiv(V, Q, quad_idx=None):
    """1 -> 4 quad refinement with shared edge midpoints + center vertex
    (``filters/quad_subdiv.hh``).  Returns (V2, Q2 [4m, 4], quad_idx)."""
    V = np.asarray(V)
    Q = np.asarray(Q)
    m = len(Q)
    quad_idx = np.arange(m) if quad_idx is None else np.asarray(quad_idx)
    V2, mid = _quad_edge_midpoints(V, Q)
    c0 = len(V2)
    V2 = np.vstack([V2, V[Q].mean(axis=1)])
    cen = c0 + np.arange(m)
    out = np.empty((m, 4, 4), dtype=Q.dtype)
    for t in range(4):
        out[:, t, 0] = Q[:, t]
        out[:, t, 1] = mid[:, t]
        out[:, t, 2] = cen
        out[:, t, 3] = mid[:, (t + 3) % 4]
    return V2, out.reshape(-1, 4), np.repeat(quad_idx, 4)


def quad_tri_subdiv(V, Q, quad_idx=None):
    """Symmetric quad -> 4 triangles via a center vertex
    (``filters/quad_tri_subdiv.hh``).  Returns (V2, T [4m, 3], quad_idx)."""
    V = np.asarray(V)
    Q = np.asarray(Q)
    m = len(Q)
    quad_idx = np.arange(m) if quad_idx is None else np.asarray(quad_idx)
    cen = len(V) + np.arange(m)
    V2 = np.vstack([V, V[Q].mean(axis=1)])
    T = np.empty((m, 4, 3), dtype=Q.dtype)
    for t in range(4):
        T[:, t, 0] = Q[:, t]
        T[:, t, 1] = Q[:, (t + 1) % 4]
        T[:, t, 2] = cen
    return V2, T.reshape(-1, 3), np.repeat(quad_idx, 4)


def quad_tri_subdiv_asymmetric(V, Q, quad_idx=None):
    """Quad -> 2 triangles along the 0-2 diagonal
    (``filters/quad_tri_subdiv_asymmetric.hh``)."""
    V = np.asarray(V)
    Q = np.asarray(Q)
    m = len(Q)
    quad_idx = np.arange(m) if quad_idx is None else np.asarray(quad_idx)
    T = np.stack([Q[:, [0, 1, 2]], Q[:, [0, 2, 3]]], axis=1)
    return V, T.reshape(-1, 3), np.repeat(quad_idx, 2)


def quad_subdiv_high_aspect(V, Q, aspect_threshold: float = 2.0,
                            quad_idx=None):
    """Split high-aspect rectangular quads in half across their long axis,
    with BFS conflict resolution so the quad mesh stays conforming
    (``filters/quad_subdiv_high_aspect.hh``).  Returns
    (V2, Q2, quad_idx, subdivided)."""
    import collections

    V = np.asarray(V, dtype=np.float64)
    Q = np.asarray(Q)
    m = len(Q)
    old_idx = np.arange(m) if quad_idx is None else np.asarray(quad_idx)
    if aspect_threshold <= np.sqrt(2) + 1e-8:
        raise ValueError("aspect threshold must be > sqrt(2) for convergence")

    def split_edges(e, sp):
        return (tuple(sorted((e[sp], e[sp + 1]))),
                tuple(sorted((e[sp + 2], e[(sp + 3) % 4]))))

    split_pair = np.full(m, -1, dtype=np.int64)
    want = {}
    for i in range(m):
        e = Q[i]
        l0 = np.linalg.norm(V[e[1]] - V[e[0]])
        l1 = np.linalg.norm(V[e[2]] - V[e[1]])
        if l0 > aspect_threshold * l1:
            split_pair[i] = 0
        elif l1 > aspect_threshold * l0:
            split_pair[i] = 1
        if split_pair[i] < 0:
            continue
        for key in split_edges(e, split_pair[i]):
            want.setdefault(key, []).append(i)

    queue = collections.deque(k for k, v in want.items() if len(v) == 1)
    while queue:
        key = queue.popleft()
        if len(want.get(key, ())) != 1:
            continue
        i = want[key][0]
        if split_pair[i] < 0:
            continue
        for k2 in split_edges(Q[i], split_pair[i]):
            want[k2].remove(i)
            if len(want[k2]) == 1:
                queue.append(k2)
        split_pair[i] = -1

    V2 = list(map(tuple, V))
    midpoint = {}

    def mid_index(key):
        if key not in midpoint:
            midpoint[key] = len(V2)
            V2.append(tuple(0.5 * (V[key[0]] + V[key[1]])))
        return midpoint[key]

    out_q, out_idx = [], []
    subdivided = False
    for i in range(m):
        e, sp = Q[i], split_pair[i]
        if sp < 0:
            out_q.append(list(e))
            out_idx.append(old_idx[i])
            continue
        subdivided = True
        k0, k1 = split_edges(e, sp)
        m0, m1 = mid_index(k0), mid_index(k1)
        mids = (m0, m1)
        for q in range(2):
            out_q.append([e[(2 * q + sp) % 4], mids[q], mids[(q + 1) % 2],
                          e[(2 * q + 3 + sp) % 4]])
            out_idx.append(old_idx[i])
    return (np.asarray(V2), np.asarray(out_q), np.asarray(out_idx),
            subdivided)


# ---------------------------------------------------------------------------
# Boundary / component polygon extraction (filters/extract_hole_boundaries.hh,
# extract_component_polygons.hh)
# ---------------------------------------------------------------------------

def extract_hole_boundaries(V, F):
    """Boundary components EXCLUDING the one incident on the bounding box
    (``filters/extract_hole_boundaries.hh``).  Triangle meshes return
    vertex loops; tet meshes return lists of boundary-face index arrays."""
    from .simplicial import TriMesh, TetMesh

    V = np.asarray(V)
    F = np.asarray(F)
    lo, hi = V.min(axis=0), V.max(axis=0)

    def touches_bbox(pts):
        return bool(np.any(np.abs(pts - lo) < 1e-9)
                    or np.any(np.abs(pts - hi) < 1e-9))

    if F.shape[1] == 3:
        loops = TriMesh.build(V, F).boundary_loops()
        on = [touches_bbox(V[lp]) for lp in loops]
    else:
        tm = TetMesh.build(V, F)
        bf = tm.boundary_faces()                       # [B, 3] vertex ids
        # face adjacency via shared edges
        e = np.stack([bf, np.roll(bf, -1, axis=1)], axis=-1).reshape(-1, 2)
        key = np.sort(e, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        face_of = np.repeat(np.arange(len(bf)), 3)
        adj = [[] for _ in range(len(bf))]
        order = np.argsort(inv, kind="stable")
        s_inv, s_face = inv[order], face_of[order]
        starts = np.searchsorted(s_inv, np.arange(len(uniq)))
        ends = np.searchsorted(s_inv, np.arange(len(uniq)) + 1)
        for a, b in zip(starts, ends):
            fs = s_face[a:b]
            for x in fs:
                for y in fs:
                    if x != y:
                        adj[x].append(y)
        seen = np.zeros(len(bf), dtype=bool)
        loops, on = [], []
        for f0 in range(len(bf)):
            if seen[f0]:
                continue
            comp = [f0]
            seen[f0] = True
            stack = [f0]
            while stack:
                u = stack.pop()
                for v in adj[u]:
                    if not seen[v]:
                        seen[v] = True
                        comp.append(v)
                        stack.append(v)
            comp = np.asarray(comp)
            loops.append(comp)
            on.append(touches_bbox(V[np.unique(bf[comp])]))
    if sum(on) != 1:
        raise ValueError(f"exactly one boundary component should touch the "
                         f"bounding box ({sum(on)} found)")
    return [lp for lp, o in zip(loops, on) if not o]


def extract_component_polygons(V, F, indicator):
    """Per-component closed boundary polylines of an indicator-labeled
    triangle mesh (``filters/extract_component_polygons.hh``).

    indicator [num_tris] int; negative values are skipped.  Returns a list
    of dicts {'exterior': [k] closed ccw vertex loop,
              'holes': list of closed cw loops}."""
    from .simplicial import TriMesh

    V = np.asarray(V)
    F = np.asarray(F)
    ind = np.asarray(indicator)
    if len(ind) != len(F):
        raise ValueError("indicator must be per-triangle")
    tm = TriMesh.build(V, F)
    nt = len(F)

    def is_poly_bdry(h):
        mate = tm.mate(h)
        if mate < 0:                      # mesh boundary (encoded -2-b)
            return True
        f, fo = h // 3, mate // 3
        return ind[f] >= 0 and ind[f] != ind[fo]

    def next_poly_he(h):
        t = tm.next(h)
        while not is_poly_bdry(t):
            t = tm.next(tm.mate(t))
        return t

    tri_seen = np.zeros(nt, dtype=bool)
    he_seen = np.zeros(3 * nt, dtype=bool)
    result = []
    for t0 in range(nt):
        if tri_seen[t0] or ind[t0] < 0:
            continue
        comp_hes = []
        stack = [t0]
        tri_seen[t0] = True
        while stack:
            u = stack.pop()
            for c in range(3):
                h = 3 * u + c
                if is_poly_bdry(h):
                    comp_hes.append(h)
                else:
                    v = tm.mate(h) // 3
                    if not tri_seen[v]:
                        tri_seen[v] = True
                        stack.append(v)
        loops = []
        for h0 in comp_hes:
            if he_seen[h0]:
                continue
            loop = []
            h = h0
            while not he_seen[h]:
                loop.append(int(tm.tail(h)))
                he_seen[h] = True
                h = next_poly_he(h)
            if h != h0:
                raise RuntimeError("boundary loop did not close")
            loop.append(loop[0])
            loops.append(loop)
        poly = {"exterior": None, "holes": []}
        for loop in loops:
            pts = V[np.asarray(loop)]
            area = 0.5 * float(np.sum(
                pts[:-1, 0] * pts[1:, 1] - pts[1:, 0] * pts[:-1, 1]))
            if area > 0:
                if poly["exterior"] is not None:
                    raise ValueError("multiple positive-area boundaries")
                poly["exterior"] = loop
            elif area < 0:
                poly["holes"].append(loop)
            else:
                raise ValueError("zero-area boundary loop")
        if poly["exterior"] is None:
            raise ValueError("no positive-area boundary")
        result.append(poly)
    return result
