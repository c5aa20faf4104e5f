"""Plain NumPy mesh work of the reference: the P2 nodes of a tetrahedral
mesh, its boundary triangles, the periodic identification of a unit cell,
and the match of another program's nodes to these by position.

Nothing here reads the program under test: every array is worked out
again from the vertices and tetrahedra the benchmark made.

Local P2 node order (the reference's own): the four vertices, then the
edge midpoints of the edges ``EDGES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


@dataclasses.dataclass
class P2Mesh:
    V: np.ndarray            # [nv, 3] float64 vertices
    T: np.ndarray            # [E, 4] int64 tetrahedra
    nodes: np.ndarray        # [N, 3] float64: vertices, then edge midpoints
    elem_nodes: np.ndarray   # [E, 10] int64, local order: vertices, EDGES
    edge_ends: np.ndarray    # [N - nv, 2] int64 vertex pair of each edge node

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)


def p2_mesh(V, T, dtype=np.float64) -> P2Mesh:
    """Number the edges of ``T`` once each (sorted vertex pairs, in
    lexicographic order) and place a node at each midpoint, in
    ``dtype``."""
    V = np.asarray(V, dtype=dtype)
    T = np.asarray(T, dtype=np.int64)
    nv = len(V)
    a = np.stack([T[:, i] for i, _ in EDGES], axis=1)
    b = np.stack([T[:, j] for _, j in EDGES], axis=1)
    lo, hi = np.minimum(a, b).ravel(), np.maximum(a, b).ravel()
    keys, inverse = np.unique(lo * nv + hi, return_inverse=True)
    ends = np.stack([keys // nv, keys % nv], axis=1)
    mids = 0.5 * (V[ends[:, 0]] + V[ends[:, 1]])
    elem_nodes = np.concatenate([T, nv + inverse.reshape(len(T), 6)], axis=1)
    return P2Mesh(V, T, np.concatenate([V, mids]), elem_nodes, ends)


def boundary_triangles(T) -> np.ndarray:
    """[B, 3] vertex triples of the faces that belong to one tetrahedron
    only (orientation not kept)."""
    T = np.asarray(T, dtype=np.int64)
    faces = np.concatenate([T[:, [1, 2, 3]], T[:, [0, 2, 3]],
                            T[:, [0, 1, 3]], T[:, [0, 1, 2]]])
    s = np.sort(faces, axis=1)
    nv = int(T.max()) + 1
    key = (s[:, 0] * nv + s[:, 1]) * nv + s[:, 2]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    return s[first[counts == 1]]


def face_edge_nodes(mesh: P2Mesh, tri) -> np.ndarray:
    """[B, 3] node ids of the edge midpoints of triangles ``tri`` [B, 3]."""
    nv = len(mesh.V)
    keys = mesh.edge_ends[:, 0] * nv + mesh.edge_ends[:, 1]
    out = []
    for i, j in ((0, 1), (1, 2), (0, 2)):
        lo = np.minimum(tri[:, i], tri[:, j])
        hi = np.maximum(tri[:, i], tri[:, j])
        pos = np.searchsorted(keys, lo * nv + hi)
        if not np.array_equal(keys[np.minimum(pos, len(keys) - 1)],
                              lo * nv + hi):
            raise ValueError("a boundary edge is not an edge of the mesh")
        out.append(nv + pos)
    return np.stack(out, axis=1)


def periodic_dofs(points, lo=0.0, hi=1.0, eps=1e-9):
    """Identify the nodes of a cell [lo, hi]^3 across opposite faces:
    each coordinate on the far face is moved onto the near one, and nodes
    at one position share a dof.  Returns (dof of each node [N], number
    of dofs)."""
    p = np.asarray(points, dtype=np.float64).copy()
    p[np.abs(p - hi) <= eps] = lo
    keys = np.round(p / 1e-9).astype(np.int64)
    _, dof = np.unique(keys, axis=0, return_inverse=True)
    dof = dof.reshape(-1)
    return dof, int(dof.max()) + 1


def _keys(q):
    """One int64 key a point of a grid of cells [M, 3] int64."""
    q = q - q.min(axis=0) + 1
    span = q.max(axis=0) + 2
    return (q[:, 0] * span[1] + q[:, 1]) * span[2] + q[:, 2], span


def match_nodes(ref_points, other_points, quantum=1e-7, reach=1e-4):
    """Pair the nodes of another numbering with these by position.

    Returns (perm, gap): ``perm[i]`` is the reference node nearest
    ``other_points[i]``, and ``gap`` the largest distance between paired
    positions (``inf`` when the pairing is not one to one, or a point has
    no reference node within ``reach``).  Points equal to within
    ``quantum`` pair at once; the rest search the neighbouring cells of a
    grid of pitch ``reach``."""
    ref = np.asarray(ref_points, dtype=np.float64)
    oth = np.asarray(other_points, dtype=np.float64)
    if ref.shape != oth.shape:
        return None, float("inf")
    qr = np.round(ref / quantum).astype(np.int64)
    qo = np.round(oth / quantum).astype(np.int64)
    sr = np.lexsort(qr.T[::-1])
    so = np.lexsort(qo.T[::-1])
    if np.array_equal(qr[sr], qo[so]) and (np.diff(qr[sr], axis=0) != 0).any(
            axis=1).all():
        perm = np.empty(len(oth), dtype=np.int64)
        perm[so] = sr
    else:
        lo = np.minimum(ref.min(axis=0), oth.min(axis=0)) - 2 * reach
        cr = np.floor((ref - lo) / reach).astype(np.int64)
        co = np.floor((oth - lo) / reach).astype(np.int64)
        kr, span = _keys(np.concatenate([cr, co]))
        kr, ko = kr[:len(ref)], kr[len(ref):]
        order = np.argsort(kr)
        ks = kr[order]
        if len(ks) > 1 and (np.diff(ks) == 0).any():
            return None, float("inf")         # two nodes within ``reach``
        best = np.full(len(oth), np.inf)
        perm = np.full(len(oth), -1, dtype=np.int64)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    k = ko + (dx * span[1] + dy) * span[2] + dz
                    pos = np.minimum(np.searchsorted(ks, k), len(ks) - 1)
                    hit = ks[pos] == k
                    cand = order[pos]
                    d = np.where(hit, np.abs(ref[cand] - oth).max(axis=1),
                                 np.inf)
                    better = d < best
                    best[better], perm[better] = d[better], cand[better]
        if (perm < 0).any() or len(np.unique(perm)) != len(perm):
            return None, float("inf")
    gap = float(np.abs(ref[perm] - oth).max()) if len(oth) else 0.0
    return perm, gap
