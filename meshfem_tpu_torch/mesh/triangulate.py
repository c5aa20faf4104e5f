"""PSLG triangulation (counterpart of ``meshfem_tpu/mesh/triangulate.py``;
parity with the reference library's ``Triangulate.h``, which wraps
Shewchuk's Triangle, and ``Meshing.hh``'s polygon-set triangulation).

The main path is the port's host core's quality constrained Delaunay
triangulator (Ruppert refinement, ``native/hostcore.cpp::
triangulate_ruppert``): a minimum-angle and a maximum-area bound, the input
segments kept exactly, hole seeds, as Triangle's q/a modes.  The same
source, flags and input order give the reference's mesh triangle for
triangle.  A jittered-grid scipy Delaunay approximation is the fallback
when the host core cannot be had (or ``MESHFEM_TORCH_NO_NATIVE=1``)."""

from __future__ import annotations

import numpy as np


def _point_in_polygon(points, poly):
    """Ray casting: [q] bool for points [q, 2] inside polygon [p, 2]."""
    q = np.atleast_2d(points)
    x, y = q[:, 0], q[:, 1]
    inside = np.zeros(len(q), dtype=bool)
    p = np.asarray(poly)
    j = len(p) - 1
    for i in range(len(p)):
        xi, yi = p[i]
        xj, yj = p[j]
        cond = ((yi > y) != (yj > y)) & (
            x < (xj - xi) * (y - yi) / (yj - yi + 1e-300) + xi)
        inside ^= cond
        j = i
    return inside


def _resample_loop(loop, max_len):
    out = []
    n = len(loop)
    for i in range(n):
        a, b = loop[i], loop[(i + 1) % n]
        seg = np.linalg.norm(b - a)
        k = max(1, int(np.ceil(seg / max_len)))
        for t in range(k):
            out.append(a + (b - a) * (t / k))
    return np.asarray(out)


def triangulate_pslg(outline, holes=(), target_area: float = 0.01,
                     interior_jitter: float = 0.3, seed: int = 0,
                     min_angle: float = 20.0, quality: bool = True):
    """Triangulate the region bounded by `outline` (CCW [n, 2]) minus the
    hole polygons (each CW or CCW [m, 2]; a point inside each is treated
    as a hole seed like Triangle's hole markers).

    quality=True uses the native Ruppert CDT (min-angle >= `min_angle`
    degrees, triangle area <= target_area, exact segment conformance).
    Returns (V [n, 2], F [m, 3]) with positively oriented triangles."""
    if quality:
        out = triangulate_pslg_quality(outline, holes, target_area,
                                       min_angle)
        if out is not None:
            return out
    from scipy.spatial import Delaunay

    h = np.sqrt(target_area * 4 / np.sqrt(3))
    outline = np.asarray(outline, dtype=np.float64)
    bpts = [_resample_loop(outline, h)]
    for hole in holes:
        bpts.append(_resample_loop(np.asarray(hole, dtype=np.float64), h))
    boundary = np.vstack(bpts)

    lo, hi = outline.min(axis=0), outline.max(axis=0)
    nx = max(2, int(np.ceil((hi[0] - lo[0]) / h)))
    ny = max(2, int(np.ceil((hi[1] - lo[1]) / h)))
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], nx + 1),
                         np.linspace(lo[1], hi[1], ny + 1), indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
    rng = np.random.default_rng(seed)
    grid = grid + interior_jitter * h * (rng.random(grid.shape) - 0.5)
    # Keep interior points well inside the region and away from boundary.
    keep = _point_in_polygon(grid, outline)
    for hole in holes:
        keep &= ~_point_in_polygon(grid, hole)
    d2b = np.min(
        ((grid[:, None, :] - boundary[None, :, :]) ** 2).sum(-1), axis=1) \
        if len(boundary) * len(grid) < 4e7 else np.full(len(grid), np.inf)
    keep &= d2b > (0.4 * h) ** 2
    pts = np.vstack([boundary, grid[keep]])

    tri = Delaunay(pts)
    F = tri.simplices
    cent = pts[F].mean(axis=1)
    ok = _point_in_polygon(cent, outline)
    for hole in holes:
        ok &= ~_point_in_polygon(cent, hole)
    F = F[ok]
    # Positive orientation.
    X = pts[F]
    a, b = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
    det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    flip = det < 0
    F[flip, 1], F[flip, 2] = F[flip, 2], F[flip, 1].copy()
    from .filters import remove_dangling_vertices

    return remove_dangling_vertices(pts, F)


def _hole_seed(poly):
    """A point strictly inside a simple polygon (centroid of an ear)."""
    p = np.asarray(poly, dtype=np.float64)
    n = len(p)
    for i in range(n):
        a, b, c = p[(i - 1) % n], p[i], p[(i + 1) % n]
        cand = (a + b + c) / 3.0
        if _point_in_polygon(cand[None], p)[0]:
            return cand
    return p.mean(axis=0)


def _valid_triangulation(out, outline, holes, target_area):
    """Output validity gate: non-empty, positive areas, total area
    matching the polygon area minus holes, no oversized triangles.  The
    CDT's orient/in-circle predicates are exact (filtered expansion
    arithmetic, ``hostcore.cpp`` namespace robust), so this is belt and
    braces — kept because a failed gate falls back to the scipy path
    instead of shipping a bad mesh."""
    if out is None:
        return False
    V, F = out
    if len(F) == 0 or len(V) < 3:
        return False
    P = V[F]
    areas = 0.5 * ((P[:, 1, 0] - P[:, 0, 0]) * (P[:, 2, 1] - P[:, 0, 1])
                   - (P[:, 1, 1] - P[:, 0, 1]) * (P[:, 2, 0] - P[:, 0, 0]))
    if areas.min() <= 0:
        return False
    if target_area > 0 and areas.max() > 4.0 * target_area:
        return False

    def poly_area(p):
        p = np.asarray(p, dtype=np.float64)
        x, y = p[:, 0], p[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    want = poly_area(outline) - sum(poly_area(h) for h in holes)
    return abs(float(areas.sum()) - want) <= 1e-6 * max(want, 1e-30)


def triangulate_pslg_quality(outline, holes=(), target_area: float = 0.01,
                             min_angle: float = 20.0):
    """Native Ruppert quality CDT over an outline + hole polygons.
    Returns (V, F), or None when the native library is unavailable or its
    output fails the validity gate (the caller then falls back to the
    scipy path)."""
    from ..native import triangulate_ruppert

    outline = np.asarray(outline, dtype=np.float64)
    pts = [outline]
    segs = []
    base = 0
    for loop in (outline, *[np.asarray(h, dtype=np.float64)
                            for h in holes]):
        n = len(loop)
        segs.extend([(base + i, base + (i + 1) % n) for i in range(n)])
        if base > 0:
            pts.append(loop)
        base += n
    seeds = [_hole_seed(h) for h in holes]
    out = triangulate_ruppert(np.vstack(pts), np.asarray(segs),
                              holes=np.asarray(seeds) if seeds else None,
                              min_angle=min_angle, max_area=target_area)
    if out is not None and not _valid_triangulation(out, outline, holes,
                                                    target_area):
        return None
    return out


def classify_pslg_entities(V, outline, holes=(), eps: float = 1e-9):
    """Link triangulation vertices back to the input PSLG entities
    (``Meshing.hh:559`` PolygonSetTriangulation input-entity links).

    Returns (kind [n], entity [n]):
      kind 0 = input point   (entity = index into the concatenated input
                              point list: outline then holes, in order)
      kind 1 = on an input segment (entity = segment index in the same
                              concatenated loop ordering)
      kind 2 = interior      (entity = -1)
    """
    V = np.asarray(V, dtype=np.float64)
    loops = [np.asarray(outline, dtype=np.float64)] + \
        [np.asarray(h, dtype=np.float64) for h in holes]
    pts = np.vstack(loops)
    segs = []
    base = 0
    for loop in loops:
        n = len(loop)
        segs.extend([(base + i, base + (i + 1) % n) for i in range(n)])
        base += n
    segs = np.asarray(segs)

    kind = np.full(len(V), 2, dtype=np.int64)
    entity = np.full(len(V), -1, dtype=np.int64)
    # input points (exact within eps)
    d2 = ((V[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    j = d2.argmin(axis=1)
    hit = d2[np.arange(len(V)), j] < eps * eps
    kind[hit] = 0
    entity[hit] = j[hit]
    # on-segment (excluding already-matched points)
    rest = np.flatnonzero(~hit)
    if len(rest):
        A = pts[segs[:, 0]]
        B = pts[segs[:, 1]]
        AB = B - A                                    # [m, 2]
        L2 = (AB ** 2).sum(-1)
        P = V[rest]                                   # [q, 2]
        t = ((P[:, None, :] - A[None]) * AB[None]).sum(-1) / np.maximum(
            L2[None], 1e-300)
        t = np.clip(t, 0.0, 1.0)
        proj = A[None] + t[:, :, None] * AB[None]
        dist2 = ((P[:, None, :] - proj) ** 2).sum(-1)
        sj = dist2.argmin(axis=1)
        on = dist2[np.arange(len(rest)), sj] < eps * eps
        kind[rest[on]] = 1
        entity[rest[on]] = sj[on]
    return kind, entity
