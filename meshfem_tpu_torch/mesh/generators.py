"""Procedural meshes (counterpart of ``meshfem_tpu/mesh/generators.py``):
triangulated grids, squares, L-shapes and fan ellipses in 2D; Kuhn box
grids, cubes and cantilever bars in 3D.  All vectorized numpy; each returns
the reference's arrays row for row."""

from __future__ import annotations

import itertools

import numpy as np


def grid_tri(nx: int, ny: int, lo=(0.0, 0.0), hi=(1.0, 1.0),
             diagonal: str = "alternate"):
    """Rectangle [lo, hi] split into (nx, ny) cells, two CCW triangles
    each, cells i-major and j-minor.  ``diagonal``: 'alternate' flips the
    diagonal of cells with i + j odd (a-c instead of b-d); 'right' splits
    every cell along its anti-diagonal b-d.
    Returns (V [n, 2] float64, F [m, 3] int32)."""
    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel()], axis=1)

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    a = ii * (ny + 1) + jj                    # corner (i, j)
    b = a + (ny + 1)                          # (i + 1, j)
    c = b + 1                                 # (i + 1, j + 1)
    d = a + 1                                 # (i, j + 1)
    flip = ((ii + jj) % 2 == 1) if diagonal == "alternate" \
        else np.zeros(len(a), dtype=bool)
    t0 = np.where(flip[:, None], np.stack([a, b, c], 1),
                  np.stack([a, b, d], 1))
    t1 = np.where(flip[:, None], np.stack([a, c, d], 1),
                  np.stack([b, c, d], 1))
    F = np.stack([t0, t1], axis=1).reshape(-1, 3)
    return V, F.astype(np.int32)


def grid_tet(nx: int, ny: int, nz: int, lo=(0.0, 0.0, 0.0),
             hi=(1.0, 1.0, 1.0)):
    """Box [lo, hi] split into (nx, ny, nz) cubes, 6 positively oriented
    Kuhn tets each (conforming across cube faces).
    Returns (V [n, 3] float64, T [m, 4] int32)."""
    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    zs = np.linspace(lo[2], hi[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def off(dx, dy, dz):
        return (dx * (ny + 1) + dy) * (nz + 1) + dz

    # 6 Kuhn tets as corner-offset patterns (paths 000 -> 111), oriented
    # positively on the unit cube once
    patterns = []
    unit = {(dx, dy, dz): np.array([dx, dy, dz], dtype=float)
            for dx, dy, dz in itertools.product((0, 1), repeat=3)}
    for perm in itertools.permutations(range(3)):
        path = [(0, 0, 0)]
        cur = [0, 0, 0]
        for ax in perm:
            cur[ax] = 1
            path.append(tuple(cur))
        pts = np.stack([unit[q] for q in path])
        tet = list(path)
        if np.linalg.det(pts[1:] - pts[0]) < 0:
            tet[2], tet[3] = tet[3], tet[2]
        patterns.append([off(*q) for q in tet])
    patterns = np.asarray(patterns, dtype=np.int64)

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    base = ((ii * (ny + 1) + jj) * (nz + 1) + kk).ravel()
    T = (base[:, None, None] + patterns[None, :, :]).reshape(-1, 4)
    return V, T.astype(np.int32)


def square(n: int = 8, lo=(0.0, 0.0), hi=(1.0, 1.0)):
    return grid_tri(n, n, lo, hi)


def cube(n: int = 4, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)):
    return grid_tet(n, n, n, lo, hi)


def l_shape(n: int = 8):
    """[0, 1]^2 minus (0.5, 1) x (0.5, 1): ``grid_tri(n, n)`` without the
    triangles whose centroid lies in the removed square, vertices renumbered
    in their old order."""
    V, F = grid_tri(n, n)
    cen = V[F].mean(axis=1)
    F2 = F[~((cen[:, 0] > 0.5) & (cen[:, 1] > 0.5))]
    used = np.unique(F2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[F2].astype(np.int32)


def ellipse(na: int = 32, a: float = 1.0, b: float = 0.6):
    """Fan-triangulated ellipse: the centre, then ``na`` rim vertices."""
    theta = np.linspace(0, 2 * np.pi, na, endpoint=False)
    ring = np.stack([a * np.cos(theta), b * np.sin(theta)], axis=1)
    V = np.vstack([[0.0, 0.0], ring])
    i = np.arange(na)
    F = np.stack([np.zeros(na, dtype=np.int64), 1 + i, 1 + (i + 1) % na],
                 axis=1)
    return V, F.astype(np.int32)


def bar_tet(nx: int = 8, ny: int = 2, nz: int = 2, length: float = 4.0,
            width: float = 1.0):
    """Cantilever bar [0, length] x [0, width]^2."""
    return grid_tet(nx, ny, nz, (0, 0, 0), (length, width, width))
