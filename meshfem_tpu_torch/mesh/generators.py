"""Procedural tetrahedral box meshes (counterpart of
``meshfem_tpu/mesh/generators.py``: ``grid_tet`` and ``bar_tet``)."""

from __future__ import annotations

import itertools

import numpy as np


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


def bar_tet(nx: int = 8, ny: int = 2, nz: int = 2, length: float = 4.0,
            width: float = 1.0):
    """Cantilever bar [0, length] x [0, width]^2."""
    return grid_tet(nx, ny, nz, (0, 0, 0), (length, width, width))
