"""Uniform bucket grids for nearest-point queries (counterpart of
``meshfem_tpu/mesh/collision_grid.py``; parity with the reference
library's ``CollisionGrid.hh``, the sparse hashed grid of periodic node
matching, and ``DenseCollisionGrid.hh``): host numpy, exact nearest point
within a radius, batched queries, the reference's algorithm line for
line."""

from __future__ import annotations

import numpy as np


class CollisionGrid:
    """Sparse hashed uniform grid over points (nearest / radius queries)."""

    def __init__(self, points, cell_size: float | None = None):
        self.P = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n, d = self.P.shape
        lo = self.P.min(axis=0)
        hi = self.P.max(axis=0)
        if cell_size is None:
            vol = max(np.prod(np.maximum(hi - lo, 1e-12)), 1e-300)
            cell_size = (vol / max(n, 1)) ** (1.0 / d) + 1e-12
        self.h = cell_size
        self.lo = lo - 0.5 * cell_size
        keys = self._cell(self.P)
        order = np.lexsort(keys.T[::-1])
        self._sorted = order
        self._keys = keys[order]
        # bucket start offsets via unique rows
        uniq, start = np.unique(self._keys, axis=0, return_index=True)
        self._uniq = uniq
        self._start = np.sort(start)
        self._bucket = {tuple(k): (s, e) for k, s, e in zip(
            self._keys[self._start],
            self._start,
            np.append(self._start[1:], n))}

    def _cell(self, q):
        return np.floor((np.atleast_2d(q) - self.lo) / self.h).astype(
            np.int64)

    def _candidates(self, q):
        c = self._cell(q)[0]
        d = self.P.shape[1]
        out = []
        import itertools

        for off in itertools.product((-1, 0, 1), repeat=d):
            se = self._bucket.get(tuple(c + np.asarray(off)))
            if se:
                out.append(self._sorted[se[0]:se[1]])
        return np.concatenate(out) if out else np.empty(0, dtype=np.int64)

    def closest_point(self, q, max_dist: float = np.inf):
        """(index, distance) of the nearest stored point; index -1 if none
        within max_dist (and beyond one cell ring)."""
        cand = self._candidates(q)
        if len(cand) == 0:
            # fall back to brute force
            cand = np.arange(len(self.P))
        d2 = ((self.P[cand] - np.asarray(q)) ** 2).sum(axis=1)
        i = int(np.argmin(d2))
        dist = float(np.sqrt(d2[i]))
        if dist > max_dist:
            return -1, dist
        return int(cand[i]), dist

    def match_points(self, Q, eps: float):
        """[len(Q)] indices of stored points within eps of each query
        (-1 where unmatched) — the periodic matcher primitive."""
        out = np.full(len(Q), -1, dtype=np.int64)
        for i, q in enumerate(np.atleast_2d(Q)):
            j, d = self.closest_point(q, max_dist=eps)
            out[i] = j
        return out


class DenseCollisionGrid:
    """Dense bucketed grid over a bounding box (element bboxes -> cells),
    for closest-element candidate generation (``DenseCollisionGrid.hh``)."""

    def __init__(self, boxes_lo, boxes_hi, resolution: int = 16):
        self.lo = np.asarray(boxes_lo).min(axis=0) - 1e-12
        hi = np.asarray(boxes_hi).max(axis=0) + 1e-12
        self.res = resolution
        self.h = (hi - self.lo) / resolution
        from collections import defaultdict

        cells_lo = np.clip(((boxes_lo - self.lo) / self.h).astype(int), 0,
                           resolution - 1)
        cells_hi = np.clip(((boxes_hi - self.lo) / self.h).astype(int), 0,
                           resolution - 1)
        self.buckets = defaultdict(list)
        import itertools

        for e in range(len(cells_lo)):
            rngs = [range(cells_lo[e, d], cells_hi[e, d] + 1)
                    for d in range(len(self.h))]
            for c in itertools.product(*rngs):
                self.buckets[c].append(e)

    def candidates(self, q):
        c = tuple(np.clip(((np.asarray(q) - self.lo) / self.h).astype(int),
                          0, self.res - 1))
        return np.asarray(self.buckets.get(c, []), dtype=np.int64)
