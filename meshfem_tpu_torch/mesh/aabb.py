"""AABB tree (BVH) over mesh elements: closest-point and ray-intersection
queries (counterpart of ``meshfem_tpu/mesh/aabb.py``; parity with the
reference library's vendored libigl subset, ``libigl_aabb/AABB.h``:
point_simplex_squared_distance, ray-mesh intersect).  Host numpy, the
reference's algorithm line for line: these are set-up and I/O queries; bulk
sampling takes the bucket-grid ``analysis.field_sampler.FieldSampler``."""

from __future__ import annotations

import numpy as np


class AABBTree:
    """Median-split BVH over the elements of (V, F) (triangles [m, 3] in
    2D/3D or tets [m, 4])."""

    def __init__(self, V, F, leaf_size: int = 8):
        self.V = np.asarray(V, dtype=np.float64)
        self.F = np.asarray(F)
        X = self.V[self.F]                       # [m, k, d]
        self.lo_e = X.min(axis=1)
        self.hi_e = X.max(axis=1)
        cent = X.mean(axis=1)
        m = len(self.F)
        # nodes as arrays: box lo/hi, children (-1 -> leaf), element ranges
        self.nodes_lo, self.nodes_hi = [], []
        self.left, self.right = [], []
        self.start, self.count = [], []
        self.order = np.arange(m)
        self._build(0, m, cent, leaf_size)
        self.nodes_lo = np.asarray(self.nodes_lo)
        self.nodes_hi = np.asarray(self.nodes_hi)
        self.left = np.asarray(self.left)
        self.right = np.asarray(self.right)
        self.start = np.asarray(self.start)
        self.count = np.asarray(self.count)

    def _build(self, a, b, cent, leaf_size) -> int:
        idx = self.order[a:b]
        lo = self.lo_e[idx].min(axis=0)
        hi = self.hi_e[idx].max(axis=0)
        node = len(self.nodes_lo)
        self.nodes_lo.append(lo)
        self.nodes_hi.append(hi)
        self.left.append(-1)
        self.right.append(-1)
        self.start.append(a)
        self.count.append(b - a)
        if b - a <= leaf_size:
            return node
        axis = int(np.argmax(hi - lo))
        key = cent[idx][:, axis]
        order = np.argsort(key, kind="stable")
        self.order[a:b] = idx[order]
        mid = a + (b - a) // 2
        l = self._build(a, mid, cent, leaf_size)
        r = self._build(mid, b, cent, leaf_size)
        self.left[node] = l
        self.right[node] = r
        return node

    # -- closest point ----------------------------------------------------
    @staticmethod
    def _closest_on_simplex(X, p):
        """Closest point to p on the simplex with corners X [k, d] (exact
        for segments/triangles; tets fall back to face recursion)."""
        k = len(X)
        if k == 1:
            return X[0]
        if k == 2:
            d = X[1] - X[0]
            t = np.clip(np.dot(p - X[0], d) / max(np.dot(d, d), 1e-300),
                        0.0, 1.0)
            return X[0] + t * d
        if k == 3:
            # Ericson's closest-point-on-triangle
            a, b, c = X
            ab, ac, ap = b - a, c - a, p - a
            d1, d2 = np.dot(ab, ap), np.dot(ac, ap)
            if d1 <= 0 and d2 <= 0:
                return a
            bp = p - b
            d3, d4 = np.dot(ab, bp), np.dot(ac, bp)
            if d3 >= 0 and d4 <= d3:
                return b
            vc = d1 * d4 - d3 * d2
            if vc <= 0 and d1 >= 0 and d3 <= 0:
                return a + ab * (d1 / (d1 - d3))
            cp = p - c
            d5, d6 = np.dot(ab, cp), np.dot(ac, cp)
            if d6 >= 0 and d5 <= d6:
                return c
            vb = d5 * d2 - d1 * d6
            if vb <= 0 and d2 >= 0 and d6 <= 0:
                return a + ac * (d2 / (d2 - d6))
            va = d3 * d6 - d5 * d4
            if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
                return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)))
            denom = 1.0 / (va + vb + vc)
            return a + ab * (vb * denom) + ac * (vc * denom)
        # tet: inside test then faces
        M = (X[1:] - X[0]).T
        try:
            lam = np.linalg.solve(M, p - X[0])
            if (lam >= -1e-12).all() and lam.sum() <= 1 + 1e-12:
                return p.copy()
        except np.linalg.LinAlgError:
            pass
        best, bd = None, np.inf
        for f in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            q = AABBTree._closest_on_simplex(X[list(f)], p)
            d2 = np.dot(p - q, p - q)
            if d2 < bd:
                best, bd = q, d2
        return best

    def _box_dist2(self, node, p):
        d = np.maximum(np.maximum(self.nodes_lo[node] - p,
                                  p - self.nodes_hi[node]), 0.0)
        return float(np.dot(d, d))

    def closest_point(self, p):
        """(element index, closest point, squared distance) for point p."""
        p = np.asarray(p, dtype=np.float64)
        best = (-1, None, np.inf)
        stack = [(self._box_dist2(0, p), 0)]
        import heapq

        heapq.heapify(stack)
        while stack:
            d2, node = heapq.heappop(stack)
            if d2 >= best[2]:
                continue
            if self.left[node] < 0:
                a, c = self.start[node], self.count[node]
                for e in self.order[a:a + c]:
                    q = self._closest_on_simplex(self.V[self.F[e]], p)
                    dd = float(np.dot(p - q, p - q))
                    if dd < best[2]:
                        best = (int(e), q, dd)
            else:
                for ch in (self.left[node], self.right[node]):
                    dd = self._box_dist2(ch, p)
                    if dd < best[2]:
                        heapq.heappush(stack, (dd, int(ch)))
        return best

    def closest_points(self, P):
        """Vector version: ([q] element ids, [q, d] points, [q] dist2)."""
        P = np.atleast_2d(P)
        es = np.empty(len(P), dtype=np.int64)
        qs = np.empty_like(P, dtype=np.float64)
        ds = np.empty(len(P))
        for i, p in enumerate(P):
            e, q, d2 = self.closest_point(p)
            es[i], qs[i], ds[i] = e, q, d2
        return es, qs, ds

    # -- ray intersection --------------------------------------------------
    def _ray_box(self, node, o, inv_d):
        t1 = (self.nodes_lo[node] - o) * inv_d
        t2 = (self.nodes_hi[node] - o) * inv_d
        tmin = np.minimum(t1, t2).max()
        tmax = np.maximum(t1, t2).min()
        return tmin, tmax

    @staticmethod
    def _ray_tri(o, d, X, eps=1e-12):
        """Moeller-Trumbore: (t, u, v) or None."""
        e1 = X[1] - X[0]
        e2 = X[2] - X[0]
        h = np.cross(d, e2)
        a = np.dot(e1, h)
        if abs(a) < eps:
            return None
        f = 1.0 / a
        s = o - X[0]
        u = f * np.dot(s, h)
        if u < -eps or u > 1 + eps:
            return None
        q = np.cross(s, e1)
        v = f * np.dot(d, q)
        if v < -eps or u + v > 1 + eps:
            return None
        t = f * np.dot(e2, q)
        if t < eps:
            return None
        return t, u, v

    def ray_intersect(self, origin, direction):
        """First hit of a ray with a TRIANGLE mesh:
        (element, t, (u, v) barycentric of corners 1/2) or None."""
        if self.F.shape[1] != 3:
            raise ValueError("ray_intersect requires a triangle mesh")
        o = np.asarray(origin, dtype=np.float64)
        d = np.asarray(direction, dtype=np.float64)
        d = d / np.linalg.norm(d)
        with np.errstate(divide="ignore"):
            inv_d = 1.0 / np.where(d == 0, 1e-300, d)
        best = None
        stack = [0]
        while stack:
            node = stack.pop()
            tmin, tmax = self._ray_box(node, o, inv_d)
            if tmax < max(tmin, 0.0) or (best is not None
                                         and tmin > best[1]):
                continue
            if self.left[node] < 0:
                a, c = self.start[node], self.count[node]
                for e in self.order[a:a + c]:
                    hit = self._ray_tri(o, d, self.V[self.F[e]])
                    if hit and (best is None or hit[0] < best[1]):
                        best = (int(e), hit[0], (hit[1], hit[2]))
            else:
                stack.append(int(self.left[node]))
                stack.append(int(self.right[node]))
        return best
