"""The one generator of the benchmark's traffic: it reads a traffic file
(``fembench/traffic/<name>.json``) and makes, from it and a seed, the
mesh of the cell and the stream of job parameters.

A traffic file (found by ``spec.Cell.traffic``) holds:

* ``mesh``: ``{"generator": "grid_tet", "n": 36}``, optionally
  ``"jitter"`` (interior vertices moved by up to this share of a grid
  cell, uniformly in each coordinate) with ``"jitter_seed"`` (fixed in
  the file, so every run has one mesh), and ``"void_radius"`` (tets whose
  centroid lies within this distance of the cell's centre removed, the
  vertices renumbered);
* ``jobs``: one entry per job parameter, each a distribution:
  ``{"uniform": [lo, hi]}``, ``{"log_uniform": [lo, hi]}``,
  ``{"power_of_two": [lo, hi]}`` (2^k, k a whole number drawn uniformly
  from lo to hi), ``{"unit_vector": 3}`` (uniform on the sphere), or
  ``{"cycle": [...]}`` (the values in an order drawn from the seed, the
  order drawn anew each time the list is used up);
* ``path``: the solver path every job of the cell must take (checked by
  the configuration's guard).

Every seed gives its own stream; the warm-up job of set-up draws from a
stream of its own, so the window's jobs do not depend on it.

A load or a material scaled by a power of two scales every step of a
linear solve exactly, rounding included, so jobs that differ only so do
the same work; a cycle gives every seed the same set of jobs in another
order.  Where the solvers' float64 refinement stops after a whole round
more or less by rounding alone (a residual that ends a round just above
or below its tolerance), values drawn from a continuum would make each
seed's window a different amount of work.
"""

from __future__ import annotations

import numpy as np


def grid_tet(n: int):
    """[0, 1]^3 in n^3 cubes, six Kuhn tets a cube (the paths 000 -> 111
    along the axes in each order), positively oriented.  Returns
    (V [(n+1)^3, 3] float64, T [6 n^3, 4] int64)."""
    import itertools

    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    pats = []
    for perm in itertools.permutations(range(3)):
        cur, path = [0, 0, 0], [(0, 0, 0)]
        for ax in perm:
            cur[ax] = 1
            path.append(tuple(cur))
        P = np.array(path, dtype=float)
        if np.linalg.det(P[1:] - P[0]) < 0:
            path[2], path[3] = path[3], path[2]
        pats.append([(dx * (n + 1) + dy) * (n + 1) + dz
                     for dx, dy, dz in path])
    i, j, k = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    base = ((i * (n + 1) + j) * (n + 1) + k).ravel()
    T = (base[:, None, None] + np.asarray(pats)[None]).reshape(-1, 4)
    return V, T.astype(np.int64)


def make_mesh(spec: dict):
    """(V, T) of the traffic's ``mesh`` entry."""
    if spec["generator"] != "grid_tet":
        raise ValueError(f"unknown mesh generator {spec['generator']!r}")
    n = int(spec["n"])
    V, T = grid_tet(n)
    if spec.get("jitter"):
        rng = np.random.default_rng(int(spec["jitter_seed"]))
        inner = ((V > 1e-9) & (V < 1 - 1e-9)).all(axis=1)
        V = V.copy()
        V[inner] += (float(spec["jitter"]) / n) * rng.uniform(
            -1.0, 1.0, (int(inner.sum()), 3))
    if spec.get("void_radius"):
        r = float(spec["void_radius"])
        keep = ((V[T].mean(axis=1) - 0.5) ** 2).sum(axis=1) > r * r
        T = T[keep]
        used = np.unique(T)
        remap = -np.ones(len(V), dtype=np.int64)
        remap[used] = np.arange(len(used))
        V, T = V[used], remap[T]
    return V, T


class JobStream:
    """Job parameters of one run: ``next()`` gives a dict of the traffic's
    ``jobs`` entries drawn for the next job."""

    def __init__(self, jobs: dict, seed: int, stream: int = 0):
        self.jobs = jobs
        self.rng = np.random.default_rng([int(seed) % (1 << 64), stream])
        self._cycles = {}

    def _draw(self, name, dist):
        (kind, arg), = dist.items()
        if kind == "uniform":
            return float(self.rng.uniform(arg[0], arg[1]))
        if kind == "log_uniform":
            return float(np.exp(self.rng.uniform(np.log(arg[0]),
                                                 np.log(arg[1]))))
        if kind == "power_of_two":
            return float(2.0 ** int(self.rng.integers(arg[0], arg[1] + 1)))
        if kind == "unit_vector":
            v = self.rng.standard_normal(int(arg))
            return (v / np.linalg.norm(v)).tolist()
        if kind == "cycle":
            left = self._cycles.get(name)
            if not left:
                left = [arg[i] for i in self.rng.permutation(len(arg))]
            self._cycles[name] = left[1:]
            return left[0]
        raise ValueError(f"unknown distribution {kind!r} for {name!r}")

    def next(self) -> dict:
        return {name: self._draw(name, dist)
                for name, dist in self.jobs.items()}
