"""Python-layer support utilities (counterpart of
``meshfem_tpu/utils/sim_utils.py``; the reference's ``python/``:
``sim_utils.py`` box dof selection, ``regions.py``, ``parallelism.py``
thread control, ``registration.py`` rigid registration).  Host numpy."""

from __future__ import annotations

import os

import numpy as np
import torch


def dofs_in_bbox(mesh, lo, hi, components=None, dim=None) -> np.ndarray:
    """Flat dof indices (``node * dim + component``) of the nodes inside a
    box, for pinning or loading."""
    d = dim or mesh.dim
    nodes = mesh.nodes_in_box(lo, hi)
    comps = np.arange(d) if components is None else np.asarray(components)
    return (nodes[:, None] * d + comps[None, :]).ravel()


class BoxRegion:
    """Axis-aligned region predicate (``regions.py``)."""

    def __init__(self, lo, hi, tol=1e-10):
        self.lo = np.asarray(lo, dtype=float)
        self.hi = np.asarray(hi, dtype=float)
        self.tol = tol

    def contains(self, pts) -> np.ndarray:
        p = np.atleast_2d(pts)
        return np.all((p >= self.lo - self.tol) & (p <= self.hi + self.tol),
                      axis=1)


def set_max_num_threads(n: int) -> None:
    """Cap host parallelism (the reference's ``MESHFEM_NUM_THREADS``): the
    OpenMP / BLAS variables, read by libraries loaded later, and torch's
    intra-op threads now."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = str(n)
    torch.set_num_threads(n)


def rigid_registration(P, Q, allow_scaling: bool = False):
    """Least-squares rigid (and optionally scaled) alignment
    ``Q ~ s R P + t`` (``registration.py``; Umeyama / Kabsch).  Returns
    ``(s, R, t)``."""
    P = np.asarray(P, dtype=float)
    Q = np.asarray(Q, dtype=float)
    cp, cq = P.mean(0), Q.mean(0)
    P0, Q0 = P - cp, Q - cq
    U, S, Vt = np.linalg.svd(P0.T @ Q0)
    D = np.eye(P.shape[1])
    D[-1, -1] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ D @ U.T
    s = 1.0
    if allow_scaling:
        s = (S * np.diag(D)).sum() / (P0 ** 2).sum()
    t = cq - s * R @ cp
    return s, R, t
