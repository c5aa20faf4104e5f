"""Bounding boxes, batched simplex embedding and boundary normals
(counterparts of ``BBox`` :21, ``simplex_geometry`` :52 and
``boundary_normals`` :87 in ``meshfem_tpu/mesh/geometry.py``).

One vectorized, autograd-differentiable computation over all elements:
constant barycentric gradients and signed volumes.  The 2x2 / 3x3 inverses
are closed-form adjugates (the reference uses closed-form determinants and
an unrolled Gauss-Jordan inverse, ``utils/linalg.py``); both agree to
rounding.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BBox:
    """Axis-aligned bounding box (numpy, host side)."""

    min: np.ndarray
    max: np.ndarray

    @classmethod
    def of(cls, points) -> "BBox":
        p = np.asarray(points)
        return cls(p.min(axis=0), p.max(axis=0))

    @property
    def dimensions(self) -> np.ndarray:
        return self.max - self.min

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)

    def volume(self) -> float:
        return float(np.prod(self.dimensions))

    def union(self, other: "BBox") -> "BBox":
        return BBox(np.minimum(self.min, other.min),
                    np.maximum(self.max, other.max))

    def contains(self, points, tol: float = 0.0) -> np.ndarray:
        p = np.asarray(points)
        return np.all((p >= self.min - tol) & (p <= self.max + tol), axis=-1)


def _det(A):
    n = A.shape[-1]
    if n == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _inv(A, det):
    """Adjugate / det for [..., n, n], n in (2, 3)."""
    if A.shape[-1] == 2:
        adj = torch.stack([
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], -1)], -2)
        return adj / det[..., None, None]
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            # cofactor C[j, i] (transposed: adjugate)
            r = [k for k in range(3) if k != j]
            c = [k for k in range(3) if k != i]
            minor = (A[..., r[0], c[0]] * A[..., r[1], c[1]]
                     - A[..., r[0], c[1]] * A[..., r[1], c[0]])
            row.append(minor if (i + j) % 2 == 0 else -minor)
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2) / det[..., None, None]


def simplex_geometry(X, K: int):
    """Embedding of K-simplices (K = dim = 2 or 3) with corner positions
    ``X [..., K+1, dim]``.  Returns (grad_lambda [..., K+1, dim],
    signed volume [...])."""
    if X.shape[-1] != K or K not in (2, 3):
        raise ValueError("this port embeds full-dimensional triangles "
                         "and tets only")
    J = X[..., 1:, :] - X[..., :1, :]              # [..., K, dim] rows = edges
    det = _det(J)
    volume = det / math.factorial(K)
    grads = _inv(J, det).transpose(-1, -2)         # grad lambda_{j>=1}
    grad0 = -grads.sum(dim=-2, keepdim=True)
    return torch.cat([grad0, grads], dim=-2), volume


def boundary_normals(Xb):
    """Outward unit normals and areas of boundary triangles with corner
    positions ``Xb [..., 3, 3]``, oriented by the stored (outward) winding.
    Returns (normal [..., 3], measure [...])."""
    if Xb.shape[-1] != 3:
        raise ValueError("this port carries boundary triangles in 3D only")
    e1 = Xb[..., 1, :] - Xb[..., 0, :]
    e2 = Xb[..., 2, :] - Xb[..., 0, :]
    c = torch.linalg.cross(e1, e2)
    nrm = torch.linalg.norm(c, dim=-1)
    return c / torch.clamp(nrm[..., None], min=1e-300), 0.5 * nrm
