"""Bounding boxes, batched simplex embedding and boundary normals
(counterparts of ``BBox`` :21, ``simplex_geometry`` :52 and
``boundary_normals`` :87 in ``meshfem_tpu/mesh/geometry.py``).

One vectorized, autograd-differentiable computation over all elements:
constant barycentric gradients and signed volumes (tangential gradients and
unsigned measures for a surface embedded in a larger space).  The small
inverses are closed-form adjugates (the reference uses closed-form
determinants and an unrolled Gauss-Jordan inverse, ``utils/linalg.py``);
both agree to rounding.  ``embedded_boundary_normals`` gives the boundary
edges of a triangle surface in 3D their in-plane normals, which the
reference's ``boundary_normals`` has no branch for.
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
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def _inv(A, det):
    """Adjugate / det for [..., n, n], n in (1, 2, 3)."""
    if A.shape[-1] == 1:
        return 1.0 / A
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
    """Embedding of K-simplices (K <= 3) with corner positions
    ``X [..., K+1, dim]``.  Returns (grad_lambda [..., K+1, dim], volume
    [...]): for dim == K the signed volume and the gradients from J^-1;
    for dim > K (a surface or curve embedded in R^dim) the unsigned measure
    and the tangential gradients from the Gram matrix G = J J^T
    (reference :76-84)."""
    dim = X.shape[-1]
    if not 1 <= K <= min(dim, 3):
        raise ValueError(f"cannot embed {K}-simplices in R^{dim}")
    J = X[..., 1:, :] - X[..., :1, :]              # [..., K, dim] rows = edges
    if dim == K:
        det = _det(J)
        volume = det / math.factorial(K)
        grads = _inv(J, det).transpose(-1, -2)     # grad lambda_{j>=1}
    else:
        G = torch.einsum("...id,...jd->...ij", J, J)
        detG = _det(G)
        volume = torch.sqrt(torch.clamp(detG, min=0.0)) / math.factorial(K)
        grads = torch.einsum("...ij,...jd->...id", _inv(G, detG), J)
    grad0 = -grads.sum(dim=-2, keepdim=True)
    return torch.cat([grad0, grads], dim=-2), volume


def boundary_normals(Xb, vol_centroids=None):
    """Outward unit normals and measures of the boundary simplices of a
    full-dimensional mesh: edges ``Xb [..., 2, 2]`` (the edge rotated by -90
    degrees) or triangles ``Xb [..., 3, 3]`` (the cross product), oriented
    by the stored (outward) winding.  ``vol_centroids [..., dim]``, the
    centroids of the adjacent elements, flips a normal that points toward
    its element.  Returns (normal [..., dim], measure [...])."""
    dim = Xb.shape[-1]
    if Xb.shape[-2] != dim or dim not in (2, 3):
        raise ValueError("boundary normals of edges in 2D and triangles in "
                         "3D only")
    if dim == 2:
        t = Xb[..., 1, :] - Xb[..., 0, :]
        measure = torch.linalg.norm(t, dim=-1)
        n = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
        n = n / torch.clamp(measure[..., None], min=1e-300)
    else:
        e1 = Xb[..., 1, :] - Xb[..., 0, :]
        e2 = Xb[..., 2, :] - Xb[..., 0, :]
        c = torch.linalg.cross(e1, e2)
        nrm = torch.linalg.norm(c, dim=-1)
        measure = 0.5 * nrm
        n = c / torch.clamp(nrm[..., None], min=1e-300)
    if vol_centroids is not None:
        face_c = Xb.mean(dim=-2)
        flip = ((n * (torch.as_tensor(vol_centroids, dtype=n.dtype,
                                      device=n.device) - face_c)).sum(-1)
                > 0)
        n = torch.where(flip[..., None], -n, n)
    return n, measure


def embedded_boundary_normals(Xb, vol_centroids):
    """In-plane outward unit normals and lengths of the boundary edges
    ``Xb [..., 2, dim]`` of a triangle surface in R^dim: the part of
    (edge midpoint - adjacent centroid) orthogonal to the edge, normalized.
    For a flat surface in the plane z = 0 it is the 2D normal."""
    t = Xb[..., 1, :] - Xb[..., 0, :]
    measure = torch.linalg.norm(t, dim=-1)
    th = t / torch.clamp(measure[..., None], min=1e-300)
    w = Xb.mean(dim=-2) - vol_centroids
    n = w - (w * th).sum(-1, keepdim=True) * th
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-300), measure
