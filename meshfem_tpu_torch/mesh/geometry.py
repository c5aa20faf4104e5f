"""Batched simplex embedding (counterpart of
``meshfem_tpu/mesh/geometry.py::simplex_geometry`` :52).

One vectorized, autograd-differentiable computation over all elements:
constant barycentric gradients and signed volumes.  The 2x2 / 3x3 inverses
are closed-form adjugates (the reference uses closed-form determinants and
an unrolled Gauss-Jordan inverse, ``utils/linalg.py``); both agree to
rounding.
"""

from __future__ import annotations

import math

import torch


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
