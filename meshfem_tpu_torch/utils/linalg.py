"""Small dense linear algebra on torch tensors (counterpart of
``meshfem_tpu/utils/linalg.py::orthonormalize`` :129)."""

from __future__ import annotations

import torch


def orthonormalize(Z: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Column-orthonormalize ``Z [n, k]`` (k small) by modified
    Gram-Schmidt with re-orthogonalization, in ``Z``'s dtype.  A nullspace
    projector of a singular CG system must be orthogonal to the working
    precision: a component left along the null space grows until the
    solve diverges."""
    cols = list(Z.unbind(dim=1))
    for _ in range(passes):
        out = []
        for v in cols:
            for q in out:
                v = v - q * torch.vdot(q, v)
            out.append(v / torch.sqrt(torch.vdot(v, v)))
        cols = out
    return torch.stack(cols, dim=1)
