"""Element-by-element operator ``A u = scatter(Ke @ gather(u))``.

Counterpart of ``meshfem_tpu/sparse/ebe.py::EBEKernel`` (:30-118): single-
vector and multi-RHS applies and the diagonal.  In the port it is the float64
residual operator of iterative refinement: the gather is a plain index, the
per-element product a batched matmul (XLA einsum / multiply-reduce in the
reference), and the scatter runs on kernel B in float64 (``ScatterPlan``),
deterministic where ``index_add_`` on CUDA would use float atomics.  The
element forces ``fe [E*n, d*m]`` (rows ``e * n + a``, the bmm's own
layout) are summed as rows straight into ``[N, d*m]``: a block
``u [N, d, m]`` is one batched matmul and one segment sum, with no
transpose.
"""

from __future__ import annotations

import dataclasses

import torch

from .scatter import ScatterPlan


@dataclasses.dataclass
class EBEKernel:
    """Symmetric EBE operator for scalar (d = 1) or vector dofs.

    Ke: [E, n*d, n*d] (dof ``node * d + comp``); elem_dofs: [E, n] long;
    applies to u of shape [N] (d = 1) or [N, d], or to a block of m
    right-hand sides [N, m] (d = 1) / [N, d, m]."""

    Ke: torch.Tensor
    elem_dofs: torch.Tensor
    num_dofs: int
    vector_dim: int
    plan: ScatterPlan

    @classmethod
    def build(cls, Ke, elem_dofs, num_dofs: int,
              vector_dim: int = 1) -> "EBEKernel":
        elem_dofs = torch.as_tensor(elem_dofs, dtype=torch.long,
                                    device=Ke.device)
        plan = ScatterPlan.build(elem_dofs.reshape(-1).cpu().numpy(),
                                 num_dofs, Ke.device)
        return cls(Ke, elem_dofs, num_dofs, vector_dim, plan)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        E, nd, _ = self.Ke.shape
        n = self.elem_dofs.shape[1]
        d = self.vector_dim
        single = (self.num_dofs,) if d == 1 else (self.num_dofs, d)
        if tuple(u.shape[:len(single)]) != single \
                or u.dim() > len(single) + 1:
            raise ValueError(f"EBEKernel: u must be {single} or "
                             f"{single + ('m',)}, got {tuple(u.shape)}")
        m = u.shape[-1] if u.dim() > len(single) else 1
        ue = u[self.elem_dofs].reshape(E, nd, m)
        fe = torch.bmm(self.Ke, ue)
        y = self.plan(fe.reshape(E * n, d * m))
        return y.reshape(u.shape)

    def diagonal(self) -> torch.Tensor:
        E, nd, _ = self.Ke.shape
        n = self.elem_dofs.shape[1]
        d = self.vector_dim
        de = torch.diagonal(self.Ke, dim1=1, dim2=2)
        return self.plan(de.reshape(E * n) if d == 1
                         else de.reshape(E * n, d))
