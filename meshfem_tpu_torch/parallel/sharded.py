"""Replicated-vector, element-sharded solves.

Counterpart of ``meshfem_tpu/parallel/sharded.py``:

* the domain axis: elements and their ``Ke`` split into contiguous equal
  chunks, one a shard; vectors replicated; ``A u`` is the sum over shards of
  each shard's element scatter (the float64 ``EBEKernel``: the gather,
  ``bmm``, kernel B), through the comm's ``sum_partials`` (the reference's
  ``psum``), which also leaves the CG scalars replicated;
* the column axis: independent right-hand sides split into the comm's
  ``col_groups``, with no communication across groups.

The comm (``parallel/comm.py``) is :class:`LocalShards` in one process or
:class:`RankShards` over ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..sparse.ebe import EBEKernel
from .comm import LocalShards


def pad_elements(Ke, elem_dofs, n_shards: int):
    """Pad the element arrays to a multiple of ``n_shards`` with
    zero-stiffness dummy elements (scattering zeros into dof 0)."""
    Ke = torch.as_tensor(Ke)
    elem_dofs = torch.as_tensor(elem_dofs, device=Ke.device)
    E = Ke.shape[0]
    Ep = -(-E // n_shards) * n_shards
    if Ep != E:
        pad = Ep - E
        Ke = torch.cat([Ke, Ke.new_zeros((pad,) + tuple(Ke.shape[1:]))])
        elem_dofs = torch.cat([elem_dofs, elem_dofs.new_zeros(
            (pad, elem_dofs.shape[1]))])
    return Ke, elem_dofs


@dataclasses.dataclass
class ShardedEBE:
    """Element-sharded EBE operator: ``op(u)`` with u replicated, [Nd] (d =
    1), [Nd, d] or [Nd, d, m]; the result is replicated too."""

    comm: object
    Ke: torch.Tensor          # [Ep, nd, nd], padded
    elem_dofs: torch.Tensor   # [Ep, n]
    num_dofs: int
    vector_dim: int
    ops: dict                 # local shard id -> EBEKernel on its chunk

    @classmethod
    def build(cls, comm, Ke, elem_dofs, num_dofs: int,
              vector_dim: int = 1) -> "ShardedEBE":
        S = comm.n_shards
        Ke, elem_dofs = pad_elements(Ke, elem_dofs, S)
        c = Ke.shape[0] // S
        ops = {s: EBEKernel.build(Ke[s * c:(s + 1) * c],
                                  elem_dofs[s * c:(s + 1) * c], num_dofs,
                                  vector_dim)
               for s in comm.shards}
        return cls(comm, Ke, elem_dofs, num_dofs, vector_dim, ops)

    def __call__(self, u):
        return self.comm.sum_partials(torch.stack(
            [self.ops[s](u) for s in self.comm.shards]))

    def diagonal(self):
        return self.comm.sum_partials(torch.stack(
            [self.ops[s].diagonal() for s in self.comm.shards]))


def sharded_cg_step(apply):
    """One unpreconditioned CG iteration as a function of the state ``(x, r,
    p, gamma)``; returns ``(new state, gamma_new)``."""

    def step(state):
        x, r, p, gamma = state
        Ap = apply(p)
        alpha = gamma / torch.dot(p.reshape(-1), Ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.dot(r.reshape(-1), r.reshape(-1))
        p = r + (gamma_new / gamma) * p
        return (x, r, p, gamma_new), gamma_new

    return step


def sharded_elasticity_solve_multichip(sim, B, comm=None, free_mask=None,
                                       iters: int = 20):
    """Jacobi-preconditioned, Dirichlet-masked block CG over ``comm``'s
    shards (elements) and column groups (columns of ``B [Nn, d, m]``), a
    fixed ``iters`` iterations.  Returns (U [Nn, d, m], res2 [m]) with the
    padding columns stripped (reference :118-217)."""
    comm = LocalShards(1, sim.device) if comm is None else comm
    d, Nn = sim.dim, sim.num_dofs
    B = torch.as_tensor(B, device=sim.device)
    m = B.shape[-1]
    bg = comm.col_groups
    mb = -(-m // bg)
    if mb * bg != m:
        B = torch.cat([B, B.new_zeros(B.shape[:-1] + (mb * bg - m,))], -1)
    free = torch.ones((Nn, d), dtype=B.dtype, device=B.device) \
        if free_mask is None else \
        torch.as_tensor(free_mask, device=B.device).to(B.dtype) \
        .reshape(Nn, d)
    op = ShardedEBE.build(comm, sim.Ke, sim.elem_dofs, Nn, d)
    diag = op.diagonal()
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))[..., None]
    fm = free[..., None]
    cols, res = [], []
    for c in comm.cols:
        b = B[..., c * mb:(c + 1) * mb] * fm
        x = torch.zeros_like(b)
        r = b
        z = r / safe * fm
        p = z
        gamma = (r * z).sum(dim=(0, 1))
        for _ in range(iters):
            Ap = op(p) * fm
            den = (p * Ap).sum(dim=(0, 1))
            alpha = gamma / torch.where(den == 0, torch.ones_like(den), den)
            x = x + alpha * p
            r = r - alpha * Ap
            z = r / safe * fm
            gamma_new = (r * z).sum(dim=(0, 1))
            beta = gamma_new / torch.where(gamma == 0,
                                           torch.ones_like(gamma), gamma)
            p = z + beta * p
            gamma = gamma_new
        cols.append(x)
        res.append((r * r).sum(dim=(0, 1)))
    U = comm.gather_cols(cols)
    res2 = comm.gather_cols(res)
    return U[..., :m], res2[:m]


def sharded_elasticity_solve(sim, b, comm=None, iters: int = 20):
    """Replicated-vector, element-sharded CG (no preconditioner, no mask)
    on an ``ElasticitySimulator``: ``iters`` iterations, one
    ``sum_partials`` an apply (reference :220-240)."""
    comm = LocalShards(1, sim.device) if comm is None else comm
    op = ShardedEBE.build(comm, sim.Ke, sim.elem_dofs, sim.num_dofs,
                          sim.dim)
    step = sharded_cg_step(op)
    b = torch.as_tensor(b, device=sim.device)
    state = (torch.zeros_like(b), b, b,
             torch.dot(b.reshape(-1), b.reshape(-1)))
    for _ in range(iters):
        state, _ = step(state)
    return state[0]
