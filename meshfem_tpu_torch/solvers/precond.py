"""Preconditioners for the iterative solvers (counterpart of
``meshfem_tpu/solvers/precond.py``):

* **block Jacobi**: exact d x d node-block inverses, coupling the vector
  components at each node (one [Nd, d, d] product per application);
* **Chebyshev**: a fixed k-step polynomial in the block-Jacobi-
  preconditioned operator.  Linear and iteration-independent, hence a valid
  (non-flexible) CG preconditioner; each application costs k operator
  applies.

Point Jacobi is built inline by the solvers.  The node-block segment sum
runs through ``ScatterPlan`` (kernel B on the card), so the blocks are
bit-identical run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.scatter import ScatterPlan


def node_block_diagonal(Ke, elem_dofs, num_dofs: int, d: int):
    """Per-node d x d diagonal blocks of the assembled operator.

    Ke [E, n*d, n*d] element matrices (node-major dof order), elem_dofs
    [E, n] -> [Nd, d, d] (set-up time only)."""
    elem_dofs = torch.as_tensor(elem_dofs)
    E = Ke.shape[0]
    n = elem_dofs.shape[1]
    blocks = Ke.reshape(E, n, d, n, d)
    idx = torch.arange(n, device=Ke.device)
    diag_blocks = blocks[:, idx, :, idx, :].movedim(0, 1)     # [E, n, d, d]
    plan = ScatterPlan.build(elem_dofs.reshape(-1).cpu().numpy(), num_dofs,
                             Ke.device)
    return plan(diag_blocks.reshape(E * n, d * d).contiguous()) \
        .reshape(num_dofs, d, d)


def block_jacobi_inv(blocks, free_mask=None):
    """Inverted node blocks [Nd, d, d] ready for apply.

    free_mask [Nd, d] (1 = free): fixed components are decoupled (their
    block rows and columns zeroed, diagonal set to 1) so the preconditioner
    is exact on the constrained subspace.  Nodes with an empty diagonal
    (isolated dofs) fall back to the identity."""
    Nd, d, _ = blocks.shape
    eye = torch.eye(d, dtype=blocks.dtype, device=blocks.device)[None]
    if free_mask is not None:
        f = free_mask.to(blocks.dtype).reshape(Nd, d)
        blocks = blocks * f[:, :, None] * f[:, None, :]
        blocks = blocks + eye * (1.0 - f)[:, :, None]
    diag_ok = torch.diagonal(blocks, dim1=1, dim2=2).abs() > 0
    blocks = torch.where(diag_ok.all(dim=1)[:, None, None], blocks, eye)
    return torch.linalg.inv(blocks)


def block_jacobi_apply(blocks_inv):
    """M_inv callable for CG: r [Nd, d] (or [Nd, d, m]) -> blocks_inv @ r."""
    def M_inv(r):
        Bi = blocks_inv.to(r.dtype)
        if r.dim() == 2:
            return torch.bmm(Bi, r.unsqueeze(-1)).squeeze(-1)
        return torch.bmm(Bi, r)
    return M_inv


def estimate_lambda_max(apply_A, M_inv, shape, dtype=torch.float64,
                        iters: int = 40, seed: int = 0, safety: float = 1.05,
                        device=None):
    """Largest eigenvalue of M_inv A by power iteration from a seeded numpy
    start vector (deterministic).  Returns a float, inflated by
    ``safety``."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                        device=device)
    lam = 1.0
    for _ in range(iters):
        w = M_inv(apply_A(v))
        nrm = torch.linalg.norm(w)
        v = w / nrm
        lam = nrm
    return float(lam) * safety


def chebyshev_preconditioner(apply_A, M_inv, lam_max, lam_min=None,
                             degree: int = 4, project=None):
    """k-step Chebyshev approximation of (M_inv A)^-1 M_inv on
    [lam_min, lam_max]: a FIXED linear operator, valid inside plain CG.
    ``lam_min`` defaults to ``lam_max / 30`` (the standard smoothing
    split)."""
    if lam_min is None:
        lam_min = lam_max / 30.0
    if project is None:
        project = lambda v: v
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta

    def M_cheb(b):
        z = project(M_inv(b))
        d = z / theta
        x = d
        r = b
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = r - project(apply_A(d))
            z = project(M_inv(r))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            x = x + d
            rho = rho_new
        return x

    return M_cheb
