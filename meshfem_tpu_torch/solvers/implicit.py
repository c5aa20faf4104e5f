"""Implicit differentiation through iterative solves (counterpart of
``meshfem_tpu/solvers/implicit.py``).

The solution of A(theta) u = b(theta) is differentiated by the implicit
function theorem: the forward solve and the adjoint solve are the same
projected CG (the system is symmetric), and the parameters' gradient is
``-lambda^T dA/dtheta u``, taken by one backward pass through the matvec.
The reference gets this from ``lax.custom_linear_solve``; here it is a
``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from . import cg as cg_mod


class _ImplicitSolve(torch.autograd.Function):
    """u = A^-1 b on the projected subspace; backward: lambda = A^-1 ubar
    (the same CG), b's gradient lambda, the parameters' ``-lambda^T
    d(A u)/dtheta``."""

    @staticmethod
    def forward(ctx, b, pmatvec, solve, *params):
        u = solve(pmatvec, b)
        ctx.pmatvec, ctx.solve = pmatvec, solve
        ctx.save_for_backward(u, *params)
        return u

    @staticmethod
    def backward(ctx, ubar):
        u, *params = ctx.saved_tensors
        lam = ctx.solve(ctx.pmatvec, ubar)
        wanted = [p for p, need in zip(params, ctx.needs_input_grad[3:])
                  if need]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = ctx.pmatvec(u.detach())
                grads = iter(torch.autograd.grad(out, wanted, -lam,
                                                 allow_unused=True))
        g_params = [next(grads) if need else None
                    for need in ctx.needs_input_grad[3:]]
        return (lam, None, None, *g_params)


def solve_implicit(matvec, b, *, params=(), M_inv=None, project=None,
                   tol: float = 1e-11, maxiter: int = 20000):
    """Differentiable solve of the SPD system matvec(u) = b.

    ``params``: the tensors that ``matvec`` closes over and that gradients
    should reach (a material's ``Ke``, a scale).  The reference finds them
    itself, since JAX traces what a closure captures; autograd cannot see
    into a closure, so they are named here.  Gradients flow to ``b`` and to
    each of them; the solve itself runs with no graph."""
    if project is not None:
        b = project(b)

    def pmatvec(u):
        out = matvec(u)
        return project(out) if project is not None else out

    def solve(mv, rhs):
        with torch.no_grad():
            return cg_mod.cg(mv, rhs, M_inv=M_inv, project=project, tol=tol,
                             maxiter=maxiter).x

    return _ImplicitSolve.apply(b, pmatvec, solve, *params)
