"""Preconditioned conjugate gradients with constraint projection.

Counterpart of ``meshfem_tpu/solvers/cg.py``: ``cg`` (:43) with its
warm start, absolute tolerance, breakdown guard, stall and divergence
detection and best-iterate return (the stall counted only once the
residual has fallen below its start, where the reference counts it
from the first iteration), ``cg_fixed_iters`` (:195),
``cg_operator`` (:224, the Jacobi Dirichlet solve), ``cg_operator_fixed``
(:250), ``mask_projector``, ``nullspace_projector`` (:274, the rigid-mode
projection), ``solve_dirichlet`` (:296) and ``cg_block`` (:309, all
right-hand sides of a block at once).
The ``while_loop`` becomes a Python loop whose scalars stay on the device;
the loop reads ONE flag back per iteration (its continue condition), so
the host waits on the device once per iteration and no more.  Vectors are
updated in place where the reference rebinds them.  Dot products run in
the vector's dtype, as the reference's do (``cg.py:33-40``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.linalg import orthonormalize

# Plain CG on kappa ~ 1e7 systems can plateau for hundreds of iterations
# and its residual oscillates by ~sqrt(kappa) between drops, so both guards
# are generous (the reference's values).
STALL_WINDOW = 2048      # iterations without a best-residual improvement
DIVERGE_FACTOR = 1e10


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int           # iterations (cumulative inner ones for refinement)
    resnorm: float       # final residual norm (relative, for refinement)
    rounds: int = 0      # refinement rounds (0 for a plain CG solve)
    history: tuple = ()  # refinement: per round (f64 relative residual
    #                      before it, inner iterations)


def _dot(a, b):
    """Inner product in the vector dtype (0-d tensor on the device)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg(A: Callable, b, x0=None, *, M_inv: Callable | None = None,
       project: Callable | None = None, tol: float = 1e-10,
       atol: float = 0.0, maxiter: int = 1000) -> CGResult:
    """Solve A x = b with PCG from ``x0`` (default 0).  ``project`` must be
    an orthogonal projector onto the feasible subspace; it is applied to b,
    x0 and every operator output, keeping all iterates feasible.  The loop
    stops once |r| <= max(tol |b|, atol)."""
    if project is None:
        project = lambda v: v
    if M_inv is None:
        M_inv = lambda v: v

    b = project(b)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = project(x0.to(b.dtype)).clone()
        r = project(b - A(x))
    z = project(M_inv(r))
    gamma = _dot(r, z)
    stop2 = torch.clamp(tol * tol * _dot(b, b), min=atol * atol)
    p = z.clone()
    rr = _dot(r, r)
    rr_best = rr.clone()
    x_best = x.clone()
    stall = torch.zeros((), dtype=torch.int32, device=b.device)
    moved = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    cont = (rr > stop2) & torch.isfinite(rr)
    while k < maxiter and bool(cont):
        Ap = project(A(p))
        den = _dot(p, Ap)
        # breakdown guard: non-positive / non-finite curvature means the
        # solve hit the roundoff floor -- freeze the iterate and stop
        good = torch.isfinite(den) & (den > 0)
        alpha = torch.where(good, gamma / torch.where(good, den, 1.0), 0.0)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1.0)
        z = project(M_inv(r))
        gamma_new = torch.where(good, _dot(r, z), gamma)
        p.mul_(gamma_new / gamma).add_(z)
        gamma = gamma_new
        # below the attainable residual floor the recursive residual
        # decouples from the true one: keep the best iterate and stop
        rr = _dot(r, r)
        improved = rr < 0.999 * rr_best
        x_best = torch.where(improved, x, x_best)
        # the floor lies below the starting residual, and a PCG residual
        # can stay above it for thousands of iterations (a slender or
        # finely meshed cantilever): no stall is counted before the
        # residual has first fallen below where it started (the
        # reference counts from the first iteration and returns x0)
        moved = moved | improved
        stall = torch.where(improved | ~moved, 0, stall + 1)
        rr_best = torch.minimum(rr, rr_best)
        done = (~good) | (stall >= STALL_WINDOW) \
            | (rr > DIVERGE_FACTOR * rr_best)
        k += 1
        cont = (rr > stop2) & (~done) & torch.isfinite(rr)
    use_best = rr_best < rr
    x = torch.where(use_best, x_best, x)
    rnorm = torch.sqrt(torch.where(use_best, rr_best, rr))
    return CGResult(x, k, float(rnorm))


def cg_fixed_iters(A: Callable, b, x0=None, *,
                   M_inv: Callable | None = None,
                   project: Callable | None = None,
                   iters: int = 100) -> CGResult:
    """CG with a fixed iteration count and no guards (``cg_fixed_iters``
    :195, for benchmarks); ``resnorm`` is the final |r|."""
    if project is None:
        project = lambda v: v
    if M_inv is None:
        M_inv = lambda v: v
    b = project(b)
    x = torch.zeros_like(b) if x0 is None else project(x0.to(b.dtype))
    r = project(b - A(x))
    z = project(M_inv(r))
    gamma = _dot(r, z)
    p = z
    for _ in range(iters):
        Ap = project(A(p))
        alpha = gamma / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = project(M_inv(r))
        gamma_new = _dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return CGResult(x, iters, float(torch.sqrt(_dot(r, r))))


def mask_projector(free_mask):
    """Projector zeroing fixed dofs.  ``free_mask`` broadcasts against the
    vector from the LEADING axes (trailing multi-RHS axes are appended), so
    one mask serves [Nd, d] and block [Nd, d, m] vectors alike."""
    def project(v):
        m = free_mask.to(v.dtype)
        if v.dim() > m.dim():
            m = m.reshape(m.shape + (1,) * (v.dim() - m.dim()))
        return v * m

    return project


def cg_operator(op, b, diag, free_mask, fixed_values=None, *,
                tol: float = 1e-11, maxiter: int = 10000) -> CGResult:
    """Jacobi-preconditioned Dirichlet CG solve of ``op`` (``cg_operator``
    :224): free_mask is 1.0/0.0 (or bool) over the dofs; fixed_values are
    the values on the fixed dofs (default zero)."""
    free = free_mask.to(b.dtype)
    project = lambda v: v * free
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))
    M_inv = lambda r: r / safe
    if fixed_values is not None:
        u_d = fixed_values * (1.0 - free)
        rhs = b - op(u_d)
    else:
        u_d = None
        rhs = b
    res = cg(op, rhs, M_inv=M_inv, project=project, tol=tol, maxiter=maxiter)
    x = res.x if u_d is None else res.x + u_d
    return CGResult(x, res.iters, res.resnorm)


def cg_operator_fixed(op, b, diag, free_mask, *,
                      iters: int = 100) -> CGResult:
    """Fixed-iteration Jacobi Dirichlet CG of ``op`` (``cg_operator_fixed``
    :250), for benchmarks."""
    free = free_mask.to(b.dtype)
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))
    return cg_fixed_iters(op, b, M_inv=lambda r: r / safe,
                          project=lambda v: v * free, iters=iters)


def nullspace_projector(Z, dtype=None):
    """Projector onto the orthogonal complement of span(Z) (``Z [n, k]``,
    columns orthonormalized here by modified Gram-Schmidt in Z's dtype);
    the rigid-mode projection that replaces the reference's Lagrange
    "no rigid motion" rows.  ``dtype``: cast the orthonormal basis to it
    after orthonormalizing (a float32 projector built in float64).  ``v``
    of any shape is projected as the columns of ``v.reshape(n, -1)``
    (``[Nd, d]`` is one column, a block ``[Nd, d, m]`` m of them); ``Qt``
    is kept contiguous so that ``Q^T v`` reads the basis row by row."""
    if Z.dim() == 1:
        Z = Z[:, None]
    Q = orthonormalize(Z)
    if dtype is not None:
        Q = Q.to(dtype)
    Qt = Q.t().contiguous()

    def project(v):
        flat = v.reshape(Q.shape[0], -1)
        return (flat - Q @ (Qt @ flat)).reshape(v.shape)

    return project


def solve_dirichlet(A: Callable, b, fixed_mask, fixed_values,
                    **kw) -> CGResult:
    """Solve A u = b with u[fixed] = fixed_values[fixed] (``solve_dirichlet``
    :296): u = u_d + z, z on the free dofs with A_ff z = P (b - A u_d).
    ``fixed_mask`` is bool or 1.0 / 0.0."""
    fixed = fixed_mask.to(torch.bool)
    u_d = torch.where(fixed, fixed_values, torch.zeros_like(fixed_values))
    res = cg(A, b - A(u_d), project=mask_projector(~fixed), **kw)
    return CGResult(res.x + u_d, res.iters, res.resnorm)


BLOCK_CHUNK = 1024       # iterations between cg_block's stagnation checks


def cg_block(A: Callable, B, *, M_inv: Callable | None = None,
             project: Callable | None = None, tol: float = 1e-10,
             maxiter: int = 10000) -> CGResult:
    """Block PCG (``cg_block`` :309): solve A X = B for ALL columns of
    ``B [..., m]`` at once with per-column step sizes (independent Krylov
    spaces, one shared operator apply).  Converged columns freeze (their
    alpha and beta are zeroed); a column whose curvature is non-positive or
    non-finite freezes too.  Every ``BLOCK_CHUNK`` iterations the loop stops
    if no column's residual improved since the last check (columns stuck at
    their roundoff floor).  ``resnorm`` is the per-column residual norms
    [m] (a tensor); the loop reads ONE flag back per iteration."""
    if project is None:
        project = lambda v: v
    if M_inv is None:
        M_inv = lambda v: v
    axes = tuple(range(B.dim() - 1))

    def cdot(a, b):
        return torch.sum(a * b, dim=axes)             # [m]

    B = project(B)
    x = torch.zeros_like(B)
    r = B.clone()
    z = project(M_inv(r))
    gamma = cdot(r, z)
    stop2 = tol * tol * cdot(B, B)
    p = z.clone()
    rr = cdot(r, r)
    one = torch.ones_like(gamma)

    def live_any(rr):
        return bool(((rr > stop2) & torch.isfinite(rr)).any())

    k = 0
    prev_rr = None
    while True:
        limit = min(k + BLOCK_CHUNK, maxiter)
        while k < limit and live_any(rr):
            Ap = project(A(p))
            den = cdot(p, Ap)
            good = torch.isfinite(den) & (den > 0)
            live = ((rr > stop2) & good).to(x.dtype)
            alpha = live * gamma / torch.where(den > 0, den, one)
            x = x + alpha * p
            r = r - alpha * Ap
            z = project(M_inv(r))
            gamma_new = cdot(r, z)
            beta = live * gamma_new / torch.where(gamma != 0, gamma, one)
            p = z + beta * p
            gamma = torch.where(live > 0, gamma_new, gamma)
            rr = cdot(r, r)
            k += 1
        if k >= maxiter or not live_any(rr):
            break
        if prev_rr is not None and bool((rr >= 0.999 * prev_rr).all()):
            break
        prev_rr = rr
    return CGResult(x, k, torch.sqrt(rr))
