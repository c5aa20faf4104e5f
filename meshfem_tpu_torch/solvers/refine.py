"""Mixed-precision iterative refinement (counterpart of
``meshfem_tpu/solvers/refine.py::refine`` :33, with its warm start).

The residual is evaluated in float64 (one accurate operator apply per
round), the correction is solved in float32 to a loose inner tolerance, and
the solution accumulates in float64.  Each round multiplies the residual
by ~(inner tol + kappa eps32); a handful of rounds reach 1e-10.

With the tracer on (``utils/timer.py``) the call is a ``refine`` span
under whatever span its caller has open (``solve/refine``,
``homogenize/refine``), each residual, its norm read back included, a
``refine/residual`` span and each inner solve a ``refine/inner`` span.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch

from ..utils.timer import GLOBAL_TIMER


class RefineResult(NamedTuple):
    x: torch.Tensor          # float64 solution
    rounds: int              # refinement rounds taken
    resnorm: float           # final float64 relative residual norm
    inner_iters: int         # total low-precision CG iterations
    history: tuple = ()      # per round: (f64 relative residual before
    #                          it, inner iterations of its solve)


def refine(apply_hi: Callable, solve_lo: Callable, b, *,
           tol: float = 1e-10, max_rounds: int = 12,
           x0=None) -> RefineResult:
    """Solve ``A x = b`` to float64 relative residual ``tol``.

    apply_hi(x_f64) -> A x in float64; solve_lo(r_f32) -> (dx, iters), an
    approximate float32 solve of A dx = r; b: float64 right-hand side;
    x0: float64 starting guess (default 0; already projected / constrained
    as the caller needs).  A guess that already meets ``tol`` returns in 0
    rounds."""
    timer = GLOBAL_TIMER
    with timer.section("refine"):
        b = b.to(torch.float64)
        bn = float(torch.linalg.norm(b))
        if bn == 0.0:
            return RefineResult(torch.zeros_like(b), 0, 0.0, 0)
        x = torch.zeros_like(b) if x0 is None else x0.to(torch.float64)
        total_inner = 0
        history = []
        rel = float("inf")
        rounds = 0
        for rounds in range(1, max_rounds + 1):
            with timer.section("residual"):
                r = b - apply_hi(x)
                rel_new = float(torch.linalg.norm(r)) / bn
            if rel_new <= tol:
                return RefineResult(x, rounds - 1, rel_new, total_inner,
                                    tuple(history))
            if rel_new >= rel * 0.9:
                # stagnation: the kappa * eps32 floor is reached
                break
            rel = rel_new
            with timer.section("inner"):
                dx, iters = solve_lo(r.to(torch.float32))
            total_inner += int(iters)
            history.append((rel_new, int(iters)))
            x = x + dx.to(torch.float64)
        with timer.section("residual"):
            r = b - apply_hi(x)
            rel = float(torch.linalg.norm(r)) / bn
        if rel > tol:
            warnings.warn(
                f"iterative refinement stagnated at relative residual "
                f"{rel:.3e} (requested tol {tol:.1e}, {rounds} rounds, "
                f"{total_inner} inner iterations): the f32 inner solve hit "
                f"its kappa*eps32 floor", RuntimeWarning, stacklevel=2)
        return RefineResult(x, rounds, rel, total_inner, tuple(history))
