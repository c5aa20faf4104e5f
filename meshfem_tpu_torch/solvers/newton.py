"""Newton optimizer with Hessian regularization and line search
(counterpart of ``meshfem_tpu/solvers/newton.py``).

Parity with the reference's ``newton_optimizer/newton_optimizer.hh:25-82``:
a ``NewtonProblem`` exposes energy / gradient / Hessian-apply; indefinite
Hessians are regularized by tau * metric until CG sees an SPD operator;
Armijo backtracking; a per-iteration ConvergenceReport.  The iterate stays
on its device; the host reads the scalars each decision needs (the
gradient norm, the curvature and descent of the step, the energies of the
line search), as the reference does.  ``newton_from_energy`` takes the
gradient by ``torch.autograd`` and the Hessian-vector product by
differentiating ``<grad, v>`` once more (the reference's forward-over-
reverse ``jvp``); ``dense_newton`` takes the dense Hessian by
``torch.autograd.functional.hessian``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.fd_validation import grad_of, hvp_of
from . import cg as cg_mod


@dataclasses.dataclass
class ConvergenceReport:
    energy: list
    grad_norm: list
    step_norm: list
    tau: list
    iterations: int = 0
    converged: bool = False


# ---------------------------------------------------------------------------
# Controller policies (reference
# ``newton_optimizer/HessianProjectionController.hh`` and
# ``HessianUpdateController.hh``): small host-side state machines that
# decide per iteration whether to use the PSD-projected Hessian and whether
# to refresh the (expensive) Hessian anchor point.
# ---------------------------------------------------------------------------

class HessianProjectionController:
    """Base policy: should this iteration use the projected Hessian?"""

    def should_use_projection(self) -> bool:
        raise NotImplementedError

    def notify_definiteness(self, is_indefinite: bool):
        pass

    def reset(self):
        pass


class HessianProjectionAlways(HessianProjectionController):
    def should_use_projection(self):
        return True


class HessianProjectionNever(HessianProjectionController):
    def should_use_projection(self):
        return False


class HessianProjectionAdaptive(HessianProjectionController):
    """Hysteresis policy (``HessianProjectionAdaptive``): start projected;
    after ``steps_before_switch`` consecutive definite iterations drop the
    projection, and switch back after ``indefinite_before_switch``
    consecutive indefinite ones."""

    def __init__(self, steps_before_switch: int = 15,
                 indefinite_before_switch: int = 5):
        self.steps_before_switch = steps_before_switch
        self.indefinite_before_switch = indefinite_before_switch
        self.reset()

    def reset(self):
        self.projection_active = True
        self._counter = self.steps_before_switch

    def should_use_projection(self):
        return self.projection_active

    def notify_definiteness(self, is_indefinite: bool):
        if self.projection_active:
            if not is_indefinite:
                self._counter -= 1
                if self._counter == 0:
                    self.projection_active = False
                    self._counter = self.indefinite_before_switch
            else:
                self._counter = self.steps_before_switch
        else:
            if is_indefinite:
                self._counter -= 1
                if self._counter == 0:
                    self.projection_active = True
                    self._counter = self.steps_before_switch
            else:
                self._counter = self.indefinite_before_switch


class HessianUpdateController:
    """Base policy: refresh the Hessian anchor this iteration?
    (``HessianUpdateController.hh`` — reuse of an expensive Hessian
    between Newton iterations; with a matrix-free HVP the 'factorization'
    being reused is the ANCHOR POINT x_H at which H(x_H) v is applied)."""

    def needs_update(self) -> bool:
        raise NotImplementedError

    def new_hessian(self, is_indefinite: bool):
        pass

    def reused_hessian(self):
        pass

    def reset(self):
        pass


class HessianUpdateAlways(HessianUpdateController):
    def needs_update(self):
        return True


class HessianUpdateNever(HessianUpdateController):
    def needs_update(self):
        return False


class HessianUpdatePeriodic(HessianUpdateController):
    """Refresh every ``period`` iterations (``HessianUpdatePeriodic``)."""

    def __init__(self, period: int = 2):
        self.period = period
        self._counter = 0

    def reset(self):
        self._counter = 0

    def needs_update(self):
        return self._counter == 0

    def new_hessian(self, is_indefinite: bool):
        self._counter = self.period

    def reused_hessian(self):
        if self._counter > 0:
            self._counter -= 1


@dataclasses.dataclass
class NewtonProblem:
    """Matrix-free Newton problem (reference NewtonProblem interface,
    ``newton_optimizer.hh:25-220`` incl. BoundConstraint)."""

    energy: Callable            # x -> scalar
    gradient: Callable          # x -> [n]
    hessian_apply: Callable     # (x, v) -> [n]  (H(x) v)
    metric_apply: Callable = None   # v -> M v (default identity)
    project: Callable = None        # feasible-subspace projector
    lower: object = None            # elementwise lower bounds (optional)
    upper: object = None            # elementwise upper bounds (optional)
    hessian_apply_projected: Callable = None  # PSD-projected (x, v) -> [n]

    def _bound(self, b, x):
        return torch.as_tensor(b, dtype=x.dtype, device=x.device)

    def apply_bound_constraints(self, x):
        """Clamp into the feasible box (``applyBoundConstraints``,
        ``newton_optimizer.hh:178-185`` / the feasibility step)."""
        if self.lower is not None:
            x = torch.maximum(x, self._bound(self.lower, x))
        if self.upper is not None:
            x = torch.minimum(x, self._bound(self.upper, x))
        return x

    def active_bound_mask(self, x, g, tol: float = 1e-8):
        """Working set: bounds that are touched AND whose gradient pushes
        outward (``activeBoundConstraints``, ``newton_optimizer.hh:187``).
        Returns a bool mask of ACTIVE (frozen) variables."""
        active = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        if self.lower is not None:
            active = active | ((x <= self._bound(self.lower, x) + tol)
                               & (g > 0))
        if self.upper is not None:
            active = active | ((x >= self._bound(self.upper, x) - tol)
                               & (g < 0))
        return active


def _dot(a, b):
    return float(torch.vdot(a.reshape(-1), b.reshape(-1)))


def newton_optimize(problem: NewtonProblem, x0, *, gradTol: float = 1e-8,
                    maxiter: int = 50, cg_tol: float = 1e-8,
                    cg_maxiter: int = 2000, tau0: float = 0.0,
                    projection_controller: HessianProjectionController
                    | None = None,
                    update_controller: HessianUpdateController | None = None,
                    verbose: bool = False):
    """Minimize the problem energy (optionally box-constrained: an
    active-set projected Newton, the working-set analog of the reference's
    BoundConstraint machinery).  Returns (x, ConvergenceReport).

    ``projection_controller`` / ``update_controller``: per-iteration
    policies (reference ``HessianProjectionController.hh`` /
    ``HessianUpdateController.hh``).  The projection policy picks between
    ``problem.hessian_apply_projected`` (when provided) and the exact
    Hessian; the update policy decides whether to refresh the Hessian
    anchor point (reusing H(x_old) across iterations).  ``report.cg_iters``
    holds the CG iterations of each Newton iteration's accepted solve."""
    x = torch.as_tensor(x0)
    has_bounds = problem.lower is not None or problem.upper is not None
    if has_bounds:
        x = problem.apply_bound_constraints(x)   # feasibility step
    base_project = problem.project or (lambda v: v)
    metric = problem.metric_apply or (lambda v: v)
    proj_ctrl = projection_controller or HessianProjectionAlways()
    upd_ctrl = update_controller or HessianUpdateAlways()
    report = ConvergenceReport([], [], [], [])
    report.cg_iters = []
    tau = tau0
    x_H = None                     # Hessian anchor (update policy)
    for it in range(maxiter):
        g_raw = base_project(problem.gradient(x))
        if has_bounds:
            free = (~problem.active_bound_mask(x, g_raw)).to(x.dtype)
            project = lambda v, free=free: base_project(v) * free
        else:
            project = base_project
        g = project(g_raw)
        gn = float(torch.linalg.norm(g.reshape(-1)))
        report.grad_norm.append(gn)
        report.energy.append(float(problem.energy(x)))
        if gn < gradTol:
            report.converged = True
            break
        if x_H is None or upd_ctrl.needs_update():
            x_H, fresh_H = x, True
        else:
            fresh_H = False
        use_proj = (problem.hessian_apply_projected is not None
                    and proj_ctrl.should_use_projection())
        happly = (problem.hessian_apply_projected if use_proj
                  else problem.hessian_apply)
        # Solve (H + tau M) dx = -g, increasing tau when CG sees
        # non-positive curvature (reference tau-regularization policy).
        indefinite = False
        for attempt in range(12):
            H = lambda v, tau=tau: project(happly(x_H, v) + tau * metric(v))
            res = cg_mod.cg(H, -g, project=project, tol=cg_tol,
                            maxiter=cg_maxiter)
            dx = res.x
            curv = _dot(dx, H(dx))
            descent = _dot(dx, g)
            if curv > 0 and descent < 0:
                break
            indefinite = True
            tau = max(4.0 * tau, 1e-6)
        report.cg_iters.append(res.iters)
        proj_ctrl.notify_definiteness(indefinite)
        if fresh_H:
            upd_ctrl.new_hessian(indefinite)
        else:
            upd_ctrl.reused_hessian()
        # Backtracking line search (Armijo), projected onto the bounds.
        e0 = report.energy[-1]
        alpha = 1.0
        for _ in range(40):
            x_try = x + alpha * dx
            if has_bounds:
                x_try = problem.apply_bound_constraints(x_try)
            e1 = float(problem.energy(x_try))
            if e1 <= e0 + 1e-4 * alpha * descent:
                break
            alpha *= 0.5
        step = x_try - x
        x = x_try
        report.step_norm.append(float(torch.linalg.norm(step.reshape(-1))))
        report.tau.append(tau)
        tau = tau / 2.0 if tau > 1e-10 else 0.0
        if verbose:
            print(f"newton it {it}: E={e1:.6e} |g|={gn:.3e} "
                  f"alpha={alpha:.2e} tau={tau:.1e}")
        report.iterations = it + 1
    return x, report


def newton_from_energy(energy_fn, x0, **kw):
    """Build the problem from a scalar energy by autograd (the gradient by
    one backward pass, the Hessian-vector product by a second) and
    minimize it."""
    problem = NewtonProblem(energy=energy_fn,
                            gradient=lambda x: grad_of(energy_fn, x),
                            hessian_apply=lambda x, v: hvp_of(energy_fn, x,
                                                              v),
                            project=kw.pop("project", None),
                            lower=kw.pop("lower", None),
                            upper=kw.pop("upper", None))
    return newton_optimize(problem, x0, **kw)


def dense_newton(energy_fn, x0, *, max_iter: int = 100,
                 grad_tol: float = 1e-14, verbose: bool = False):
    """Dense Newton for small problems with eigendecomposition-based
    Hessian regularization (reference ``newton_optimizer/dense_newton.hh``):
    negative eigenvalues are FLIPPED (not clamped), near-zero ones
    pseudo-inverted away, followed by Armijo backtracking (c1 = 1e-4,
    15 halvings) with the reference's accuracy-floor acceptance.

    energy_fn: scalar differentiable energy of a flat [n] vector.
    Returns (x, ConvergenceReport)."""
    x = torch.as_tensor(x0, dtype=torch.float64).reshape(-1)
    report = ConvergenceReport([], [], [], [])
    indefinite = False
    for it in range(max_iter + 1):
        g = grad_of(energy_fn, x)
        Hx = torch.autograd.functional.hessian(energy_fn, x)
        lam, Q = torch.linalg.eigh(Hx)
        indefinite = bool((lam < 0).any())
        lam = lam.abs()                            # flip negatives
        lam_inv = torch.where(lam > 1e-10, 1.0 / torch.where(
            lam > 1e-10, lam, 1.0), lam)
        gnorm = float(torch.linalg.norm(g))
        with torch.no_grad():
            e0 = float(energy_fn(x))
        report.energy.append(e0)
        report.grad_norm.append(gnorm)
        report.iterations = it
        if verbose:
            print(f"{it}\t{e0:.17g}\t{gnorm:.3e}\t{int(indefinite)}")
        if not indefinite and gnorm < grad_tol:
            report.converged = True
            break
        step = Q @ (lam_inv * (Q.T @ (-g)))
        dd = float(torch.dot(g, step))
        alpha, accepted = 1.0, False
        for _ in range(15):
            with torch.no_grad():
                e1 = float(energy_fn(x + alpha * step))
            sufficient = -1e-4 * alpha * dd
            decrease = e0 - e1
            if (decrease >= sufficient
                    or (abs(sufficient) < 1e-10 * abs(e0)
                        and decrease > -1e-16 * abs(e0))):
                accepted = True
                break
            alpha *= 0.5
        if not accepted:
            break                                  # backtracking failed
        x = x + alpha * step
        report.step_norm.append(float(alpha * torch.linalg.norm(step)))
        report.tau.append(0.0)
    return x, report
