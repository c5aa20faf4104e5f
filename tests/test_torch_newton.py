"""The port's total strain energy over a mesh (``physics/energies.py::
total_energy``, its element gather the differentiable kernel-A Function)
and Newton (``solvers/newton.py``: ``newton_optimize`` with its bound
constraints and controllers, ``newton_from_energy``, ``dense_newton``)
against the reference's on the CPU.

Same inputs (numpy, from a seed) through both packages.  Tolerances: the
energy, its gradient and a Hessian-vector product 1e-12 of max; Newton
iterates and energies 1e-10 of max, step norms 1e-8, gradient norms 1e-8
of the first, tau exactly as printed to 1e-10, with equal iteration counts
and convergence flags.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.physics import energies as ren
from meshfem_tpu.solvers import cg as rcg, newton as rnewton

from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.physics import energies as en
from meshfem_tpu_torch.solvers import cg as cg_mod, newton
from meshfem_tpu_torch.utils import fd_validation as fd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_total_energy_and_gradient():
    """``total_energy`` of a P2 tet mesh at seeded positions and its
    gradient (the element gather's adjoint, kernel B's Function) and one
    Hessian-vector product (the pair again) against the reference's
    ``jax.grad`` / forward-over-reverse ``jvp``, to 1e-12 of max."""
    V, F = rgen.grid_tet(2, 2, 1)
    rm, pm = RFEMMesh(V, F, degree=2), FEMMesh(V, F, degree=2)
    rng = np.random.default_rng(10)
    x = np.asarray(rm.node_positions) * np.array([1.1, 0.95, 1.0]) \
        + 0.01 * rng.standard_normal((rm.num_nodes, 3))
    v = rng.standard_normal(x.shape)
    Er = ren.total_energy(rm, "neo_hookean", 2.0, 1.0)
    Ep = en.total_energy(pm, "neo_hookean", 2.0, 1.0, device="cpu")
    assert _rel(Ep(_t(x)), float(Er(jnp.asarray(x)))) <= 1e-12
    g_r = jax.grad(Er)(jnp.asarray(x))
    assert _rel(fd.grad_of(Ep, _t(x)), g_r) <= 1e-12
    hv_r = jax.jvp(jax.grad(Er), (jnp.asarray(x),), (jnp.asarray(v),))[1]
    assert _rel(fd.hvp_of(Ep, _t(x), _t(v)), hv_r) <= 1e-12


# -- Newton -------------------------------------------------------------------

def _same_report(rp, rr, x_p, x_r):
    assert rp.iterations == rr.iterations and rp.converged == rr.converged
    assert _rel(x_p, np.asarray(x_r)) <= 1e-10
    assert _rel(np.asarray(rp.energy), np.asarray(rr.energy)) <= 1e-10
    assert _rel(np.asarray(rp.step_norm), np.asarray(rr.step_norm)) <= 1e-8
    assert rp.tau == pytest.approx(rr.tau, rel=1e-10, abs=0)
    g0 = max(rr.grad_norm[0], 1e-300)
    assert max(abs(a - b) for a, b in zip(rp.grad_norm, rr.grad_norm)) \
        <= 1e-8 * g0


def test_newton_nonlinear_stretch_against_reference():
    """The reference test's stretched NeoHookean bar (grid_tri(6, 3) P1,
    20% stretch, ``newton_from_energy`` to gradTol 1e-9): iterates, report
    and counts equal to the reference's; Poisson contraction mid-bar."""
    V, F = rgen.grid_tri(6, 3, hi=(2.0, 1.0))
    rm, pm = RFEMMesh(V, F, degree=1), FEMMesh(V, F, degree=1)
    X = np.asarray(rm.node_positions)
    left = rm.nodes_in_box((0, 0), (0, 1))
    right = rm.nodes_in_box((2, 0), (2, 1))
    fixed = np.zeros((rm.num_nodes, 2), dtype=bool)
    fixed[left] = True
    fixed[right, 0] = True
    x0 = X.copy()
    x0[right, 0] = 2.4
    xr, rr = rnewton.newton_from_energy(
        ren.total_energy(rm, "neo_hookean", 2.0, 1.0), jnp.asarray(x0),
        project=rcg.mask_projector(jnp.asarray(~fixed)), gradTol=1e-9,
        maxiter=30)
    xp, rp = newton.newton_from_energy(
        en.total_energy(pm, "neo_hookean", 2.0, 1.0, device="cpu"), _t(x0),
        project=cg_mod.mask_projector(torch.as_tensor(~fixed)), gradTol=1e-9,
        maxiter=30)
    assert rp.converged
    _same_report(rp, rr, xp, xr)
    assert len(rp.cg_iters) == rp.iterations
    mid = pm.nodes_in_box((1, 1), (1, 1))
    assert float(xp[mid, 1].mean()) < 1.0


def _quartic(n, lib):
    rng = np.random.default_rng(5)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n) * 3
    As, bs = (jnp.asarray(A), jnp.asarray(b)) if lib is jnp else \
        (_t(A), _t(b))
    return lambda x: 0.5 * x @ (As @ x) - bs @ x


@pytest.mark.parametrize("case", ["bounds", "periodic_update",
                                  "projected_hook"])
def test_newton_options_against_reference(case):
    """Box constraints (the reference test's strictly convex quadratic),
    the periodic Hessian-update controller (a Rosenbrock-like chain) and a
    projected-Hessian hook under ``HessianProjectionAlways`` (a double
    well): iterates, reports and counts equal to the reference's."""
    if case == "bounds":
        n = 12
        lo, hi = -0.3 * np.ones(n), 0.4 * np.ones(n)
        xr, rr = rnewton.newton_from_energy(
            _quartic(n, jnp), jnp.zeros(n), lower=lo, upper=hi,
            gradTol=1e-10, maxiter=60)
        xp, rp = newton.newton_from_energy(
            _quartic(n, torch), torch.zeros(n, dtype=torch.float64),
            lower=lo, upper=hi, gradTol=1e-10, maxiter=60)
        assert rp.converged
        assert ((np.abs(xp.numpy() - lo) < 1e-9)
                | (np.abs(xp.numpy() - hi) < 1e-9)).any()
    elif case == "periodic_update":
        def f(x, lib=torch):
            return lib.sum((x[:-1] - 1.0) ** 2) \
                + 10.0 * lib.sum((x[1:] - x[:-1] ** 2) ** 2)

        xr, rr = rnewton.newton_from_energy(
            lambda x: f(x, jnp), jnp.zeros(6), gradTol=1e-10, maxiter=100,
            update_controller=rnewton.HessianUpdatePeriodic(period=2))
        xp, rp = newton.newton_from_energy(
            f, torch.zeros(6, dtype=torch.float64), gradTol=1e-10,
            maxiter=100,
            update_controller=newton.HessianUpdatePeriodic(period=2))
        assert rp.converged
    else:
        def problem(lib, grad, hvp):
            f = lambda x: lib.sum((x ** 2 - 1.0) ** 2)
            proj = (lambda x, v: (lib.maximum(12 * x ** 2 - 4.0, 0.0 * x)
                                  + 1e-3) * v)
            mod = rnewton if lib is jnp else newton
            return mod.NewtonProblem(energy=f, gradient=grad(f),
                                     hessian_apply=hvp(f),
                                     hessian_apply_projected=proj)

        pr = problem(jnp, jax.grad,
                     lambda f: lambda x, v: jax.jvp(jax.grad(f), (x,),
                                                    (v,))[1])
        pp = problem(torch, lambda f: lambda x: fd.grad_of(f, x),
                     lambda f: lambda x, v: fd.hvp_of(f, x, v))
        x0 = np.array([0.1, -0.2, 0.3])
        xr, rr = rnewton.newton_optimize(
            pr, jnp.asarray(x0), gradTol=1e-10, maxiter=60,
            projection_controller=rnewton.HessianProjectionAlways())
        xp, rp = newton.newton_optimize(
            pp, _t(x0), gradTol=1e-10, maxiter=60,
            projection_controller=newton.HessianProjectionAlways())
        np.testing.assert_allclose(np.abs(xp.numpy()), 1.0, atol=1e-6)
    _same_report(rp, rr, xp, xr)


def test_newton_controllers():
    """The controller state machines step as the reference's do."""
    cr = rnewton.HessianProjectionAdaptive(3, 2)
    cp = newton.HessianProjectionAdaptive(3, 2)
    ur, up = rnewton.HessianUpdatePeriodic(3), newton.HessianUpdatePeriodic(3)
    for flag in [False, False, False, True, True, False, True, False]:
        cr.notify_definiteness(flag)
        cp.notify_definiteness(flag)
        assert cp.should_use_projection() == cr.should_use_projection()
        if ur.needs_update():
            ur.new_hessian(flag)
            up.new_hessian(flag)
        else:
            ur.reused_hessian()
            up.reused_hessian()
        assert up.needs_update() == ur.needs_update()


@pytest.mark.parametrize("case", ["rosenbrock", "quartic_saddle"])
def test_dense_newton_against_reference(case):
    """``dense_newton`` from the reference test's starts (an indefinite
    Hessian at the quartic's): iterates and reports equal to the
    reference's."""
    if case == "rosenbrock":
        def f(x, lib=torch):
            return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                           + (1 - x[:-1]) ** 2)
        x0 = np.array([0.5, 0.5, 0.5, 0.5])
    else:
        def f(x, lib=torch):
            return lib.sum(x ** 4) - lib.sum(x ** 2)
        x0 = np.array([1e-3, -1e-3])
    xr, rr = rnewton.dense_newton(lambda x: f(x, jnp), x0, grad_tol=1e-12)
    xp, rp = newton.dense_newton(f, x0, grad_tol=1e-12)
    assert rp.converged == rr.converged and rp.iterations == rr.iterations
    assert _rel(xp, np.asarray(xr)) <= 1e-10
    assert _rel(np.asarray(rp.energy), np.asarray(rr.energy)) <= 1e-10
