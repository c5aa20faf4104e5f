"""The port's derivatives against the reference's on the CPU: kernels A and
B as each other's adjoints (``sparse/scatter.py``), the finite-difference
harness (``utils/fd_validation.py``), the implicit-function solve
(``solvers/implicit.py``) and
``analysis/topopt.py::differentiable_displacement`` (material
optimization: ``tests/test_torch_material_opt.py``).

Same inputs (numpy, from a seed) through both packages.  Tolerances: the
A/B pair bit for bit (each backward equals the other's plain forward) and
``gradcheck`` / ``gradgradcheck`` at their float64 defaults, its
forward-mode rule 1e-6 against a central difference; the
finite-difference errors 1e-8 apart; implicit gradients 1e-8 relative;
``differentiable_displacement`` 1e-8 against the reference's ``jax.grad``
and 5e-5 against ``dc`` (the reference test's gate).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshfem_tpu.analysis import topopt as rtopopt
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.ops import operators as rops
from meshfem_tpu.solvers import cg as rcg
from meshfem_tpu.solvers.implicit import solve_implicit as rsolve_implicit
from meshfem_tpu.utils import fd_validation as rfd

from meshfem_tpu_torch import kernels
from meshfem_tpu_torch.analysis import topopt
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.ops import operators
from meshfem_tpu_torch.solvers import cg as cg_mod
from meshfem_tpu_torch.solvers.implicit import solve_implicit
from meshfem_tpu_torch.sparse.scatter import GatherPlan, ScatterPlan
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


# -- kernels A and B as each other's adjoints ---------------------------------

@pytest.fixture(scope="module")
def ab_plans():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, size=40)
    ids[:9] = np.arange(9)                  # every segment has a row
    plan = ScatterPlan.build(ids, 9, "cpu")
    return ids, plan, plan.adjoint


@pytest.mark.parametrize("which", ["segment_sum", "gather"])
def test_ab_gradcheck(ab_plans, which):
    """gradcheck (reverse and forward mode) and gradgradcheck of the
    segment sum (kernel B's Function) and the gather (kernel A's) in
    float64."""
    ids, plan, gather = ab_plans
    rng = np.random.default_rng(1)
    if which == "segment_sum":
        fn = plan
        x = _t(rng.standard_normal((40, 3))).requires_grad_(True)
    else:
        fn = gather
        x = _t(rng.standard_normal((9, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x,), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(lambda v: fn(v) ** 2, (x,))


def test_ab_backward_is_the_other_kernel(ab_plans):
    """Each backward equals, bit for bit, the other Function's plain
    forward: B's backward is A's plain gather of the output gradient, A's
    backward B's plain segment sum; a second derivative runs the pair
    again (their launches counted through the plain versions here)."""
    ids, plan, gather = ab_plans
    rng = np.random.default_rng(2)
    rows = _t(rng.standard_normal((40, 5))).requires_grad_(True)
    src = _t(rng.standard_normal((9, 5))).requires_grad_(True)
    gy = _t(rng.standard_normal((9, 5)))
    gx = _t(rng.standard_normal((40, 5)))
    ids32 = torch.as_tensor(ids, dtype=torch.int32)
    g_rows, = torch.autograd.grad(plan(rows), rows, gy)
    assert torch.equal(g_rows, kernels.gather_rows_plain(gy, ids32))
    g_src, = torch.autograd.grad(gather(src), src, gx)
    assert torch.equal(g_src, kernels.segment_sum_rows_plain(
        gx, plan.perm, plan.offsets))
    assert torch.equal(gather.ids, ids32)
    # double backward: d/dgy <grad(plan(rows)), w> = gather(w)... again A
    gy_r = gy.clone().requires_grad_(True)
    g1, = torch.autograd.grad(plan(rows), rows, gy_r, create_graph=True)
    w = _t(rng.standard_normal((40, 5)))
    g2, = torch.autograd.grad(g1, gy_r, w)
    assert torch.equal(g2, kernels.segment_sum_rows_plain(w, plan.perm,
                                                          plan.offsets))


@pytest.mark.parametrize("which", ["segment_sum", "gather"])
def test_ab_jvp_against_finite_difference(ab_plans, which):
    """The forward-mode rule (``torch.func.jvp``) against a central
    difference of the map, to 1e-6 (both maps are linear: the difference
    is exact up to rounding)."""
    ids, plan, gather = ab_plans
    rng = np.random.default_rng(3)
    fn = plan if which == "segment_sum" else gather
    n = 40 if which == "segment_sum" else 9
    x, t = _t(rng.standard_normal((n, 2))), _t(rng.standard_normal((n, 2)))
    y, jv = torch.func.jvp(fn, (x,), (t,))
    h = 1e-3
    fdv = (fn(x + h * t) - fn(x - h * t)) / (2 * h)
    assert _rel(jv, fdv.numpy()) <= 1e-6
    assert torch.equal(y, fn(x))


def test_scatter_plan_ids_need_one_segment_a_row():
    """A plan that sums one row into two segments (the two-level transfer
    plans) has no single-gather adjoint and says so."""
    plan = ScatterPlan.build(np.array([0, 1, 1]), 2, "cpu").renumbered(
        torch.tensor([0, 1, 0], dtype=torch.int32))
    with pytest.raises(ValueError):
        plan.ids
    assert torch.equal(ScatterPlan.build(np.array([1, 0, 1]), 2, "cpu").ids,
                       torch.tensor([1, 0, 1], dtype=torch.int32))
    g = GatherPlan.build(np.array([2, 0]), 3, "cpu")
    assert torch.equal(g(torch.arange(3.0)), torch.tensor([2.0, 0.0]))


# -- the finite-difference harness --------------------------------------------

def test_fd_harness_against_reference():
    """``fd_gradient_check`` and ``fd_hessian_check`` on the reference
    test's function pass its gates and give the reference's errors to
    1e-8 (both sit near the differences' rounding floor)."""
    x = np.random.default_rng(0).standard_normal(10)
    f_r = lambda v: jnp.sum(jnp.sin(v) * v ** 2)
    f_p = lambda v: torch.sum(torch.sin(v) * v ** 2)
    h_r = rfd.fd_hessian_check(f_r, jnp.asarray(x))
    h_p = fd.fd_hessian_check(f_p, _t(x))
    g_r = rfd.fd_gradient_check(f_r, jnp.asarray(x))
    g_p = fd.fd_gradient_check(f_p, _t(x))
    assert h_p < 1e-6 and g_p < 1e-5
    assert abs(h_p - h_r) <= 1e-8 and abs(g_p - g_r) <= 1e-8


# -- implicit differentiation -------------------------------------------------

def test_implicit_solve_gradient():
    """d/dtheta of J(u(theta)), (theta L) u = b: equal to ``jax.grad``
    through the reference's ``solve_implicit`` to 1e-8, and to the
    reference test's identity -2 J / theta."""
    V, F = rgen.grid_tri(4, 4)
    rm, pm = RFEMMesh(V, F, degree=1), FEMMesh(V, F, degree=1)
    rL, L = rops.laplacian(rm), operators.laplacian(pm, device="cpu")
    free = np.ones(pm.num_nodes)
    free[pm.bdry_nodes] = 0.0
    b = np.random.default_rng(0).standard_normal(pm.num_nodes)
    rproj = rcg.mask_projector(jnp.asarray(free))
    proj = cg_mod.mask_projector(_t(free))

    def J_ref(th):
        u = rsolve_implicit(lambda v: th * rL(v), rproj(jnp.asarray(b)),
                            project=rproj, tol=1e-13)
        return jnp.sum(u ** 2)

    g_ref = float(jax.grad(J_ref)(2.0))
    theta = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    u = solve_implicit(lambda v: theta * L(v), proj(_t(b)),
                       params=(theta,), project=proj, tol=1e-13)
    J = torch.sum(u ** 2)
    g, = torch.autograd.grad(J, theta)
    assert abs(float(g) - g_ref) <= 1e-8 * abs(g_ref)
    assert float(g) == pytest.approx(-2.0 / 2.0 * float(J.detach()),
                                     rel=1e-8)
    # the right-hand side's gradient is the adjoint solution
    bt = proj(_t(b)).requires_grad_(True)
    u2 = solve_implicit(lambda v: theta.detach() * L(v), bt, project=proj,
                        tol=1e-13)
    gb, = torch.autograd.grad(torch.sum(u2 ** 2), bt)
    g_rb = jax.grad(lambda bb: jnp.sum(rsolve_implicit(
        lambda v: 2.0 * rL(v), bb, project=rproj, tol=1e-13) ** 2))(
        rproj(jnp.asarray(b)))
    assert _rel(gb, g_rb) <= 1e-8


# -- differentiable_displacement ----------------------------------------------

def test_differentiable_displacement():
    """The gradient of load . u(rho) through the autograd Function against
    ``jax.grad`` through the reference's custom VJP (1e-8) and against the
    self-adjoint compliance gradient ``dc`` (5e-5, the reference test's
    gate), float64 on ``ComplianceTopOpt(4, 2, 2)``."""
    kw = dict(volfrac=0.5, solve_tol=1e-11, rmin=1.5)
    rtop = rtopopt.ComplianceTopOpt(4, 2, 2, dtype=jnp.float64, **kw)
    top = topopt.ComplianceTopOpt(4, 2, 2, dtype=torch.float64,
                                  device="cpu", **kw)
    rho = np.clip(0.5 + 0.05 * np.random.default_rng(8).standard_normal(
        (4, 2, 2)), 0.3, 0.8)
    ru = rtopopt.differentiable_displacement(rtop)
    g_ref = np.asarray(jax.grad(lambda r: jnp.vdot(
        jnp.asarray(rtop.load, jnp.float64),
        jnp.asarray(ru(r), jnp.float64)))(jnp.asarray(rho)))
    u_of_rho = topopt.differentiable_displacement(top)
    r = _t(rho).requires_grad_(True)
    J = torch.vdot(top.load.reshape(-1), u_of_rho(r).reshape(-1))
    g, = torch.autograd.grad(J, r)
    assert _rel(g, g_ref) <= 1e-8
    _, dc, _ = top.compliance_and_grad(_t(rho))
    np.testing.assert_allclose(g.numpy(), dc.numpy(), rtol=5e-5,
                               atol=1e-10 * float(dc.abs().max()))
