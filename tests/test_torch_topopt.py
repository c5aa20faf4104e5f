"""SIMP topology optimization (``analysis/topopt.py``): the port against
meshfem_tpu on the reference tests' 4 x 2 x 2 cantilever in float64 on the
CPU, and the reference's own checks run on the port (finite differences of
the adjoint gradient through the whole pipeline, the OC volume and bounds,
a decreasing compliance).

Tolerances: 1e-12 relative for the filter, its adjoint and the cell
energies of one displacement (the same float64 arithmetic); 1e-8 for the
compliance, its gradient and three ``run`` iterations, whose state solves
stop at the same relative tolerance; the finite-difference and OC checks
keep the reference test's bounds.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis.topopt import ComplianceTopOpt as RTopOpt

from meshfem_tpu_torch.analysis.topopt import ComplianceTopOpt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's torch work on one thread: the suite runs six test
    processes on eight cores, where torch's intra-op threads oversubscribe
    the cores and the CG loops' small ops slow three- to fourfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tiny(**kw):
    kw.setdefault("solve_tol", 1e-11)
    return ComplianceTopOpt(4, 2, 2, volfrac=0.5, dtype=torch.float64,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    top = _tiny()
    rtop = RTopOpt(4, 2, 2, volfrac=0.5, dtype=jnp.float64, solve_tol=1e-11)
    rng = np.random.default_rng(0)
    rho = np.clip(0.5 + 0.1 * rng.standard_normal((4, 2, 2)), 0.2, 0.9)
    return top, rtop, rho


def test_filter_matches_reference(pair):
    top, rtop, rho = pair
    x = torch.as_tensor(rho)
    assert _rel(top.filtered(x).numpy(), rtop.filtered(jnp.asarray(rho))) \
        < 1e-12
    assert _rel(top.filter_adjoint(x).numpy(),
                rtop.filter_adjoint(jnp.asarray(rho))) < 1e-12
    np.testing.assert_array_equal(top.kern.numpy(), np.asarray(rtop.kern))
    np.testing.assert_array_equal(top.fixed, rtop.fixed)
    np.testing.assert_array_equal(top.load.numpy(), np.asarray(rtop.load))


def test_cell_energies_match_reference(pair):
    top, rtop, rho = pair
    ru, _, _, _ = rtop.solve(jnp.asarray(rho))
    u = torch.as_tensor(np.array(ru))
    assert _rel(top.cell_energies(u).numpy(), rtop.cell_energies(ru)) < 1e-12
    v = u.flip(0)
    assert _rel(top.cell_energies(u, v).numpy(),
                rtop.cell_energies(ru, jnp.asarray(v.numpy()))) < 1e-12
    assert _rel(top._unit_cell_matrix(), rtop._unit_cell_matrix()) < 1e-12


def test_compliance_and_grad_match_reference(pair):
    top, rtop, rho = pair
    c, dc, iters = top.compliance_and_grad(torch.as_tensor(rho))
    rc, rdc, riters = rtop.compliance_and_grad(jnp.asarray(rho))
    assert abs(c - rc) <= 1e-8 * abs(rc)
    assert _rel(dc.numpy(), rdc) < 1e-8
    assert abs(iters - riters) <= 1


def test_run_matches_reference():
    top = _tiny()
    rtop = RTopOpt(4, 2, 2, volfrac=0.5, dtype=jnp.float64, solve_tol=1e-11)
    rho, hist = top.run(iters=3)
    rrho, rhist = rtop.run(iters=3)
    for h, rh in zip(hist, rhist):
        assert abs(h["compliance"] - rh["compliance"]) \
            <= 1e-8 * abs(rh["compliance"])
        assert abs(h["volume"] - rh["volume"]) <= 1e-8
        assert abs(h["inner_iters"] - rh["inner_iters"]) <= 1
    assert _rel(rho.numpy(), rrho) < 1e-8


def test_compliance_gradient_matches_fd():
    """Adjoint dc/drho == central finite differences through the whole
    pipeline (filter -> SIMP -> MG solve -> compliance), the reference
    test's points and bound."""
    top = _tiny()
    rng = np.random.default_rng(0)
    rho = torch.as_tensor(np.clip(
        0.5 + 0.1 * rng.standard_normal((4, 2, 2)), 0.2, 0.9))
    _, dc, _ = top.compliance_and_grad(rho)
    h = 1e-5
    for ix in [(0, 0, 0), (2, 1, 0), (3, 0, 1), (1, 1, 1)]:
        e = torch.zeros_like(rho)
        e[ix] = 1.0
        cp, _, _ = top.compliance_and_grad(rho + h * e)
        cm, _, _ = top.compliance_and_grad(rho - h * e)
        fd = (cp - cm) / (2 * h)
        ad = float(dc[ix])
        assert abs(fd - ad) <= 2e-4 * max(abs(fd), abs(ad), 1e-12), \
            (ix, fd, ad)


def test_oc_update_respects_volume_and_bounds():
    top = _tiny()
    rho = torch.full((4, 2, 2), 0.5, dtype=torch.float64)
    _, dc, _ = top.compliance_and_grad(rho)
    new = top.oc_update(rho, dc)
    assert float(new.min()) >= 0.0 and float(new.max()) <= 1.0
    assert abs(float(top.filtered(new).mean()) - top.volfrac) < 0.02
    assert float((new - rho).abs().max()) <= 0.2 + 1e-12


def test_run_decreases_compliance():
    top = _tiny()
    _, hist = top.run(iters=3)
    cs = [h["compliance"] for h in hist]
    assert cs[-1] < cs[0]
    assert all(np.isfinite(cs))
    assert all(h["inner_iters"] < 200 for h in hist)
