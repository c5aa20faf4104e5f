"""The port's material optimization (``analysis/material_optimization.py``:
``MaterialOptimizationProblem``, ``optimize`` with Adam and the multigrid
branch; ``cli/material_opt.py``) against the reference's on the CPU.

Same inputs (numpy, from a seed) through both packages.  Tolerances: the
objective and its gradient 1e-8 relative (also with the field exactly on
both bounds), the finite-difference gate 1e-4 (the reference test's),
Adam against optax 1e-12, optimization histories and fields 1e-8, the
reference test's recovery (below 1e-2 of the start, the mean within
20%), the CLI equal to the API to 1e-12.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshfem_tpu.analysis import material_optimization as rmo
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen

from meshfem_tpu_torch.analysis import material_optimization as mo
from meshfem_tpu_torch.mesh import FEMMesh
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


# -- material optimization ----------------------------------------------------

def _mo_inputs(V, F, E_true=3.0):
    d = V.shape[1]
    rm = RFEMMesh(V, F, degree=1)
    X = np.asarray(rm.node_positions)
    hi = X.max(axis=0)
    left = np.flatnonzero(X[:, 0] < 1e-9)
    right = np.flatnonzero(X[:, 0] > hi[0] - 1e-9)
    fixed = np.zeros((rm.num_nodes, d), dtype=bool)
    fixed[left] = True
    load = np.zeros((rm.num_nodes, d))
    load[right, 0] = 0.05
    rprob = rmo.MaterialOptimizationProblem(
        rm, 0.3, fixed, np.zeros_like(load), jnp.asarray(load), right,
        np.zeros((len(right), d)), bounds=(0.5, 8.0))
    u_true = rprob.displacement(jnp.full(rm.num_elements, E_true))
    rprob.target_values = np.asarray(u_true)[right]
    rprob.__post_init__()
    prob = mo.MaterialOptimizationProblem(
        FEMMesh(V, F, degree=1), 0.3, fixed, np.zeros_like(load),
        torch.as_tensor(load), right, np.asarray(u_true)[right],
        bounds=(0.5, 8.0), device="cpu")
    return rprob, prob


@pytest.fixture(scope="module")
def mo_square():
    V, F = rgen.grid_tri(4, 4)
    return _mo_inputs(V, F)


def test_material_objective_and_gradient(mo_square):
    """The objective and its gradient at a seeded field against the
    reference's ``jax.grad`` (1e-8), the reference test's finite-difference
    gate (1e-4), and a field sitting exactly on both bounds (clip splits a
    tie's gradient as JAX's max / min do)."""
    rprob, prob = mo_square
    E = rprob.mesh.num_elements
    y = 2.0 + np.random.default_rng(4).random(E)
    J_ref = float(rprob.objective(jnp.asarray(y)))
    assert _rel(prob.objective(_t(y)), J_ref) <= 1e-8
    g_ref = np.asarray(rprob.gradient(jnp.asarray(y)))
    assert _rel(prob.gradient(_t(y)), g_ref) <= 1e-8
    assert fd.fd_gradient_check(prob.objective, _t(np.full(E, 2.0)),
                                eps=1e-5, n_dirs=3) < 1e-4
    # theta with exp(theta) exactly on lo and on hi (bounds 0.5 and 1.0,
    # which exp reaches exactly): the optimizer's clipped map
    lo, hi = 0.5, 1.0
    th = np.where(np.arange(E) % 3 == 0, np.log(lo),
                  np.where(np.arange(E) % 3 == 1, 0.0, np.log(0.75)))
    assert torch.equal(torch.exp(_t(th[:2])),
                       torch.tensor([lo, hi], dtype=torch.float64))
    assert np.exp(th[0]) == lo and np.exp(th[1]) == hi
    g_r = np.asarray(jax.grad(lambda t: rprob.objective(
        jnp.clip(jnp.exp(t), lo, hi)))(jnp.asarray(th)))
    tt = _t(th).requires_grad_(True)
    g_p, = torch.autograd.grad(prob.objective(
        mo._clip(torch.exp(tt), lo, hi)), tt)
    assert _rel(g_p, g_r) <= 1e-8


def test_adam_equals_optax():
    """The written-out Adam against ``optax.adam`` with its defaults over
    twelve steps of seeded gradients, to 1e-12."""
    import optax

    rng = np.random.default_rng(5)
    theta = rng.standard_normal(7)
    opt = optax.adam(0.2)
    state = opt.init(jnp.asarray(theta))
    tr, tp = jnp.asarray(theta), _t(theta)
    adam = mo._Adam(0.2, tp)
    for _ in range(12):
        g = rng.standard_normal(7)
        upd, state = opt.update(jnp.asarray(g), state)
        tr = optax.apply_updates(tr, upd)
        tp = adam.step(tp, _t(g))
        assert _rel(tp, tr) <= 1e-12


def test_optimize_against_reference(mo_square):
    """``optimize`` (Adam, 6 steps) from the reference test's start: the
    objective history and the fitted field equal to the reference's to
    1e-8."""
    rprob, prob = mo_square
    E = rprob.mesh.num_elements
    yr, hr = rmo.optimize(rprob, jnp.full(E, 2.0), steps=6,
                          learning_rate=0.2)
    yp, hp = mo.optimize(prob, torch.full((E,), 2.0, dtype=torch.float64),
                         steps=6, learning_rate=0.2)
    assert _rel(np.asarray(hp), np.asarray(hr)) <= 1e-8
    assert _rel(yp, np.asarray(yr)) <= 1e-8
    assert hp[-1] < hp[0]


def test_optimize_recovers_stiffness(mo_square):
    """The reference test's recovery, on the port alone: 60 Adam steps
    from E = 2 bring the objective below 1e-2 of its start and the mean
    modulus within 20% of E_true = 3."""
    _, prob = mo_square
    E = prob.mesh.num_elements
    y, hist = mo.optimize(prob, torch.full((E,), 2.0, dtype=torch.float64),
                          steps=60, learning_rate=0.2)
    assert hist[-1] < 1e-2 * hist[0]
    assert abs(float(y.mean()) - 3.0) / 3.0 < 0.2


@pytest.fixture(scope="module")
def mo_kuhn():
    """The smallest Kuhn grid whose multigrid both packages build
    (grid_tet(2) P2, two levels), shared by the multigrid checks."""
    V, F = rgen.grid_tet(2, 2, 2)
    rm = RFEMMesh(V, F, degree=2)
    X = np.asarray(rm.node_positions)
    right = np.flatnonzero(X[:, 0] > 1 - 1e-9)
    fixed = np.zeros((rm.num_nodes, 3), dtype=bool)
    fixed[X[:, 0] < 1e-9] = True
    load = np.zeros((rm.num_nodes, 3))
    load[right, 1] = -0.05
    tv = np.random.default_rng(6).standard_normal((len(right), 3)) * 1e-3
    rprob = rmo.MaterialOptimizationProblem(
        rm, 0.3, fixed, np.zeros_like(load), jnp.asarray(load), right,
        jnp.asarray(tv), bounds=(0.5, 8.0))
    prob = mo.MaterialOptimizationProblem(
        FEMMesh(V, F, degree=2), 0.3, fixed, np.zeros_like(load),
        torch.as_tensor(load), right, tv, bounds=(0.5, 8.0), device="cpu")
    return rprob, prob


def test_optimize_multigrid_against_reference(mo_kuhn):
    """``precond="multigrid"`` (the V-cycle rebuilt from the current field
    each step): 2 Adam steps, history and field equal to the reference's to
    1e-8."""
    rprob, prob = mo_kuhn
    E = rprob.mesh.num_elements
    y0 = 1.0 + np.random.default_rng(7).random(E)
    yr, hr = rmo.optimize(rprob, jnp.asarray(y0), steps=2,
                          learning_rate=0.1, precond="multigrid")
    yp, hp = mo.optimize(prob, _t(y0), steps=2, learning_rate=0.1,
                         precond="multigrid")
    assert _rel(np.asarray(hp), np.asarray(hr)) <= 1e-8
    assert _rel(yp, np.asarray(yr)) <= 1e-8


def test_material_opt_cli_matches_api(tmp_path):
    """``python -m meshfem_tpu_torch.cli.material_opt`` on a mesh and a .bc
    file with ``target`` regions: the field it writes equals the API's
    ``optimize`` on the same problem to 1e-12."""
    from meshfem_tpu_torch.cli import material_opt
    from meshfem_tpu_torch.io import meshio, msh_fields
    from meshfem_tpu_torch.mesh import generators
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           load_bc)
    from meshfem_tpu_torch.physics.boundary_conditions import (
        expression_env, match_boundary_nodes)

    V, F = generators.grid_tri(4, 3)
    meshio.save_msh(tmp_path / "m.msh", V, F)
    bc = {"regions": [
        {"type": "dirichlet", "value": [0, 0],
         "box%": {"minCorner": [-0.01, -0.01], "maxCorner": [0.01, 1.01]}},
        {"type": "force", "value": [0.05, 0],
         "box%": {"minCorner": [0.99, -0.01], "maxCorner": [1.01, 1.01]}},
        {"type": "target", "value": [0.01, 0],
         "box%": {"minCorner": [0.99, -0.01], "maxCorner": [1.01, 1.01]}}]}
    (tmp_path / "m.bc").write_text(json.dumps(bc))
    out = tmp_path / "fit.msh"
    material_opt.main([str(tmp_path / "m.msh"), "-b", str(tmp_path / "m.bc"),
                       "--steps", "3", "--lr", "0.2", "-o", str(out),
                       "--device", "cpu"])
    young_cli = msh_fields.read_fields(out)["young"]["data"]

    V2, F2 = meshio.load(tmp_path / "m.msh")      # as the CLI reads it
    mesh = FEMMesh(V2[:, :2], F2, degree=1)
    b = load_bc(tmp_path / "m.bc", dim=2)
    sim = ElasticitySimulator(mesh, Material.isotropic(2, 1.0, 0.3),
                              device="cpu")
    sim.apply_boundary_conditions(b)
    reg = [r for r in b.regions if r.type == "target"][0]
    nodes = match_boundary_nodes(mesh, reg)
    vals = reg.eval_value(mesh.node_positions[nodes],
                          expression_env(mesh))[:, :2]
    prob = mo.MaterialOptimizationProblem(
        mesh, 0.3, sim.dirichlet_mask, sim.dirichlet_values,
        sim.neumann_load, nodes, vals, device="cpu")
    y, _ = mo.optimize(prob, torch.ones(mesh.num_elements,
                                        dtype=torch.float64),
                       steps=3, learning_rate=0.2)
    assert _rel(np.asarray(young_cli).reshape(-1), y.numpy()) <= 1e-12
