"""The P1-coarse two-level preconditioner (``solvers/twolevel.py``) and the
paths that run it: the port against meshfem_tpu on small P2 meshes, both on
the CPU in float64.

Tolerances: integer equality for the endpoint maps; 1e-12 relative for the
transfers and one preconditioner application on a seeded residual (the same
float64 arithmetic, the coarse solve the same SuperLU factorization of the
same Galerkin matrix); the multiplicative cycle is compared with the
reference's damping factor 1/lam carried across, since the power-iteration
estimate behind it need not match bit for bit; 1e-8 of max|u| for the
simulator's two-level solves and of max|Ch| for the cell problems and the
orthotropic cell (all solves at tol <= 1e-10).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.physics import ElasticitySimulator as RSim
from meshfem_tpu.physics.materials import MaterialField as RField
from meshfem_tpu.solvers.twolevel import (TwoLevel as RTwoLevel,
                                          p2_vertex_endpoints as r_endpoints)

from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, MaterialField
from meshfem_tpu_torch.solvers.twolevel import TwoLevel, p2_vertex_endpoints


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


def _moduli(V, T, centre=0.5, r2=0.09, contrast=1000.0):
    c = V[T].mean(axis=1)
    E = np.where(((c - centre) ** 2).sum(axis=1) < r2, contrast, 1.0)
    return E, np.full(len(E), 0.3)


def _perturbed_grid(n, seed=0):
    """grid_tet(n) with its interior vertices moved (not a Kuhn grid)."""
    V, T = generators.grid_tet(n, n, n)
    V = V.copy()
    interior = ((V > 1e-9) & (V < 1 - 1e-9)).all(axis=1)
    rng = np.random.default_rng(seed)
    V[interior] += (0.15 / n) * rng.uniform(-1, 1, (interior.sum(), 3))
    return V, T


@pytest.fixture(scope="module")
def clamped():
    """A 1000:1 inclusion in a perturbed grid_tet(3) P2, x = 0 clamped, the
    far face loaded in -y, in both packages."""
    V, T = _perturbed_grid(3)
    E, nu = _moduli(V, T)
    rmesh = RFEMMesh(V, T, degree=2)
    rsim = RSim(rmesh, RField.isotropic_field(3, jnp.asarray(E),
                                              jnp.asarray(nu)))
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              MaterialField.isotropic_field(3, E, nu),
                              device="cpu")
    X = rmesh.node_positions
    fixed = np.zeros((rmesh.num_nodes, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    load = np.zeros((rmesh.num_nodes, 3))
    load[X[:, 0] > 1 - 1e-9, 1] = -1.0
    rsim.dirichlet_mask[:] = fixed
    rsim.neumann_load = jnp.asarray(load)
    sim.dirichlet_mask[:] = fixed
    sim.neumann_load = torch.as_tensor(load)
    return rsim, sim, fixed


def test_node_endpoint_vertices_equal():
    V, T = _perturbed_grid(3)
    mesh, rmesh = FEMMesh(V, T, degree=2), RFEMMesh(V, T, degree=2)
    ep = p2_vertex_endpoints(mesh)
    np.testing.assert_array_equal(ep, r_endpoints(rmesh))
    np.testing.assert_array_equal(mesh.vertex_nodes, rmesh.vertex_nodes)
    np.testing.assert_allclose(
        mesh.node_positions, 0.5 * (V[ep[:, 0]] + V[ep[:, 1]]), atol=1e-15)
    with pytest.raises(ValueError, match="P2"):
        p2_vertex_endpoints(FEMMesh(V, T, degree=1))


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_M_inv_matches_reference(clamped, mode):
    """One application on a seeded residual, the port's simulator sharing
    the reference's element matrices (their own parity, 1e-12, is held in
    ``test_torch_homogenization.py``; the 1000:1 contrast amplifies it
    through the coarse solve)."""
    rsim, sim0, fixed = clamped
    sim = ElasticitySimulator(sim0.mesh, sim0.D, device="cpu",
                              Ke=np.array(rsim.Ke))
    free = ~fixed
    f64 = torch.as_tensor(free, dtype=torch.float64)
    project = lambda v: v * (f64 if v.dim() == 2 else f64[..., None])
    rfree = jnp.asarray(free, jnp.float64)
    rproject = lambda v: v * (rfree if v.ndim == 2 else rfree[..., None])
    tl = TwoLevel.from_simulator(sim, mode=mode, free_mask=free,
                                 project=project)
    rtl = RTwoLevel.from_simulator(rsim, mode=mode, free_mask=free,
                                   project=rproject)
    assert tl.n_coarse == rtl.n_coarse
    if mode == "multiplicative":
        sm = rtl.smoother
        lam = dict(zip(sm.__code__.co_freevars,
                       (c.cell_contents for c in sm.__closure__)))["lam"]
        assert abs(tl.damping * lam - 1.0) < 1e-6
        tl.damping = 1.0 / lam
    rng = np.random.default_rng(0)
    r = rng.standard_normal((sim.num_dofs, 3, 2)) * free[..., None]
    rc = rng.standard_normal((tl.n_coarse, 3, 2))
    assert _rel(tl.prolong(torch.as_tensor(rc)).numpy(),
                rtl.prolong(jnp.asarray(rc))) < 1e-12
    assert _rel(tl.restrict(torch.as_tensor(r)).numpy(),
                rtl.restrict(jnp.asarray(r))) < 1e-12
    for x in (r, r[..., 0].copy()):
        z = tl.M_inv(torch.as_tensor(x))
        assert _rel(z.numpy(), rtl.M_inv(jnp.asarray(x))) < 1e-12
    # symmetric and positive on the free subspace
    r1, r2 = (torch.as_tensor(r[..., j].copy()) for j in range(2))
    s1 = float((tl.M_inv(r1) * r2).sum())
    s2 = float((r1 * tl.M_inv(r2)).sum())
    assert abs(s1 - s2) < 1e-9 * abs(s1)
    assert float((r1 * tl.M_inv(r1)).sum()) > 0
    assert tl.timings["coarse_dofs"] == 3 * tl.n_coarse


@pytest.fixture(scope="module")
def clamped_reference(clamped):
    rsim, _, _ = clamped
    u, _ = rsim.solve(tol=1e-12, precond="jacobi", operator="ebe")
    return np.asarray(u)


@pytest.mark.parametrize("operator,precond", [
    ("ebe", "twolevel"), ("ebe", "twolevel-mult"),
    ("routed", "twolevel"), ("routed", "twolevel-mult")])
def test_simulator_twolevel_solves(clamped, clamped_reference, operator,
                                   precond):
    """``solve(precond='twolevel*')`` on the float64 EBE branch and on the
    routed branch (float32 CG in the internal order inside float64
    refinement), against the reference's float64 solve; the two-level
    build is cached per (mode, mask, ordering)."""
    rsim, sim, _ = clamped
    u, res = sim.solve(tol=1e-11, precond=precond, operator=operator)
    assert _rel(u.numpy(), clamped_reference) < 1e-8
    ru, rres = rsim.solve(tol=1e-11, precond=precond, operator="ebe")
    assert _rel(u.numpy(), ru) < 1e-8
    key = (precond, (~sim.dirichlet_mask).tobytes(), operator == "routed")
    assert key in sim._twolevel
    if operator == "ebe":
        assert abs(res.iters - int(rres.iters)) <= 1
    else:
        assert res.rounds >= 1


def test_twolevel_beats_jacobi_on_the_routed_branch(clamped):
    """The iteration gate of the chip phase at a small size: the routed
    two-level solve takes fewer inner iterations than Jacobi (a wrong
    internal order would still converge, only slowly)."""
    _, sim, _ = clamped
    _, rt = sim.solve(tol=1e-10, precond="twolevel", operator="routed")
    _, rj = sim.solve(tol=1e-10, precond="jacobi", operator="routed")
    assert rt.iters < rj.iters


@pytest.fixture(scope="module")
def periodic_cell():
    V, T = generators.grid_tet(3, 3, 3)
    E, nu = _moduli(V, T, contrast=100.0)
    rsim = rhom.periodic_simulator(
        RFEMMesh(V, T, degree=2),
        RField.isotropic_field(3, jnp.asarray(E), jnp.asarray(nu)))
    sim = hom.periodic_simulator(FEMMesh(V, T, degree=2),
                                 MaterialField.isotropic_field(3, E, nu),
                                 device="cpu")
    return rsim, sim


@pytest.mark.parametrize("precond", ["twolevel", "twolevel-mult"])
def test_cell_problems_twolevel(periodic_cell, precond):
    rsim, sim = periodic_cell
    w, iters = hom.solve_cell_problems(sim, tol=1e-11, precond=precond,
                                       operator="ebe")
    rw, riters = rhom.solve_cell_problems(rsim, tol=1e-11, precond=precond,
                                          operator="ebe")
    assert abs(iters[0] - riters[0]) <= 1
    Ch = hom.homogenized_tensor_stress_form(sim, w)
    assert _rel(Ch.numpy(), rhom.homogenized_tensor_stress_form(rsim, rw)) \
        < 1e-8
    wb, _ = hom.solve_cell_problems(sim, tol=1e-11, precond="block",
                                    operator="ebe")
    assert _rel(Ch.numpy(),
                hom.homogenized_tensor_stress_form(sim, wb).numpy()) < 1e-8


@pytest.mark.parametrize("precond", ["jacobi", "twolevel"])
def test_orthotropic_cell_matches_reference(precond):
    """``homogenize(orthotropic_cell=True)`` with the jacobi and twolevel
    block CGs on a non-grid 1/8 cell with a stiff inclusion."""
    V, T = generators.grid_tet(3, 3, 3, hi=(0.5, 0.5, 0.5))
    E, nu = _moduli(V, T, centre=0.0, r2=0.06, contrast=50.0)
    res = hom.homogenize(FEMMesh(V, T, degree=2),
                         MaterialField.isotropic_field(3, E, nu),
                         orthotropic_cell=True, tol=1e-11,
                         precond=precond, device="cpu")
    rres = rhom.homogenize(RFEMMesh(V, T, degree=2),
                           RField.isotropic_field(3, jnp.asarray(E),
                                                  jnp.asarray(nu)),
                           orthotropic_cell=True, tol=1e-11, precond=precond)
    assert _rel(res.Ch.numpy(), rres.Ch) < 1e-8
    assert _rel(res.w.numpy(), rres.w) < 1e-8
    assert abs(res.cg_iters[0] - rres.cg_iters[0]) <= 1
    Ch = res.Ch.numpy()
    assert np.all(Ch[:3, 3:] == 0) and np.linalg.eigvalsh(Ch).min() > 0
