"""The periodic torus multigrid (``ops/structured_periodic.py``), voxel
homogenization and the orthotropic multigrid cell: the port against
meshfem_tpu on small Kuhn-grid cells, both on the CPU in float64.

Tolerances: 1e-14 (absolute, unit-size inputs) for the torus transfers,
which do the same additions; 1e-10 for their adjoint identities; 1e-12
relative for the operator, its diagonal and one V-cycle against the
reference (the same float64 products summed in another order), 1e-13
against the port's own float64 EBE operator; 1e-8 of max|Ch| for the
homogenized tensors (both solves stop at the same relative tolerance),
with iteration counts equal to within 1.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.ops import structured_periodic as rsp
from meshfem_tpu.physics.materials import MaterialField as RField

from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.ops import structured_periodic as sp
from meshfem_tpu_torch.physics import MaterialField


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


def _sphere_moduli(V, T, centre=0.5, r2=0.08, contrast=1000.0):
    c = V[T].mean(axis=1)
    E = np.where(((c - centre) ** 2).sum(axis=1) < r2, contrast, 1.0)
    return E, np.full(len(E), 0.3)


def _cross_lattice(n=6):
    """The cross lattice of ``examples/homogenize_voxels.py`` at n^3."""
    occ = np.zeros((n, n, n), bool)
    lo, hi = n // 2 - max(n // 8, 1), n // 2 + max(n // 8, 1)
    occ[lo:hi, :, lo:hi] = True
    occ[:, lo:hi, lo:hi] = True
    occ[lo:hi, lo:hi, :] = True
    return occ


@pytest.fixture(scope="module")
def grid_cell():
    """``_grid_cell(4)`` of the reference's tests in both packages: the
    periodic simulators and the two multigrid hierarchies."""
    V, T = generators.grid_tet(4, 4, 4)
    E, nu = _sphere_moduli(V, T)
    rmesh = RFEMMesh(V, T, degree=2)
    rmats = RField.isotropic_field(3, jnp.asarray(E), jnp.asarray(nu))
    rsim = rhom.periodic_simulator(rmesh, rmats)
    mesh = FEMMesh(V, T, degree=2)
    mats = MaterialField.isotropic_field(3, E, nu)
    sim = hom.periodic_simulator(mesh, mats, device="cpu")
    rmg = rsp.PeriodicVarMG.build(rmesh, np.asarray(rmats.D), rsim.dof_map)
    mg = sp.PeriodicVarMG.build(mesh, mats.D, sim.dof_map, device="cpu")
    return dict(V=V, T=T, E=E, nu=nu, rsim=rsim, sim=sim, rmg=rmg, mg=mg,
                rmesh=rmesh, rmats=rmats, mesh=mesh, mats=mats)


@pytest.mark.parametrize("columns", [None, 2])
def test_torus_transfers_match_reference(columns):
    rng = np.random.default_rng(0)
    n = 4
    tail = () if columns is None else (columns,)
    v = rng.standard_normal((n, n, n, 3) + tail)
    u = rng.standard_normal((n, n, n, 8, 3) + tail)
    vc = rng.standard_normal((n // 2,) * 3 + (3,) + tail)
    uf = rng.standard_normal((n,) * 3 + (3,) + tail)
    T = torch.as_tensor
    pairs = [(sp.torus_prolong_p2(T(v)), rsp.torus_prolong_p2, v),
             (sp.torus_restrict_p2(T(u)), rsp.torus_restrict_p2, u),
             (sp.torus_prolong_h(T(vc)), rsp.torus_prolong_h, vc),
             (sp.torus_restrict_h(T(uf)), rsp.torus_restrict_h, uf)]
    for ours, fn, x in pairs:
        if columns is None:
            ref = np.asarray(fn(jnp.asarray(x)))
        else:   # the reference transfers take one column at a time
            ref = np.stack([np.asarray(fn(jnp.asarray(x[..., j])))
                            for j in range(columns)], axis=-1)
        assert np.abs(ours.numpy() - ref).max() < 1e-14
    dot = lambda a, b: float((a * b).sum())
    assert abs(dot(sp.torus_prolong_p2(T(v)), T(u))
               - dot(T(v), sp.torus_restrict_p2(T(u)))) < 1e-10
    assert abs(dot(sp.torus_prolong_h(T(vc)), T(uf))
               - dot(T(vc), sp.torus_restrict_h(T(uf)))) < 1e-10


def test_wrap_fold_is_the_adjoint_of_wrap_pad():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((3, 4, 5, 8, 3, 2)))
    y = torch.as_tensor(rng.standard_normal((4, 5, 6, 8, 3, 2)))
    assert abs(float((sp._wrap_pad(x) * y).sum())
               - float((x * sp._wrap_fold(y)).sum())) < 1e-10


def test_periodic_operator_matches_reference_and_ebe(grid_cell):
    sim, rsim = grid_cell["sim"], grid_cell["rsim"]
    op, rop = grid_cell["mg"].fine, grid_cell["rmg"].fine
    np.testing.assert_array_equal(op.dof_slot.numpy(),
                                  np.asarray(rop.dof_slot))
    rng = np.random.default_rng(2)
    u = rng.standard_normal((sim.num_dofs, 3))
    y = op(torch.as_tensor(u))
    assert _rel(y.numpy(), rop(jnp.asarray(u))) < 1e-12
    assert _rel(y.numpy(), sim.apply_K(torch.as_tensor(u)).numpy()) < 1e-13
    d = op.from_channels(op.diagonal_channels())
    rd = rop.from_channels(rop.diagonal_channels())
    assert _rel(d.numpy(), rd) < 1e-12
    assert _rel(d.numpy(), sim.K_diagonal().numpy()) < 1e-13
    # a block of columns: one apply, each column as the EBE operator's
    U = torch.as_tensor(rng.standard_normal((sim.num_dofs, 3, 6)))
    assert _rel(op(U).numpy(), sim.apply_K(U).numpy()) < 1e-13


def test_periodic_mg_matches_reference(grid_cell):
    """The hierarchy (levels, coarsest pseudo-inverse, Gershgorin bounds)
    and one V-cycle on a seeded residual, single and as a block."""
    mg, rmg = grid_cell["mg"], grid_cell["rmg"]
    assert [lvl.n3 for lvl in mg.levels] == [tuple(lvl.n3)
                                             for lvl in rmg.levels]
    for lvl, rlvl in zip(mg.levels, rmg.levels):
        assert _rel(lvl.Kc.numpy(), rlvl.Kc) < 1e-12
        assert _rel(lvl.diag.numpy(), rlvl.diag) < 1e-12
    assert (mg.coarse_inv is None) == (rmg.coarse_inv is None)
    assert _rel(mg.coarse_inv.numpy(), rmg.coarse_inv) < 1e-10
    np.testing.assert_allclose(mg.lam, rmg.lam, rtol=1e-12)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(tuple(mg.fine_diag.shape) + (2,))
    z = mg.precondition(torch.as_tensor(r))
    for j in range(2):
        rz = rmg.precondition(jnp.asarray(r[..., j]))
        assert _rel(z[..., j].numpy(), rz) < 1e-12
        z1 = mg.precondition(torch.as_tensor(r[..., j].copy()))
        assert _rel(z1.numpy(), z[..., j].numpy()) < 1e-13


def test_single_column_mg_cg_matches_the_block(grid_cell):
    """``_periodic_mg_cg`` on one cell problem equals that column of the
    block solve (the same Krylov iteration per column)."""
    sim, mg = grid_cell["sim"], grid_cell["mg"]
    Bc = mg.fine.to_channels(hom._cell_loads(sim))
    blk = sp._periodic_mg_cg_block(mg, Bc, 1e-10, 300)
    x, iters, resnorm = sp._periodic_mg_cg(mg, Bc[..., 3].contiguous(),
                                           1e-10, 300)
    assert iters == blk.iters
    assert _rel(x.numpy(), blk.x[..., 3].numpy()) < 1e-10
    assert float(x.mean(dim=(0, 1, 2, 3)).abs().max()) < 1e-14


def test_superlu_coarsest_level_matches_pinv():
    """With a small ``dense_cap`` the coarsest torus level (3^3 after one
    coarsening of 6^3) is solved by host SuperLU with vertex 0 pinned; the
    V-cycle then differs from the ``pinv`` one by a translation only."""
    V, T = generators.grid_tet(6, 6, 6)
    E, nu = _sphere_moduli(V, T)
    mesh = FEMMesh(V, T, degree=2)
    mats = MaterialField.isotropic_field(3, E, nu)
    sim = hom.periodic_simulator(mesh, mats, device="cpu")
    lu = sp.PeriodicVarMG.build(mesh, mats.D, sim.dof_map, dense_cap=50,
                                device="cpu")
    dense = sp.PeriodicVarMG.build(mesh, mats.D, sim.dof_map, dense_cap=100,
                                   device="cpu")
    assert lu.coarse_inv is None and lu._coarse_lu is not None
    assert dense.coarse_inv is not None
    assert [lvl.n3 for lvl in lu.levels] == [(6, 6, 6), (3, 3, 3)]
    r = sp._project_translations(torch.as_tensor(
        np.random.default_rng(4).standard_normal(
            tuple(lu.fine_diag.shape) + (2,))))
    z_lu = sp._project_translations(lu.precondition(r))
    z_dense = sp._project_translations(dense.precondition(r))
    assert _rel(z_lu.numpy(), z_dense.numpy()) < 1e-10


def test_grid_cell_problems_multigrid(grid_cell):
    """homogenize(precond='multigrid') on the reference's _grid_cell(4).
    The reference's side is what its ``homogenize`` computes there (the
    periodic simulator, ``solve_cell_problems_grid`` with maxiter 100000,
    centred fluctuations, the stress form) on the fixture's simulator and
    multigrid, built once for the module."""
    g = grid_cell
    res = hom.homogenize(g["mesh"], g["mats"], tol=1e-9, precond="multigrid",
                         device="cpu")
    rw, riters = rsp.solve_cell_problems_grid(g["rsim"], mg=g["rmg"],
                                              tol=1e-9, maxiter=100000)
    rCh = rhom.homogenized_tensor_stress_form(
        g["rsim"], rw - jnp.mean(rw, axis=1, keepdims=True))
    assert _rel(res.Ch.numpy(), rCh) < 1e-8
    assert abs(res.cg_iters[0] - riters[0]) <= 1
    assert tuple(res.w.shape) == (6, g["mesh"].num_nodes, 3)
    # against the port's own block-Jacobi block CG on the EBE operator
    blk = hom.homogenize(g["mesh"], g["mats"], tol=1e-11, precond="block",
                         device="cpu")
    assert _rel(res.Ch.numpy(), blk.Ch.numpy()) < 1e-7
    assert max(res.cg_iters) * 2 < blk.cg_iters[0]


def test_homogenize_voxels_matches_reference():
    """The voxel entry point on the 4^3 cross lattice (1e-6 ersatz void):
    the reference's gates and its tensor (the reference's compiles, not
    the size, set this test's time)."""
    occ = _cross_lattice(4)
    res = hom.homogenize_voxels(occ, E_solid=1.0, nu=0.3, device="cpu")
    rres = rhom.homogenize_voxels(occ, E_solid=1.0, nu=0.3)
    Ch = res.Ch.numpy()
    assert _rel(Ch, rres.Ch) < 1e-8
    assert abs(res.cg_iters[0] - rres.cg_iters[0]) <= 1
    d = np.diag(Ch)
    assert max(res.cg_iters) < 60
    assert np.linalg.eigvalsh(Ch).min() > 0
    assert d.max() < 1.0
    assert abs(d[:3] - d[:3].mean()).max() < 1e-6   # cubic symmetry


def test_multigrid_raises_off_grid():
    V, T = generators.grid_tet(4, 4, 4)
    V2 = V.copy()
    interior = ((V2 > 0.1) & (V2 < 0.9)).all(axis=1)
    V2[interior] += 0.01
    mesh = FEMMesh(V2, T, degree=2)
    mats = MaterialField.isotropic_field(3, np.ones(len(T)),
                                         np.full(len(T), 0.3))
    with pytest.raises(ValueError):
        hom.homogenize(mesh, mats, precond="multigrid", device="cpu")


def test_dof_map_must_tile_the_torus():
    """An identity dof map (no periodic identification) does not tile the
    torus: the build refuses it."""
    V, T = generators.grid_tet(2, 2, 2)
    mesh = FEMMesh(V, T, degree=2)
    D = MaterialField.isotropic_field(3, np.ones(len(T)),
                                      np.full(len(T), 0.3)).D
    with pytest.raises(ValueError, match="tile the torus"):
        sp.PeriodicVarP2Elasticity.build(mesh, D, np.arange(mesh.num_nodes),
                                         device="cpu")


def test_orthotropic_multigrid_matches_reference():
    """``homogenize_orthotropic(precond='multigrid')`` on the reference
    test's 1000:1 sphere, here at n = 4 (the reference test's n = 6 costs
    the same compiles and a third more solve time): Ch, w, the per-probe
    iterations and timings, and the orthotropic structure."""
    n = 4
    V, T = generators.grid_tet(n, n, n, hi=(0.5, 0.5, 0.5))
    E, nu = _sphere_moduli(V, T, centre=0.25, r2=0.02)
    res = hom.homogenize_orthotropic(
        FEMMesh(V, T, degree=2), MaterialField.isotropic_field(3, E, nu),
        tol=1e-10, precond="multigrid", device="cpu")
    rres = rhom.homogenize_orthotropic(
        RFEMMesh(V, T, degree=2),
        RField.isotropic_field(3, jnp.asarray(E), jnp.asarray(nu)),
        tol=1e-10, precond="multigrid")
    Ch = res.Ch.numpy()
    assert _rel(Ch, rres.Ch) < 1e-8
    assert _rel(res.w.numpy(), rres.w) < 1e-8
    assert all(abs(a - b) <= 1 for a, b in zip(res.cg_iters, rres.cg_iters))
    assert np.abs(res.w.numpy()).max() > 0
    assert [len(res.timings[k]) for k in ("probe_build_s",
                                          "probe_solve_s")] == [6, 6]
    assert np.linalg.eigvalsh(Ch).min() > 0
    assert np.all(Ch[:3, 3:] == 0) and np.all(Ch[3:, 3:][~np.eye(3, dtype=bool)]
                                              == 0)
