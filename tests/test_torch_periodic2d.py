"""The 2D pixel-cell torus multigrid (``ops/structured_periodic2d.py``) and
``homogenize_voxels`` on a pixel array: the port against meshfem_tpu on
small right-diagonal pixel grids, both on the CPU in float64.

Tolerances: 1e-14 (absolute, unit-size inputs) for the torus transfers,
which do the same additions; 1e-10 for their adjoint identities; 1e-12
relative for the operator, its diagonal, the P1 cell matrices and one
V-cycle against the reference (the same float64 products summed in another
order), 1e-13 against the port's own float64 EBE operator; 1e-10 of
max|Ch| for the homogenized tensors, with equal iteration counts.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.ops import structured_periodic2d as rsp
from meshfem_tpu.physics.materials import MaterialField as RField

from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.ops import structured_periodic2d as sp
from meshfem_tpu_torch.physics import MaterialField


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _disc_moduli(V, F, contrast=1000.0):
    c = V[F].mean(axis=1)
    E = np.where(((c - 0.5) ** 2).sum(axis=1) < 0.06, contrast, 1.0)
    return E, np.full(len(E), 0.3)


@pytest.fixture(scope="module")
def pixel_cell():
    """grid_tri(8, 8, 'right') P2 with a 1000:1 disc (the reference test's
    cell, ``test_structured_periodic.py:145-152``): the port's and the
    reference's periodic simulators and torus operators."""
    V, F = generators.grid_tri(8, 8, diagonal="right")
    E, nu = _disc_moduli(V, F)
    mats = MaterialField.isotropic_field(2, E, nu)
    rmats = RField.isotropic_field(2, jnp.asarray(E), jnp.asarray(nu))
    mesh, rmesh = FEMMesh(V, F, degree=2), RFEMMesh(V, F, degree=2)
    sim = hom.periodic_simulator(mesh, mats, device="cpu")
    rsim = rhom.periodic_simulator(rmesh, rmats)
    D = np.asarray(rmats.D)
    op = sp.PeriodicVarP2Elasticity2D.build(mesh, D, sim.dof_map,
                                            device="cpu")
    rop = rsp.PeriodicVarP2Elasticity2D.build(rmesh, D, rsim.dof_map)
    return dict(mesh=mesh, rmesh=rmesh, mats=mats, rmats=rmats, sim=sim,
                rsim=rsim, op=op, rop=rop, D=D)


def test_transfers_match_reference_and_are_adjoint():
    """The four transfers equal the reference's (1e-14) and each
    restriction is its prolongation's adjoint (1e-10, the reference test's
    ``test_structured_periodic.py:123-139``), with and without a column
    axis."""
    rng = np.random.default_rng(0)
    m = 4
    v = rng.standard_normal((m, m, 2))
    u = rng.standard_normal((m, m, 4, 2))
    vc = rng.standard_normal((m // 2, m // 2, 2))
    uf = rng.standard_normal((m, m, 2))
    T = torch.as_tensor
    pairs = [(sp.torus2d_prolong_p2, rsp.torus2d_prolong_p2, v),
             (sp.torus2d_restrict_p2, rsp.torus2d_restrict_p2, u),
             (sp.torus2d_prolong_h, rsp.torus2d_prolong_h, vc),
             (sp.torus2d_restrict_h, rsp.torus2d_restrict_h, uf)]
    for f, rf, x in pairs:
        np.testing.assert_allclose(f(T(x)).numpy(), np.asarray(rf(
            jnp.asarray(x))), rtol=0, atol=1e-14)
        cols = np.stack([x, 2 * x + 1, -x], axis=-1)       # trailing column
        got = f(T(cols)).numpy()
        for j in range(3):
            np.testing.assert_allclose(got[..., j], f(T(cols[..., j]))
                                       .numpy(), rtol=0, atol=1e-14)
    assert abs(float(torch.vdot(sp.torus2d_prolong_p2(T(v)).reshape(-1),
                                T(u).reshape(-1))
                     - torch.vdot(T(v).reshape(-1),
                                  sp.torus2d_restrict_p2(T(u)).reshape(-1)))
               ) < 1e-10
    assert abs(float(torch.vdot(sp.torus2d_prolong_h(T(vc)).reshape(-1),
                                T(uf).reshape(-1))
                     - torch.vdot(T(vc).reshape(-1),
                                  sp.torus2d_restrict_h(T(uf)).reshape(-1)))
               ) < 1e-10


def test_torus_operator_matches_ebe_and_reference(pixel_cell):
    """The torus apply against the port's own float64 periodic EBE operator
    (1e-13) and the reference's torus apply (1e-12), one column and a
    block of 3; its diagonal against the reference's (1e-12)."""
    op, rop, sim = pixel_cell["op"], pixel_cell["rop"], pixel_cell["sim"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((sim.num_dofs, 2, 3))
    X = torch.as_tensor(x)
    y = op(X)
    assert _rel(y.numpy(), sim.apply_K(X).numpy()) < 1e-13
    for j in range(3):
        ry = np.asarray(rop(jnp.asarray(x[..., j])))
        assert _rel(y[..., j].numpy(), ry) < 1e-12
        assert _rel(op(X[..., j]).numpy(), ry) < 1e-12
    assert _rel(op.diagonal_channels().numpy(),
                rop.diagonal_channels()) < 1e-12


def test_p1_cells_and_coarsening_match_reference(pixel_cell):
    """The per-pixel P1 matrices and their dyadic Galerkin coarsening
    against the reference's (1e-12)."""
    Kc = sp._p1_cell_matrices_var2d(pixel_cell["mesh"], pixel_cell["D"])
    rKc = rsp._p1_cell_matrices_var2d(pixel_cell["rmesh"], pixel_cell["D"])
    assert _rel(Kc, rKc) < 1e-12
    assert _rel(sp._coarsen_2d(Kc), rsp._coarsen_2d(np.asarray(rKc))) \
        < 1e-12
    np.testing.assert_array_equal(sp._h_reduction_2d(),
                                  rsp._h_reduction_2d())


@pytest.mark.parametrize("n,dense_cap", [(8, 32), (6, 4)])
def test_vcycle_matches_reference(n, dense_cap):
    """One V-cycle of ``PeriodicVarMG2D`` against the reference's on the
    same residual (1e-12), its smoothing bounds to 1e-12: two levels with
    the dense pseudo-inverse at 8^2 (dense_cap 32), and an odd 3^2 coarsest
    level through host SuperLU at 6^2 (dense_cap 4); three columns at once
    equal three single ones (1e-14)."""
    V, F = generators.grid_tri(n, n, diagonal="right")
    E, nu = _disc_moduli(V, F)
    mats = MaterialField.isotropic_field(2, E, nu)
    mesh, rmesh = FEMMesh(V, F, degree=2), RFEMMesh(V, F, degree=2)
    sim = hom.periodic_simulator(mesh, mats, device="cpu")
    D = mats.D.numpy()
    mg = sp.PeriodicVarMG2D.build(mesh, D, sim.dof_map, dense_cap=dense_cap,
                                  device="cpu")
    rmg = rsp.PeriodicVarMG2D.build(rmesh, D, sim.dof_map,
                                    dense_cap=dense_cap)
    assert len(mg.levels) == len(rmg.levels)
    assert (mg.coarse_inv is None) == (rmg.coarse_inv is None)
    np.testing.assert_allclose(mg.lam, rmg.lam, rtol=1e-12)
    rng = np.random.default_rng(n)
    r = rng.standard_normal((n, n, 4, 2, 3))
    r -= r.mean(axis=(0, 1, 2), keepdims=True)
    got = mg.precondition(torch.as_tensor(r)).numpy()
    for j in range(3):
        one = mg.precondition(torch.as_tensor(r[..., j])).numpy()
        assert _rel(got[..., j], one) < 1e-14
    assert _rel(got[..., 0], rmg.precondition(jnp.asarray(r[..., 0]))) \
        < 1e-12


def test_multigrid_homogenize_matches_reference(pixel_cell):
    """``homogenize(precond="multigrid")`` on the 8^2 disc cell: Ch against
    the reference's multigrid (1e-10), equal iteration counts, and the port's
    own block-Jacobi Ch (1e-7, the reference test's bound between the two
    solvers at tol 1e-9)."""
    mesh, mats = pixel_cell["mesh"], pixel_cell["mats"]
    res = hom.homogenize(mesh, mats, tol=1e-9, precond="multigrid",
                         device="cpu")
    ref = rhom.homogenize(pixel_cell["rmesh"], pixel_cell["rmats"], tol=1e-9,
                          precond="multigrid")
    assert _rel(res.Ch.numpy(), ref.Ch) < 1e-10
    assert res.cg_iters == list(ref.cg_iters)
    blk = hom.homogenize(mesh, mats, tol=1e-11, precond="block",
                         device="cpu")
    assert _rel(res.Ch.numpy(), blk.Ch.numpy()) < 1e-7
    assert max(res.cg_iters) * 3 < blk.cg_iters[0]


def test_homogenize_pixels_matches_reference():
    """``homogenize_voxels`` on the reference test's 8^2 cross of struts
    (``test_structured_periodic.py:164-175``): Ch against the reference
    (1e-10), the same block-CG iterations (< 60), SPD with square
    symmetry; every column's residual through the port's float64 periodic
    EBE operator <= 1e-8 of its load."""
    occ = np.zeros((8, 8), bool)
    occ[3:5, :] = True
    occ[:, 3:5] = True
    res = hom.homogenize_voxels(occ, E_solid=1.0, nu=0.3, device="cpu")
    ref = rhom.homogenize_voxels(occ, E_solid=1.0, nu=0.3)
    Ch = res.Ch.numpy()
    assert _rel(Ch, ref.Ch) < 1e-10
    assert res.cg_iters == list(ref.cg_iters) and max(res.cg_iters) < 60
    d = np.diag(Ch)
    assert np.linalg.eigvalsh(Ch).min() > 0 and d.max() < 1.0
    assert abs(d[0] - d[1]) < 1e-8
    V, F = generators.grid_tri(8, 8, diagonal="right")
    E = np.repeat(np.where(occ.reshape(-1), 1.0, 1e-6), 2)
    sim = hom.periodic_simulator(
        FEMMesh(V, F, degree=2),
        MaterialField.isotropic_field(2, E, np.full(len(E), 0.3)),
        device="cpu")
    loads = hom._cell_loads(sim)
    wd = torch.zeros((sim.num_dofs, 2, 3), dtype=torch.float64)
    wd[sim._dof_map_t] = res.w.movedim(0, -1)
    r = hom._project_translations(loads - sim.apply_K(wd))
    for j in range(3):
        assert float(r[..., j].norm() / loads[..., j].norm()) < 1e-8


def test_pixel_grid_checks():
    """The alternating diagonal fails the pixel-grid check, a shuffled
    right-diagonal grid fails the element-order check, and a P1 mesh is
    refused: each a ValueError, as in the reference."""
    V, F = generators.grid_tri(4, 4)
    with pytest.raises(ValueError, match="uniform pixel grid"):
        sp.validate_pixel_grid(FEMMesh(V, F, degree=2))
    V, F = generators.grid_tri(4, 4, diagonal="right")
    F2 = F[np.random.default_rng(0).permutation(len(F))]
    mesh = FEMMesh(V, F2, degree=2)
    n2, h2 = sp.validate_pixel_grid(mesh)
    with pytest.raises(ValueError, match="grid_tri order"):
        sp.check_pixel_element_order(mesh, n2, h2)
    with pytest.raises(ValueError):
        sp.validate_pixel_grid(FEMMesh(V, F, degree=1))
