"""Periodic homogenization: the port against meshfem_tpu on small cells.

The same numpy arrays go through the JAX function and the port's (CPU,
float64 unless stated).  Tolerances: integer equality for dof maps; 1e-12
relative for element matrices, loads and node blocks (the same float64
arithmetic in another order); 1e-10 for block-CG iterates; 5e-6 of max|y|
for the float32 routed block apply (the reference's tolerance for its own
routed operator); 1e-8 of max|Ch| for the float64 EBE branch and 2e-5 for
the float32 routed branch at tol 1e-10 (the reference's own tolerance,
``tests/test_homogenization.py:206``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.mesh.periodic import match_periodic_nodes as r_match
from meshfem_tpu.physics import Material as RMat, MaterialField as RField
from meshfem_tpu.solvers import cg as rcg, precond as rpc

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators, periodic
from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                       MaterialField)
from meshfem_tpu_torch.solvers import cg as cg_mod, precond as pc
from meshfem_tpu_torch.solvers.refine import refine


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


def _inclusion_moduli(mesh):
    """Soft spherical inclusion (``tests/test_homogenization.py:187-192``)."""
    cent = np.asarray(mesh.V)[np.asarray(mesh.F)].mean(axis=1)
    soft = ((cent - 0.5) ** 2).sum(axis=1) < 0.09
    E = np.where(soft, 0.2, 2.0)
    return E, np.full(len(E), 0.3)


def _void_cell(n=4, degree=1):
    """grid_tet(n) with the tets nearest the centre removed and the
    vertices renumbered (``hole_mesh``, in 3D)."""
    V, T = generators.grid_tet(n, n, n)
    c = V[T].mean(axis=1)
    T2 = T[np.abs(c - 0.5).max(axis=1) > 0.25]
    used = np.unique(T2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[T2].astype(np.int32), degree


@pytest.fixture(scope="module")
def inclusion():
    """P1 grid_tet(3,3,3) soft-inclusion cell in both packages."""
    V, T = rgen.grid_tet(3, 3, 3)
    rmesh = RFEMMesh(V, T, degree=1)
    E, nu = _inclusion_moduli(rmesh)
    rsim = rhom.periodic_simulator(rmesh,
                                   RField.isotropic_field(3, E, nu))
    mesh = FEMMesh(V, T, degree=1)
    sim = hom.periodic_simulator(
        mesh, MaterialField.isotropic_field(3, E, nu), device="cpu")
    return rsim, sim


@pytest.mark.parametrize("n,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_match_periodic_nodes_equal(n, deg):
    V, T = generators.grid_tet(n, n, n)
    mesh = FEMMesh(V, T, degree=deg)
    rmesh = RFEMMesh(V, T, degree=deg)
    dm, nd, fm = periodic.match_periodic_nodes(mesh.node_positions,
                                               mesh.bbox())
    rdm, rnd, rfm = r_match(rmesh.node_positions, rmesh.bbox())
    np.testing.assert_array_equal(dm, rdm)
    assert nd == rnd == (deg * n) ** 3
    np.testing.assert_array_equal(fm.on_min, rfm.on_min)
    np.testing.assert_array_equal(fm.on_max, rfm.on_max)
    assert periodic.cell_face_boundary_elements(mesh).all()


def test_periodic_mismatch_raises():
    V, T = generators.grid_tet(2, 2, 2)
    V = V.copy()
    V[np.flatnonzero(np.isclose(V[:, 0], 1.0))[0], 1] += 0.01
    with pytest.raises(ValueError, match="mismatch"):
        periodic.match_periodic_nodes(V)
    periodic.match_periodic_nodes(V, permit_mismatch=True)


def test_material_field_Ke_and_load(inclusion):
    rsim, sim = inclusion
    assert sim.num_dofs == rsim.num_dofs == 27
    np.testing.assert_array_equal(sim.elem_dofs.numpy(),
                                  np.asarray(rsim.elem_dofs))
    assert _rel(sim.D.numpy(), rsim.D) < 1e-12
    assert _rel(sim.Ke.numpy(), rsim.Ke) < 1e-12
    for i in range(6):
        e = hom.canonical_strain(3, i)
        np.testing.assert_array_equal(e.numpy(),
                                      np.asarray(rhom.canonical_strain(3, i)))
        assert _rel(sim.constant_strain_load(-e).numpy(),
                    rsim.constant_strain_load(-jnp.asarray(e.numpy()))) < 1e-12
    c = MaterialField.constant(3, Material.isotropic(3, 2.0, 0.3).D, 5)
    assert tuple(c.D.shape) == (5, 6, 6)


def test_boundary_geometry_matches_reference():
    V, T, deg = _void_cell(4, 2)
    g = FEMMesh(V, T, degree=deg).geometry("cpu")
    rg = RFEMMesh(V, T, degree=deg).geometry()
    assert _rel(g.bdry_normal.numpy(), rg.bdry_normal) < 1e-12
    assert _rel(g.bdry_volume.numpy(), rg.bdry_volume) < 1e-12


def test_node_blocks_match_reference(inclusion):
    rsim, sim = inclusion
    blocks = pc.node_block_diagonal(sim.Ke, sim.elem_dofs, sim.num_dofs, 3)
    rblocks = rpc.node_block_diagonal(rsim.Ke, rsim.elem_dofs,
                                      rsim.num_dofs, 3)
    assert _rel(blocks.numpy(), rblocks) < 1e-12
    free = np.ones((sim.num_dofs, 3))
    free[::4, 1] = 0.0
    for mask in (None, free):
        inv = pc.block_jacobi_inv(
            blocks, None if mask is None else torch.as_tensor(mask))
        rinv = rpc.block_jacobi_inv(
            rblocks, None if mask is None else jnp.asarray(mask))
        assert _rel(inv.numpy(), rinv) < 1e-12
    r = np.random.default_rng(0).standard_normal((sim.num_dofs, 3, 2))
    M, rM = pc.block_jacobi_apply(inv), rpc.block_jacobi_apply(rinv)
    assert _rel(M(torch.as_tensor(r)).numpy(), rM(jnp.asarray(r))) < 1e-12
    assert _rel(M(torch.as_tensor(r[..., 0])).numpy(),
                rM(jnp.asarray(r[..., 0]))) < 1e-12


def test_chebyshev_and_lambda_max_match_reference(inclusion):
    rsim, sim = inclusion
    proj = hom._project_translations
    rproj = lambda v: v - jnp.mean(v, axis=0, keepdims=True)
    blocks = pc.node_block_diagonal(sim.Ke, sim.elem_dofs, sim.num_dofs, 3)
    M0 = pc.block_jacobi_apply(pc.block_jacobi_inv(blocks))
    rM0 = rpc.block_jacobi_apply(rpc.block_jacobi_inv(jnp.asarray(
        blocks.numpy())))
    Ap = lambda v: proj(sim.apply_K(v))
    rAp = lambda v: rproj(rsim.apply_K(v))
    lmax = pc.estimate_lambda_max(Ap, lambda r: proj(M0(r)),
                                  (sim.num_dofs, 3))
    rlmax = rpc.estimate_lambda_max(rAp, lambda r: rproj(rM0(r)),
                                    (sim.num_dofs, 3))
    assert abs(lmax - rlmax) < 1e-10 * rlmax
    b = np.random.default_rng(1).standard_normal((sim.num_dofs, 3))
    z = pc.chebyshev_preconditioner(Ap, M0, lmax, degree=5,
                                    project=proj)(torch.as_tensor(b))
    rz = rpc.chebyshev_preconditioner(rAp, rM0, rlmax, degree=5,
                                      project=rproj)(jnp.asarray(b))
    assert _rel(z.numpy(), rz) < 1e-10


def test_cg_block_matches_reference():
    """An SPD block problem with one zero column and unequal conditioning:
    the same iterates (1e-10), iteration count and residuals."""
    rng = np.random.default_rng(2)
    Q = rng.standard_normal((40, 40))
    A = Q @ Q.T + 40 * np.eye(40)
    B = rng.standard_normal((40, 4))
    B[:, 2] = 0.0
    d = np.diag(A).copy()
    res = cg_mod.cg_block(lambda X: torch.as_tensor(A) @ X,
                          torch.as_tensor(B),
                          M_inv=lambda r: r / torch.as_tensor(d)[:, None],
                          tol=1e-12, maxiter=500)
    rres = rcg.cg_block(lambda X: jnp.asarray(A) @ X, jnp.asarray(B),
                        M_inv=lambda r: r / jnp.asarray(d)[:, None],
                        tol=1e-12, maxiter=500)
    assert res.iters == int(rres.iters)
    assert _rel(res.x.numpy(), rres.x) < 1e-10
    assert np.abs(A @ res.x.numpy() - B).max() < 1e-10
    # a low iteration cap stops both at the same iterate
    res = cg_mod.cg_block(lambda X: torch.as_tensor(A) @ X,
                          torch.as_tensor(B), tol=1e-12, maxiter=7)
    rres = rcg.cg_block(lambda X: jnp.asarray(A) @ X, jnp.asarray(B),
                        tol=1e-12, maxiter=7)
    assert res.iters == int(rres.iters) == 7
    assert _rel(res.x.numpy(), rres.x) < 1e-10
    assert _rel(res.resnorm.numpy(), rres.resnorm) < 1e-8


def test_mask_projector_on_blocks():
    mask = torch.as_tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    proj, rproj = cg_mod.mask_projector(mask), rcg.mask_projector(
        jnp.asarray(mask.numpy()))
    v = np.random.default_rng(3).standard_normal((3, 2, 4))
    for x in (v, v[..., 0]):
        np.testing.assert_array_equal(proj(torch.as_tensor(x)).numpy(),
                                      np.asarray(rproj(jnp.asarray(x))))


def test_refine_takes_block_right_hand_sides():
    """The norm refine stops on is that of the whole block, as the
    reference's (``refine.py:45-58``)."""
    from meshfem_tpu.solvers.refine import refine as r_refine

    rng = np.random.default_rng(4)
    Q = rng.standard_normal((30, 30))
    A = Q @ Q.T + 30 * np.eye(30)
    B = rng.standard_normal((30, 3, 2))
    A32 = A.astype(np.float32)

    def solve_lo(r32):
        x = np.linalg.solve(A32, np.asarray(r32).reshape(30, 6))
        return x.reshape(30, 3, 2), 1

    ref = refine(lambda X: torch.einsum("ab,bcm->acm", torch.as_tensor(A), X),
                 lambda r: (torch.as_tensor(solve_lo(r.numpy())[0]), 1),
                 torch.as_tensor(B), tol=1e-12)
    rref = r_refine(lambda X: jnp.einsum("ab,bcm->acm", jnp.asarray(A), X),
                    lambda r: (jnp.asarray(solve_lo(r)[0]), 1),
                    jnp.asarray(B), tol=1e-12)
    assert tuple(ref.x.shape) == (30, 3, 2)
    assert ref.rounds == rref.rounds and ref.inner_iters == rref.inner_iters
    assert ref.resnorm <= 1e-12 and _rel(ref.x.numpy(), rref.x) < 1e-10


def test_ebe_block_apply_matches_reference(inclusion):
    rsim, sim = inclusion
    U = np.random.default_rng(5).standard_normal((sim.num_dofs, 3, 6))
    y = sim.apply_K(torch.as_tensor(U))
    assert _rel(y.numpy(), rsim.apply_K(jnp.asarray(U))) < 1e-12
    y0 = sim.apply_K(torch.as_tensor(U[..., 0].copy()))
    assert _rel(y[..., 0].numpy(), y0.numpy()) < 1e-13


@pytest.mark.parametrize("backend", ["dense", "factored", "factored_tq"])
def test_apply_block_matches_reference(backend, monkeypatch):
    """P2 periodic cell, 6 columns: the port's one-pass block apply against
    ``RoutedEBE.apply_block`` (interpret mode), 5e-6 of max|y|."""
    monkeypatch.delenv("MESHFEM_FACTORED_TQ", raising=False)
    if backend == "dense":
        monkeypatch.delenv("MESHFEM_FACTORED", raising=False)
    else:
        monkeypatch.setenv("MESHFEM_FACTORED", "1")
    V, T = rgen.grid_tet(2, 2, 2)
    rsim = rhom.periodic_simulator(RFEMMesh(V, T, degree=2),
                                   RMat.isotropic(3, 2.3, 0.31))
    rk_ref = rsim.routed_kernel(block_rhs=6)
    if backend == "factored_tq":      # the port's switch; same product
        monkeypatch.setenv("MESHFEM_FACTORED_TQ", "1")
    sim = hom.periodic_simulator(FEMMesh(V, T, degree=2),
                                 Material.isotropic(3, 2.3, 0.31),
                                 device="cpu")
    rk = sim.routed_kernel(block_rhs=6)
    assert (rk.KeP is None) == (rk_ref.KeB is None) == (backend != "dense")
    assert rk.bm == 6
    np.testing.assert_array_equal(rk.order.numpy(), np.asarray(rk_ref.order))
    U = np.random.default_rng(6).standard_normal(
        (sim.num_dofs, 3, 6)).astype(np.float32)
    y = rk.permute_out(rk.apply_block(rk.permute_in(torch.as_tensor(U))))
    y_ref = rk_ref.permute_out(rk_ref.apply_block(
        rk_ref.permute_in(jnp.asarray(U))))
    assert _rel(y.numpy(), y_ref) < 5e-6
    y64 = sim.apply_K(torch.as_tensor(U, dtype=torch.float64))
    assert _rel(y.numpy(), y64.numpy()) < 5e-5


def test_routed_from_arrays_block_rhs(inclusion):
    rsim, sim = inclusion
    rk = interop.routed_from_arrays(dict(
        Ke=np.asarray(rsim.Ke), elem_dofs=np.asarray(rsim.elem_dofs),
        num_dofs=rsim.num_dofs, vector_dim=3, block_rhs=6), device="cpu")
    assert rk.bm == 6
    U = np.random.default_rng(7).standard_normal(
        (rsim.num_dofs, 3, 6)).astype(np.float32)
    y64 = rsim.apply_K(jnp.asarray(U, jnp.float64))
    assert _rel(rk.apply_block(torch.as_tensor(U)).numpy(), y64) < 5e-5


@pytest.mark.parametrize("precond", ["jacobi", "block", "chebyshev"])
def test_cell_problems_ebe_match_reference(inclusion, precond):
    rsim, sim = inclusion
    w, iters = hom.solve_cell_problems(sim, tol=1e-11, precond=precond,
                                       operator="ebe")
    rw, riters = rhom.solve_cell_problems(rsim, tol=1e-11, precond=precond,
                                          operator="ebe")
    assert tuple(w.shape) == (6, sim.mesh.num_nodes, 3)
    assert abs(iters[0] - riters[0]) <= 2
    wc = w - w.mean(dim=1, keepdim=True)
    rwc = rw - jnp.mean(rw, axis=1, keepdims=True)
    assert _rel(wc.numpy(), rwc) < 1e-8
    Ch = hom.homogenized_tensor_stress_form(sim, w)
    rCh = rhom.homogenized_tensor_stress_form(rsim, rw)
    assert _rel(Ch.numpy(), rCh) < 1e-8


def test_homogenize_inclusion_matches_reference(inclusion):
    """``homogenize`` end to end, EBE branch (the CPU's 'auto'): 1e-8."""
    rsim, sim = inclusion
    V, T = rsim.mesh.V, rsim.mesh.F
    E, nu = _inclusion_moduli(rsim.mesh)
    res = hom.homogenize(FEMMesh(V, T, degree=1),
                         MaterialField.isotropic_field(3, E, nu), tol=1e-11,
                         device="cpu")
    rres = rhom.homogenize(rsim.mesh, RField.isotropic_field(3, E, nu),
                           tol=1e-11)
    assert _rel(res.Ch.numpy(), rres.Ch) < 1e-8
    assert _rel(res.w.numpy(), rres.w) < 1e-8
    assert _rel(res.strain_w.numpy(), rres.strain_w) < 1e-8
    Ch = res.Ch.numpy()
    assert np.abs(Ch - Ch.T).max() < 1e-9 * np.abs(Ch).max()
    assert np.linalg.eigvalsh(Ch).min() > 0
    G = hom.macro_to_micro_strain(sim, res.w)
    rG = rhom.macro_to_micro_strain(rsim, rres.w)
    assert _rel(G.numpy(), rG) < 1e-8
    e0 = hom.canonical_strain(3, 3)
    u, strain = hom.probe(sim, res.w, e0)
    ru, rstrain = rhom.probe(rsim, rres.w, jnp.asarray(e0.numpy()))
    assert _rel(u.numpy(), ru) < 1e-8 and _rel(strain.numpy(), rstrain) < 1e-8


@pytest.fixture(scope="module")
def inclusion_ebe_Ch(inclusion):
    """The reference's EBE tensor of the inclusion cell (jacobi, tol
    1e-10), shared by the routed cases."""
    rsim, _ = inclusion
    rw, _ = rhom.solve_cell_problems(rsim, tol=1e-10, precond="jacobi",
                                     operator="ebe")
    return rhom.homogenized_tensor_stress_form(rsim, rw)


@pytest.mark.parametrize("precond", ["jacobi", "block"])
def test_cell_problems_routed_dense_match_ebe(inclusion, inclusion_ebe_Ch,
                                              precond):
    """operator='routed' (float32 block CG inside float64 refinement, dense
    backend, MaterialField) against the reference's EBE tensor: 2e-5."""
    rsim, sim = inclusion
    sim._routed = None
    w, iters = hom.solve_cell_problems(sim, tol=1e-10, precond=precond,
                                       operator="routed")
    assert sim._routed is not None and sim._routed.bm == 6
    assert sim._routed.KeP is not None and iters[0] > 0
    Ch = hom.homogenized_tensor_stress_form(sim, w)
    assert _rel(Ch.numpy(), inclusion_ebe_Ch) < 2e-5


def test_void_cell_factored_tq_and_forms(monkeypatch):
    """Constant material, cell with a void, P1: routed factored + TQ (the
    table-form contraction) against the reference's EBE solve (2e-5); the
    stress and displacement forms agree (1e-8) and the void softens."""
    V, T, deg = _void_cell(4, 1)
    rmesh = RFEMMesh(V, T, degree=deg)
    rsim = rhom.periodic_simulator(rmesh, RMat.isotropic(3, 5.0, 0.3))
    rw, _ = rhom.solve_cell_problems(rsim, tol=1e-11, operator="ebe")
    rCh = np.asarray(rhom.homogenized_tensor_stress_form(
        rsim, rw, base_cell_volume=1.0))
    rCh_d = np.asarray(rhom.homogenized_tensor_displacement_form(
        rsim, rw, base_cell_volume=1.0))

    mat = Material.isotropic(3, 5.0, 0.3)
    sim = hom.periodic_simulator(FEMMesh(V, T, degree=deg), mat,
                                 device="cpu")
    w, _ = hom.solve_cell_problems(sim, tol=1e-11, operator="ebe")
    Ch = hom.homogenized_tensor_stress_form(sim, w, 1.0).numpy()
    Ch_d = hom.homogenized_tensor_displacement_form(sim, w, 1.0).numpy()
    assert _rel(Ch, rCh) < 1e-8 and _rel(Ch_d, rCh_d) < 1e-8
    assert np.abs(Ch - Ch_d).max() < 1e-8 * np.abs(Ch).max()
    assert Ch[0, 0] < float(mat.D[0, 0])

    monkeypatch.setenv("MESHFEM_FACTORED", "1")
    monkeypatch.setenv("MESHFEM_FACTORED_TQ", "1")
    sim._routed = None
    wr, _ = hom.solve_cell_problems(sim, tol=1e-10, operator="routed")
    assert sim._routed.KeP is None
    Ch_r = hom.homogenized_tensor_stress_form(sim, wr, 1.0).numpy()
    assert _rel(Ch_r, rCh) < 2e-5


@pytest.mark.parametrize("deg", [1, 2])
def test_uniform_cell_gives_D(deg):
    mat = Material.isotropic(3, 5.0, 0.3)
    mesh = FEMMesh(*generators.grid_tet(2, 2, 2), degree=deg)
    res = hom.homogenize(mesh, mat, tol=1e-12, device="cpu")
    np.testing.assert_allclose(res.Ch.numpy(), mat.D.numpy(), atol=1e-9)
    np.testing.assert_allclose(res.w.numpy(), 0.0, atol=1e-9)


def test_periodic_simulator_solve_and_fields():
    """solve(operator='auto') on a periodic simulator takes the path the
    reference takes (its structured pre-filter needs an identity dof map),
    and ``precond='block'`` / 'chebyshev' agree with it."""
    V, T = rgen.grid_tet(2, 2, 2)
    rmesh = RFEMMesh(V, T, degree=2)
    E = np.linspace(1.0, 3.0, rmesh.num_elements)
    nu = np.full(len(E), 0.3)
    rsim = rhom.periodic_simulator(rmesh, RField.isotropic_field(3, E, nu))
    sim = interop.simulator_from_arrays(dict(
        V=V, T=T, degree=2, D=np.asarray(rsim.D), dof_map=rsim.dof_map),
        device="cpu")
    assert sim.num_dofs == rsim.num_dofs < sim.mesh.num_nodes
    assert not sim._structured_eligible()
    assert _rel(sim.Ke.numpy(), rsim.Ke) < 1e-12
    pinned = np.flatnonzero(np.abs(rmesh.node_positions - 0.5).max(axis=1)
                            < 1e-9)
    dofs = np.unique(rsim.dof_map[pinned])
    load = np.random.default_rng(8).standard_normal((rsim.num_dofs, 3))
    for s in (sim, rsim):
        s.dirichlet_mask[dofs] = True
    rsim.neumann_load = jnp.asarray(load)
    sim.neumann_load = torch.as_tensor(load)
    ru, _ = rsim.solve(tol=1e-12)
    for precond in ("jacobi", "block", "chebyshev"):
        u, res = sim.solve(tol=1e-12, precond=precond)
        assert tuple(u.shape) == (sim.mesh.num_nodes, 3)
        assert tuple(res.x.shape) == (sim.num_dofs, 3)
        assert _rel(u.numpy(), ru) < 1e-8
    ur, _ = sim.solve(tol=1e-10, precond="block", operator="routed")
    assert _rel(ur.numpy(), ru) < 1e-8
    assert abs(float(sim.strain_energy(u)) - float(rsim.strain_energy(ru))) \
        < 1e-8 * abs(float(rsim.strain_energy(ru)))
    assert _rel(sim.average_stress_field(u).numpy(),
                rsim.average_stress_field(ru)) < 1e-7


def test_structured_prefilter_conditions():
    """``_structured_eligible`` carries all of the reference's conditions
    (``elasticity.py:185-193``): with Dirichlet data on a 3000-element P2
    mesh the identity map is eligible, a periodic map is not; nor is a
    simulator built at other node positions (the port's own condition)."""
    mat = Material.isotropic(3, 1.0, 0.3)

    class Probe(ElasticitySimulator):
        def __init__(self, num_dofs, degree=2, rigid=False, deformed=False):
            self.dim, self.D = 3, mat.D
            self.mesh = type("M", (), dict(degree=degree, num_nodes=729,
                                           num_elements=3072))()
            self.num_dofs = num_dofs
            self.no_rigid_motion = rigid
            self.deformed = deformed
            self.dirichlet_mask = np.ones((num_dofs, 3), bool)

    assert Probe(729)._structured_eligible()
    assert not Probe(729, deformed=True)._structured_eligible()
    assert not Probe(512)._structured_eligible()          # periodic ids
    assert not Probe(729, rigid=True)._structured_eligible()
    assert not Probe(729, degree=1)._structured_eligible()
    p = Probe(729)
    p.dirichlet_mask[:] = False
    assert not p._structured_eligible()
    p = Probe(729)
    p.D = torch.zeros(6)
    assert not p._structured_eligible()


def test_unported_options_name_their_roadmap_items():
    """An unknown ``precond`` is a ValueError.  A 2D (pixel) occupancy,
    which raised naming item 3 before triangle meshes were ported, runs: an
    all-solid 2 x 2 pixel cell gives the material's own plane-stress
    tensor."""
    mat = Material.isotropic(3, 5.0, 0.3)
    mesh = FEMMesh(*generators.grid_tet(2, 2, 2), degree=1)
    sim = hom.periodic_simulator(mesh, mat, device="cpu")
    res = hom.homogenize_voxels(np.ones((2, 2)), device="cpu")
    D2 = Material.isotropic(2, 1.0, 0.3).D
    assert float((res.Ch - D2).abs().max()) <= 1e-9 * float(D2.abs().max())
    with pytest.raises(ValueError):
        hom.solve_cell_problems(sim, precond="nope")
    with pytest.raises(ValueError):
        hom.homogenize_orthotropic(mesh, mat, precond="nope", device="cpu")
