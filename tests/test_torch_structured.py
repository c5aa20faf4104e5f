"""The port's structured-grid multigrid == meshfem_tpu's, on the CPU in
float64 (seeded numpy inputs, the reference's own problems).

(a) ``validate_kuhn_grid``: the same (n3, h3) on a cube and a box, the same
    ValueError on each kind of defect;
(b) the structured apply (stencil conv minus the gather-form shell
    correction), its diagonal and valid mask against the reference's
    ``StructuredP2Elasticity`` (its lane-packed ``__call__``) and the port's
    f64 ``EBEKernel``, to 1e-12 of max|y|;
(c) the four transfers equal the reference's (1e-15), each restriction its
    prolongation's adjoint (1e-10);
(d) ``StructuredMG.build`` on the clamped grid_tet(8): level shapes, the
    Gershgorin bounds to 1e-12, one V-cycle of a seeded residual to 1e-10;
    with ``exact_lambda`` the P1 bounds to 1e-10;
(e) ``sim.solve(tol=1e-10)`` (auto) on the clamped grid_tet(8) against the
    reference's auto solve: u to 1e-8, MG-PCG iterations within 1;
(f) the host LU coarse solve (small ``dense_cap``) against the port's EBE
    solve, 1e-8; the pseudo-inverse coarse solve with no Dirichlet data;
(g) the inhomogeneous-Dirichlet patch test (reference
    ``test_structured_mg.py:184-203``), 5e-9 absolute;
(h) ``StructuredVarP2Elasticity`` against the reference on seeded
    per-element materials, 1e-12;
(i) a 1000:1 inclusion (``MaterialField``) solved ``auto`` against the
    reference, 1e-8, iterations within 1;
(j) the float32 multigrid inside float64 refinement, forced on the CPU,
    against the reference's float64 u, 1e-7, residual < 1e-9, and the
    rounds' record (``history``) consistent with the result;
(k) a perturbed grid solves under ``auto`` (EBE) and raises ValueError under
    ``structured``, as do ``x0`` and an ineligible mesh.

The reference is imported inside its fixtures, so the ``cuda``-marked cases
(the card's float32 apply and solves against the port's float64 ones on the
CPU) run without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_structured.py``.
"""

import numpy as np
import pytest
import torch

from meshfem_tpu_torch.fem import elasticity_tensor as et
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.ops import structured_mg as smg
from meshfem_tpu_torch.ops.structured import (StructuredP2Elasticity,
                                              validate_kuhn_grid)
from meshfem_tpu_torch.ops.structured_var import StructuredVarP2Elasticity
from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                       MaterialField)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


D_ISO = Material.isotropic(3, 200.0, 0.3).D


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _clamped(n=8):
    """The reference's MG problem (``test_structured_mg.py:90``): x = 0
    clamped, the far face loaded -0.01 in y."""
    V, T = generators.grid_tet(n, n, n)
    mesh = FEMMesh(V, T, degree=2)
    X = mesh.node_positions
    fixed = np.zeros((mesh.num_nodes, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > 1 - 1e-9, 1] = -0.01
    return V, T, mesh, fixed, load


def _inclusion(V, T):
    """Young's moduli of the 1000:1 spherical inclusion
    (``test_structured_var.py:80``)."""
    c = V[T].mean(axis=1)
    return np.where(((c - 0.5) ** 2).sum(axis=1) < 0.08, 1000.0, 1.0)


def _sim(mesh, material, fixed, load, device="cpu"):
    sim = ElasticitySimulator(mesh, material, device=device)
    sim.dirichlet_mask[fixed] = True
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    return sim


def _ref_sim(V, T, material, fixed, load):
    import jax.numpy as jnp
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.physics import ElasticitySimulator as RSim

    sim = RSim(RMesh(V, T, degree=2), material)
    sim.dirichlet_mask[fixed] = True
    sim.neumann_load = jnp.asarray(load)
    return sim


@pytest.fixture(scope="module")
def reference_grid():
    """The reference's auto solve of the clamped grid_tet(8): (sim, u,
    iterations); its cached multigrid serves (d)."""
    from meshfem_tpu.physics import Material as RMat

    V, T, _, fixed, load = _clamped()
    sim = _ref_sim(V, T, RMat.isotropic(3, 200.0, 0.3), fixed, load)
    u, res = sim.solve(tol=1e-10)
    return sim, np.asarray(u), int(res.iters)


@pytest.fixture(scope="module")
def reference_field():
    """The reference's auto solve of the inclusion problem: (u, iters)."""
    import jax.numpy as jnp
    from meshfem_tpu.physics.materials import MaterialField as RMF

    V, T, _, fixed, load = _clamped()
    E_field = _inclusion(V, T)
    mats = RMF.isotropic_field(3, jnp.asarray(E_field),
                               jnp.full(len(E_field), 0.3))
    sim = _ref_sim(V, T, mats, fixed, load)
    u, res = sim.solve(tol=1e-10, operator="auto")
    assert type(sim._mg[1]).__name__ == "VarStructuredMG"
    return np.asarray(u), int(res.iters)


# -- (a) ---------------------------------------------------------------------

@pytest.mark.parametrize("dims,hi", [((4, 4, 4), (1.0, 1.0, 1.0)),
                                     ((3, 4, 5), (1.3, 0.9, 1.1))])
def test_validate_kuhn_grid_matches_reference(dims, hi):
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.ops.structured import validate_kuhn_grid as rvalidate

    V, T = generators.grid_tet(*dims, hi=hi)
    n3, h3 = validate_kuhn_grid(FEMMesh(V, T, degree=2))
    rn3, rh3 = rvalidate(RMesh(V, T, degree=2))
    assert n3 == tuple(rn3) == dims
    np.testing.assert_allclose(h3, rh3, rtol=1e-15)


def _defect(kind):
    V, T = generators.grid_tet(4, 4, 4)
    if kind == "perturbed":
        V = V.copy()
        interior = ((V > 0.1) & (V < 0.9)).all(axis=1)
        V[interior] += 0.01
    elif kind == "off_lattice":       # graded spacing, same vertex counts
        V = V.copy()
        V[:, 0] = V[:, 0] ** 2
    elif kind == "count":
        T = T[:-6]
    elif kind == "non_kuhn":
        # one cube split around the diagonal (1,0,0)-(0,1,1) instead of
        # (0,0,0)-(1,1,1): the same vertices, another tetrahedralization
        V, _ = generators.grid_tet(1, 1, 1)
        p, q, ring = 4, 3, [0, 2, 6, 7, 5, 1]
        T = []
        for i in range(6):
            t = [p, q, ring[i], ring[(i + 1) % 6]]
            if np.linalg.det(V[t[1:]] - V[t[0]]) < 0:
                t[2], t[3] = t[3], t[2]
            T.append(t)
        T = np.asarray(T, dtype=np.int32)
    return V, T


@pytest.mark.parametrize("kind", ["perturbed", "off_lattice", "count",
                                  "non_kuhn", "p1"])
def test_validate_kuhn_grid_rejects_like_reference(kind):
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.ops.structured import validate_kuhn_grid as rvalidate

    V, T = _defect("count" if kind == "p1" else kind)
    if kind == "p1":
        V, T = generators.grid_tet(4, 4, 4)
    deg = 1 if kind == "p1" else 2
    with pytest.raises(ValueError) as ref:
        rvalidate(RMesh(V, T, degree=deg))
    with pytest.raises(ValueError) as port:
        validate_kuhn_grid(FEMMesh(V, T, degree=deg))
    assert str(port.value) == str(ref.value)


# -- (b) ---------------------------------------------------------------------

@pytest.mark.parametrize("dims,hi", [((3, 4, 5), (1.3, 0.9, 1.1)),
                                     ((4, 4, 4), (1.0, 1.0, 1.0))])
def test_structured_apply_matches_reference(dims, hi):
    import jax.numpy as jnp
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.ops.structured import StructuredP2Elasticity as RS
    from meshfem_tpu.physics import Material as RMat

    V, T = generators.grid_tet(*dims, hi=hi)
    mesh = FEMMesh(V, T, degree=2)
    mat = Material.isotropic(3, 200.0, 0.3)
    op = StructuredP2Elasticity.build(mesh, mat.D, device="cpu")
    rop = RS.build(RMesh(V, T, degree=2), RMat.isotropic(3, 200.0, 0.3).D)
    sim = ElasticitySimulator(mesh, mat, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        u = rng.standard_normal((mesh.num_nodes, 3))
        y = op(torch.as_tensor(u)).numpy()
        assert _rel(y, rop(jnp.asarray(u))) < 1e-12
        assert _rel(y, sim.apply_K(torch.as_tensor(u))) < 1e-12
    d = op.from_channels(op.diagonal_channels())
    assert _rel(d, rop.from_channels(rop.diagonal_channels())) < 1e-12
    assert _rel(d, sim.K_diagonal()) < 1e-12
    np.testing.assert_array_equal(op.valid_mask().numpy(),
                                  np.asarray(rop.valid_mask()))


def test_structured_jacobi_cg_matches_ebe():
    """``solve_cg`` (Jacobi PCG in channel space) on a clamped, end-loaded
    grid against the port's EBE solve, 1e-8 (reference
    ``test_structured.py::test_solve_matches_general``)."""
    V, T = generators.grid_tet(3, 3, 3, hi=(2.0, 2.0, 2.0))
    mesh = FEMMesh(V, T, degree=2)
    X = mesh.node_positions
    fixed = np.zeros((mesh.num_nodes, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > 2 - 1e-9, 2] = -0.5
    mat = Material.isotropic(3, 200.0, 0.3)
    op = StructuredP2Elasticity.build(mesh, mat.D, device="cpu")
    u, res = op.solve_cg(load, fixed_mask=fixed, tol=1e-12)
    u_ebe, _ = _sim(mesh, mat, fixed, load).solve(tol=1e-12,
                                                   operator="ebe")
    assert _rel(u, u_ebe) < 1e-8 and res.iters > 0


# -- (c) ---------------------------------------------------------------------

@pytest.mark.parametrize("n3", [(6, 6, 6), (6, 4, 8)])
def test_transfers_match_reference_and_are_adjoint(n3):
    import jax.numpy as jnp
    from meshfem_tpu.ops import structured_mg as rsmg

    rng = np.random.default_rng(1)
    m = tuple(c + 1 for c in n3)
    nc3 = tuple(c // 2 for c in n3)
    v = rng.standard_normal(m + (3,))
    u = rng.standard_normal(m + (8, 3))
    vc = rng.standard_normal(tuple(c + 1 for c in nc3) + (3,))
    t = torch.as_tensor
    pairs = [(smg.prolong_p2(t(v)), rsmg.prolong_p2(jnp.asarray(v))),
             (smg.restrict_p2(t(u)), rsmg.restrict_p2(jnp.asarray(u))),
             (smg.prolong_h(t(vc), n3), rsmg.prolong_h(jnp.asarray(vc), n3)),
             (smg.restrict_h(t(v), nc3), rsmg.restrict_h(jnp.asarray(v),
                                                        nc3))]
    for port, ref in pairs:
        assert port.shape == ref.shape
        assert _rel(port, ref) < 1e-15
    vdot = lambda a, b: float(torch.vdot(a.reshape(-1), b.reshape(-1)))
    assert abs(vdot(smg.prolong_p2(t(v)), t(u))
               - vdot(t(v), smg.restrict_p2(t(u)))) < 1e-10
    assert abs(vdot(smg.prolong_h(t(vc), n3), t(v))
               - vdot(t(vc), smg.restrict_h(t(v), nc3))) < 1e-10


# -- (d) ---------------------------------------------------------------------

def test_mg_build_and_vcycle_match_reference(reference_grid):
    import jax.numpy as jnp

    rsim = reference_grid[0]
    rmg = rsim._mg[1]
    _, _, mesh, fixed, _ = _clamped()
    mg = smg.StructuredMG.build(mesh, D_ISO, fixed_mask=fixed, device="cpu")
    assert [lvl.n3 for lvl in mg.levels] == [lvl.n3 for lvl in rmg.levels]
    assert tuple(mg.coarse_inv.shape) == tuple(rmg.coarse_inv.shape)
    np.testing.assert_allclose(mg.lam, np.asarray(rmg.lam), rtol=1e-12)
    r = np.random.default_rng(2).standard_normal((mesh.num_nodes, 3))
    op = mg.fine
    rc = op.to_channels(torch.as_tensor(r)).reshape(mg.free_ch.shape)
    x = op.from_channels(mg.precondition(rc * mg.free_ch))
    rp = rmg.fine.to_packed(jnp.asarray(r)) * rmg.free_packed
    xr = rmg.fine.from_packed(rmg.precondition(rp))
    assert _rel(x, xr) < 1e-10


def test_mg_exact_lambda_matches_reference():
    """Power-iteration bounds: the P1 levels from the same seeded start
    vector as the reference (1e-10); the P2 level's start vector lies in
    the reference's packed layout, so it agrees to the iteration's own
    accuracy (5%)."""
    import jax.numpy as jnp
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.ops.structured_mg import StructuredMG as RMG
    from meshfem_tpu.physics import Material as RMat

    V, T, mesh, fixed, _ = _clamped(4)
    mg = smg.StructuredMG.build(mesh, D_ISO, fixed_mask=fixed,
                                exact_lambda=True, device="cpu")
    rmg = RMG.build(RMesh(V, T, degree=2), RMat.isotropic(3, 200.0, 0.3).D,
                    fixed_mask=jnp.asarray(fixed), exact_lambda=True)
    np.testing.assert_allclose(mg.lam[1:], np.asarray(rmg.lam)[1:],
                               rtol=1e-10)
    assert abs(mg.lam[0] / float(rmg.lam[0]) - 1) < 0.05


# -- (e) ---------------------------------------------------------------------

def test_auto_solve_matches_reference(reference_grid):
    _, u_ref, iters_ref = reference_grid
    _, _, mesh, fixed, load = _clamped()
    sim = _sim(mesh, Material.isotropic(3, 200.0, 0.3), fixed, load)
    u, res = sim.solve(tol=1e-10)
    assert type(sim._mg[1]) is smg.StructuredMG
    assert sim._mg[1].free_ch.dtype == torch.float64
    assert _rel(u, u_ref) < 1e-8
    assert abs(res.iters - iters_ref) <= 1
    # the cached multigrid serves a second load; a new mask rebuilds it
    mg = sim._mg[1]
    sim.solve(extra_load=torch.as_tensor(load), tol=1e-10)
    assert sim._mg[1] is mg


# -- (f) ---------------------------------------------------------------------

def test_splu_coarse_path_matches_ebe():
    """Odd chain tail: 6 -> 3, whose 192 dofs exceed ``dense_cap=100``, so
    the coarsest solve is the host LU."""
    _, _, mesh, fixed, load = _clamped(6)
    mg = smg.StructuredMG.build(mesh, D_ISO, fixed_mask=fixed, dense_cap=100,
                                device="cpu")
    assert mg.coarse_inv is None and mg._coarse_lu is not None
    assert [lvl.n3 for lvl in mg.levels] == [(6, 6, 6), (3, 3, 3)]
    u, res = mg.solve(torch.as_tensor(load), tol=1e-12)
    sim = _sim(mesh, Material.isotropic(3, 200.0, 0.3), fixed, load)
    u_ebe, _ = sim.solve(tol=1e-12, operator="ebe")
    assert _rel(u, u_ebe) < 1e-8
    assert res.iters <= 40


def test_pure_neumann_pinv_coarse_is_spd():
    """No Dirichlet data: the coarsest matrix is singular and the build
    takes its pseudo-inverse; the V-cycle stays finite and positive on a
    translation-free residual (reference ``test_structured_mg.py:206``)."""
    mesh = FEMMesh(*generators.grid_tet(6, 6, 6), degree=2)
    mg = smg.StructuredMG.build(mesh, D_ISO, device="cpu")
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (mesh.num_nodes, 3)))
    r = r - r.mean(dim=0, keepdim=True)
    rc = mg.fine.to_channels(r).reshape(mg.free_ch.shape) * mg.free_ch
    x = mg.precondition(rc)
    assert bool(torch.isfinite(x).all())
    assert float(torch.vdot(rc.reshape(-1), x.reshape(-1))) > 0


# -- (g) ---------------------------------------------------------------------

def test_dirichlet_patch_test():
    """A uniaxially stretched isotropic block reproduces the linear field
    u = (0.1 x, -nu 0.1 y, -nu 0.1 z) through the inhomogeneous-Dirichlet
    solve."""
    mesh = FEMMesh(*generators.grid_tet(6, 6, 6), degree=2)
    X = mesh.node_positions
    fixed = np.zeros((mesh.num_nodes, 3), bool)
    fixed[(X[:, 0] < 1e-9) | (X[:, 0] > 1 - 1e-9)] = True
    nu = 0.3
    vals = np.stack([0.1 * X[:, 0], -nu * 0.1 * X[:, 1],
                     -nu * 0.1 * X[:, 2]], axis=1)
    mg = smg.StructuredMG.build(mesh, D_ISO, fixed_mask=fixed, device="cpu")
    u, _ = mg.solve(torch.zeros((mesh.num_nodes, 3), dtype=torch.float64),
                    fixed_values=torch.as_tensor(vals))
    np.testing.assert_allclose(u.numpy(), vals, atol=5e-9)


# -- (h) ---------------------------------------------------------------------

def test_var_apply_matches_reference():
    import jax.numpy as jnp
    from meshfem_tpu.mesh import FEMMesh as RMesh
    from meshfem_tpu.ops.structured_var import (
        StructuredVarP2Elasticity as RV)

    V, T = generators.grid_tet(4, 4, 4, hi=(1.3, 0.9, 1.1))
    mesh = FEMMesh(V, T, degree=2)
    rng = np.random.default_rng(0)
    young = np.exp(rng.standard_normal(mesh.num_elements))
    D = et.isotropic(3, torch.as_tensor(young),
                     torch.full((len(young),), 0.3, dtype=torch.float64))
    op = StructuredVarP2Elasticity.build(mesh, D, device="cpu")
    rop = RV.build(RMesh(V, T, degree=2), D.numpy())
    sim = ElasticitySimulator(mesh, D, device="cpu")
    u = rng.standard_normal((mesh.num_nodes, 3))
    y = op(torch.as_tensor(u))
    assert _rel(y, rop(jnp.asarray(u))) < 1e-12
    assert _rel(y, sim.apply_K(torch.as_tensor(u))) < 1e-12
    d = op.from_channels(op.diagonal_channels())
    assert _rel(d, rop.from_channels(rop.diagonal_channels())) < 1e-12
    np.testing.assert_array_equal(op.valid_mask_channels().numpy(),
                                  np.asarray(rop.valid_mask_channels()))


# -- (i) ---------------------------------------------------------------------

def test_material_field_auto_matches_reference(reference_field):
    u_ref, iters_ref = reference_field
    V, T, mesh, fixed, load = _clamped()
    young = _inclusion(V, T)
    mat = MaterialField.isotropic_field(3, young, np.full(len(young), 0.3))
    sim = _sim(mesh, mat, fixed, load)
    u, res = sim.solve(tol=1e-10, operator="auto")
    assert type(sim._mg[1]) is smg.VarStructuredMG
    assert _rel(u, u_ref) < 1e-8
    assert abs(res.iters - iters_ref) <= 1


# -- (j) ---------------------------------------------------------------------

def test_f32_multigrid_inside_refinement(reference_grid):
    """The branch CUDA takes, forced on the CPU by caching a float32
    multigrid (as the reference's own test does, :223-248)."""
    _, u_ref, _ = reference_grid
    _, _, mesh, fixed, load = _clamped()
    sim = _sim(mesh, Material.isotropic(3, 200.0, 0.3), fixed, load)
    mg32 = smg.StructuredMG.build(mesh, sim.D, fixed_mask=sim.dirichlet_mask,
                                  dtype=torch.float32, device="cpu")
    sim._mg = (sim.dirichlet_mask.tobytes(), mg32)
    u, res = sim.solve(tol=1e-10)
    assert sim._mg[1] is mg32 and res.rounds >= 2
    assert u.dtype == torch.float64
    assert _rel(u, u_ref) < 1e-7
    assert res.resnorm < 1e-9
    # the rounds' record: from the zero start, each round's residual below
    # the one before, the inner iterations summing to ``iters``
    rels = [rel for rel, _ in res.history]
    assert len(res.history) == res.rounds and abs(rels[0] - 1.0) < 1e-15
    assert all(b < a for a, b in zip(rels, rels[1:] + [res.resnorm]))
    assert sum(it for _, it in res.history) == res.iters


# -- (k) ---------------------------------------------------------------------

def test_non_grid_falls_back_and_structured_raises():
    V, T, mesh, fixed, load = _clamped()
    V2 = V.copy()
    interior = ((V2 > 0.1) & (V2 < 0.9)).all(axis=1)
    V2[interior] += 0.01
    sim = _sim(FEMMesh(V2, T, degree=2), Material.isotropic(3, 200.0, 0.3),
               fixed, load)
    assert sim._structured_eligible()
    with pytest.raises(ValueError, match="not a Kuhn-subdivided box grid"):
        sim.solve(operator="structured")
    u, res = sim.solve(tol=1e-10, operator="auto")
    assert sim._mg is None and res.rounds == 0
    assert bool(torch.isfinite(u).all())
    grid = _sim(mesh, Material.isotropic(3, 200.0, 0.3), fixed, load)
    with pytest.raises(ValueError, match="x0"):
        grid.solve(operator="structured",
                   x0=torch.zeros((mesh.num_nodes, 3)))
    small = FEMMesh(*generators.grid_tet(4, 4, 4), degree=2)   # 384 tets
    sim_small = _sim(small, Material.isotropic(3, 200.0, 0.3),
                     small.node_positions[:, 0] < 1e-9,
                     np.zeros((small.num_nodes, 3)))
    with pytest.raises(ValueError, match="requires a 3D P2 mesh"):
        sim_small.solve(operator="structured")


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(6, 5, 4), (8, 8, 8)])
def test_cuda_structured_apply_matches_cpu(cuda, dims):
    """The card's float32 conv apply and shell correction (kernels A and
    B) against the float64 apply on the CPU, 1e-5 of max|y|."""
    from meshfem_tpu_torch import kernels

    mesh = FEMMesh(*generators.grid_tet(*dims), degree=2)
    op = StructuredP2Elasticity.build(mesh, D_ISO, dtype=torch.float32,
                                      device=cuda)
    op64 = StructuredP2Elasticity.build(mesh, D_ISO, device="cpu")
    u = np.random.default_rng(3).standard_normal((mesh.num_nodes, 3))
    kernels.reset_launch_counts()
    y = op(torch.as_tensor(u, dtype=torch.float32, device=cuda))
    torch.cuda.synchronize()
    assert kernels.gather_rows.launches == 1
    assert kernels.segment_sum_rows.launches == 1
    assert _rel(y.cpu().double(), op64(torch.as_tensor(u))) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("field", [False, True])
def test_cuda_mg_solve_matches_cpu(cuda, field):
    """``sim.solve(tol=1e-10)`` on the card (float32 multigrid inside
    float64 refinement) against the float64 solve on the CPU, 1e-7."""
    V, T, mesh, fixed, load = _clamped()
    mat = Material.isotropic(3, 200.0, 0.3)
    if field:
        young = _inclusion(V, T)
        mat = MaterialField.isotropic_field(3, young,
                                            np.full(len(young), 0.3))
    u_card, res = _sim(mesh, mat, fixed, load, cuda).solve(tol=1e-10)
    u_cpu, _ = _sim(mesh, mat, fixed, load).solve(tol=1e-10)
    assert res.rounds >= 2 and res.resnorm < 1e-9
    assert _rel(u_card.cpu(), u_cpu) < 1e-7
