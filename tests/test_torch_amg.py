"""The port's unstructured multigrid (``meshfem_tpu_torch/solvers/amg.py``)
against the reference's (``meshfem_tpu/solvers/amg.py``) on the CPU.

The port's routed operator orders elements and nodes exactly as the
reference's does (RCB leaves, then first touch; ``sparse/routed_ebe.py``),
on the fine and on the P1 level, so the hierarchy is compared ENTRY BY
ENTRY in the internal orders, not in user order: the orders themselves
must be equal integer for integer first.  One reference build in all (in
the module fixture), on the smallest clamped P2 grid that still makes an
aggregation level with ``agg_size=12, coarse_target=200`` (grid_tet(3):
64 P1 units -> 6 aggregates), both hierarchies in float64 so the host
pieces agree to 1e-12; the V-cycle (float32 routed operators inside) to
1e-5 of max.  The host helpers ``_rcb_chunks``, ``_tentative_prolongator``
and ``_to_ell`` are held on seeded inputs of their own.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                 Material as RMaterial)
from meshfem_tpu.solvers import amg as ramg

from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.solvers import amg

N_GRID = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _port_cantilever(n, device="cpu", contrast=None):
    V, T = generators.grid_tet(n, n, n)
    mesh = FEMMesh(V, T, degree=2)
    if contrast is None:
        mat = Material.isotropic(3, 200.0, 0.3)
    else:
        from meshfem_tpu_torch.physics import MaterialField

        cent = V[T].mean(axis=1)
        E = np.where(cent[:, 2] > 0.5, 200.0, 200.0 / contrast)
        mat = MaterialField.isotropic_field(3, E, np.full(len(E), 0.3))
    sim = ElasticitySimulator(mesh, mat, device=device)
    X = mesh.node_positions
    sim.dirichlet_mask[X[:, 0] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > 1 - 1e-9, 1] = -0.01
    sim.neumann_load = torch.as_tensor(load)
    return sim


@pytest.fixture(scope="module")
def pair():
    """(reference simulator, its float64 hierarchy, port simulator, its
    float64 hierarchy, the reference's float64 EBE solution)."""
    V, T = rgen.grid_tet(N_GRID, N_GRID, N_GRID)
    rmesh = RFEMMesh(V, T, degree=2)
    rsim = RSim(rmesh, RMaterial.isotropic(3, 200.0, 0.3))
    X = np.asarray(rmesh.node_positions)
    rsim.dirichlet_mask[X[:, 0] < 1e-9] = True
    load = np.zeros((rmesh.num_nodes, 3))
    load[X[:, 0] > 1 - 1e-9, 1] = -0.01
    rsim.neumann_load = jnp.asarray(load)
    rmg = ramg.UnstructuredMG.build(rsim, agg_size=12, coarse_target=200,
                                    dtype=jnp.float64)
    u_ref, _ = rsim.solve(tol=1e-13, operator="ebe")
    psim = _port_cantilever(N_GRID)
    pmg = amg.UnstructuredMG.build(psim, agg_size=12, coarse_target=200,
                                   dtype=torch.float64)
    return rsim, rmg, psim, pmg, np.asarray(u_ref)


def test_rcb_chunks_match():
    pos = np.random.default_rng(3).random((500, 3))
    for size in (12, 32):
        a_p, n_p = amg._rcb_chunks(pos, size)
        a_r, n_r = ramg._rcb_chunks(pos, size)
        assert n_p == n_r and np.array_equal(a_p, a_r)


def test_tentative_prolongator_matches():
    """Rigid modes at seeded positions, a few rows masked, one aggregate
    fully fixed (its columns are rank-dropped): Pblk and the R factors to
    1e-12."""
    rng = np.random.default_rng(4)
    pos = rng.random((200, 3))
    agg_of, n_agg = amg._rcb_chunks(pos, 12)
    B = amg._rigid_modes(pos, 3)
    assert np.array_equal(B, ramg._rigid_modes(pos, 3))
    fixed = rng.random((200, 3)) < 0.1
    fixed[agg_of == 0] = True
    B = B * (~fixed)[:, :, None]
    P_p, R_p = amg._tentative_prolongator(B, agg_of, n_agg)
    P_r, R_r = ramg._tentative_prolongator(B, agg_of, n_agg)
    assert _rel(P_p, P_r) <= 1e-12 and _rel(R_p, R_r) <= 1e-12
    assert np.abs(P_p[agg_of == 0]).max() == 0.0
    S_p = amg._scipy_P(P_p, agg_of, n_agg)
    assert _rel(S_p.toarray(), ramg._scipy_P(P_r, agg_of, n_agg).toarray()) \
        <= 1e-12


def test_to_ell_matches():
    """A seeded symmetric block matrix with an empty block row and a dead
    diagonal entry: the ELL values, neighbours, diagonal and Gershgorin
    bound to 1e-12."""
    rng = np.random.default_rng(5)
    n, b = 30, 6
    A = sp.random(n * b, n * b, density=0.05, random_state=6, format="csr")
    A = (A + A.T + sp.diags(rng.random(n * b) + 10.0)).tolil()
    A[7 * b:8 * b, :] = 0.0
    A[:, 7 * b:8 * b] = 0.0
    A[3 * b + 2, 3 * b + 2] = 0.0
    A = A.tocsr()
    out_p = amg._to_ell(A, b)
    out_r = ramg._to_ell(A, b)
    for p, r in zip(out_p[:3], out_r[:3]):
        assert p.shape == r.shape and _rel(p, r) <= 1e-12
    assert np.array_equal(out_p[1], out_r[1])
    assert abs(out_p[3] - out_r[3]) <= 1e-12 * abs(out_r[3])


def test_hierarchy_matches_reference(pair):
    rsim, rmg, psim, pmg, _ = pair
    prk, rrk = pmg.rk_f, rmg.rk_f
    assert np.array_equal(prk.order.numpy(), np.asarray(rrk.order))
    assert np.array_equal(pmg.rk_c.order.numpy(), np.asarray(rmg.rk_c.order))
    assert (pmg.Nf, pmg.NC) == (rmg.Nf, rmg.NC)
    assert np.array_equal(pmg.free_f.numpy(), np.asarray(rmg.free_f))
    assert np.array_equal(pmg.free_c.numpy(), np.asarray(rmg.free_c))
    assert _rel(pmg.diag_f.numpy(), rmg.diag_f) <= 1e-6     # float32 sums
    assert _rel(pmg.diag_c.numpy(), rmg.diag_c) <= 1e-6
    assert len(pmg.levels) == len(rmg.levels) == 1
    for lp, lr in zip(pmg.levels, rmg.levels):
        assert lp.n_agg == lr.n_agg
        assert np.array_equal(lp.agg_of.numpy(), np.asarray(lr.agg_of))
        assert _rel(lp.Pblk.numpy(), lr.Pblk) <= 1e-12
    assert _rel(pmg.Cinv.numpy(), rmg.Cinv) <= 1e-12
    for lp, lr in zip(pmg.lam, np.asarray(rmg.lam)):
        assert abs(lp - lr) <= 1e-12 * abs(lr)
    # the P2 <-> P1 transfers are adjoint
    rng = np.random.default_rng(7)
    uc = torch.as_tensor(rng.standard_normal((pmg.NC, 3)))
    r = torch.as_tensor(rng.standard_normal((pmg.Nf, 3)))
    lhs = float(torch.vdot(pmg._prolong_f(uc).reshape(-1), r.reshape(-1)))
    rhs = float(torch.vdot(uc.reshape(-1), pmg._restrict_f(r).reshape(-1)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_vcycle_matches_reference(pair):
    """One V-cycle on the same seeded free vectors: the port's against the
    reference's (1e-5 of max), and the reference's own criteria: symmetric
    (1e-4) and positive."""
    rsim, rmg, psim, pmg, _ = pair
    rng = np.random.default_rng(8)
    x = rng.standard_normal((pmg.Nf, 3)) * pmg.free_f.numpy()
    y = rng.standard_normal((pmg.Nf, 3)) * pmg.free_f.numpy()
    Mx = pmg.precondition(torch.as_tensor(x))
    My = pmg.precondition(torch.as_tensor(y))
    Mx_ref = np.asarray(rmg.precondition(jnp.asarray(x)))
    assert _rel(Mx.numpy(), Mx_ref) <= 1e-5
    a = float(np.vdot(y, Mx.numpy()))
    b = float(np.vdot(x, My.numpy()))
    assert abs(a - b) <= 1e-4 * max(abs(a), abs(b))
    assert float(np.vdot(x, Mx.numpy())) > 0


def test_float32_vcycle_on_the_cpu():
    """The default float32 hierarchy (the card's precision) on the port
    alone, with an ELL level (grid_tet(7): 512 units -> 43 -> 4
    aggregates): the ELL apply equals the block matrix it was cut from,
    each restriction is the adjoint of its prolongation, and the cycle is
    symmetric and positive."""
    sim = _port_cantilever(7)
    mg = amg.UnstructuredMG.build(sim, agg_size=12, coarse_target=200)
    assert [lv.n_agg for lv in mg.levels] == [43, 4]
    assert mg.Cinv.dtype == torch.float32 and mg.levels[1].vals is None
    lv, nxt = mg.levels
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.standard_normal((lv.n_agg, 6)), dtype=torch.float32)
    dense = torch.zeros((lv.n_agg * 6, lv.n_agg * 6), dtype=torch.float64)
    for i in range(lv.n_agg):
        for k in range(lv.nbr.shape[1]):
            j = int(lv.nbr[i, k])
            if j < lv.n_agg:
                dense[i * 6:(i + 1) * 6, j * 6:(j + 1) * 6] += \
                    lv.vals[i, k].double()
    assert torch.allclose(dense, dense.t(), atol=1e-5 * float(dense.abs().max()))
    assert _rel(lv.apply(u).double().reshape(-1),
                dense @ u.double().reshape(-1)) <= 1e-5
    for level, n_units, b_f in ((lv, mg.NC, 3), (nxt, lv.n_agg, 6)):
        r = torch.as_tensor(rng.standard_normal((n_units, b_f)))
        uc = torch.as_tensor(rng.standard_normal((level.n_agg, 6)))
        lhs = float(torch.vdot(level.prolong(uc).reshape(-1), r.reshape(-1)))
        rhs = float(torch.vdot(uc.reshape(-1), level.restrict(r).reshape(-1)))
        assert abs(lhs - rhs) <= 1e-12 * abs(rhs)
    x = torch.as_tensor(rng.standard_normal((mg.Nf, 3)),
                        dtype=torch.float32) * mg.free_f
    y = torch.as_tensor(rng.standard_normal((mg.Nf, 3)),
                        dtype=torch.float32) * mg.free_f
    Mx, My = mg.precondition(x), mg.precondition(y)
    a = float(torch.vdot(y.reshape(-1), Mx.reshape(-1)))
    b = float(torch.vdot(x.reshape(-1), My.reshape(-1)))
    assert abs(a - b) <= 1e-4 * max(abs(a), abs(b))
    assert float(torch.vdot(x.reshape(-1), Mx.reshape(-1))) > 0


def test_amg_solve_through_simulator(pair):
    """``solve(operator="routed", precond="amg", tol=1e-9)``: float64
    refinement around float32 MG-PCG, against the reference's float64 EBE
    solution (1e-7 of max|u|)."""
    _, _, psim, _, u_ref = pair
    u, res = psim.solve(tol=1e-9, operator="routed", precond="amg")
    assert res.resnorm <= 1e-9 and res.rounds >= 1
    assert psim._amg is not None
    assert _rel(u.numpy(), u_ref) <= 1e-7
    # a float32 solve (tol >= 1e-5) reuses the cached hierarchy
    mg = psim._amg[1]
    u32, res32 = psim.solve(tol=1e-5, operator="routed", precond="amg")
    assert psim._amg[1] is mg and res32.rounds == 0
    assert _rel(u32.numpy(), u_ref) <= 1e-3


def test_amg_high_contrast():
    """The 1e4-contrast field of the reference's own test: the port's AMG
    (its default build: P1, then the dense coarsest) to 1e-10, against the
    port's float64 EBE solve (held against the reference's in
    ``tests/test_torch_structured.py`` and ``tests/test_torch_bc.py``)."""
    sim = _port_cantilever(N_GRID, contrast=1e4)
    u_ebe, _ = sim.solve(tol=1e-13, operator="ebe", maxiter=20000)
    u, res = sim.solve(tol=1e-10, operator="routed", precond="amg")
    assert res.resnorm <= 1e-10
    assert _rel(u.numpy(), u_ebe.numpy()) <= 1e-7


def test_amg_value_errors(pair):
    """The reference's ValueErrors: an EBE solve, ``no_rigid_motion`` and
    ``x0`` under precond='amg', in both packages."""
    rsim, _, psim, _, _ = pair
    for sim in (psim, rsim):
        with pytest.raises(ValueError, match="routed operator only"):
            sim.solve(operator="ebe", precond="amg")
        with pytest.raises(ValueError, match="no_rigid_motion or x0"):
            sim.solve(operator="routed", precond="amg",
                      x0=np.zeros((sim.num_dofs, 3)))
        sim.no_rigid_motion = True
        try:
            with pytest.raises(ValueError, match="no_rigid_motion or x0"):
                sim.solve(operator="routed", precond="amg")
        finally:
            sim.no_rigid_motion = False
