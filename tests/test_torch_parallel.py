"""The port's multi-device layer (``meshfem_tpu_torch/parallel/``) against
the reference's (``meshfem_tpu/parallel/``) on the CPU.

The reference runs ``shard_map`` over the eight virtual CPU devices that
``tests/conftest.py`` provides; the port runs every shard in this process
(``LocalShards``).  The decomposition's arrays are compared exactly (the
element stiffness is carried across through ``interop``), the solves to
1e-9 of max|u| (the port sums in another order), the routed shard apply
(the plain versions of kernels A and B here) to 1e-5 of max|y| of the
reference's Pallas kernels in interpret mode.  The reference's
``shard_map`` compiles dominate the file, so the solver variants run at
S = 4 only and share one problem.  The gloo ranks are held against
``LocalShards`` in ``tests/test_torch_parallel_ranks.py``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.parallel import domain as rdom, sharded as rsh
from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                 Material as RMat)

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.parallel import (DDCoarse, DomainDecomposition,
                                        LocalShards, ShardedEBE,
                                        dd_cg_solve, dryrun_multidevice,
                                        pad_elements,
                                        sharded_elasticity_solve,
                                        sharded_elasticity_solve_multichip)

S_SOLVE = 4


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


def _port_sim(rsim, V, T, **extra):
    return interop.simulator_from_arrays(
        dict(V=V, T=T, degree=2, D=np.asarray(rsim.D),
             Ke=np.asarray(rsim.Ke), **extra), device="cpu")


def _mesh(S, cols=None):
    devs = np.asarray(jax.devices()[:S * (cols or 1)])
    if cols is None:
        return Mesh(devs, axis_names=("e",))
    return Mesh(devs.reshape(S, cols), axis_names=("e", "b"))


@pytest.fixture(scope="module")
def clamped():
    """grid_tet(5, 4, 3) P2 clamped on x = 0, a seeded load, both sims."""
    V, T = rgen.grid_tet(5, 4, 3)
    rmesh = RFEMMesh(V, T, degree=2)
    rsim = RSim(rmesh, RMat.isotropic(3, 10.0, 0.3))
    sim = _port_sim(rsim, V, T)
    fixed = np.zeros((sim.num_dofs, 3), dtype=bool)
    fixed[rmesh.nodes_in_box((0, 0, 0), (0, 1, 1))] = True
    rng = np.random.default_rng(1)
    b = rng.standard_normal((sim.num_dofs, 3))
    b[fixed] = 0.0
    return rsim, sim, ~fixed, b


@pytest.fixture(scope="module")
def periodic():
    """A periodic grid_tet(4) P2 cell (periodic dof_map)."""
    V, T = rgen.grid_tet(4, 4, 4)
    rsim = rhom.periodic_simulator(RFEMMesh(V, T, degree=2),
                                   RMat.isotropic(3, 5.0, 0.3))
    sim = _port_sim(rsim, V, T, dof_map=np.asarray(rsim.dof_map))
    return rsim, sim


@pytest.fixture(scope="module")
def dd4(clamped):
    rsim, sim, _, _ = clamped
    return (rdom.DomainDecomposition.from_simulator(rsim, S_SOLVE),
            DomainDecomposition.from_simulator(sim, S_SOLVE))


INT_FIELDS = ("perm", "ld_int", "ld_bnd", "send_idx", "halo_take",
              "halo_counts")
FLOAT_FIELDS = ("Ke_int", "Ke_bnd", "diag_s", "blocks_s")


@pytest.mark.parametrize("case,S", [("clamped", 2), ("clamped", 4),
                                    ("clamped", 8), ("periodic", 2),
                                    ("periodic", 4), ("periodic", 8)])
def test_dd_arrays_match_reference(case, S, request):
    rsim, sim = request.getfixturevalue(case)[:2]
    ref = rdom.DomainDecomposition.from_simulator(rsim, S)
    dd = DomainDecomposition.from_simulator(sim, S)
    assert (dd.n_shards, dd.num_dofs, dd.Nl, dd.H, dd.K, dd.d) == \
        (ref.n_shards, ref.num_dofs, ref.Nl, ref.H, ref.K, ref.d)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(dd, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in FLOAT_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(dd, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f
    # the true element counts: padding rows are zero in both
    for s in range(S):
        assert not np.asarray(ref.Ke_int)[s, dd.n_int[s]:].any()
        assert not np.asarray(ref.Ke_bnd)[s, dd.n_bnd[s]:].any()
    assert dd.comms_volume_per_spmv() == ref.comms_volume_per_spmv()
    u = np.random.default_rng(S).standard_normal((sim.num_dofs, 3, 2))
    us = dd.to_sharded(torch.as_tensor(u))
    assert np.array_equal(us.numpy(), np.asarray(ref.to_sharded(u)))
    assert np.array_equal(dd.from_sharded(us).numpy(), u)


def test_dd_coarse_matches_reference(clamped, dd4):
    rsim, sim, free, _ = clamped
    ref = rdom.DDCoarse.from_simulator(rsim, dd4[0], agg_size=24,
                                       free_mask=free)
    co = DDCoarse.from_simulator(sim, dd4[1], agg_size=24, free_mask=free)
    assert (co.n_agg, co.nm) == (ref.n_agg, ref.nm)
    for f in ("aggA", "aggB"):
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(co, f))
    for f in ("WA", "WB"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(co, f).numpy()), f
    Cinv = np.asarray(ref.Cinv)
    assert np.abs(co.Cinv.numpy() - Cinv).max() <= 1e-10 * np.abs(Cinv).max()


@pytest.mark.parametrize("variant", ["jacobi", "block", "block+coarse"])
def test_dd_solve_matches_reference(variant, clamped, dd4):
    rsim, sim, free, b = clamped
    ref, dd = dd4
    kw = {"precond": "jacobi" if variant == "jacobi" else "block"}
    rkw, pkw = dict(kw), dict(kw)
    if variant == "block+coarse":
        rkw["coarse"] = rdom.DDCoarse.from_simulator(rsim, ref, agg_size=24,
                                                     free_mask=free)
        pkw["coarse"] = DDCoarse.from_simulator(sim, dd, agg_size=24,
                                                free_mask=free)
    u_ref, r2_ref = rdom.dd_cg_solve(_mesh(S_SOLVE), ref, b,
                                     free_mask=free, iters=30, **rkw)
    u, r2 = dd_cg_solve(dd, b, LocalShards(S_SOLVE, "cpu"), free_mask=free,
                        iters=30, **pkw)
    assert u.shape == (sim.num_dofs, 3) and r2.dim() == 0
    assert _rel(u.numpy(), u_ref) <= 1e-9
    assert abs(float(r2) - float(r2_ref)) <= 1e-9 * float(r2_ref)


def test_dd_solve_rhs_axis_matches_reference(clamped, dd4):
    """Three columns over 2 column groups (padded to 4), as the
    reference's ("e", "b") mesh splits them."""
    _, sim, free, _ = clamped
    ref, dd = dd4
    B = np.random.default_rng(2).standard_normal((sim.num_dofs, 3, 3))
    B *= free[..., None]
    U_ref, r2_ref = rdom.dd_cg_solve(_mesh(S_SOLVE, 2), ref, B,
                                     free_mask=free, iters=25,
                                     precond="block", rhs_axis="b")
    U, r2 = dd_cg_solve(dd, B, LocalShards(S_SOLVE, "cpu", col_groups=2),
                        free_mask=free, iters=25, precond="block")
    assert U.shape == B.shape and r2.shape == (3,)
    assert _rel(U.numpy(), U_ref) <= 1e-9
    assert np.abs(r2.numpy() - np.asarray(r2_ref)).max() \
        <= 1e-9 * np.asarray(r2_ref).max()


def test_dd_tol_path_matches_reference(clamped, dd4):
    """The chunked tol path (chunk=25): the same stop.  Past the tolerance
    the recursive residual is ~1e-7 of |b|, where the two sums' orders
    (u agrees to 1e-9 of max|u|) move res2 by a few percent; a chunk more
    or less would move it by orders of magnitude."""
    _, sim, free, b = clamped
    ref, dd = dd4
    u_ref, r2_ref = rdom.dd_cg_solve(_mesh(S_SOLVE), ref, b, free_mask=free,
                                     iters=400, tol=1e-6, chunk=25)
    stats = {}
    u, r2 = dd_cg_solve(dd, b, None, free_mask=free, iters=400, tol=1e-6,
                        chunk=25, stats=stats)
    b2 = float(np.sum(b * b))
    assert float(r2) <= 1e-12 * b2 and stats["iters"] % 25 == 0
    assert stats["iters"] == 25 * stats["chunks"] < 400
    assert _rel(u.numpy(), u_ref) <= 1e-9
    assert abs(float(r2) - float(r2_ref)) <= 0.1 * float(r2_ref)


def test_routed_shard_apply_matches_reference(clamped):
    """Each shard's routed apply on its halo-extended vector, the exchange
    emulated on the host as tests/test_domain_decomposition.py does."""
    rsim, sim = clamped[:2]
    S = 2
    ref = rdom.DomainDecomposition.from_simulator(rsim, S)
    dd = DomainDecomposition.from_simulator(sim, S)
    rsp, psp = ref.build_routed(), dd.build_routed()
    x = np.random.default_rng(0).standard_normal((sim.num_dofs, 3))
    xs = dd.to_sharded(torch.as_tensor(x, dtype=torch.float32)).numpy()
    K = dd.K
    recv = np.zeros((S, S * K, 3), np.float32)
    for dst in range(S):
        for src in range(S):
            recv[dst, src * K:(src + 1) * K] = xs[src][dd.send_idx[src, dst]]
    for s in range(S):
        x_loc = np.concatenate([xs[s], recv[s][dd.halo_take[s]]])
        sl = jax.tree_util.tree_map(lambda v, s=s: v[s], rsp.gather)
        rl = jax.tree_util.tree_map(lambda v, s=s: v[s], rsp.rung1)
        y_ref = np.asarray(rsp.local(sl, rl, rsp.last_ids[s], rsp.KeB[s],
                                     jnp.asarray(x_loc)))
        y = psp.local(s, torch.as_tensor(x_loc))
        assert y.dtype == torch.float32 and y.shape == y_ref.shape
        assert np.abs(y.numpy() - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


@pytest.mark.parametrize("S", [2, 4])
def test_routed_dd_solve_matches_ebe(S, clamped):
    """The routed shards (float32) against the float64 DD solve at the same
    count, within the reference's 2e-4 of max|u|."""
    _, sim, free, b = clamped
    dd = DomainDecomposition.from_simulator(sim, S)
    u_r, _ = dd_cg_solve(dd, b, None, free_mask=free, iters=25,
                         routed_spmv=dd.build_routed())
    u_e, _ = dd_cg_solve(dd, b, None, free_mask=free, iters=25)
    assert u_r.dtype == torch.float64
    assert _rel(u_r.numpy(), u_e.numpy()) < 2e-4


def test_sharded_ebe_and_padding_match_reference(clamped):
    rsim, sim = clamped[:2]
    Ke_r, ed_r = rsh.pad_elements(rsim.Ke, rsim.elem_dofs, 7)
    Ke_p, ed_p = pad_elements(sim.Ke, sim.elem_dofs, 7)
    assert np.array_equal(np.asarray(Ke_r), Ke_p.numpy())
    assert np.array_equal(np.asarray(ed_r), ed_p.numpy())
    u = np.random.default_rng(0).standard_normal((sim.num_dofs, 3))
    y_ref = np.asarray(rsh.ShardedEBE.build(
        _mesh(8), "e", rsim.Ke, rsim.elem_dofs, rsim.num_dofs, 3)(
            jnp.asarray(u)))
    y = ShardedEBE.build(LocalShards(8, "cpu"), sim.Ke, sim.elem_dofs,
                         sim.num_dofs, 3)(torch.as_tensor(u))
    assert _rel(y.numpy(), y_ref) <= 1e-12


def test_sharded_solves_match_reference(clamped):
    rsim, sim, free, _ = clamped
    rng = np.random.default_rng(2)
    b = rng.standard_normal((sim.num_dofs, 3))
    x_ref = np.asarray(rsh.sharded_elasticity_solve(_mesh(4), rsim,
                                                    jnp.asarray(b), iters=10))
    x = sharded_elasticity_solve(sim, torch.as_tensor(b),
                                 LocalShards(4, "cpu"), iters=10)
    assert _rel(x.numpy(), x_ref) <= 1e-9
    free = free.astype(np.float64)
    B = rng.standard_normal((sim.num_dofs, 3, 3)) * free[..., None]
    U_ref, r2_ref = rsh.sharded_elasticity_solve_multichip(
        _mesh(2, 2), rsim, jnp.asarray(B), free_mask=jnp.asarray(free),
        iters=20)
    U, r2 = sharded_elasticity_solve_multichip(
        sim, torch.as_tensor(B), LocalShards(2, "cpu", col_groups=2),
        free_mask=torch.as_tensor(free), iters=20)
    assert U.shape == B.shape and r2.shape == (3,)
    assert _rel(U.numpy(), U_ref) <= 1e-9
    assert _rel(r2.numpy(), r2_ref) <= 1e-9


def test_dryrun_multidevice_cpu():
    """Both gates of the dry run (true residual < 1e-6, single-device
    agreement < 5e-3) at grid_tet(4) over 2 shards x 2 column groups."""
    out = dryrun_multidevice(4, n=4, device="cpu")
    rel, err = out["relres"], out["err"]
    assert rel.shape == (4,) and (rel < 1e-6).all() and err < 5e-3
    assert out["u"].shape == (9 ** 3, 3, 4)   # grid_tet(4) P2 nodes


def test_parallel_imports_no_jax():
    code = ("import sys; import meshfem_tpu_torch.parallel; "
            "import meshfem_tpu_torch.parallel.launch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'meshfem_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
