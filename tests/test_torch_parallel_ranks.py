"""The port's multi-device layer across processes: ``torch.distributed``
ranks (gloo, one shard a rank, spawned by ``parallel.launch.run_ranks``)
against every shard in one process (``LocalShards``), bit for bit.

Each world size spawns once and each child runs every case
(``parallel.dryrun.rank_cases``: the DD solve at a fixed iteration count
with float64 EBE shards and with routed shards, the element-sharded apply
and, at world 4, the element-sharded multichip solve on 2 domain x 2
column groups).  The port sums the partials of every
shard in shard order on every rank, so the ranks and the in-process shards
agree to the bit.  This file imports no JAX: its ``cuda`` cases run on the
card with ``python -m pytest --noconftest -m cuda
tests/test_torch_parallel_ranks.py``.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from meshfem_tpu_torch.parallel import (DomainDecomposition, LocalShards,
                                        RankShards, dd_cg_solve, run_ranks)
from meshfem_tpu_torch.parallel.dryrun import multidevice_cases, rank_cases


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_equal_local_shards(world):
    ranks = run_ranks(rank_cases, world, "gloo", timeout_s=90)
    local = multidevice_cases(
        LocalShards(world, "cpu"),
        LocalShards(world // 2, "cpu", col_groups=2) if world > 2 else None)
    assert sorted(ranks[0]) == sorted(local)
    assert ("U" in local) == (world == 4)
    for r, res in enumerate(ranks):
        for key, want in local.items():
            got = res[key]
            assert got.shape == tuple(want.shape), (r, key)
            assert np.array_equal(got, want.numpy()), (r, key)


def test_run_ranks_raises_child_error():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="unknown precond 'nope'"):
        run_ranks(rank_cases, 2, "gloo", args=(2, 3, 15, "nope"),
                  timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_rank_shards_in_process(tmp_path):
    """A one-rank gloo group in this process: the DD solve equals one
    in-process shard bit for bit (the card runs the same check on NCCL),
    and the group refuses a tensor that is not on the CPU."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    V, T = generators.grid_tet(3, 3, 3)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3),
                              device="cpu")
    b = np.random.default_rng(3).standard_normal((sim.num_dofs, 3))
    dd = DomainDecomposition.from_simulator(sim, 1)
    u_loc, r2_loc = dd_cg_solve(dd, b, LocalShards(1, "cpu"), iters=12,
                                precond="block")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        comm = RankShards()
        assert comm.device == torch.device("cpu") and comm.shards == [0]
        u, r2 = dd_cg_solve(dd, b, comm, iters=12, precond="block")
        with pytest.raises(ValueError, match="carries cpu tensors"):
            comm.sum_partials(torch.zeros((1, 3), device="meta"))
    finally:
        dist.destroy_process_group()
    assert torch.equal(u, u_loc) and torch.equal(r2, r2_loc)
    with pytest.raises(ValueError, match="shards on"):
        LocalShards(1, "cpu").sum_partials(torch.zeros((1, 3),
                                                       device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_shard_plans_kernels_match_plain(cuda):
    """Kernels A and B on the shard plans of a 4-shard decomposition: A in
    rows on each routed shard operator's slots (exact), B in float32 rows
    on its plan (1e-5 of max|y|) and B in float64 rows on the interior and
    boundary EBE plans (1e-12 of max|y|), each launched."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    V, T = generators.grid_tet(6, 6, 6)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3),
                              device=cuda)
    dd = DomainDecomposition.from_simulator(sim, 4)
    rsp = dd.build_routed()
    gen = torch.Generator(device=cuda).manual_seed(0)
    kernels.reset_launch_counts()
    for s in range(4):
        op = rsp.ops[s]
        x = torch.randn((dd.Nl + dd.H, 3), generator=gen, device=cuda)
        g = kernels.gather_rows(x, op.ids_em)
        assert torch.equal(g, kernels.gather_rows_plain(x, op.ids_em))
        fe = torch.randn(g.shape, generator=gen, device=cuda)
        y = kernels.segment_sum_rows(fe, op.plan_em.perm, op.plan_em.offsets)
        ref = kernels.segment_sum_rows_plain(fe, op.plan_em.perm,
                                             op.plan_em.offsets)
        assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
        for ebe in (dd.shard_ops(s).interior, dd.shard_ops(s).boundary):
            plan = ebe.plan
            src = torch.randn((plan.num_rows, 3), generator=gen, device=cuda,
                              dtype=torch.float64)
            y = plan.sum_rows(src)
            ref = kernels.segment_sum_rows_plain(src, plan.perm,
                                                 plan.offsets)
            assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    torch.cuda.synchronize()
    assert kernels.gather_rows.launches == 4
    assert kernels.segment_sum_rows.launches == 12
    assert kernels.segment_sum_rows.launches_f64 == 8
