"""End-to-end check of the multi-device solve.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``
(:55-162): the same problem and the same two checks, on a comm of the
port's (``parallel/comm.py``) instead of a virtual JAX device mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import LocalShards
from .domain import DomainDecomposition, dd_cg_solve


def dryrun_multidevice(n_shards: int, comm=None, n: int = 13, device=None):
    """Solve ``grid_tet(n)`` P2 (x = 0 face clamped) for 2 b canonical
    strain loads with ``dd_cg_solve(precond="block", tol=1e-8, chunk=150,
    iters=1500)`` over ``n_shards`` = e x b devices (b = 2 columns groups
    when ``n_shards`` is even, as the reference factors its mesh), then
    check (1) every column's true float64 relative residual through the
    port's EBE operator is < 1e-6 and (2) the first column agrees with a
    single-device block-Jacobi CG solve to < 5e-3 of its max.  ``comm``
    (default: ``LocalShards(e, device, col_groups=b)``) must have that
    layout.  Raises on a failed check; returns a dict: ``relres`` (the
    true relative residuals [2 b]), ``err`` (the invariance error), ``u``
    and ``res2`` (the DD solve's)."""
    from ..mesh import FEMMesh, generators
    from ..physics import ElasticitySimulator, Material
    from ..solvers import cg as cg_mod
    from ..solvers import precond as pc

    b_axis = 2 if n_shards % 2 == 0 else 1
    e_axis = n_shards // b_axis
    if comm is None:
        comm = LocalShards(e_axis, device, col_groups=b_axis)
    elif (comm.n_shards, comm.col_groups) != (e_axis, b_axis):
        raise ValueError(f"comm is {comm.n_shards} x {comm.col_groups}, "
                         f"the dry run {e_axis} x {b_axis}")
    dev = comm.device

    V, T = generators.grid_tet(n, n, n)
    fem = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(fem, Material.isotropic(3, 200.0, 0.3),
                              device=dev)
    # one canonical strain load a column (homogenization cell problems)
    n_rhs = 2 * b_axis
    cols = []
    for i in range(n_rhs):
        e = torch.zeros(6, dtype=torch.float64)
        e[i % 6] = 1e-3
        cols.append(sim.constant_strain_load(e))
    B = torch.stack(cols, dim=-1)                     # [Nn, d, n_rhs]
    free = np.ones((sim.num_dofs, sim.dim))
    free[np.asarray(fem.node_positions)[:, 0] < 1e-9, :] = 0.0
    free = torch.as_tensor(free, device=dev)
    B = B * free[..., None]

    dd = DomainDecomposition.from_simulator(sim, e_axis)
    u, res2 = dd_cg_solve(dd, B, comm, free_mask=free, iters=1500,
                          tol=1e-8, chunk=150, precond="block")
    if not bool(torch.isfinite(res2).all()):
        raise RuntimeError(f"non-finite residuals: {res2}")

    r_true = (B - sim.apply_K(u)) * free[..., None]
    rel = (torch.linalg.norm(r_true.reshape(-1, n_rhs), dim=0)
           / torch.linalg.norm(B.reshape(-1, n_rhs), dim=0)).cpu().numpy()
    if not (rel < 1e-6).all():
        raise RuntimeError(f"DD solve did not reduce residuals: {rel}")

    blocks = pc.node_block_diagonal(sim.Ke, sim.elem_dofs, sim.num_dofs,
                                    sim.dim)
    M_inv = pc.block_jacobi_apply(pc.block_jacobi_inv(blocks, free))
    ref = cg_mod.cg(sim.apply_K, B[..., 0], M_inv=M_inv,
                    project=lambda v: v * free, tol=1e-8, maxiter=4000)
    scale = float(ref.x.abs().max())
    err = float((u[..., 0] - ref.x).abs().max()) / scale
    if not err < 5e-3:
        raise RuntimeError(f"DD solution disagrees with single-device "
                           f"solve: rel err {err}")
    print(f"dryrun_multidevice OK: {e_axis} shards x {b_axis} column "
          f"groups on {dev}, u {tuple(u.shape)}, halo scalars/SpMV "
          f"{dd.comms_volume_per_spmv()}, true relative residuals "
          f"{rel[:3]}, single-device invariance err {err:.2e}", flush=True)
    return {"relres": rel, "err": err, "u": u, "res2": res2}


def multidevice_cases(comm, comm_cols=None, n: int = 3, iters: int = 15,
                      precond: str = "block"):
    """The multi-device paths at a fixed iteration count on a clamped
    ``grid_tet(n)`` P2 with seeded loads, on ``comm``'s device: the DD solve
    (``dd_cg_solve``, one column) with float64 EBE shards and with the
    routed shards of this process's shards, the element-sharded apply
    (``ShardedEBE``) of a seeded vector, and, given ``comm_cols`` (a comm
    with column groups), ``sharded_elasticity_solve_multichip`` on four
    columns.  The same call on :class:`LocalShards` and on ranks of the same
    layout gives the same bits.  Returns a dict of tensors."""
    from ..mesh import FEMMesh, generators
    from ..physics import ElasticitySimulator, Material
    from .sharded import ShardedEBE, sharded_elasticity_solve_multichip

    dev = comm.device
    V, T = generators.grid_tet(n, n, n)
    fem = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(fem, Material.isotropic(3, 200.0, 0.3),
                              device=dev)
    Nn = sim.num_dofs
    free = np.ones((Nn, 3))
    free[np.asarray(fem.node_positions)[:, 0] < 1e-9] = 0.0
    rng = np.random.default_rng(0)
    b = rng.standard_normal((Nn, 3)) * free
    x = rng.standard_normal((Nn, 3))
    B = rng.standard_normal((Nn, 3, 4)) * free[..., None]
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    dd = DomainDecomposition.from_simulator(sim, comm.n_shards)
    u, res2 = dd_cg_solve(dd, as_dev(b), comm, free_mask=as_dev(free),
                          iters=iters, precond=precond)
    u_routed, _ = dd_cg_solve(dd, as_dev(b), comm, free_mask=as_dev(free),
                              iters=iters, precond=precond,
                              routed_spmv=dd.build_routed(comm.shards))
    out = {"u": u, "res2": res2, "u_routed": u_routed,
           "y": ShardedEBE.build(comm, sim.Ke, sim.elem_dofs, Nn, 3)(
               as_dev(x))}
    if comm_cols is not None:
        out["U"], out["U_res2"] = sharded_elasticity_solve_multichip(
            sim, as_dev(B), comm_cols, free_mask=as_dev(free), iters=iters)
    return out


def rank_cases(col_groups: int = 2, n: int = 3, iters: int = 15,
               precond: str = "block"):
    """:func:`multidevice_cases` on this rank's process group (one shard a
    rank; when the world splits into more than one shard of
    ``col_groups`` column groups, also the element-sharded multichip solve
    on that grid).  Run it with ``launch.run_ranks(rank_cases, world)``."""
    import torch.distributed as dist

    from .comm import RankShards

    world = dist.get_world_size()
    comm = RankShards()
    comm_cols = RankShards(col_groups=col_groups) \
        if world % col_groups == 0 and world > col_groups else None
    return multidevice_cases(comm, comm_cols, n, iters, precond)
