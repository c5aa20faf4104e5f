#!/usr/bin/env python3
"""Chip smoke test of meshfem_tpu_torch on one CUDA card.

Run from the repository root with ``python3 chip_smoke.py``.  Phases, each
of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``meshfem_tpu_torch/csrc`` (timed); then set
   up the main path's problem: ``grid_tet(36,36,36)`` P2 (279,936 tets,
   1,167,051 dofs), ``Material.isotropic(3, 200, 0.3)``, the x = 0 face
   clamped and the far face loaded in -y (``bench.py:397-404``), its dense
   routed operator and the factored one (built as ``bench.py:363``);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes: A at 3 and 1 planes (exact), B in float32 (1e-5 of max|y|) and
   float64 (1e-12), bit-identical across two runs, C (1e-5 of max|y|);
4. the main path: ``sim.solve(operator="routed", tol=1e-10)``, float32
   routed CG inside float64 iterative refinement.  Launch counts are zeroed
   just before the solve and read just after; the float64 relative residual
   through the port's EBE operator must be <= 1e-10;
5. the factored backend: its apply against the dense apply (<= 5e-6 of
   max|y|), then the same solve with ``MESHFEM_FACTORED=1`` (the
   reference's switch), counted the same way, so kernel C runs on a path;
   a small clamped bar solved on the card (routed) against the port's
   float64 EBE solve on the CPU (u and von Mises to 1e-8);
6. each kernel timed beside its bound, its plain version and one PyTorch
   call computing the same function (median of per-launch CUDA-event
   times, L2 flushed before each launch), printed as one
   ``{"kernels": [...]}`` line;
7. last, ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_N = 36                  # grid_tet(36, 36, 36), bench.py's size
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores


def log(*args):
    print(*args, flush=True)


class Timer:
    """Device time of one call: the median over ``reps`` launches, each
    between two CUDA events, with the 50 MB L2 flushed before each launch
    (the bounds count every byte once from device memory)."""

    def __init__(self, device):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.int8,
                                     device=device)

    def __call__(self, fn, reps=15, warmup=2):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def median_apply_ms(apply, inputs):
    """Median over varied inputs of one apply's device time (warm L2, as
    inside CG)."""
    times = []
    for x in inputs:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        apply(x)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def clamped_problem(size, device):
    """bench.py:397-404: clamp x = 0, load the far face in -y.  ``size`` is
    n for grid_tet(n, n, n) or "bar" for bar_tet(6, 2, 2)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    if size == "bar":
        V, T = generators.bar_tet(6, 2, 2)
    else:
        V, T = generators.grid_tet(size, size, size)
    t0 = time.time()
    mesh = FEMMesh(V, T, degree=2)
    t_mesh = time.time() - t0
    t0 = time.time()
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device=device)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    t_sim = time.time() - t0
    X = mesh.node_positions
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    return sim, t_mesh, t_sim


def check_solution(sim, u, label):
    """u finite, of the right shape, float64 relative residual <= 1e-10
    through the EBE operator, and the energy balance u.Ku == b.u."""
    if tuple(u.shape) != (sim.num_dofs, 3) or not bool(
            torch.isfinite(u).all()):
        raise RuntimeError(f"{label}: bad solution {tuple(u.shape)}")
    free = torch.as_tensor(~sim.dirichlet_mask, dtype=torch.float64,
                           device=sim.device)
    b = sim.neumann_load
    Ku = sim.apply_K(u)
    relres = float(torch.linalg.norm((b - Ku) * free)
                   / torch.linalg.norm(b * free))
    work = float(torch.vdot(b.reshape(-1), u.reshape(-1)))
    energy2 = float(torch.vdot(u.reshape(-1), Ku.reshape(-1)))
    balance = abs(energy2 - work) / abs(work)
    log(f"{label}: f64 relative residual {relres:.3e}, energy balance "
        f"|u.Ku - b.u|/|b.u| = {balance:.3e}, max |u| = "
        f"{float(u.abs().max()):.6e}")
    if not relres <= 1e-10:
        raise RuntimeError(f"{label}: relative residual {relres:.3e} > 1e-10")
    if not balance <= 1e-8:
        raise RuntimeError(f"{label}: energy balance {balance:.3e}")
    return relres


def drive_solve(sim, label, required):
    """One counted run of the user's entry point ``sim.solve``: counts are
    zeroed just before and read just after; each wrapper in ``required``
    must have launched."""
    from meshfem_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.time()
    u, res = sim.solve(operator="routed", tol=1e-10)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {w.__name__: w.launches for w in kernels.WRAPPERS}
    log(f"{label}: solve {wall:.3f} s, {res.rounds} refinement rounds, "
        f"{res.iters} inner CG iterations, relres {res.resnorm:.3e}, "
        f"launches {counts}")
    for name in required:
        if counts[name] == 0:
            raise RuntimeError(f"{label}: {name} was not launched")
    return u, res, wall, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.kernels import _build
    from meshfem_tpu_torch.sparse.contract import qp_tables
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    dev = torch.device("cuda")
    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 2. build, and the main path's problem -----------------------------
    t0 = time.time()
    so = _build.build()
    _build.load()
    log(f"kernels built in {time.time() - t0:.1f} s -> {so.name}")
    ptx_log = so.with_suffix(".log")
    if ptx_log.exists():
        for line in ptx_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    os.environ.pop("MESHFEM_FACTORED", None)
    n = BENCH_N
    sim, t_mesh, t_sim = clamped_problem(n, dev)
    E, N = sim.mesh.num_elements, sim.num_dofs
    log(f"grid_tet({n}) P2: {E} tets, {N} nodes, {3 * N} dofs; host mesh "
        f"+ P2 numbering {t_mesh:.2f} s, geometry + Ke + EBE plan "
        f"{t_sim:.2f} s")
    t0 = time.time()
    rk = sim.routed_kernel()
    torch.cuda.synchronize()
    log(f"dense routed operator (RCB order, first touch, CSR plan, f32 Ke) "
        f"built in {time.time() - t0:.2f} s")
    lam, mu = et.lame_parameters(sim.D)
    t0 = time.time()
    rkf = RoutedEBE.build(None, sim.mesh.elem_nodes, N, 3,
                          coords=sim.mesh.node_positions,
                          factor=(sim.geom.grad_lambda, sim.geom.volume,
                                  lam, mu, 2), device=dev)
    torch.cuda.synchronize()
    log(f"factored routed operator built in {time.time() - t0:.2f} s")

    # -- 3. each kernel against its plain version, main-path shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    ids, S = rk.ids, rk.ids.shape[0]
    src3 = torch.randn((3, N), generator=gen, device=dev)
    for P in (3, 1):
        src = src3[:P].contiguous()
        out = kernels.gather_planes(src, ids)
        ref = kernels.gather_planes_plain(src, ids)
        if not torch.equal(out, ref):
            raise RuntimeError(f"gather_planes (planes {P}) != plain")
        if P == 3:
            err_a = float((out - ref).abs().max())
    log(f"A gather_planes: planes 3 and 1 equal to the plain version "
        f"(ids [{S}] int32, src [3, {N}])")

    perm, offs = rk.plan.perm, rk.plan.offsets
    fsrc = torch.randn((3, S), generator=gen, device=dev)
    b1 = kernels.segment_sum_csr(fsrc, perm, offs)
    b2 = kernels.segment_sum_csr(fsrc, perm, offs)
    bref = kernels.segment_sum_csr_plain(fsrc, perm, offs)
    err_b = float((b1 - bref).abs().max())
    if not torch.equal(b1, b2):
        raise RuntimeError("segment_sum_csr f32 is not bit-identical run "
                           "to run")
    if not err_b <= 1e-5 * float(bref.abs().max()):
        raise RuntimeError(f"segment_sum_csr f32 disagrees: {err_b}")
    plan64 = sim._kernel.plan
    dsrc = torch.randn((3, plan64.num_rows), generator=gen, device=dev,
                       dtype=torch.float64)
    d1 = kernels.segment_sum_csr(dsrc, plan64.perm, plan64.offsets)
    d2 = kernels.segment_sum_csr(dsrc, plan64.perm, plan64.offsets)
    dref = kernels.segment_sum_csr_plain(dsrc, plan64.perm, plan64.offsets)
    err_b64 = float((d1 - dref).abs().max())
    if not torch.equal(d1, d2):
        raise RuntimeError("segment_sum_csr f64 is not bit-identical run "
                           "to run")
    if not err_b64 <= 1e-12 * float(dref.abs().max()):
        raise RuntimeError(f"segment_sum_csr f64 disagrees: {err_b64}")
    log(f"B segment_sum_csr: f32 max abs err {err_b:.3e} (max|y| "
        f"{float(bref.abs().max()):.3e}), f64 {err_b64:.3e}; bit-identical "
        f"across two runs in both")

    ue = torch.randn((3, 10, E), generator=gen, device=dev)
    c_out = kernels.qp_contract(rkf.g, rkf.vol, ue, lam, mu)
    c_ref = kernels.qp_contract_plain(rkf.g, rkf.vol, ue, lam, mu)
    err_c = float((c_out - c_ref).abs().max())
    rel_c = err_c / float(c_ref.abs().max())
    if not rel_c <= 1e-5:
        raise RuntimeError(f"qp_contract disagrees with plain: {rel_c}")
    log(f"C qp_contract: max abs err {err_c:.3e}, {rel_c:.3e} of max|y|")

    # -- 4. the main path: dense routed solve at full width ----------------
    u, res, wall, counts_dense = drive_solve(
        sim, "dense routed solve", ("gather_planes", "segment_sum_csr"))
    check_solution(sim, u, "dense routed solve")
    inputs = [torch.randn((3, N), generator=gen, device=dev)
              for _ in range(9)]
    dense_apply_ms = median_apply_ms(rk.apply_planes, inputs)
    u64 = inputs[0].t().double().contiguous()
    ebe64_ms = median_apply_ms(sim.apply_K,
                               [u64 * (1 + i) for i in range(5)])
    log(f"dense routed apply {dense_apply_ms:.4f} ms (median of "
        f"{len(inputs)} inputs); {wall / max(res.iters, 1) * 1e3:.4f} ms "
        f"per inner CG iteration on the host clock; f64 EBE residual apply "
        f"{ebe64_ms:.4f} ms")
    summary = dict(tets=E, dofs=3 * N, rounds=res.rounds,
                   inner_iters=res.iters, relres=res.resnorm, solve_s=wall,
                   apply_ms=dense_apply_ms, ebe64_apply_ms=ebe64_ms)

    # -- 5. the factored backend (kernel C) --------------------------------
    yd = rk.apply_planes(inputs[0])
    yf = rkf.apply_planes(inputs[0])
    rel_fd = float((yf - yd).abs().max() / yd.abs().max())
    fact_apply_ms = median_apply_ms(rkf.apply_planes, inputs)
    log(f"factored vs dense apply: {rel_fd:.3e} of max|y|; factored apply "
        f"{fact_apply_ms:.4f} ms")
    if not rel_fd <= 5e-6:
        raise RuntimeError(f"factored apply disagrees with dense: {rel_fd}")
    os.environ["MESHFEM_FACTORED"] = "1"
    sim._routed = None
    if sim.routed_kernel().KeP is not None:
        raise RuntimeError("isotropic material did not take the factored "
                           "backend")
    uf, resf, wallf, counts_fact = drive_solve(
        sim, "factored routed solve",
        ("gather_planes", "segment_sum_csr", "qp_contract"))
    os.environ.pop("MESHFEM_FACTORED", None)
    check_solution(sim, uf, "factored routed solve")
    du = float((uf - u).abs().max() / u.abs().max())
    log(f"factored vs dense solution: {du:.3e} of max|u|")
    if not du <= 1e-8:
        raise RuntimeError(f"factored and dense solutions differ: {du}")
    summary.update(factored_rounds=resf.rounds,
                   factored_inner_iters=resf.iters, factored_solve_s=wallf,
                   factored_apply_ms=fact_apply_ms,
                   factored_vs_dense_apply=rel_fd)

    small, _, _ = clamped_problem("bar", dev)
    us, _ = small.solve(operator="routed", tol=1e-10)
    small_cpu, _, _ = clamped_problem("bar", "cpu")
    uc, _ = small_cpu.solve(operator="ebe", tol=1e-10)
    vm_c = small_cpu.von_mises_field(uc)
    rel_small = float((us.cpu() - uc).abs().max() / uc.abs().max())
    vm_rel = float((small.von_mises_field(us).cpu() - vm_c).abs().max()
                   / vm_c.abs().max())
    log(f"small bar: card routed vs CPU f64 EBE solve: u {rel_small:.3e}, "
        f"von Mises {vm_rel:.3e} of max")
    if not (rel_small <= 1e-8 and vm_rel <= 1e-8):
        raise RuntimeError("small-input solve disagrees with the CPU path")
    summary["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # -- 6. kernels timed beside bound, plain version and library call -----
    timer = Timer(dev)
    report = []

    def entry(name, source, replaces, launches, err, fn, plain, library,
              nbytes, flops, **extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        d = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches, max_abs_err=err, ms=timer(fn),
                 plain_ms=timer(plain, reps=5), bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=timer(library))
        d.update(extra)
        report.append(d)
        log(f"{name}: {d['ms']:.4f} ms (bound {d['bound_ms']:.4f} ms by "
            f"{d['bound_by']}), plain {d['plain_ms']:.4f} ms, library "
            f"{d['library_ms']:.4f} ms, max abs err {err:.3e}, launches "
            f"{launches}")

    ids_long = ids.long()
    entry("gather_planes", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139", counts_dense["gather_planes"],
          err_a, lambda: kernels.gather_planes(src3, ids),
          lambda: kernels.gather_planes_plain(src3, ids),
          lambda: torch.index_select(src3, 1, ids_long),
          S * 4 + 3 * N * 4 + 3 * S * 4, 0,
          also_replaces="meshfem_tpu/sparse/route.py:187 (_copy_kernel, "
                        "1 plane)",
          planes1_ms=timer(lambda: kernels.gather_planes(src3[:1], ids)),
          planes1_plain_ms=timer(
              lambda: kernels.gather_planes_plain(src3[:1], ids), reps=5),
          planes1_bound_ms=(S * 4 + N * 4 + S * 4) / HBM_BYTES_PER_S * 1e3,
          planes1_library_ms=timer(
              lambda: torch.index_select(src3[:1], 1, ids_long)),
          launches_factored=counts_fact["gather_planes"],
          library_call="torch.index_select",
          shape=f"src [3, {N}] f32, ids [{S}] int32")

    acc32 = torch.zeros((3, N), device=dev)
    acc64 = torch.zeros((3, N), device=dev, dtype=torch.float64)
    dst64 = sim._kernel.elem_dofs.reshape(-1)
    entry("segment_sum_csr", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162", counts_dense["segment_sum_csr"],
          err_b, lambda: kernels.segment_sum_csr(fsrc, perm, offs),
          lambda: kernels.segment_sum_csr_plain(fsrc, perm, offs),
          lambda: acc32.index_add_(1, ids_long, fsrc),
          3 * S * 4 + S * 4 + (N + 1) * 4 + 3 * N * 4, 3 * S,
          also_replaces="meshfem_tpu/sparse/route.py:207 (_reduce_kernel, "
                        "1 plane); the SumPlan ladder "
                        "(meshfem_tpu/sparse/routed_ebe.py:74-123)",
          launches_factored=counts_fact["segment_sum_csr"],
          library_call="Tensor.index_add_ (float atomics, not "
                       "deterministic)",
          shape=f"src [3, {S}] f32 -> [3, {N}]",
          planes1_ms=timer(lambda: kernels.segment_sum_csr(fsrc[:1], perm,
                                                           offs)),
          planes1_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
              fsrc[:1], perm, offs), reps=5),
          planes1_bound_ms=(S * 4 + S * 4 + (N + 1) * 4 + N * 4)
          / HBM_BYTES_PER_S * 1e3,
          planes1_library_ms=timer(
              lambda: acc32[:1].index_add_(1, ids_long, fsrc[:1])),
          f64_ms=timer(lambda: kernels.segment_sum_csr(
              dsrc, plan64.perm, plan64.offsets)),
          f64_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
              dsrc, plan64.perm, plan64.offsets), reps=5),
          f64_bound_ms=(3 * S * 8 + S * 4 + (N + 1) * 4 + 3 * N * 8)
          / HBM_BYTES_PER_S * 1e3,
          f64_library_ms=timer(lambda: acc64.index_add_(1, dst64, dsrc)),
          f64_max_abs_err=err_b64)

    Q, nn, K1 = qp_tables(3, 2)[0].shape
    flops = E * Q * (2 * nn * 3 * K1 + 2 * 9 * nn + 3 + 1 + 9 * 4 + 3 * 2
                     + 2 * nn * 9)
    ue_dense = ue.reshape(30, E).t().contiguous().unsqueeze(-1)
    entry("qp_contract", "meshfem_tpu_torch/csrc/qp_contract.cu",
          "meshfem_tpu/sparse/contract.py:232", counts_fact["qp_contract"],
          err_c, lambda: kernels.qp_contract(rkf.g, rkf.vol, ue, lam, mu),
          lambda: kernels.qp_contract_plain(rkf.g, rkf.vol, ue, lam, mu),
          lambda: torch.bmm(rk.KeP, ue_dense),
          (12 + 1 + 30 + 30) * E * 4, flops, max_rel_err=rel_c,
          library_call="torch.bmm with the dense f32 Ke",
          shape=f"g [12, {E}], vol [{E}], ue [3, 10, {E}] f32")

    ue_slots = ue.reshape(3, 10 * E)
    summary.update(
        dense_contract_ms=timer(lambda: rk._contract(ue_slots)),
        dense_bmm_ms=timer(lambda: torch.bmm(rk.KeP, ue_dense)),
        dense_bmm_bound_ms=rk.KeP.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        cg_iter_ms=wall / max(res.iters, 1) * 1e3,
        factored_cg_iter_ms=wallf / max(resf.iters, 1) * 1e3)
    log("solve " + json.dumps(summary))
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
