"""Run a function on ``world`` ranks of a ``torch.distributed`` group.

``run_ranks(fn, world, backend, args, timeout_s)`` spawns ``world``
processes (the ``spawn`` start method: no state is inherited), joins them
into one process group through a ``FileStore`` in a temporary directory (no
network, not even localhost), pins each to one torch thread, calls
``fn(*args)`` on every rank and returns the results in rank order.  Tensors
in a result come back as numpy arrays.

``fn`` must be importable by a fresh interpreter: a module-level function
of a package, never of a test module (the child imports the module ``fn``
lives in).  On a timeout, or when a child raises, every child is
terminated and ``run_ranks`` raises with that child's traceback.

For NCCL, each rank takes the card ``cuda:<rank>``; NCCL cannot put two
ranks on one card.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _child(rank, world, backend, store_path, timeout_s, fn, args, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = _to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:         # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str = "gloo", args=(),
              timeout_s: float = 60.0):
    """``[fn(*args) on rank r for r in range(world)]``; raises
    ``RuntimeError`` with the child's traceback when a rank raises, and
    ``TimeoutError`` when the ranks are not done within ``timeout_s``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"run_ranks: backend {backend!r}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="meshfem_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child,
                         args=(r, world, backend, os.path.join(tmp, "store"),
                               timeout_s, fn, tuple(args), results),
                         daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(out)} of "
                                   f"{world} ranks not done in "
                                   f"{timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} died "
                                       f"(exit code "
                                       f"{procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} raised:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

