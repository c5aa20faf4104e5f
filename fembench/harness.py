"""One run of one cell: set-up, the measured window, the traced job, the
judge, and the result line.

The window is a closed loop with one job in flight: a job starts while
less than ``seconds`` have passed since the window opened, and the window
closes when the last job that started has finished (a synchronise ends
every job).  The job-time metric is the window's wall time over the jobs
it completed.  A sample of the jobs, drawn from the seed with the job of
the most inner iterations always in it, has its outputs copied to pinned
host memory as the job ends (asynchronously, queued behind the job); the
judge compares them with the reference once the window has closed, the
memory peak has been read and the program's state is freed.

``--trace 1`` runs the same window with the probes that the cell's
per-layer metrics name (``PROBES`` in each reader), then one more job
under ``torch.profiler``, which gives ``busy_s``, ``window_s`` and the
breakdown.  That job is judged like the others and is not in the
window's metrics.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import spec as spec_mod
from . import traffic as traffic_mod
from .probes import install as install_probes
from .device_trace import profile_call

SAMPLE = 4                     # jobs judged at random, besides the longest
FORBIDDEN = ("jax", "jaxlib", "flax", "meshfem_tpu")


class Keeper:
    """A reservoir of ``SAMPLE`` jobs' outputs, drawn from the seed, and
    the job with the most inner iterations, copied into host buffers made
    once after the warm-up job (pinned on a CUDA device)."""

    def __init__(self, example: dict, seed: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 7])
        pin = next(iter(example.values())).is_cuda
        self.slots = [{k: torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=pin)
                       for k, v in example.items()}
                      for _ in range(SAMPLE + 1)]
        self.meta = [None] * (SAMPLE + 1)     # the longest is the last slot
        self.seen = 0

    def _store(self, i, outputs, meta):
        for k, v in outputs.items():
            self.slots[i][k].copy_(v, non_blocking=True)
        self.meta[i] = meta

    def offer(self, outputs: dict, meta: dict):
        self.seen += 1
        longest = self.meta[-1]
        if longest is None or meta["iters"] > longest["iters"]:
            self._store(SAMPLE, outputs, meta)
        if self.seen <= SAMPLE:
            self._store(self.seen - 1, outputs, meta)
        else:
            j = int(self.rng.integers(self.seen))
            if j < SAMPLE:
                self._store(j, outputs, meta)

    def kept(self):
        """[(meta, outputs)] of the distinct jobs kept."""
        out, seen = [], set()
        for meta, slot in zip(self.meta, self.slots):
            if meta is not None and meta["index"] not in seen:
                seen.add(meta["index"])
                out.append((meta, slot))
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        return out.splitlines()[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, traffic: dict | None = None):
    """One run; returns the result line's object.  ``traffic`` replaces
    the cell's traffic file (tests run tiny meshes)."""
    traffic = traffic or cell.traffic()
    problem = cell.module().Problem(cell.config, traffic, device)
    setup = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    problem.setup(setup)
    _sync(device)
    setup["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = traffic_mod.JobStream(traffic["jobs"], seed, stream=1)
    job = problem.job(warm.next())
    _sync(device)
    setup["warm_job_s"] = time.perf_counter() - t
    why = problem.guard(job)
    if why:
        raise RuntimeError(f"{cell.name}: the warm-up job left the cell's "
                           f"path: {why}")
    keeper = Keeper(job.outputs, seed)
    del job
    _sync(device)
    setup_s = time.perf_counter() - t_start

    stream = traffic_mod.JobStream(traffic["jobs"], seed)
    record = dict(setup=setup, jobs=[], spans={}, events={},
                  info=dict(job_kind=problem.JOB_KIND, kind=(
                      torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")))
    uninstall = (install_probes(cell.per_layer, record, cell.root)
                 if trace else None)
    attempted = failed = 0
    reasons = []
    t0 = time.perf_counter()
    try:
        while attempted == 0 or time.perf_counter() - t0 < seconds:
            params = stream.next()
            attempted += 1
            record["info"]["job"] = attempted
            j0 = time.perf_counter()
            job = problem.job(params)
            _sync(device)
            wall = time.perf_counter() - j0
            why = problem.guard(job)
            if why:
                failed += 1
                reasons.append(why)
            meta = dict(index=attempted, params=params, iters=job.iters,
                        **job.fields)
            record["jobs"].append(dict(meta, wall_s=wall, start_s=j0))
            keeper.offer(job.outputs, meta)
            del job
        window_s = time.perf_counter() - t0
    finally:
        if uninstall is not None:
            uninstall()
    done = len(record["jobs"])
    profile = None
    if trace:
        params = stream.next()
        attempted += 1
        job, profile = profile_call(lambda: problem.job(params),
                                    lambda: _sync(device), device)
        why = problem.guard(job)
        if why:
            failed += 1
            reasons.append(why)
        keeper.offer(job.outputs, dict(index=attempted, params=params,
                                       iters=job.iters, **job.fields))
        del job
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    job_metric = problem.JOB_METRIC
    inputs = problem.release()
    del problem
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.module().judge(cell.config, traffic, inputs,
                                 keeper.kept(), device)

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
                  job_metric: window_s / done}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise SystemExit(f"{cell.name}: no measurement for "
                                 f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        record["profile"] = profile
        record["window_s"] = window_s
        for m in cell.per_layer:
            v = spec_mod.reader(m["name"], cell.root).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    within = all(isinstance(c["value"], float) and c["value"] <= c["limit"]
                 for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(within and failed == 0 and checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        if device.type == "cuda":
            dev["power"] = _power_limit()
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["jobs_done"] = done
    result["job_s"] = [j["wall_s"] for j in record["jobs"]]
    result["job_iters"] = [j["iters"] for j in record["jobs"]]
    result["setup_parts"] = setup
    if reasons:
        result["path_faults"] = reasons[:5]
    result["checks"] = checks
    return result


def forbidden_modules(modules=None):
    """Top-level names in ``modules`` (default ``sys.modules``) that the
    run may not hold, compared whole: ``meshfem_tpu_torch`` is not
    ``meshfem_tpu``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def environment():
    """Kernel caches at fixed paths inside the checkout (the program's
    own nvcc and g++ libraries already go to its ``build/``), and JAX
    kept out of libraries that would load it on their own."""
    build = spec_mod.ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
