"""Hierarchical section timers (counterpart of ``meshfem_tpu/utils/timer.py``;
reference ``Timer.hh`` / ``GlobalBenchmark.hh:8-46`` and
``python/benchmark.py``).

Off unless enabled, like the reference's ``-DBENCHMARK`` builds.  Section
names nest by ``/``.  CUDA work is asynchronous, so an enabled section
calls ``torch.cuda.synchronize()`` at its start and its stop once CUDA is
initialised in the process: a section then times the device work it
launched, where the host clock alone would time the launches.
``torch_profile_trace`` takes the place of the reference's
``jax_profile_trace``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    def __init__(self):
        self.sections: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._stack: list[tuple[str, float]] = []
        self.enabled = False

    def start_section(self, name: str) -> None:
        if not self.enabled:
            return
        _sync()
        self._stack.append((name, time.perf_counter()))

    def stop_section(self, name: str | None = None) -> None:
        """Close the innermost open section (``name`` is not checked, as
        in the reference)."""
        if not self.enabled or not self._stack:
            return
        _sync()
        label, t0 = self._stack.pop()
        full = "/".join([s for s, _ in self._stack] + [label])
        self.sections[full] = self.sections.get(full, 0.0) \
            + time.perf_counter() - t0
        self.counts[full] = self.counts.get(full, 0) + 1

    @contextlib.contextmanager
    def section(self, name: str):
        self.start_section(name)
        try:
            yield
        finally:
            self.stop_section(name)

    def report(self, stream=None) -> str:
        lines = ["=== meshfem_tpu_torch benchmark report ==="]
        for k in sorted(self.sections):
            lines.append(f"{k:<48s} {self.sections[k]*1e3:10.2f} ms  "
                         f"x{self.counts[k]}")
        out = "\n".join(lines)
        if stream is not None:
            print(out, file=stream)
        return out

    def reset(self) -> None:
        self.sections.clear()
        self.counts.clear()
        self._stack.clear()


GLOBAL_TIMER = Timer()


def enable_benchmarking(on: bool = True) -> None:
    GLOBAL_TIMER.enabled = on


def benchmarkit(fn=None, *, name: str | None = None):
    """Decorator timing a function into the global timer
    (``python/benchmark.py:5-27``)."""
    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*a, **kw):
            with GLOBAL_TIMER.section(label):
                return f(*a, **kw)

        return inner

    return wrap(fn) if fn is not None else wrap


@contextlib.contextmanager
def torch_profile_trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card), written as a Chrome trace to ``log_dir/trace.json``.  Yields the
    profiler, whose ``key_averages()`` sum the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
