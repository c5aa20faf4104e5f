"""Hierarchical section timers, span records and counters: the port's
tracer (counterpart of ``meshfem_tpu/utils/timer.py``; reference
``Timer.hh`` / ``GlobalBenchmark.hh:8-46`` and ``python/benchmark.py``).

Off unless enabled, like the reference's ``-DBENCHMARK`` builds; an
instrumented site then costs one attribute test.  Section names nest by
``/``.  A section measures host time only: it never synchronises the
card (a synchronise would make the very idle gaps a trace is read for),
and the device's time is a device trace's to measure.

Besides the summed ``sections`` and ``counts``, each section appends one
span record ``(path, parent, root, start_ns, end_ns)``: its path
(``solve/refine/inner``), the index of the record of the section it
opened in (None at the top), the index of its top-level record (a
top-level section is one request, and every span under it carries its
index), and ``time.perf_counter_ns()`` at its start and its end (None
while it is open).  ``add`` keeps named integer counters.  Records stay
in memory until ``take`` hands them over.  ``torch_profile_trace`` takes
the place of the reference's ``jax_profile_trace``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


class _Section:
    """The context manager of an enabled ``Timer.section``."""

    __slots__ = ("timer", "name")

    def __init__(self, timer, name):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.timer.start_section(self.name)

    def __exit__(self, *exc):
        self.timer.stop_section(self.name)


_OFF = contextlib.nullcontext()


class Timer:
    def __init__(self):
        self.sections: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.spans: list[list] = []
        self.counters: dict[str, int] = {}
        # open sections: (path, start ns, index of its span record)
        self._stack: list[tuple[str, int, int | None]] = []
        self.enabled = False

    def start_section(self, name: str) -> None:
        if not self.enabled:
            return
        path = f"{self._stack[-1][0]}/{name}" if self._stack else name
        parent = self._stack[-1][2] if self._stack else None
        index = len(self.spans)
        root = index if parent is None else self.spans[parent][2]
        t0 = time.perf_counter_ns()
        self.spans.append([path, parent, root, t0, None])
        self._stack.append((path, t0, index))

    def stop_section(self, name: str | None = None) -> None:
        """Close the innermost open section (``name`` is not checked, as
        in the reference)."""
        if not self.enabled or not self._stack:
            return
        t1 = time.perf_counter_ns()
        path, t0, index = self._stack.pop()
        self.sections[path] = self.sections.get(path, 0.0) \
            + (t1 - t0) * 1e-9
        self.counts[path] = self.counts.get(path, 0) + 1
        if index is not None:
            self.spans[index][4] = t1

    def section(self, name: str):
        """``with timer.section(name):`` times the block; a shared no-op
        context while the timer is off."""
        return _Section(self, name) if self.enabled else _OFF

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (while enabled)."""
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def take(self) -> tuple[list, dict]:
        """(span records, counters) since the last ``take`` or ``reset``,
        which are cleared.  Parent and root indices point into the
        returned list.  A section still open comes with its end None and
        records nothing when it closes (its time still goes to
        ``sections``)."""
        spans, counters = self.spans, self.counters
        self.spans, self.counters = [], {}
        self._stack = [(path, t0, None) for path, t0, _ in self._stack]
        return spans, counters

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
        self.spans.clear()
        self.counters.clear()
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
