"""Device busy time, idle share and the breakdown, from ``torch.profiler``
over one job.

Only device activity is recorded (``ProfilerActivity.CUDA``: kernels,
copies, fills, and the host's CUDA calls that launch them): recording
the host's operators too doubled the routed solve's host time an
iteration, and with it the idle share it was to measure.  Busy time is
the union of the intervals in which a CUDA kernel, copy or fill ran on
the device (not their sum: work that overlaps counts once).  The traced
window is the job's own span on the host (the profiler's record of it),
from its start to the synchronise that ends it.  Each idle gap inside the
window is named by the device operation it waits for ("before ...")
and the one it follows ("after ..."): the host was preparing the former
(Python, numpy, a read of a device scalar) while the device stood.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

NAME_CHARS = 120


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def short_name(name):
    """A device operation's name without template arguments, parameters
    and return type, and its last two scopes: ``gemvx::kernel``."""
    head = name.split("(")[0].strip()
    if "::" not in head:
        return head or name
    out, depth = [], 0
    for ch in head:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    scopes = "".join(out).split()[-1:] or [name]
    return "::".join(scopes[0].split("::")[-2:])


def _gap_labels(dev, gaps):
    """"after <op> / before <op>" of each gap (gaps in time order)."""
    dev = sorted(dev)
    starts = [s for s, _, _ in dev]
    ends = sorted((e, n) for _, e, n in dev)
    labels, i, j = [], 0, 0
    for gs, ge in gaps:
        while i < len(dev) and starts[i] < ge:
            i += 1
        while j < len(ends) and ends[j][0] <= gs:
            j += 1
        prev = short_name(ends[j - 1][1]) if j else "window start"
        nxt = short_name(dev[i][2]) if i < len(dev) else "window end"
        labels.append(f"after {prev} / before {nxt}")
    return labels


def profile_call(fn, sync, device=None):
    """Run ``fn()`` under the profiler; returns (fn's result, a dict with
    ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps``).  With no
    device activity recorded (no CUDA), ``busy_s`` is None.

    The window runs from a one-element fill launched just before ``fn`` to
    another launched just after the synchronise that ends it: the device
    is idle at both launches, so each fill starts on the device within
    microseconds of the host's call, and both are timed on the clock of
    the device's other events.  The two fills are not counted busy.
    Without device events the host's clock around the job stands in."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and device is not None \
        and device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        h0 = time.time_ns()
        if cuda:
            torch.zeros(1, device=device)
        out = fn()
        sync()
        if cuda:
            torch.zeros(1, device=device)
            sync()
        h1 = time.time_ns()
    dev = []
    devtype = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if (e.device_type() == devtype
                and not getattr(e, "is_user_annotation", lambda: False)()):
            dev.append((s, s + d, e.name()))
    dev.sort()
    if len(dev) >= 2:
        t0, t1 = dev[0][0], dev[-1][0]             # the two fills
        dev = dev[1:-1]
    else:
        t0, t1, dev = h0, h1, []
    info = dict(window_s=(t1 - t0) * 1e-9, busy_s=None, device_ops=[],
                idle_gaps=[])
    if not dev:
        return out, info
    union = _merge([(max(s, t0), min(e, t1)) for s, e, _ in dev
                    if e > t0 and s < t1])
    info["busy_s"] = sum(e - s for s, e in union) * 1e-9
    per_op = defaultdict(int)
    for s, e, name in dev:
        per_op[name[:NAME_CHARS]] += e - s
    info["device_ops"] = [[k, v * 1e-9] for k, v in sorted(
        per_op.items(), key=lambda kv: -kv[1])[:10]]
    edges = [t0] + [x for iv in union for x in iv] + [t1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    per_gap = defaultdict(int)
    for (s, e), label in zip(gaps, _gap_labels(dev, gaps)):
        per_gap[label[:NAME_CHARS]] += e - s
    info["idle_gaps"] = [[k, v * 1e-9] for k, v in sorted(
        per_gap.items(), key=lambda kv: -kv[1])[:10]]
    return out, info
