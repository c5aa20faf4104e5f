"""The program's own spans and counters (``meshfem_tpu_torch/utils/
timer.py``): the arithmetic of the per-layer metrics that read them, and
the attribution of a traced job's idle device time to the host span open
at each moment.

A span record is ``(path, parent, root, start_ns, end_ns)`` on the host's
``time.perf_counter_ns`` clock; the probe ``probes/program_spans.py``
takes the window's records into ``record["program"]``.  A job's requests
are its root spans (no parent); the window's jobs carry ``start_s`` and
``wall_s`` on the same clock, which assigns the roots to them.

``idle_by_span`` puts idle intervals on the device clock down to host
spans through anchors: pairs of the host's ``perf_counter_ns`` taken just
before a marker's launch and the marker's start on the device clock.
Host spans map onto the device clock through the least of the anchors'
offsets (a launch can be late, not early).
"""

from __future__ import annotations

from fembench.readers import jobs_of

ROOTS = {"solve": ("bc", "solve", "von_mises"), "homog": ("homogenize",)}
REFINE = {"solve": "solve/refine", "homog": "homogenize/refine"}
NO_SPAN = "no span"
SLACK_NS = 1000                # a root's ends against its job's host clock


def program(record, kind):
    """(spans, counters) the probe took from the window, if the cell's
    jobs are of ``kind`` and the program recorded any; else None."""
    prog = record.get("program")
    if not jobs_of(record, kind) or not prog or not prog["spans"]:
        return None
    return prog["spans"], prog["counters"]


def _ns(span):
    return span[4] - span[3]


def _closed(spans, path):
    return [s for s in spans if s[0] == path and s[4] is not None]


def entry_s(record, kind):
    """Seconds a job spends in its root spans outside their ``refine``
    spans (entry, builds, set-up of the solve, fields), averaged over the
    window's jobs that recorded roots."""
    got = program(record, kind)
    if got is None:
        return None
    spans, _ = got
    per_job = []
    for job in jobs_of(record, kind):
        lo = job["start_s"] * 1e9 - SLACK_NS
        hi = (job["start_s"] + job["wall_s"]) * 1e9 + SLACK_NS
        roots = {i for i, s in enumerate(spans)
                 if s[1] is None and s[0] in ROOTS[kind]
                 and s[4] is not None and lo <= s[3] and s[4] <= hi}
        if not roots:
            continue
        inside = sum(_ns(spans[i]) for i in roots)
        refine = sum(_ns(s) for s in _closed(spans, REFINE[kind])
                     if s[2] in roots)
        per_job.append((inside - refine) * 1e-9)
    return sum(per_job) / len(per_job) if per_job else None


def residual_ms(record, kind):
    """Mean milliseconds of one float64 residual of refinement (the
    operator apply and the norm's read-back)."""
    got = program(record, kind)
    spans = _closed(got[0], REFINE[kind] + "/residual") if got else []
    return 1e-6 * sum(map(_ns, spans)) / len(spans) if spans else None


def _inner(record, kind):
    """(nanoseconds in the inner solves, counters), or None."""
    got = program(record, kind)
    if got is None:
        return None
    spans, counters = got
    ns = sum(map(_ns, _closed(spans, REFINE[kind] + "/inner")))
    return (ns, counters) if ns else None


def inner_iter_ms(record, kind):
    """Milliseconds an inner CG iteration: the inner solves' spans over
    the CG iterations counted (``cg.iters``)."""
    got = _inner(record, kind)
    if got is None or not got[1].get("cg.iters"):
        return None
    return 1e-6 * got[0] / got[1]["cg.iters"]


def readback_wait_pct(record, kind):
    """Share of the inner solves' time the host spent blocked in the CG
    loops' flag reads (``cg.readback_wait_ns``), percent."""
    got = _inner(record, kind)
    if got is None or "cg.readback_wait_ns" not in got[1]:
        return None
    return 100.0 * got[1]["cg.readback_wait_ns"] / got[0]


# ---------------------------------------------------------------------------
# idle device time by host span
# ---------------------------------------------------------------------------

def _segments(spans):
    """The host's time line cut into (start, end, innermost open span's
    path) pieces, from closed, nested span records."""
    closed = sorted(((s[3], s[4], s[0]) for s in spans if s[4] is not None),
                    key=lambda s: (s[0], -s[1]))
    points = sorted({t for s in closed for t in s[:2]})
    out, stack, j = [], [], 0
    for a, b in zip(points, points[1:]):
        while j < len(closed) and closed[j][0] <= a:
            while stack and stack[-1][1] <= closed[j][0]:
                stack.pop()
            stack.append(closed[j])
            j += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            out.append((a, b, stack[-1][2]))
    return out


def to_device(anchors):
    """Host ns -> device ns through ``anchors`` ([host ns, device ns]
    pairs): the least of their offsets.  A fill can start late after its
    host time (launch latency, the host thread held up), never early, so
    the soonest is the nearest to the clocks' true offset; on the card the
    offsets show no drift over seconds, only such delays."""
    offset = min(d - h for h, d in anchors)
    return lambda h: h + offset


def idle_by_span(gaps, spans, anchors):
    """[[path, seconds]], largest first: each idle nanosecond of ``gaps``
    ([start, end] on the device clock) goes to the innermost span open on
    the host at that moment (host spans mapped onto the device clock
    through ``anchors``, ``to_device``), or to ``"no span"`` where none is
    open."""
    clock = to_device(anchors)
    segs = _segments([[s[0], s[1], s[2], clock(s[3]),
                       None if s[4] is None else clock(s[4])]
                      for s in spans])
    per = {}
    k = 0
    for a, b in sorted(gaps):
        covered = 0
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        i = k
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                per[segs[i][2]] = per.get(segs[i][2], 0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            per[NO_SPAN] = per.get(NO_SPAN, 0) + (b - a) - covered
    return [[k, v * 1e-9] for k, v in sorted(per.items(),
                                             key=lambda kv: -kv[1])]


def entry_share(by_span):
    """Idle seconds while the host is inside a root span but outside its
    ``refine`` spans, from ``idle_by_span``'s pairs."""
    return sum(s for path, s in by_span
               if path != NO_SPAN and "refine" not in path.split("/"))
