"""Arithmetic shared by the per-layer metrics' readers
(``metrics/<metric>.py``).  Each reader's ``read(record)`` returns its
number, or None where the run has nothing for it to read."""

from __future__ import annotations

from .roofline import PEAKS, apply_bound_s


def jobs_of(record, kind):
    """The window's job records, if the cell's jobs are of ``kind``."""
    if record["info"].get("job_kind") != kind or not record["jobs"]:
        return None
    return record["jobs"]


def mean_iters(record, kind):
    jobs = jobs_of(record, kind)
    if not jobs:
        return None
    return sum(j["iters"] for j in jobs) / len(jobs)


def idle_pct(record, kind):
    prof = record.get("profile")
    if (record["info"].get("job_kind") != kind or not prof
            or not prof.get("busy_s") or not prof.get("window_s")):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def apply_roofline_pct(record, block):
    """100 x (least time of the applies) / (their CUDA-event time), over
    the routed applies of one column (``block`` False) or of several."""
    peaks = PEAKS.get(record["info"].get("kind"))
    applies = [a for a in record["events"].get("apply", [])
               if (a[0] > 1) == block]
    if peaks is None or not applies:
        return None
    bound = sum(apply_bound_s(m, E, N, n, d, peaks)
                for m, E, N, n, d, _, _ in applies)
    spent = sum(s.elapsed_time(e) for *_, s, e in applies) * 1e-3
    return 100.0 * bound / spent
