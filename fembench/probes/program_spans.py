"""The program's own tracer (``meshfem_tpu_torch/utils/timer.py``) on
through the window: its span records and counters go to
``record["program"]`` when the probe is removed.  A program without the
tracer's records (no ``Timer.take``) is left alone and records nothing."""

from __future__ import annotations


def install(record):
    from meshfem_tpu_torch.utils.timer import GLOBAL_TIMER as timer

    if not hasattr(timer, "take"):
        return lambda: None
    was = timer.enabled
    timer.take()
    timer.enabled = True

    def uninstall():
        timer.enabled = was
        spans, counters = timer.take()
        record["program"] = dict(spans=spans, counters=counters)

    return uninstall
