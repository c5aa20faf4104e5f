"""Share of the block apply's least time (``roofline.py``, at its m
columns) in its CUDA-event time around ``RoutedEBE.apply_block``, in
percent."""

from fembench.readers import apply_roofline_pct

PROBES = ("apply_events",)


def read(record):
    return apply_roofline_pct(record, block=True)
