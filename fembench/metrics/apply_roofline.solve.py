"""Share of the one-column routed apply's least time (``roofline.py``)
in its CUDA-event time around ``RoutedEBE.apply_planes``, in percent."""

from fembench.readers import apply_roofline_pct

PROBES = ("apply_events",)


def read(record):
    return apply_roofline_pct(record, block=False)
