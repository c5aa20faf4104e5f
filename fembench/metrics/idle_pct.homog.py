"""Share of the traced homogenization in which no kernel, copy or fill
ran on the device (the union of their intervals, ``device_trace.py``),
percent."""

from fembench.readers import idle_pct


def read(record):
    return idle_pct(record, "homog")
