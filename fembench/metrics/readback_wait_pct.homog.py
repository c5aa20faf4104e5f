"""Share of the cell problems' inner solves (``homogenize/refine/inner``)
in which the host waited on the block CG's per-iteration flag read
(``cg.readback_wait_ns``), percent."""

from fembench.spans import readback_wait_pct

PROBES = ("program_spans",)


def read(record):
    return readback_wait_pct(record, "homog")
