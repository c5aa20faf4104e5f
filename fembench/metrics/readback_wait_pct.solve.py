"""Share of a static solve's inner solves (``solve/refine/inner``) in
which the host waited on the CG loop's per-iteration flag read
(``cg.readback_wait_ns``), percent: high, the device paces the loop;
low beside a high idle share, the host's Python and launches do."""

from fembench.spans import readback_wait_pct

PROBES = ("program_spans",)


def read(record):
    return readback_wait_pct(record, "solve")
