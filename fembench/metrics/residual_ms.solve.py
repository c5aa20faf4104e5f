"""Milliseconds of one float64 residual of a static solve's refinement
(``solve/refine/residual``: the f64 EBE apply and its norm read back),
the mean over the window (the program's tracer)."""

from fembench.spans import residual_ms

PROBES = ("program_spans",)


def read(record):
    return residual_ms(record, "solve")
