"""Milliseconds an inner CG iteration of a static solve: the window's
``solve/refine/inner`` spans over the iterations the CG loops counted
(``cg.iters``); no f64 residual, build or added synchronise in it."""

from fembench.spans import inner_iter_ms

PROBES = ("program_spans",)


def read(record):
    return inner_iter_ms(record, "solve")
