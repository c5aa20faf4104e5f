"""Milliseconds a block CG iteration of the cell problems: the window's
``homogenize/refine/inner`` spans over the iterations the block CG
counted (``cg.iters``); no f64 residual, build or added synchronise in
it."""

from fembench.spans import inner_iter_ms

PROBES = ("program_spans",)


def read(record):
    return inner_iter_ms(record, "homog")
