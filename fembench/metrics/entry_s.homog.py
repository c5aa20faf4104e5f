"""Host seconds a homogenization spends in its ``homogenize`` span outside
``homogenize/refine``: periodic matching, the simulator (f64 ``Ke``, EBE
plan), the routed build, the block-Jacobi set-up, the loads and the
tensor; averaged over the window's jobs (the program's tracer)."""

from fembench.spans import entry_s

PROBES = ("program_spans",)


def read(record):
    return entry_s(record, "homog")
