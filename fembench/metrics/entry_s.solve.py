"""Host seconds a static solve job spends in the program's root spans
(``bc``, ``solve``, ``von_mises``) outside their ``solve/refine``
spans: the boundary conditions, the Kuhn-grid check, builds on a cache
miss, the preconditioner's set-up, the fields; averaged over the window's
jobs (the program's tracer, ``fembench/spans.py``)."""

from fembench.spans import entry_s

PROBES = ("program_spans",)


def read(record):
    return entry_s(record, "solve")
