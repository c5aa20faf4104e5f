"""What a configuration's job hands back to the harness."""

from __future__ import annotations

from typing import NamedTuple


class Job(NamedTuple):
    outputs: dict      # tensors judged against the reference, on the device
    iters: int         # the solver's inner iterations
    fields: dict       # further numbers of the result (floats, ints)
    evidence: dict     # what the path guard reads (launch counts, ...)
