"""Milliseconds a block CG iteration: synchronised host-clock spans
around each ``cg_block`` call, summed, over their iterations summed."""

from fembench.readers import jobs_of

PROBES = ("cg_block_span",)


def read(record):
    spans = record["spans"].get("cg_block", [])
    if not jobs_of(record, "homog") or not sum(s[2] for s in spans):
        return None
    return 1e3 * sum(s[1] for s in spans) / sum(s[2] for s in spans)
