"""Milliseconds a V-cycle of the structured multigrid: CUDA events around
``StructuredMG.precondition``, averaged over every V-cycle of the
window."""

PROBES = ("vcycle_events",)


def read(record):
    ev = record["events"].get("vcycle", [])
    if not ev:
        return None
    return sum(s.elapsed_time(e) for s, e in ev) / len(ev)
