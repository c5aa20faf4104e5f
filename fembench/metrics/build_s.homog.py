"""Host seconds of a homogenization outside its block CG spans: the
periodic simulator, the f64 Ke, kernel E, the routed build, the f64
residuals of refinement and the tensor; averaged over the window's
jobs."""

from fembench.readers import jobs_of

PROBES = ("cg_block_span",)


def read(record):
    jobs = jobs_of(record, "homog")
    spans = record["spans"].get("cg_block", [])
    if not jobs or not spans:
        return None
    inside = {}
    for job, seconds, _ in spans:
        inside[job] = inside.get(job, 0.0) + seconds
    return sum(j["wall_s"] - inside.get(j["index"], 0.0)
               for j in jobs) / len(jobs)
