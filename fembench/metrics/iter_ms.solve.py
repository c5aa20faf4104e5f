"""Milliseconds an inner iteration: the jobs' synchronised wall times
summed over their inner iterations summed (host clock; the f64 residuals,
builds and fields of a job are in it)."""

from fembench.readers import jobs_of


def read(record):
    jobs = jobs_of(record, "solve")
    if not jobs or not sum(j["iters"] for j in jobs):
        return None
    return 1e3 * sum(j["wall_s"] for j in jobs) / sum(j["iters"]
                                                      for j in jobs)
