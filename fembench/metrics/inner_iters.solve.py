"""Inner CG iterations a static solve takes (``CGResult.iters``: all
refinement rounds' inner iterations), averaged over the window's jobs."""

from fembench.readers import mean_iters


def read(record):
    return mean_iters(record, "solve")
