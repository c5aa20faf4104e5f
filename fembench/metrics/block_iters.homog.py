"""Block CG iterations a homogenization takes
(``HomogenizationResult.cg_iters``: all refinement rounds' inner
iterations), averaged over the window's jobs."""

from fembench.readers import mean_iters


def read(record):
    return mean_iters(record, "homog")
