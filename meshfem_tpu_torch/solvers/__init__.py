from . import cg  # noqa: F401
from .cg import (CGResult, mask_projector, nullspace_projector,  # noqa: F401
                 solve_dirichlet)
