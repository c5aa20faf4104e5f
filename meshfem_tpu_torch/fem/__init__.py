from . import simplex, quadrature, shape_functions, flattening  # noqa: F401
from . import elasticity_tensor  # noqa: F401
