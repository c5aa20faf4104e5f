from . import simplex, quadrature, shape_functions, flattening  # noqa: F401
from . import elasticity_tensor, tensor_projection  # noqa: F401
from . import interpolant, one_form  # noqa: F401
from .elasticity_tensor import ElasticityTensor  # noqa: F401
from .interpolant import Interpolant  # noqa: F401
from .one_form import OneForm  # noqa: F401
