from . import homogenization  # noqa: F401
from . import curvature, mechanisms, parametrization  # noqa: F401
