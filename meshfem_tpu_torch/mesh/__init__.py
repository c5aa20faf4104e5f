from . import generators, geometry, reorder  # noqa: F401
from .geometry import simplex_geometry  # noqa: F401
from .simplicial import TetMesh  # noqa: F401
from .femmesh import FEMMesh, ElementGeometry  # noqa: F401
