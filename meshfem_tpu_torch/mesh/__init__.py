from . import generators, geometry, periodic, reorder  # noqa: F401
from .geometry import BBox, simplex_geometry  # noqa: F401
from .simplicial import TetMesh, TriMesh  # noqa: F401
from .femmesh import FEMMesh, ElementGeometry  # noqa: F401
