from . import (boundary_conditions, elasticity, materials,  # noqa: F401
               poisson)
from .poisson import PoissonProblem  # noqa: F401
from .materials import (Material, MaterialField, load_material,  # noqa: F401
                        parse_material, save_material)
from .boundary_conditions import (BoundaryConditions, load_bc,  # noqa: F401
                                  parse_bc)
from .elasticity import ElasticitySimulator, von_mises  # noqa: F401
