from .materials import Material, MaterialField  # noqa: F401
from .elasticity import ElasticitySimulator, von_mises  # noqa: F401
