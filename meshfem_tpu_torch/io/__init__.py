from . import meshio, msh_fields  # noqa: F401
from .meshio import guess_format, load, save  # noqa: F401
