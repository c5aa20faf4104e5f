from . import element_matrices  # noqa: F401
