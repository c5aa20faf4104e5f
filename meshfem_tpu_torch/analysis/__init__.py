from . import homogenization  # noqa: F401
