from . import expressions, linalg  # noqa: F401
