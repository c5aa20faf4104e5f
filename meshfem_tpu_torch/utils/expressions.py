"""Safe arithmetic expression evaluation for boundary-condition values.

The port's own copy of ``meshfem_tpu/utils/expressions.py`` (the same AST
whitelist, function table and ``eval`` with no builtins): expressions over
x/y/z plus environment variables (``mesh_size_x`` and so on), evaluated on
the host on numpy arrays of points.  Device code only sees the numeric
arrays.
"""

from __future__ import annotations

import ast
import math

import numpy as np

_FUNCS = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log10,
    "log10": np.log10, "log2": np.log2, "abs": np.abs, "fabs": np.abs,
    "floor": np.floor, "ceil": np.ceil, "pow": np.power,
    "min": np.minimum, "max": np.maximum, "sign": np.sign,
}
_CONSTS = {"pi": math.pi, "e": math.e}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call, ast.Name, ast.Constant,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
    ast.Compare, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Load, ast.IfExp,
)


class Expression:
    """A compiled expression over point coordinates + environment variables."""

    def __init__(self, text: str):
        self.text = str(text)
        tree = ast.parse(self.text, mode="eval")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"disallowed syntax {type(node).__name__!r} "
                    f"in expression {text!r}")
            if isinstance(node, ast.Call):
                if (not isinstance(node.func, ast.Name)
                        or node.func.id not in _FUNCS):
                    raise ValueError(f"unknown function in {text!r}")
        self._code = compile(tree, "<bc-expression>", "eval")

    def __call__(self, points, env: dict | None = None):
        """points: [..., dim] array; returns [...] values."""
        p = np.asarray(points, dtype=np.float64)
        names: dict = dict(_FUNCS)
        names.update(_CONSTS)
        names["x"] = p[..., 0]
        names["y"] = p[..., 1] if p.shape[-1] > 1 else 0.0
        names["z"] = p[..., 2] if p.shape[-1] > 2 else 0.0
        if env:
            names.update(env)
        out = eval(self._code, {"__builtins__": {}}, names)
        return np.broadcast_to(np.asarray(out, dtype=np.float64),
                               p.shape[:-1]).copy()


def evaluate(expr, points, env: dict | None = None):
    """Evaluate a number-or-expression-string at points."""
    if isinstance(expr, (int, float)):
        p = np.asarray(points)
        return np.full(p.shape[:-1], float(expr))
    return Expression(expr)(points, env)
