"""Gmsh field sections: write/read $NodeData / $ElementData (the port's own
copy of ``meshfem_tpu/io/msh_fields.py``, host numpy).

Parity with reference ``MSHFieldWriter.hh`` (node/element scalar/vector/
tensor fields, 2D padded to 3D) and ``MSHFieldParser.hh:101-118``
(``scalarField/vectorField/symmetricMatrixField`` by name).

A field dict: {"name": str, "data": array, "where": "node"|"element",
"kind": "scalar"|"vector"|"smatrix"} — vectors are [*, dim] (padded to 3),
symmetric matrices are flattened Voigt [*, fl] written as full 9-component
tensors like the reference writer.
"""

from __future__ import annotations

import numpy as np

from ..fem.flattening import flat_rows_cols, flat_to_sym
from .meshio import numbered_rows, parse_table

_DIM_OF_FLAT = {1: 1, 3: 2, 6: 3}


def _components(field) -> np.ndarray:
    data = np.asarray(field["data"], dtype=np.float64)
    kind = field.get("kind") or _guess_kind(data)
    if kind == "scalar":
        return data.reshape(-1, 1)
    if kind == "vector":
        if data.shape[1] < 3:
            data = np.pad(data, [(0, 0), (0, 3 - data.shape[1])])
        return data
    if kind == "smatrix":
        full = flat_to_sym(data, _DIM_OF_FLAT[data.shape[-1]])
        d = full.shape[-1]
        out = np.zeros((len(full), 3, 3))
        out[:, :d, :d] = full
        return out.reshape(-1, 9)
    raise ValueError(f"unknown field kind {kind}")


def _guess_kind(data) -> str:
    if data.ndim == 1 or data.shape[1] == 1:
        return "scalar"
    if data.shape[1] in (2, 3):
        return "vector"
    return "smatrix"


def append_fields(path, fields) -> None:
    with open(path, "a") as f:
        for field in fields:
            comp = _components(field)
            ncomp = comp.shape[1]
            section = ("$NodeData" if field.get("where", "node") == "node"
                       else "$ElementData")
            f.write(f"{section}\n1\n\"{field['name']}\"\n1\n0.0\n3\n0\n"
                    f"{ncomp}\n{len(comp)}\n")
            f.write(numbered_rows("%.17g", comp))
            f.write(f"$End{section[1:]}\n")


def read_fields(path) -> dict:
    """Returns {name: {"where": ..., "data": [n, ncomp] array}}.  The file
    is read as bytes, so the field sections of a binary MSH (ASCII, after
    its binary node and element blocks) read too; the reference opens it
    as text and fails on the binary blocks."""
    out = {}
    with open(path, "rb") as f:
        lines = iter(f.read().splitlines())
    for line in lines:
        s = line.strip()
        if s in (b"$NodeData", b"$ElementData"):
            where = "node" if s == b"$NodeData" else "element"
            nstr = int(next(lines))
            name = next(lines).decode().strip().strip('"')
            for _ in range(nstr - 1):
                next(lines)
            nreal = int(next(lines))
            for _ in range(nreal):
                next(lines)
            nint = int(next(lines))
            ints = [int(next(lines)) for _ in range(nint)]
            ncomp, count = ints[1], ints[2]
            block = [next(lines).decode() for _ in range(count)]
            out[name] = {"where": where,
                         "data": parse_table(block, 1 + ncomp)[:, 1:].copy()}
    return out


def scalar_field(fields: dict, name: str) -> np.ndarray:
    return fields[name]["data"][:, 0]


def vector_field(fields: dict, name: str, dim: int = 3) -> np.ndarray:
    return fields[name]["data"][:, :dim]


def smatrix_field(fields: dict, name: str, dim: int) -> np.ndarray:
    """Return flattened Voigt [n, fl] from a 9-component tensor field."""
    full = fields[name]["data"].reshape(-1, 3, 3)[:, :dim, :dim]
    r, c = flat_rows_cols(dim)
    return full[:, r, c]
