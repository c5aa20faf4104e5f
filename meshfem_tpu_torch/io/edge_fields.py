"""Named scalar fields on mesh edges, round-tripped through ASCII text
(counterpart of ``meshfem_tpu/io/edge_fields.py``; parity with the
reference library's ``EdgeFields.hh/.cc``), and the JSON/JavaScript field
export of ``JSFieldWriter.hh``.  Host numpy."""

from __future__ import annotations

from pathlib import Path

import numpy as np


class EdgeFields:
    def __init__(self, edges):
        self.edges = np.asarray(edges, dtype=np.int64)  # [ne, 2] sorted
        self.fields: dict[str, np.ndarray] = {}

    def add_field(self, name: str, values) -> None:
        values = np.asarray(values, dtype=np.float64)
        if len(values) != len(self.edges):
            raise ValueError("field length != number of edges")
        self.fields[name] = values

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(f"{len(self.edges)} {len(self.fields)}\n")
            for a, b in self.edges:
                f.write(f"{a} {b}\n")
            for name, vals in self.fields.items():
                f.write(f"{name}\n")
                for v in vals:
                    f.write(f"{v:.17g}\n")

    @classmethod
    def load(cls, path) -> "EdgeFields":
        tok = iter(Path(path).read_text().split("\n"))
        ne, nf = (int(x) for x in next(tok).split())
        edges = np.asarray([[int(x) for x in next(tok).split()]
                            for _ in range(ne)])
        out = cls(edges)
        for _ in range(nf):
            name = next(tok).strip()
            vals = np.asarray([float(next(tok)) for _ in range(ne)])
            out.fields[name] = vals
        return out


def write_js_fields(path, mesh, fields: dict) -> None:
    """JSON/JavaScript field export for web viewing (parity with
    ``JSFieldWriter.hh``)."""
    import json

    data = {
        "vertices": mesh.V.tolist(),
        "elements": mesh.F.tolist(),
        "fields": {k: np.asarray(v).tolist() for k, v in fields.items()},
    }
    text = json.dumps(data)
    if str(path).endswith(".js"):
        text = "var meshData = " + text + ";"
    Path(path).write_text(text)
