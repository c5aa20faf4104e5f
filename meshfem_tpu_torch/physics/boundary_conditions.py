"""Boundary condition parsing and region matching.

The port's counterpart of ``meshfem_tpu/physics/boundary_conditions.py``,
numpy on the host as there (reference ``BoundaryConditions.hh/.cc``):
JSON ``.bc`` files with

* ``regions``: list of ``{"type": ..., "value": [...], "box"/"box%": {...}}``
  where type is dirichlet / force / traction / pressure / target /
  delta_force (optionally suffixed with a component mask, e.g.
  ``dirichletxy``), values may be expression strings over x/y/z;
* ``box%`` corners are fractions of the mesh bounding box;
* ``no_rigid_motion`` flag.

Semantics (``BoundaryConditions.hh:179-215``, ``LinearElasticity.hh:881-1027``):
pressure p -> traction = -p n; force F -> uniform traction F / region-area;
dirichlet applies to boundary nodes in the region (per component mask).
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np

from ..utils.expressions import evaluate
from ..mesh.geometry import BBox

_TYPE_RE = re.compile(
    r"^(dirichlet|force|traction|pressure|target|delta_force|fracture|contact)"
    r"([xyz]{0,3})( nodes| elements)?$")


@dataclasses.dataclass
class ComponentMask:
    """x/y/z component selection (reference ``ComponentMask.hh``)."""

    mask: str = ""

    def components(self, dim: int) -> np.ndarray:
        if not self.mask:
            return np.arange(dim)
        return np.asarray(["xyz".index(c) for c in self.mask])

    def has(self, c: int) -> bool:
        return not self.mask or "xyz"[c] in self.mask


@dataclasses.dataclass
class BCRegion:
    type: str                      # dirichlet/force/traction/pressure/target/delta_force
    value: list                    # numbers or expression strings
    min_corner: np.ndarray | None
    max_corner: np.ndarray | None
    percent: bool                  # box% (fraction of mesh bbox)
    component_mask: ComponentMask = dataclasses.field(
        default_factory=ComponentMask)
    kind: str = "box"              # box | polygon | nodes | elements
    polygon: np.ndarray | None = None        # [k, 2] for kind == 'polygon'
    indices: np.ndarray | None = None        # node ids (kind == 'nodes')
    indexed_values: np.ndarray | None = None  # per-index values
    element_corners: list | None = None      # vertex-id sets (elements)

    def absolute_box(self, mesh_bbox: BBox) -> BBox:
        if not self.percent:
            return BBox(self.min_corner.copy(), self.max_corner.copy())
        d = mesh_bbox.dimensions
        return BBox(mesh_bbox.min + self.min_corner * d,
                    mesh_bbox.min + self.max_corner * d)

    def eval_value(self, points, env=None) -> np.ndarray:
        """[len(points), len(value)] evaluated values."""
        cols = [evaluate(v, points, env) for v in self.value]
        return np.stack(cols, axis=-1)


@dataclasses.dataclass
class BoundaryConditions:
    regions: list
    no_rigid_motion: bool = False


def parse_bc(data: dict | str, dim: int = 3) -> BoundaryConditions:
    """Parse the reference's ``.bc`` JSON (``readBoundaryConditions``,
    ``BoundaryConditions.cc``)."""
    if isinstance(data, str):
        data = json.loads(data)
    regions = []
    for r in data.get("regions", []):
        m = _TYPE_RE.match(r["type"].strip().lower())
        if not m:
            raise ValueError(f"unknown BC type {r['type']!r}")
        base, mask, suffix = m.group(1), m.group(2), (m.group(3) or "")
        cmask = ComponentMask(mask)
        if suffix == " elements" and base not in ("traction", "pressure",
                                                  "force"):
            # the reference only defines element-indexed NEUMANN conditions
            # (NeumannElementsCondition); element-set Dirichlet goes through
            # the 'element vertices' key instead (BoundaryConditions.cc:297)
            raise ValueError(f"'{base} elements' is not a condition type; "
                             "use 'element vertices' for Dirichlet element "
                             "sets")
        if suffix == " nodes" and base not in ("dirichlet", "target",
                                               "delta_force"):
            raise ValueError(f"'{base} nodes' is not a condition type")
        if suffix == " nodes":
            # indexed node condition: values = [[vec, [node ids...]], ...]
            # (parseNodeConditionValues, BoundaryConditions.cc:64-81)
            idxs, vals = [], []
            for vec, ids in r["values"]:
                for ni in ids:
                    idxs.append(int(ni))
                    vals.append(np.asarray(vec, dtype=np.float64)[:dim])
            regions.append(BCRegion(base, [], None, None, False, cmask,
                                    kind="nodes",
                                    indices=np.asarray(idxs, dtype=np.int64),
                                    indexed_values=np.asarray(vals)))
            continue
        if suffix == " elements":
            # indexed boundary-element condition: values =
            # [[vec, [[v0, v1(, v2)], ...]], ...]
            # (parseElementConditionValues, BoundaryConditions.cc:84-108)
            corners, vals = [], []
            for vec, elems in r["values"]:
                for el in elems:
                    corners.append(frozenset(int(v) for v in el))
                    vals.append(np.asarray(vec, dtype=np.float64)[:dim])
            regions.append(BCRegion(base, [], None, None, False, cmask,
                                    kind="elements",
                                    element_corners=corners,
                                    indexed_values=np.asarray(vals)))
            continue
        if "element vertices" in r:
            # dirichlet/target over boundary elements given by vertex ids
            # (DirichletElementsCondition, BoundaryConditions.hh:358)
            corners = [frozenset(int(v) for v in el)
                       for el in r["element vertices"]]
            value = r.get("value", [])
            if not isinstance(value, (list, tuple)):
                value = [value]
            regions.append(BCRegion(base, list(value), None, None, False,
                                    cmask, kind="elements",
                                    element_corners=corners))
            continue
        if "polygon" in r:
            poly = np.asarray(r["polygon"], dtype=np.float64)[:, :2]
            value = r.get("value", [])
            if not isinstance(value, (list, tuple)):
                value = [value]
            regions.append(BCRegion(base, list(value), None, None, False,
                                    cmask, kind="polygon", polygon=poly))
            continue
        if "box" in r:
            box, percent = r["box"], False
        elif "box%" in r:
            box, percent = r["box%"], True
        else:
            raise ValueError("BC region needs a box, box%, polygon, "
                             "element vertices, or indexed values")
        lo = np.asarray(box["minCorner"], dtype=np.float64)[:dim]
        hi = np.asarray(box["maxCorner"], dtype=np.float64)[:dim]
        value = r.get("value", [])
        if not isinstance(value, (list, tuple)):
            value = [value]
        regions.append(BCRegion(base, list(value), lo, hi, percent,
                                ComponentMask(mask)))
    return BoundaryConditions(regions, bool(data.get("no_rigid_motion",
                                                     False)))


def load_bc(path, dim: int = 3) -> BoundaryConditions:
    return parse_bc(json.loads(Path(path).read_text()), dim)


# ---------------------------------------------------------------------------
# Region matching against a FEMMesh.
# ---------------------------------------------------------------------------

def _points_in_polygon(points, poly):
    """Even-odd point-in-polygon test on the xy projection."""
    x, y = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), dtype=bool)
    k = len(poly)
    for i in range(k):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % k]
        crosses = ((y0 > y) != (y1 > y))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
        inside ^= crosses & (x < xint)
    return inside


def match_boundary_nodes(mesh, region: BCRegion, tol_frac: float = 1e-7):
    """Boundary node indices selected by the region (box, polygon — the
    reference's PolygonalRegion — or explicit node indices)."""
    if region.kind == "nodes":
        nodes = np.asarray(region.indices)
        bset = set(int(b) for b in np.asarray(mesh.bdry_nodes))
        for ni in nodes:
            if int(ni) not in bset:
                raise ValueError(
                    f"Node condition applied to non-boundary node: {ni}")
        return nodes
    p = mesh.node_positions[mesh.bdry_nodes]
    if region.kind == "polygon":
        inside = _points_in_polygon(np.asarray(p)[:, :2], region.polygon)
        return mesh.bdry_nodes[inside]
    box = region.absolute_box(mesh.bbox())
    tol = tol_frac * max(float(np.max(mesh.bbox().dimensions)), 1.0)
    inside = np.all((p >= box.min - tol) & (p <= box.max + tol), axis=1)
    return mesh.bdry_nodes[inside]


def match_boundary_elements(mesh, region: BCRegion, tol_frac: float = 1e-7):
    """Boundary element indices selected by the region (box, polygon, or
    explicit vertex-index sets; the reference requires all vertices inside,
    ``LinearElasticity.hh:897-930``)."""
    if region.kind == "elements":
        lookup = {frozenset(int(v) for v in row): i
                  for i, row in enumerate(np.asarray(mesh.bdry_elems))}
        out = []
        for key in region.element_corners:
            if key not in lookup:
                raise ValueError(
                    "Some element boundary conditions weren't matched "
                    f"(vertex set {sorted(key)})")
            out.append(lookup[key])
        return np.asarray(out, dtype=np.int64)
    if region.kind == "polygon":
        ok = np.ones(mesh.num_boundary_elements, dtype=bool)
        for c in range(mesh.bdry_elems.shape[1]):
            p = np.asarray(mesh.V[mesh.bdry_elems[:, c]])[:, :2]
            ok &= _points_in_polygon(p, region.polygon)
        return np.flatnonzero(ok)
    box = region.absolute_box(mesh.bbox())
    tol = tol_frac * max(float(np.max(mesh.bbox().dimensions)), 1.0)
    ok = np.ones(mesh.num_boundary_elements, dtype=bool)
    for c in range(mesh.bdry_elems.shape[1]):
        p = mesh.V[mesh.bdry_elems[:, c]]
        ok &= np.all((p >= box.min - tol) & (p <= box.max + tol), axis=1)
    return np.flatnonzero(ok)


def expression_env(mesh) -> dict:
    """Environment variables available to BC expressions
    (``LinearElasticity.hh:883-894``)."""
    bb = mesh.bbox()
    env = {}
    for i, c in enumerate("xyz"[:mesh.dim]):
        env[f"mesh_size_{c}"] = float(bb.dimensions[i])
        env[f"mesh_min_{c}"] = float(bb.min[i])
        env[f"mesh_max_{c}"] = float(bb.max[i])
    return env
