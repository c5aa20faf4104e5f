"""Periodic boundary matching: node identification across cell faces.

The port's own copy of ``meshfem_tpu/mesh/periodic.py`` (numpy, host side).
Parity with reference ``PeriodicBoundaryMatcher.hh`` (``FaceMembership``,
``match``, ``determineCellFaceBoundaryElements``) and ``PeriodicCondition``
(``BoundaryConditions.hh:452-608``): nodes on opposite faces of the period
cell are identified into single DOFs (edge/corner nodes identified across
several faces at once).  The output is a flat ``dof_map [N] -> Nd`` used by
the simulator's gather/scatter — no constraint rows are ever built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geometry import BBox


@dataclasses.dataclass
class FaceMembership:
    """Per-node cell-face membership bitsets (on_min[d], on_max[d])."""

    on_min: np.ndarray  # [N, dim] bool
    on_max: np.ndarray  # [N, dim] bool

    def on_any_face(self) -> np.ndarray:
        return self.on_min.any(axis=1) | self.on_max.any(axis=1)

    def count(self) -> np.ndarray:
        return self.on_min.sum(axis=1) + self.on_max.sum(axis=1)


def face_membership(points, cell: BBox, eps: float = 1e-7) -> FaceMembership:
    """Which cell faces each point lies on (eps relative to cell size,
    reference ``FaceMembership`` ctor, ``PeriodicBoundaryMatcher.hh:39-75``)."""
    p = np.asarray(points)
    tol = eps * np.max(cell.dimensions)
    return FaceMembership(np.abs(p - cell.min) <= tol,
                          np.abs(p - cell.max) <= tol)


def match_periodic_nodes(points, cell: BBox | None = None, eps: float = 1e-7,
                         permit_mismatch: bool = False):
    """Identify nodes across periodic cell faces.

    Returns (dof_map [N] -> Nd consecutive dof ids, num_dofs, FaceMembership).
    Nodes whose positions coincide after snapping every on-face coordinate to
    the min face share a DOF (corners of the cell collapse to one DOF, etc.).
    Raises on unmatched face nodes unless ``permit_mismatch``
    (``matchPermittingMismatch``)."""
    p = np.asarray(points, dtype=np.float64)
    N = len(p)
    if cell is None:
        cell = BBox.of(p)
    fm = face_membership(p, cell, eps)

    # Canonical position: snap max-face coordinates onto the min face.
    canon = p.copy()
    for d in range(p.shape[1]):
        canon[fm.on_max[:, d], d] = cell.min[d]
    # Quantize for exact grouping (eps/2 grid relative to cell size).
    scale = max(float(np.max(cell.dimensions)), 1.0)
    q = np.round(canon / (0.5 * eps * scale)).astype(np.int64)

    on_face = fm.on_any_face()
    # Only face nodes participate in identification.
    keys = q[on_face]
    uniq, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                      return_counts=True)
    # Mismatch check: every face-node group must contain >= 2 nodes unless it
    # sits on a face pair with no partner (permit_mismatch skips the check).
    if not permit_mismatch:
        # A node on k faces belongs to a group of 2^k identified nodes.
        expect = 2 ** fm.count()[on_face]
        group_count = counts[inverse]
        bad = group_count != expect
        if bad.any():
            idx = np.flatnonzero(on_face)[bad][:5]
            raise ValueError(
                f"periodic mismatch: {bad.sum()} face nodes lack partners "
                f"(first offenders at {p[idx]})")

    dof_map = np.full(N, -1, dtype=np.int64)
    face_ids = np.flatnonzero(on_face)
    # Group leaders: first node in each group.
    order = np.argsort(inverse, kind="stable")
    sorted_inverse = inverse[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = sorted_inverse[1:] != sorted_inverse[:-1]
    leader_of_group = np.empty(len(uniq), dtype=np.int64)
    leader_of_group[sorted_inverse[first]] = face_ids[order[first]]
    dof_map[face_ids] = leader_of_group[inverse]
    interior = dof_map < 0
    dof_map[interior] = np.flatnonzero(interior)
    # Compress to consecutive dof ids.
    uniq_nodes, dof_map = np.unique(dof_map, return_inverse=True)
    return dof_map.astype(np.int64), len(uniq_nodes), fm


def cell_face_boundary_elements(mesh, cell: BBox | None = None,
                                eps: float = 1e-7) -> np.ndarray:
    """Mask of boundary elements lying entirely on a cell face ("internal"
    periodic boundary, ``determineCellFaceBoundaryElements``)."""
    if cell is None:
        cell = mesh.bbox()
    fm = face_membership(mesh.node_positions, cell, eps)
    is_internal = np.zeros(mesh.num_boundary_elements, dtype=bool)
    benodes = mesh.bdry_elem_nodes
    for d in range(mesh.dim):
        all_min = fm.on_min[benodes, d].all(axis=1)
        all_max = fm.on_max[benodes, d].all(axis=1)
        is_internal |= all_min | all_max
    return is_internal
