"""FEMMesh: degree-1/2 Lagrange nodes over a triangle or tetrahedral mesh.

Counterpart of ``meshfem_tpu/mesh/femmesh.py``.  Nodes are numbered as in
the reference: vertices first, then edge nodes in sorted-edge order
(``femmesh.py:83-100``), and then, for ``node_order="morton"|"rcb"|
"firsttouch"``, all nodes renumbered along Morton codes, RCB leaves or
first touch in element order (``femmesh.py:123-167``).  ``node_perm`` maps
a reference-order node id to its id in the active order and
``vertex_nodes`` a vertex to its node; the element and boundary corner
tables (``F``, ``bdry_elems``) keep vertex ids, so every read of a node
array at corners goes through ``vertex_nodes``.
Connectivity is numpy on the host; element geometry is a torch computation
on the requested device.  The P2 edge numbering comes from the port's host
core (``native.unique_edges``) where it can be had, as in the reference
(``femmesh.py:87-93``), else from ``np.unique`` of the sorted edge keys
(``femmesh.py:94``); both sort the (min, max) vertex pairs, so they number
edges alike.  The region queries (``nodes_in_box``,
``boundary_elems_in_box``) and barycenters are numpy on the host; volumes
and the lumped nodal measure are torch on the requested device, the latter
summed by ``ScatterPlan`` (kernel B on the card).  ``vertex_nodes`` and
``node_endpoint_vertices`` give the two-level preconditioner its P1
transfers, and ``node_positions_from_vertices`` the differentiable
re-embedding from vertex positions that the linkage shape derivative
takes; its endpoint gather, like the element-corner gather of
``corner_gather``, is a ``GatherPlan`` (kernel A forward, kernel B
backward on the card, so a gradient sums in a fixed order).  Triangle
meshes take their boundary edges from ``TriMesh`` in its order (outward
wound), and may be embedded in 3D (``embedding_dim``),
where the geometry gives tangential gradients and unsigned areas.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config, native
from ..fem import shape_functions, simplex
from ..sparse.scatter import GatherPlan, ScatterPlan
from . import geometry as geom
from .reorder import _morton_codes, rcb_order
from .simplicial import TetMesh, TriMesh


@dataclasses.dataclass(frozen=True)
class ElementGeometry:
    """Per-element embedding data (torch tensors on one device)."""

    grad_lambda: torch.Tensor   # [E, K+1, dim] barycentric gradients
    volume: torch.Tensor        # [E] signed volumes
    bdry_normal: torch.Tensor   # [B, dim] outward unit normals
    bdry_volume: torch.Tensor   # [B] boundary element measures


class FEMMesh:
    """P1/P2 FEM mesh over a K-simplicial complex (K = 2 or 3) embedded in
    R^dim.

    Host-side numpy connectivity, as in the reference:
      * ``elem_nodes [E, n]`` element -> global node (vertices, then edge
        nodes in GMSH local order);
      * ``node_positions [N, dim]``;
      * ``bdry_elems [B, K]`` outward-wound boundary edges (K = 2) or
        triangles (K = 3), ``bdry_elem_nodes [B, nb]``, ``bdry_nodes
        [NB]`` and ``bdry_elem_vol_elem [B]`` (the element behind each
        boundary element).

    ``embedding_dim`` pads the positions with zero coordinates (a flat
    triangle mesh in 3D) or drops trailing ones, as the reference does.
    ``node_order`` is ``"reference"``, ``"morton"``, ``"rcb"`` or
    ``"firsttouch"`` (the last numbers nodes by their first element, so
    it wants spatially sorted elements, e.g. ``reorder_mesh(order="rcb")``).

    Every array here is fixed at construction, so facts derived from them
    may be stored on the mesh: ``ops.structured.validate_kuhn_grid``
    keeps its Kuhn-grid verdict in ``_kuhn_verdict`` beside the ``V`` and
    ``F`` it read, and checks a mesh once however many solves ask.
    """

    def __init__(self, V, F, degree: int = 1,
                 embedding_dim: int | None = None,
                 node_order: str = "reference"):
        F = np.ascontiguousarray(F, dtype=np.int64)
        V = np.atleast_2d(np.ascontiguousarray(V, dtype=np.float64))
        K = F.shape[1] - 1
        if K not in (2, 3):
            raise ValueError("FEMMesh supports triangles (K=2) and tets "
                             "(K=3)")
        if degree not in (1, 2):
            raise ValueError("degree must be 1 or 2 (like the reference)")
        if embedding_dim is not None:
            if V.shape[1] < embedding_dim:
                V = np.pad(V, [(0, 0), (0, embedding_dim - V.shape[1])])
            else:
                V = np.ascontiguousarray(V[:, :embedding_dim])
        self.K = K
        self.degree = degree
        self.dim = V.shape[1]
        self.V = V
        self.F = F
        self.cell = TriMesh.build(V, F) if K == 2 else TetMesh.build(V, F)

        nv = len(V)
        if degree == 1:
            self.num_edges = 0
            self._edge_keys = np.empty(0, dtype=np.int64)
            elem_nodes = F.copy()
            node_pos = V.copy()
        else:
            pairs = np.asarray(simplex.simplex_edges(K))
            ev = np.stack([F[:, pairs[:, 0]], F[:, pairs[:, 1]]], axis=-1)
            ev = ev.reshape(-1, 2)
            nat = native.unique_edges(ev)
            if nat is not None:
                inverse, uniq_pairs = nat
                uniq = uniq_pairs[:, 0] * nv + uniq_pairs[:, 1]
            else:
                key = np.min(ev, axis=1) * nv + np.max(ev, axis=1)
                uniq, inverse = np.unique(key, return_inverse=True)
            self.num_edges = len(uniq)
            self._edge_keys = uniq
            edge_node = nv + inverse.reshape(len(F), -1)
            elem_nodes = np.concatenate([F, edge_node], axis=1)
            mids = 0.5 * (V[uniq // nv] + V[uniq % nv])
            node_pos = np.concatenate([V, mids], axis=0)
        self.elem_nodes = elem_nodes.astype(np.int64)
        self.node_positions = node_pos
        self.num_nodes = len(node_pos)
        self.nodes_per_elem = simplex.num_nodes(K, degree)

        if K == 2:
            bdry = self.cell.boundary_edges()
            self.bdry_elem_vol_elem = self.cell.bdry_halfedge // 3
        else:
            bdry = self.cell.boundary_faces()
            self.bdry_elem_vol_elem = self.cell.bdry_halfface // 4
        self.bdry_elems = bdry.astype(np.int64)
        self.bdry_elem_nodes = self._boundary_nodes_of(bdry)
        self.bdry_nodes = np.unique(self.bdry_elem_nodes)
        self.is_bdry_node = np.zeros(self.num_nodes, dtype=bool)
        self.is_bdry_node[self.bdry_nodes] = True
        self._plans = {}
        self._kuhn_verdict = None
        self._renumber(node_order)

    def _renumber(self, node_order: str) -> None:
        """Set ``node_perm`` (reference id -> id in ``node_order``) and
        ``vertex_nodes``, and renumber the node arrays (reference
        ``femmesh.py:123-167``)."""
        nv, n = len(self.V), self.num_nodes
        if node_order == "reference":
            old_of_new = np.arange(n)
        elif node_order == "morton":
            old_of_new = np.argsort(_morton_codes(self.node_positions),
                                    kind="stable")
        elif node_order == "rcb":
            old_of_new = rcb_order(self.node_positions)
        elif node_order == "firsttouch":
            uniq, first = np.unique(self.elem_nodes.reshape(-1),
                                    return_index=True)
            old_of_new = uniq[np.argsort(first, kind="stable")]
            if len(old_of_new) < n:                      # unused nodes last
                old_of_new = np.concatenate(
                    [old_of_new, np.setdiff1d(np.arange(n), old_of_new)])
        else:
            raise ValueError(f"unknown node_order {node_order!r}")
        self.node_order = node_order
        new_of_old = np.empty(n, dtype=np.int64)
        new_of_old[old_of_new] = np.arange(n)
        self.elem_nodes = new_of_old[self.elem_nodes]
        self.node_positions = self.node_positions[old_of_new]
        self.bdry_elem_nodes = new_of_old[self.bdry_elem_nodes]
        self.bdry_nodes = np.sort(new_of_old[self.bdry_nodes])
        self.is_bdry_node = self.is_bdry_node[old_of_new]
        self.vertex_nodes = new_of_old[:nv]
        self.node_perm = new_of_old

    def _boundary_nodes_of(self, belems: np.ndarray) -> np.ndarray:
        """Boundary (K-1)-simplex -> volume node indices (vertices, then
        edge nodes for P2), GMSH local order on the boundary element."""
        if self.degree == 1:
            return belems.copy()
        nv = len(self.V)
        pairs = np.asarray(simplex.simplex_edges(self.K - 1))
        ev = np.stack([belems[:, pairs[:, 0]], belems[:, pairs[:, 1]]],
                      axis=-1)
        key = np.min(ev, axis=-1) * nv + np.max(ev, axis=-1)
        pos = np.searchsorted(self._edge_keys, key)
        if not np.all(self._edge_keys[np.clip(pos, 0, self.num_edges - 1)]
                      == key):
            raise RuntimeError("boundary edge missing from volume edge table")
        return np.concatenate([belems, nv + pos], axis=1)

    @property
    def num_vertices(self) -> int:
        return len(self.V)

    @property
    def num_elements(self) -> int:
        return len(self.F)

    @property
    def num_boundary_elements(self) -> int:
        return len(self.bdry_elems)

    def bbox(self) -> geom.BBox:
        return geom.BBox.of(self.V)

    def barycenters(self) -> np.ndarray:
        return self.V[self.F].mean(axis=1)

    def boundary_barycenters(self) -> np.ndarray:
        return self.V[self.bdry_elems].mean(axis=1)

    def geometry(self, device=None, *,
                 node_positions=None) -> ElementGeometry:
        """Float64 embedding of all elements on ``device`` (the CUDA device
        by default, or the device of a ``node_positions`` tensor).
        ``node_positions [N, dim]``, node-indexed, re-embeds the mesh at
        perturbed positions (reference ``geometry(node_positions)``,
        ``femmesh.py:209``); the corner tables hold vertex ids, read
        through ``vertex_nodes``.  A triangle surface in
        3D takes the in-plane normals of its boundary edges
        (``geometry.embedded_boundary_normals``)."""
        dev = config.device_for(device, node_positions)
        X = torch.as_tensor(self.node_positions if node_positions is None
                            else node_positions, dtype=config.REAL,
                            device=dev)
        if tuple(X.shape) != (self.num_nodes, self.dim):
            raise ValueError(f"node_positions must be [{self.num_nodes}, "
                             f"{self.dim}], got {tuple(X.shape)}")
        vn = self.vertex_nodes
        corners = X[torch.as_tensor(vn[self.F], device=dev)]
        grad_lambda, volume = geom.simplex_geometry(corners, self.K)
        bcorners = X[torch.as_tensor(vn[self.bdry_elems], device=dev)]
        if self.dim == self.K:
            normal, bvol = geom.boundary_normals(bcorners)
        else:
            adj = torch.as_tensor(self.bdry_elem_vol_elem, device=dev)
            normal, bvol = geom.embedded_boundary_normals(
                bcorners, corners[adj].mean(dim=-2))
        return ElementGeometry(grad_lambda, volume, normal, bvol)

    def node_endpoint_vertices(self) -> np.ndarray:
        """[N, 2] vertex ids (va, vb) whose midpoint is node i (va == vb
        for vertex nodes)."""
        nv = len(self.V)
        ends_old = np.empty((self.num_nodes, 2), dtype=np.int64)
        ends_old[:nv] = np.arange(nv)[:, None]
        if self.num_nodes > nv:
            ends_old[nv:, 0] = self._edge_keys // nv
            ends_old[nv:, 1] = self._edge_keys % nv
        ends = np.empty_like(ends_old)
        ends[self.node_perm] = ends_old
        return ends

    def _gather_plan(self, name, ids, num_sources, device) -> GatherPlan:
        """A ``GatherPlan`` built once per device and kept on the mesh."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (name, str(device))
        if key not in self._plans:
            self._plans[key] = GatherPlan.build(ids, num_sources, device)
        return self._plans[key]

    def corner_gather(self, device) -> GatherPlan:
        """Node rows -> element-corner rows ``[E * (K+1)]`` (the corner
        table's vertex ids mapped to nodes through ``vertex_nodes``)."""
        return self._gather_plan("corners",
                                 self.vertex_nodes[self.F].reshape(-1),
                                 self.num_nodes, device)

    def endpoint_gather(self, device) -> GatherPlan:
        """Vertex rows -> the two endpoint rows of each node ``[2 N]``
        (``node_endpoint_vertices``)."""
        return self._gather_plan("endpoints",
                                 self.node_endpoint_vertices().reshape(-1),
                                 self.num_vertices, device)

    def node_positions_from_vertices(self, Xv, device=None) -> torch.Tensor:
        """Node positions [N, dim] from vertex positions ``Xv`` [Nv, dim],
        differentiable in ``Xv``: vertex nodes at Xv, P2 edge nodes at edge
        midpoints (reference ``femmesh.py:247``).  Both endpoints come
        through one ``GatherPlan``; ``Xv`` a tensor keeps its device."""
        dev = config.device_for(device, Xv)
        Xv = torch.as_tensor(Xv, dtype=config.REAL, device=dev)
        ends = self.endpoint_gather(dev)(Xv).reshape(self.num_nodes, 2,
                                                     Xv.shape[-1])
        return 0.5 * (ends[:, 0] + ends[:, 1])

    def volume(self, device=None) -> float:
        return float(self.geometry(device).volume.sum())

    def boundary_volume(self, device=None) -> float:
        return float(self.geometry(device).bdry_volume.sum())

    def node_mass_lumped(self, device=None) -> torch.Tensor:
        """[N] float64 lumped nodal measure: the sum over elements of
        vol * int(phi_i), summed in a fixed order by ``ScatterPlan``."""
        g = self.geometry(device)
        w = torch.as_tensor(
            shape_functions.integrated_shape_np(self.K, self.degree),
            dtype=g.volume.dtype, device=g.volume.device)
        contrib = g.volume[:, None] * w[None, :]
        plan = ScatterPlan.build(self.elem_nodes.reshape(-1), self.num_nodes,
                                 g.volume.device)
        return plan(contrib.reshape(-1))

    # region selectors (boundary-condition application)
    def nodes_in_box(self, lo, hi, tol_frac: float = 1e-10) -> np.ndarray:
        tol = tol_frac * float(np.max(self.bbox().dimensions))
        p = self.node_positions
        m = np.all((p >= np.asarray(lo) - tol) & (p <= np.asarray(hi) + tol),
                   axis=1)
        return np.flatnonzero(m)

    def boundary_elems_in_box(self, lo, hi,
                              tol_frac: float = 1e-10) -> np.ndarray:
        """Boundary elements whose corners all lie in the box."""
        tol = tol_frac * float(np.max(self.bbox().dimensions))
        ok = np.ones(len(self.bdry_elems), dtype=bool)
        for corner in range(self.bdry_elems.shape[1]):
            p = self.V[self.bdry_elems[:, corner]]
            ok &= np.all((p >= np.asarray(lo) - tol)
                         & (p <= np.asarray(hi) + tol), axis=1)
        return np.flatnonzero(ok)
