"""FEMMesh: degree-1/2 Lagrange nodes over a triangle or tetrahedral mesh.

Counterpart of ``meshfem_tpu/mesh/femmesh.py`` in the reference node order
(vertices first, then edge nodes in sorted-edge order, ``femmesh.py:83-100``).
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
where the geometry gives tangential gradients and unsigned areas.  The
reference's other node orders (``node_order="morton"|"rcb"|"firsttouch"``)
are not ported: this ``FEMMesh`` keeps the reference order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config, native
from ..fem import shape_functions, simplex
from ..sparse.scatter import GatherPlan, ScatterPlan
from . import geometry as geom
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
    """

    def __init__(self, V, F, degree: int = 1,
                 embedding_dim: int | None = None):
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
        # vertex i -> its node id: the identity in the reference node
        # order, the only one ported
        self.vertex_nodes = np.arange(nv, dtype=np.int64)

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
        ``femmesh.py:209``); the corner tables hold vertex ids, which are
        the first node ids in the reference order.  A triangle surface in
        3D takes the in-plane normals of its boundary edges
        (``geometry.embedded_boundary_normals``)."""
        dev = config.device_for(device, node_positions)
        X = torch.as_tensor(self.node_positions if node_positions is None
                            else node_positions, dtype=config.REAL,
                            device=dev)
        if tuple(X.shape) != (self.num_nodes, self.dim):
            raise ValueError(f"node_positions must be [{self.num_nodes}, "
                             f"{self.dim}], got {tuple(X.shape)}")
        corners = X[torch.as_tensor(self.F, device=dev)]   # vertices first
        grad_lambda, volume = geom.simplex_geometry(corners, self.K)
        bcorners = X[torch.as_tensor(self.bdry_elems, device=dev)]
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
        ends = np.empty((self.num_nodes, 2), dtype=np.int64)
        ends[:nv] = np.arange(nv)[:, None]
        if self.num_nodes > nv:
            ends[nv:, 0] = self._edge_keys // nv
            ends[nv:, 1] = self._edge_keys % nv
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
        table holds vertex ids, the first node ids in the reference
        order)."""
        return self._gather_plan("corners", self.F.reshape(-1),
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
