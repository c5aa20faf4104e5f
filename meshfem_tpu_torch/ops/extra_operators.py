"""Additional discrete operators (counterpart of
``meshfem_tpu/ops/extra_operators.py``).

Parity with reference ``BoundaryLaplacian.hh`` (boundary-restricted
Laplace-Beltrami with periodic-face exclusion), ``UniformLaplacian.hh``
(graph Laplacian, host scipy), ``PerturbMesh.hh`` (host scipy) and
``GridFunction.hh`` (scalar fields on uniform grids with an FD Laplacian,
smoothing and multilinear sampling)."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import config
from ..mesh.femmesh import FEMMesh
from ..mesh.geometry import simplex_geometry
from . import element_matrices as em
from .operators import EBEOperator


def boundary_laplacian(mesh: FEMMesh, exclude_cell_faces: bool = False,
                       device=None):
    """FEM Laplacian on the boundary surface (K-1 simplices embedded in
    R^dim, the Gram branch of ``simplex_geometry``), optionally excluding
    periodic cell faces (``BoundaryLaplacian.hh:1-18``).  Operates on
    node-indexed vectors of length mesh.num_nodes (zero off-boundary
    rows)."""
    belems = mesh.bdry_elem_nodes
    corners = mesh.bdry_elems
    if exclude_cell_faces:
        from ..mesh.periodic import cell_face_boundary_elements

        keep = ~cell_face_boundary_elements(mesh)
        belems = belems[keep]
        corners = corners[keep]
    dev = config.resolve_device(device)
    X = torch.as_tensor(mesh.V, dtype=config.REAL, device=dev)
    grad_lam, vol = simplex_geometry(
        X[torch.as_tensor(corners, device=dev)], mesh.K - 1)
    Ke = em.element_laplacian(grad_lam, vol, mesh.degree)
    return EBEOperator(Ke, belems, mesh.num_nodes)


def uniform_laplacian(V, edges):
    """Graph Laplacian on vertices (``UniformLaplacian.hh``): a scipy CSR
    (host-side smoothing and mesh perturbation)."""
    import scipy.sparse as sp

    n = len(V)
    e = np.asarray(edges)
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    A = sp.coo_matrix((np.ones(len(i)), (i, j)), shape=(n, n)).tocsr()
    d = np.asarray(A.sum(axis=1)).ravel()
    return sp.diags(d) - A


def perturb_mesh(mesh: FEMMesh, boundary_velocity, steps: float = 1.0):
    """Move boundary vertices by a velocity field and extend to the
    interior harmonically via the uniform Laplacian (``PerturbMesh.hh:1-7``);
    host numpy, returns the new vertex positions [nv, dim]."""
    import scipy.sparse.linalg as spla

    L = uniform_laplacian(mesh.V, mesh.cell.edges()).tolil()
    bverts = mesh.cell.boundary_vertices()
    rhs = np.zeros_like(mesh.V)
    rhs[bverts] = steps * np.asarray(boundary_velocity)
    for v in bverts:
        L.rows[v] = [v]
        L.data[v] = [1.0]
    delta = np.column_stack([
        spla.spsolve(L.tocsc(), rhs[:, d]) for d in range(mesh.V.shape[1])])
    return mesh.V + delta


class GridFunction:
    """Scalar field on a uniform N-d grid with FD Laplacian and smoothing
    (``GridFunction.hh``), on ``device`` (the CUDA device by default, or
    the device of a ``values`` tensor)."""

    def __init__(self, values, spacing=1.0, device=None):
        self.values = torch.as_tensor(values,
                                      device=config.device_for(device,
                                                               values))
        self.spacing = spacing

    @staticmethod
    def _shifts(v):
        """Edge-clamped neighbour shifts (no wrap-around) along every axis:
        the reference pads with ``mode="edge"``."""
        for ax in range(v.dim()):
            n = v.shape[ax]
            i = torch.arange(n, device=v.device)
            yield (v.index_select(ax, (i - 1).clamp(min=0)),
                   v.index_select(ax, (i + 1).clamp(max=n - 1)))

    def laplacian(self):
        v = self.values
        out = torch.zeros_like(v)
        for lo, hi in self._shifts(v):
            out = out + (lo + hi - 2 * v)
        return out / self.spacing ** 2

    def smoothed(self, iterations: int = 1, weight: float = 0.5):
        v = self.values
        for _ in range(iterations):
            nb = torch.zeros_like(v)
            for lo, hi in self._shifts(v):
                nb = nb + lo + hi
            v = (1 - weight) * v + weight * nb / (2 * v.dim())
        return GridFunction(v, self.spacing)

    def sample(self, points):
        """Multilinear interpolation at fractional grid coordinates
        ``points [P, ndim]`` (in units of ``spacing``), as the reference's
        ``map_coordinates(order=1)`` with its default ``mode="constant"``,
        ``cval=0``: a corner outside the grid contributes 0, so points in
        the last half cell and beyond blend toward 0."""
        v = self.values
        p = torch.as_tensor(points, dtype=v.dtype,
                            device=v.device).T / self.spacing
        per_axis = []
        for x, n in zip(p, v.shape):
            lower = torch.floor(x)
            w_hi = x - lower
            i = lower.long()
            per_axis.append([(i, 1 - w_hi), (i + 1, w_hi)])
        out = None
        for corner in itertools.product(*per_axis):
            valid = torch.ones_like(p[0], dtype=torch.bool)
            index, weight = [], None
            for (i, w), n in zip(corner, v.shape):
                valid &= (i >= 0) & (i < n)
                index.append(i.clamp(0, n - 1))
                weight = w if weight is None else weight * w
            term = weight * torch.where(valid, v[tuple(index)],
                                        torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
            out = term if out is None else out + term
        return out
