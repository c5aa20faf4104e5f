"""Scalar Poisson solver (counterpart of ``meshfem_tpu/physics/poisson.py``;
parity with reference ``Poisson.hh:55-135``).

-div(grad u) = f on the mesh, Dirichlet values on selected nodes, optional
Neumann flux on boundary elements.  Solves with projection-PCG (Jacobi
preconditioner) in float64 on the problem's device: every operator apply,
diagonal and load sum runs kernel B in float64 on the card
(``ops/operators.py``).  Host inputs (node lists, Dirichlet values as a
scalar, list or array, fluxes, nodal sources) are moved to that device
and to float64 here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..fem import shape_functions as sf
from ..mesh.femmesh import FEMMesh
from ..ops import operators
from ..solvers import cg as cg_mod
from ..sparse import assembly


class PoissonProblem:
    """Poisson problem on a FEMMesh (any K, degree, embedding dim), on
    ``device`` (the CUDA device by default, or the device of a
    ``node_positions`` tensor)."""

    def __init__(self, mesh: FEMMesh, node_positions=None, device=None):
        self.mesh = mesh
        self.device = config.device_for(device, node_positions)
        self.node_positions = node_positions
        self.L = operators.laplacian(mesh, node_positions, self.device)
        self.M = operators.mass(mesh, node_positions=node_positions,
                                device=self.device)
        self._geom = mesh.geometry(self.device,
                                   node_positions=node_positions)

    def _real(self, x):
        return torch.as_tensor(x, dtype=config.REAL, device=self.device)

    # -- loads ------------------------------------------------------------
    def load_from_source(self, f):
        """Consistent load b_i = int f phi_i for nodal f [N] or a callable
        of one node position."""
        if callable(f):
            f = np.apply_along_axis(f, 1, self.mesh.node_positions)
        return self.M(self._real(f))

    def neumann_load(self, flux_per_belem, belems=None):
        """b_i += int_bdry g phi_i for per-boundary-element constant flux g.

        flux_per_belem: [B] (or [len(belems)] if belems given)."""
        mesh = self.mesh
        if belems is None:
            belems = np.arange(mesh.num_boundary_elements)
        belems = np.asarray(belems, dtype=np.int64)
        bvol = self._geom.bdry_volume[torch.as_tensor(belems,
                                                      device=self.device)]
        w = self._real(sf.integrated_shape_np(mesh.K - 1, mesh.degree))
        fe = (self._real(flux_per_belem)[:, None] * bvol[:, None]
              * w[None, :])
        return assembly.scatter_load(fe, mesh.bdry_elem_nodes[belems],
                                     mesh.num_nodes)

    # -- solve ------------------------------------------------------------
    def solve(self, dirichlet_nodes, dirichlet_values, source=None,
              extra_load=None, tol: float = 1e-12, maxiter: int = 20000):
        """Returns (u [N], CGResult)."""
        mesh = self.mesh
        b = torch.zeros(mesh.num_nodes, dtype=config.REAL,
                        device=self.device)
        if source is not None:
            b = b + self.load_from_source(source)
        if extra_load is not None:
            b = b + self._real(extra_load)

        nodes = torch.as_tensor(np.asarray(dirichlet_nodes, dtype=np.int64),
                                device=self.device)
        fixed = torch.zeros(mesh.num_nodes, dtype=torch.bool,
                            device=self.device)
        fixed[nodes] = True
        values = self._real(dirichlet_values)
        if values.dim() == 0:
            values = values.expand(nodes.shape[0])
        vals = torch.zeros_like(b)
        vals[nodes] = values

        diag = self.L.diagonal()
        safe = torch.where(diag > 0, diag, torch.ones_like(diag))
        res = cg_mod.solve_dirichlet(self.L, b, fixed, vals,
                                     M_inv=lambda r: r / safe, tol=tol,
                                     maxiter=maxiter)
        return res.x, res

    # -- postprocessing -----------------------------------------------------
    def gradient(self, u):
        """Per-element gradient [E, dim] (``Poisson.hh`` averageGradient
        building block), at the problem's node positions (the reference
        takes the stored ones even for a perturbed problem)."""
        return operators.gradient(self.mesh, u, self.node_positions)

    def average_gradient(self, u):
        g = self.gradient(u)
        vol = self._geom.volume
        return torch.einsum("e,ed->d", vol, g) / torch.sum(vol)

    def energy(self, u):
        """Dirichlet energy 1/2 u^T L u."""
        return 0.5 * torch.vdot(u, self.L(u))
