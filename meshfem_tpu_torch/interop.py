"""Build the port's objects from state handed over as numpy arrays.

The reference's objects (``meshfem_tpu``) can be carried across by reading
their fields as numpy (``np.asarray(sim.Ke)`` and so on); these functions
rebuild the port's counterparts from such a dictionary.  Nothing here
imports JAX or the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .mesh.femmesh import FEMMesh
from .physics.elasticity import ElasticitySimulator
from .physics.materials import Material, MaterialField
from .sparse.routed_ebe import RoutedEBE


def simulator_from_arrays(arrays: dict, device=None) -> ElasticitySimulator:
    """ElasticitySimulator from ``V``, ``T``, ``degree``, ``node_order``
    (default ``"reference"``), ``D`` (constant
    [fl, fl] or per element [E, fl, fl]) and optionally ``dof_map`` (a
    periodic node -> dof map), ``dirichlet_mask``, ``dirichlet_values``,
    ``neumann_load``, ``no_rigid_motion``, ``region_nodes`` (the dof ids of
    each Dirichlet region, the reference's ``_region_nodes``, which
    ``report_region_surface_forces`` sums over) and ``Ke`` (shares the
    exact element stiffness instead of re-assembling it)."""
    mesh = FEMMesh(arrays["V"], arrays["T"], degree=int(arrays["degree"]),
                   node_order=str(arrays.get("node_order", "reference")))
    D = torch.tensor(np.asarray(arrays["D"]), dtype=config.REAL)
    Ke = arrays.get("Ke")
    if Ke is not None:
        Ke = torch.tensor(np.asarray(Ke), dtype=config.REAL)
    material = Material(mesh.dim, D) if D.ndim == 2 \
        else MaterialField(mesh.dim, D)
    sim = ElasticitySimulator(mesh, material, device=device, Ke=Ke,
                              dof_map=arrays.get("dof_map"))
    if "dirichlet_mask" in arrays:
        sim.dirichlet_mask[:] = np.asarray(arrays["dirichlet_mask"], bool)
    if "dirichlet_values" in arrays:
        sim.dirichlet_values[:] = np.asarray(arrays["dirichlet_values"],
                                             np.float64)
    if "neumann_load" in arrays:
        sim.neumann_load = torch.tensor(np.asarray(arrays["neumann_load"]),
                                        dtype=config.REAL, device=sim.device)
    sim.no_rigid_motion = bool(arrays.get("no_rigid_motion", False))
    sim._region_nodes = [np.asarray(r, dtype=np.int64)
                         for r in arrays.get("region_nodes", [])]
    return sim


def routed_from_arrays(arrays: dict, device=None) -> RoutedEBE:
    """RoutedEBE from ``elem_dofs``, ``num_dofs``, ``vector_dim`` and
    optionally ``coords``, plus either ``Ke`` (dense backend) or
    ``grad_lambda``, ``volume``, ``lam``, ``mu``, ``deg`` (factored), and
    ``block_rhs`` (the right-hand-side count recorded for ``apply_block``)."""
    dev = config.resolve_device(device)
    factor = None
    if "grad_lambda" in arrays:
        factor = (torch.tensor(np.asarray(arrays["grad_lambda"]),
                               device=dev),
                  torch.tensor(np.asarray(arrays["volume"]), device=dev),
                  float(arrays["lam"]), float(arrays["mu"]),
                  int(arrays["deg"]))
    Ke = arrays.get("Ke")
    if Ke is not None:
        Ke = torch.tensor(np.asarray(Ke), device=dev)
    return RoutedEBE.build(Ke, np.asarray(arrays["elem_dofs"]),
                           int(arrays["num_dofs"]),
                           int(arrays["vector_dim"]),
                           coords=arrays.get("coords"), factor=factor,
                           device=dev, block_rhs=arrays.get("block_rhs"))
