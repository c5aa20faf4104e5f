"""Homogenization of linearly deformed cells and shape derivatives of the
homogenized tensor (counterpart of ``meshfem_tpu/analysis/
deformed_cells.py``; parity with the reference's ``DeformedCells_cli.cc``
and ``PeriodicHomogenization.hh:226-492``).

``homogenize_deformed`` warps the cell by a linear map (periodic pairs
matched on the original cell, the simulator built at the warped positions,
``ElasticitySimulator(node_positions=...)``) or, with
``transform_version``, transforms the base tensor by the map's rotation.
The shape derivative differentiates the energy-form tensor with the
fluctuations frozen (valid because w is the stationary point of the
cell-problem energy, so the partial derivative is the total one) by
``torch.autograd`` through ``mesh.geometry.simplex_geometry``, where the
reference takes ``jax.grad``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem.flattening import shear_doubler
from ..mesh import periodic as per
from ..mesh.femmesh import FEMMesh
from ..mesh.geometry import simplex_geometry
from ..ops import element_matrices as em
from ..physics.elasticity import ElasticitySimulator
from ..physics.materials import Material
from . import homogenization as hom


def homogenize_deformed(mesh: FEMMesh, material, jacobian,
                        transform_version: bool = False, tol: float = 1e-11,
                        device=None) -> hom.HomogenizationResult:
    """Effective tensor of the cell warped by the linear map ``jacobian``.

    transform_version=False: warp the mesh vertices (the DeformedCells
    default).  transform_version=True: keep the mesh and transform the base
    tensor by the rotation part of the map.  Runs on the CUDA device
    unless ``device="cpu"``."""
    F = np.asarray(jacobian, dtype=np.float64)
    if transform_version:
        U, _, Vt = np.linalg.svd(F)
        R = torch.as_tensor(U @ Vt)
        D = material.D if hasattr(material, "D") else material
        D2 = et.transform(torch.as_tensor(D, dtype=config.REAL).cpu(), R)
        return hom.homogenize(mesh, Material(mesh.dim, D2), tol=tol,
                              device=device)
    # a general jacobian (shear, rotation) breaks axis-aligned periodic
    # matching on the warped vertices: match on the ORIGINAL cell and embed
    # the same mesh at the warped positions (the linear map commutes with
    # the edge-node construction); the cell volume is |det F| |Y|
    dof_map, _, _ = per.match_periodic_nodes(mesh.node_positions, mesh.bbox())
    sim = ElasticitySimulator(mesh, material, device=device, dof_map=dof_map,
                              node_positions=mesh.node_positions @ F.T)
    w, iters = hom.solve_cell_problems(sim, tol=tol)
    w = w - w.mean(dim=1, keepdim=True)
    vol_cell = abs(np.linalg.det(F)) * mesh.bbox().volume()
    Ch = hom.homogenized_tensor_stress_form(sim, w, base_cell_volume=vol_cell)
    strain_w = torch.stack([sim.average_strain_field(w[i])
                            for i in range(w.shape[0])])
    return hom.HomogenizationResult(Ch, w, strain_w, iters)


def _energy_form_tensor(mesh: FEMMesh, D, w, node_positions):
    """[fl, fl] energy-form homogenized tensor at ``node_positions`` [N, dim]
    with the fluctuation displacements w [fl, N, dim] FROZEN:
        Ehat(i, j) = 1/|Y| int (eps(w_i) + B_i) : C : (eps(w_j) + B_j),
    equal to the stress-form tensor (the 1/2-normalized canonical basis
    makes the two coincide entry by entry).  Differentiable in
    ``node_positions``."""
    fl = w.shape[0]
    dim = mesh.dim
    X = node_positions
    dev = X.device
    corners = X[torch.as_tensor(mesh.F, device=dev)]
    grad_lambda, volume = simplex_geometry(corners, mesh.K)
    # the average strain of each w_i on each element (strains of degree
    # <= 1: the centroid value)
    centroid = np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
    B = em.element_strain_matrix(grad_lambda, mesh.degree, centroid)[:, 0]
    en = torch.as_tensor(mesh.elem_nodes, device=dev)
    w = w.to(X.dtype)
    eps_w = torch.stack([torch.einsum("eanc,enc->ea", B, w[i][en])
                         for i in range(fl)])            # [fl, E, fl]
    # plus the macroscopic canonical strains
    basis = torch.stack([hom.canonical_strain(dim, i, X.dtype)
                         for i in range(fl)]).to(dev)    # [fl, fl]
    total = eps_w + basis[:, None, :]
    S = torch.as_tensor(shear_doubler(dim), dtype=X.dtype, device=dev)
    D = torch.as_tensor(D, dtype=X.dtype, device=dev)
    if D.dim() == 2:
        sig = torch.einsum("ab,jeb->jea", D * S[None, :], total)
    else:
        sig = torch.einsum("eab,jeb->jea", D * S[None, :], total)
    Ehat = torch.einsum("iea,a,jea,e->ij", total, S, sig, volume)
    return Ehat / mesh.bbox().volume()


def homogenized_tensor_shape_gradient(sim, w, weights):
    """d(sum_ij weights_ij Eh_ij) / d(node positions) [N, dim] at the mesh's
    positions: the shape derivative of a functional of the homogenized
    tensor (replaces the reference library's
    ``homogenizedElasticityTensorDiscreteDifferential``), through the
    energy form with w frozen (total = partial at the stationary point)."""
    mesh = sim.mesh
    X0 = torch.tensor(mesh.node_positions, dtype=config.REAL,
                      device=sim.device, requires_grad=True)
    Wt = torch.as_tensor(np.asarray(weights), dtype=config.REAL,
                         device=sim.device)
    J = torch.sum(Wt * _energy_form_tensor(mesh, sim.D, w.detach(), X0))
    (grad,) = torch.autograd.grad(J, X0)
    return grad


def homogenized_tensor_at(sim, w, node_positions=None):
    """Stress-form-normalized tensor from the energy form (the autodiff
    path of the shape gradient; agrees with
    ``homogenized_tensor_stress_form`` for converged w), at the mesh's
    positions or at ``node_positions``."""
    mesh = sim.mesh
    X = torch.as_tensor(mesh.node_positions if node_positions is None
                        else node_positions, dtype=config.REAL,
                        device=sim.device)
    return _energy_form_tensor(mesh, sim.D, w, X)
