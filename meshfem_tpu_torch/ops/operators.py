"""Discrete differential operators over a FEMMesh (counterpart of
``meshfem_tpu/ops/operators.py``).

Parity with the reference's operator layer (``Laplacian.hh``,
``MassMatrix.hh``, ``differential_operators.cc:22-79``: laplacian, mass,
mass_elasticity, bilaplacian, gradient, divergence), exposed both as
matrix-free device operators and scipy matrices for host verification.
Every operator is an ``EBEOperator`` over the float64 ``EBEKernel``: a
plain gather, one ``torch.bmm`` and kernel B (``segment_sum_rows`` in
float64, one value a node for a scalar field) on the card.  The
operators run on ``device`` (the CUDA device by default, or the device of
a ``node_positions`` tensor); ``gradient`` and ``divergence`` where their
field lies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import config
from ..fem import shape_functions as sf
from ..mesh.femmesh import FEMMesh
from ..sparse import assembly
from ..sparse.ebe import EBEKernel
from . import element_matrices as em


@dataclasses.dataclass
class EBEOperator:
    """Element-by-element symmetric operator A = scatter(Ke gather(.)) on
    Ke's device, summed by kernel B through one ``ScatterPlan``."""

    Ke: torch.Tensor         # [E, n, n] or [E, n*d, n*d]
    elem_nodes: np.ndarray   # [E, n]
    num_nodes: int
    vector_dim: int = 1

    def __post_init__(self):
        self._kernel = EBEKernel.build(
            self.Ke, assembly.host_ids(self.elem_nodes), self.num_nodes,
            self.vector_dim)

    def __call__(self, u):
        return self._kernel(u)

    def diagonal(self):
        return self._kernel.diagonal()

    def to_scipy(self):
        return assembly.assemble_scipy(self.Ke.cpu().numpy(),
                                       assembly.host_ids(self.elem_nodes),
                                       self.num_nodes, d=self.vector_dim)

    @property
    def shape(self):
        n = self.num_nodes * self.vector_dim
        return (n, n)


def _geometry(mesh: FEMMesh, node_positions, device):
    return mesh.geometry(config.device_for(device, node_positions),
                         node_positions=node_positions)


def laplacian(mesh: FEMMesh, node_positions=None,
              device=None) -> EBEOperator:
    """FEM stiffness for -Laplace (``Laplacian.hh:28-56``)."""
    g = _geometry(mesh, node_positions, device)
    Ke = em.element_laplacian(g.grad_lambda, g.volume, mesh.degree)
    return EBEOperator(Ke, mesh.elem_nodes, mesh.num_nodes)


def mass(mesh: FEMMesh, lumped: bool = False, node_positions=None,
         device=None):
    """Consistent (or lumped -> [N] diagonal) mass matrix
    (``MassMatrix.hh:24-60``)."""
    g = _geometry(mesh, node_positions, device)
    if lumped:
        Me = em.element_mass_lumped(g.volume, mesh.K, mesh.degree)
        return assembly.scatter_load(Me, mesh.elem_nodes, mesh.num_nodes)
    Ke = em.element_mass(g.volume, mesh.K, mesh.degree)
    return EBEOperator(Ke, mesh.elem_nodes, mesh.num_nodes)


def mass_elasticity(mesh: FEMMesh, node_positions=None,
                    device=None) -> EBEOperator:
    """Vector-valued mass matrix (``MassMatrix::construct_vector_valued``),
    dof ``node * d + component``."""
    g = _geometry(mesh, node_positions, device)
    Me = em.element_mass(g.volume, mesh.K, mesh.degree)
    d = mesh.dim
    n = mesh.nodes_per_elem
    eye = torch.eye(d, dtype=Me.dtype, device=Me.device)
    Kv = torch.einsum("eij,cf->eicjf", Me, eye).reshape(-1, n * d, n * d)
    return EBEOperator(Kv, mesh.elem_nodes, mesh.num_nodes, vector_dim=d)


def gradient(mesh: FEMMesh, u, node_positions=None):
    """Per-element gradient of a nodal scalar field u [N] (constant for P1,
    evaluated at the element centroid for P2): [E, dim] on u's device."""
    g = _geometry(mesh, node_positions, u.device)
    centroid = np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
    dN = torch.as_tensor(sf.grad_shape_np(mesh.K, mesh.degree, centroid)[0],
                         dtype=g.grad_lambda.dtype, device=u.device)
    gp = torch.einsum("nk,ekd->end", dN, g.grad_lambda)     # [E, n, dim]
    ue = u[torch.as_tensor(mesh.elem_nodes, device=u.device)]
    return torch.einsum("end,en->ed", gp, ue)


def divergence(mesh: FEMMesh, X, node_positions=None):
    """Nodal divergence load b_i = -int grad(phi_i) . X for per-element
    constant vector fields X [E, dim] (geodesics-in-heat RHS,
    ``experiments/geodesic_heat/main.cc:82-88``), on X's device."""
    g = _geometry(mesh, node_positions, X.device)
    S = torch.as_tensor(em.shape_grad_table(mesh.K, mesh.degree),
                        dtype=g.grad_lambda.dtype, device=X.device)
    # int grad phi_i = vol * sum_k S[k, i] g_k
    int_grad = torch.einsum("kn,ekd->end", S,
                            g.grad_lambda) * g.volume[:, None, None]
    fe = -torch.einsum("end,ed->en", int_grad, X)
    return assembly.scatter_load(fe, mesh.elem_nodes, mesh.num_nodes)


def bilaplacian_apply(mesh: FEMMesh, node_positions=None,
                      device=None) -> Callable:
    """B = L M^-1_lumped L as a matrix-free operator (reference
    ``differential_operators.cc`` bilaplacian)."""
    L = laplacian(mesh, node_positions, device)
    Ml = mass(mesh, lumped=True, node_positions=node_positions,
              device=device)
    inv = 1.0 / Ml

    def apply(u):
        return L(inv * L(u))

    return apply
