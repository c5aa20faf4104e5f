"""Linkage-microstructure mechanisms: opening analysis and optimization
(counterpart of ``meshfem_tpu/analysis/mechanisms.py``; parity with the
reference's ``src/bin/mechanisms/OpenLinkage.cc`` and
``OptimizeLinkage.cc``).

Both drivers iterate periodic homogenization of a linkage cell, take the
softest deformation mode (the minimum eigenstrain of Eh) and advect the
vertices along a per-node field: ``open_linkage`` along the opening
displacement itself, ``optimize_linkage`` along a shape derivative of the
mode.  Each step rebuilds the mesh and its ``ElasticitySimulator`` with
the periodic ``dof_map`` matched once on the input cell; past
``MESHFEM_ROUTED_MIN_E`` elements on the card the cell problems take the
routed block CG (kernel E once per operator build, kernels A and B in
node rows on every block apply).

The shape derivative ``dEh/dx`` (a per-vertex elasticity tensor, the
reference library's ``homogenizedElasticityTensorDiscreteDifferential``)
differentiates the energy form

    Eh_ij,kl |Y| = int_Y (e^ij + e(w^ij)) : C : (e^kl + e(w^kl)) dV
                 = sum_e [ w_i Ke w_j + int e^i : C : e(w_j)
                           + int e^j : C : e(w_i) + e^i : C : e^j vol_e ]

with the nodal fluctuations w held fixed (they solve the cell problems,
where the form is stationary, so the partial derivative is the total
one), at the node positions ``FEMMesh.node_positions_from_vertices(Xv)``
and over a constant |Y| with no gradient.  ``w Ke w`` integrates the P2
strains' product exactly (the reference's centroid-strain form,
``meshfem_tpu/analysis/deformed_cells.py:67``, does so only for P1; the
port's ``deformed_cells._energy_form_tensor`` calls
``energy_form_at_nodes``).  dEh, ``jax.jacrev`` in the reference, is
fl^2 reverse passes of ``torch.autograd.grad``.  Every gather these passes
differentiate (the vertex endpoints, the element corners) is a
``GatherPlan``, so on the card each backward sums by kernel B in a fixed
order and dEh repeats bit for bit.

A mesh in another ``node_order`` is rebuilt in the reference order before
the loop, as in the reference, since the loop rebuilds the mesh at each
step.  Entry points run on the CUDA device unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem import simplex
from ..fem.flattening import flat_len, flat_rows_cols, shear_doubler
from ..mesh import periodic as per
from ..mesh.femmesh import FEMMesh
from ..mesh.geometry import simplex_geometry
from ..ops import element_matrices as em
from ..physics.elasticity import ElasticitySimulator
from . import homogenization as hom


def energy_form_Eh(mesh: FEMMesh, D, w, Xv=None,
                   base_cell_volume: float | None = None,
                   device=None) -> torch.Tensor:
    """Homogenized tensor [fl, fl] by the mutual-energy form at vertex
    positions ``Xv`` (default: the mesh's), differentiable in ``Xv``, the
    nodal fluctuations ``w`` [fl, N, dim] held fixed (reference
    ``PeriodicHomogenization.hh:383-484`` computes the same quantity's
    vertex derivative by hand).  |Y| is ``base_cell_volume`` (default: the
    input mesh's bounding box), a constant, as the reference's
    ``stop_gradient`` makes it."""
    dev = config.device_for(device, Xv if isinstance(Xv, torch.Tensor)
                            else w)
    X = mesh.node_positions_from_vertices(mesh.V if Xv is None else Xv,
                                          device=dev)
    if base_cell_volume is None:
        base_cell_volume = mesh.bbox().volume()
    return energy_form_at_nodes(mesh, D, w, X, base_cell_volume)


def energy_form_at_nodes(mesh: FEMMesh, D, w, X,
                         base_cell_volume: float) -> torch.Tensor:
    """The energy form of ``energy_form_Eh`` at node positions ``X`` [N,
    dim] (vertices and P2 edge nodes, on X's device), differentiable in
    ``X``; only the vertex rows enter (the corner gather), so the edge-node
    rows of a gradient are zero.  ``D`` is [fl, fl] or per element [E,
    fl, fl].  ``w Ke w`` integrates the P2 strains' product exactly; the
    cross terms need only each element's average strain, which for
    strains of degree <= 1 is the centroid value."""
    dim = mesh.dim
    fl = flat_len(dim)
    dev = X.device
    corners = mesh.corner_gather(dev)(X).reshape(
        mesh.num_elements, mesh.K + 1, dim)
    grad_lambda, vol = simplex_geometry(corners, mesh.K)
    D = torch.as_tensor(D, dtype=X.dtype, device=dev)
    w = torch.as_tensor(w, dtype=X.dtype, device=dev)
    Ke = em.element_elasticity(grad_lambda, vol, D, mesh.degree)
    we = w[:, torch.as_tensor(mesh.elem_nodes, device=dev)]  # [fl, E, n, d]
    wef = we.reshape(fl, mesh.num_elements, -1)              # node-major
    term_ww = torch.einsum("iea,eab,jeb->ij", wef, Ke, wef)
    centroid = np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
    B = em.element_strain_matrix(grad_lambda, mesh.degree, centroid)[:, 0]
    sa = torch.einsum("eanc,ienc->iea", B, we)           # [fl, E, fl]
    # int e^i : C : e(w_j) over an element = stress_j[e, i] vol_e
    cross = torch.einsum("e,jei->ij", vol, et.double_contract(D, sa))
    canon = torch.stack([hom.canonical_strain(dim, i, X.dtype)
                         for i in range(fl)]).to(dev)
    # sig[(e,) i] = C : e^i; a per-element material weighs each element
    sig = et.double_contract(D[..., None, :, :], canon)
    const = (torch.einsum("e,eia->ai", vol, sig) if D.dim() == 3
             else sig.T * vol.sum())
    return (term_ww + cross + cross.T + const) / float(base_cell_volume)


def eh_vertex_differential(mesh: FEMMesh, D, w,
                           base_cell_volume: float | None = None,
                           device=None) -> torch.Tensor:
    """dEh/d(vertex positions) [Nv, dim, fl, fl]: one reverse pass for
    each of the fl^2 entries of Eh, the forward graph kept between them."""
    dev = config.device_for(device, w)
    w = torch.as_tensor(w, device=dev).detach()
    with torch.enable_grad():
        Xv = torch.tensor(mesh.V, dtype=config.REAL, device=dev,
                          requires_grad=True)
        Eh = energy_form_Eh(mesh, D, w, Xv, base_cell_volume)
        fl = Eh.shape[0]
        grads = []
        for k in range(fl * fl):
            (g,) = torch.autograd.grad(Eh[k // fl, k % fl], Xv,
                                       retain_graph=k < fl * fl - 1)
            grads.append(g)
    J = torch.stack(grads).reshape((fl, fl) + tuple(Xv.shape))
    return J.permute(2, 3, 0, 1).contiguous()


def sum_identified_vertex_field(mesh: FEMMesh, dof_map, v) -> np.ndarray:
    """Sum values over periodically identified VERTICES and redistribute
    (reference ``sumIdentifiedValues``, ``OptimizeLinkage.cc:87-101``), on
    the host."""
    v = np.asarray(v)
    dofs = np.asarray(dof_map)[np.asarray(mesh.vertex_nodes)]
    acc = np.zeros((int(dofs.max()) + 1,) + v.shape[1:])
    np.add.at(acc, dofs, v)
    return acc[dofs]


def _oriented_eigenstrains(Eh):
    """Eigenstrains sorted ascending by eigenvalue, each flipped so that
    its first raw component is positive (``OpenLinkage.cc:160-171``);
    the flip fixes the sign that the eigensolver leaves free."""
    strains, lam = et.eigenstrains(Eh)                 # [fl, n], ascending
    sign = torch.where(strains[0] < 0, -1.0, 1.0)
    return strains * sign[None, :], lam


def _max_column_normalize(field):
    """Divide by the largest per-node vector norm
    (``Fields.hh maxColumnNormalize``)."""
    nrm = torch.sqrt(torch.max((field ** 2).sum(dim=-1)))
    return field / torch.where(nrm > 0, nrm, 1.0)


@dataclasses.dataclass
class LinkageStep:
    """Per-iteration record of an open/optimize run."""

    Eh: np.ndarray                # [fl, fl]
    min_eigenvalue: float
    opening_strain: np.ndarray    # [fl] raw flat components
    step_field: np.ndarray        # [Nv, dim] applied vertex displacement


@dataclasses.dataclass
class LinkageResult:
    steps: list
    vertices: np.ndarray          # final vertex positions
    max_rel_edge_change: float
    Eh: np.ndarray                # final homogenized tensor


def _unique_edges(mesh: FEMMesh) -> np.ndarray:
    pairs = np.asarray(simplex.simplex_edges(mesh.K))
    e = mesh.F[:, pairs].reshape(-1, 2)
    e.sort(axis=1)
    return np.unique(e, axis=0)


def _base_tensor(material):
    return torch.as_tensor(material.D if hasattr(material, "D")
                           else material, dtype=config.REAL)


def _edge_lengths(V, edges):
    return np.linalg.norm(V[edges[:, 0]] - V[edges[:, 1]], axis=1)


def _cell_problems(m, D0, dof_map, cell, tol, dev):
    """The cell problems of mesh ``m`` with the held ``dof_map``: (w, Eh in
    displacement form over the input cell's volume)."""
    sim = ElasticitySimulator(m, D0, device=dev, dof_map=dof_map)
    w, _ = hom.solve_cell_problems(sim, tol=tol)
    return w, hom.homogenized_tensor_displacement_form(
        sim, w, base_cell_volume=cell.volume())


def _in_reference_order(mesh: FEMMesh) -> FEMMesh:
    """``mesh`` renumbered in the reference node order: the linkage loops
    rebuild the mesh at each step, so ``dof_map`` must keep meaning."""
    if mesh.node_order == "reference":
        return mesh
    return FEMMesh(np.asarray(mesh.V), mesh.F, degree=mesh.degree)


def open_linkage(mesh: FEMMesh, material, num_steps: int = 20,
                 opening_speed: float = 0.01, orthotropic_cell: bool = False,
                 tol: float = 1e-7, permit_mismatch: bool = False,
                 callback=None, device=None) -> LinkageResult:
    """Iteratively open a linkage microstructure along its softest mode
    (``OpenLinkage.cc:106-252``).

    Each step: homogenize -> min eigenstrain of Eh = opening strain ->
    opening displacement = strain-driven affine part + the matching
    combination of fluctuation fields (their mean over each min face's
    boundary nodes removed) -> normalize, scale by ``opening_speed``,
    advect the vertices.  The periodic identification is computed ONCE on
    the input mesh and held (the reference's manualPeriodicVertices)."""
    dev = config.resolve_device(device)
    D0 = _base_tensor(material)
    mesh = _in_reference_order(mesh)
    dim = mesh.dim
    edges = _unique_edges(mesh)
    V0 = np.asarray(mesh.V, np.float64)
    orig_len = _edge_lengths(V0, edges)
    cell = mesh.bbox()
    dof_map, _, _ = per.match_periodic_nodes(
        mesh.node_positions, cell, 1e-7, permit_mismatch=permit_mismatch)
    r, c = flat_rows_cols(dim)
    doubler = torch.as_tensor(shear_doubler(dim), dtype=config.REAL,
                              device=dev)

    V = V0.copy()
    steps: list[LinkageStep] = []
    max_rel = 0.0
    Eh = None
    m = mesh
    for it in range(num_steps):
        if orthotropic_cell:
            res = hom.homogenize_orthotropic(m, D0, tol=tol, device=dev)
            w, Eh = res.w, res.Ch
        else:
            w, Eh = _cell_problems(m, D0, dof_map, cell, tol, dev)
        strains, lam = _oriented_eigenstrains(Eh)
        opening = strains[:, 0]                        # min eigenstrain

        # keep boundary vertices on the cell faces in the average sense:
        # per component, subtract the mean of w over nodes on the min face
        bb = m.bbox()
        pos = m.node_positions
        w_c = w.clone()
        for dcomp in range(dim):
            on_face = np.abs(pos[:, dcomp] - bb.min[dcomp]) < 1e-9
            on_face &= m.is_bdry_node
            if on_face.any():
                idx = torch.as_tensor(np.nonzero(on_face)[0], device=dev)
                w_c[:, :, dcomp] -= w[:, idx, dcomp].mean(dim=1)[:, None]

        opening_np = opening.cpu().numpy()
        S = np.zeros((dim, dim))
        S[r, c] = opening_np
        S[c, r] = opening_np
        affine = (pos - 0.5 * (bb.min + bb.max)) @ S.T  # [N, dim]
        disp = torch.as_tensor(affine, device=dev) + torch.einsum(
            "i,ind->nd", doubler * opening, w_c)
        step = _max_column_normalize(disp) * opening_speed
        step_v = step.cpu().numpy()[m.vertex_nodes]
        steps.append(LinkageStep(Eh.cpu().numpy(), float(lam[0]),
                                 opening_np, step_v))
        if callback is not None:
            callback(it, m, steps[-1])
        V = V + step_v
        m = FEMMesh(V, mesh.F, degree=mesh.degree)
        max_rel = max(max_rel, float(np.max(
            np.abs(_edge_lengths(V, edges) - orig_len) / orig_len)))
    return LinkageResult(steps, V, max_rel, Eh.cpu().numpy())


def optimize_linkage(mesh: FEMMesh, material, num_steps: int = 20,
                     step_size: float = 0.01, tol: float = 1e-7,
                     objective_component: int = 1, callback=None,
                     device=None) -> LinkageResult:
    """Steer the softest mode's eigenstrain by moving the vertices along
    the shape derivative of one of its components
    (``OptimizeLinkage.cc:106-202``: descent along the first-order
    eigen-perturbation ``-pinv(Eh) : (dEh : s_min)``), the step summed
    over periodically identified vertices."""
    dev = config.resolve_device(device)
    D0 = _base_tensor(material)
    mesh = _in_reference_order(mesh)
    dim = mesh.dim
    edges = _unique_edges(mesh)
    V0 = np.asarray(mesh.V, np.float64)
    orig_len = _edge_lengths(V0, edges)
    cell = mesh.bbox()
    dof_map, _, _ = per.match_periodic_nodes(mesh.node_positions, cell,
                                             1e-7)
    doubler = torch.as_tensor(shear_doubler(dim), dtype=config.REAL,
                              device=dev)
    V = V0.copy()
    steps: list[LinkageStep] = []
    Eh = None
    m = mesh
    for it in range(num_steps):
        w, Eh = _cell_problems(m, D0, dof_map, cell, tol, dev)
        strains, lam = _oriented_eigenstrains(Eh)
        s_min = strains[:, 0]
        dEh = eh_vertex_differential(m, D0, w, base_cell_volume=cell.volume(),
                                     device=dev)
        # d(s_min)/dx ~ -pinv(Eh) (dEh : s_min): [Nv, dim, fl]
        dstrain = -torch.einsum("ab,vcbd,d->vca",
                                et.pseudoinverse(Eh) * doubler[None, :],
                                dEh * doubler, s_min)
        desc = sum_identified_vertex_field(
            m, dof_map, dstrain[:, :, objective_component].cpu().numpy())
        step = (_max_column_normalize(torch.as_tensor(desc))
                * step_size).numpy()
        steps.append(LinkageStep(Eh.cpu().numpy(), float(lam[0]),
                                 s_min.cpu().numpy(), step))
        if callback is not None:
            callback(it, m, steps[-1])
        V = V + step
        m = FEMMesh(V, mesh.F, degree=mesh.degree)
    max_rel = float(np.max(np.abs(_edge_lengths(V, edges) - orig_len)
                           / orig_len))
    return LinkageResult(steps, V, max_rel, Eh.cpu().numpy())
