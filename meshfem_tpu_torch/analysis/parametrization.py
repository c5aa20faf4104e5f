"""Surface parametrization: harmonic, LSCM, SCP (counterpart of
``meshfem_tpu/analysis/parametrization.py``; parity with the reference's
``Parametrization.hh/.cc``: ``harmonic :39``, ``lscm :35``, the spectral
conformal ``scp :60`` after Mullen et al. 2008, and the
``scaleFactor`` / ``conformalDistortion`` analysis).

The conformal (LSCM) energy is E_C(z) = E_Dirichlet(z) - Area(z):
  H = [L 0; 0 L] - S,  S the boundary area pairing
  Area(u, v) = 1/2 sum_bdry_edges (u_i v_j - u_j v_i).
``harmonic`` fixes the longest boundary loop on the unit circle by
arclength and solves two Jacobi-preconditioned Dirichlet CGs; ``lscm``
pins the two farthest boundary vertices and solves H z = b by CG; ``scp``
finds the smallest generalized eigenvector of (H, M), the translations
deflated, by LOBPCG.

On the card every L and M apply is the float64 EBE operator (a plain
gather, ``torch.bmm``, kernel B): one value a node in ``harmonic``, two
(u and v together) in ``lscm`` and 2m in ``scp``, which applies H and M
to all m columns of a block at once where the reference loops over them.
The area pairing sums its boundary-edge terms into nodes through one
``ScatterPlan`` (kernel B), not ``index_add_``.  As in the reference the
maps are of the vertices: ``harmonic`` on a P2 mesh fixes the boundary
vertices only (its boundary edge nodes stay free), and the Jacobian
reads the vertex values.  Vertex ids (boundary loops and edges, the
pins, ``F``) become node ids through ``mesh.vertex_nodes``, so a mesh in
any ``node_order`` gives the reference order's maps, renumbered (the
reference reads vertex ids as node ids).  Entry points run on the CUDA
device unless ``device="cpu"`` (or ``uv`` is a CPU tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mesh.femmesh import FEMMesh
from ..ops import operators
from ..solvers import cg as cg_mod
from ..solvers import eigen as eigen_mod
from ..sparse.scatter import ScatterPlan


def _conformal_operator(mesh: FEMMesh, device=None):
    """(H applying to z [N, 2] or a block [N, 2, m], the Laplacian, the
    boundary edges [B, 2])."""
    L = operators.laplacian(mesh, device=device)
    dev = L.Ke.device
    edges = mesh.cell.boundary_edges()          # [B, 2] CCW
    en = mesh.vertex_nodes[edges]               # their node ids
    N = mesh.num_nodes
    i = torch.as_tensor(en[:, 0], device=dev)
    j = torch.as_tensor(en[:, 1], device=dev)
    plan = ScatterPlan.build(np.concatenate([en[:, 0], en[:, 1]]), N, dev)

    def area_pair(z):
        """Gradient of Area(u, v) = 1/2 sum (u_i v_j - u_j v_i): the terms
        at i, then those at j, summed per node by kernel B."""
        u, v = z[:, 0], z[:, 1]
        return plan(torch.stack([torch.cat([0.5 * v[j], -0.5 * v[i]]),
                                 torch.cat([-0.5 * u[j], 0.5 * u[i]])],
                                dim=1))

    def H(z):
        Lz = L(z.reshape(N, -1)).reshape(z.shape)
        return Lz - area_pair(z)

    return H, L, edges


def harmonic(mesh: FEMMesh, tol: float = 1e-11,
             device=None) -> torch.Tensor:
    """Boundary mapped to the unit circle by arclength, interior harmonic
    (``Parametrization.hh:39``): [N, 2], each CG at ``cg``'s default of at
    most 1000 iterations, as the reference's."""
    L = operators.laplacian(mesh, device=device)
    dev = L.Ke.device
    loop = max(mesh.cell.boundary_loops(), key=len)
    pts = mesh.V[loop]
    seg = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)
    s = np.concatenate([[0], np.cumsum(seg)[:-1]]) / seg.sum()
    theta = 2 * np.pi * s
    nodes = mesh.vertex_nodes[loop]
    fixed = np.zeros(mesh.num_nodes, dtype=bool)
    fixed[nodes] = True
    vals = np.zeros((mesh.num_nodes, 2))
    vals[nodes] = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    fixed_t = torch.as_tensor(fixed, device=dev)
    vals_t = torch.as_tensor(vals, device=dev)
    diag = L.diagonal()
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))
    zero = torch.zeros(mesh.num_nodes, dtype=config.REAL, device=dev)
    cols = [cg_mod.solve_dirichlet(L, zero, fixed_t, vals_t[:, c],
                                   M_inv=lambda r: r / safe,
                                   tol=tol).x for c in range(2)]
    return torch.stack(cols, dim=1)


def lscm(mesh: FEMMesh, pin_nodes=None, tol: float = 1e-11,
         device=None) -> torch.Tensor:
    """Least-squares conformal map with two pinned nodes
    (``Parametrization.hh:35``; by default the nodes of the two
    farthest-apart boundary vertices): [N, 2], unpreconditioned CG of at
    most 20,000 iterations, as the reference's."""
    H, L, _ = _conformal_operator(mesh, device)
    if pin_nodes is None:
        # pin the two farthest-apart boundary vertices
        bverts = mesh.cell.boundary_vertices()
        p = mesh.V[bverts]
        d2 = ((p[:, None] - p[None, :]) ** 2).sum(-1)
        a, b = np.unravel_index(np.argmax(d2), d2.shape)
        pin_nodes = [int(mesh.vertex_nodes[bverts[a]]),
                     int(mesh.vertex_nodes[bverts[b]])]
    dev = L.Ke.device
    fixed = np.zeros((mesh.num_nodes, 2), dtype=bool)
    fixed[pin_nodes] = True
    vals = np.zeros((mesh.num_nodes, 2))
    vals[pin_nodes[0]] = [0.0, 0.0]
    vals[pin_nodes[1]] = [1.0, 0.0]
    fixed_t = torch.as_tensor(fixed, device=dev)
    project = cg_mod.mask_projector(~fixed_t)
    z_d = torch.where(fixed_t, torch.as_tensor(vals, device=dev), 0.0)
    res = cg_mod.cg(H, project(-H(z_d)), project=project, tol=tol,
                    maxiter=20000)
    return res.x + z_d


def scp(mesh: FEMMesh, tol: float = 1e-8, maxiter: int = 300, device=None):
    """Spectral conformal parametrization (``Parametrization.hh:60``): the
    smallest nontrivial generalized eigenvector of (H, M), M the scalar
    mass matrix on both coordinates, the translations deflated.  Returns
    (z [N, 2], eigenvalues)."""
    H, _, _ = _conformal_operator(mesh, device)
    M = operators.mass(mesh, device=device)
    N = mesh.num_nodes

    def K_apply(Z):   # [2N, m], rows (u, v) interleaved: 2 i + c
        return H(Z.reshape(N, 2, -1)).reshape(2 * N, -1)

    def M_apply(Z):
        return M(Z.reshape(N, -1)).reshape(2 * N, -1)

    # the translations: constant u, constant v
    Z = np.zeros((2 * N, 2))
    Z[0::2, 0] = 1.0
    Z[1::2, 1] = 1.0
    rng = np.random.default_rng(0)
    X0 = torch.as_tensor(rng.standard_normal((2 * N, 2)),
                         device=M.Ke.device)
    lam, X, _ = eigen_mod.lobpcg_generalized(K_apply, M_apply, X0, deflate=Z,
                                             tol=tol, maxiter=maxiter)
    return X[:, 0].reshape(N, 2), lam


def scale_factor(mesh: FEMMesh, uv, device=None) -> torch.Tensor:
    """Per-element area scale factor |det J| of the parametrization
    (``Parametrization.hh:70``)."""
    J = _param_jacobian(mesh, uv, device)
    return torch.abs(J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0])


def conformal_distortion(mesh: FEMMesh, uv, device=None) -> torch.Tensor:
    """Per-element quasi-conformal distortion sigma_max / sigma_min."""
    J = _param_jacobian(mesh, uv, device)
    a = (J * J).sum(dim=(1, 2))
    det = torch.abs(J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0])
    # singular values from the invariants
    s = torch.sqrt(torch.clamp(a * a / 4 - det * det, min=0.0))
    smax2 = a / 2 + s
    smin2 = torch.clamp(a / 2 - s, min=1e-300)
    return torch.sqrt(smax2 / smin2)


def _param_jacobian(mesh: FEMMesh, uv, device=None) -> torch.Tensor:
    """[E, 2, 2] Jacobian of the uv map (its vertex values) in a local
    orthonormal frame of each triangle."""
    dev = config.device_for(device, uv)
    uv = torch.as_tensor(uv, dtype=config.REAL, device=dev)
    gp = mesh.geometry(dev).grad_lambda                  # [E, 3, dim]
    X = mesh.V[mesh.F]
    e1 = X[:, 1] - X[:, 0]
    e1 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    if X.shape[-1] == 2:
        e2 = np.stack([-e1[:, 1], e1[:, 0]], axis=1)
    else:
        n = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        e2 = np.cross(n, e1)
    frame = torch.as_tensor(np.stack([e1, e2], axis=1), device=dev)
    corners = torch.as_tensor(mesh.vertex_nodes[mesh.F], device=dev)
    uve = uv[corners]                                    # [E, 3, 2]
    duv = torch.einsum("enc,end->ecd", uve, gp)          # [E, 2, dim]
    return torch.einsum("ecd,efd->ecf", duv, frame)
