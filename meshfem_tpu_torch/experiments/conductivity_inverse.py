"""Conductivity inverse-problem validation suite (counterpart of
``experiments/conductivity_inverse.py``).

  forward:  -div(a grad u) = f,  u = 0 on the boundary, with the
            conductivity ``a`` interpolated in the FEM basis;
  inverse:  recover ``a`` from the solved ``u`` by the direct inverse
            system  M(u) a = L(a) u,  M_ij = int phi_j grad(phi_i).grad(u).

Both element-matrix families are one batched quadrature einsum over all
elements on the device; the load vector is summed by a ``ScatterPlan``
(kernel B on the card); the forward solve is the library's projection CG
on an ``EBEKernel`` (unpreconditioned, as in the reference); the
Tikhonov-regularized inverse system is assembled from the device's
element blocks and factorized once on the host (``scipy``'s ``splu``), as
the reference does.

The reference reads its domain ``omega.msh`` from a collection outside
this repository.  Given no mesh, this module writes a stand-in,
``omega.msh`` in the working directory (:func:`write_omega`): a
non-convex heptagon in [0, 1]^2 with an off-centre square hole, meshed by
``triangulate_pslg`` at a target area of 2.5e-4 (5,198 triangles,
10,670 P2 nodes).  Nothing here claims to equal the reference's
domain.

Asserted outcome: the recovered conductivity matches the true field on
interior nodes (median relative error < 1e-3, 95th percentile < 1e-2).

Run: python -m meshfem_tpu_torch.experiments.conductivity_inverse
     [--degree 2] [--mesh omega.msh] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from meshfem_tpu_torch import config
from meshfem_tpu_torch.fem import quadrature, shape_functions as sf
from meshfem_tpu_torch.io import meshio
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
from meshfem_tpu_torch.solvers import cg as cg_mod
from meshfem_tpu_torch.sparse.assembly import scatter_load
from meshfem_tpu_torch.sparse.ebe import EBEKernel

OMEGA = "omega.msh"
OMEGA_OUTLINE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.55], [0.7, 0.6],
                          [0.85, 1.0], [0.0, 1.0], [0.05, 0.5]])
OMEGA_HOLE = np.array([[0.55, 0.25], [0.7, 0.25], [0.7, 0.4], [0.55, 0.4]])
OMEGA_AREA = 2.5e-4


def write_omega(path, target_area: float = OMEGA_AREA) -> None:
    """The stand-in domain (see the module's docstring) as an MSH file."""
    V, F = triangulate_pslg(OMEGA_OUTLINE, holes=[OMEGA_HOLE],
                            target_area=target_area)
    meshio.save(path, V, F)


def _quad_tables(mesh, qdeg, device):
    """(weights [Q], phi [Q, n], dphi [Q, n, K+1]) on the reference cell,
    on ``device``."""
    pts, w = quadrature.rule_np(mesh.K, qdeg)
    phi = sf.eval_shape_np(mesh.K, mesh.degree, pts)
    dphi = sf.grad_shape_np(mesh.K, mesh.degree, pts)
    return tuple(torch.as_tensor(x, dtype=config.REAL, device=device)
                 for x in (w, phi, dphi))


def _elem_nodes(mesh, device):
    return torch.as_tensor(mesh.elem_nodes, device=device)


def forward_matrices(mesh, a, device=None):
    """[E, n, n] element matrices of int a grad(phi_i).grad(phi_j), one
    einsum chain on the device (``a`` nodal, [N])."""
    g = mesh.geometry(config.resolve_device(device))
    dev = g.volume.device
    deg = mesh.degree
    w, phi, dphi = _quad_tables(mesh, deg + 2 * max(deg - 1, 1), dev)
    gp = torch.einsum("qnk,ekd->qend", dphi, g.grad_lambda)   # phys grads
    ae = torch.as_tensor(a, dtype=config.REAL,
                         device=dev)[_elem_nodes(mesh, dev)]   # [E, n]
    aq = torch.einsum("qn,en->qe", phi, ae)                    # a at q
    return torch.einsum("q,qe,qeid,qejd,e->eij", w, aq, gp, gp, g.volume)


def load_vector(mesh, f, device=None):
    """b_i = int f phi_i with f nodally interpolated, the element loads
    summed by a ``ScatterPlan`` (the reference's ``segment_sum``)."""
    g = mesh.geometry(config.resolve_device(device))
    dev = g.volume.device
    w, phi, _ = _quad_tables(mesh, 2 * mesh.degree, dev)
    fe = torch.as_tensor(f, dtype=config.REAL,
                         device=dev)[_elem_nodes(mesh, dev)]
    fq = torch.einsum("qn,en->qe", phi, fe)
    be = torch.einsum("q,qe,qi,e->ei", w, fq, phi, g.volume)
    return scatter_load(be, mesh.elem_nodes, mesh.num_nodes)


def solve_forward(mesh, a, f, tol=1e-11, device=None):
    """Zero-Dirichlet forward solve through the library CG; returns (u,
    the operator L(a) as an ``EBEKernel``, the CG result)."""
    Ke = forward_matrices(mesh, a, device)
    kern = EBEKernel.build(Ke, mesh.elem_nodes, mesh.num_nodes, 1)
    b = load_vector(mesh, f, Ke.device)
    fixed = torch.zeros(mesh.num_nodes, dtype=torch.bool, device=Ke.device)
    fixed[torch.as_tensor(mesh.bdry_nodes, device=Ke.device)] = True
    res = cg_mod.solve_dirichlet(kern, b, fixed, torch.zeros_like(b),
                                 M_inv=None, tol=tol, maxiter=40000)
    return res.x, kern, res


def inverse_matrices(mesh, u):
    """[E, n, n] blocks of M_ij = int phi_j grad(phi_i).grad(u) (i the
    test row, j multiplying the unknown conductivity), on u's device."""
    g = mesh.geometry(u.device)
    deg = mesh.degree
    w, phi, dphi = _quad_tables(mesh, deg + 2 * max(deg - 1, 1), u.device)
    gp = torch.einsum("qnk,ekd->qend", dphi, g.grad_lambda)
    ue = u[_elem_nodes(mesh, u.device)]
    guq = torch.einsum("qend,en->qed", gp, ue)                 # grad u at q
    return torch.einsum("q,qeid,qed,qj,e->eij", w, gp, guq, phi, g.volume)


def solve_inverse(mesh, u, rhs, lam_rel: float = 1e-7):
    """The conductivity from the direct inverse system, by the
    Tikhonov-regularized normal equations (M^T M + lam scale L) a =
    M^T rhs with L the geometric Laplacian, factorized on the host (M has
    near-zero rows wherever grad u vanishes, which a plain LU spreads
    over the domain).  Returns a [N] numpy array."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    Me = inverse_matrices(mesh, u).cpu().numpy()
    n = mesh.nodes_per_elem
    rows = np.repeat(mesh.elem_nodes, n, axis=1).reshape(-1)
    cols = np.tile(mesh.elem_nodes, (1, n)).reshape(-1)
    shape = (mesh.num_nodes, mesh.num_nodes)
    M = sp.coo_matrix((Me.reshape(-1), (rows, cols)), shape=shape).tocsr()
    # the geometric Laplacian (the same quadrature machinery, a == 1)
    g = mesh.geometry("cpu")
    w, phi, dphi = _quad_tables(mesh, 2 * max(mesh.degree - 1, 1), "cpu")
    gp = np.einsum("qnk,ekd->qend", dphi.numpy(), g.grad_lambda.numpy())
    KeL = np.einsum("q,qeid,qejd,e->eij", w.numpy(), gp, gp,
                    g.volume.numpy())
    L = sp.coo_matrix((KeL.reshape(-1), (rows, cols)), shape=shape).tocsr()
    MtM = (M.T @ M).tocsr()
    scale = MtM.diagonal().mean() / max(L.diagonal().mean(), 1e-300)
    A = (MtM + lam_rel * scale * L).tocsc()
    return spla.splu(A).solve(M.T @ np.asarray(rhs))


def run(degree=2, mesh_path=None, decimate=1, device=None):
    """Forward and inverse on the mesh at ``mesh_path`` (the stand-in,
    written to ``omega.msh`` in the working directory, when None).
    ``decimate`` is kept from the reference's signature, which ignores it
    too.  Returns the interior errors' median and 95th percentile, the
    errors, both fields and the interior mask."""
    if mesh_path is None:
        mesh_path = OMEGA
        write_omega(mesh_path)
        print(f"no mesh given: wrote {os.path.abspath(mesh_path)} (the "
              f"stand-in domain, target area {OMEGA_AREA:g})")
    V, T = meshio.load(mesh_path)
    mesh = FEMMesh(V[:, :2], T, degree=degree)
    X = mesh.node_positions
    f = np.sin(2 * np.pi * X[:, 0] * X[:, 1])
    a = 1.5 + np.cos(0.5 * np.pi * X[:, 0] * X[:, 1])

    u, kern_a, _ = solve_forward(mesh, a, f, device=device)
    # inverse rhs = L(a_true) u (== b + the Dirichlet reaction residual)
    rhs = kern_a(u).cpu().numpy()
    a_inf = solve_inverse(mesh, u, rhs)

    interior = ~mesh.is_bdry_node
    err = np.abs(a_inf - a) / np.abs(a).max()
    q50, q95 = np.quantile(err[interior], [0.5, 0.95])
    print(f"nodes={mesh.num_nodes} interior median rel err={q50:.3e} "
          f"p95={q95:.3e}")
    return dict(median=q50, p95=q95, err=err, a=a, a_inf=a_inf,
                interior=interior)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--mesh", default=None,
                    help="domain mesh (default: write the stand-in)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    out = run(degree=args.degree, mesh_path=args.mesh, device=args.device)
    assert out["median"] < 1e-3, out["median"]
    assert out["p95"] < 1e-2, out["p95"]
    print("conductivity_inverse OK")
    return out


if __name__ == "__main__":
    main()
