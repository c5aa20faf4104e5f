"""Plain PyTorch linear elasticity on P2 tetrahedra: the reference's
operator, loads, fields, homogenized tensor and conjugate gradients.

Isotropic material ``(E, nu)``.  The stiffness is applied without ever
forming an element matrix: at each point of a four-point rule (exact for
the degree-2 products of P2 gradients) the strain of the gathered
element displacements, the stress ``lam tr(e) I + 2 mu e``, and the
stress against each shape gradient, summed into the nodes.  Elements go
in blocks so that any mesh fits.  ``dtype`` selects the precision of
every step (float64 for the judge, float32 for the control).

Flattened symmetric tensors are ordered xx, yy, zz, yz, xz, xy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import EDGES, P2Mesh, boundary_triangles, face_edge_nodes

BLOCK = 1 << 18                 # elements a block
_A = (5.0 + 3.0 * math.sqrt(5.0)) / 20.0
_B = (5.0 - math.sqrt(5.0)) / 20.0
QUAD_POINTS = np.array([[_A, _B, _B, _B], [_B, _A, _B, _B],
                        [_B, _B, _A, _B], [_B, _B, _B, _A]])
QUAD_WEIGHTS = np.full(4, 0.25)        # times the element volume
FLAT = ((0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1))


def lame(E, nu):
    return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), E / (2.0 + 2.0 * nu)


def shape_grad_table(lam_pts):
    """dN_a / dlambda_k at barycentric points [Q, 4] -> [Q, 10, 4]."""
    lam_pts = np.atleast_2d(lam_pts)
    G = np.zeros((len(lam_pts), 10, 4))
    for q, L in enumerate(lam_pts):
        for i in range(4):
            G[q, i, i] = 4.0 * L[i] - 1.0
        for e, (i, j) in enumerate(EDGES):
            G[q, 4 + e, i] = 4.0 * L[j]
            G[q, 4 + e, j] = 4.0 * L[i]
    return G


class Elasticity:
    """The reference's operator on a P2 mesh with node-to-dof map
    ``dof`` (identity by default; a periodic cell's identification)."""

    def __init__(self, mesh: P2Mesh, E, nu, device, dtype=torch.float64,
                 dof=None, num_dofs=None):
        self.mesh, self.device, self.dtype = mesh, device, dtype
        self.lam, self.mu = lame(float(E), float(nu))
        V = torch.as_tensor(mesh.V, device=device).to(dtype)
        T = torch.as_tensor(mesh.T, device=device)
        X = V[T]                                           # [E, 4, 3]
        J = (X[:, 1:] - X[:, :1]).transpose(1, 2)          # columns x_k - x_0
        Jinv = torch.linalg.inv(J)                         # rows grad l_1..3
        self.grad_lambda = torch.cat(
            [-Jinv.sum(dim=1, keepdim=True), Jinv], dim=1)  # [E, 4, 3]
        self.volume = torch.linalg.det(J) / 6.0
        self.elem_nodes = torch.as_tensor(mesh.elem_nodes, device=device)
        self.num_nodes = mesh.num_nodes
        if dof is None:
            self.dof = torch.arange(self.num_nodes, device=device)
            self.num_dofs = self.num_nodes
        else:
            self.dof = torch.as_tensor(dof, device=device)
            self.num_dofs = int(num_dofs)
        self.Gq = torch.as_tensor(shape_grad_table(QUAD_POINTS), dtype=dtype,
                                  device=device)
        self.Gc = torch.as_tensor(shape_grad_table(np.full(4, 0.25)),
                                  dtype=dtype, device=device)[0]
        self._boundary = None          # boundary triangles, on first use

    def _blocks(self):
        E = len(self.volume)
        for s in range(0, E, BLOCK):
            yield slice(s, min(E, s + BLOCK))

    def _stress(self, eps):
        """Isotropic stress of strains [..., 3, 3] (symmetric)."""
        tr = eps.diagonal(dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=eps.dtype, device=eps.device)
        return self.lam * tr[..., None, None] * eye + 2.0 * self.mu * eps

    def apply_nodes(self, u):
        """K u for nodal fields u [N, 3] or [N, 3, m] -> same shape."""
        u = u.to(self.dtype)
        squeeze = u.dim() == 2
        if squeeze:
            u = u[..., None]
        out = torch.zeros_like(u)
        for blk in self._blocks():
            en = self.elem_nodes[blk]
            ue = u[en]                                     # [Eb, 10, 3, m]
            g = self.grad_lambda[blk]
            f = torch.zeros_like(ue)
            for q in range(len(QUAD_WEIGHTS)):
                gN = torch.einsum("ak,ekd->ead", self.Gq[q], g)
                H = torch.einsum("eacm,ead->emcd", ue, gN)
                sig = self._stress(0.5 * (H + H.transpose(-1, -2)))
                w = QUAD_WEIGHTS[q] * self.volume[blk]
                f += torch.einsum("emcd,ead,e->eacm", sig, gN, w)
            out.index_add_(0, en.reshape(-1), f.reshape(-1, 3, u.shape[-1]))
        return out[..., 0] if squeeze else out

    def to_dofs(self, v_nodes):
        """Sum nodal values into dofs [Nd, ...]."""
        out = torch.zeros((self.num_dofs,) + tuple(v_nodes.shape[1:]),
                          dtype=v_nodes.dtype, device=v_nodes.device)
        return out.index_add_(0, self.dof, v_nodes)

    def apply(self, x):
        """K x in dof space: x [Nd, 3(, m)] -> [Nd, 3(, m)]."""
        return self.to_dofs(self.apply_nodes(x[self.dof]))

    def diagonal(self):
        """Diagonal of K in dof space [Nd, 3]:
        sum_q w vol (mu |grad N_a|^2 + (lam + mu) (d_c N_a)^2)."""
        d = torch.zeros((self.num_nodes, 3), dtype=self.dtype,
                        device=self.device)
        for blk in self._blocks():
            g = self.grad_lambda[blk]
            acc = torch.zeros((g.shape[0], 10, 3), dtype=self.dtype,
                              device=self.device)
            for q in range(len(QUAD_WEIGHTS)):
                gN = torch.einsum("ak,ekd->ead", self.Gq[q], g)
                sq = gN * gN
                acc += (QUAD_WEIGHTS[q] * self.volume[blk])[:, None, None] * (
                    self.mu * sq.sum(-1, keepdim=True)
                    + (self.lam + self.mu) * sq)
            d.index_add_(0, self.elem_nodes[blk].reshape(-1),
                         acc.reshape(-1, 3))
        return self.to_dofs(d)

    def centroid_strain(self, u):
        """[E, 3, 3] strain at each element's centroid (the element
        average: a P2 strain is linear) of nodal u [N, 3]."""
        u = u.to(self.dtype)
        gN = torch.einsum("ak,ekd->ead", self.Gc, self.grad_lambda)
        H = torch.einsum("eac,ead->ecd", u[self.elem_nodes], gN)
        return 0.5 * (H + H.transpose(-1, -2))

    def von_mises(self, u):
        """[E] von Mises stress of the centroid stress."""
        s = self._stress(self.centroid_strain(u))
        xx, yy, zz = s[:, 0, 0], s[:, 1, 1], s[:, 2, 2]
        return torch.sqrt(0.5 * ((xx - yy) ** 2 + (yy - zz) ** 2
                                 + (zz - xx) ** 2)
                          + 3.0 * (s[:, 1, 2] ** 2 + s[:, 0, 2] ** 2
                                   + s[:, 0, 1] ** 2))

    # -- loads -------------------------------------------------------------
    def traction_load(self, traction, axis=0, at=1.0, eps=1e-9):
        """Consistent nodal load [Nd, 3] of a uniform traction on the
        boundary triangles whose vertices all lie on ``x[axis] = at``: a P2
        triangle's vertex shape functions integrate to 0 and its edge
        shape functions to a third of its area each."""
        mesh = self.mesh
        if self._boundary is None:
            self._boundary = boundary_triangles(mesh.T)
        tri = self._boundary
        on = (np.abs(mesh.V[tri][:, :, axis] - at) <= eps).all(axis=1)
        tri = tri[on]
        P = mesh.V[tri]
        area = 0.5 * np.linalg.norm(np.cross(P[:, 1] - P[:, 0],
                                             P[:, 2] - P[:, 0]), axis=1)
        nodes = face_edge_nodes(mesh, tri).reshape(-1)
        f = np.repeat(area / 3.0, 3)[:, None] * np.asarray(traction)[None]
        load = np.zeros((mesh.num_nodes, 3))
        np.add.at(load, nodes, f)
        return self.to_dofs(torch.as_tensor(load, dtype=self.dtype,
                                            device=self.device))

    def cell_loads(self):
        """[Nd, 3, 6] right-hand sides of the six cell problems:
        -int grad N_a . sigma(e^i), e^i the canonical strains (1 on a
        diagonal slot, 1/2 on the two entries of a shear slot)."""
        gN = torch.einsum("ak,ekd->ead", self.Gc, self.grad_lambda)
        cols = []
        for i, (k, l) in enumerate(FLAT):
            e = torch.zeros((3, 3), dtype=self.dtype, device=self.device)
            e[k, l] = e[l, k] = 1.0 if k == l else 0.5
            sig = self._stress(e)
            f = -torch.einsum("ead,cd,e->eac", gN, sig, self.volume)
            cols.append(torch.zeros((self.num_nodes, 3), dtype=self.dtype,
                                    device=self.device).index_add_(
                0, self.elem_nodes.reshape(-1), f.reshape(-1, 3)))
        return self.to_dofs(torch.stack(cols, dim=-1))

    def homogenized_tensor(self, w, cell_volume=1.0):
        """[6, 6] stress-form tensor: row i the cell average of the flat
        stress under strain(w_i) + e^i, w [6, N, 3] nodal."""
        rows = []
        for i, (k, l) in enumerate(FLAT):
            e = torch.zeros((3, 3), dtype=self.dtype, device=self.device)
            e[k, l] = e[l, k] = 1.0 if k == l else 0.5
            s = self._stress(self.centroid_strain(w[i]) + e)
            avg = torch.einsum("e,ecd->cd", self.volume, s) / cell_volume
            rows.append(torch.stack([avg[a, b] for a, b in FLAT]))
        return torch.stack(rows)


def project_translations(v):
    return v - v.mean(dim=0, keepdim=True)


def pcg(apply, b, diag, free=None, project=None, tol=1e-10, maxiter=100000):
    """Jacobi-preconditioned CG on every column at once (columns are
    independent Krylov spaces) in ``b``'s dtype.  ``free`` masks fixed
    dofs; ``project`` removes a null space.  Stops when every column's
    recursive residual is below ``tol`` of its right-hand side, or after
    ``maxiter``.  Returns (x, iterations)."""
    P = (lambda v: v) if project is None else project
    mask = (lambda v: v) if free is None else (lambda v: v * free)
    d = torch.where(diag > 0, diag, torch.ones_like(diag))
    while d.dim() < b.dim():
        d = d[..., None]
    axes = tuple(range(b.dim() - 1)) if b.dim() == 3 else tuple(
        range(b.dim()))

    def dot(a, c):
        return (a * c).sum(dim=axes)

    b = P(mask(b))
    x = torch.zeros_like(b)
    r = b.clone()
    z = P(mask(r / d))
    p = z.clone()
    rz = dot(r, z)
    stop = tol * tol * dot(b, b)
    it = 0
    while it < maxiter and bool((dot(r, r) > stop).any()):
        Ap = P(mask(apply(p)))
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1), 0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = P(mask(r / d))
        rz_new = dot(r, z)
        beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1), 0)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it
