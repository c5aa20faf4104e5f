"""SIMP topology optimization on structured grids.

Counterpart of ``meshfem_tpu/analysis/topopt.py``: the state solve is the
variable-material geometric multigrid (``ops/structured_mg.VarStructuredMG``
over ``ops/structured_var.StructuredVarP2Elasticity``) on the device, the
density filter a ``torch.nn.functional.conv3d`` (an XLA convolution in the
reference, outside any Pallas kernel), and the compliance gradient the
exact adjoint (self-adjoint for compliance: no extra solve).

Standard SIMP setup (Sigmund's 88-line algorithm):
  E(rho) = E_min + rho_f^p (E0 - E_min)      per grid cell,
  rho_f  = conic density filter of rho       (radius ``rmin`` cells),
  min  c(rho) = f^T u(rho)   s.t.  K(rho) u = f,  mean(rho_f) <= volfrac,
optimality-criteria update with bisection on the volume multiplier.

``differentiable_displacement`` gives u(rho) for arbitrary objectives
through an implicit-function adjoint: a ``torch.autograd.Function`` whose
backward solves the adjoint with the same multigrid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..fem import elasticity_tensor as et
from ..mesh import generators
from ..mesh.femmesh import FEMMesh


def _conic_kernel(rmin: float, dim: int = 3):
    """Conic filter weights max(rmin - dist, 0) on a (2r+1)^dim stencil
    (float64 on the host)."""
    r = int(np.ceil(rmin)) - 1
    ax = np.arange(-r, r + 1)
    grids = np.meshgrid(*([ax] * dim), indexing="ij")
    dist = np.sqrt(sum(g.astype(float) ** 2 for g in grids))
    return torch.as_tensor(np.maximum(rmin - dist, 0.0))


def _filter_conv(x, kern):
    """Zero-padded 'same' correlation of the [nx, ny, nz] field ``x`` with
    ``kern``."""
    pad = tuple(s // 2 for s in kern.shape)
    k = kern.to(dtype=x.dtype, device=x.device)
    return F.conv3d(x[None, None], k[None, None], padding=pad)[0, 0]


@dataclasses.dataclass
class ComplianceTopOpt:
    """3D cantilever compliance minimization on an nx x ny x nz cell grid.

    The state solve rebuilds the variable-material multigrid per design
    (the fine P1 cell matrices are E_cell times one unit-modulus cell
    matrix) and runs MG-PCG in ``dtype`` on ``device`` (the CUDA device
    unless ``device="cpu"``)."""

    nx: int
    ny: int
    nz: int
    volfrac: float = 0.4
    penal: float = 3.0
    rmin: float = 1.5
    E0: float = 1.0
    E_min: float = 1e-6
    nu: float = 0.3
    dtype: object = torch.float32
    solve_tol: float = 1e-5
    device: object = None

    def __post_init__(self):
        from ..ops.structured_var import StructuredVarP2Elasticity

        self.device = config.resolve_device(self.device)
        n3 = (self.nx, self.ny, self.nz)
        V, T = generators.grid_tet(*n3)
        self.mesh = FEMMesh(V, T, degree=2)
        self.tets_per_cell = self.mesh.num_elements // (
            self.nx * self.ny * self.nz)
        X = self.mesh.node_positions
        # cantilever: clamp the x = 0 face, unit downward (-y) load on the
        # free end's lower edge (x = max, z = 0)
        self.fixed = np.zeros((self.mesh.num_nodes, 3), bool)
        self.fixed[X[:, 0] < 1e-9] = True
        load = np.zeros((self.mesh.num_nodes, 3))
        tip = (X[:, 0] > X[:, 0].max() - 1e-9) & (X[:, 2] < 1e-9)
        load[tip, 1] = -1.0 / max(tip.sum(), 1)
        self.load = torch.as_tensor(load, dtype=self.dtype,
                                    device=self.device)
        self.kern = _conic_kernel(self.rmin).to(self.device)
        self._Kc_unit = None
        # unit-modulus structured operator: the SIMP gradient needs
        # per-cell strain energies at E = 1 (dK/drho is linear in them),
        # evaluated through the strain products with per-CELL memory
        E = self.mesh.num_elements
        D_unit = et.isotropic(3, torch.ones(E, dtype=torch.float64),
                              torch.full((E,), self.nu, dtype=torch.float64))
        self._unit_op = StructuredVarP2Elasticity.build(
            self.mesh, D_unit, dtype=self.dtype, device=self.device)

    # -- densities -> physical field ------------------------------------
    def filtered(self, rho):
        w = _filter_conv(torch.ones_like(rho), self.kern)
        return _filter_conv(rho, self.kern) / w

    def filter_adjoint(self, g):
        w = _filter_conv(torch.ones_like(g), self.kern)
        return _filter_conv(g / w, self.kern)

    def modulus(self, rho_f):
        return self.E_min + rho_f ** self.penal * (self.E0 - self.E_min)

    def _unit_cell_matrix(self):
        """[24, 24] P1 cell stiffness of ONE grid cell at E = 1 (all cells
        share geometry on a uniform Kuhn grid, so the SIMP hierarchy's fine
        cell matrices are E_cell times this), host float64."""
        if self._Kc_unit is None:
            from ..ops.structured import validate_kuhn_grid
            from ..ops.structured_mg import _p1_cell_matrices_var

            _, h3 = validate_kuhn_grid(self.mesh)
            V1, T1 = generators.grid_tet(1, 1, 1, hi=tuple(h3))
            m1 = FEMMesh(V1, T1, degree=2)
            D1 = et.isotropic(3, torch.ones(6, dtype=torch.float64),
                              torch.full((6,), self.nu, dtype=torch.float64))
            self._Kc_unit = np.asarray(
                _p1_cell_matrices_var(m1, D1), np.float64)[0, 0, 0]
        return self._Kc_unit

    def _mg_for(self, rho_f):
        from ..ops.structured_mg import VarStructuredMG

        E_cell = self.modulus(rho_f).reshape(-1)
        E_elem = torch.repeat_interleave(E_cell, self.tets_per_cell)
        D = et.isotropic(3, E_elem, torch.full(E_elem.shape, self.nu,
                                               dtype=torch.float64,
                                               device=E_elem.device))
        # uniform-grid shortcut: fine P1 cell matrices = E_cell * Kc_unit
        # (no per-iteration [E, 12, 12] assembly and host Galerkin einsum)
        Kc_fine = (E_cell.cpu().numpy().astype(np.float64)[:, None, None]
                   * self._unit_cell_matrix()).reshape(
            self.nx, self.ny, self.nz, 24, 24)
        return VarStructuredMG.build(self.mesh, D,
                                     fixed_mask=torch.as_tensor(self.fixed),
                                     dtype=self.dtype, Kc_fine=Kc_fine,
                                     device=self.device)

    def solve(self, rho, tol=None):
        """(u [N, 3], iters, rho_f, mg) for the densities ``rho`` (filtered
        here)."""
        rho_f = self.filtered(torch.as_tensor(rho, dtype=self.dtype,
                                              device=self.device))
        mg = self._mg_for(rho_f)
        u, res = mg.solve(self.load, tol=tol or self.solve_tol, maxiter=300)
        return u, int(res.iters), rho_f, mg

    # -- compliance + exact adjoint gradient -----------------------------
    def cell_energies(self, u, v=None):
        """[nx, ny, nz] per-cell bilinear strain energies at E = 1: the sum
        over the cell's tets and quadrature points of strain_u . D_unit
        strain_v (the same bilinear form as u_e^T Ke_unit v_e)."""
        op = self._unit_op
        nx, ny, nz = op.n3
        nc = nx * ny * nz
        fl = op.SDS.shape[-1]
        Q = op.B.shape[1]
        dt = op.SDS.dtype

        def strains(w):
            w27 = op._gather_cells(op.to_channels(
                torch.as_tensor(w, dtype=dt, device=op.device))).reshape(
                nc, 81)
            return (w27 @ op.Bc.t()).reshape(nc, 6, Q, fl)

        strain_u = strains(u)
        strain_v = strain_u if v is None else strains(v)
        stress = torch.einsum("xtab,xtqb->xtqa", op.SDS, strain_v) \
            * op.wv[None, :, :, None]
        w = torch.einsum("xtqa,xtqa->x", strain_u, stress)
        return w.reshape(nx, ny, nz)

    def compliance_and_grad(self, rho):
        """(c, dc/drho [nx, ny, nz], iters).  Compliance is self-adjoint:
        dc/dE_cell = -w_cell(u, u), no extra solve; the filter's chain rule
        is its (normalized) adjoint convolution."""
        u, iters, rho_f, _ = self.solve(rho)
        c = float(torch.vdot(self.load.reshape(-1),
                             u.to(self.dtype).reshape(-1)))
        w = self.cell_energies(u)
        dE = self.penal * rho_f ** (self.penal - 1.0) \
            * (self.E0 - self.E_min)
        dc = self.filter_adjoint(-(dE * w))
        return c, dc, iters

    # -- optimality criteria ----------------------------------------------
    def oc_update(self, rho, dc, move=0.2):
        """Classic OC bisection on the volume multiplier (filtered volume
        constraint; dv/drho through the filter adjoint of ones)."""
        dv = self.filter_adjoint(torch.ones_like(rho) / rho.numel())
        lo, hi = 1e-11, 1e11
        dcn = torch.clamp(dc, max=0.0)           # descent part only
        lower = torch.clamp(rho - move, min=0.0)
        upper = torch.clamp(rho + move, max=1.0)
        for _ in range(80):
            lam = 0.5 * (lo + hi)
            scale = torch.sqrt(-dcn / (lam * dv))
            cand = torch.minimum(torch.maximum(rho * scale, lower), upper)
            vol = float(self.filtered(cand).mean())
            if vol > self.volfrac:
                lo = lam
            else:
                hi = lam
        return cand

    def run(self, iters: int = 30, rho0=None, verbose: bool = False,
            callback=None):
        rho = torch.full((self.nx, self.ny, self.nz), self.volfrac,
                         dtype=self.dtype, device=self.device) \
            if rho0 is None else torch.as_tensor(rho0, dtype=self.dtype,
                                                 device=self.device)
        history = []
        for it in range(iters):
            c, dc, inner = self.compliance_and_grad(rho)
            rho = self.oc_update(rho, dc)
            vol = float(self.filtered(rho).mean())
            history.append(dict(it=it, compliance=c, volume=vol,
                                inner_iters=inner))
            if verbose:
                print(f"it {it:3d}  c={c:.6e}  vol={vol:.3f}  "
                      f"inner={inner}")
            if callback:
                callback(it, rho, history[-1])
        return rho, history


class _DisplacementOfDensity(torch.autograd.Function):
    """u(rho) = topopt.solve(rho); backward: the (self-adjoint) adjoint
    system solved with the same hierarchy, contracted as -lambda^T dK/drho
    u through the per-cell unit energies, then the filter's adjoint."""

    @staticmethod
    def forward(ctx, rho, topopt):
        u, _, rho_f, mg = topopt.solve(rho)
        ctx.topopt, ctx.mg, ctx.rho_dtype = topopt, mg, rho.dtype
        ctx.save_for_backward(rho_f, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        t = ctx.topopt
        rho_f, u = ctx.saved_tensors
        lam_u, _ = ctx.mg.solve(gbar.to(t.dtype), tol=t.solve_tol,
                                maxiter=300)
        w = t.cell_energies(lam_u, u)
        dE = t.penal * rho_f ** (t.penal - 1.0) * (t.E0 - t.E_min)
        return t.filter_adjoint(-(dE * w)).to(ctx.rho_dtype), None


def differentiable_displacement(topopt: ComplianceTopOpt):
    """u(rho) as a differentiable function of the densities, by the
    implicit-function theorem: the backward solves the (self-adjoint)
    adjoint system with the same multigrid hierarchy and contracts
    -lambda^T dK/drho u through the per-cell unit energies.  Each call runs
    the multigrid solver; an objective J(u) then gets dJ/drho by autograd
    through J(differentiable_displacement(topopt)(rho))."""

    def u_of_rho(rho):
        rho = torch.as_tensor(rho, device=topopt.device)
        return _DisplacementOfDensity.apply(rho, topopt).to(rho.dtype)

    return u_of_rho
