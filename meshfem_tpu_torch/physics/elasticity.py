"""Static linear elasticity simulator.

Counterpart of ``meshfem_tpu/physics/elasticity.py::ElasticitySimulator``
for the routed P2 solve:

* element stiffness ``Ke`` in float64 as one matmul
  (``ops/element_matrices.element_elasticity``);
* ``apply_K`` / ``K_diagonal`` through the float64 EBE operator, whose
  scatter runs on kernel B;
* ``routed_kernel``: the float32 routed operator on kernels A-C, dense or
  (``MESHFEM_FACTORED`` set, isotropic material) factored, read exactly as
  the reference reads it (``elasticity.py:142-149``);
* ``solve``: ``operator="routed"`` runs Jacobi-preconditioned float32 CG
  inside float64 iterative refinement (``_solve_routed`` :660);
  ``operator="ebe"`` the float64 Jacobi CG (:521-528);
* the strain, stress and von Mises fields and the strain energy.

Dof layout: ``u[node, component]``; the dof map is the identity (periodic
dof maps are not ported yet).  Tensors live on ``device`` (the CUDA device
unless the caller asks for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem.flattening import flat_to_sym
from ..mesh.femmesh import FEMMesh
from ..ops import element_matrices as em
from ..solvers import cg as cg_mod
from ..solvers import refine as refine_mod
from ..sparse.ebe import EBEKernel
from ..sparse.routed_ebe import RoutedEBE
from .materials import Material


def von_mises(stress_flat, dim: int):
    """Von Mises stress from flattened stress [..., fl] (``VonMises.hh``;
    2D uses the plane-stress formula)."""
    s = stress_flat
    if dim == 2:
        return torch.sqrt(torch.clamp(
            s[..., 0] ** 2 - s[..., 0] * s[..., 1] + s[..., 1] ** 2
            + 3.0 * s[..., 2] ** 2, min=0.0))
    sxx, syy, szz, syz, sxz, sxy = (s[..., i] for i in range(6))
    return torch.sqrt(torch.clamp(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * (sxy ** 2 + syz ** 2 + sxz ** 2), min=0.0))


class ElasticitySimulator:
    """Static linear elasticity on a tetrahedral FEMMesh.

    ``Ke`` (optional, [E, n*d, n*d]) shares an element stiffness computed
    elsewhere (``interop.simulator_from_arrays``) instead of assembling."""

    def __init__(self, mesh: FEMMesh, material, device=None, Ke=None):
        if mesh.dim != mesh.K:
            raise ValueError("elasticity requires embedding dim == K")
        self.device = config.resolve_device(device)
        self.mesh = mesh
        self.dim = mesh.dim
        D = material.D if isinstance(material, Material) else material
        self.D = torch.as_tensor(D, dtype=config.REAL, device=self.device)
        self.geom = mesh.geometry(self.device)
        if bool((self.geom.volume <= 0).any()):
            raise ValueError("mesh has non-positive element volumes "
                             "(reference rejects these too)")
        if Ke is None:
            self.Ke = em.element_elasticity(self.geom.grad_lambda,
                                            self.geom.volume, self.D,
                                            mesh.degree)
        else:
            self.Ke = torch.as_tensor(Ke, dtype=config.REAL,
                                      device=self.device)
        self.num_dofs = mesh.num_nodes
        self.elem_dofs = torch.as_tensor(mesh.elem_nodes, device=self.device)
        self._kernel = EBEKernel.build(self.Ke, self.elem_dofs,
                                       self.num_dofs, self.dim)
        self._routed = None
        d = self.dim
        self.dirichlet_mask = np.zeros((self.num_dofs, d), dtype=bool)
        self.dirichlet_values = np.zeros((self.num_dofs, d))
        self.neumann_load = torch.zeros((self.num_dofs, d), dtype=config.REAL,
                                        device=self.device)

    # ------------------------------------------------------------------
    # Operator
    # ------------------------------------------------------------------
    def apply_K(self, u):
        """A @ u (float64) for u [N, dim]."""
        return self._kernel(u)

    def K_diagonal(self):
        return self._kernel.diagonal()

    def routed_kernel(self, block_rhs: int | None = None):
        """The float32 routed operator (internally RCB / first-touch
        reordered), built lazily.  With ``MESHFEM_FACTORED`` set and an
        isotropic material it takes the factored contraction (kernel C).
        ``block_rhs`` (multi-RHS block plans) is not ported yet and
        raises."""
        if block_rhs:
            raise NotImplementedError(
                "multi-RHS block plans are queued in ROADMAP.md (Queue 1, "
                "item 8)")
        if self._routed is None:
            factor = None
            if os.environ.get("MESHFEM_FACTORED"):
                lm = et.lame_parameters(self.D)
                if lm is not None:
                    factor = (self.geom.grad_lambda, self.geom.volume,
                              lm[0], lm[1], self.mesh.degree)
            self._routed = RoutedEBE.build(
                None if factor is not None else self.Ke,
                self.mesh.elem_nodes, self.num_dofs, self.dim,
                coords=self.mesh.node_positions, factor=factor,
                device=self.device)
        return self._routed

    def _routed_auto(self) -> bool:
        """Routed operator by default on CUDA for meshes past
        ``MESHFEM_ROUTED_MIN_E`` elements (the reference gates on the TPU)."""
        if self.device.type != "cuda":
            return False
        return self.mesh.num_elements >= int(
            os.environ.get("MESHFEM_ROUTED_MIN_E", "16384"))

    def _structured_eligible(self) -> bool:
        """The reference's pre-filter for its structured multigrid path
        (``elasticity.py:185-193``)."""
        return (self.dim == 3 and self.mesh.degree == 2
                and bool(self.dirichlet_mask.any())
                and self.mesh.num_elements >= 3000)

    # ------------------------------------------------------------------
    # Boundary conditions
    # ------------------------------------------------------------------
    def fix_nodes(self, nodes, values=0.0, components=None):
        """Programmatic Dirichlet (node indices, per-node values)."""
        nodes = np.asarray(nodes)
        values = np.broadcast_to(np.asarray(values, dtype=np.float64),
                                 (len(nodes), self.dim))
        comps = np.arange(self.dim) if components is None \
            else np.asarray(components)
        for c in comps:
            self.dirichlet_mask[nodes, c] = True
            self.dirichlet_values[nodes, c] = values[:, c]

    # ------------------------------------------------------------------
    # Solve
    # ------------------------------------------------------------------
    def solve(self, extra_load=None, tol: float = 1e-12,
              maxiter: int = 50000, x0=None, precond: str = "jacobi",
              operator: str = "auto"):
        """Returns (u [N, dim] float64 nodal displacements, CGResult).

        ``operator``: 'routed' (float32 routed CG, inside float64
        refinement when ``tol < 1e-5``; ``CGResult.iters`` then counts all
        inner iterations and ``rounds`` the refinement rounds) or 'ebe'
        (float64 Jacobi CG).  'auto' picks like the reference where it can:
        when the reference would try its structured multigrid (3D P2 with
        Dirichlet conditions and >= 3000 elements) or on 'structured' this
        raises NotImplementedError; otherwise it takes the routed operator
        on CUDA past ``MESHFEM_ROUTED_MIN_E`` elements and the EBE path
        else.  Only ``precond='jacobi'`` and no ``x0`` are ported."""
        if operator == "structured" or (operator == "auto"
                                        and self._structured_eligible()):
            raise NotImplementedError(
                "the structured multigrid path (operator='structured', and "
                "'auto' on meshes it would take) is queued in ROADMAP.md "
                "(Queue 1, item 13); pass operator='routed' or 'ebe'")
        if x0 is not None or precond != "jacobi":
            raise NotImplementedError(
                "this port solves with precond='jacobi' and no x0; the "
                "other preconditioners and x0 are queued in ROADMAP.md "
                "(Queue 1, items 6-7)")
        if operator == "auto":
            operator = "routed" if self._routed_auto() else "ebe"
        if operator not in ("routed", "ebe"):
            raise ValueError(f"unknown operator {operator!r}")
        b = self.neumann_load
        if extra_load is not None:
            b = b + torch.as_tensor(extra_load, dtype=b.dtype,
                                    device=self.device)
        fixed = torch.as_tensor(self.dirichlet_mask, device=self.device)
        vals = torch.as_tensor(self.dirichlet_values, dtype=b.dtype,
                               device=self.device)
        if operator == "routed":
            return self._solve_routed(b, fixed, vals, tol, maxiter)
        res = cg_mod.cg_operator(self._kernel, b, self.K_diagonal(),
                                 (~fixed).to(b.dtype), vals, tol=tol,
                                 maxiter=maxiter)
        return res.x, res

    def _solve_routed(self, b, fixed, vals, tol, maxiter):
        """Routed float32 CG in the operator's internal ordering and plane
        layout [d, N], inside float64 refinement when ``tol`` is beyond
        float32 reach (``_solve_routed`` :660-803, jacobi branch)."""
        rk = self.routed_kernel()
        f32 = config.SOLVE
        free = ~fixed

        def to_planes(v):                    # user [N, d] -> internal [d, N]
            return rk.permute_in(v).t().contiguous()

        def from_planes(v):                  # internal [d, N] -> user [N, d]
            return rk.permute_out(v.t())

        free_p = to_planes(free.to(f32))
        diag_p = rk.diagonal_planes()
        safe = torch.where(diag_p > 0, diag_p, torch.ones_like(diag_p))
        M_inv = lambda r: r / safe
        project = cg_mod.mask_projector(free_p)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals))

        if b.dtype != torch.float64 or tol >= 1e-5:
            ud_p = to_planes(u_d.to(f32))
            rhs = project(to_planes(b.to(f32)) - rk.apply_planes(ud_p))
            res = cg_mod.cg(rk.apply_planes, rhs, M_inv=M_inv,
                            project=project, tol=tol, maxiter=maxiter)
            x = from_planes(res.x + ud_p).to(b.dtype)
            return x, cg_mod.CGResult(x, res.iters, res.resnorm)

        free64 = free.to(torch.float64)
        apply_hi = lambda x: self.apply_K(x) * free64
        rhs64 = (b.to(torch.float64) - self.apply_K(u_d.to(torch.float64))) \
            * free64

        def solve_lo(r32):
            res = cg_mod.cg(rk.apply_planes, project(to_planes(r32)),
                            M_inv=M_inv, project=project, tol=1e-4,
                            maxiter=maxiter)
            return from_planes(res.x), res.iters

        ref = refine_mod.refine(apply_hi, solve_lo, rhs64, tol=tol)
        u = ref.x + u_d.to(torch.float64)
        return u, cg_mod.CGResult(u, ref.inner_iters, ref.resnorm,
                                  ref.rounds)

    # ------------------------------------------------------------------
    # Loads and fields (LinearElasticity.hh:100-162, 512-552)
    # ------------------------------------------------------------------
    def constant_strain_load(self, e0_flat):
        """l[(i,c)] = int strain(phi_i e_c) : C : e0 dV (float64 [N, d])."""
        e0 = torch.as_tensor(e0_flat, dtype=self.Ke.dtype, device=self.device)
        sigma0 = et.double_contract(self.D, e0)
        g = self.geom
        S = torch.as_tensor(em.shape_grad_table(self.mesh.K,
                                                self.mesh.degree),
                            dtype=self.Ke.dtype, device=self.device)
        int_grad = torch.einsum("kn,ekd->end", S, g.grad_lambda) \
            * g.volume[:, None, None]
        fe = torch.einsum("end,cd->enc", int_grad,
                          flat_to_sym(sigma0, self.dim))
        E, n = fe.shape[0], fe.shape[1]
        return self._kernel.plan(fe.reshape(E * n, self.dim))

    def strain_at(self, u, points=None):
        """[E, Q, fl] strains of nodal displacement u [N, dim] at barycentric
        points (default: element vertices for P2, the centroid for P1)."""
        mesh = self.mesh
        if points is None:
            points = np.eye(mesh.K + 1) if mesh.degree == 2 else \
                np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
        B = em.element_strain_matrix(self.geom.grad_lambda, mesh.degree,
                                     np.atleast_2d(points))
        ue = u[self.elem_dofs]
        return torch.einsum("eqanc,enc->eqa", B, ue)

    def average_strain_field(self, u):
        """[E, fl] element-average strains (the centroid value)."""
        centroid = np.full((1, self.mesh.K + 1), 1.0 / (self.mesh.K + 1))
        return self.strain_at(u, centroid)[:, 0, :]

    def average_stress_field(self, u):
        return et.double_contract(self.D, self.average_strain_field(u))

    def von_mises_field(self, u):
        return von_mises(self.average_stress_field(u), self.dim)

    def average_strain(self, u):
        """Volume-averaged strain [fl]."""
        vol = self.geom.volume
        return torch.einsum("e,ea->a", vol, self.average_strain_field(u)) \
            / vol.sum()

    def average_stress(self, u):
        vol = self.geom.volume
        return torch.einsum("e,ea->a", vol, self.average_stress_field(u)) \
            / vol.sum()

    def strain_energy(self, u):
        """1/2 u^T K u."""
        return 0.5 * torch.vdot(u.reshape(-1), self.apply_K(u).reshape(-1))
