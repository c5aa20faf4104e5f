"""Static linear elasticity simulator.

Counterpart of ``meshfem_tpu/physics/elasticity.py::ElasticitySimulator``
for the routed P2 solve and periodic homogenization:

* element stiffness ``Ke`` in float64: one matmul for a constant material,
  a batched einsum for a per-element ``MaterialField``
  (``ops/element_matrices.element_elasticity``);
* ``apply_K`` / ``K_diagonal`` through the float64 EBE operator, whose
  scatter runs on kernel B;
* ``routed_kernel``: the float32 routed operator on kernels A-D, dense or
  (``MESHFEM_FACTORED`` set, isotropic material) factored, read exactly as
  the reference reads it (``elasticity.py:142-149``); the dense operator's
  float32 ``Ke`` of a constant material is assembled in float32 by kernel E
  (``kernels.element_stiffness``), as ``bench.py:266,320`` feeds
  ``RoutedEBE.build``;
* ``solve``: ``operator="routed"`` runs preconditioned float32 CG inside
  float64 iterative refinement (``_solve_routed`` :660);
  ``operator="ebe"`` the float64 CG (:521-574); ``precond`` is 'jacobi',
  'block' or 'chebyshev' (``solvers/precond.py``);
* the homogenization load ``constant_strain_load``, the strain, stress and
  von Mises fields and the strain energy.

Dof layout: ``u[dof, component]``.  ``dof_map [N] -> Nd`` identifies nodes
into dofs (periodic cells, ``mesh/periodic.py``); it is the identity by
default.  The solve runs in dof space and ``solve`` returns the nodal field
``u[dof_map]``.  Tensors live on ``device`` (the CUDA device unless the
caller asks for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem.flattening import flat_to_sym
from ..kernels import element_stiffness
from ..mesh.femmesh import FEMMesh
from ..ops import element_matrices as em
from ..solvers import cg as cg_mod
from ..solvers import precond as pc
from ..solvers import refine as refine_mod
from ..sparse.ebe import EBEKernel
from ..sparse.routed_ebe import RoutedEBE
from .materials import Material, MaterialField


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

    ``material``: a ``Material``, a ``MaterialField`` or a raw ``D``
    ([fl, fl] or per element [E, fl, fl]).  ``dof_map`` ([N] node -> dof)
    identifies nodes (periodic cells).  ``Ke`` (optional, [E, n*d, n*d])
    shares an element stiffness computed elsewhere
    (``interop.simulator_from_arrays``) instead of assembling."""

    def __init__(self, mesh: FEMMesh, material, device=None, Ke=None,
                 dof_map=None):
        if mesh.dim != mesh.K:
            raise ValueError("elasticity requires embedding dim == K")
        self.device = config.resolve_device(device)
        self.mesh = mesh
        self.dim = mesh.dim
        D = material.D if isinstance(material, (Material, MaterialField)) \
            else material
        self.D = torch.as_tensor(D, dtype=config.REAL, device=self.device)
        self.geom = mesh.geometry(self.device)
        if bool((self.geom.volume <= 0).any()):
            raise ValueError("mesh has non-positive element volumes "
                             "(reference rejects these too)")
        self._Ke_shared = Ke is not None
        if Ke is None:
            self.Ke = em.element_elasticity(self.geom.grad_lambda,
                                            self.geom.volume, self.D,
                                            mesh.degree)
        else:
            self.Ke = torch.as_tensor(Ke, dtype=config.REAL,
                                      device=self.device)
        if dof_map is None:
            self.dof_map = np.arange(mesh.num_nodes)
            self.num_dofs = mesh.num_nodes
        else:
            self.dof_map = np.asarray(dof_map, dtype=np.int64)
            self.num_dofs = int(self.dof_map.max()) + 1
        self._dof_map_t = torch.as_tensor(self.dof_map, device=self.device)
        self._elem_nodes_t = torch.as_tensor(mesh.elem_nodes,
                                             device=self.device)
        self.elem_dofs = self._dof_map_t[self._elem_nodes_t]
        self._kernel = EBEKernel.build(self.Ke, self.elem_dofs,
                                       self.num_dofs, self.dim)
        self._routed = None
        d = self.dim
        self.dirichlet_mask = np.zeros((self.num_dofs, d), dtype=bool)
        self.dirichlet_values = np.zeros((self.num_dofs, d))
        self.neumann_load = torch.zeros((self.num_dofs, d), dtype=config.REAL,
                                        device=self.device)
        self.no_rigid_motion = False    # rigid-mode projection: not ported

    # ------------------------------------------------------------------
    # Operator
    # ------------------------------------------------------------------
    def apply_K(self, u):
        """A @ u (float64) for u [Nd, dim] (or [Nd, dim, m] multi-RHS)."""
        return self._kernel(u)

    def K_diagonal(self):
        return self._kernel.diagonal()

    def routed_kernel(self, block_rhs: int | None = None):
        """The float32 routed operator (internally RCB / first-touch
        reordered), built lazily.  With ``MESHFEM_FACTORED`` set and a
        constant isotropic material it takes the factored contraction
        (kernel C, or D with ``MESHFEM_FACTORED_TQ=1``).  ``block_rhs``:
        the right-hand-side count recorded on the operator (``bm``).  The
        reference rebuilds its plan sets for a new count (:125-127); here
        ``apply_block`` takes any count through the same plans, so the
        cached operator is kept."""
        if self._routed is not None and block_rhs:
            self._routed.bm = int(block_rhs)
        if self._routed is None:
            # dof coordinates: position of (a) node carrying each dof
            pos = np.zeros((self.num_dofs, self.mesh.node_positions.shape[1]))
            pos[self.dof_map] = self.mesh.node_positions
            factor = None
            if os.environ.get("MESHFEM_FACTORED"):
                lm = et.lame_parameters(self.D)
                if lm is not None:
                    factor = (self.geom.grad_lambda, self.geom.volume,
                              lm[0], lm[1], self.mesh.degree)
            self._routed = RoutedEBE.build(
                None if factor is not None else self._routed_Ke(),
                self.elem_dofs.cpu().numpy(), self.num_dofs, self.dim,
                coords=pos, factor=factor, device=self.device,
                block_rhs=block_rhs)
        return self._routed

    def _routed_Ke(self):
        """``Ke`` for the dense routed operator.  A constant material's is
        assembled in float32 by ``kernels.element_stiffness`` (kernel E on
        the card) from the float32 geometry and the fused matrix, the
        assembly ``bench.py:266`` hands to ``RoutedEBE.build``; a material
        field's, or a ``Ke`` shared from elsewhere, is the float64 one
        (cast by ``build``)."""
        if self.D.ndim != 2 or self._Ke_shared:
            return self.Ke
        f32 = config.SOLVE
        M = torch.as_tensor(
            em.fused_matrix_for(self.D, self.mesh.K, self.mesh.degree),
            dtype=f32, device=self.device)
        return element_stiffness(self.geom.grad_lambda.to(f32).contiguous(),
                                 self.geom.volume.to(f32).contiguous(), M)

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
                and self.D.ndim in (2, 3)                 # uniform / field
                and self.num_dofs == self.mesh.num_nodes  # no periodic ids
                and not self.no_rigid_motion
                and bool(self.dirichlet_mask.any())
                and self.mesh.num_elements >= 3000)

    # ------------------------------------------------------------------
    # Boundary conditions
    # ------------------------------------------------------------------
    def fix_nodes(self, nodes, values=0.0, components=None):
        """Programmatic Dirichlet (dof indices, which are the node indices
        under the identity dof map; per-dof values)."""
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
              chebyshev_degree: int = 6, operator: str = "auto"):
        """Returns (u [N, dim] float64 nodal displacements, CGResult).

        The solve runs in dof space; the result is expanded through the dof
        map (``u_dof[dof_map]``) and ``CGResult.x`` keeps the dof-space
        field.  ``precond``: 'jacobi' | 'block' (exact d x d node blocks) |
        'chebyshev' (k-step polynomial in the block-Jacobi-preconditioned
        operator), ``solvers/precond.py``.

        ``operator``: 'routed' (float32 routed CG, inside float64
        refinement when ``tol < 1e-5``; ``CGResult.iters`` then counts all
        inner iterations and ``rounds`` the refinement rounds) or 'ebe'
        (float64 CG).  'auto' picks like the reference where it can:
        when the reference would try its structured multigrid (3D P2,
        identity dof map, Dirichlet conditions and >= 3000 elements) or on
        'structured' this raises NotImplementedError; otherwise it takes
        the routed operator on CUDA past ``MESHFEM_ROUTED_MIN_E`` elements
        and the EBE path else.  ``x0`` and the two-level and AMG
        preconditioners are not ported."""
        if operator == "structured" or (operator == "auto"
                                        and self._structured_eligible()):
            raise NotImplementedError(
                "the structured multigrid path (operator='structured', and "
                "'auto' on meshes it would take) is queued in ROADMAP.md "
                "(Queue 1, item 13); pass operator='routed' or 'ebe'")
        if precond in ("twolevel", "twolevel-mult"):
            raise NotImplementedError(
                "precond='twolevel*' (solvers/twolevel.py) is queued in "
                "ROADMAP.md (Queue 1, item 11)")
        if precond == "amg":
            raise NotImplementedError(
                "precond='amg' (solvers/amg.py) is queued in ROADMAP.md "
                "(Queue 1, item 14)")
        if precond not in ("jacobi", "block", "chebyshev"):
            raise ValueError(f"unknown precond {precond!r}")
        if x0 is not None or self.no_rigid_motion:
            raise NotImplementedError(
                "warm starts (x0) and the rigid-motion projection are "
                "queued in ROADMAP.md (Queue 1, item 7)")
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
            u_dof, res = self._solve_routed(b, fixed, vals, tol, maxiter,
                                            precond, chebyshev_degree)
            return u_dof[self._dof_map_t], res
        if precond == "jacobi":
            res = cg_mod.cg_operator(self._kernel, b, self.K_diagonal(),
                                     (~fixed).to(b.dtype), vals, tol=tol,
                                     maxiter=maxiter)
            return res.x[self._dof_map_t], res
        # block Jacobi / Chebyshev on the float64 EBE operator (:552-574)
        free = (~fixed).to(b.dtype)
        project = cg_mod.mask_projector(free)
        blocks = pc.node_block_diagonal(self.Ke, self.elem_dofs,
                                        self.num_dofs, self.dim)
        M_inv = pc.block_jacobi_apply(pc.block_jacobi_inv(blocks, free))
        if precond == "chebyshev":
            Ap = lambda v: project(self.apply_K(v))
            M0 = M_inv
            lmax = pc.estimate_lambda_max(
                Ap, lambda r: project(M0(r)), (self.num_dofs, self.dim),
                dtype=self.Ke.dtype, device=self.device)
            M_inv = pc.chebyshev_preconditioner(
                Ap, M0, lmax, degree=chebyshev_degree, project=project)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals))
        res = cg_mod.cg(self.apply_K, b - self.apply_K(u_d), M_inv=M_inv,
                        project=project, tol=tol, maxiter=maxiter)
        u_dof = res.x + u_d
        return u_dof[self._dof_map_t], cg_mod.CGResult(u_dof, res.iters,
                                                      res.resnorm)

    def _solve_routed(self, b, fixed, vals, tol, maxiter, precond="jacobi",
                      chebyshev_degree=6):
        """Routed float32 CG in the operator's internal ordering and plane
        layout [d, Nd], inside float64 refinement when ``tol`` is beyond
        float32 reach (``_solve_routed`` :660-803).  Returns the dof-space
        field and the CGResult."""
        rk = self.routed_kernel()
        f32 = config.SOLVE
        free = ~fixed

        def to_planes(v):                    # user [Nd, d] -> internal [d, Nd]
            return rk.permute_in(v).t().contiguous()

        def from_planes(v):                  # internal [d, Nd] -> user [Nd, d]
            return rk.permute_out(v.t())

        free_p = to_planes(free.to(f32))
        project = cg_mod.mask_projector(free_p)
        if precond == "jacobi":
            diag_p = rk.diagonal_planes()
            safe = torch.where(diag_p > 0, diag_p, torch.ones_like(diag_p))
            M_inv = lambda r: r / safe
        else:   # block Jacobi, permuted into the internal ordering
            blocks = pc.node_block_diagonal(self.Ke.to(f32), self.elem_dofs,
                                            self.num_dofs, self.dim)
            bj = pc.block_jacobi_apply(pc.block_jacobi_inv(
                rk.permute_in(blocks), free_p.t()))
            M_inv = lambda r: bj(r.t()).t()
            if precond == "chebyshev":
                Ap = lambda v: project(rk.apply_planes(v))
                M0 = M_inv
                lmax = pc.estimate_lambda_max(
                    Ap, lambda r: project(M0(r)),
                    (self.dim, self.num_dofs), dtype=f32,
                    device=self.device)
                M_inv = pc.chebyshev_preconditioner(
                    Ap, M0, lmax, degree=chebyshev_degree, project=project)
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
        """l[(i,c)] = int strain(phi_i e_c) : C : e0 dV (float64 [Nd, d]);
        pass -e0 for the cell-problem right-hand side.  A per-element
        material gives a per-element stress (reference :808-826)."""
        e0 = torch.as_tensor(e0_flat, dtype=self.Ke.dtype, device=self.device)
        sigma0 = et.double_contract(self.D, e0)
        g = self.geom
        S = torch.as_tensor(em.shape_grad_table(self.mesh.K,
                                                self.mesh.degree),
                            dtype=self.Ke.dtype, device=self.device)
        int_grad = torch.einsum("kn,ekd->end", S, g.grad_lambda) \
            * g.volume[:, None, None]
        sig_full = flat_to_sym(sigma0, self.dim)
        if sig_full.dim() == 2:
            fe = torch.einsum("end,cd->enc", int_grad, sig_full)
        else:
            fe = torch.einsum("end,ecd->enc", int_grad, sig_full)
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
        ue = u[self._elem_nodes_t]
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
        """1/2 u^T K u for a nodal field u [N, dim]."""
        ud = torch.zeros((self.num_dofs, self.dim), dtype=self.Ke.dtype,
                         device=self.device)
        ud[self._dof_map_t] = u.to(ud.dtype)       # node field -> dof field
        return 0.5 * torch.vdot(ud.reshape(-1), self.apply_K(ud).reshape(-1))
