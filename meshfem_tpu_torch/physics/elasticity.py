"""Static linear elasticity simulator.

Counterpart of ``meshfem_tpu/physics/elasticity.py::ElasticitySimulator``:

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
* boundary conditions: ``apply_boundary_conditions`` (``parse_bc``'s
  regions: Dirichlet, force, traction, pressure, point forces, targets),
  ``fix_nodes``, the surface-force report, the posedness analysis and the
  rigid modes (:239-430);
* ``solve``: ``operator="structured"`` (and ``"auto"`` on Kuhn grids, the
  reference's dispatch :475-515) runs the geometric multigrid
  (``ops/structured_mg.py``, ``_solve_structured`` :195-237);
  ``operator="routed"`` runs preconditioned float32 CG inside float64
  iterative refinement (``_solve_routed`` :660); ``operator="ebe"`` the
  float64 CG (:521-574), or on CUDA at tight tolerances float32 EBE CG
  inside float64 refinement (``_solve_ebe_refined`` :576-658, where the
  reference gates on the TPU).  Every branch but the structured one takes
  the rigid-mode projection (``no_rigid_motion``) and a warm start
  (``x0``); ``precond`` is 'jacobi', 'block' or 'chebyshev'
  (``solvers/precond.py``), or 'twolevel' / 'twolevel-mult' (the P1-coarse
  two-level preconditioner, ``solvers/twolevel.py``, cached by
  ``_twolevel_for`` :165-183) on the float64 EBE and the routed branches;
* the homogenization load ``constant_strain_load``, the strain, stress and
  von Mises fields and the strain energy.

Dof layout: ``u[dof, component]``.  ``dof_map [N] -> Nd`` identifies nodes
into dofs (periodic cells, ``mesh/periodic.py``); it is the identity by
default.  The solve runs in dof space and ``solve`` returns the nodal field
``u[dof_map]``.  Tensors live on ``device`` (the CUDA device unless the
caller asks for the CPU); boundary-condition matching and the loads it
builds are numpy on the host, as in the reference.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem import shape_functions as sf
from ..fem.flattening import flat_to_sym
from ..kernels import element_stiffness
from ..mesh.femmesh import FEMMesh
from ..ops import element_matrices as em
from ..ops.structured import validate_kuhn_grid
from ..ops.structured_mg import StructuredMG, VarStructuredMG
from ..solvers import cg as cg_mod
from ..solvers import precond as pc
from ..solvers import refine as refine_mod
from ..sparse import assembly
from ..sparse.ebe import EBEKernel
from ..sparse.routed_ebe import RoutedEBE
from . import boundary_conditions as bc_mod
from .materials import Material, MaterialField


def _compose(projectors):
    """One projector applying ``projectors`` in turn."""
    def project(v):
        for p in projectors:
            v = p(v)
        return v
    return project


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
        self._kernel32 = None           # float32 EBE, _solve_ebe_refined
        self._routed = None
        self._mg = None                 # (Dirichlet mask bytes, multigrid,
        #                                  build seconds on the host clock)
        self._twolevel = {}             # (precond, mask, ordered) -> TwoLevel
        d = self.dim
        self.dirichlet_mask = np.zeros((self.num_dofs, d), dtype=bool)
        self.dirichlet_values = np.zeros((self.num_dofs, d))
        self.neumann_load = torch.zeros((self.num_dofs, d), dtype=config.REAL,
                                        device=self.device)
        self.no_rigid_motion = False
        self._region_nodes: list = []   # dofs of each Dirichlet region

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
        the card) from the float32 geometry and ``D``, the assembly
        ``bench.py:266`` hands to ``RoutedEBE.build``; a material field's,
        or a ``Ke`` shared from elsewhere, is the float64 one (cast by
        ``build``)."""
        if self.D.ndim != 2 or self._Ke_shared:
            return self.Ke
        f32 = config.SOLVE
        return element_stiffness(self.geom.grad_lambda.to(f32).contiguous(),
                                 self.geom.volume.to(f32).contiguous(),
                                 self.D, self.mesh.degree)

    def _routed_auto(self) -> bool:
        """Routed operator by default on CUDA for meshes past
        ``MESHFEM_ROUTED_MIN_E`` elements (the reference gates on the TPU)."""
        if self.device.type != "cuda":
            return False
        return self.mesh.num_elements >= int(
            os.environ.get("MESHFEM_ROUTED_MIN_E", "16384"))

    def _twolevel_for(self, precond, free, node_order=None, project=None,
                      apply_A=None):
        """Cached TwoLevel build (host Galerkin product and SuperLU
        factorization once per (mode, Dirichlet mask, ordering); the
        projector and operator closures do not depend on the load).  At
        most 4 are kept."""
        from ..solvers.twolevel import TwoLevel

        free_np = torch.as_tensor(free).cpu().numpy()
        key = (precond, free_np.tobytes(), node_order is not None)
        tl = self._twolevel.get(key)
        if tl is None:
            tl = TwoLevel.from_simulator(
                self, mode=("multiplicative" if precond.endswith("mult")
                            else "additive"),
                free_mask=free_np, node_order=node_order, project=project,
                apply_A=apply_A)
            if len(self._twolevel) >= 4:
                self._twolevel.pop(next(iter(self._twolevel)))
            self._twolevel[key] = tl
        return tl

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
    # Boundary conditions (reference applyBoundaryConditions,
    # LinearElasticity.hh:881-1027)
    # ------------------------------------------------------------------
    def apply_boundary_conditions(self, conds: bc_mod.BoundaryConditions):
        """Apply parsed boundary conditions (``parse_bc``): Dirichlet
        regions set ``dirichlet_mask`` / ``dirichlet_values`` (conflicts
        raise), Neumann regions and point forces add to ``neumann_load``
        (summed on the host with ``np.add.at``), targets are matched and
        skipped, and ``no_rigid_motion`` switches the rigid-mode
        projection on."""
        mesh = self.mesh
        env = bc_mod.expression_env(mesh)
        self.no_rigid_motion |= conds.no_rigid_motion
        load = np.zeros((self.num_dofs, self.dim))
        for region in conds.regions:
            if region.type in ("dirichlet", "target"):
                if region.kind == "elements":
                    # DirichletElementsCondition: every node (edge nodes
                    # too) of the matched boundary elements
                    belems = bc_mod.match_boundary_elements(mesh, region)
                    nodes = np.unique(mesh.bdry_elem_nodes[belems])
                else:
                    nodes = bc_mod.match_boundary_nodes(mesh, region)
                if len(nodes) == 0:
                    raise ValueError(f"BC region matched no nodes: {region}")
                if region.type == "target":
                    continue            # targets are objectives
                if region.kind == "nodes":
                    vals = np.asarray(region.indexed_values)
                else:
                    vals = region.eval_value(mesh.node_positions[nodes], env)
                comps = region.component_mask.components(self.dim)
                dofs = self.dof_map[nodes]
                for ci, c in enumerate(comps):
                    col = vals[:, c] if vals.shape[1] == self.dim \
                        else vals[:, ci]
                    conflict = (self.dirichlet_mask[dofs, c]
                                & (self.dirichlet_values[dofs, c] != col))
                    if conflict.any():
                        raise ValueError("conflicting Dirichlet constraints "
                                         "(reference detects these too)")
                    self.dirichlet_mask[dofs, c] = True
                    self.dirichlet_values[dofs, c] = col
                # the region's dofs, for surface-force reports
                self._region_nodes.append(np.asarray(dofs))
            elif region.type in ("traction", "force", "pressure"):
                belems = bc_mod.match_boundary_elements(mesh, region)
                if len(belems) == 0:
                    raise ValueError(f"BC region matched no boundary "
                                     f"elements: {region}")
                load += self._neumann_region_load(region, belems, env)
            elif region.type == "delta_force":
                if region.kind == "nodes":
                    nodes = np.asarray(region.indices)
                    if nodes.max(initial=-1) >= mesh.num_nodes:
                        raise ValueError("delta_force node index out of "
                                         "bounds")
                    vals = np.asarray(region.indexed_values)
                else:
                    nodes = bc_mod.match_boundary_nodes(mesh, region)
                    vals = region.eval_value(mesh.node_positions[nodes], env)
                np.add.at(load, self.dof_map[nodes], vals)
            else:
                raise ValueError(f"unsupported BC type {region.type!r}")
        self.neumann_load = self.neumann_load + torch.as_tensor(
            load, dtype=self.neumann_load.dtype, device=self.device)

    def _neumann_region_load(self, region, belems, env):
        """Consistent nodal load [Nd, d] (numpy) of a traction that is
        constant on each boundary element."""
        mesh = self.mesh
        centers = mesh.V[mesh.bdry_elems[belems]].mean(axis=1)
        bvol = self.geom.bdry_volume.cpu().numpy()[belems]
        if region.kind == "elements":
            # NeumannElementsCondition: per-element values; a force is
            # divided by the condition's total element area
            vals = np.asarray(region.indexed_values)
            if region.type == "pressure":
                n = self.geom.bdry_normal.cpu().numpy()[belems]
                traction = -vals[:, :1] * n
            elif region.type == "traction":
                traction = vals
            else:
                traction = vals / bvol.sum()
        elif region.type == "pressure":
            p = np.asarray(bc_mod.evaluate(region.value[0], centers, env))
            n = self.geom.bdry_normal.cpu().numpy()[belems]
            traction = -p[:, None] * n
        else:
            traction = region.eval_value(centers, env)[:, :self.dim]
            if region.type == "force":
                # total force over the region's area: a uniform traction
                # (BoundaryConditions.hh:179-181)
                traction = traction / bvol.sum()
        w = sf.integrated_shape_np(mesh.K - 1, mesh.degree)     # [nb]
        fe = traction[:, None, :] * (bvol[:, None] * w[None, :])[:, :, None]
        nodes = self.dof_map[mesh.bdry_elem_nodes[belems]]
        load = np.zeros((self.num_dofs, self.dim))
        np.add.at(load, nodes.reshape(-1), fe.reshape(-1, self.dim))
        return load

    def report_region_surface_forces(self, u):
        """[n_regions, dim] net force transmitted through each Dirichlet
        region: sums of (K u) over the region's dofs
        (``reportRegionSurfaceForces``, ``LinearElasticity.hh:1251-1270``);
        u is the nodal field."""
        ud = torch.zeros((self.num_dofs, self.dim), dtype=self.Ke.dtype,
                         device=self.device)
        ud[self._dof_map_t] = torch.as_tensor(u, dtype=ud.dtype,
                                              device=self.device)
        f = self.apply_K(ud).cpu().numpy()
        return np.stack([f[r].sum(axis=0) for r in self._region_nodes]) \
            if self._region_nodes else np.zeros((0, self.dim))

    def analyze_dirichlet_posedness(self):
        """(needs_translations [dim] bool, needs_rotations bool): which
        rigid modes the Dirichlet conditions leave free
        (``analyzeDirichletPosedness``, ``LinearElasticity.hh:1169-1191``).
        A rigid combination survives iff it vanishes on every constrained
        dof: the null space of the rigid basis restricted to the
        constrained rows, read from its [k, k] Gram matrix."""
        needs_translations = self.dirichlet_mask.sum(axis=0) == 0
        d = self.dim
        Z = self.rigid_modes()
        rows = self.dirichlet_mask.reshape(-1)
        if not rows.any():
            return needs_translations, True
        C = Z[rows]
        G = C.T @ C
        scale = max(float(np.trace(G)), 1e-300)
        w, V = np.linalg.eigh(G)
        kernel = V[:, w < 1e-12 * scale]               # surviving combos
        needs_rotations = bool(kernel.shape[1]
                               and np.abs(kernel[d:]).max() > 1e-8)
        return needs_translations, needs_rotations

    def fix_nodes(self, nodes, values=0.0, components=None):
        """Programmatic Dirichlet conditions on node indices (mapped to
        their dofs through ``dof_map``), values per node."""
        nodes = np.asarray(nodes)
        values = np.broadcast_to(np.asarray(values, dtype=np.float64),
                                 (len(nodes), self.dim))
        comps = np.arange(self.dim) if components is None \
            else np.asarray(components)
        dofs = self.dof_map[nodes]
        for c in comps:
            self.dirichlet_mask[dofs, c] = True
            self.dirichlet_values[dofs, c] = values[:, c]

    def clear_boundary_conditions(self):
        self.dirichlet_mask[:] = False
        self.dirichlet_values[:] = 0.0
        self.neumann_load = torch.zeros_like(self.neumann_load)
        self.no_rigid_motion = False
        self._region_nodes = []

    # ------------------------------------------------------------------
    # Rigid-motion projection (replaces the constraint rows R,
    # LinearElasticity.hh:1522-1593)
    # ------------------------------------------------------------------
    def rigid_modes(self, translations_only: bool = False) -> np.ndarray:
        """[Nd * dim, n_modes] float64 rigid translation / rotation basis
        (numpy), dof-major rows ``dof * dim + component``."""
        d = self.dim
        Nd = self.num_dofs
        # the position of (a) node carrying each dof
        pos = np.zeros((Nd, d))
        pos[self.dof_map] = self.mesh.node_positions[:, :d]
        modes = []
        for c in range(d):
            m = np.zeros((Nd, d))
            m[:, c] = 1.0
            modes.append(m.ravel())
        if not translations_only:
            if d == 2:
                m = np.zeros((Nd, d))
                m[:, 0], m[:, 1] = -pos[:, 1], pos[:, 0]
                modes.append(m.ravel())
            else:
                for axis in range(3):
                    m = np.zeros((Nd, d))
                    a, b = (axis + 1) % 3, (axis + 2) % 3
                    m[:, a] = -pos[:, b]
                    m[:, b] = pos[:, a]
                    modes.append(m.ravel())
        return np.stack(modes, axis=1)

    def _rigid_basis(self) -> torch.Tensor:
        return torch.as_tensor(self.rigid_modes(), device=self.device)

    def to_scipy(self):
        """The assembled float64 stiffness as a scipy CSR matrix (host),
        dof-major (``dof * dim + component``)."""
        return assembly.assemble_scipy(self.Ke.cpu().numpy(),
                                       self.elem_dofs.cpu().numpy(),
                                       self.num_dofs, d=self.dim)

    # ------------------------------------------------------------------
    # Solve
    # ------------------------------------------------------------------
    def solve(self, extra_load=None, tol: float = 1e-12,
              maxiter: int = 50000, x0=None, precond: str = "jacobi",
              chebyshev_degree: int = 6, operator: str = "auto"):
        """Returns (u [N, dim] float64 nodal displacements, CGResult).

        The solve runs in dof space; the result is expanded through the dof
        map (``u_dof[dof_map]``) and ``CGResult.x`` keeps the dof-space
        field.  ``x0`` ([Nd, dim], dof space) warm-starts the CG, or the
        float64 refinement on the routed path.  ``precond``: 'jacobi' |
        'block' (exact d x d node blocks) | 'chebyshev' (k-step polynomial
        in the block-Jacobi-preconditioned operator),
        ``solvers/precond.py`` | 'twolevel' / 'twolevel-mult' (P1-coarse
        two-level, additive or multiplicative, ``solvers/twolevel.py``;
        its host Galerkin product and SuperLU factorization are cached
        per Dirichlet mask).  With ``no_rigid_motion`` set the solve
        runs on the complement of the rigid modes (``nullspace_projector``).

        ``operator``: 'structured' (geometric multigrid on a Kuhn grid,
        ``_solve_structured``), 'routed' (float32 routed CG, inside float64
        refinement when ``tol < 1e-5``) or 'ebe'.  'auto' picks as the
        reference does (:475-515): on a mesh that passes the structured
        pre-filter (3D P2, constant or per-element material, identity dof
        map, Dirichlet conditions, no rigid-mode projection, >= 3000
        elements), with no ``x0``, and passes the Kuhn-grid validation,
        the structured multigrid, whatever ``precond`` says; otherwise,
        with no ``x0``, the routed operator on CUDA past
        ``MESHFEM_ROUTED_MIN_E`` elements, and the EBE path else.  Only the
        validation may send an 'auto' solve elsewhere: a fault inside the
        multigrid surfaces.  'structured' raises ValueError on a mesh that
        fails either check or with ``x0``.

        On CUDA, an 'auto' or 'ebe' solve with no ``x0``, a float64 load,
        ``tol < 1e-5`` and a jacobi, block or chebyshev ``precond`` takes
        ``_solve_ebe_refined``: float32 EBE CG
        inside float64 refinement, where the reference takes it on the TPU
        (:510-515); elsewhere 'ebe' is the float64 CG.  Refinement stops
        with a RuntimeWarning when the float32 floor (kappa eps32) lies
        above ``tol``: check ``CGResult.resnorm`` on ill-conditioned
        meshes.  On refined paths ``maxiter`` bounds each inner solve,
        ``CGResult.iters`` counts all inner iterations and ``rounds`` the
        refinement rounds.  The AMG preconditioner is not ported."""
        b = self.neumann_load
        if extra_load is not None:
            b = b + torch.as_tensor(extra_load, dtype=b.dtype,
                                    device=self.device)
        if x0 is not None:
            x0 = torch.as_tensor(x0, dtype=b.dtype, device=self.device)
        fixed = torch.as_tensor(self.dirichlet_mask, device=self.device)
        vals = torch.as_tensor(self.dirichlet_values, dtype=b.dtype,
                               device=self.device)
        if operator in ("structured", "auto"):
            if x0 is not None:
                if operator == "structured":
                    raise ValueError(
                        "operator='structured' does not support x0 (the "
                        "MG-PCG solve starts from zero); drop x0 or use "
                        "operator='routed'/'ebe'")
            elif self._structured_eligible():
                # only the Kuhn-grid validation may redirect an auto solve:
                # a defect inside the MG stack must surface, not reroute
                try:
                    validate_kuhn_grid(self.mesh)
                    is_grid = True
                except ValueError:
                    if operator == "structured":
                        raise
                    is_grid = False
                if is_grid:
                    return self._solve_structured(b, fixed, vals, tol,
                                                  maxiter)
            elif operator == "structured":
                raise ValueError(
                    "structured solve requires a 3D P2 mesh with uniform "
                    "material, identity dof map, some Dirichlet "
                    "constraint and no rigid-mode projection")
        if precond == "amg":
            raise NotImplementedError(
                "precond='amg' (solvers/amg.py) is queued in ROADMAP.md "
                "(Queue 1, item 14)")
        if precond not in ("jacobi", "block", "chebyshev", "twolevel",
                           "twolevel-mult"):
            raise ValueError(f"unknown precond {precond!r}")
        if operator not in ("auto", "routed", "ebe"):
            raise ValueError(f"unknown operator {operator!r}")
        if operator == "routed" or (operator == "auto" and x0 is None
                                    and self._routed_auto()):
            u_dof, res = self._solve_routed(b, fixed, vals, tol, maxiter,
                                            precond, chebyshev_degree, x0)
            return u_dof[self._dof_map_t], res
        if (x0 is None and b.dtype == torch.float64 and tol < 1e-5
                and self.device.type == "cuda"
                and precond in ("jacobi", "block", "chebyshev")):
            return self._solve_ebe_refined(b, fixed, vals, tol, maxiter,
                                           precond, chebyshev_degree)
        return self._solve_ebe(b, fixed, vals, tol, maxiter, precond,
                               chebyshev_degree, x0)

    def _solve_ebe(self, b, fixed, vals, tol, maxiter, precond,
                   chebyshev_degree, x0):
        """Float64 EBE CG (reference :521-574): the Jacobi fast path
        (``cg_operator``) when there is nothing to project but the mask and
        no ``x0``; else the mask and rigid-mode projectors, Jacobi, block,
        Chebyshev or two-level preconditioning and ``x0`` handed to
        ``cg``."""
        free = ~fixed
        if not self.no_rigid_motion and x0 is None and precond == "jacobi":
            res = cg_mod.cg_operator(self._kernel, b, self.K_diagonal(),
                                     free.to(b.dtype), vals, tol=tol,
                                     maxiter=maxiter)
            return res.x[self._dof_map_t], res
        projs = [cg_mod.mask_projector(free)]
        if self.no_rigid_motion:
            projs.append(cg_mod.nullspace_projector(self._rigid_basis()))
        project = _compose(projs)
        if precond == "jacobi":
            diag = self.K_diagonal()
            safe = torch.where(diag > 0, diag, torch.ones_like(diag))
            M_inv = lambda r: r / safe
        elif precond in ("twolevel", "twolevel-mult"):
            M_inv = self._twolevel_for(precond, free, project=project).M_inv
        else:
            M_inv = self._block_precond(self.Ke, self.apply_K, free, project,
                                        precond, chebyshev_degree)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals))
        res = cg_mod.cg(self.apply_K, b - self.apply_K(u_d), x0,
                        M_inv=M_inv, project=project, tol=tol,
                        maxiter=maxiter)
        u_dof = res.x + u_d
        return u_dof[self._dof_map_t], cg_mod.CGResult(u_dof, res.iters,
                                                      res.resnorm)

    def _block_precond(self, Ke, apply, free, project, precond,
                       chebyshev_degree):
        """Block Jacobi on the node blocks of ``Ke`` (in ``Ke``'s dtype),
        or Chebyshev in the block-Jacobi-preconditioned ``apply``, for
        vectors [Nd, d] in the user's dof order."""
        blocks = pc.node_block_diagonal(Ke, self.elem_dofs, self.num_dofs,
                                        self.dim)
        M_inv = pc.block_jacobi_apply(
            pc.block_jacobi_inv(blocks, free.to(Ke.dtype)))
        if precond == "chebyshev":
            Ap = lambda v: project(apply(v))
            M0 = M_inv
            lmax = pc.estimate_lambda_max(
                Ap, lambda r: project(M0(r)), (self.num_dofs, self.dim),
                dtype=Ke.dtype, device=self.device)
            M_inv = pc.chebyshev_preconditioner(
                Ap, M0, lmax, degree=chebyshev_degree, project=project)
        return M_inv

    def _solve_ebe_refined(self, b, fixed, vals, tol, maxiter, precond,
                           chebyshev_degree=6):
        """Tight-tolerance EBE solve on CUDA (reference :576-658, taken
        there on the TPU): float32 EBE CG (``Ke`` cast to float32, the
        float64 operator's scatter plan, kernel B in float) inside float64
        refinement whose residuals run through the float64 operator
        (kernel B in double).  The inner solve carries the mask and, with
        ``no_rigid_motion``, the rigid-mode projector in float32; the
        float64 residual the same projectors in float64."""
        f32 = config.SOLVE
        free = ~fixed
        if self._kernel32 is None:
            k = self._kernel
            self._kernel32 = EBEKernel(self.Ke.to(f32), k.elem_dofs,
                                       k.num_dofs, k.vector_dim, k.plan)
        k32 = self._kernel32
        projs = [cg_mod.mask_projector(free)]
        proj_rm_hi = None
        if self.no_rigid_motion:
            Z = self._rigid_basis()
            proj_rm_hi = cg_mod.nullspace_projector(Z)
            # the port's choice: the float32 basis is orthonormalized in
            # float64 and then cast (the reference orthonormalizes the
            # float32 modes in float32, elasticity.py:605-607)
            projs.append(cg_mod.nullspace_projector(Z, dtype=f32))
        project = _compose(projs)
        if precond == "jacobi":
            diag = k32.diagonal()
            safe = torch.where(diag > 0, diag, torch.ones_like(diag))
            M_inv = lambda r: r / safe
        else:
            M_inv = self._block_precond(k32.Ke, k32, free, project, precond,
                                        chebyshev_degree)
        proj_hi = self._proj_hi(free, proj_rm_hi)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals)).to(
            torch.float64)
        apply_hi = lambda x: proj_hi(self.apply_K(x))
        rhs64 = proj_hi(b.to(torch.float64) - self.apply_K(u_d))

        def solve_lo(r32):
            res = cg_mod.cg(k32, project(r32), M_inv=M_inv, project=project,
                            tol=1e-4, maxiter=maxiter)
            return res.x, res.iters

        ref = refine_mod.refine(apply_hi, solve_lo, rhs64, tol=tol)
        u_dof = ref.x + u_d
        return u_dof[self._dof_map_t], cg_mod.CGResult(
            u_dof, ref.inner_iters, ref.resnorm, ref.rounds, ref.history)

    @staticmethod
    def _proj_hi(free, proj_rm_hi):
        """The float64 residual projector of a refined solve: the Dirichlet
        mask, then the rigid-mode projector where there is one."""
        free64 = free.to(torch.float64)

        def proj_hi(v):
            v = v * free64
            return v if proj_rm_hi is None else proj_rm_hi(v)

        return proj_hi

    def _solve_structured(self, b, fixed, vals, tol, maxiter):
        """Kuhn-grid path (reference :195-237): V-cycle-preconditioned CG
        (``ops/structured_mg``), the multigrid cached on the Dirichlet
        mask.  On the CPU it is built in float64 and solves directly; on
        CUDA it is built in float32 and runs inside float64 iterative
        refinement, the residual through ``apply_K`` (the f64 EBE
        operator, kernel B in double) and each inner solve
        ``mg.solve(r32, tol=1e-4, maxiter=120)``; the result carries the
        rounds' residuals and inner iterations (``history``).  A ``tol`` >=
        1e-5 solves directly in the multigrid's own dtype."""
        key = self.dirichlet_mask.tobytes()
        if self._mg is None or self._mg[0] != key:
            f64_dev = self.device.type == "cpu"
            cls_mg = VarStructuredMG if self.D.ndim == 3 else StructuredMG
            t0 = time.perf_counter()
            mg = cls_mg.build(self.mesh, self.D, fixed_mask=fixed,
                              dtype=config.REAL if f64_dev else config.SOLVE,
                              device=self.device)
            self._mg = (key, mg, time.perf_counter() - t0)
        mg = self._mg[1]
        dt = mg.free_ch.dtype
        if dt == torch.float64 or tol >= 1e-5:
            u, res = mg.solve(b.to(dt), fixed_values=vals.to(dt), tol=tol,
                              maxiter=maxiter)
            u_dof = u.to(b.dtype)
            return u_dof[self._dof_map_t], cg_mod.CGResult(
                u_dof, res.iters, res.resnorm)

        free64 = (~fixed).to(torch.float64)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals)).to(
            torch.float64)
        apply_hi = lambda x: self.apply_K(x) * free64
        rhs64 = (b.to(torch.float64) - self.apply_K(u_d)) * free64

        def solve_lo(r32):
            u, r = mg.solve(r32, tol=1e-4, maxiter=120)
            return u, r.iters

        ref = refine_mod.refine(apply_hi, solve_lo, rhs64, tol=tol)
        u_dof = ref.x + u_d
        return u_dof[self._dof_map_t], cg_mod.CGResult(
            u_dof, ref.inner_iters, ref.resnorm, ref.rounds, ref.history)

    def _solve_routed(self, b, fixed, vals, tol, maxiter, precond="jacobi",
                      chebyshev_degree=6, x0=None):
        """Routed float32 CG in the operator's internal ordering and plane
        layout [d, Nd], inside float64 refinement when ``tol`` is beyond
        float32 reach (``_solve_routed`` :660-803).  The rigid modes go
        through the same reordering and transpose as the vectors before
        they are orthonormalized; ``x0`` enters the refinement as
        ``proj_hi(x0 - u_d)`` and the plain float32 CG in internal order.
        Returns the dof-space field and the CGResult."""
        rk = self.routed_kernel()
        f32 = config.SOLVE
        d, Nd = self.dim, self.num_dofs
        free = ~fixed

        def to_planes(v):                    # user [Nd, d] -> internal [d, Nd]
            return rk.permute_in(v).t().contiguous()

        def from_planes(v):                  # internal [d, Nd] -> user [Nd, d]
            return rk.permute_out(v.t())

        free_p = to_planes(free.to(f32))
        projs = [cg_mod.mask_projector(free_p)]
        proj_rm_hi = None
        if self.no_rigid_motion:
            Z = self._rigid_basis()                   # [Nd * d, k] float64
            proj_rm_hi = cg_mod.nullspace_projector(Z)
            k = Z.shape[1]
            Zp = rk.permute_in(Z.reshape(Nd, d, k)).permute(1, 0, 2) \
                .reshape(d * Nd, k)                   # rows c * Nd + i
            # the port's choice: orthonormalize in float64 and cast the
            # basis to float32 (the reference orthonormalizes the float32
            # modes in float32, elasticity.py:736-742)
            projs.append(cg_mod.nullspace_projector(Zp, dtype=f32))
        project = _compose(projs)
        if precond == "jacobi":
            diag_p = rk.diagonal_planes()
            safe = torch.where(diag_p > 0, diag_p, torch.ones_like(diag_p))
            M_inv = lambda r: r / safe
        elif precond in ("twolevel", "twolevel-mult"):
            # the two-level transfers and smoother blocks follow the
            # internal order (rk.order); it works on [Nd, d], the CG on
            # the planes [d, Nd]; -mult applies the routed operator itself
            free_i = free_p.t()
            tl = self._twolevel_for(
                precond, free,
                node_order=None if rk.order is None
                else rk.order.cpu().numpy(),
                project=lambda v: v * free_i.to(v.dtype),
                apply_A=rk if precond.endswith("mult") else None)
            M_inv = lambda r: tl.M_inv(r.t()).t()
        else:   # block Jacobi, permuted into the internal ordering
            blocks = pc.node_block_diagonal(self.Ke.to(f32), self.elem_dofs,
                                            Nd, d)
            bj = pc.block_jacobi_apply(pc.block_jacobi_inv(
                rk.permute_in(blocks), free_p.t()))
            M_inv = lambda r: bj(r.t()).t()
            if precond == "chebyshev":
                Ap = lambda v: project(rk.apply_planes(v))
                M0 = M_inv
                lmax = pc.estimate_lambda_max(
                    Ap, lambda r: project(M0(r)), (d, Nd), dtype=f32,
                    device=self.device)
                M_inv = pc.chebyshev_preconditioner(
                    Ap, M0, lmax, degree=chebyshev_degree, project=project)
        u_d = torch.where(fixed, vals, torch.zeros_like(vals))

        if b.dtype != torch.float64 or tol >= 1e-5:
            ud_p = to_planes(u_d.to(f32))
            x0_p = None if x0 is None else project(to_planes(
                (x0 - u_d).to(f32)))
            rhs = project(to_planes(b.to(f32)) - rk.apply_planes(ud_p))
            res = cg_mod.cg(rk.apply_planes, rhs, x0_p, M_inv=M_inv,
                            project=project, tol=tol, maxiter=maxiter)
            x = from_planes(res.x + ud_p).to(b.dtype)
            return x, cg_mod.CGResult(x, res.iters, res.resnorm)

        proj_hi = self._proj_hi(free, proj_rm_hi)
        u_d = u_d.to(torch.float64)
        apply_hi = lambda x: proj_hi(self.apply_K(x))
        rhs64 = proj_hi(b.to(torch.float64) - self.apply_K(u_d))

        def solve_lo(r32):
            res = cg_mod.cg(rk.apply_planes, project(to_planes(r32)),
                            M_inv=M_inv, project=project, tol=1e-4,
                            maxiter=maxiter)
            return from_planes(res.x), res.iters

        # a warm start is projected before the first residual: a rigid
        # component in x0 would never be corrected (K Z = 0)
        x0_64 = None if x0 is None else proj_hi(x0.to(torch.float64) - u_d)
        ref = refine_mod.refine(apply_hi, solve_lo, rhs64, tol=tol, x0=x0_64)
        u = ref.x + u_d
        return u, cg_mod.CGResult(u, ref.inner_iters, ref.resnorm,
                                  ref.rounds, ref.history)

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

    def stress_at(self, u, points=None):
        """[E, Q, fl] stresses at barycentric points (``strain_at``'s)."""
        return et.double_contract(self.D if self.D.ndim == 2
                                  else self.D[:, None],
                                  self.strain_at(u, points))

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
