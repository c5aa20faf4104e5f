"""Periodic homogenization of effective elasticity tensors (counterpart of
``meshfem_tpu/analysis/homogenization.py``).

* cell problems: for each canonical macroscopic strain e^ij solve
      -div C : [strain(w^ij) + e^ij] = 0,  w^ij cell-periodic,
  through a periodic dof map and translation projection, all fl right-hand
  sides as ONE block CG (``solve_cell_problems``);
* on the card past ``MESHFEM_ROUTED_MIN_E`` elements the block CG runs in
  float32 on the routed operator (``RoutedEBE.apply_block``: one gather and
  one segment sum for all 18 planes at dim 3) inside float64 iterative
  refinement (``_solve_cell_problems_routed``);
* ``precond="multigrid"`` on Kuhn-grid cells: the periodic torus V-cycle
  (``ops/structured_periodic.py``), all fl columns in one block CG in
  float64; ``homogenize_voxels`` builds such a cell from an occupancy
  array;
* ``precond="twolevel"`` / ``"twolevel-mult"``: the P1-coarse two-level
  preconditioner (``solvers/twolevel.py``) with the translation projector;
* the orthotropic base cell (``homogenize_orthotropic``): symmetry-plane
  pinning instead of periodicity, one block CG with a per-column mask
  (jacobi, twolevel) or one ``VarStructuredMG`` per probe (multigrid), and
  the reflection-sign reconstruction of the full tensor;
* the homogenized tensor in stress form and in boundary (displacement)
  form, macro-to-micro strain tensors and probes.

Tetrahedral cells only: 2D cells and pixel occupancies wait for triangle
meshes (ROADMAP Queue 1, item 3) and raise NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..fem import elasticity_tensor as et
from ..fem import shape_functions as sf
from ..fem.flattening import flat_len, flat_rows_cols, shear_doubler
from ..mesh import periodic as per
from ..mesh.femmesh import FEMMesh
from ..mesh.geometry import BBox
from ..physics.elasticity import ElasticitySimulator
from ..solvers import cg as cg_mod
from ..solvers import precond as pc
from ..solvers.refine import refine as mp_refine

_NO_2D = ("2D cells and pixel occupancies need triangle meshes, queued in "
          "ROADMAP.md (Queue 1, item 3)")


@dataclasses.dataclass
class HomogenizationResult:
    """Mirrors the reference's ``HomogenizationResult``; ``timings``
    holds host seconds of the solve's parts where a path records them
    (the orthotropic multigrid: each probe's build and solve)."""

    Ch: torch.Tensor           # [fl, fl] homogenized tensor (D matrix)
    w: torch.Tensor            # [fl, N, dim] fluctuation displacements
    strain_w: torch.Tensor     # [fl, E, fl] average fluctuation strains
    cg_iters: list
    timings: dict = dataclasses.field(default_factory=dict)


def canonical_strain(dim: int, i: int, dtype=torch.float64):
    """The symmetrized basis e^(kl) = 1/2 (e_k x e_l + e_l x e_k): raw flat
    component 1 on diagonal slots, 0.5 on shear slots."""
    e = torch.zeros(flat_len(dim), dtype=dtype)
    e[i] = 1.0 if i < dim else 0.5
    return e


def _project_translations(v):
    """Exact mean subtraction over the dof axis: projects the translations
    out of the periodic system (replaces the pin constraint)."""
    return v - v.mean(dim=0, keepdim=True)


def _cell_loads(sim):
    """[Nd, dim, fl] right-hand sides ``constant_strain_load(-e^i)``."""
    dim = sim.dim
    return torch.stack([sim.constant_strain_load(
        -canonical_strain(dim, i, sim.Ke.dtype))
        for i in range(flat_len(dim))], dim=-1)


def solve_cell_problems(sim: ElasticitySimulator, tol: float = 1e-11,
                        maxiter: int = 100000, precond: str = "block",
                        chebyshev_degree: int = 6, operator: str = "auto"):
    """Solve the fl cell problems on a periodic simulator (built with a
    periodic dof map, :func:`periodic_simulator`) as ONE block CG over all
    fl right-hand sides.

    ``precond``: 'jacobi' | 'block' (d x d node blocks) | 'chebyshev'
    (k-step polynomial in the block-Jacobi-preconditioned operator) |
    'twolevel' / 'twolevel-mult' (P1-coarse two-level,
    ``solvers/twolevel.py``) | 'multigrid' (the periodic torus V-cycle for
    Kuhn-GRID cells, ``ops/structured_periodic.py``; raises ValueError
    off-grid).  ``operator``: 'auto' runs the routed multi-RHS operator on
    CUDA past ``MESHFEM_ROUTED_MIN_E`` elements for the jacobi / block
    preconditioners, wrapped in float64 iterative refinement below float32
    reach; 'routed' / 'ebe' force a path.
    Returns (w [fl, N, dim], iters list)."""
    if precond == "multigrid":
        from ..ops.structured_periodic import solve_cell_problems_grid

        return solve_cell_problems_grid(sim, tol=tol, maxiter=maxiter)
    if precond not in ("jacobi", "block", "chebyshev", "twolevel",
                       "twolevel-mult"):
        raise ValueError(f"unknown precond {precond!r}")
    dim = sim.dim
    fl = flat_len(dim)
    project = _project_translations
    if (operator == "routed"
            or (operator == "auto" and precond in ("jacobi", "block")
                and sim._routed_auto())):
        return _solve_cell_problems_routed(sim, tol, maxiter, precond,
                                           project)
    if precond == "jacobi":
        diag = sim.K_diagonal()
        safe = torch.where(diag > 0, diag, torch.ones_like(diag))
        M_inv = lambda r: r / (safe if r.dim() == 2 else safe[..., None])
    elif precond in ("twolevel", "twolevel-mult"):
        # P1-coarse two-level: bounded iteration counts at high contrast
        from ..solvers.twolevel import TwoLevel

        M_inv = TwoLevel.from_simulator(
            sim, mode=("multiplicative" if precond.endswith("mult")
                       else "additive"), project=project).M_inv
    else:
        blocks = pc.node_block_diagonal(sim.Ke, sim.elem_dofs, sim.num_dofs,
                                        dim)
        M_inv = pc.block_jacobi_apply(pc.block_jacobi_inv(blocks))
        if precond == "chebyshev":
            Ap = lambda v: project(sim.apply_K(v))
            M0 = M_inv
            lmax = pc.estimate_lambda_max(
                Ap, lambda r: project(M0(r)), (sim.num_dofs, dim),
                dtype=sim.Ke.dtype, device=sim.device)
            M_inv = pc.chebyshev_preconditioner(
                Ap, M0, lmax, degree=chebyshev_degree, project=project)

    res = cg_mod.cg_block(sim.apply_K, _cell_loads(sim), M_inv=M_inv,
                          project=project, tol=tol, maxiter=maxiter)
    w = res.x.movedim(-1, 0)[:, sim._dof_map_t]
    return w, [int(res.iters)] * fl


def _solve_cell_problems_routed(sim, tol, maxiter, precond, project):
    """All fl cell problems through ONE routed multi-RHS block CG
    (``RoutedEBE.apply_block``): float32 block CG, wrapped in float64
    iterative refinement (EBE float64 residuals) below float32 reach.

    The translation projector (mean over the dof axis) is permutation-
    invariant, so it applies unchanged in the operator's internal
    ordering."""
    dim = sim.dim
    fl = flat_len(dim)
    f32 = torch.float32
    rk = sim.routed_kernel(block_rhs=fl)
    if precond == "jacobi":
        diag_i = rk.diagonal()
        safe = torch.where(diag_i > 0, diag_i, torch.ones_like(diag_i))
        M_inv = lambda r: r / (safe if r.dim() == 2 else safe[..., None])
    else:   # block Jacobi, permuted into the internal ordering
        blocks = pc.node_block_diagonal(sim.Ke.to(f32), sim.elem_dofs,
                                        sim.num_dofs, dim)
        M_inv = pc.block_jacobi_apply(
            pc.block_jacobi_inv(rk.permute_in(blocks)))

    B = _cell_loads(sim)                                   # [Nd, dim, fl]

    def solve_lo_block(Bi, lo_tol, lo_maxiter):
        return cg_mod.cg_block(rk.apply_block, Bi, M_inv=M_inv,
                               project=project, tol=lo_tol,
                               maxiter=lo_maxiter)

    if sim.Ke.dtype != torch.float64 or tol >= 1e-5:
        res = solve_lo_block(project(rk.permute_in(B.to(f32))), tol, maxiter)
        X = rk.permute_out(res.x).to(sim.Ke.dtype)
        iters = [int(res.iters)] * fl
    else:
        # f64 refinement: EBE f64 residuals, routed f32 block corrections
        apply_hi = lambda X: project(sim.apply_K(X))
        b64 = project(B.to(torch.float64))

        def solve_lo(R32):
            res = solve_lo_block(project(rk.permute_in(R32)), 1e-4, maxiter)
            return rk.permute_out(res.x), res.iters

        ref = mp_refine(apply_hi, solve_lo, b64, tol=tol)
        X = ref.x
        iters = [int(ref.inner_iters)] * fl
    w = X.movedim(-1, 0)[:, sim._dof_map_t]
    return w, iters


def periodic_simulator(mesh: FEMMesh, material, cell: BBox | None = None,
                       eps: float = 1e-7, permit_mismatch: bool = False,
                       device=None) -> ElasticitySimulator:
    """ElasticitySimulator with periodic dof identification."""
    dof_map, _, _ = per.match_periodic_nodes(
        mesh.node_positions, cell or mesh.bbox(), eps,
        permit_mismatch=permit_mismatch)
    return ElasticitySimulator(mesh, material, device=device,
                               dof_map=dof_map)


def homogenized_tensor_stress_form(sim: ElasticitySimulator, w,
                                   base_cell_volume: float | None = None):
    """Eh row i = <[C : strain(w_i)] + C row i> averaged over the cell."""
    if base_cell_volume is None:
        base_cell_volume = sim.mesh.bbox().volume()
    vol = sim.geom.volume
    Eh = torch.stack([torch.einsum("e,ea->a", vol,
                                   sim.average_stress_field(w[i]))
                      for i in range(w.shape[0])])          # [fl, fl]
    if sim.D.ndim == 2:
        Eh = Eh + sim.D * vol.sum()
    else:
        Eh = Eh + torch.einsum("e,eab->ab", vol, sim.D)
    return Eh / base_cell_volume


def homogenized_tensor_displacement_form(sim: ElasticitySimulator, w,
                                         base_cell_volume: float | None = None):
    """Boundary-integral form (constant base material):
    Eh row i = C : nw^i + C * volFrac, nw^i = 1/2 int_dw (w x n + n x w)."""
    mesh = sim.mesh
    if base_cell_volume is None:
        base_cell_volume = mesh.bbox().volume()
    if sim.D.ndim != 2:
        raise ValueError("displacement form requires a constant base material")
    normals = sim.geom.bdry_normal                        # [B, dim]
    bvol = sim.geom.bdry_volume                           # [B]
    wgt = torch.as_tensor(sf.integrated_shape_np(mesh.K - 1, mesh.degree),
                          dtype=bvol.dtype, device=bvol.device)   # [nb]
    benodes = torch.as_tensor(mesh.bdry_elem_nodes, device=bvol.device)
    r, c = flat_rows_cols(sim.dim)
    rows = []
    for i in range(w.shape[0]):
        wb = w[i][benodes]                                # [B, nb, dim]
        w_int = torch.einsum("n,bnd->bd", wgt, wb) * bvol[:, None]
        nw = 0.5 * (torch.einsum("bp,bq->bpq", w_int, normals)
                    + torch.einsum("bq,bp->bpq", w_int, normals))
        nw_flat = nw[:, r, c].sum(dim=0)                  # [fl]
        rows.append(et.double_contract(sim.D, nw_flat))
    Eh = torch.stack(rows) + sim.D * sim.geom.volume.sum()
    return Eh / base_cell_volume


def macro_to_micro_strain(sim: ElasticitySimulator, w):
    """Per-element G tensors [E, fl, fl]: G[e] row i = average strain of
    (w_i + e^i x) over element e."""
    dim = sim.dim
    rows = []
    for i in range(w.shape[0]):
        es = sim.average_strain_field(w[i]).clone()
        es[:, i] += 1.0 if i < dim else 0.5
        rows.append(es)
    return torch.stack(rows, dim=1)


def probe(sim: ElasticitySimulator, w, macro_strain_flat):
    """(u, strain) under a macroscopic strain: u = sum_i e_i w_i, and the
    strain field includes the macro strain."""
    e = torch.as_tensor(macro_strain_flat, dtype=w.dtype, device=w.device)
    # shear basis elements carry 1/2, so their coefficients are the
    # shear-doubled raw components
    coef = torch.as_tensor(shear_doubler(sim.dim), dtype=e.dtype,
                           device=e.device) * e
    u = torch.einsum("i,ind->nd", coef, w)
    return u, sim.average_strain_field(u) + e[None, :]


def homogenize_voxels(occupancy, E_solid: float = 1.0, nu: float = 0.3,
                      void_ratio: float = 1e-6, tol: float = 1e-9,
                      cell=None, device=None) -> HomogenizationResult:
    """Homogenize a VOXEL microstructure directly: occupancy [nx, ny, nz]
    (bool or 0/1) -> grid cell with a two-phase material field (void as
    ``void_ratio * E_solid``, the topology-optimization ersatz) -> periodic
    torus multigrid cell problems (``ops/structured_periodic.py``).  A 2D
    (pixel) occupancy raises NotImplementedError."""
    from ..mesh import generators
    from ..physics.materials import MaterialField

    occ = np.asarray(occupancy)
    if occ.ndim != 3:
        raise NotImplementedError(_NO_2D)
    if cell is None:
        cell = (1.0,) * 3
    V, T = generators.grid_tet(*occ.shape, hi=tuple(cell))
    mesh = FEMMesh(V, T, degree=2)
    E_cell = np.where(occ.reshape(-1) > 0, E_solid, void_ratio * E_solid)
    E_field = np.repeat(E_cell, 6)
    mats = MaterialField.isotropic_field(3, E_field,
                                         np.full(len(E_field), nu))
    return homogenize(mesh, mats, tol=tol, precond="multigrid",
                      device=device)


def homogenize(mesh: FEMMesh, material, orthotropic_cell: bool = False,
               tol: float = 1e-11, center_fluctuations: bool = True,
               base_cell_volume: float | None = None,
               precond: str = "block", device=None) -> HomogenizationResult:
    """One-call homogenization: periodic simulator, cell problems
    (``operator="auto"``), stress-form tensor.  ``precond`` as in
    :func:`solve_cell_problems`; with ``orthotropic_cell`` the twolevel
    variants take 'twolevel', 'multigrid' stays and any other takes
    'jacobi' (:func:`homogenize_orthotropic`).  Runs on the CUDA device
    unless ``device="cpu"``."""
    if orthotropic_cell:
        if precond.startswith("twolevel"):
            oprecond = "twolevel"
        elif precond == "multigrid":
            oprecond = "multigrid"
        else:
            oprecond = "jacobi"
        return homogenize_orthotropic(
            mesh, material, tol=tol, base_cell_volume=base_cell_volume,
            precond=oprecond, device=device)
    sim = periodic_simulator(mesh, material, device=device)
    w, iters = solve_cell_problems(sim, tol=tol, precond=precond)
    if center_fluctuations:
        w = w - w.mean(dim=1, keepdim=True)
    Ch = homogenized_tensor_stress_form(sim, w, base_cell_volume)
    strain_w = torch.stack([sim.average_strain_field(w[i])
                            for i in range(w.shape[0])])
    return HomogenizationResult(Ch, w, strain_w, iters)


# ---------------------------------------------------------------------------
# Orthotropic base cell
# ---------------------------------------------------------------------------

def _ortho_fixed_masks(mesh: FEMMesh, eps: float = 1e-7):
    """Per-probe Dirichlet component masks on the symmetry planes.

    Returns (stretch_mask [N, 3] bool, shear_masks list of [N, 3]).
    Stretch probes w^ii fix component c on the faces with normal e_c;
    shear probe s (plane ij) fixes component s on every face, plus the
    third component on the perpendicular faces."""
    dim = mesh.dim
    fm = per.face_membership(mesh.node_positions, mesh.bbox(), eps)
    on_face = fm.on_min | fm.on_max                      # [N, dim]
    stretch = np.zeros((mesh.num_nodes, dim), dtype=bool)
    for c in range(dim):
        stretch[on_face[:, c], c] = True
    shear_masks = []
    for s in range(flat_len(dim) - dim):
        m = np.zeros((mesh.num_nodes, dim), dtype=bool)
        for c in range(dim):
            face_nodes = on_face[:, c]
            m[face_nodes, s] = True
            if c != s:
                m[face_nodes, 3 - (c + s)] = True
        shear_masks.append(m)
    return stretch, shear_masks


def homogenize_orthotropic(mesh: FEMMesh, material, tol: float = 1e-11,
                           base_cell_volume: float | None = None,
                           precond: str = "jacobi",
                           device=None) -> HomogenizationResult:
    """Homogenize on an orthotropic base cell (1/8 of the period cell):
    per-face normal pinning replaces periodicity, and the full-cell tensor
    follows from the reflection-sign reconstruction.  ``precond``:
    'jacobi' | 'twolevel' (one block CG over the fl probes with a
    per-column mask; the two-level coarse matrix is masked by the union of
    all pins) | 'multigrid' (Kuhn-grid cells: one ``VarStructuredMG`` per
    probe, sharing the fine P1 cell matrices)."""
    if mesh.dim != 3:
        raise NotImplementedError(_NO_2D)
    if precond not in ("jacobi", "twolevel", "multigrid"):
        raise ValueError(f"unknown precond {precond!r}")
    dim = mesh.dim
    fl = flat_len(dim)
    sim = ElasticitySimulator(mesh, material, device=device)
    stretch_mask, shear_masks = _ortho_fixed_masks(mesh)
    masks = [stretch_mask if i < dim else shear_masks[i - dim]
             for i in range(fl)]
    if base_cell_volume is None:
        base_cell_volume = mesh.bbox().volume()

    if precond == "multigrid":
        from ..ops.structured_mg import (VarStructuredMG,
                                         _p1_cell_matrices_var)

        D = sim.D
        if D.dim() == 2:
            D = D.expand((mesh.num_elements,) + tuple(D.shape))
        # the fine P1 cell matrices depend only on (mesh, D): computed
        # once and shared by the fl builds (masks, diagonals and the
        # coarse factorization differ per probe)
        Kc_shared = _p1_cell_matrices_var(mesh, D, sim.device)
        ws, iters = [], []
        timings = dict(probe_build_s=[], probe_solve_s=[])
        for i in range(fl):
            t0 = time.perf_counter()
            mg = VarStructuredMG.build(mesh, D,
                                       fixed_mask=torch.as_tensor(masks[i]),
                                       dtype=sim.Ke.dtype, Kc_fine=Kc_shared,
                                       device=sim.device)
            t1 = time.perf_counter()
            rhs = sim.constant_strain_load(
                -canonical_strain(dim, i, sim.Ke.dtype))
            u, res = mg.solve(rhs, tol=tol)
            ws.append(u)
            iters.append(int(res.iters))
            timings["probe_build_s"].append(t1 - t0)
            timings["probe_solve_s"].append(time.perf_counter() - t1)
        w = torch.stack(ws)
    else:
        if precond == "twolevel":
            # the probes pin different faces; the coarse matrix is masked
            # with the UNION of all pins (the intersection of the free
            # masks), so its solve is well-posed and every correction lies
            # inside each column's subspace after the outer projector
            from ..solvers.twolevel import TwoLevel

            free_all = np.ones((sim.num_dofs, dim), bool)
            for m in masks:
                free_all &= ~m
            M_inv = TwoLevel.from_simulator(sim, mode="additive",
                                            free_mask=free_all).M_inv
        else:
            diag = sim.K_diagonal()
            safe = torch.where(diag > 0, diag, torch.ones_like(diag))
            M_inv = lambda r: r / safe[..., None]
        # ONE block CG over the fl probes with a per-column mask projector
        free_cols = torch.stack(
            [torch.as_tensor(~m, dtype=sim.Ke.dtype, device=sim.device)
             for m in masks], dim=-1)                       # [Nd, d, fl]
        res = cg_mod.cg_block(sim.apply_K, _cell_loads(sim), M_inv=M_inv,
                              project=lambda v: v * free_cols, tol=tol,
                              maxiter=100000)
        w = res.x.movedim(-1, 0)
        iters = [int(res.iters)] * fl
        timings = {}

    EhO = homogenized_tensor_stress_form(sim, w, base_cell_volume)
    Ch = reconstruct_from_ortho_cell(EhO, dim)
    strain_w = torch.stack([sim.average_strain_field(w[i])
                            for i in range(fl)])
    return HomogenizationResult(Ch, w, strain_w, iters, timings)


def reconstruct_from_ortho_cell(EhO, dim: int):
    """Reflection-sign reconstruction: averages sign-weighted copies over
    the 2^dim reflections, zeroing the non-orthotropic couplings."""
    fl = flat_len(dim)
    n_refl = 1 << dim

    def sign(ij, r):
        if ij < dim:
            return 1.0
        bits = [(r >> b) & 1 for b in range(dim)]
        if dim == 3:
            bits[ij - dim] = 0
        return -1.0 if sum(bits) == 1 else 1.0

    W = np.zeros((fl, fl))
    for r in range(n_refl):
        for kl in range(fl):
            for ij in range(fl):
                W[ij, kl] += sign(ij, r) * sign(kl, r)
    W /= n_refl
    return EhO * torch.as_tensor(W, dtype=EhO.dtype, device=EhO.device)
