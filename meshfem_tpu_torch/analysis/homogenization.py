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
* the homogenized tensor in stress form and in boundary (displacement)
  form, macro-to-micro strain tensors and probes.

Tetrahedral cells only (2D cells wait for triangle meshes).  Not ported
yet, each raising NotImplementedError with its ROADMAP item: the two-level
preconditioners and the orthotropic base cell (Queue 1, item 11), the
periodic multigrid and ``homogenize_voxels`` (Queue 1, item 13).
"""

from __future__ import annotations

import dataclasses

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

_NO_TWOLEVEL = ("precond='twolevel*' (solvers/twolevel.py) is queued in "
                "ROADMAP.md (Queue 1, item 11)")
_NO_MULTIGRID = ("precond='multigrid' (ops/structured_periodic.py) and "
                 "homogenize_voxels are queued in ROADMAP.md (Queue 1, "
                 "item 13)")
_NO_ORTHO = ("the orthotropic base cell (homogenize_orthotropic, "
             "orthotropic_cell=True) is queued in ROADMAP.md (Queue 1, "
             "item 11)")


@dataclasses.dataclass
class HomogenizationResult:
    """Mirrors the reference's ``HomogenizationResult``."""

    Ch: torch.Tensor           # [fl, fl] homogenized tensor (D matrix)
    w: torch.Tensor            # [fl, N, dim] fluctuation displacements
    strain_w: torch.Tensor     # [fl, E, fl] average fluctuation strains
    cg_iters: list


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
    (k-step polynomial in the block-Jacobi-preconditioned operator).
    ``operator``: 'auto' runs the routed multi-RHS operator on CUDA past
    ``MESHFEM_ROUTED_MIN_E`` elements for the jacobi / block
    preconditioners, wrapped in float64 iterative refinement below float32
    reach; 'routed' / 'ebe' force a path.
    Returns (w [fl, N, dim], iters list)."""
    if precond in ("twolevel", "twolevel-mult"):
        raise NotImplementedError(_NO_TWOLEVEL)
    if precond == "multigrid":
        raise NotImplementedError(_NO_MULTIGRID)
    if precond not in ("jacobi", "block", "chebyshev"):
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
                      cell=None):
    """Voxel microstructures run on the periodic multigrid: not ported."""
    raise NotImplementedError(_NO_MULTIGRID)


def homogenize_orthotropic(mesh: FEMMesh, material, tol: float = 1e-11,
                           base_cell_volume: float | None = None,
                           precond: str = "jacobi"):
    """The orthotropic base cell variant: not ported."""
    raise NotImplementedError(_NO_ORTHO)


def homogenize(mesh: FEMMesh, material, orthotropic_cell: bool = False,
               tol: float = 1e-11, center_fluctuations: bool = True,
               base_cell_volume: float | None = None,
               precond: str = "block", device=None) -> HomogenizationResult:
    """One-call homogenization: periodic simulator, cell problems
    (``operator="auto"``), stress-form tensor.  Runs on the CUDA device
    unless ``device="cpu"``."""
    if orthotropic_cell:
        raise NotImplementedError(_NO_ORTHO)
    sim = periodic_simulator(mesh, material, device=device)
    w, iters = solve_cell_problems(sim, tol=tol, precond=precond)
    if center_fluctuations:
        w = w - w.mean(dim=1, keepdim=True)
    Ch = homogenized_tensor_stress_form(sim, w, base_cell_volume)
    strain_w = torch.stack([sim.average_strain_field(w[i])
                            for i in range(w.shape[0])])
    return HomogenizationResult(Ch, w, strain_w, iters)
