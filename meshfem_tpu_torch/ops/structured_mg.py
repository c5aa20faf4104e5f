"""Structured geometric multigrid: a V-cycle preconditioner for the P2
Kuhn-grid operator.

Counterpart of ``meshfem_tpu/ops/structured_mg.py``.  Hierarchy (every level
exactly Galerkin):

* level 0: P2 elasticity on the n^3 Kuhn grid, the channel-space stencil
  operator (``ops.structured.StructuredP2Elasticity``), or the per-element
  one (``ops.structured_var``);
* level 1: P1 on the SAME grid.  P1 is nested in P2 with exact nodal
  interpolation (every P2 edge node is the midpoint of the Kuhn edge from
  its owner cell's min corner to corner ``bits``), so the Galerkin coarse
  operator equals the rediscretized P1 stiffness;
* levels 2..: P1 on dyadically coarsened grids.  Kuhn triangulations are
  self-similar under 2:1 refinement, so rediscretized == Galerkin again;
  transfers are parity-class reshapes with the midpoint rule
  fine[2c + b] = (v[c] + v[c + b]) / 2;
* coarsest: a dense inverse built on the host in f64 and applied as one
  device ``torch.matmul`` when it has at most ``dense_cap`` dofs (``pinv``
  when no Dirichlet condition is left), else a host ``scipy`` LU, which
  copies the coarse residual to the host and back once per V-cycle (the
  reference's ``pure_callback``).  Odd grid sizes stop the dyadic chain.

Smoother: fixed-degree Chebyshev over Jacobi on [lam_max/4, lam_max] per
level, linear and symmetric, so the V-cycle is a valid plain-CG
preconditioner.  P1 levels apply as 8 corner slices -> [cells, 24] @ K_cell
-> 8 slice adds; the cell grid holds only real cells, so no boundary
correction.  Vectors are channel tensors [mx, my, mz, 8, 3] on level 0 and
vertex fields [mx, my, mz, 3] below; the reference's lane-packed layout is
not carried over (``ops/structured.py``).  TF32 stays off
(``config.py``): the reference found reduced-precision products turn the
V-cycle into an indefinite preconditioner (``<p, Ap> < 0`` at 1.2 M dofs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..mesh import generators
from ..mesh.femmesh import FEMMesh
from ..solvers import cg as cg_mod
from ..sparse import assembly
from . import element_matrices as em
from .structured import (_CHANNEL_BITS, StructuredP2Elasticity,
                         validate_kuhn_grid)


def _element_stiffness_host(mesh, D, deg, device="cpu"):
    """f64 degree-``deg`` element stiffness on ``mesh``'s tets as a host
    array (the geometry is the vertices', whatever the mesh's degree)."""
    g = mesh.geometry(device)
    return em.element_elasticity(
        g.grad_lambda, g.volume,
        torch.as_tensor(D, dtype=config.REAL, device=g.volume.device),
        deg).cpu().numpy()


def _p1_cell_stiffness(h3, D):
    """[24, 24] P1 stiffness of one Kuhn-subdivided cell with per-axis
    spacings h3, rows/cols ordered by ``_CHANNEL_BITS`` corner order."""
    V, T = generators.grid_tet(1, 1, 1, hi=tuple(h3))
    mesh = FEMMesh(V, T, degree=1)
    K = np.asarray(assembly.assemble_scipy(
        _element_stiffness_host(mesh, D, 1), mesh.elem_nodes,
        mesh.num_nodes, d=3).todense())
    q = np.round(mesh.node_positions / np.asarray(h3)).astype(int)
    perm = np.empty(8, np.int64)
    for i in range(8):
        perm[_CHANNEL_BITS.index(tuple(q[i]))] = i
    idx = (perm[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
    return K[np.ix_(idx, idx)]


@dataclasses.dataclass
class P1Level:
    """P1 elasticity on an (nx, ny, nz)-cell Kuhn grid as corner slices ->
    per-cell product -> corner slice adds (the cell grid has no fake
    cells, so the operator is exact with no boundary fix-up)."""

    n3: tuple
    Kc: torch.Tensor        # [24, 24], or per cell [nx, ny, nz, 24, 24]
    free: torch.Tensor      # [mx, my, mz, 3] 1.0 = free
    diag: torch.Tensor      # [mx, my, mz, 3]
    Kc64: np.ndarray        # Kc in f64 on the host (bounds, coarse matrix)
    diag64: np.ndarray

    def apply(self, v):
        nx, ny, nz = self.n3
        cell = torch.cat([v[bx:bx + nx, by:by + ny, bz:bz + nz]
                          for bx, by, bz in _CHANNEL_BITS], dim=-1)
        Kc = self.Kc.to(v.dtype)
        if Kc.dim() == 2:               # uniform material: one [24, 24]
            f = cell @ Kc.t()
        else:                           # per cell [nx, ny, nz, 24, 24]
            f = torch.matmul(Kc, cell.unsqueeze(-1)).squeeze(-1)
        y = torch.zeros_like(v)
        for i, (bx, by, bz) in enumerate(_CHANNEL_BITS):
            y[bx:bx + nx, by:by + ny, bz:bz + nz] += f[..., 3 * i:3 * i + 3]
        return y


def _p1_diag(n3, Kc):
    """Assembled diagonal of the P1 grid operator (host, f64); Kc either
    one [24, 24] or per-cell [nx, ny, nz, 24, 24]."""
    nx, ny, nz = n3
    d = np.zeros((nx + 1, ny + 1, nz + 1, 3))
    Kc = np.asarray(Kc)
    kd = np.diagonal(Kc, axis1=-2, axis2=-1)
    if Kc.ndim == 2:
        kd = np.broadcast_to(kd, (nx, ny, nz, 24))
    kd = kd.reshape(nx, ny, nz, 8, 3)
    for i, (bx, by, bz) in enumerate(_CHANNEL_BITS):
        d[bx:bx + nx, by:by + ny, bz:bz + nz] += kd[..., i, :]
    return d


def _p1_gershgorin(lvl: P1Level) -> float:
    """Row-scaled Gershgorin bound on lam_max(D^-1 A) for a P1 level
    (abs row sums assembled per cell, exact on the host)."""
    nx, ny, nz = lvl.n3
    rs = np.zeros((nx + 1, ny + 1, nz + 1, 3))
    ka = np.abs(lvl.Kc64).sum(axis=-1)
    if lvl.Kc64.ndim == 2:
        ka = np.broadcast_to(ka, (nx, ny, nz, 24))
    ka = ka.reshape(nx, ny, nz, 8, 3)
    for i, (bx, by, bz) in enumerate(_CHANNEL_BITS):
        rs[bx:bx + nx, by:by + ny, bz:bz + nz] += ka[..., i, :]
    return float((rs / np.maximum(lvl.diag64, 1e-30)).max()) * 1.02


# ---------------------------------------------------------------------------
# Transfers (slices, pads and reshapes)
# ---------------------------------------------------------------------------

def _shift_up(v, b):
    """shifted[c] = v[c + b] (zero past the end)."""
    bx, by, bz = b
    return F.pad(v[bx:, by:, bz:], (0, 0, 0, bz, 0, by, 0, bx))


def _shift_down(v, b):
    """shifted[c] = v[c - b] (zero before the start)."""
    bx, by, bz = b
    m = v.shape
    return F.pad(v, (0, 0, bz, 0, by, 0, bx, 0))[:m[0], :m[1], :m[2]]


def prolong_p2(v):
    """P1 vertex field [mx, my, mz, 3] -> P2 channel field
    [mx, my, mz, 8, 3]: edge channel b gets (v[c] + v[c + b]) / 2."""
    chs = [v] + [0.5 * (v + _shift_up(v, b)) for b in _CHANNEL_BITS[1:]]
    return torch.stack(chs, dim=3)


def restrict_p2(u):
    """Adjoint of :func:`prolong_p2`: [mx, my, mz, 8, 3] -> vertices."""
    out = u[..., 0, :]
    for i, b in enumerate(_CHANNEL_BITS[1:], start=1):
        ub = u[..., i, :]
        out = out + 0.5 * (ub + _shift_down(ub, b))
    return out


def prolong_h(vc, nf3):
    """P1 grid (n/2) -> P1 grid n by the Kuhn midpoint rule:
    fine[2c + b] = (v[c] + v[c + b]) / 2 (copy for b = 0)."""
    mc = vc.shape[:3]
    classes = [vc if b == (0, 0, 0) else 0.5 * (vc + _shift_up(vc, b))
               for b in [(bx, by, bz)
                         for bx in (0, 1) for by in (0, 1) for bz in (0, 1)]]
    z = torch.stack(classes, dim=0).reshape(2, 2, 2, *mc, 3)
    fine = z.permute(3, 0, 4, 1, 5, 2, 6).reshape(
        2 * mc[0], 2 * mc[1], 2 * mc[2], 3)
    return fine[:nf3[0] + 1, :nf3[1] + 1, :nf3[2] + 1]


def restrict_h(rf, nc3):
    """Adjoint of :func:`prolong_h`."""
    mc = (nc3[0] + 1, nc3[1] + 1, nc3[2] + 1)
    mf = rf.shape[:3]
    rf = F.pad(rf, (0, 0, 0, 2 * mc[2] - mf[2], 0, 2 * mc[1] - mf[1],
                    0, 2 * mc[0] - mf[0]))
    z = rf.reshape(mc[0], 2, mc[1], 2, mc[2], 2, 3).permute(
        1, 3, 5, 0, 2, 4, 6)
    out = z[0, 0, 0]
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                if bx == by == bz == 0:
                    continue
                ub = z[bx, by, bz]
                out = out + 0.5 * (ub + _shift_down(ub, (bx, by, bz)))
    return out


# ---------------------------------------------------------------------------
# The multigrid object
# ---------------------------------------------------------------------------

def _chebyshev(apply_A, diag, mask, lam_max, degree):
    """Fixed-degree Chebyshev smoother over Jacobi targeting
    [lam_max/4, lam_max]: linear and symmetric (valid inside plain CG)."""
    lam_max = float(lam_max)
    lam_min = lam_max / 4.0
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))

    def S(b):
        z = (b / safe) * mask
        d = z / theta
        x = d
        r = b
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            r = r - apply_A(d * mask) * mask
            z = (r / safe) * mask
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            x = x + d
            rho = rho_new
        return x * mask

    return S


def _level_chain(n3, dense_cap):
    """P1 on the fine grid, then dyadic coarsening while every count is
    even and at least 4 and the level exceeds the dense cap."""
    def dofs(n):
        return (n[0] + 1) * (n[1] + 1) * (n[2] + 1) * 3

    chain = [n3]
    while (all(c % 2 == 0 for c in chain[-1]) and min(chain[-1]) >= 4
           and dofs(chain[-1]) > dense_cap):
        chain.append(tuple(c // 2 for c in chain[-1]))
    return chain, dofs(chain[-1]) <= dense_cap


def _coarse_solver(Ac, mask, perm, dense, dt, dev):
    """(dense inverse in grid order on the device, or None; host LU solve
    of a grid-order [mx, my, mz, 3] array, or None)."""
    if dense:
        Ad = np.asarray(Ac.todense())
        if mask.min() > 0:
            # no Dirichlet anywhere: singular (rigid modes); the outer CG
            # projects the nullspace
            inv = np.linalg.pinv(Ad, hermitian=True)
        else:
            inv = np.linalg.inv(Ad)
        return torch.as_tensor(inv[np.ix_(perm, perm)], dtype=dt,
                               device=dev), None
    import scipy.sparse.linalg as spla

    lu = spla.splu(Ac.tocsc())
    iperm = np.argsort(perm)

    def coarse_solve(r):
        flat = np.asarray(r, np.float64).reshape(-1)[iperm]
        return lu.solve(flat)[perm].reshape(r.shape)

    return None, coarse_solve


@dataclasses.dataclass
class StructuredMG:
    """V-cycle preconditioner and MG-PCG solver for the structured P2 path
    (constant material).  Build once per (mesh, D, Dirichlet mask);
    ``precondition`` maps a channel residual [mx, my, mz, 8, 3] to a
    correction; ``solve`` runs MG-PCG end to end."""

    fine: object                   # StructuredP2Elasticity
    free_ch: torch.Tensor          # [mx, my, mz, 8, 3] valid & free
    fine_diag: torch.Tensor        # [mx, my, mz, 8, 3] Jacobi diagonal
    levels: tuple                  # of P1Level, finest-to-coarsest
    coarse_inv: torch.Tensor | None  # [Ncd, Ncd] dense inverse (grid order)
    lam: tuple                     # per-level lam_max: (P2, *P1 levels)
    nu: int                        # Chebyshev smoothing degree
    _coarse_lu: object = None      # host LU solve, or None

    # -- build ----------------------------------------------------------
    @classmethod
    def build(cls, mesh: FEMMesh, D, fixed_mask=None, *, nu: int = 3,
              dense_cap: int = 4096, dtype=None,
              exact_lambda: bool = False,
              fine_op: StructuredP2Elasticity | None = None,
              device=None) -> "StructuredMG":
        op = fine_op or StructuredP2Elasticity.build(mesh, D, dtype=dtype,
                                                     device=device)
        dt, dev = op.dtype, op.device
        n3 = tuple(int(c) for c in op.n3)
        bb = mesh.bbox()
        h3 = tuple(float(bb.dimensions[a]) / n3[a] for a in range(3))
        shape = (n3[0] + 1, n3[1] + 1, n3[2] + 1, 8, 3)

        free = op.valid_mask().expand(-1, 3)
        if fixed_mask is not None:
            fixed = torch.as_tensor(fixed_mask, device=dev)
            free = op.to_channels((~fixed).to(dt)) * free
        free_ch = free.reshape(shape).contiguous()
        fine_diag = op.diagonal_channels().reshape(shape)

        chain, dense = _level_chain(n3, dense_cap)
        # vertex-level free masks: fine vertices = channel 0 of the P2
        # slots, coarser = even-index subsample (coincident grid points)
        masks = [free_ch[..., 0, :].cpu().numpy()]
        for _ in chain[1:]:
            masks.append(masks[-1][::2, ::2, ::2])
        levels = []
        for ln, m in zip(chain, masks):
            hl = tuple(h3[a] * (n3[a] // ln[a]) for a in range(3))
            levels.append(_p1_level(ln, _p1_cell_stiffness(hl, D), m, dt,
                                    dev))
        Ac, perm = cls._coarse_matrix(chain[-1], h3, n3, D, masks[-1])
        coarse_inv, coarse_lu = _coarse_solver(Ac, masks[-1], perm, dense,
                                               dt, dev)

        # spectral bounds: host row-scaled Gershgorin (lam_max(D^-1 A) <=
        # max_i sum_j |a_ij| / d_i), or power iteration on request
        obj = cls(op, free_ch, fine_diag, tuple(levels), coarse_inv,
                  (1.0,) * (1 + len(levels)), nu, coarse_lu)
        if exact_lambda:
            lam = [obj._lam_max_fine()]
            lam += [obj._lam_max_p1(i) for i in range(len(levels))]
        else:
            lam = [obj._lam_fine_gershgorin()]
            lam += [_p1_gershgorin(lvl) for lvl in levels]
        obj.lam = tuple(lam)
        return obj

    def _lam_fine_gershgorin(self):
        """Row-scaled Gershgorin bound for the P2 level: abs row sums
        assembled like the diagonal (uniform interior per channel minus
        the fake cubes' shell contributions), on the host in f64."""
        op = self.fine
        live = op.slot_node >= 0
        r = op.abs_row_sums_host()[live] \
            / np.maximum(op.diagonal_host()[live], 1e-30)
        return float(r.max()) * 1.02

    @staticmethod
    def _coarse_matrix(nc, h3, n3, D, mask):
        """Masked coarse P1 matrix (scipy sparse, MESH dof ordering) and
        the permutation from grid flat order to mesh dof order."""
        import scipy.sparse as sp

        hi = tuple(h3[a] * n3[a] for a in range(3))
        V, T = generators.grid_tet(*nc, hi=hi)
        cm = FEMMesh(V, T, degree=1)
        A = assembly.assemble_scipy(
            _element_stiffness_host(cm, D, 1), cm.elem_nodes, cm.num_nodes,
            d=3).tocsr()
        # node id -> grid flat index ((x * my + y) * mz + z)
        my, mz = nc[1] + 1, nc[2] + 1
        q = np.round(cm.node_positions / np.asarray(h3) / np.asarray(
            [n3[a] // nc[a] for a in range(3)])).astype(int)
        gid = (q[:, 0] * my + q[:, 1]) * mz + q[:, 2]
        perm_nodes = np.argsort(gid)     # grid order -> node id
        perm = (perm_nodes[:, None] * 3 + np.arange(3)).reshape(-1)
        m = np.asarray(mask, np.float64).reshape(-1)[
            np.argsort(perm)]            # mesh-order mask
        M = sp.diags(m)
        return M @ A @ M + sp.diags(1.0 - m), perm

    def _power_iteration(self, apply, free, diag, iters):
        safe = torch.where(diag > 0, diag, torch.ones_like(diag))
        rng = np.random.default_rng(0)
        v = torch.as_tensor(rng.standard_normal(tuple(free.shape)),
                            dtype=free.dtype, device=free.device) * free
        lam = 1.0
        for _ in range(iters):
            w = (apply(v * free) * free) / safe
            nrm = torch.linalg.norm(w)
            v = w / nrm
            lam = float(nrm)
        return lam * 1.05

    def _lam_max_fine(self, iters: int = 30):
        return self._power_iteration(self.fine.apply_channels, self.free_ch,
                                     self.fine_diag, iters)

    def _lam_max_p1(self, i, iters: int = 30):
        lvl = self.levels[i]
        return self._power_iteration(lvl.apply, lvl.free, lvl.diag, iters)

    # -- the cycle ------------------------------------------------------
    def _coarse_apply(self, r):
        lvl = self.levels[-1]
        r = r * lvl.free
        if self.coarse_inv is not None:
            flat = self.coarse_inv.to(r.dtype) @ r.reshape(-1)
            return flat.reshape(r.shape) * lvl.free
        x = self._coarse_lu(r.cpu().numpy())
        return torch.as_tensor(x, dtype=r.dtype, device=r.device) * lvl.free

    def precondition(self, r):
        """Channel residual [mx, my, mz, 8, 3] -> correction (one symmetric
        V-cycle; linear, SPD on the free subspace)."""
        A = self.fine.apply_channels
        mask = self.free_ch
        S = _chebyshev(A, self.fine_diag, mask, self.lam[0], self.nu)
        r = r * mask
        x = S(r)
        res = r - A(x) * mask
        xc = self._cycle_p1(0, restrict_p2(res) * self.levels[0].free)
        x = x + prolong_p2(xc) * mask
        return x + S(r - A(x) * mask)

    def _cycle_p1(self, i, r):
        lvl = self.levels[i]
        if i == len(self.levels) - 1:
            return self._coarse_apply(r)
        S = _chebyshev(lvl.apply, lvl.diag, lvl.free, self.lam[1 + i],
                       self.nu)
        r = r * lvl.free
        x = S(r)
        res = r - lvl.apply(x) * lvl.free
        nxt = self.levels[i + 1]
        xc = self._cycle_p1(i + 1, restrict_h(res, nxt.n3) * nxt.free)
        x = x + prolong_h(xc, lvl.n3) * lvl.free
        return x + S(r - lvl.apply(x) * lvl.free)

    # -- end-to-end solve ----------------------------------------------
    def solve(self, b, fixed_values=None, tol: float = 1e-10,
              maxiter: int = 500):
        """MG-PCG on nodal b [N, 3]; returns (u [N, 3], CGResult whose x is
        the channel-space solution).  The Dirichlet mask must match the
        one given at build."""
        op = self.fine
        dt, dev = self.free_ch.dtype, self.free_ch.device
        shape = self.free_ch.shape
        bc = op.to_channels(torch.as_tensor(b, dtype=dt, device=dev))
        u_d = None
        if fixed_values is not None:
            valid = op.to_channels(torch.ones((op.num_nodes, 3), dtype=dt,
                                              device=dev))
            u_d = op.to_channels(torch.as_tensor(
                fixed_values, dtype=dt, device=dev)).reshape(shape) \
                * (valid.reshape(shape) - self.free_ch)
        x, iters, resnorm = _mg_pcg(self, bc.reshape(shape), u_d, tol,
                                    maxiter)
        return op.from_channels(x), cg_mod.CGResult(x, iters, resnorm)


def _mg_pcg(mg, bc, u_d, tol, maxiter):
    """MG-PCG core on channel tensors, for both hierarchies (the
    reference's ``_mg_pcg`` and ``_var_mg_pcg``; CG projects the right-hand
    side, so premasking it, as the latter does, changes nothing)."""
    mask = mg.free_ch
    A = mg.fine.apply_channels
    if u_d is not None:
        bc = bc - A(u_d)
    res = cg_mod.cg(A, bc, M_inv=mg.precondition,
                    project=lambda v: v * mask, tol=tol, maxiter=maxiter)
    x = res.x if u_d is None else res.x + u_d
    return x, res.iters, res.resnorm


def _p1_level(n3, Kc, mask, dt, dev):
    """A P1Level from host f64 cell matrices and vertex mask."""
    diag = _p1_diag(n3, Kc)
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    return P1Level(n3, as_t(Kc), as_t(mask), as_t(diag), np.asarray(Kc),
                   diag)


# ---------------------------------------------------------------------------
# Variable-material hierarchy (per-element D, ops/structured_var.py fine
# level).  Nesting is material-independent, so exact Galerkin coarse
# operators exist at every level as per-cell [24, 24] P1 matrices: the
# finest P1 level assembles them per tet, h-coarsening reduces 8 fine cells
# through fixed interpolation matrices T_s (the Kuhn midpoint rule).
# ---------------------------------------------------------------------------

def _p1_cell_matrices_var(mesh, D_elems, device="cpu"):
    """[nx, ny, nz, 24, 24] per-cell P1 stiffness from per-tet materials
    (exact Galerkin restriction of the P2 operator), host f64."""
    n3, h3 = validate_kuhn_grid(mesh)
    nx, ny, nz = n3
    Ke1 = _element_stiffness_host(mesh, D_elems, 1, device)  # [E, 12, 12]
    ncells = len(Ke1) // 6
    # cube-local vertex one-hot from the reference cell
    V1, T1 = generators.grid_tet(1, 1, 1, hi=tuple(h3))
    m1 = FEMMesh(V1, T1, degree=1)
    q = np.round(m1.node_positions / np.asarray(h3)).astype(int)
    vid = np.asarray([_CHANNEL_BITS.index(tuple(b)) for b in q])
    hot = np.zeros((6, 4, 8))
    for t in range(6):
        for a in range(4):
            hot[t, a, vid[m1.elem_nodes[t, a]]] = 1.0
    Kt = Ke1.reshape(ncells, 6, 4, 3, 4, 3)
    Kc = np.einsum("tak,tbl,xtaibj->xkilj", hot, hot, Kt, optimize=True)
    return Kc.reshape(nx, ny, nz, 24, 24)


def _h_reduction_matrices():
    """[8, 24, 24] T_s: coarse cell corner values -> fine subcell s corner
    values (Kuhn midpoint rule), s in _CHANNEL_BITS order."""
    Ts = np.zeros((8, 8, 8))
    for si, s in enumerate(_CHANNEL_BITS):
        for gi, gbits in enumerate(_CHANNEL_BITS):
            p = (np.asarray(s) + np.asarray(gbits)) / 2.0
            u = np.floor(p).astype(int)
            v = np.ceil(p).astype(int)
            Ts[si, gi, _CHANNEL_BITS.index(tuple(u))] += 0.5
            Ts[si, gi, _CHANNEL_BITS.index(tuple(v))] += 0.5
    return np.einsum("sfc,ij->sficj", Ts, np.eye(3)).reshape(8, 24, 24)


def _coarsen_cell_matrices(Kc_f):
    """Per-cell P1 matrices on grid n -> exact Galerkin per-cell matrices
    on grid n/2 (sum over the 8 subcells of T_s^T K T_s)."""
    nx, ny, nz = Kc_f.shape[:3]
    T24 = _h_reduction_matrices()
    Kc = np.zeros((nx // 2, ny // 2, nz // 2, 24, 24))
    for si, s in enumerate(_CHANNEL_BITS):
        sub = Kc_f[s[0]::2, s[1]::2, s[2]::2]
        Kc += np.einsum("fi,xyzfg,gj->xyzij", T24[si], sub, T24[si],
                        optimize=True)
    return Kc


def _coarse_matrix_from_cells(Kc, mask):
    """Scipy CSR of the masked coarsest operator from per-cell [24, 24]
    matrices, in GRID vertex order; plus the identity permutation (the
    assembly is already grid-ordered)."""
    import scipy.sparse as sp

    nx, ny, nz = Kc.shape[:3]
    mx, my, mz = nx + 1, ny + 1, nz + 1
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij"),
                     axis=-1).reshape(-1, 3)
    corners = np.asarray(_CHANNEL_BITS)
    gid = ((cells[:, None, 0] + corners[None, :, 0]) * my
           + (cells[:, None, 1] + corners[None, :, 1])) * mz \
        + (cells[:, None, 2] + corners[None, :, 2])          # [nc, 8]
    dof = (gid[:, :, None] * 3 + np.arange(3)).reshape(-1, 24)
    rows = np.repeat(dof, 24, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 24)).reshape(-1)
    vals = np.asarray(Kc, np.float64).reshape(-1)
    N = mx * my * mz * 3
    A = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    m = np.asarray(mask, np.float64).reshape(-1)
    M = sp.diags(m)
    return (M @ A @ M + sp.diags(1.0 - m)).tocsr(), np.arange(N)


class VarStructuredMG(StructuredMG):
    """V-cycle preconditioner and solver for PER-ELEMENT materials on Kuhn
    grids: the fine level is ``ops/structured_var.StructuredVarP2Elasticity``
    and every coarse level carries exact-Galerkin per-cell [24, 24]
    matrices.  The cycle and the solve are StructuredMG's."""

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, fixed_mask=None, *,
              nu: int = 3, dense_cap: int = 4096, dtype=None,
              Kc_fine=None, device=None) -> "VarStructuredMG":
        """``Kc_fine``: precomputed ``_p1_cell_matrices_var(mesh,
        D_elems)`` (shared across builds that differ only in the mask)."""
        from .structured_var import StructuredVarP2Elasticity

        op = StructuredVarP2Elasticity.build(mesh, D_elems, dtype=dtype,
                                             device=device)
        dt, dev = op.dtype, op.device
        n3 = tuple(int(c) for c in op.n3)

        free = op.valid_mask_channels().expand(-1, -1, -1, -1, 3)
        if fixed_mask is not None:
            fixed = torch.as_tensor(fixed_mask, device=dev)
            free = op.to_channels((~fixed).to(dt)) * free
        free_ch = free.contiguous()
        fine_diag = op.diagonal_channels()

        chain, dense = _level_chain(n3, dense_cap)
        masks = [free_ch[..., 0, :].cpu().numpy()]
        for _ in chain[1:]:
            masks.append(masks[-1][::2, ::2, ::2])
        Kc = (Kc_fine if Kc_fine is not None
              else _p1_cell_matrices_var(mesh, D_elems, dev))
        levels = []
        for li, (ln, m) in enumerate(zip(chain, masks)):
            if li > 0:
                Kc = _coarsen_cell_matrices(Kc)
            levels.append(_p1_level(ln, Kc, m, dt, dev))
        Ac, perm = _coarse_matrix_from_cells(levels[-1].Kc64, masks[-1])
        coarse_inv, coarse_lu = _coarse_solver(Ac, masks[-1], perm, dense,
                                               dt, dev)
        obj = cls(op, free_ch, fine_diag, tuple(levels), coarse_inv,
                  (1.0,) * (1 + len(levels)), nu, coarse_lu)
        obj.lam = tuple([obj._lam_fine_gershgorin()]
                        + [_p1_gershgorin(lvl) for lvl in levels])
        return obj

    def _lam_fine_gershgorin(self):
        """Row-scaled Gershgorin: abs row-sum bound assembled per tet,
        |Ke| row sums bounded by |B|^T |SDS| |B| 1 (triangle inequality);
        f64 on the operator's device."""
        op = self.fine
        nx, ny, nz = op.n3
        f64 = torch.float64
        aB = op.B.to(f64).abs()
        aS = op.SDS.to(f64).abs().reshape(nx, ny, nz, 6, op.SDS.shape[-2],
                                          op.SDS.shape[-1])
        z = torch.einsum("tqanc->tqa", aB)
        rs_tet = torch.einsum("tqanc,xyztab,tqb->xyztnc",
                              aB * op.wv.to(f64)[:, :, None, None, None],
                              aS, z)
        rs27 = torch.einsum("tak,xyztac->xyzkc", op.tet_slot.to(f64),
                            rs_tet)
        rs = op._scatter_cells(rs27, f64, 3).cpu().numpy()
        diag = self.fine_diag.to(f64).cpu().numpy()
        r = rs / np.maximum(diag, 1e-30)
        r = np.where(diag > 0, r, 0.0)        # dead slots excluded
        return float(r.max()) * 1.02
