"""2D pixel-cell periodic structured path: plane homogenization on tori.

Counterpart of ``meshfem_tpu/ops/structured_periodic2d.py``, the 2D mirror
of ``ops/structured_periodic.py`` for PIXEL design cells
(``grid_tri(n, n, diagonal="right")``): each pixel is two right triangles
sharing the (1,0)-(0,1) anti-diagonal, the periodic P2 dof space is an
[n, n, 4, 2] channel torus (4 half-grid parity classes), element
stiffnesses factor through one fixed [2*Q*3, 18] strain matrix with
per-triangle [3, 3] materials, and the exact-Galerkin multigrid chain
(P2 -> P1 -> dyadic P1 tori, per-pixel [8, 8] matrices) mirrors 3D: the
midpoint rule reads each class's true edge endpoints (the (1,1) half-grid
point is the ANTI-diagonal's midpoint).

Vectors may carry a trailing column axis ([n, n, 4, 2, m] on the fine
level, [n, n, 2, m] below): the block solve of the 3 cell problems runs ONE
apply and ONE V-cycle for all columns.  The reference computes all of this
in XLA outside any Pallas kernel; here the products are ``torch.matmul``
in the operator's dtype (float64 for cell problems, TF32 off).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..fem import quadrature
from ..fem.flattening import flat_len, shear_doubler
from ..mesh import generators
from ..mesh.femmesh import FEMMesh
from ..solvers import cg as cg_mod
from . import element_matrices as em
from .structured_mg import _chebyshev, _element_stiffness_host
from .structured_periodic import (_coarse_matrix_torus,
                                  _coarse_matrix_torus_sparse,
                                  _roll, _torus_gershgorin, _torus_p1_diag,
                                  _with_columns, _wrap_fold, _wrap_pad)

_BITS2 = [(0, 0), (1, 0), (0, 1), (1, 1)]
# edge endpoints (corner offsets of the owning pixel) of each nonzero
# midpoint class; the split uses the ANTI-diagonal (1,0)-(0,1), so the
# (1,1) half-grid point is its midpoint
_EDGE2 = {1: ((0, 0), (1, 0)),
          2: ((0, 0), (0, 1)),
          3: ((1, 0), (0, 1))}


def validate_pixel_grid(mesh: FEMMesh):
    """(n2, h2) for a right-diagonal triangulated P2 pixel grid; raises
    ValueError otherwise (counts, lattice positions, uniform diagonal)."""
    if mesh.K != 2 or mesh.degree != 2:
        raise ValueError("2D structured path supports P2 triangles")
    bb = mesh.bbox()
    Vv = np.asarray(mesh.V)
    n2 = tuple(len(np.unique(np.round(Vv[:, a], 9))) - 1 for a in range(2))
    if min(n2) < 1:
        raise ValueError("not a pixel grid (degenerate axis)")
    h2 = tuple(float(bb.dimensions[a]) / n2[a] for a in range(2))
    nv2 = np.asarray(n2)
    if mesh.num_vertices != int(np.prod(nv2 + 1)) \
            or mesh.num_elements != 2 * int(np.prod(nv2)):
        raise ValueError("not a pixel grid (count mismatch)")
    q = (Vv - np.asarray(bb.min)) / np.asarray(h2)
    qi = np.round(q)
    if np.abs(q - qi).max() > 1e-6:
        raise ValueError("not a pixel grid (vertices off lattice)")
    tq = qi[np.asarray(mesh.F)].astype(np.int64)
    bits = tq - tq.min(axis=1, keepdims=True)
    if bits.min() < 0 or bits.max() > 1:
        raise ValueError("not a pixel grid (element spans cells)")
    # uniform anti-diagonal split: corner sets {00, 10, 01}, {10, 11, 01}
    keys = np.sort(bits[:, :, 0] * 2 + bits[:, :, 1], axis=1)
    ok = ((keys == np.asarray([0, 1, 2])).all(axis=1)
          | (keys == np.asarray([1, 2, 3])).all(axis=1))
    if not ok.all():
        raise ValueError("not a uniform pixel grid (use "
                         "grid_tri(..., diagonal='right'))")
    return n2, h2


def check_pixel_element_order(mesh, n2, h2):
    """Raise unless elements are in grid_tri order (pixel-major C-order, 2
    reference triangle slots per pixel): the per-element material pairing
    depends on it."""
    bb = mesh.bbox()
    q = np.round((np.asarray(mesh.V) - np.asarray(bb.min))
                 / np.asarray(h2)).astype(np.int64)
    tq = q[np.asarray(mesh.F)]
    cmin = tq.min(axis=1)
    cidx = cmin[:, 0] * n2[1] + cmin[:, 1]
    E = len(tq)
    if not np.array_equal(cidx, np.repeat(np.arange(E // 2), 2)):
        raise ValueError("elements are not in grid_tri order (pixel-"
                         "major C-order)")
    bits = tq - cmin[:, None, :]
    keys = np.sort(bits[:, :, 0] * 2 + bits[:, :, 1], axis=1)
    Vr, Tr = generators.grid_tri(1, 1, diagonal="right")
    qr = np.round(Vr).astype(np.int64)[Tr]
    ref = np.sort(qr[:, :, 0] * 2 + qr[:, :, 1], axis=1)
    if not np.array_equal(keys.reshape(E // 2, 2, 3),
                          np.broadcast_to(ref, (E // 2, 2, 3))):
        raise ValueError("pixel-local triangle slots do not match the "
                         "grid_tri reference pattern order")


def _pixel_reference(h2):
    """One pixel, P2: (slots [(offset, channel)] per pixel node, Bc
    [2*Q*3, 18] corner values -> per-triangle quadrature strains, wv [2, Q]
    weight * area), numpy float64."""
    V, T = generators.grid_tri(1, 1, hi=tuple(h2), diagonal="right")
    mesh = FEMMesh(V, T, degree=2)
    assert mesh.num_nodes == 9
    g = mesh.geometry("cpu")
    q = np.round(mesh.node_positions / (np.asarray(h2) / 2)).astype(int)
    slots = [(tuple(q[i] // 2), _BITS2.index(tuple(q[i] % 2)))
             for i in range(9)]
    pts, w = quadrature.rule_np(2, 2)
    B = em.element_strain_matrix(g.grad_lambda, 2, pts).numpy()
    wv = np.asarray(w)[None, :] * g.volume.numpy()[:, None]
    hot = np.zeros((2, 6, 9))
    for t in range(2):
        for a in range(6):
            hot[t, a, mesh.elem_nodes[t, a]] = 1.0
    Q = B.shape[1]
    Bc = np.einsum("tqanc,tnk->tqakc", B, hot).reshape(
        2 * Q * flat_len(2), 18)
    return slots, Bc, wv


def _project_translations2d(v):
    """Per-column mean over the torus axes (pixels and channels): removes
    the two translations from a channel field [n, n, 4, 2(, m)]."""
    return v - v.mean(dim=(0, 1, 2), keepdim=True)


@dataclasses.dataclass
class PeriodicVarP2Elasticity2D:
    """2D P2 plane elasticity with per-triangle materials on the periodic
    pixel grid; vectors are [n, n, 4, 2(, m)] channel tori."""

    n2: tuple
    SDS: torch.Tensor       # [npix, 2, 3, 3]
    Bc: torch.Tensor        # [2*Q*3, 18]
    wv: torch.Tensor        # [2, Q]
    dof_slot: torch.Tensor  # [Nd] -> flat torus channel index
    num_dofs: int
    slots: list             # [9] (corner offset, channel) per pixel node

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, dof_map, dtype=None,
              device=None) -> "PeriodicVarP2Elasticity2D":
        """D_elems [E, 3, 3] in grid_tri element order; dof_map [N] the
        periodic node -> dof map.  Raises ValueError off-grid, for a
        reordered grid, or when the dofs do not tile the torus."""
        n2, h2 = validate_pixel_grid(mesh)
        check_pixel_element_order(mesh, n2, h2)
        dev = config.resolve_device(device)
        dt = dtype or config.REAL
        fl = flat_len(2)
        slots, Bc, wv = _pixel_reference(h2)
        npix = mesh.num_elements // 2
        S = torch.as_tensor(shear_doubler(2), dtype=config.REAL, device=dev)
        D = torch.as_tensor(D_elems, dtype=config.REAL, device=dev).reshape(
            npix, 2, fl, fl)
        SDS = S[:, None] * D * S[None, :]

        bb = mesh.bbox()
        dof_map = np.asarray(dof_map)
        Nd = int(dof_map.max()) + 1
        first = np.zeros(Nd, np.int64)
        uniq, firsts = np.unique(dof_map, return_index=True)
        first[uniq] = firsts
        qn = np.round((mesh.node_positions[first] - np.asarray(bb.min))
                      / (np.asarray(h2) / 2)).astype(np.int64)
        owner = (qn // 2) % np.asarray(n2)
        bits = qn % 2
        ch = bits[:, 0] + 2 * bits[:, 1]           # _BITS2 order
        nx, ny = n2
        dof_slot = (owner[:, 0] * ny + owner[:, 1]) * 4 + ch
        if not len(np.unique(dof_slot)) == Nd == nx * ny * 4:
            raise ValueError("periodic dof space does not tile the 2D "
                             "torus")
        as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        return cls(tuple(int(c) for c in n2), SDS.to(dt), as_t(Bc),
                   as_t(wv), torch.as_tensor(dof_slot, device=dev), Nd,
                   slots)

    @property
    def dtype(self) -> torch.dtype:
        return self.SDS.dtype

    @property
    def device(self) -> torch.device:
        return self.SDS.device

    # -- dof space <-> channel space -------------------------------------
    def to_channels(self, u):
        """[Nd, 2(, m)] -> [n, n, 4, 2(, m)]."""
        nx, ny = self.n2
        z = u.new_zeros((nx * ny * 4,) + tuple(u.shape[1:]))
        z[self.dof_slot] = u
        return z.reshape((nx, ny, 4) + tuple(u.shape[1:]))

    def from_channels(self, ch):
        return ch.reshape((-1,) + tuple(ch.shape[3:]))[self.dof_slot]

    # -- the apply ---------------------------------------------------------
    def _gather_cells(self, ch):
        """[n, n, 4, 2, m] -> [n, n, m, 9, 2] pixel node values (9 wrapped
        slices, the column axis before the nodes)."""
        nx, ny = self.n2
        w = _wrap_pad(ch, 2)
        return torch.stack([w[o[0]:o[0] + nx, o[1]:o[1] + ny, c]
                            .movedim(-1, 2) for o, c in self.slots], dim=3)

    def _scatter_cells(self, f9, dtype):
        """Adjoint of :meth:`_gather_cells`: [n, n, m, 9, 2] ->
        [n, n, 4, 2, m]."""
        nx, ny = self.n2
        m = f9.shape[2]
        out = f9.new_zeros((nx + 1, ny + 1, 4, 2, m), dtype=dtype)
        for k, (o, c) in enumerate(self.slots):
            out[o[0]:o[0] + nx, o[1]:o[1] + ny, c] += \
                f9[:, :, :, k].movedim(2, -1)
        return _wrap_fold(out, 2)

    def apply_channels(self, ch):
        """A u on channel tensors [n, n, 4, 2] or [n, n, 4, 2, m]: wrapped
        slices -> ONE [np*m, 18] @ Bc^T product -> the per-(pixel,
        triangle) [3, 3] stress products -> ONE @ Bc product -> slice adds
        and the fold."""
        block = ch.dim() == 5
        if not block:
            ch = ch.unsqueeze(-1)
        nx, ny = self.n2
        nc = nx * ny
        m = ch.shape[-1]
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        dt = ch.dtype
        Bc = self.Bc.to(dt)
        u9 = self._gather_cells(ch).reshape(nc * m, 18)
        strain = (u9 @ Bc.t()).reshape(nc, m, 2, Q, fl)
        stress = torch.matmul(strain,
                              self.SDS.to(dt).transpose(-1, -2)[:, None]) \
            * self.wv.to(dt)[:, :, None]
        f9 = (stress.reshape(nc * m, 2 * Q * fl) @ Bc).reshape(
            nx, ny, m, 9, 2)
        out = self._scatter_cells(f9, dt)
        return out if block else out[..., 0]

    def __call__(self, u):
        """A u for periodic-dof fields [Nd, 2(, m)]."""
        return self.from_channels(self.apply_channels(self.to_channels(u)))

    def diagonal_channels(self):
        """Assembled diagonal on the torus [n, n, 4, 2]."""
        nx, ny = self.n2
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        Bq = self.Bc.reshape(2, Q, fl, 9, 2)
        G = torch.einsum("tqakc,tqbkc->tabkc",
                         Bq * self.wv[:, :, None, None, None], Bq)
        d9 = torch.einsum("xtab,tabkc->xkc", self.SDS, G)
        return self._scatter_cells(d9.reshape(nx, ny, 1, 9, 2),
                                   self.dtype)[..., 0]

    def abs_row_sums_channels(self):
        """Row-sum bound of |A| assembled per triangle (float64): |Ke| row
        sums bounded by |B|^T |SDS| |B| 1."""
        nx, ny = self.n2
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        f64 = torch.float64
        aB = self.Bc.to(f64).abs().reshape(2, Q, fl, 9, 2)
        z = torch.einsum("tqakc->tqa", aB)
        H = torch.einsum("tqakc,tqb->tabkc",
                         aB * self.wv.to(f64)[:, :, None, None, None], z)
        rs9 = torch.einsum("xtab,tabkc->xkc", self.SDS.to(f64).abs(), H)
        return self._scatter_cells(rs9.reshape(nx, ny, 1, 9, 2),
                                   f64)[..., 0]


# ---------------------------------------------------------------------------
# Torus P1 levels + transfers (2D)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TorusP1Level2D:
    """P1 level on the n^2 torus with per-pixel [8, 8] matrices."""

    n2: tuple
    Kc: torch.Tensor        # [nx, ny, 8, 8]
    diag: torch.Tensor      # [nx, ny, 2]
    Kc64: np.ndarray        # Kc in float64 on the host (bounds, coarse)

    def apply(self, v):
        """v [n, n, 2] or [n, n, 2, m]."""
        block = v.dim() == 4
        if not block:
            v = v.unsqueeze(-1)
        nx, ny = self.n2
        w = _wrap_pad(v, 2)
        cell = torch.cat([w[bx:bx + nx, by:by + ny] for bx, by in _BITS2],
                         dim=2)
        f = torch.matmul(self.Kc.to(v.dtype), cell)     # [n, n, 8, m]
        out = v.new_zeros((nx + 1, ny + 1) + tuple(v.shape[2:]))
        for i, (bx, by) in enumerate(_BITS2):
            out[bx:bx + nx, by:by + ny] += f[:, :, 2 * i:2 * i + 2]
        out = _wrap_fold(out, 2)
        return out if block else out[..., 0]


def _p1_cell_matrices_var2d(mesh, D_elems, device="cpu"):
    """[nx, ny, 8, 8] per-pixel P1 stiffness from per-triangle materials
    (exact Galerkin restriction of the P2 operator), host float64."""
    n2, h2 = validate_pixel_grid(mesh)
    Ke1 = _element_stiffness_host(mesh, D_elems, 1, device)   # [E, 6, 6]
    npix = len(Ke1) // 2
    V1, T1 = generators.grid_tri(1, 1, hi=tuple(h2), diagonal="right")
    m1 = FEMMesh(V1, T1, degree=1)
    q = np.round(m1.node_positions / np.asarray(h2)).astype(int)
    vid = np.asarray([_BITS2.index(tuple(b)) for b in q])
    hot = np.zeros((2, 3, 4))
    for t in range(2):
        for a in range(3):
            hot[t, a, vid[m1.elem_nodes[t, a]]] = 1.0
    Kt = Ke1.reshape(npix, 2, 3, 2, 3, 2)
    Kc = np.einsum("tak,tbl,xtaibj->xkilj", hot, hot, Kt, optimize=True)
    return Kc.reshape(n2[0], n2[1], 8, 8)


def _h_reduction_2d():
    """[4, 8, 8] T_s: coarse pixel corner values -> fine subpixel s corner
    values (the midpoint rule on each class's true edge)."""
    Ts = np.zeros((4, 4, 4))
    for si, s in enumerate(_BITS2):
        for gi, gb in enumerate(_BITS2):
            p = np.asarray(s) + np.asarray(gb)      # in half-steps: 0..2
            half = p % 2 == 1
            if not half.any():                      # lattice point
                Ts[si, gi, _BITS2.index(tuple(p // 2))] += 1.0
                continue
            base = p // 2
            if half.all():                          # anti-diagonal midpoint
                u = base + np.asarray((1, 0))
                v = base + np.asarray((0, 1))
            else:                                   # axis edge midpoint
                u = base
                v = base + half.astype(int)
            Ts[si, gi, _BITS2.index(tuple(u))] += 0.5
            Ts[si, gi, _BITS2.index(tuple(v))] += 0.5
    return np.einsum("sfc,ij->sficj", Ts, np.eye(2)).reshape(4, 8, 8)


def _coarsen_2d(Kc_f):
    """Per-pixel P1 matrices on grid n -> the exact Galerkin ones on grid
    n/2 (sum over the 4 subpixels of T_s^T K T_s)."""
    nx, ny = Kc_f.shape[:2]
    T8 = _h_reduction_2d()
    Kc = np.zeros((nx // 2, ny // 2, 8, 8))
    for si, s in enumerate(_BITS2):
        sub = Kc_f[s[0]::2, s[1]::2]
        Kc += np.einsum("fi,xyfg,gj->xyij", T8[si], sub, T8[si],
                        optimize=True)
    return Kc


def torus2d_prolong_p2(v):
    """Torus vertex field [n, n, 2(, m)] -> channels [n, n, 4, 2(, m)]:
    class i gets the mean of its edge's two endpoint values."""
    chs = [v]
    for i in (1, 2, 3):
        ea, eb = _EDGE2[i]
        chs.append(0.5 * (_roll(v, ea, +1) + _roll(v, eb, +1)))
    return torch.stack(chs, dim=2)


def torus2d_restrict_p2(u):
    """Adjoint of :func:`torus2d_prolong_p2`."""
    out = u[:, :, 0]
    for i in (1, 2, 3):
        ea, eb = _EDGE2[i]
        ub = u[:, :, i]
        out = out + 0.5 * (_roll(ub, ea, -1) + _roll(ub, eb, -1))
    return out


def torus2d_prolong_h(vc):
    """Torus (mx, my) -> torus (2mx, 2my) by the same midpoint rule."""
    mx, my = vc.shape[:2]
    rest = tuple(vc.shape[2:])
    classes = []
    for bx in (0, 1):
        for by in (0, 1):
            if bx == by == 0:
                classes.append(vc)
            else:
                ea, eb = _EDGE2[_BITS2.index((bx, by))]
                classes.append(0.5 * (_roll(vc, ea, +1)
                                      + _roll(vc, eb, +1)))
    z = torch.stack(classes, dim=0).reshape((2, 2, mx, my) + rest)
    tail = tuple(range(4, 4 + len(rest)))
    return z.permute((2, 0, 3, 1) + tail).reshape((2 * mx, 2 * my) + rest)


def torus2d_restrict_h(rf):
    """Adjoint of :func:`torus2d_prolong_h`."""
    mx, my = rf.shape[0] // 2, rf.shape[1] // 2
    rest = tuple(rf.shape[2:])
    tail = tuple(range(4, 4 + len(rest)))
    z = rf.reshape((mx, 2, my, 2) + rest).permute((1, 3, 0, 2) + tail)
    out = z[0, 0]
    for bx in (0, 1):
        for by in (0, 1):
            if bx == by == 0:
                continue
            ea, eb = _EDGE2[_BITS2.index((bx, by))]
            ub = z[bx, by]
            out = out + 0.5 * (_roll(ub, ea, -1) + _roll(ub, eb, -1))
    return out


# ---------------------------------------------------------------------------
# Periodic variable-material multigrid (2D)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PeriodicVarMG2D:
    """2D torus V-cycle for pixel-cell homogenization (translations
    projected by the caller's CG; the coarsest level's pseudo-inverse, or
    host SuperLU with vertex 0 pinned)."""

    fine: PeriodicVarP2Elasticity2D
    fine_diag: torch.Tensor
    levels: tuple          # of TorusP1Level2D
    coarse_inv: torch.Tensor | None
    lam: tuple
    nu: int
    _coarse_lu: object = None

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, dof_map, *, nu: int = 3,
              dense_cap: int = 4096, dtype=None,
              device=None) -> "PeriodicVarMG2D":
        op = PeriodicVarP2Elasticity2D.build(mesh, D_elems, dof_map,
                                             dtype=dtype, device=device)
        dt, dev = op.dtype, op.device
        n2 = op.n2
        fine_diag = op.diagonal_channels()

        def dofs(nn):
            return nn[0] * nn[1] * 2

        chain = [n2]
        while (all(c % 2 == 0 for c in chain[-1]) and min(chain[-1]) >= 4
               and dofs(chain[-1]) > dense_cap):
            chain.append(tuple(c // 2 for c in chain[-1]))

        Kc = _p1_cell_matrices_var2d(mesh, D_elems, dev)
        levels = []
        for li, ln in enumerate(chain):
            if li > 0:
                Kc = _coarsen_2d(Kc)
            diag = _torus_p1_diag(ln, Kc, _BITS2)
            levels.append(TorusP1Level2D(
                ln, torch.as_tensor(Kc, dtype=dt, device=dev),
                torch.as_tensor(diag, dtype=dt, device=dev), np.asarray(Kc)))

        Kc_last = levels[-1].Kc64
        Ncd = dofs(levels[-1].n2)
        coarse_inv = coarse_lu = None
        if Ncd <= dense_cap:
            Ac = _coarse_matrix_torus(Kc_last, _BITS2)
            coarse_inv = torch.as_tensor(np.linalg.pinv(Ac, hermitian=True),
                                         dtype=dt, device=dev)
        else:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            Ac = sp.csr_matrix(_coarse_matrix_torus_sparse(Kc_last, _BITS2))
            m = np.ones(Ncd)
            m[:2] = 0.0                    # pin vertex 0 (translations)
            M = sp.diags(m)
            lu = spla.splu((M @ Ac @ M + sp.diags(1.0 - m)).tocsc())

            def coarse_lu(r):
                flat = r.reshape(Ncd, -1) * m[:, None]
                return (lu.solve(flat) * m[:, None]).reshape(r.shape)

        obj = cls(op, fine_diag, tuple(levels), coarse_inv,
                  (1.0,) * (1 + len(levels)), nu, coarse_lu)
        obj.lam = tuple([obj._lam_fine()]
                        + [_torus_gershgorin(lvl.n2, lvl.Kc64, lvl.diag,
                                             _BITS2) for lvl in levels])
        return obj

    def _lam_fine(self):
        """Row-scaled Gershgorin bound on lam_max(D^-1 A) for the P2 level
        (float64)."""
        rs = self.fine.abs_row_sums_channels().cpu().numpy()
        diag = self.fine_diag.to(torch.float64).cpu().numpy()
        r = rs / np.maximum(diag, 1e-30)
        return float(np.where(diag > 0, r, 0.0).max()) * 1.02

    def _coarse_apply(self, r):
        if self.coarse_inv is not None:
            flat = r.reshape(self.coarse_inv.shape[0], -1)
            return (self.coarse_inv.to(r.dtype) @ flat).reshape(r.shape)
        x = self._coarse_lu(r.cpu().numpy().astype(np.float64))
        return torch.as_tensor(x, dtype=r.dtype, device=r.device)

    def _cycle(self, i, r):
        lvl = self.levels[i]
        if i == len(self.levels) - 1:
            return self._coarse_apply(r)
        one = torch.ones((), dtype=r.dtype, device=r.device)
        S = _chebyshev(lvl.apply, _with_columns(lvl.diag, r).to(
            r.dtype), one, self.lam[1 + i], self.nu)
        x = S(r)
        res = r - lvl.apply(x)
        xc = self._cycle(i + 1, torus2d_restrict_h(res))
        x = x + torus2d_prolong_h(xc)
        return x + S(r - lvl.apply(x))

    def precondition(self, r_ch):
        """Torus channel residual [n, n, 4, 2(, m)] -> correction (one
        symmetric V-cycle, all columns at once)."""
        A = self.fine.apply_channels
        one = torch.ones((), dtype=r_ch.dtype, device=r_ch.device)
        S = _chebyshev(A, _with_columns(self.fine_diag, r_ch).to(
            r_ch.dtype), one, self.lam[0], self.nu)
        x = S(r_ch)
        res = r_ch - A(x)
        xc = self._cycle(0, torus2d_restrict_p2(res))
        x = x + torus2d_prolong_p2(xc)
        return x + S(r_ch - A(x))


def _periodic2d_mg_cg_block(mg, Bc, tol, maxiter):
    """All columns of ``Bc [n, n, 4, 2, m]`` in ONE block CG: the torus
    operator and the V-cycle take the trailing column axis as it lies."""
    return cg_mod.cg_block(mg.fine.apply_channels,
                           _project_translations2d(Bc),
                           M_inv=mg.precondition,
                           project=_project_translations2d, tol=tol,
                           maxiter=maxiter)


def solve_cell_problems_grid2d(sim, mg: PeriodicVarMG2D | None = None,
                               tol: float = 1e-10, maxiter: int = 300):
    """2D pixel-grid cell problems: the 3 right-hand sides in ONE block CG
    with the torus V-cycle, in ``sim.Ke``'s dtype on ``sim``'s device.
    Returns (w [3, N, 2], iters list)."""
    from ..analysis.homogenization import _cell_loads

    fl = flat_len(2)
    if mg is None:
        D = sim.D
        if D.dim() == 2:
            D = D.expand((sim.mesh.num_elements,) + tuple(D.shape))
        mg = PeriodicVarMG2D.build(sim.mesh, D, sim.dof_map,
                                   dtype=sim.Ke.dtype, device=sim.device)
    res = _periodic2d_mg_cg_block(mg, mg.fine.to_channels(_cell_loads(sim)),
                                  tol, maxiter)
    w = mg.fine.from_channels(res.x).movedim(-1, 0)[:, sim._dof_map_t]
    return w, [int(res.iters)] * fl
