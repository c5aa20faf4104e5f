"""Periodic (torus) structured path: homogenization cells on Kuhn grids.

Counterpart of ``meshfem_tpu/ops/structured_periodic.py`` (3D).  Periodic
homogenization of voxel or grid microstructure cells identifies opposite
faces, which turns the (n+1)^3-vertex grid into an n^3 TORUS: every P2 dof
is exactly one (cell, channel) slot of an [n, n, n, 8, 3] channel tensor,
and the per-element-material cell operator (``ops/structured_var.py``)
needs only WRAPPED corner slices: the channel tensor is padded by its own
first plane on each axis (``_wrap_pad``) and the adjoint folds the extra
planes back (``_wrap_fold``).  The exact-Galerkin multigrid hierarchy of
``ops/structured_mg.py`` carries over unchanged: torus transfers are rolls,
every coarser torus is again a torus, and the only nullspace is the three
translations (projected in the outer CG by a per-column mean; the coarsest
level's dense pseudo-inverse, or host SuperLU with three pinned dofs).

Vectors may carry a trailing column axis ([n, n, n, 8, 3, m] on the fine
level, [n, n, n, 3, m] below): the block solve of the fl cell problems
runs ONE apply and ONE V-cycle for all columns, so the per-cell materials
and the strain matrix are read once per apply, not once per column.  The
products are ``torch.matmul`` in the operator's dtype (float64 for cell
problems); TF32 stays off (``config.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..fem.flattening import flat_len, shear_doubler
from ..mesh.femmesh import FEMMesh
from ..solvers import cg as cg_mod
from .structured import _CHANNEL_BITS, validate_kuhn_grid
from .structured_mg import (_chebyshev, _coarsen_cell_matrices,
                            _p1_cell_matrices_var)
from .structured_var import _cube_reference, check_grid_element_order


def _wrap_pad(ch, nax: int = 3):
    """Append the first slab after the last along the ``nax`` leading
    (torus) axes."""
    for ax in range(nax):
        ch = torch.cat([ch, ch.narrow(ax, 0, 1)], dim=ax)
    return ch


def _wrap_fold(padded, nax: int = 3):
    """Adjoint of :func:`_wrap_pad`: fold the overflow slabs back, the
    last torus axis first."""
    p = padded.clone()
    for ax in reversed(range(nax)):
        p.narrow(ax, 0, 1).add_(p.narrow(ax, p.shape[ax] - 1, 1))
        p = p.narrow(ax, 0, p.shape[ax] - 1)
    return p


def _corner_assemble(per_corner, corners):
    """Host (numpy) torus assembly: per-cell corner values ``[*n, len(
    corners), d]`` -> the field ``[*n, d]``, corner ``b`` of cell ``c``
    added at ``c + b`` wrapped (the last torus axis folded first)."""
    nax = len(corners[0])
    n = per_corner.shape[:nax]
    out = np.zeros(tuple(c + 1 for c in n) + per_corner.shape[-1:])
    for i, b in enumerate(corners):
        out[tuple(slice(o, o + c) for o, c in zip(b, n))] += \
            per_corner[..., i, :]
    for ax in reversed(range(nax)):
        lead = (slice(None),) * ax
        out[lead + (0,)] += out[lead + (-1,)]
        out = out[lead + (slice(0, -1),)]
    return out


def _coarse_dofs(Kc, corners):
    """Per-cell dof lists of a torus P1 level with per-cell matrices ``Kc
    [*n, B, B]``: ([ncells, B] dof ids, dof count), dofs ``node * d + c``
    with nodes numbered C-order on the torus."""
    nax = len(corners[0])
    n = Kc.shape[:nax]
    cells = np.stack(np.meshgrid(*[np.arange(c) for c in n], indexing="ij"),
                     axis=-1).reshape(-1, nax)
    wrapped = (cells[:, None, :] + np.asarray(corners)[None]) % np.asarray(n)
    gid = np.ravel_multi_index(tuple(wrapped[..., a] for a in range(nax)), n)
    return ((gid[:, :, None] * nax + np.arange(nax))
            .reshape(-1, len(corners) * nax), int(np.prod(n)) * nax)


def _coarse_matrix_torus_sparse(Kc, corners):
    """Scipy COO of the torus P1 operator from per-cell matrices."""
    import scipy.sparse as sp

    dof, N = _coarse_dofs(Kc, corners)
    B = dof.shape[1]
    rows = np.repeat(dof, B, axis=1).reshape(-1)
    cols = np.tile(dof, (1, B)).reshape(-1)
    vals = np.asarray(Kc, np.float64).reshape(-1)
    return sp.coo_matrix((vals, (rows, cols)), shape=(N, N))


def _coarse_matrix_torus(Kc, corners):
    """Dense torus P1 operator (host, float64), summed cell by cell."""
    dof, N = _coarse_dofs(Kc, corners)
    B = dof.shape[1]
    A = np.zeros((N, N))
    Kf = np.asarray(Kc, np.float64).reshape(-1, B, B)
    for c in range(len(dof)):
        A[np.ix_(dof[c], dof[c])] += Kf[c]
    return A


def _torus_p1_diag(n, Kc, corners=_CHANNEL_BITS):
    """Assembled diagonal of the torus P1 operator (host, float64)."""
    kd = np.diagonal(np.asarray(Kc), axis1=-2, axis2=-1).reshape(
        tuple(n) + (len(corners), len(n)))
    return _corner_assemble(kd, corners)


def _torus_gershgorin(n, Kc64, diag, corners=_CHANNEL_BITS) -> float:
    """Row-scaled Gershgorin bound for a torus P1 level (host, float64)."""
    rs = _corner_assemble(np.abs(Kc64).sum(axis=-1).reshape(
        tuple(n) + (len(corners), len(n))), corners)
    diag = diag.to(torch.float64).cpu().numpy()
    return float((rs / np.maximum(diag, 1e-30)).max()) * 1.02


def _with_columns(t, r):
    """``t`` with a trailing axis when ``r`` is a block of columns (one
    axis more than ``t``)."""
    return t[..., None] if r.dim() > t.dim() else t


def _project_translations(v):
    """Per-column mean over the torus axes (cells and channels): removes
    the three translations from a channel field [n, n, n, 8, 3(, m)]."""
    return v - v.mean(dim=(0, 1, 2, 3), keepdim=True)


@dataclasses.dataclass
class PeriodicVarP2Elasticity:
    """P2 elasticity with per-tet materials on the PERIODIC Kuhn grid.

    Vectors are torus channel tensors [n, n, n, 8, 3] (or [..., m] for a
    block); ``to_channels`` / ``from_channels`` convert periodic-dof fields
    [Nd, 3(, m)] (the dof space of ``periodic_simulator`` on a grid
    mesh)."""

    n3: tuple
    SDS: torch.Tensor       # [ncells, 6, fl, fl]
    Bc: torch.Tensor        # [6*Q*fl, 81]
    wv: torch.Tensor        # [6, Q]
    dof_slot: torch.Tensor  # [Nd] -> flat torus channel index
    num_dofs: int
    slots: list             # [27] (corner offset, channel) per cube node

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, dof_map, dtype=None,
              device=None) -> "PeriodicVarP2Elasticity":
        """D_elems [E, fl, fl] in grid_tet element order; dof_map [N] the
        periodic node -> dof map.  Raises ValueError off-grid, for a
        reordered grid, or when the dofs do not tile the torus."""
        n3, h3 = validate_kuhn_grid(mesh)
        check_grid_element_order(mesh, n3, h3)
        dev = config.resolve_device(device)
        dt = dtype or config.REAL
        fl = flat_len(3)
        slots, tet_nodes, B, wv = _cube_reference(h3)
        ncells = mesh.num_elements // 6
        S = torch.as_tensor(shear_doubler(3), dtype=config.REAL, device=dev)
        D = torch.as_tensor(D_elems, dtype=config.REAL, device=dev).reshape(
            ncells, 6, fl, fl)
        SDS = S[:, None] * D * S[None, :]
        hot = np.zeros((6, 10, 27))
        for t in range(6):
            for a in range(10):
                hot[t, a, tet_nodes[t, a]] = 1.0
        Q = B.shape[1]
        Bc = np.einsum("tqanc,tnk->tqakc", B, hot).reshape(6 * Q * fl,
                                                           27 * 3)

        # periodic dof -> torus slot: representative node position mod L
        bb = mesh.bbox()
        dof_map = np.asarray(dof_map)
        Nd = int(dof_map.max()) + 1
        first = np.zeros(Nd, np.int64)
        uniq, firsts = np.unique(dof_map, return_index=True)
        first[uniq] = firsts
        qn = np.round((mesh.node_positions[first] - np.asarray(bb.min))
                      / (np.asarray(h3) / 2)).astype(np.int64)
        owner = (qn // 2) % np.asarray(n3)
        bits = qn % 2
        ch = np.asarray([_CHANNEL_BITS.index(tuple(b)) for b in bits],
                        dtype=np.int64)
        nx, ny, nz = n3
        dof_slot = ((owner[:, 0] * ny + owner[:, 1]) * nz
                    + owner[:, 2]) * 8 + ch
        if not len(np.unique(dof_slot)) == Nd == nx * ny * nz * 8:
            raise ValueError("periodic dof space does not tile the torus")
        as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        return cls(tuple(int(c) for c in n3), SDS.to(dt), as_t(Bc),
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
        """[Nd, 3(, m)] -> [n, n, n, 8, 3(, m)]."""
        nx, ny, nz = self.n3
        z = u.new_zeros((nx * ny * nz * 8,) + tuple(u.shape[1:]))
        z[self.dof_slot] = u
        return z.reshape((nx, ny, nz, 8) + tuple(u.shape[1:]))

    def from_channels(self, ch):
        return ch.reshape((-1,) + tuple(ch.shape[4:]))[self.dof_slot]

    # -- the apply ---------------------------------------------------------
    def _gather_cells(self, ch):
        """[n, n, n, 8, 3, m] -> [n, n, n, m, 27, 3] cube corner values (27
        wrapped slices, the column axis moved before the corners)."""
        nx, ny, nz = self.n3
        w = _wrap_pad(ch)
        return torch.stack(
            [w[o[0]:o[0] + nx, o[1]:o[1] + ny, o[2]:o[2] + nz, c]
             .movedim(-1, 3) for o, c in self.slots], dim=4)

    def _scatter_cells(self, f27, dtype):
        """Adjoint of :meth:`_gather_cells`: [n, n, n, m, 27, 3] ->
        [n, n, n, 8, 3, m] (27 slice adds into the padded torus, then the
        fold)."""
        nx, ny, nz = self.n3
        m = f27.shape[3]
        out = f27.new_zeros((nx + 1, ny + 1, nz + 1, 8, 3, m), dtype=dtype)
        for k, (o, c) in enumerate(self.slots):
            out[o[0]:o[0] + nx, o[1]:o[1] + ny, o[2]:o[2] + nz, c] += \
                f27[:, :, :, :, k].movedim(3, -1)
        return _wrap_fold(out)

    def apply_channels(self, ch):
        """A u on channel tensors [n, n, n, 8, 3] or [n, n, n, 8, 3, m]:
        wrapped corner slices -> ONE [nc*m, 81] @ Bc^T product -> the
        per-(cell, tet) [fl, fl] stress products -> ONE @ Bc product ->
        slice adds and the fold."""
        block = ch.dim() == 6
        if not block:
            ch = ch.unsqueeze(-1)
        nx, ny, nz = self.n3
        nc = nx * ny * nz
        m = ch.shape[-1]
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        dt = ch.dtype
        Bc = self.Bc.to(dt)
        u27 = self._gather_cells(ch).reshape(nc * m, 81)
        strain = (u27 @ Bc.t()).reshape(nc, m, 6, Q, fl)
        stress = torch.matmul(strain,
                              self.SDS.to(dt).transpose(-1, -2)[:, None]) \
            * self.wv.to(dt)[:, :, None]
        f27 = (stress.reshape(nc * m, 6 * Q * fl) @ Bc).reshape(
            nx, ny, nz, m, 27, 3)
        out = self._scatter_cells(f27, dt)
        return out if block else out[..., 0]

    def __call__(self, u):
        """A u for periodic-dof fields [Nd, 3(, m)]."""
        return self.from_channels(self.apply_channels(self.to_channels(u)))

    def diagonal_channels(self):
        """Assembled diagonal on the torus [n, n, n, 8, 3]."""
        nx, ny, nz = self.n3
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        Bq = self.Bc.reshape(6, Q, fl, 27, 3)
        G = torch.einsum("tqakc,tqbkc->tabkc",
                         Bq * self.wv[:, :, None, None, None], Bq)
        d27 = torch.einsum("xtab,tabkc->xkc", self.SDS, G)
        return self._scatter_cells(
            d27.reshape(nx, ny, nz, 1, 27, 3), self.dtype)[..., 0]

    def abs_row_sums_channels(self):
        """Row-sum bound of |A| assembled per tet (float64): |Ke| row sums
        bounded by |B|^T |SDS| |B| 1 (triangle inequality)."""
        nx, ny, nz = self.n3
        fl = self.SDS.shape[-1]
        Q = self.wv.shape[1]
        f64 = torch.float64
        aB = self.Bc.to(f64).abs().reshape(6, Q, fl, 27, 3)
        z = torch.einsum("tqakc->tqa", aB)
        H = torch.einsum("tqakc,tqb->tabkc",
                         aB * self.wv.to(f64)[:, :, None, None, None], z)
        rs27 = torch.einsum("xtab,tabkc->xkc", self.SDS.to(f64).abs(), H)
        return self._scatter_cells(rs27.reshape(nx, ny, nz, 1, 27, 3),
                                   f64)[..., 0]


# ---------------------------------------------------------------------------
# Torus P1 level + transfers (rolls instead of pads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TorusP1Level:
    """P1 level on the n^3 torus with per-cell [24, 24] matrices."""

    n3: tuple
    Kc: torch.Tensor        # [nx, ny, nz, 24, 24]
    diag: torch.Tensor      # [nx, ny, nz, 3]
    Kc64: np.ndarray        # Kc in float64 on the host (bounds, coarse)

    def apply(self, v):
        """v [n, n, n, 3] or [n, n, n, 3, m]."""
        block = v.dim() == 5
        if not block:
            v = v.unsqueeze(-1)
        nx, ny, nz = self.n3
        w = _wrap_pad(v)
        cell = torch.cat([w[bx:bx + nx, by:by + ny, bz:bz + nz]
                          for bx, by, bz in _CHANNEL_BITS], dim=3)
        f = torch.matmul(self.Kc.to(v.dtype), cell)    # [n, n, n, 24, m]
        out = v.new_zeros((nx + 1, ny + 1, nz + 1) + tuple(v.shape[3:]))
        for i, (bx, by, bz) in enumerate(_CHANNEL_BITS):
            out[bx:bx + nx, by:by + ny, bz:bz + nz] += f[:, :, :,
                                                         3 * i:3 * i + 3]
        out = _wrap_fold(out)
        return out if block else out[..., 0]


def _roll(v, b, sign):
    """Roll the torus axes of ``v`` by ``-sign * b``."""
    return torch.roll(v, shifts=tuple(-sign * x for x in b),
                      dims=tuple(range(len(b))))


def torus_prolong_p2(v):
    """Torus vertex field [n, n, n, 3(, m)] -> channels [n, n, n, 8, 3(, m)]:
    edge channel b gets (v[c] + v[c + b]) / 2."""
    chs = [v] + [0.5 * (v + _roll(v, b, +1)) for b in _CHANNEL_BITS[1:]]
    return torch.stack(chs, dim=3)


def torus_restrict_p2(u):
    """Adjoint of :func:`torus_prolong_p2`."""
    out = u[:, :, :, 0]
    for i, b in enumerate(_CHANNEL_BITS[1:], start=1):
        ub = u[:, :, :, i]
        out = out + 0.5 * (ub + _roll(ub, b, -1))
    return out


def torus_prolong_h(vc):
    """Torus (mx, my, mz) -> torus (2mx, 2my, 2mz):
    fine[2c + b] = (v[c] + v[c + b]) / 2."""
    mx, my, mz = vc.shape[:3]
    rest = tuple(vc.shape[3:])
    classes = [vc if b == (0, 0, 0) else 0.5 * (vc + _roll(vc, b, +1))
               for b in [(bx, by, bz) for bx in (0, 1) for by in (0, 1)
                         for bz in (0, 1)]]
    z = torch.stack(classes, dim=0).reshape((2, 2, 2, mx, my, mz) + rest)
    tail = tuple(range(6, 6 + len(rest)))
    return z.permute((3, 0, 4, 1, 5, 2) + tail).reshape(
        (2 * mx, 2 * my, 2 * mz) + rest)


def torus_restrict_h(rf):
    """Adjoint of :func:`torus_prolong_h`."""
    mx, my, mz = (rf.shape[0] // 2, rf.shape[1] // 2, rf.shape[2] // 2)
    rest = tuple(rf.shape[3:])
    tail = tuple(range(6, 6 + len(rest)))
    z = rf.reshape((mx, 2, my, 2, mz, 2) + rest).permute(
        (1, 3, 5, 0, 2, 4) + tail)
    out = z[0, 0, 0]
    for bx in (0, 1):
        for by in (0, 1):
            for bz in (0, 1):
                if bx == by == bz == 0:
                    continue
                ub = z[bx, by, bz]
                out = out + 0.5 * (ub + _roll(ub, (bx, by, bz), -1))
    return out


# ---------------------------------------------------------------------------
# Periodic variable-material multigrid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PeriodicVarMG:
    """V-cycle preconditioner for periodic cell problems on Kuhn grids
    with per-element materials.  The nullspace (3 translations) is handled
    by the mean projection of the caller's CG and the coarsest level's
    pseudo-inverse (or SuperLU with vertex 0 pinned)."""

    fine: PeriodicVarP2Elasticity
    fine_diag: torch.Tensor
    levels: tuple          # of TorusP1Level
    coarse_inv: torch.Tensor | None
    lam: tuple
    nu: int
    _coarse_lu: object = None

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, dof_map, *, nu: int = 3,
              dense_cap: int = 4096, dtype=None,
              device=None) -> "PeriodicVarMG":
        op = PeriodicVarP2Elasticity.build(mesh, D_elems, dof_map,
                                           dtype=dtype, device=device)
        dt, dev = op.dtype, op.device
        n3 = op.n3
        fine_diag = op.diagonal_channels()

        def dofs(nn):
            return nn[0] * nn[1] * nn[2] * 3

        chain = [n3]
        while (all(c % 2 == 0 for c in chain[-1]) and min(chain[-1]) >= 4
               and dofs(chain[-1]) > dense_cap):
            chain.append(tuple(c // 2 for c in chain[-1]))

        Kc = _p1_cell_matrices_var(mesh, D_elems, dev)
        levels = []
        for li, ln in enumerate(chain):
            if li > 0:
                Kc = _coarsen_cell_matrices(Kc)
            diag = _torus_p1_diag(ln, Kc)
            levels.append(TorusP1Level(
                ln, torch.as_tensor(Kc, dtype=dt, device=dev),
                torch.as_tensor(diag, dtype=dt, device=dev), np.asarray(Kc)))

        # coarsest: dense pseudo-inverse (translations are singular) when
        # small, else host SuperLU on the 3-dof-pinned matrix (odd extents
        # stop the dyadic chain early)
        Kc_last = levels[-1].Kc64
        Ncd = dofs(levels[-1].n3)
        coarse_inv = coarse_lu = None
        if Ncd <= dense_cap:
            Ac = _coarse_matrix_torus(Kc_last, _CHANNEL_BITS)
            coarse_inv = torch.as_tensor(np.linalg.pinv(Ac, hermitian=True),
                                         dtype=dt, device=dev)
        else:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            Ac = sp.csr_matrix(_coarse_matrix_torus_sparse(Kc_last,
                                                           _CHANNEL_BITS))
            m = np.ones(Ncd)
            m[:3] = 0.0                    # pin vertex 0 (translations)
            M = sp.diags(m)
            lu = spla.splu((M @ Ac @ M + sp.diags(1.0 - m)).tocsc())

            def coarse_lu(r):
                flat = r.reshape(Ncd, -1) * m[:, None]
                return (lu.solve(flat) * m[:, None]).reshape(r.shape)

        obj = cls(op, fine_diag, tuple(levels), coarse_inv,
                  (1.0,) * (1 + len(levels)), nu, coarse_lu)
        obj.lam = tuple([obj._lam_fine()]
                        + [_torus_gershgorin(lvl.n3, lvl.Kc64, lvl.diag)
                           for lvl in levels])
        return obj

    def _lam_fine(self):
        """Row-scaled Gershgorin bound on lam_max(D^-1 A) for the P2 level
        (float64)."""
        rs = self.fine.abs_row_sums_channels().cpu().numpy()
        diag = self.fine_diag.to(torch.float64).cpu().numpy()
        return float((rs / np.maximum(diag, 1e-30)).max()) * 1.02

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
        xc = self._cycle(i + 1, torus_restrict_h(res))
        x = x + torus_prolong_h(xc)
        return x + S(r - lvl.apply(x))

    def precondition(self, r_ch):
        """Torus channel residual [n, n, n, 8, 3(, m)] -> correction (one
        symmetric V-cycle, all columns at once)."""
        A = self.fine.apply_channels
        one = torch.ones((), dtype=r_ch.dtype, device=r_ch.device)
        S = _chebyshev(A, _with_columns(self.fine_diag, r_ch).to(
            r_ch.dtype), one, self.lam[0], self.nu)
        x = S(r_ch)
        res = r_ch - A(x)
        xc = self._cycle(0, torus_restrict_p2(res))
        x = x + torus_prolong_p2(xc)
        return x + S(r_ch - A(x))


def _periodic_mg_cg(mg, bc, tol, maxiter):
    """MG-PCG on the torus for one channel right-hand side; translations
    projected by the mean over the torus axes."""
    res = cg_mod.cg(mg.fine.apply_channels, _project_translations(bc),
                    M_inv=mg.precondition, project=_project_translations,
                    tol=tol, maxiter=maxiter)
    return res.x, res.iters, res.resnorm


def _periodic_mg_cg_block(mg, Bc, tol, maxiter):
    """All columns of ``Bc [n, n, n, 8, 3, m]`` in ONE block CG: the torus
    operator and the V-cycle take the trailing column axis as it lies."""
    return cg_mod.cg_block(mg.fine.apply_channels,
                           _project_translations(Bc), M_inv=mg.precondition,
                           project=_project_translations, tol=tol,
                           maxiter=maxiter)


def solve_cell_problems_grid(sim, mg: PeriodicVarMG | None = None,
                             tol: float = 1e-10, maxiter: int = 300):
    """MG-preconditioned periodic cell problems for a GRID simulator (the
    counterpart of ``analysis.homogenization.solve_cell_problems`` when the
    mesh is a Kuhn grid): all fl right-hand sides in ONE block CG with the
    V-cycle, in ``sim.Ke``'s dtype on ``sim``'s device.  Returns (w [fl, N,
    dim], iters list)."""
    from ..analysis.homogenization import _cell_loads

    fl = flat_len(sim.dim)
    if mg is None:
        D = sim.D
        if D.dim() == 2:
            D = D.expand((sim.mesh.num_elements,) + tuple(D.shape))
        mg = PeriodicVarMG.build(sim.mesh, D, sim.dof_map,
                                 dtype=sim.Ke.dtype, device=sim.device)
    res = _periodic_mg_cg_block(mg, mg.fine.to_channels(_cell_loads(sim)),
                                tol, maxiter)
    w = mg.fine.from_channels(res.x).movedim(-1, 0)[:, sim._dof_map_t]
    return w, [int(res.iters)] * fl
