"""Structured-grid P2 elasticity with PER-ELEMENT materials.

Counterpart of ``meshfem_tpu/ops/structured_var.py``.  Per-element
materials break the translation invariance that gives the uniform path
(``ops/structured.py``) its one stencil, but every cell of a Kuhn grid has
the same geometry, so the element stiffness factors as
``Ke = vol * sum_q w_q B_q^T (S D S) B_q`` with ONE strain matrix ``B``
shared by all cells and only the [fl, fl] material varying.  The apply is
27 slices into ``[ncells, 81]``, one ``@ Bc^T`` product to all per-tet
quadrature-point strains, the per-cell ``[fl, fl]`` stress product, one
``@ Bc`` product back and 27 slice adds: no per-cell [81, 81] matrix is
ever formed (1.2 GB at 36^3 cells).  The products are ``torch.matmul``, as
the reference leaves them to XLA.
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
from . import element_matrices as em
from .structured import _CHANNEL_BITS, node_slots, validate_kuhn_grid


def check_grid_element_order(mesh, n3, h3):
    """Raise unless elements are in grid_tet order: cell-major C-order
    with each cell's 6 tets in the reference pattern slots.  The
    per-element material pairing (D_elems.reshape(ncells, 6, ...)) and
    the fixed strain matrix both depend on it; a reordered Kuhn mesh
    must fail loudly, not silently mis-assemble."""
    bb = mesh.bbox()
    Vv = np.asarray(mesh.V)
    q = np.round((Vv - np.asarray(bb.min)) / np.asarray(h3)).astype(
        np.int64)
    tq = q[np.asarray(mesh.F)]                        # [E, 4, 3]
    cmin = tq.min(axis=1)
    cidx = (cmin[:, 0] * n3[1] + cmin[:, 1]) * n3[2] + cmin[:, 2]
    E = len(tq)
    if not np.array_equal(cidx, np.repeat(np.arange(E // 6), 6)):
        raise ValueError("elements are not in grid_tet order (cell-major "
                         "C-order); the variable-material structured path "
                         "requires the generator ordering")
    bits = tq - cmin[:, None, :]
    keys = np.sort(bits[:, :, 0] * 4 + bits[:, :, 1] * 2 + bits[:, :, 2],
                   axis=1)                            # [E, 4]
    Vr, Tr = generators.grid_tet(1, 1, 1)
    qr = np.round(Vr).astype(np.int64)[Tr]            # [6, 4, 3]
    ref = np.sort(qr[:, :, 0] * 4 + qr[:, :, 1] * 2 + qr[:, :, 2], axis=1)
    if not np.array_equal(keys.reshape(E // 6, 6, 4),
                          np.broadcast_to(ref, (E // 6, 6, 4))):
        raise ValueError("cell-local tet slots do not match the grid_tet "
                         "reference pattern order")


def _cube_reference(h3):
    """One Kuhn cell, P2: (slots [(offset, channel)] per cube node,
    tet_nodes [6, 10] cube-local node ids, B [6, Q, fl, 10, 3] strain
    matrices at quad points, wv [6, Q] weight*volume), numpy f64."""
    V, T = generators.grid_tet(1, 1, 1, hi=tuple(h3))
    mesh = FEMMesh(V, T, degree=2)
    assert mesh.num_nodes == 27
    g = mesh.geometry("cpu")
    q = np.round(mesh.node_positions / (np.asarray(h3) / 2)).astype(int)
    slots = [(tuple(q[i] // 2), _CHANNEL_BITS.index(tuple(q[i] % 2)))
             for i in range(27)]
    pts, w = quadrature.rule_np(3, 2)
    B = em.element_strain_matrix(g.grad_lambda, 2, pts).numpy()
    wv = np.asarray(w)[None, :] * g.volume.numpy()[:, None]
    return slots, np.asarray(mesh.elem_nodes), B, wv


@dataclasses.dataclass
class StructuredVarP2Elasticity:
    """P2 elasticity on a Kuhn grid with per-TET materials.

    Vectors live in channel space [mx, my, mz, 8, 3] (the slot layout of
    ``ops/structured.py``); ``to_channels`` / ``from_channels`` convert
    nodal [N, 3] fields.  Tensors live on one device in one dtype."""

    n3: tuple
    SDS: torch.Tensor       # [ncells, 6, fl, fl] S D S per (cell, tet)
    B: torch.Tensor         # [6, Q, fl, 10, 3]
    Bc: torch.Tensor        # [6*Q*fl, 81] corner values -> per-tet strains
    wv: torch.Tensor        # [6, Q] quad weight * tet volume
    tet_slot: torch.Tensor  # [6, 10, 27] one-hot: cube node of (tet, a)
    node_slot: torch.Tensor  # [N] nodal -> flat channel index
    num_nodes: int
    slots: list             # [27] (owner offset, channel) per cube node

    @classmethod
    def build(cls, mesh: FEMMesh, D_elems, dtype=None, device=None
              ) -> "StructuredVarP2Elasticity":
        """D_elems: [E, fl, fl] per-element material matrices in the
        grid_tet element order (6 tets per cell, cells C-order)."""
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
        # the tet-node selection folded into the strain matrix: ONE
        # [144, 81] operator from cube corner values to all per-tet
        # quadrature-point strains
        Q = B.shape[1]
        Bc = np.einsum("tqanc,tnk->tqakc", B, hot).reshape(
            6 * Q * fl, 27 * 3)
        as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        return cls(n3, SDS.to(dt), as_t(B), as_t(Bc), as_t(wv), as_t(hot),
                   torch.as_tensor(node_slots(mesh, n3, h3), device=dev),
                   mesh.num_nodes, slots)

    @property
    def dtype(self) -> torch.dtype:
        return self.SDS.dtype

    @property
    def device(self) -> torch.device:
        return self.SDS.device

    # -- channel-space transforms ----------------------------------------
    def to_channels(self, u):
        mx, my, mz = (self.n3[0] + 1, self.n3[1] + 1, self.n3[2] + 1)
        z = u.new_zeros((mx * my * mz * 8, u.shape[-1]))
        z[self.node_slot] = u
        return z.reshape(mx, my, mz, 8, u.shape[-1])

    def from_channels(self, ch):
        return ch.reshape(-1, ch.shape[-1])[self.node_slot]

    def _gather_cells(self, ch):
        """[mx, my, mz, 8, 3] -> [nx, ny, nz, 27, 3] cube corner values
        (27 shifted slices)."""
        nx, ny, nz = self.n3
        return torch.stack(
            [ch[o[0]:o[0] + nx, o[1]:o[1] + ny, o[2]:o[2] + nz, c]
             for o, c in self.slots], dim=3)

    def _scatter_cells(self, f27, dtype, m):
        """Adjoint of :meth:`_gather_cells` (27 slice adds; the slices of
        one add never alias, so the sum order is fixed)."""
        nx, ny, nz = self.n3
        out = f27.new_zeros((nx + 1, ny + 1, nz + 1, 8, m), dtype=dtype)
        for k, (o, c) in enumerate(self.slots):
            out[o[0]:o[0] + nx, o[1]:o[1] + ny, o[2]:o[2] + nz, c] += \
                f27[..., k, :]
        return out

    def apply_channels(self, ch):
        """A u in channel space: corner slices -> [ncells, 81] @ Bc^T ->
        per-cell [fl, fl] stress products -> @ Bc -> slice adds."""
        nx, ny, nz = self.n3
        nc = nx * ny * nz
        fl = self.SDS.shape[-1]
        Q = self.B.shape[1]
        dt = ch.dtype
        Bc = self.Bc.to(dt)
        u27 = self._gather_cells(ch).reshape(nc, 81)
        strain = (u27 @ Bc.t()).reshape(nc, 6, Q, fl)
        stress = torch.matmul(strain, self.SDS.to(dt).transpose(-1, -2)) \
            * self.wv.to(dt)[None, :, :, None]
        f27 = (stress.reshape(nc, 6 * Q * fl) @ Bc).reshape(
            nx, ny, nz, 27, 3)
        return self._scatter_cells(f27, dt, 3)

    def __call__(self, u):
        """A u for nodal u [N, 3]."""
        return self.from_channels(self.apply_channels(self.to_channels(u)))

    def diagonal_channels(self):
        """Assembled diagonal in channel space [mx, my, mz, 8, 3]."""
        dt = self.dtype
        nx, ny, nz = self.n3
        d_tet = torch.einsum("tqanc,xyztab,tqbnc->xyztnc",
                             self.B, self.SDS.reshape(
                                 nx, ny, nz, 6, self.SDS.shape[-2],
                                 self.SDS.shape[-1]),
                             self.B * self.wv[:, :, None, None, None])
        d27 = torch.einsum("tak,xyztac->xyzkc", self.tet_slot.to(dt), d_tet)
        return self._scatter_cells(d27, dt, 3)

    def valid_mask_channels(self):
        mx, my, mz = (self.n3[0] + 1, self.n3[1] + 1, self.n3[2] + 1)
        v = torch.zeros((mx * my * mz * 8,), dtype=self.dtype,
                        device=self.device)
        v[self.node_slot] = 1.0
        return v.reshape(mx, my, mz, 8)[..., None]
