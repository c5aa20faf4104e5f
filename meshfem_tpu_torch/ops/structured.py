"""Structured-grid fast path: P2 elasticity as a 27-point block convolution.

Counterpart of ``meshfem_tpu/ops/structured.py``.  On Kuhn-subdivided box
grids (``generators.grid_tet``) every cube has identical geometry, so the
assembled stiffness is translation invariant.  The P2 nodes live in
**cube-channel space**: cell (i, j, k) owns 8 node classes (its min-corner
vertex and the 7 edge midpoints whose edges start there, ``_CHANNEL_BITS``),
so a field is the channel tensor ``[mx, my, mz, 24]`` (``m = n + 1`` cells
a side, 8 classes x 3 components), which is ``[n_slots, 3]`` as it lies.
The stiffness action is ONE ``torch.nn.functional.conv3d`` with a
``[24, 24, 3, 3, 3]`` block stencil, padding 1 (an XLA
``conv_general_dilated`` in the reference, not a Pallas kernel), minus a
correction for the fake cubes outside the box that the uniform stencil
counts on the boundary shell.

The correction takes one form on every box, the gather form: kernel A
(``gather_rows``) reads the 27 node slots of every fake cube that touches
the box (0 outside it), one ``[nf, 81] @ [81, 81]`` product with the cube
matrix gives their forces, kernel B (``segment_sum_rows``) sums them into
the compact list of shell slots in a fixed order, and one ``index_add_``
at those unique slots subtracts them.  The reference serves only cubes
(``nx == ny == nz``) with its 26 grouped facet convolutions and falls back
to this gather form otherwise; on the GPU a gather costs its bytes, and
three launches replace 26 small convolutions.

The reference's lane-packed layout (5 z-layers folded into 120 channels,
``_pack_z_kernel`` and ``apply_packed``) exists because XLA:TPU pads the
channel dimension to 128 lanes; the port keeps the channel tensor, which
``conv3d`` reads as channels-last (NDHWC) where it lies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..kernels import gather_rows, segment_sum_rows_plain
from ..mesh import generators
from ..mesh.femmesh import FEMMesh
from ..solvers import cg as cg_mod
from ..sparse import assembly
from ..sparse.scatter import ScatterPlan
from . import element_matrices as em

# Channel order: fractional-offset bit patterns (x, y, z).
_CHANNEL_BITS = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                 (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1)]
_BITS_TO_CH = {b: i for i, b in enumerate(_CHANNEL_BITS)}


def _cube_mesh_and_stiffness(h3, D):
    """One cell (per-axis spacings h3), Kuhn-subdivided, P2: returns
    (node_slots [27] as (owner_offset [3], channel), K_cube [81, 81] f64)."""
    V, T = generators.grid_tet(1, 1, 1, hi=tuple(h3))
    mesh = FEMMesh(V, T, degree=2)
    assert mesh.num_nodes == 27
    g = mesh.geometry("cpu")
    Ke = em.element_elasticity(g.grad_lambda, g.volume,
                               torch.as_tensor(D, dtype=config.REAL,
                                               device="cpu"), 2)
    K_cube = np.asarray(assembly.assemble_scipy(
        Ke.numpy(), mesh.elem_nodes, mesh.num_nodes, d=3).todense())
    # Classify each node by quantized position (units of h/2 per axis).
    q = np.round(mesh.node_positions / (np.asarray(h3) / 2)).astype(int)
    slots = [(q[i] // 2, _BITS_TO_CH[tuple(q[i] % 2)]) for i in range(27)]
    return slots, K_cube


def validate_kuhn_grid(mesh: FEMMesh):
    """Validate the structured hypothesis completely (a near-grid
    unstructured mesh must fail loudly, not silently mis-assemble):
    vertex count, element count, vertices exactly on the inferred
    lattice, and every tet a Kuhn path 000 -> 111 (nested corner bit
    patterns; the same vertex positions with flipped diagonals is a
    different operator).  Returns (n3, h3); raises ValueError."""
    if mesh.K != 3 or mesh.degree != 2:
        raise ValueError("structured path supports P2 tets")
    bb = mesh.bbox()
    Vv = np.asarray(mesh.V)
    n3 = tuple(len(np.unique(np.round(Vv[:, a], 9))) - 1
               for a in range(3))
    if min(n3) < 1:
        raise ValueError("mesh is not a Kuhn-subdivided box grid "
                         "(degenerate axis)")
    h3 = tuple(float(bb.dimensions[a]) / n3[a] for a in range(3))
    nv3 = np.asarray(n3)
    if mesh.num_vertices != int(np.prod(nv3 + 1)) \
            or mesh.num_elements != 6 * int(np.prod(nv3)):
        raise ValueError("mesh is not a Kuhn-subdivided box grid "
                         "(vertex/element count mismatch)")
    q = (Vv - np.asarray(bb.min)) / np.asarray(h3)
    qi = np.round(q)
    if np.abs(q - qi).max() > 1e-6:
        raise ValueError("mesh is not a Kuhn-subdivided box grid "
                         "(vertices off the inferred lattice)")
    tet_q = qi[np.asarray(mesh.F)].astype(np.int64)   # [E, 4, 3]
    bits = tet_q - tet_q.min(axis=1, keepdims=True)
    if bits.min() < 0 or bits.max() > 1:
        raise ValueError("mesh is not a Kuhn-subdivided box grid "
                         "(element spans more than one cell)")
    pop = bits.sum(axis=2)                            # [E, 4]
    order = np.argsort(pop, axis=1)
    sb = np.take_along_axis(bits, order[:, :, None], axis=1)
    nested = ((np.sort(pop, axis=1) == np.arange(4)[None, :]).all(axis=1)
              & (sb[:, :-1] <= sb[:, 1:]).all(axis=(1, 2)))
    if not nested.all():
        raise ValueError("mesh is not a Kuhn-subdivided box grid "
                         "(non-Kuhn tetrahedralization)")
    return n3, h3


def node_slots(mesh: FEMMesh, n3, h3) -> np.ndarray:
    """[N] node id -> flat node slot ``cell_flat * 8 + channel`` of the
    channel tensor (owner cell and class from the quantized position)."""
    my, mz = n3[1] + 1, n3[2] + 1
    q = np.round((mesh.node_positions - mesh.bbox().min)
                 / (np.asarray(h3) / 2)).astype(np.int64)
    owner = q // 2
    ch = np.array([_BITS_TO_CH[tuple(b)] for b in q % 2], dtype=np.int64)
    return ((owner[:, 0] * my + owner[:, 1]) * mz + owner[:, 2]) * 8 + ch


@dataclasses.dataclass
class StructuredP2Elasticity:
    """Structured operator for ``FEMMesh(grid_tet(nx, ny, nz), degree=2)``.

    Apply path: u [N, 3] -> channel tensor [n_slots, 3] -> conv minus
    shell correction -> back.  ``node_slot`` maps FEMMesh node ids to
    channel slots.  Tensors live on one device in one dtype; on a CUDA
    device the shell correction runs kernels A and B, which take float32
    (the solve refines in float64 through the EBE operator)."""

    n3: tuple                  # cells per axis (nx, ny, nz)
    weight: torch.Tensor       # [24 out, 24 in, 3, 3, 3], channels-last
    K_cube: torch.Tensor       # [81, 81] for the shell correction
    node_slot: torch.Tensor    # [N] -> flat node slot
    slot_node: np.ndarray      # [n_slots] inverse (node or -1), host
    fake_ids: torch.Tensor     # [nf * 27] int32 slot of each fake-cube
    #                            node, -1 outside the box
    fake_plan: ScatterPlan     # fake-cube rows -> compact shell slots
    shell_slots: torch.Tensor  # [S] the slots the correction touches
    num_nodes: int
    kernel: np.ndarray         # [3, 3, 3, 24 in, 24 out] f64, the
    #                            reference's layout, host
    K_cube64: np.ndarray       # [81, 81] f64, host

    @classmethod
    def build(cls, mesh: FEMMesh, D, dtype=None,
              device=None) -> "StructuredP2Elasticity":
        n3, h3 = validate_kuhn_grid(mesh)
        dev = config.resolve_device(device)
        dt = dtype or config.REAL
        slots, K_cube = _cube_mesh_and_stiffness(h3, D)

        # Stencil in the reference's layout kernel[dx+1, dy+1, dz+1, in,
        # out]: f[c, ca] += K[a, b] u[c + (ob - oa), cb] for the cube at
        # c - oa.  conv3d is a cross-correlation like lax.conv, so its
        # weight [out, in, x, y, z] is this one permuted.
        kernel = np.zeros((3, 3, 3, 24, 24))
        for a, (oa, ca) in enumerate(slots):
            for b, (ob, cb) in enumerate(slots):
                d = ob - oa
                blk = K_cube[a * 3:(a + 1) * 3, b * 3:(b + 1) * 3]
                kernel[d[0] + 1, d[1] + 1, d[2] + 1,
                       cb * 3:(cb + 1) * 3, ca * 3:(ca + 1) * 3] += blk.T
        weight = torch.as_tensor(kernel.transpose(4, 3, 0, 1, 2), dtype=dt,
                                 device=dev).contiguous(
            memory_format=torch.channels_last_3d)

        mx, my, mz = (n3[0] + 1, n3[1] + 1, n3[2] + 1)
        node_slot = node_slots(mesh, n3, h3)
        slot_node = np.full(mx * my * mz * 8, -1, dtype=np.int64)
        slot_node[node_slot] = np.arange(mesh.num_nodes)

        # Fake cubes: cells in [-1, n]^3 \ [0, n-1]^3 owning in-box slots.
        rngs = [np.arange(-1, n3[a] + 1) for a in range(3)]
        cells = np.stack(np.meshgrid(*rngs, indexing="ij"),
                         axis=-1).reshape(-1, 3)
        nv3 = np.asarray(n3)
        real = np.all((cells >= 0) & (cells <= nv3 - 1), axis=1)
        fake = cells[~real]
        offsets = np.asarray([s[0] for s in slots])
        chans = np.asarray([s[1] for s in slots])
        slot_cells = fake[:, None, :] + offsets[None, :, :]   # [nf, 27, 3]
        in_box = np.all((slot_cells >= 0) & (slot_cells <= nv3), axis=2)
        touch = in_box.any(axis=1)
        slot_cells, in_box = slot_cells[touch], in_box[touch]
        flat = ((slot_cells[:, :, 0] * my + slot_cells[:, :, 1]) * mz
                + slot_cells[:, :, 2]) * 8 + chans[None, :]
        # The correction runs over the S touched shell slots only; rows of
        # nodes outside the box read 0 (id -1) and belong to no segment.
        shell = np.unique(flat[in_box])
        kept = np.flatnonzero(in_box.reshape(-1))
        plan = ScatterPlan.build(np.searchsorted(shell, flat[in_box]),
                                 len(shell), dev)
        plan = dataclasses.replace(
            plan.renumbered(torch.as_tensor(kept, dtype=config.INDEX,
                                            device=dev)),
            num_rows=in_box.size)
        return cls(n3, weight, torch.as_tensor(K_cube, dtype=dt, device=dev),
                   torch.as_tensor(node_slot, device=dev), slot_node,
                   torch.as_tensor(np.where(in_box, flat, -1).reshape(-1),
                                   dtype=config.INDEX, device=dev),
                   plan, torch.as_tensor(shell, device=dev), mesh.num_nodes,
                   kernel, K_cube)

    @property
    def dtype(self) -> torch.dtype:
        return self.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.weight.device

    @property
    def num_slots(self) -> int:
        return len(self.slot_node)

    # -- channel-space transforms ---------------------------------------
    def to_channels(self, u):
        """u [N, 3] -> [n_slots, 3] channel space (dead slots zero)."""
        z = u.new_zeros((self.num_slots, u.shape[-1]))
        z[self.node_slot] = u
        return z

    def from_channels(self, uc):
        return uc.reshape(-1, 3)[self.node_slot]

    def apply_channels(self, uc):
        """A u in channel space (any shape holding ``[n_slots, 3]``, which
        the result keeps): the stencil conv minus the shell correction."""
        mx, my, mz = (self.n3[0] + 1, self.n3[1] + 1, self.n3[2] + 1)
        rows = uc.reshape(-1, 3)
        x = rows.view(1, mx, my, mz, 24).permute(0, 4, 1, 2, 3)  # NDHWC
        y = F.conv3d(x, self.weight.to(uc.dtype), padding=1)
        y = y.permute(0, 2, 3, 4, 1).reshape(-1, 3)
        y.index_add_(0, self.shell_slots, self._shell_correction(rows),
                     alpha=-1)
        return y.reshape(uc.shape)

    def _shell_correction(self, rows):
        """Forces of the fake cubes on the shell slots [S, 3]: kernel A
        gathers each fake cube's 27 node rows, one product with the cube
        matrix, kernel B sums the rows of in-box nodes per shell slot."""
        ue = gather_rows(rows.contiguous(), self.fake_ids)    # [nf*27, 3]
        fe = ue.view(-1, 81) @ self.K_cube.to(rows.dtype).t()
        return self.fake_plan.sum_rows(fe.view(-1, 3))

    def __call__(self, u):
        """A u for nodal u [N, 3]."""
        return self.from_channels(self.apply_channels(self.to_channels(u)))

    def valid_mask(self):
        """[n_slots, 1] 1.0 on live channel slots, 0.0 on dead ones (the
        conv writes into dead slots; CG must project them away)."""
        return torch.as_tensor(self.slot_node >= 0, dtype=self.dtype,
                               device=self.device)[:, None]

    def _shell_sum(self, per_node):
        """Host f64: ``per_node [27, 3]`` summed over the in-box nodes of
        every fake cube into the shell slots through the correction's own
        plan -> [n_slots, 3]."""
        rows = torch.as_tensor(per_node, dtype=torch.float64).repeat(
            self.fake_ids.shape[0] // 27, 1)
        acc = segment_sum_rows_plain(rows, self.fake_plan.perm.cpu(),
                                     self.fake_plan.offsets.cpu())
        out = np.zeros((self.num_slots, 3))
        out[self.shell_slots.cpu().numpy()] = acc.numpy()
        return out

    def diagonal_host(self):
        """Assembled diagonal in channel space [n_slots, 3], f64 on the
        host: the stencil centre per channel minus the fake cubes' diagonal
        contributions on the shell."""
        c = np.diagonal(self.kernel[1, 1, 1]).reshape(8, 3)
        full = np.tile(c, (self.num_slots // 8, 1))
        return full - self._shell_sum(np.diagonal(self.K_cube64).reshape(
            27, 3))

    def abs_row_sums_host(self):
        """Assembled absolute row sums in channel space [n_slots, 3] (f64,
        host): the interior sums minus the fake cubes' shares."""
        rs = np.abs(self.kernel).sum(axis=(0, 1, 2, 3)).reshape(8, 3)
        full = np.tile(rs, (self.num_slots // 8, 1))
        return full - self._shell_sum(
            np.abs(self.K_cube64).sum(axis=1).reshape(27, 3))

    def diagonal_channels(self):
        """Diagonal of the channel-space operator (Jacobi) [n_slots, 3]."""
        return torch.as_tensor(self.diagonal_host(), dtype=self.dtype,
                               device=self.device)

    def solve_cg(self, b, fixed_mask=None, fixed_values=None,
                 tol: float = 1e-10, maxiter: int = 20000):
        """Jacobi-PCG in channel space.  b [N, 3] nodal right-hand side;
        fixed_mask / fixed_values [N, 3] optional Dirichlet data.  Returns
        (u [N, 3], CGResult)."""
        dt, dev = self.dtype, self.device
        bc = self.to_channels(torch.as_tensor(b, dtype=dt, device=dev))
        valid = self.valid_mask()
        if fixed_mask is not None:
            fixed = torch.as_tensor(fixed_mask, device=dev)
            freec = self.to_channels((~fixed).to(dt)) * valid
        else:
            freec = valid.expand_as(bc)
        diag = self.diagonal_channels()
        safe = torch.where(diag > 0, diag, torch.ones_like(diag))
        project = lambda v: v * freec
        M_inv = lambda r: r / safe
        u_d = None
        if fixed_values is not None:
            u_d = self.to_channels(torch.as_tensor(
                fixed_values, dtype=dt, device=dev)) * (1 - freec)
            bc = bc - self.apply_channels(u_d)
        res = cg_mod.cg(self.apply_channels, bc, M_inv=M_inv,
                        project=project, tol=tol, maxiter=maxiter)
        x = res.x if u_d is None else res.x + u_d
        return self.from_channels(x), cg_mod.CGResult(x, res.iters,
                                                      res.resnorm)
