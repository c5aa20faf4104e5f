"""Domain decomposition with halo exchange for multi-device solves.

Counterpart of ``meshfem_tpu/parallel/domain.py``.  The reduced dof space
is cut into per-shard OWNED ranges along a Morton curve, and each apply
exchanges only HALO values:

* host build (:52-213): Morton-ordered dofs, contiguous owned ranges of
  ``Nl`` rows, per-shard element lists (every element touching an owned
  dof, duplicated across shard boundaries so every owned row is complete
  locally), split into interior elements (all nodes owned) and boundary
  elements (touching the halo), and the halo's send and receive tables
  padded to uniform ``[S, S, K]`` / ``[S, H]`` shapes.  The reference's
  per-dof Python dict (:132-138) is a ``searchsorted`` over the sorted halo
  here, with the same result, and its ``np.add.at`` sums ``np.bincount``s
  (the same additions in the same order);
* the shard apply (:347-377): start the halo exchange, apply the interior
  elements through the float64 ``EBEKernel`` (the gather, ``bmm``, kernel
  B in float64 rows), wait, then apply the boundary elements on the
  halo-extended vector.  On ranks the exchange is asynchronous, so it
  overlaps the interior apply as the reference's ``all_to_all`` overlaps
  its einsum;
* CG scalars are the only sums across shards, through the comm's
  ``sum_partials`` (``parallel/comm.py``): the same bits on every rank;
* point Jacobi or exact per-node d x d block Jacobi, and optionally the
  replicated aggregation coarse level :class:`DDCoarse` (:216-322);
* stopping: a fixed iteration count in one run, or ``tol`` checked on the
  host between ``chunk``-iteration runs with the reference's two-chunk
  stall rule (:568-590).

Floating arrays live on the device of the simulator's ``Ke``; integer
tables stay on the host as numpy (the reference's shapes and values), with
device copies built per shard when a solve first needs them.  The
reference's ``Mesh``, ``shard_map`` and ``psum`` are the comm's job.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..mesh.reorder import _morton_codes
from ..solvers import precond as pc
from ..sparse.ebe import EBEKernel
from ..sparse.scatter import ScatterPlan
from .comm import LocalShards


def _node_blocks(Ke, n, d):
    """[E, n, d] diagonals and [E, n, d, d] node blocks of ``Ke`` as host
    float64 arrays (a selection: no arithmetic)."""
    E = Ke.shape[0]
    de = torch.diagonal(Ke, dim1=1, dim2=2).reshape(E, n, d)
    idx = torch.arange(n, device=Ke.device)
    blk = Ke.reshape(E, n, d, n, d)[:, idx, :, idx, :].movedim(0, 1)
    return (de.cpu().numpy().astype(np.float64),
            blk.cpu().numpy().astype(np.float64))


def _accumulate(ids, vals, size):
    """Host sums ``out[ids[i]] += vals[i]`` in index order, one bincount a
    trailing component (``np.add.at``'s additions in its order)."""
    flat = vals.reshape(len(ids), -1)
    out = np.stack([np.bincount(ids, weights=flat[:, c], minlength=size)
                    for c in range(flat.shape[1])], axis=1)
    return out.reshape((size,) + vals.shape[1:])


class ShardOps(NamedTuple):
    """One shard's operators and exchange tables on the device."""

    interior: EBEKernel | None   # over the Nl owned rows
    boundary: EBEKernel | None   # over the Nl + H owned and halo rows
    send: torch.Tensor           # [S * K] owned rows into the send slots
    take: torch.Tensor           # [H] receive slots into the halo rows


@dataclasses.dataclass
class DomainDecomposition:
    """Host-built partition and halo-exchange plan; per-shard arrays carry a
    leading ``[S]`` axis (padded to the largest shard, as the reference's;
    ``n_int`` / ``n_bnd`` are each shard's true element counts)."""

    n_shards: int
    num_dofs: int          # reduced dof count (unpadded)
    Nl: int                # owned rows per shard (padded)
    H: int                 # halo slots per shard (padded)
    K: int                 # exchange slots per (src, dst) pair (padded)
    d: int
    perm: np.ndarray       # old dof id -> new (Morton) id
    Ke_int: torch.Tensor   # [S, Ei, nd, nd] interior elements
    ld_int: np.ndarray     # [S, Ei, n] local OWNED rows in [0, Nl)
    Ke_bnd: torch.Tensor   # [S, Eb, nd, nd] halo-touching elements
    ld_bnd: np.ndarray     # [S, Eb, n] local rows in [0, Nl + H)
    send_idx: np.ndarray   # [S, S, K] local OWNED rows to ship to each dst
    halo_take: np.ndarray  # [S, H] rows of the [S * K] receive buffer
    diag_s: torch.Tensor   # [S, Nl, d] owned operator diagonal
    blocks_s: torch.Tensor  # [S, Nl, d, d] per-node diagonal blocks
    halo_counts: np.ndarray  # [S, S] true (unpadded) pairwise traffic
    n_int: np.ndarray      # [S] interior elements of each shard
    n_bnd: np.ndarray      # [S] boundary elements of each shard
    _ops: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    # -- host build -------------------------------------------------------
    @classmethod
    def build(cls, Ke, elem_dofs, num_dofs: int, d: int, positions,
              n_shards: int, device=None) -> "DomainDecomposition":
        """Ke [E, n*d, n*d] (a tensor stays on its device; numpy goes to
        ``device``); elem_dofs [E, n] reduced dof ids; positions [num_dofs,
        dim] representative coordinates for the Morton order."""
        if isinstance(Ke, torch.Tensor):
            dev = Ke.device if device is None else torch.device(device)
        else:
            dev = config.resolve_device(device)
        Ke = torch.as_tensor(Ke, device=dev)
        elem_dofs = np.asarray(torch.as_tensor(elem_dofs).cpu())
        E, n = elem_dofs.shape
        nd = Ke.shape[1]
        S = n_shards

        order = np.argsort(_morton_codes(np.asarray(positions)),
                           kind="stable")
        perm = np.empty(num_dofs, dtype=np.int64)
        perm[order] = np.arange(num_dofs)
        Nl = -(-num_dofs // S)
        new_ed = perm[elem_dofs]                       # [E, n]
        owner_ed = new_ed // Nl

        shard_elems, shard_halo = [], []
        counts = np.zeros((S, S), dtype=np.int64)
        for s in range(S):
            elems = np.flatnonzero((owner_ed == s).any(axis=1))
            dofs = np.unique(new_ed[elems])
            lo, hi = s * Nl, (s + 1) * Nl
            halo = dofs[(dofs < lo) | (dofs >= hi)]     # sorted
            shard_elems.append(elems)
            shard_halo.append(halo)
            counts[:, s] = np.bincount(halo // Nl, minlength=S)
        H = max(max((len(h) for h in shard_halo), default=1), 1)
        K = max(int(counts.max()), 1)

        send_idx = np.zeros((S, S, K), np.int32)
        halo_take = np.zeros((S, H), np.int32)
        de, Kblk = _node_blocks(Ke, n, d)
        ids = new_ed.reshape(-1)
        diag_full = _accumulate(ids, de.reshape(E * n, d), S * Nl)
        blocks_full = _accumulate(ids, Kblk.reshape(E * n, d, d), S * Nl)

        per_shard = []
        for s in range(S):
            elems, halo = shard_elems[s], shard_halo[s]
            lo = s * Nl
            ed = new_ed[elems]
            loc = ed - lo
            is_halo = (ed < lo) | (ed >= lo + Nl)
            # local row of a halo dof: Nl + its place in the sorted halo
            loc[is_halo] = Nl + np.searchsorted(halo, ed[is_halo])
            bnd = is_halo.any(axis=1)
            per_shard.append((elems[~bnd], loc[~bnd], elems[bnd], loc[bnd]))
            # halo slots grouped by source shard in ascending dof order:
            # receive row of (src, k) is src * K + k
            srcs = halo // Nl
            k = np.arange(len(halo)) - np.searchsorted(srcs, srcs)
            halo_take[s, :len(halo)] = srcs * K + k
            send_idx[srcs, s, k] = halo - srcs * Nl

        n_int = np.asarray([len(p[0]) for p in per_shard])
        n_bnd = np.asarray([len(p[2]) for p in per_shard])
        Ei, Eb = int(n_int.max()), max(int(n_bnd.max()), 1)
        Ke_int = torch.zeros((S, Ei, nd, nd), dtype=Ke.dtype, device=dev)
        Ke_bnd = torch.zeros((S, Eb, nd, nd), dtype=Ke.dtype, device=dev)
        ld_int = np.zeros((S, Ei, n), np.int32)
        ld_bnd = np.zeros((S, Eb, n), np.int32)
        for s, (ei, li, eb, lb) in enumerate(per_shard):
            Ke_int[s, :len(ei)] = Ke[torch.as_tensor(ei, device=dev)]
            ld_int[s, :len(ei)] = li
            Ke_bnd[s, :len(eb)] = Ke[torch.as_tensor(eb, device=dev)]
            ld_bnd[s, :len(eb)] = lb
        as_dev = lambda a: torch.as_tensor(a.astype(np.float64),  # noqa
                                           device=dev).to(Ke.dtype)
        return cls(S, num_dofs, Nl, H, K, d, perm, Ke_int, ld_int, Ke_bnd,
                   ld_bnd, send_idx, halo_take,
                   as_dev(diag_full.reshape(S, Nl, d)),
                   as_dev(blocks_full.reshape(S, Nl, d, d)), counts,
                   n_int, n_bnd)

    @classmethod
    def from_simulator(cls, sim, n_shards: int) -> "DomainDecomposition":
        """From an ``ElasticitySimulator``: its ``Ke``, ``elem_dofs`` and the
        mesh's node positions carried to the dofs (``dof_map``), on the
        simulator's device."""
        X = np.asarray(sim.mesh.node_positions)
        pos = np.zeros((sim.num_dofs, X.shape[1]))
        pos[sim.dof_map] = X
        return cls.build(sim.Ke, sim.elem_dofs, sim.num_dofs, sim.dim, pos,
                         n_shards)

    @property
    def device(self) -> torch.device:
        return self.Ke_int.device

    def build_routed(self, shards=None):
        """Per-shard ROUTED operators (``parallel/routed_dd.py``), float32,
        on each shard's interior and boundary elements together (the
        exchange completes before the apply).  ``shards``: the shard ids to
        build (default all; a rank builds its own)."""
        from .routed_dd import RoutedShardSpMV

        shards = range(self.n_shards) if shards is None else shards
        Kes = {s: torch.cat([self.Ke_int[s, :self.n_int[s]],
                             self.Ke_bnd[s, :self.n_bnd[s]]])
               for s in shards}
        locs = {s: np.concatenate([self.ld_int[s, :self.n_int[s]],
                                   self.ld_bnd[s, :self.n_bnd[s]]])
                for s in shards}
        return RoutedShardSpMV.build(Kes, locs, self.Nl, self.H, self.d,
                                     device=self.device)

    def shard_ops(self, s: int) -> ShardOps:
        """Shard ``s``'s interior and boundary ``EBEKernel`` (None where the
        shard has no such element) and its send / take tables, built
        once."""
        if s not in self._ops:
            dev = self.device
            ni, nb = int(self.n_int[s]), int(self.n_bnd[s])
            int_op = EBEKernel.build(self.Ke_int[s, :ni],
                                     self.ld_int[s, :ni], self.Nl,
                                     self.d) if ni else None
            bnd_op = EBEKernel.build(self.Ke_bnd[s, :nb],
                                     self.ld_bnd[s, :nb],
                                     self.Nl + self.H, self.d) if nb else None
            send = torch.as_tensor(self.send_idx[s].reshape(-1),
                                   dtype=torch.long, device=dev)
            take = torch.as_tensor(self.halo_take[s], dtype=torch.long,
                                   device=dev)
            self._ops[s] = ShardOps(int_op, bnd_op, send, take)
        return self._ops[s]

    # -- vector layout ----------------------------------------------------
    def to_sharded(self, u):
        """[Nd, d(, m)] old dof order -> [S, Nl, d(, m)] padded, permuted,
        on the decomposition's device."""
        u = torch.as_tensor(u, device=self.device)
        pad = u.new_zeros((self.n_shards * self.Nl,) + tuple(u.shape[1:]))
        pad[torch.as_tensor(self.perm, device=self.device)] = u
        return pad.reshape((self.n_shards, self.Nl) + tuple(u.shape[1:]))

    def from_sharded(self, us):
        flat = us.reshape((self.n_shards * self.Nl,) + tuple(us.shape[2:]))
        return flat[torch.as_tensor(self.perm, device=us.device)]

    def comms_volume_per_spmv(self) -> int:
        """True halo scalars moved per SpMV (accounting, unpadded)."""
        return int(self.halo_counts.sum()) * self.d


@dataclasses.dataclass
class DDCoarse:
    """Replicated aggregation coarse level for the DD solve: each shard
    restricts its OWNED residual rows through a composed P2-dof -> P1-vertex
    -> rigid-body-aggregate prolongator (per dof two target aggregates with
    [d, nm] weight blocks), the small aggregate residual is summed over the
    shards (``sum_partials``), solved by a replicated dense pseudo-inverse
    and prolonged shard-locally.  Additive with the local smoother: M =
    S_block + P C^-1 P^T.  The shard restriction is kernel B (float64 rows
    of nm * m values) on a plan per shard."""

    aggA: np.ndarray      # [S, Nl] aggregate of endpoint vertex A
    aggB: np.ndarray      # [S, Nl]
    WA: torch.Tensor      # [S, Nl, d, nm] weight blocks (0 on padding)
    WB: torch.Tensor      # [S, Nl, d, nm]
    Cinv: torch.Tensor    # [NA * nm, NA * nm] replicated dense pinv
    n_agg: int
    nm: int
    _plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @classmethod
    def from_simulator(cls, sim, dd: DomainDecomposition,
                       agg_size: int = 64, free_mask=None,
                       shift_rel: float = 0.0,
                       stats: dict | None = None) -> "DDCoarse":
        """Host build (reference :237-322): P1 Galerkin (nested in P2) ->
        rigid-body aggregation Galerkin -> dense pinv.  The chain is MASKED
        through the prolongator (rows zeroed at fixed dofs, ``free_mask``
        defaulting to ``~sim.dirichlet_mask``); for floating problems pass
        the all-free mask and a small ``shift_rel``.  ``stats``, when
        given, receives the host seconds of each stage."""
        import time
        from ..ops import element_matrices as em
        from ..solvers.amg import (_rcb_chunks, _rigid_modes,
                                   _tentative_prolongator, _scipy_P)
        from ..sparse import assembly

        t = [time.perf_counter()]
        mesh = sim.mesh
        d = sim.dim
        ND = sim.num_dofs
        dof_map = np.asarray(sim.dof_map)

        vdofs = dof_map[np.asarray(mesh.vertex_nodes)]
        cuniq, cidx = np.unique(vdofs, return_inverse=True)
        NC = len(cuniq)
        ep = mesh.node_endpoint_vertices()
        first = np.zeros(ND, np.int64)
        u_dofs, firsts = np.unique(dof_map, return_index=True)
        first[u_dofs] = firsts
        epd = ep[first]
        cA, cB = cidx[epd[:, 0]], cidx[epd[:, 1]]       # per P2 dof

        g = sim.geom
        Ke1 = em.element_elasticity(g.grad_lambda, g.volume, sim.D, 1)
        elem_c = cidx[np.asarray(mesh.F)]
        A1 = assembly.assemble_scipy(Ke1.cpu().numpy(), elem_c, NC,
                                     d=d).tocsr()
        t.append(time.perf_counter())

        if free_mask is None:
            free_mask = ~np.asarray(sim.dirichlet_mask, bool)
        free = np.asarray(torch.as_tensor(free_mask).cpu(), bool) \
            .reshape(ND, d)
        free1 = free[cuniq]

        pos_c = np.zeros((NC, mesh.node_positions.shape[1]))
        pos_c[cidx] = np.asarray(mesh.V)
        nm = 3 if d == 2 else 6
        agg_of, n_agg = _rcb_chunks(pos_c, agg_size)
        B = _rigid_modes(pos_c, d) * free1[:, :, None]  # masked rows
        Pblk, _ = _tentative_prolongator(B, agg_of, n_agg)
        P = _scipy_P(Pblk, agg_of, n_agg)
        t.append(time.perf_counter())
        Ad = np.asarray((P.T @ A1 @ P).todense())
        t.append(time.perf_counter())
        if shift_rel:
            shift = shift_rel * max(float(np.abs(Ad.diagonal()).mean()),
                                    1e-300)
            Ad = Ad + shift * np.eye(len(Ad))
        Cinv = np.linalg.pinv(Ad, rcond=1e-10, hermitian=True)
        t.append(time.perf_counter())

        # per-dof composed transfers in the DD's permuted, padded layout
        S, Nl = dd.n_shards, dd.Nl
        aggA = np.zeros((S * Nl,), np.int32)
        aggB = np.zeros((S * Nl,), np.int32)
        WA = np.zeros((S * Nl, d, nm))
        WB = np.zeros((S * Nl, d, nm))
        aggA[dd.perm] = agg_of[cA]
        aggB[dd.perm] = agg_of[cB]
        # fine rows masked too: Pbar = M_free P
        WA[dd.perm] = 0.5 * Pblk[cA] * free[:, :, None]
        WB[dd.perm] = 0.5 * Pblk[cB] * free[:, :, None]
        dt, dev = dd.Ke_int.dtype, dd.device
        as_dev = lambda a: torch.as_tensor(a, device=dev).to(dt)  # noqa
        out = cls(aggA.reshape(S, Nl), aggB.reshape(S, Nl),
                  as_dev(WA.reshape(S, Nl, d, nm)),
                  as_dev(WB.reshape(S, Nl, d, nm)), as_dev(Cinv), n_agg, nm)
        t.append(time.perf_counter())
        if stats is not None:
            stats.update(zip(("p1_assembly", "aggregation", "galerkin",
                              "pinv", "transfers"), np.diff(t)))
        return out

    def shard_plan(self, s: int):
        """Shard ``s``'s restriction plan (rows ``[aggA; aggB]`` into the
        aggregates) and its aggregate ids on the device, built once."""
        if s not in self._plans:
            dev = self.WA.device
            ids = np.concatenate([self.aggA[s], self.aggB[s]])
            self._plans[s] = (
                ScatterPlan.build(ids, self.n_agg, dev),
                torch.as_tensor(self.aggA[s], dtype=torch.long, device=dev),
                torch.as_tensor(self.aggB[s], dtype=torch.long, device=dev))
        return self._plans[s]


class _ShardSolver:
    """One column group's PCG over the comm's local shards: the state is
    ``[L, Nl, d, m]`` (L = local shards), elementwise updates run on it all
    at once, and every reduction and apply runs shard by shard."""

    def __init__(self, dd, comm, fs, precond, coarse, routed_spmv):
        self.dd, self.comm, self.coarse = dd, comm, coarse
        self.routed = routed_spmv
        self.shards = list(comm.shards)
        self.fm = fs[..., None]
        self.block = precond == "block"
        if self.block:
            self.Minv = torch.stack([pc.block_jacobi_inv(dd.blocks_s[s],
                                                         fs[i])
                                     for i, s in enumerate(self.shards)])
        else:
            diag = dd.diag_s[self.shards]
            self.safe = torch.where(diag > 0, diag, torch.ones_like(diag))

    def spmv(self, u):
        dd, Nl = self.dd, self.dd.Nl
        ops = [dd.shard_ops(s) for s in self.shards]
        send = torch.stack([u[i][op.send] for i, op in enumerate(ops)])
        pending = self.comm.exchange(send.reshape(
            (len(ops), dd.n_shards, dd.K) + tuple(u.shape[2:])))
        if self.routed is not None:
            recv = pending.wait()
            return torch.stack([
                self.routed.local(s, torch.cat([u[i], recv[i][ops[i].take]]))
                [:Nl].to(u.dtype) for i, s in enumerate(self.shards)])
        # interior elements: no dependence on the exchange in flight
        acc = [u.new_zeros(u.shape[1:]) if op.interior is None
               else op.interior(u[i]) for i, op in enumerate(ops)]
        recv = pending.wait()
        for i, op in enumerate(ops):
            if op.boundary is not None:
                x_loc = torch.cat([u[i], recv[i][op.take]])
                acc[i] = acc[i] + op.boundary(x_loc)[:Nl]
        return torch.stack(acc)

    def dot(self, a, c):
        """Per-column <a, c> over the domain: one partial a local shard (the
        reduction a rank would run, on the same shape), summed in shard
        order."""
        prod = a * c
        return self.comm.sum_partials(torch.stack(
            [prod[i].sum(dim=(0, 1)) for i in range(prod.shape[0])]))

    def smooth(self, v):
        if self.block:
            z = torch.stack([torch.bmm(self.Minv[i], v[i])
                             for i in range(v.shape[0])])
        else:
            z = v / self.safe[..., None]
        return z * self.fm

    def coarse_corr(self, v):
        co = self.coarse
        NA, nm, m = co.n_agg, co.nm, v.shape[-1]
        parts, plans = [], []
        for i, s in enumerate(self.shards):
            plan, a_ids, b_ids = co.shard_plan(s)
            ca = torch.bmm(co.WA[s].transpose(1, 2), v[i])    # [Nl, nm, m]
            cb = torch.bmm(co.WB[s].transpose(1, 2), v[i])
            parts.append(plan(torch.cat([ca, cb]).reshape(-1, nm * m)))
            plans.append((a_ids, b_ids))
        rc = self.comm.sum_partials(torch.stack(parts))
        xc = (co.Cinv @ rc.reshape(NA * nm, m)).reshape(NA, nm, m)
        return torch.stack([
            torch.bmm(co.WA[s], xc[a_ids]) + torch.bmm(co.WB[s], xc[b_ids])
            for s, (a_ids, b_ids) in zip(self.shards, plans)])

    def precondition(self, v):
        z = self.smooth(v)
        if self.coarse is not None:
            z = z + self.coarse_corr(v) * self.fm
        return z

    def start(self, b):
        r = b * self.fm
        z = self.precondition(r)
        return [torch.zeros_like(r), r, z, z, self.dot(r, z)]

    def run(self, state, L):
        x, r, z, p, gamma = state
        for _ in range(L):
            Ap = self.spmv(p) * self.fm
            den = self.dot(p, Ap)
            alpha = torch.where((den != 0) & (gamma != 0),
                                gamma / torch.where(den != 0, den,
                                                    torch.ones_like(den)),
                                torch.zeros_like(den))
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.precondition(r)
            gamma_new = self.dot(r, z)
            beta = torch.where(gamma != 0,
                               gamma_new / torch.where(
                                   gamma != 0, gamma, torch.ones_like(gamma)),
                               torch.zeros_like(gamma))
            p = z + beta * p
            gamma = gamma_new
        return [x, r, z, p, gamma]


def dd_cg_solve(dd: DomainDecomposition, b, comm=None, free_mask=None,
                iters: int = 50, tol: float | None = None,
                precond: str = "jacobi", chunk: int | None = None,
                coarse: DDCoarse | None = None, routed_spmv=None,
                stats: dict | None = None):
    """Domain-decomposed PCG over ``comm`` (default: every shard in this
    process, :class:`~meshfem_tpu_torch.parallel.comm.LocalShards`).

    b [Nd, d] or [Nd, d, m] (original dof order); returns (u matching b's
    shape on the decomposition's device, res2 = final squared residual
    norms, a float64 CPU tensor [m] or scalar).  With ``comm.col_groups``
    > 1 the columns are split into that many groups (padded with zero
    columns to a multiple), each solved with no communication across
    groups; the ``tol`` check reads every group's residuals, as the
    reference's host check reads the gathered ones.

    ``precond``: 'jacobi' (point) or 'block' (exact node blocks); ``coarse``
    adds the two-level :class:`DDCoarse` correction.  ``tol``: relative
    residual target, checked on the host between ``chunk``-iteration runs
    (two chunks without improvement stop the loop); None runs exactly
    ``iters`` iterations.  ``routed_spmv``: a
    :class:`~meshfem_tpu_torch.parallel.routed_dd.RoutedShardSpMV` (from
    ``dd.build_routed()``) makes the shard apply the float32 routed
    operator.  ``stats``, when given, receives the iterations run
    (``"iters"``) and the host chunk count (``"chunks"``)."""
    S, d = dd.n_shards, dd.d
    dt = dd.Ke_int.dtype
    comm = LocalShards(S, dd.device) if comm is None else comm
    if comm.n_shards != S:
        raise ValueError(f"comm has {comm.n_shards} shards, the "
                         f"decomposition {S}")
    if precond not in ("jacobi", "block"):
        raise ValueError(f"unknown precond {precond!r}")

    b = torch.as_tensor(b, device=dd.device).to(dt)
    single = b.dim() == 2
    if single:
        b = b[..., None]
    m = b.shape[-1]
    bg = comm.col_groups
    mb = -(-m // bg)
    if mb * bg != m:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (mb * bg - m,))], -1)
    free = torch.ones((dd.num_dofs, d), dtype=dt, device=dd.device) \
        if free_mask is None else \
        torch.as_tensor(free_mask, device=dd.device).to(dt) \
        .reshape(dd.num_dofs, d)
    loc = torch.as_tensor(comm.shards, device=dd.device)
    fs = dd.to_sharded(free)[loc]
    bs = dd.to_sharded(b)[loc]

    solver = _ShardSolver(dd, comm, fs, precond, coarse, routed_spmv)
    states = {c: solver.start(bs[..., c * mb:(c + 1) * mb])
              for c in comm.cols}
    b2 = comm.gather_cols([solver.dot(st[1], st[1])
                           for st in states.values()])
    b2 = np.maximum(b2.cpu().numpy(), 1e-300)

    if tol is None:
        steps = [iters]
    else:
        c = chunk or min(256, max(iters, 1))
        steps = [min(c, iters - k) for k in range(0, iters, c)]
    res2 = np.zeros(mb * bg)
    best, stall, done, chunks = np.inf, 0, 0, 0
    for L in steps:
        for c in comm.cols:
            states[c] = solver.run(states[c], L)
        done, chunks = done + L, chunks + 1
        res2 = comm.gather_cols([solver.dot(st[1], st[1])
                                 for st in states.values()]).cpu().numpy()
        if tol is not None:
            rel2 = float((res2 / b2).max())
            if rel2 <= tol * tol:
                break
            # PCG residuals are non-monotone and can plateau for a chunk;
            # two chunks in a row without a new best mean a stall
            if rel2 >= best * 0.999:
                stall += 1
                if stall >= 2:
                    break
            else:
                stall = 0
            best = min(best, rel2)
    if stats is not None:
        stats.update(iters=done, chunks=chunks)

    xs = comm.gather_cols([comm.gather_shards(st[0])
                           for st in states.values()])
    u = dd.from_sharded(xs)[..., :m]
    res2 = torch.as_tensor(res2[:m])
    if single:
        return u[..., 0], res2[0]
    return u, res2
