"""How the shards of a multi-device solve talk to each other.

The reference runs its multi-device layer as one SPMD program: a
``jax.sharding.Mesh`` with a domain axis ``"e"`` and a right-hand-side axis
``"b"``, ``shard_map`` over it, ``lax.all_to_all`` for the halo and
``lax.psum`` for the CG scalars (``meshfem_tpu/parallel/domain.py:347-397``).
The port writes the per-shard code once and gives it one interface with two
implementations:

* :class:`LocalShards` keeps every shard in this process, on one device:
  the exchange is an index copy and each shard runs the same per-shard code
  a rank would (the arrangement the reference's tests run on eight virtual
  CPU devices, and what one card runs);
* :class:`RankShards` puts one shard on each rank of a
  ``torch.distributed`` process group: gloo carries CPU tensors, NCCL CUDA
  tensors, and a tensor on the other kind of device raises.

The interface, on a leading axis of the shards this process holds (all
``S`` of them locally, one on a rank):

* ``exchange(send)``: the halo all-to-all over the reference's padded send
  slots ``[L, S, K, ...]`` (every split the same size); returns a handle
  whose ``wait()`` gives ``[L, S * K, ...]``, slot ``src * K + k`` from
  shard ``src``.  On ranks it is started asynchronously, so the interior
  apply overlaps it as the reference's does;
* ``sum_partials(parts)``: the sum over the domain's shards of per-shard
  partials ``[L, ...]`` (CG scalars, the coarse residual, the
  element-sharded apply), in shard order.  On ranks it is an
  ``all_gather`` summed in rank order on every rank, never a bare
  ``all_reduce``: every rank gets the same bits, and an S-rank solve the
  bits of an S-shard solve in one process;
* ``gather_shards(x)``: ``[L, ...]`` -> ``[S, ...]``, every shard's part;
* right-hand-side columns split into ``col_groups`` groups (the reference's
  ``"b"`` axis), with no communication across groups inside a solve:
  ``cols`` lists the groups this process solves, ``gather_cols(blocks)``
  puts their results back together along the last axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import config


class _Ready:
    """Handle of an exchange that finished when it was started."""

    def __init__(self, out):
        self.out = out

    def wait(self):
        return self.out


class _Pending:
    """Handle of an asynchronous ``all_to_all_single``."""

    def __init__(self, work, out, shape):
        self.work, self.out, self.shape = work, out, shape

    def wait(self):
        self.work.wait()
        return self.out.reshape(self.shape)


def _sum_in_order(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class LocalShards:
    """``n_shards`` domain shards (and ``col_groups`` column groups), all in
    this process on ``device``."""

    def __init__(self, n_shards: int, device=None, col_groups: int = 1):
        if n_shards < 1 or col_groups < 1:
            raise ValueError("n_shards and col_groups must be >= 1")
        self.n_shards = int(n_shards)
        self.col_groups = int(col_groups)
        self.device = config.resolve_device(device)
        self.shards = list(range(self.n_shards))
        self.cols = list(range(self.col_groups))

    def _check(self, t, what):
        if t.device != self.device and not (
                t.device.type == self.device.type == "cuda"
                and self.device.index is None):
            raise ValueError(f"LocalShards.{what}: tensor on {t.device}, "
                             f"shards on {self.device}")

    def exchange(self, send):
        self._check(send, "exchange")
        S = self.n_shards
        if send.shape[:2] != (S, S):
            raise ValueError(f"exchange: send must be [{S}, {S}, K, ...]")
        # recv[dst, src * K + k] = send[src, dst, k]
        return _Ready(send.transpose(0, 1).reshape(
            (S, -1) + tuple(send.shape[3:])))

    def sum_partials(self, parts):
        self._check(parts, "sum_partials")
        if parts.shape[0] != self.n_shards:
            raise ValueError("sum_partials: one partial a shard")
        return _sum_in_order(list(parts))

    def gather_shards(self, x):
        self._check(x, "gather_shards")
        return x

    def gather_cols(self, blocks):
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-1)


class RankShards:
    """One shard on each rank of ``group`` (default: the whole world).

    With ``col_groups = b`` the group's ``S * b`` ranks form an S x b grid,
    rank ``e * b + c`` holding domain shard ``e`` of column group ``c``
    (the reference's ``devices.reshape(e, b)``); the halo and the partial
    sums run among the ranks of one column group.  Every rank of ``group``
    must construct it, in the same order as any other group it makes."""

    def __init__(self, group=None, col_groups: int = 1):
        group = dist.group.WORLD if group is None else group
        ranks = dist.get_process_group_ranks(group)
        world, me = len(ranks), dist.get_rank(group)
        if col_groups < 1 or world % col_groups:
            raise ValueError(f"{world} ranks do not split into "
                             f"{col_groups} column groups")
        b = int(col_groups)
        S = world // b
        e, c = divmod(me, b)
        self.n_shards, self.col_groups = S, b
        self.shards, self.cols = [e], [c]
        self.backend = dist.get_backend(group)
        if self.backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"RankShards: no rule for backend "
                             f"{self.backend!r}")
        if b == 1:
            self.domain, self.colgroup = group, None
        else:
            self.domain = self.colgroup = None
            for cc in range(b):          # every rank makes every group
                g = dist.new_group([ranks[ee * b + cc] for ee in range(S)],
                                   backend=self.backend)
                if cc == c:
                    self.domain = g
            for ee in range(S):
                g = dist.new_group([ranks[ee * b + cc] for cc in range(b)],
                                   backend=self.backend)
                if ee == e:
                    self.colgroup = g

    def _check(self, t, what):
        want = "cuda" if self.backend == "nccl" else "cpu"
        if t.device.type != want:
            raise ValueError(f"RankShards.{what}: a {self.backend} group "
                             f"carries {want} tensors, got {t.device}")

    def exchange(self, send):
        self._check(send, "exchange")
        S = self.n_shards
        if send.shape[:2] != (1, S):
            raise ValueError(f"exchange: send must be [1, {S}, K, ...]")
        inp = send[0].contiguous()
        out = torch.empty_like(inp)
        work = dist.all_to_all_single(out, inp, group=self.domain,
                                      async_op=True)
        return _Pending(work, out, (1, -1) + tuple(send.shape[3:]))

    def _all_gather(self, t, group, n):
        t = t.contiguous()
        bufs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(bufs, t, group=group)
        return bufs

    def sum_partials(self, parts):
        self._check(parts, "sum_partials")
        if parts.shape[0] != 1:
            raise ValueError("sum_partials: one partial a shard")
        return _sum_in_order(self._all_gather(parts[0], self.domain,
                                              self.n_shards))

    def gather_shards(self, x):
        self._check(x, "gather_shards")
        return torch.stack(self._all_gather(x[0], self.domain,
                                            self.n_shards))

    def gather_cols(self, blocks):
        (blk,) = blocks
        if self.colgroup is None:
            return blk
        self._check(blk, "gather_cols")
        return torch.cat(self._all_gather(blk, self.colgroup,
                                          self.col_groups), dim=-1)
