"""Deterministic scatter-add as a destination-sorted CSR segment sum.

Counterpart of ``meshfem_tpu/sparse/scatter.py::ScatterPlan``.  The
reference builds a two-level pyramid of flat gathers because XLA:TPU
scatters are slow; on the GPU one plan (``perm``: rows sorted stably by
segment, ``offsets [N+1]``) feeds kernel B (``kernels/segment_sum.py``),
whose per-segment sums run in a fixed order: bit-for-bit deterministic,
no atomics, in float32 or float64.  Contributions come as rows ``[R, w]``
(``__call__``, ``sum_rows``: the f64 EBE operator, node blocks, both
routed backends) or as planes ``[P, R]`` (``sum_planes``: on no path, the
planes composition the factored applies are held against); rows are
summed as they lie, with no transpose.

``__call__`` is differentiable: it runs through ``_SegmentSum``, a
``torch.autograd.Function`` whose backward is the mirror gather
(``GatherPlan``, kernel A: each row takes its segment's output gradient)
and whose mirror's backward is this sum again, so kernels A and B are each
other's adjoints and a second derivative runs on them too.  Both maps are
linear, so their forward-mode rules apply the same map to the tangent.  On
a CUDA tensor neither ever takes ``index_add_`` or an accumulating
``index_put_``, which sum in no fixed order.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict

import numpy as np
import torch

from .. import config
from ..kernels import gather_rows, segment_sum_csr, segment_sum_rows

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class ScatterPlan:
    """Plan to sum R contribution rows into N segments."""

    perm: torch.Tensor       # [R] int32 row ids sorted stably by segment
    offsets: torch.Tensor    # [N+1] int32 CSR run starts
    num_rows: int            # R
    num_segments: int        # N

    @classmethod
    def build(cls, ids, num_segments: int, device) -> "ScatterPlan":
        """``ids [R]`` segment of each row (host array, all in [0, N))."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids) > _INT32_MAX:
            raise ValueError("more rows than an int32 index stream can hold")
        if len(ids) and (ids.min() < 0 or ids.max() >= num_segments):
            raise ValueError("segment ids out of range")
        perm = np.argsort(ids, kind="stable").astype(np.int32)
        counts = np.bincount(ids, minlength=num_segments)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return cls(torch.as_tensor(perm, device=device),
                   torch.as_tensor(offsets, device=device),
                   len(ids), int(num_segments))

    def renumbered(self, new_row: torch.Tensor) -> "ScatterPlan":
        """The same plan over rows renumbered ``r -> new_row[r]``: every
        segment sums the same contributions in the same order."""
        return dataclasses.replace(
            self, perm=new_row[self.perm.long()].to(torch.int32))

    def sum_planes(self, src: torch.Tensor) -> torch.Tensor:
        """src [P, R] (contiguous planes) -> [P, N]."""
        return segment_sum_csr(src, self.perm, self.offsets)

    def sum_rows(self, src: torch.Tensor,
                 planes_out: bool = False) -> torch.Tensor:
        """src [R, P] (contiguous rows) -> [N, P] (or [P, N] when
        ``planes_out``)."""
        return segment_sum_rows(src, self.perm, self.offsets, planes_out)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [R] or [R, w] (any trailing shape) -> [N] or [N, w] segment
        sums; differentiable, with kernel A as its adjoint."""
        width = math.prod(rows.shape[1:])
        y = _SegmentSum.apply(rows.reshape(self.num_rows, width), self)
        return y.reshape((self.num_segments,) + tuple(rows.shape[1:]))

    @property
    def ids(self) -> torch.Tensor:
        """[R] int32 segment of each row (-1 for a row no segment sums),
        built once, on the plan's device, when a gradient first needs it."""
        if getattr(self, "_ids", None) is None:
            counts = (self.offsets[1:] - self.offsets[:-1]).long()
            seg = torch.repeat_interleave(
                torch.arange(self.num_segments, device=self.perm.device,
                             dtype=torch.int32), counts)
            perm = self.perm.long()
            if perm.numel() and int(torch.bincount(
                    perm, minlength=self.num_rows).max()) > 1:
                raise ValueError("a row summed into two segments has no "
                                 "single-gather adjoint")
            ids = torch.full((self.num_rows,), -1, dtype=torch.int32,
                             device=self.perm.device)
            ids[perm] = seg
            self._ids = ids
        return self._ids

    @property
    def adjoint(self) -> "GatherPlan":
        """The gather each row of its segment: this sum's transpose."""
        if getattr(self, "_adjoint", None) is None:
            self._adjoint = GatherPlan(self.ids, self.num_segments, self)
        return self._adjoint


@dataclasses.dataclass
class GatherPlan:
    """Rows ``out[s] = src[ids[s]]`` (0 where ``ids[s] < 0``): kernel A on
    the card, the plain index on the CPU, differentiable with kernel B on
    the plan of the same ids as its adjoint (``_GatherRows``)."""

    ids: torch.Tensor        # [S] int32 source row of each output row
    num_sources: int         # N rows of the source
    _adjoint: ScatterPlan | None = None

    @classmethod
    def build(cls, ids, num_sources: int, device) -> "GatherPlan":
        """``ids [S]`` (host array, all in [0, N))."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids) and (ids.min() < 0 or ids.max() >= num_sources):
            raise ValueError("source ids out of range")
        return cls(torch.as_tensor(ids.astype(np.int32), device=device),
                   int(num_sources))

    @property
    def adjoint(self) -> ScatterPlan:
        """The segment sum by the same ids (the CSR plan, built once)."""
        if self._adjoint is None:
            plan = ScatterPlan.build(self.ids.cpu().numpy(),
                                     self.num_sources, self.ids.device)
            plan._ids, plan._adjoint = self.ids, self
            self._adjoint = plan
        return self._adjoint

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """src [N] or [N, ...] -> [S] or [S, ...]."""
        width = math.prod(src.shape[1:])
        y = _GatherRows.apply(src.reshape(self.num_sources, width), self)
        return y.reshape((self.ids.shape[0],) + tuple(src.shape[1:]))


class _SegmentSum(torch.autograd.Function):
    """rows [R, w] -> [N, w] by kernel B; backward: kernel A gathers each
    row's segment of the output gradient."""

    @staticmethod
    def forward(rows, plan):
        return plan.sum_rows(rows.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.plan.adjoint), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return ctx.plan.sum_rows(tangent.contiguous())


class _GatherRows(torch.autograd.Function):
    """src [N, w] -> [S, w] by kernel A; backward: kernel B sums each
    output row's gradient into its source row."""

    @staticmethod
    def forward(src, plan):
        return gather_rows(src.contiguous(), plan.ids)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _SegmentSum.apply(grad, ctx.plan.adjoint), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return gather_rows(tangent.contiguous(), ctx.plan.ids)


PLAN_CACHE_SIZE = 16
_PLAN_CACHE: OrderedDict = OrderedDict()


def plan_for(ids, num_segments: int, device=None) -> ScatterPlan:
    """A ``ScatterPlan`` cached by content (reference :102): keyed on a
    SHA-1 of the id bytes, the id count, ``num_segments`` and the device,
    so two different id arrays never share a plan.  The cache keeps the
    ``PLAN_CACHE_SIZE`` plans used last, so it pins a bounded amount of
    device memory.  (The reference's ``g1``, its pyramid's group size, has
    no counterpart: the CSR plan has no groups.)"""
    import hashlib

    dev = config.resolve_device(device)
    ids = np.ascontiguousarray(np.asarray(ids).reshape(-1))
    key = (hashlib.sha1(ids.tobytes()).hexdigest(), ids.size,
           int(num_segments), str(dev))
    plan = _PLAN_CACHE.pop(key, None)
    if plan is None:
        plan = ScatterPlan.build(ids, num_segments, dev)
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > PLAN_CACHE_SIZE:
        _PLAN_CACHE.popitem(last=False)
    return plan
