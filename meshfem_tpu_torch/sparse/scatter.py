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
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import segment_sum_csr, segment_sum_rows

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
        """rows [R] or [R, w] -> [N] or [N, w] segment sums."""
        width = math.prod(rows.shape[1:])
        y = self.sum_rows(rows.reshape(self.num_rows, width).contiguous())
        return y.reshape((self.num_segments,) + tuple(rows.shape[1:]))
