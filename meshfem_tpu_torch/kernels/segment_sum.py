"""Kernel B, ``segment_sum_csr``: deterministic destination-sorted
segment sum ``out[p, v] = sum_{k in [offsets[v], offsets[v+1])} src[p, perm[k]]``.

Replaces ``meshfem_tpu/sparse/route.py::_reduce_kernel_p`` (:162),
``::_reduce_kernel`` (:207) and RoutedEBE's SumPlan scatter ladder; its
float64 instance carries the f64 EBE residual operator.  Bound on the H100:
memory (~51 MB at the bench size in f32, ~15 us at 3.35 TB/s).  One thread
per destination sums its run in increasing slot order: no atomics, the same
bits every run.  Design notes are in ``csrc/segment_sum_csr.cu``.
"""

from __future__ import annotations

import torch

from . import _build


def segment_sum_csr_plain(src: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: src [P, S], perm [S] int32 (slots sorted
    stably by destination), offsets [N+1] int32 -> [P, N].  On the CPU the
    sum runs in the kernel's order (increasing k per destination)."""
    N = offsets.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(N, device=src.device), (offsets[1:] - offsets[:-1]).long())
    out = src.new_zeros((src.shape[0], N))
    out.index_add_(1, seg, src[:, perm.long()])
    return out


def segment_sum_csr(src: torch.Tensor, perm: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """src [P, S] float32/float64, perm [S] int32, offsets [N+1] int32
    -> [P, N].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if src.device.type == "cpu":
        return segment_sum_csr_plain(src, perm, offsets)
    _build.check_cuda_args("segment_sum_csr", src, perm, offsets,
                           dtypes=(torch.float32, torch.float64))
    P, S = src.shape
    N = offsets.shape[0] - 1
    out = torch.empty((P, N), dtype=src.dtype, device=src.device)
    lib = _build.load()
    fn = (lib.segment_sum_csr_f32 if src.dtype == torch.float32
          else lib.segment_sum_csr_f64)
    rc = fn(src.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), P, S, N,
            torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(rc, "segment_sum_csr")
    segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0
