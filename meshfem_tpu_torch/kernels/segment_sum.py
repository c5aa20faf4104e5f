"""Kernel B, the deterministic destination-sorted segment sum
``out(v, p) = sum_{k in [offsets[v], offsets[v+1])} src(perm[k], p)``, in
two input layouts:

* ``segment_sum_csr``: contribution planes ``[P, S]`` -> ``[P, N]``, on
  no path: the factored rows applies are held bit for bit against the
  planes composition built on it;
* ``segment_sum_rows``: contribution rows ``[R, P]`` -> node rows
  ``[N, P]``, or planes ``[P, N]`` written through strides.

Both launch one kernel (``csrc/segment_sum_csr.cu``), in float32 or
float64: one thread per (destination, plane) value walks its
destination's run in increasing ``k``, in rounds of 8 contributions whose
index and value loads are all in flight together, and adds in that order
in one register (staging a block's contribution rows in shared memory was
tried and dropped: level at 3 values a node, slower at 18).  No atomics,
the same bits every run, and the same bits from rows and planes given the
same contributions in the same order.

Replaces ``meshfem_tpu/sparse/route.py::_reduce_kernel_p`` (:162),
``::_reduce_kernel`` (:207) and RoutedEBE's SumPlan scatter ladder; its
float64 instance carries the f64 EBE residual operator.  Bound on the H100:
memory (~214 MB at the block apply's 18 float32 planes, 0.064 ms at 3.35
TB/s).
"""

from __future__ import annotations

import torch

from . import _build


def _segments(offsets: torch.Tensor) -> torch.Tensor:
    N = offsets.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(N, device=offsets.device),
        (offsets[1:] - offsets[:-1]).long())


def segment_sum_csr_plain(src: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: src [P, S], perm [S] int32 (slots sorted
    stably by destination), offsets [N+1] int32 -> [P, N].  On the CPU the
    sum runs in the kernel's order (increasing k per destination)."""
    out = src.new_zeros((src.shape[0], offsets.shape[0] - 1))
    out.index_add_(1, _segments(offsets), src[:, perm.long()])
    return out


def segment_sum_rows_plain(src: torch.Tensor, perm: torch.Tensor,
                           offsets: torch.Tensor,
                           planes_out: bool = False) -> torch.Tensor:
    """Plain PyTorch version: src [R, P], perm [R] int32, offsets [N+1]
    int32 -> [N, P] (or [P, N] when ``planes_out``), in the kernel's
    order on the CPU."""
    out = src.new_zeros((offsets.shape[0] - 1, src.shape[1]))
    out.index_add_(0, _segments(offsets), src[perm.long()])
    return out.t().contiguous() if planes_out else out


def _launch(what, src, perm, offsets, P, src_strides, out_shape,
            out_strides):
    _build.check_cuda_args(what, src, perm, offsets,
                           dtypes=(torch.float32, torch.float64))
    N = offsets.shape[0] - 1
    if N * P >= 2 ** 31:
        raise ValueError(f"{what}: more than 2^31 output values")
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    lib = _build.load()
    fn = (lib.segment_sum_f32 if src.dtype == torch.float32
          else lib.segment_sum_f64)
    rc = fn(src.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), P, *src_strides, *out_strides, N,
            torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(rc, what)
    return out


def segment_sum_csr(src: torch.Tensor, perm: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """src [P, S] float32/float64, perm [S] int32, offsets [N+1] int32
    -> [P, N].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if src.device.type == "cpu":
        return segment_sum_csr_plain(src, perm, offsets)
    P, S = src.shape
    N = offsets.shape[0] - 1
    out = _launch("segment_sum_csr", src, perm, offsets, P, (1, S), (P, N),
                  (1, N))
    segment_sum_csr.launches += 1
    if src.dtype == torch.float64:
        segment_sum_csr.launches_f64 += 1
    return out


segment_sum_csr.launches = 0
segment_sum_csr.launches_f64 = 0


def segment_sum_rows(src: torch.Tensor, perm: torch.Tensor,
                     offsets: torch.Tensor,
                     planes_out: bool = False) -> torch.Tensor:
    """src [R, P] float32/float64 rows, perm [R] int32, offsets [N+1]
    int32 -> node rows [N, P] (or planes [P, N] when ``planes_out``).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if src.device.type == "cpu":
        return segment_sum_rows_plain(src, perm, offsets, planes_out)
    R, P = src.shape
    N = offsets.shape[0] - 1
    out_shape, out_strides = ((P, N), (1, N)) if planes_out \
        else ((N, P), (P, 1))
    out = _launch("segment_sum_rows", src, perm, offsets, P, (P, 1),
                  out_shape, out_strides)
    segment_sum_rows.launches += 1
    if src.dtype == torch.float64:
        segment_sum_rows.launches_f64 += 1
    return out


segment_sum_rows.launches = 0
segment_sum_rows.launches_f64 = 0
