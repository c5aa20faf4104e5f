"""Kernel A, the routed gather slot <- node (0 where ``ids[s] < 0``), in
two output layouts:

* ``gather_planes``: ``out[p, s] = src[p, ids[s]]``, planes ``[P, S]``,
  on no path: the factored rows applies are held bit for bit against the
  planes composition built on it;
* ``gather_rows``: ``out[s, p] = src(ids[s], p)``, rows ``[S, P]``, from
  node rows ``[N, P]`` or from planes ``[P, N]`` read through strides.
  With element-major slots (``s = e * n + a``) the output is the dense
  contraction's ``bmm`` operand ``[E, n*d, m]`` under the node-major Ke,
  and what kernels C and D read in rows.
  Float64 node rows move as float32 pairs (a gather copies bits, so the
  float32 kernel serves them unchanged): the two-level preconditioner's
  prolongation in a float64 solve.

Replaces ``meshfem_tpu/sparse/route.py::_copy_kernel_p`` (:139, planes
mode) and ``::_copy_kernel`` (:187, one plane), the routed gather of every
RoutedEBE apply.  Bound on the H100: memory (ids, the source and the
output; ~213 MB at the block apply's 18 planes, 0.064 ms at 3.35 TB/s).
Design notes are in ``csrc/gather_planes.cu``: planes mode, one thread per
slot looping over the planes; rows mode from node rows with an even P,
16-byte pieces of the output, four a thread with their loads in flight
together, so a warp reads whole source rows and writes in order;
otherwise one thread per slot into a shared-memory tile that the block
writes out in order.
"""

from __future__ import annotations

import torch

from . import _build


def gather_planes_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: src [P, N], ids [S] int32 -> [P, S]."""
    g = src[:, ids.long().clamp(min=0)]
    return torch.where(ids >= 0, g, g.new_zeros(()))


def gather_planes(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """src [P, N] float32, ids [S] int32 (every id < N) -> [P, S].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if src.device.type == "cpu":
        return gather_planes_plain(src, ids)
    _build.check_cuda_args("gather_planes", src, ids, dtypes=(torch.float32,))
    P, N = src.shape
    S = ids.shape[0]
    out = torch.empty((P, S), dtype=src.dtype, device=src.device)
    rc = _build.load().gather_planes_f32(
        src.data_ptr(), ids.data_ptr(), out.data_ptr(), P, N, S,
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(rc, "gather_planes")
    gather_planes.launches += 1
    return out


gather_planes.launches = 0


def gather_rows_plain(src: torch.Tensor, ids: torch.Tensor,
                      planes_in: bool = False) -> torch.Tensor:
    """Plain PyTorch version: src [N, P] (or [P, N] when ``planes_in``),
    ids [S] int32 -> [S, P]."""
    rows = src.t() if planes_in else src
    g = rows[ids.long().clamp(min=0)]
    return torch.where((ids >= 0)[:, None], g, g.new_zeros(()))


def gather_rows(src: torch.Tensor, ids: torch.Tensor,
                planes_in: bool = False) -> torch.Tensor:
    """src [N, P] node rows (or [P, N] planes when ``planes_in``) float32,
    or float64 node rows, ids [S] int32 (every id < N) -> rows [S, P].
    Float64 rows are gathered as float32 pairs ``[N, 2P]`` (bit copies)
    and counted in ``launches_f64`` too.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, ids, planes_in)
    if src.dtype == torch.float64 and not planes_in and src.dim() == 2:
        _build.check_cuda_args("gather_rows", src, ids,
                               dtypes=(torch.float64,))
        out = _gather_rows_f32(src.view(torch.float32), ids, False)
        gather_rows.launches_f64 += 1
        return out.view(torch.float64)
    return _gather_rows_f32(src, ids, planes_in)


def _gather_rows_f32(src, ids, planes_in):
    _build.check_cuda_args("gather_rows", src, ids, dtypes=(torch.float32,))
    if planes_in:
        P, N = src.shape
        node_stride, plane_stride = 1, N
    else:
        N, P = src.shape
        node_stride, plane_stride = P, 1
    S = ids.shape[0]
    if S * P >= 2 ** 31 or P > 384:
        raise ValueError("gather_rows: more than 2^31 output values or "
                         "384 values a node")
    vec4 = (not planes_in and P % 2 == 0 and S * P % 4 == 0
            and src.data_ptr() % 8 == 0)            # 8-byte row pieces
    out = torch.empty((S, P), dtype=src.dtype, device=src.device)
    rc = _build.load().gather_rows_f32(
        src.data_ptr(), ids.data_ptr(), out.data_ptr(), P, node_stride,
        plane_stride, S, int(vec4),
        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
gather_rows.launches_f64 = 0
