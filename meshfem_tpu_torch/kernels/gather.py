"""Kernel A, ``gather_planes``: ``out[p, s] = src[p, ids[s]]`` (0 where
``ids[s] < 0``).

Replaces ``meshfem_tpu/sparse/route.py::_copy_kernel_p`` (:139, planes
mode) and ``::_copy_kernel`` (:187, one plane), the routed gather of every
RoutedEBE apply.  Bound on the H100: memory (ids, the source planes and the
output, ~50 MB at the bench size, ~15 us at 3.35 TB/s).  Design notes are
in ``csrc/gather_planes.cu``: one thread per slot reads its index once and
loops over the planes.
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
