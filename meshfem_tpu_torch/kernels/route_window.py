"""Kernel F, ``route_window``: windowed lane routing,
``out[v, s, l] = x[win0[v] + widx[v, s, l], lidx[v, s, l]]``.

Replaces ``experiments/probe_route.py::route_kernel`` (:22, ``pallas_call``
at :44), the TPU micro-benchmark of in-register lane routing: each output
vreg ``[8, 128]`` takes its values from a chain of ``chain`` 128-lane
windows of ``x`` starting at row ``win0[v]``.  A ``widx`` outside
``[0, chain)`` routes 0.0, as the TPU kernel's masked accumulate does;
``lidx`` is taken modulo 128, and window rows outside ``x`` read as 0.
No path of the package runs it: ``chip_smoke.py`` drives it at the probe's
shapes and times it beside kernel A on the same count of routed values.

Bound on the H100: memory (widx, lidx and out, 4 B a value each, plus x;
~94 MB at the probe's shapes, 0.028 ms at 3.35 TB/s).  Design notes are in
``csrc/route_window.cu``: a block stages the windows of 4 consecutive v in
shared memory, then routes 4 values a thread with 16-byte loads and
streaming stores.
"""

from __future__ import annotations

import torch

from . import _build

LANES = 128


def route_window_plain(x: torch.Tensor, win0: torch.Tensor,
                       widx: torch.Tensor, lidx: torch.Tensor,
                       chain: int) -> torch.Tensor:
    """Plain PyTorch version: x [NT, 128] float32, win0 [NV] int32, widx
    and lidx [NV, S, 128] int32 -> [NV, S, 128]."""
    rows = win0.long()[:, None, None] + widx.long()
    ok = (widx >= 0) & (widx < chain) & (rows >= 0) & (rows < x.shape[0])
    g = x[rows.clamp(0, x.shape[0] - 1), (lidx & (LANES - 1)).long()]
    return torch.where(ok, g, g.new_zeros(()))


def route_window(x: torch.Tensor, win0: torch.Tensor, widx: torch.Tensor,
                 lidx: torch.Tensor, chain: int) -> torch.Tensor:
    """x [NT, 128] float32, win0 [NV] int32, widx and lidx [NV, S, 128]
    int32 -> [NV, S, 128].  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return route_window_plain(x, win0, widx, lidx, chain)
    _build.check_cuda_args("route_window", x, win0, dtypes=(torch.float32,))
    NV = win0.shape[0]
    if x.shape[1] != LANES:
        raise ValueError(f"route_window: x must be [NT, {LANES}]")
    for t in (widx, lidx):
        if t.device != x.device or t.dtype != torch.int32 or t.dim() != 3 \
                or t.shape[0] != NV or t.shape[2] != LANES \
                or not t.is_contiguous():
            raise ValueError(f"route_window: widx and lidx must be "
                             f"contiguous int32 [{NV}, S, {LANES}] on "
                             f"{x.device}")
    if widx.shape != lidx.shape:
        raise ValueError("route_window: widx and lidx differ in shape")
    if widx.data_ptr() % 16 or lidx.data_ptr() % 16:
        raise ValueError("route_window: widx and lidx must be 16-byte "
                         "aligned (the kernel reads them 4 values at a time)")
    if not 1 <= chain <= 100:
        raise ValueError("route_window: chain must be in [1, 100]")
    out = torch.empty(widx.shape, dtype=x.dtype, device=x.device)
    rc = _build.load().route_window_f32(
        x.data_ptr(), win0.data_ptr(), widx.data_ptr(), lidx.data_ptr(),
        out.data_ptr(), int(chain), x.shape[0], NV,
        widx.shape[1] * LANES,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "route_window")
    route_window.launches += 1
    return out


route_window.launches = 0
