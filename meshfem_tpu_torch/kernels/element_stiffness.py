"""Kernel E, ``element_stiffness``: fused float32 element-stiffness
assembly ``Ke[e] = vol_e (g_e (x) g_e) @ M``.

Replaces ``meshfem_tpu/kernels/element_stiffness.py::_asm_kernel`` (:42),
the float32 drop-in for ``ops.element_matrices.
element_elasticity_fused_apply`` (which stays the default assembly, as in
the reference).  Bound on the H100: memory (~0.30 ms to write 1.0 GB at
the bench size; the function needs ~15.7k multiply-adds per element when
the material is contracted before the table, ~0.13 ms).  The one-product
form kept here does 2 gdim^2 (n d)^2 flops per element, 72.6 GFLOP and
~1.08 ms at the 67 TFLOP/s float32 rate: the algorithm's own arithmetic
time, not a bound.  The product is a
register-tiled float32 FMA loop over column tiles of M held in shared
memory, no tensor cores (TF32 would leave ~1e-3 operator error); design
notes are in ``csrc/element_stiffness.cu``.

``grad_lambda [E, K+1, d]``, ``volume [E]``, ``M_fused [((K+1) d)^2,
(n d)^2]`` float32 -> ``Ke [E, n d, n d]`` float32.
"""

from __future__ import annotations

import math

import torch

from . import _build


def element_stiffness_plain(grad_lambda, volume, M_fused):
    """Plain PyTorch version: the Gram block scaled by the volume, times M."""
    E, K1, d = grad_lambda.shape
    gdim = K1 * d
    nd = math.isqrt(M_fused.shape[1])
    gg = torch.einsum("eka,elb->ekalb", grad_lambda,
                      grad_lambda).reshape(E, gdim * gdim)
    return torch.matmul(gg * volume[:, None], M_fused).reshape(E, nd, nd)


def element_stiffness(grad_lambda, volume, M_fused) -> torch.Tensor:
    """Float32 element stiffness of a constant material.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (or raises).  The
    kernel is float32 only: a float64 ``Ke`` stays one ``torch.matmul``
    (``ops.element_matrices.element_elasticity_fused``)."""
    if grad_lambda.device.type == "cpu":
        return element_stiffness_plain(grad_lambda, volume, M_fused)
    if grad_lambda.dim() != 3:
        raise ValueError("element_stiffness: grad_lambda must be [E, K+1, d]")
    E, K1, d = grad_lambda.shape
    gdim = K1 * d
    _build.check_cuda_args("element_stiffness", M_fused,
                           dtypes=(torch.float32,))
    nd2 = M_fused.shape[1]
    nd = math.isqrt(nd2)
    if M_fused.shape[0] != gdim * gdim or nd * nd != nd2 or nd2 % 4 \
            or gdim > 12:
        raise ValueError(f"element_stiffness: M must be [{gdim * gdim}, "
                         f"(n d)^2] with (n d)^2 a multiple of 4 and "
                         f"(K+1) d <= 12, got {tuple(M_fused.shape)}")
    for t, shape in ((grad_lambda, (E, K1, d)), (volume, (E,))):
        if t.device != M_fused.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"element_stiffness: expected contiguous "
                             f"float32 {shape} on {M_fused.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    Ke = torch.empty((E, nd, nd), dtype=torch.float32,
                     device=M_fused.device)
    rc = _build.load().element_stiffness_f32(
        grad_lambda.data_ptr(), volume.data_ptr(), M_fused.data_ptr(),
        Ke.data_ptr(), gdim, nd2, E,
        torch.cuda.current_stream(M_fused.device).cuda_stream)
    _build.check(rc, "element_stiffness")
    element_stiffness.launches += 1
    return Ke


element_stiffness.launches = 0
