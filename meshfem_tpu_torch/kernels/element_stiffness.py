"""Kernel E, ``element_stiffness``: float32 element-stiffness assembly of a
constant material, ``Ke[e] = vol_e (g_e (x) g_e) @ M`` with ``M =
fused_matrix_for(D)``.

Replaces ``meshfem_tpu/kernels/element_stiffness.py::_asm_kernel`` (:42),
the float32 drop-in for ``ops.element_matrices.
element_elasticity_fused_apply`` (which stays the default assembly, as in
the reference).  Bound on the H100: memory (~0.30 ms to write 1.0 GB at
the bench size).  The kernel contracts the material first and the
gradgrad table second (``H = g g C``, 9 terms; ``Ke = vol T H``, 16 terms):
~15.3k multiply-adds per element where the TPU kernel's one product with
``M`` does 129.6k, accumulated in float64 on the FP64 cores and rounded
once to float32, so its ``Ke`` is the float64 ``Ke`` cast to float32 to
within an ulp (a float32 accumulation took the dense clamped solve from
4,099 to 5,225 inner iterations on the H100).  A warp owns 32 (element,
node, half-row) lanes, whose rows of ``Ke`` are one contiguous run it
writes with 16-byte streaming stores; design notes are in
``csrc/element_stiffness.cu``.

``grad_lambda [E, K+1, d]``, ``volume [E]`` float32, ``D [fl, fl]`` (the
constant material, any dtype and device), ``deg`` -> ``Ke [E, n d, n d]``
float32.  The wrapper caches the float64 gradgrad table and full material
tensor on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fem.flattening import full_to_flat_map
from ..ops.element_matrices import fused_matrix_for
from . import _build
from .factored import _table_on
from .qp import CONFIGS


def _material_key(D):
    """``D``'s float64 values, as a hashable key (and its side).  ``D``
    must be symmetric to float32 rounding (``|D - D^T| <= 2^-20 max|D|``):
    the kernel computes ``H[k,l,c,f]`` for ``k <= l`` only and mirrors it,
    which holds only for a symmetric material."""
    D64 = np.asarray(torch.as_tensor(D).detach().cpu(), dtype=np.float64)
    if D64.ndim != 2 or D64.shape[0] != D64.shape[1] \
            or D64.shape[0] not in (3, 6):
        raise ValueError(f"element_stiffness: D must be a constant [3, 3] or "
                         f"[6, 6] material, got {tuple(D64.shape)}")
    asym = np.abs(D64 - D64.T).max()
    if not asym <= 2.0 ** -20 * np.abs(D64).max():
        raise ValueError(f"element_stiffness: D must be symmetric, got "
                         f"max|D - D^T| = {asym:.3e} (max|D| "
                         f"{np.abs(D64).max():.3e})")
    return D64.tobytes(), D64.shape[0]


@functools.lru_cache(maxsize=16)
def _material(key: bytes, fl: int) -> np.ndarray:
    """The full tensor ``C[c, a, f, b] = D[flat(c, a), flat(f, b)]``
    (``fused_matrix_for``'s), float64 on the host: the kernel takes it as
    a launch parameter."""
    D = np.frombuffer(key, dtype=np.float64).reshape(fl, fl)
    f2f = full_to_flat_map({3: 2, 6: 3}[fl])
    return np.ascontiguousarray(D[f2f[:, :, None, None],
                                  f2f[None, None, :, :]])


@functools.lru_cache(maxsize=16)
def _fused_on(key: bytes, fl: int, K: int, deg: int, dtype: torch.dtype,
              device: torch.device):
    D = np.frombuffer(key, dtype=np.float64).reshape(fl, fl).copy()
    return torch.as_tensor(fused_matrix_for(D, K, deg), dtype=dtype,
                           device=device)


def element_stiffness_plain(grad_lambda, volume, D, deg: int):
    """Plain PyTorch version, the TPU kernel's one-product form: the Gram
    block scaled by the volume, times ``fused_matrix_for(D)``."""
    E, K1, d = grad_lambda.shape
    M = _fused_on(*_material_key(D), K1 - 1, deg, grad_lambda.dtype,
                  grad_lambda.device)
    nd = int(round(M.shape[1] ** 0.5))
    gg = torch.einsum("eka,elb->ekalb", grad_lambda,
                      grad_lambda).reshape(E, K1 * d * K1 * d)
    return torch.matmul(gg * volume[:, None], M).reshape(E, nd, nd)


def element_stiffness(grad_lambda, volume, D, deg: int) -> torch.Tensor:
    """Float32 element stiffness of the constant material ``D`` on P1 or P2
    simplices.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises).  The kernel is float32 only: a float64
    ``Ke`` stays one ``torch.matmul``
    (``ops.element_matrices.element_elasticity_fused``)."""
    if grad_lambda.device.type == "cpu":
        return element_stiffness_plain(grad_lambda, volume, D, deg)
    if grad_lambda.dim() != 3:
        raise ValueError("element_stiffness: grad_lambda must be [E, K+1, d]")
    E, K1, d = grad_lambda.shape
    if K1 != d + 1 or (d, deg) not in CONFIGS:
        raise ValueError(f"element_stiffness: no kernel for K = {K1 - 1}, "
                         f"dim {d}, degree {deg}")
    _build.check_cuda_args("element_stiffness",
                           grad_lambda.reshape(E, K1 * d),
                           dtypes=(torch.float32,))
    for t, shape in ((grad_lambda, (E, K1, d)), (volume, (E,))):
        if t.device != grad_lambda.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"element_stiffness: expected contiguous "
                             f"float32 {shape} on {grad_lambda.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dev = grad_lambda.device
    T = _table_on(d, deg, torch.float64, dev)
    C = _material(*_material_key(D))
    n = T.shape[-1]
    Ke = torch.empty((E, n * d, n * d), dtype=torch.float32, device=dev)
    rc = _build.load().element_stiffness_f32(
        CONFIGS[(d, deg)][0], grad_lambda.data_ptr(), volume.data_ptr(),
        T.data_ptr(), C.ctypes.data, Ke.data_ptr(), E,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "element_stiffness")
    element_stiffness.launches += 1
    return Ke


element_stiffness.launches = 0
