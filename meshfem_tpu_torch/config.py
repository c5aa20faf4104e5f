"""Numeric configuration of meshfem_tpu_torch: device, dtypes, TF32 off.

Dtype policy (mirrors ``meshfem_tpu/config.py:44-60``):

* ``REAL`` (float64): mesh geometry, element stiffness ``Ke``, the EBE
  residual operator and iterative refinement;
* ``SOLVE`` (float32): the routed operator and the inner CG; CG dot
  products run in the vector's own dtype (``solvers/cg.py``);
* ``INDEX`` (int32): the index streams the CUDA kernels read.

TF32 is switched off for matmuls and convolutions: the reference insists on
full-f32 products (bf16 passes left ~1e-3 operator error and stalled CG,
``meshfem_tpu/ops/element_matrices.py:147-157``), and TF32 keeps only about
three decimal digits.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA and without that request they raise.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REAL = torch.float64
SOLVE = torch.float32
INDEX = torch.int32

_real = REAL


def real_dtype() -> torch.dtype:
    """Dtype for geometry and assembly (``REAL`` unless ``set_real_dtype``
    changed it; reference ``config.py:44``)."""
    return _real


def index_dtype() -> torch.dtype:
    """Dtype of the connectivity streams the kernels read (``INDEX``)."""
    return INDEX


def accum_dtype() -> torch.dtype:
    """Dtype for scalar reductions inside the solvers (``REAL``)."""
    return REAL


def set_real_dtype(dtype) -> None:
    """Change what ``real_dtype()`` returns, and nothing else, as in the
    reference (``config.py:63``): the modules read ``REAL``."""
    global _real
    _real = dtype


def x64_enabled() -> bool:
    """Float64 is always on in the port (the reference's
    ``MESHFEM_TPU_X64`` switch has no counterpart)."""
    return True


def default_device() -> torch.device:
    """The CUDA device; raises when CUDA is missing (never picks the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "meshfem_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or :func:`default_device` when None."""
    return default_device() if device is None else torch.device(device)


def device_for(device=None, like=None) -> torch.device:
    """``device`` when given, else the device of the tensor ``like``, else
    :func:`default_device`: an entry point handed a tensor works where the
    tensor lies."""
    if device is None and isinstance(like, torch.Tensor):
        return like.device
    return resolve_device(device)
