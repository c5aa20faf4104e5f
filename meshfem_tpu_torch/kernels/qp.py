"""Kernel C, ``qp_contract``: the isotropic element apply ``fe = vol Ke ue``
from grad_lambda and the volume alone, strain -> stress -> force at the
quadrature points of ``sparse.contract.qp_tables``.

Replaces ``meshfem_tpu/sparse/contract.py::_qp_kernel`` (:232), the
factored routed backend on the TPU.  Bound on the H100: memory (73 f32 per
element, ~82 MB at the bench size, ~24 us at 3.35 TB/s).  One thread per
element keeps u and f in registers; lam and mu are arguments; the
quadrature tables sit in ``__constant__`` memory.  Design notes are in
``csrc/qp_contract.cu``.

Layout: ``g [K1*d, E]`` (row ``k*d + b`` = d lambda_k / d x_b), ``vol [E]``,
``ue [d, n, E]`` -> ``fe [d, n, E]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sparse.contract import qp_tables
from . import _build

# (dim, deg) -> (configuration index of the kernel's template instance,
# its number of quadrature points); csrc/qp_contract.cu fixes both
CONFIGS = {(3, 2): (0, 4), (3, 1): (1, 1), (2, 2): (2, 3), (2, 1): (3, 1)}
_tables_loaded: set = set()


def _degree(d: int, n: int) -> int:
    """Element degree from the nodes per simplex: d + 1 at P1, (d + 1)(d + 2)/2
    at P2."""
    for deg, nodes in ((1, d + 1), (2, (d + 1) * (d + 2) // 2)):
        if n == nodes:
            return deg
    raise ValueError(f"qp_contract: no P1/P2 simplex of dim {d} has {n} nodes")


@functools.lru_cache(maxsize=None)
def _tables_on(d: int, deg: int, dtype: torch.dtype, device: torch.device):
    dN, W = qp_tables(d, deg)
    return (torch.as_tensor(dN, dtype=dtype, device=device),
            torch.as_tensor(W, dtype=dtype, device=device))


def qp_contract_plain(g, vol, ue, lam, mu):
    """Plain PyTorch version (same arithmetic as the kernel, batched over
    elements), on ``qp_tables`` of ue's dimension and degree."""
    d, n, E = ue.shape
    dN, W = _tables_on(d, _degree(d, n), g.dtype, g.device)
    gl = g.reshape(d + 1, d, E)
    gphi = torch.einsum("qik,kbe->qibe", dN, gl)              # [Q, n, d, E]
    G = torch.einsum("cie,qibe->qcbe", ue, gphi)              # [Q, d, d, E]
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1)            # [Q, E]
    eye = torch.eye(d, dtype=g.dtype, device=g.device)
    S = mu * (G + G.transpose(1, 2)) + lam * tr[:, None, None, :] \
        * eye[None, :, :, None]
    S = S * (W[:, None] * vol[None, :])[:, None, None, :]
    return torch.einsum("qibe,qcbe->cie", gphi, S)


def qp_contract(g, vol, ue, lam: float, mu: float) -> torch.Tensor:
    """g [K1*d, E], vol [E], ue [d, n, E] float32 -> fe [d, n, E].

    The dimension and degree (P1 or P2) follow from ue's shape, and the
    quadrature tables from them (``sparse.contract.qp_tables``).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if g.device.type == "cpu":
        return qp_contract_plain(g, vol, ue, lam, mu)
    d, n, E = ue.shape
    deg = _degree(d, n)
    if (d, deg) not in CONFIGS:
        raise ValueError(f"qp_contract: no kernel for dim {d}, degree {deg}")
    cfg, Q = CONFIGS[(d, deg)]
    _build.check_cuda_args("qp_contract", g, dtypes=(torch.float32,))
    for t, shape in ((vol, (E,)), (ue, (d, n, E))):
        if t.device != g.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"qp_contract: expected contiguous float32 "
                             f"{shape} on {g.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(g.shape) != ((d + 1) * d, E):
        raise ValueError(f"qp_contract: g must be {((d + 1) * d, E)}")
    lib = _build.load()
    key = (g.device.index, cfg)
    if key not in _tables_loaded:
        dN, W = qp_tables(d, deg)
        if dN.shape != (Q, n, d + 1):
            raise RuntimeError(f"qp_contract: kernel config {cfg} has {Q} "
                               f"points, the rule {dN.shape[0]}")
        dN32 = np.ascontiguousarray(dN, dtype=np.float32)
        W32 = np.ascontiguousarray(W, dtype=np.float32)
        with torch.cuda.device(g.device):
            _build.check(lib.qp_set_tables(cfg, dN32.ctypes.data, dN32.size,
                                           W32.ctypes.data, W32.size),
                         "qp_set_tables")
        _tables_loaded.add(key)
    fe = torch.empty_like(ue)
    rc = lib.qp_contract_f32(
        cfg, g.data_ptr(), vol.data_ptr(), ue.data_ptr(), fe.data_ptr(),
        float(lam), float(mu), E,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "qp_contract")
    qp_contract.launches += 1
    return fe


qp_contract.launches = 0
