"""Kernel D, ``factored_contract``: the isotropic element apply
``fe = vol Ke ue`` through the gradgrad table ``T[k, l, i, j]``:

    d1[k, j]   = sum_c g[k, c] u[c, j]
    m1[k, i]   = sum_lj T[k, l, i, j] d1[l, j]
    m2[l, i]   = sum_kj T[k, l, i, j] d1[k, j]
    q_c[km, i] = sum_j T[k, m, i, j] u[c, j],     G2[km] = g_k . g_m
    f[c, i]    = vol (mu sum_km G2[km] q_c[km, i]
                      + sum_k g[k, c] (lam m1[k, i] + mu m2[k, i]))

Replaces ``meshfem_tpu/sparse/contract.py::_factored_kernel`` (:91), the
TQ-table backend of the routed operator (``MESHFEM_FACTORED_TQ=1``).  Same
layouts as kernel C, so ``RoutedEBE._contract`` switches between the two on
the environment variable alone.  Bound on the H100: memory, as for kernel
C (the same function of the same inputs: ~24 us for its bytes at the bench
size).  The table form's own arithmetic, ~8.9k multiply-adds per element at
dim 3 / deg 2, takes ~75 us at the 67 TFLOP/s float32 rate; that is the
chosen algorithm's time, not a bound of the function.  Four warps share 32
elements with u, g, d1, m1, m2 and the table in shared memory; design
notes are in ``csrc/factored_contract.cu``.

Layout: ``g [K1*d, E]`` (row ``k*d + b``), ``vol [E]``, ``ue [d, n, E]`` ->
``fe [d, n, E]``.
"""

from __future__ import annotations

import functools

import torch

from ..sparse.contract import factored_tables
from . import _build
from .qp import CONFIGS, _degree


@functools.lru_cache(maxsize=None)
def _table_on(d: int, deg: int, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(factored_tables(d, deg), dtype=dtype,
                           device=device)


def factored_contract_plain(g, vol, ue, lam, mu):
    """Plain PyTorch version: the same table form, batched over elements."""
    d, n, E = ue.shape
    T = _table_on(d, _degree(d, n), g.dtype, g.device)
    gl = g.reshape(d + 1, d, E)
    d1 = torch.einsum("kce,cje->kje", gl, ue)
    m1 = torch.einsum("klij,lje->kie", T, d1)
    m2 = torch.einsum("klij,kje->lie", T, d1)
    q = torch.einsum("kmij,cje->ckmie", T, ue)
    G2 = torch.einsum("kce,mce->kme", gl, gl)
    f1 = torch.einsum("kme,ckmie->cie", G2, q)
    f23 = torch.einsum("kce,kie->cie", gl, lam * m1 + mu * m2)
    return vol * (mu * f1 + f23)


def factored_contract(g, vol, ue, lam: float, mu: float) -> torch.Tensor:
    """g [K1*d, E], vol [E], ue [d, n, E] float32 -> fe [d, n, E].

    The dimension and degree (P1 or P2) follow from ue's shape, and the
    table from them (``sparse.contract.factored_tables``).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    if g.device.type == "cpu":
        return factored_contract_plain(g, vol, ue, lam, mu)
    d, n, E = ue.shape
    deg = _degree(d, n)
    if (d, deg) not in CONFIGS:
        raise ValueError(f"factored_contract: no kernel for dim {d}, "
                         f"degree {deg}")
    cfg = CONFIGS[(d, deg)][0]
    _build.check_cuda_args("factored_contract", g, dtypes=(torch.float32,))
    for t, shape in ((vol, (E,)), (ue, (d, n, E))):
        if t.device != g.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"factored_contract: expected contiguous "
                             f"float32 {shape} on {g.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if tuple(g.shape) != ((d + 1) * d, E):
        raise ValueError(f"factored_contract: g must be {((d + 1) * d, E)}")
    T = _table_on(d, deg, torch.float32, g.device)
    if tuple(T.shape) != (d + 1, d + 1, n, n) or not T.is_contiguous():
        raise RuntimeError(f"factored_contract: table {tuple(T.shape)} does "
                           f"not fit kernel config {cfg}")
    fe = torch.empty_like(ue)
    rc = _build.load().factored_contract_f32(
        cfg, g.data_ptr(), vol.data_ptr(), ue.data_ptr(), T.data_ptr(),
        fe.data_ptr(), float(lam), float(mu), E,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "factored_contract")
    factored_contract.launches += 1
    return fe


factored_contract.launches = 0
