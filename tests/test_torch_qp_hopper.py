"""Kernel C's compile-time tables and per-element arithmetic, on the CPU.

The Hopper kernel (``meshfem_tpu_torch/csrc/qp_contract.cu``) reads its
quadrature tables from ``csrc/qp_tables.cuh``, float32 hex literals written
by ``kernels.qp.table_header`` from ``sparse.contract.qp_tables``, and skips
every term whose table entry is zero.  Here:

* the committed header equals the generator's output, and its literals,
  parsed back, equal ``float32(qp_tables(d, deg))`` bit for bit (dN, W and
  the zero pattern) for (dim, deg) = (3, 2), (3, 1), (2, 2), (2, 1);
* a float32 model of the kernel's per-element arithmetic (the parsed
  tables, zero entries skipped, every sum in the kernel's order) agrees
  with the reference's TPU kernel (``meshfem_tpu.sparse.contract._qp_kernel``,
  its body evaluated on host arrays for one superblock, which at the P1
  configurations equals ``qp_contract(..., interpret=True)`` to 1e-6) to
  1e-5 of max|y|, and with the port's plain
  version ``qp_contract_plain`` in node rows at m = 1, 3 and 6 to 1e-5 of
  max|y| (both sum in other orders).

The kernel itself runs only on the card: its ``cuda`` cases are in
``tests/test_torch_factored_rows.py``.
"""

import re

import numpy as np
import pytest
import torch

from meshfem_tpu_torch.kernels import qp
from meshfem_tpu_torch.sparse.contract import qp_tables

CONFIGS = [(3, 2), (3, 1), (2, 2), (2, 1)]
NONZERO = {(3, 2): 112, (3, 1): 4, (2, 2): 45, (2, 1): 3}
LAM, MU = 1.7, 0.9


def _parsed_tables():
    """{cfg: (dN flat, W)} as float32 arrays, parsed from the committed
    header's literals."""
    text = qp.TABLE_HEADER.read_text()
    out = {}
    for block in re.split(r"template <>\s*struct Table<", text)[1:]:
        cfg = int(block[:block.index(">")])
        dn, w = re.findall(r"constexpr float v\[\d+\] = \{(.*?)\};", block,
                           flags=re.S)
        lit = lambda s: np.array([float.fromhex(x.strip().rstrip("f"))
                                  for x in s.split(",") if x.strip()],
                                 dtype=np.float32)
        out[cfg] = (lit(dn), lit(w))
    return out


def _n(dim, deg):
    return dim + 1 if deg == 1 else (dim + 1) * (dim + 2) // 2


def test_committed_header_is_generated():
    assert qp.TABLE_HEADER.read_text() == qp.table_header()


@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_header_tables_equal_qp_tables_float32(dim, deg):
    cfg, Q = qp.CONFIGS[(dim, deg)]
    dN, W = qp_tables(dim, deg)
    dn_h, w_h = _parsed_tables()[cfg]
    dN32, W32 = dN.astype(np.float32), W.astype(np.float32)
    assert dN32.shape == (Q, _n(dim, deg), dim + 1)
    assert np.array_equal(dn_h.view(np.uint32), dN32.ravel().view(np.uint32))
    assert np.array_equal(w_h.view(np.uint32), W32.view(np.uint32))
    assert int(np.count_nonzero(dn_h)) == NONZERO[(dim, deg)]
    assert np.array_equal(dn_h != 0, dN.ravel() != 0)


def _model_planes(g, vol, u, dim, deg):
    """The kernel's per-element arithmetic in float32 torch, batched over
    elements: u planes [d, n, E] -> f [d, n, E]."""
    cfg, Q = qp.CONFIGS[(dim, deg)]
    dn_h, w_h = _parsed_tables()[cfg]
    K1, n, E = dim + 1, u.shape[1], u.shape[2]
    dN = dn_h.reshape(Q, n, K1)
    gl = g.reshape(K1, dim, E)
    lam, mu = torch.tensor(LAM), torch.tensor(MU)
    f = [[torch.zeros(E) for _ in range(n)] for _ in range(dim)]
    for q in range(Q):
        gphi = [[None] * dim for _ in range(n)]
        for i in range(n):
            for b in range(dim):
                acc = torch.zeros(E)
                for k in range(K1):
                    w = float(dN[q, i, k])
                    if w != 0.0:
                        acc = acc + torch.tensor(w) * gl[k, b]
                gphi[i][b] = acc
        G = [[None] * dim for _ in range(dim)]
        for c in range(dim):
            for b in range(dim):
                acc = torch.zeros(E)
                for i in range(n):
                    acc = acc + u[c, i] * gphi[i][b]
                G[c][b] = acc
        tr = torch.zeros(E)
        for c in range(dim):
            tr = tr + G[c][c]
        wv = vol * torch.tensor(float(w_h[q]))
        S = [[None] * dim for _ in range(dim)]
        for c in range(dim):
            for b in range(dim):
                s = mu * (G[c][b] + G[b][c])
                if c == b:
                    s = s + lam * tr
                S[c][b] = s * wv
        for i in range(n):
            for b in range(dim):
                for c in range(dim):
                    f[c][i] = f[c][i] + gphi[i][b] * S[c][b]
    return torch.stack([torch.stack(row) for row in f])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tpu_inputs(dim, deg):
    """One superblock (1,024 elements, the last 324 padding) in the
    reference's layout: g [1, K1 d, 8, 128], vol [1, 8, 128], u [d, 1, n,
    8, 128], float32."""
    rng = np.random.default_rng(dim * 10 + deg)
    n, K1 = _n(dim, deg), dim + 1
    g = rng.standard_normal((1, K1 * dim, 8, 128)).astype(np.float32)
    vol = (rng.random((1, 8, 128)) + 0.5).astype(np.float32)
    vol.reshape(-1)[700:] = 0.0
    u = rng.standard_normal((dim, 1, n, 8, 128)).astype(np.float32)
    return g, vol, u


def _tpu_kernel_body(g, vol, u, dim, deg):
    """The TPU kernel's body (``_qp_kernel``, :232) evaluated on host
    arrays standing for its refs, with the arguments ``_qp_call`` binds:
    what interpret mode evaluates for one superblock."""
    from meshfem_tpu.sparse.contract import _qp_kernel
    from meshfem_tpu.sparse.contract import qp_tables as r_qp_tables

    n, K1 = _n(dim, deg), dim + 1
    dN, W = r_qp_tables(dim, deg)
    out = np.zeros(u.shape, np.float32)
    _qp_kernel(g, vol, u, out, np.zeros((n * dim, 8, 128), np.float32),
               n=n, K1=K1, dim=dim, lam=LAM, mu=MU, dN=dN, W=W)
    return out


@pytest.mark.parametrize("dim,deg", [(3, 1), (2, 1)])
def test_tpu_kernel_body_is_interpret_mode(dim, deg):
    """The harness below against ``qp_contract(..., interpret=True)``, at
    the two configurations whose interpret runs trace quickly (P2 takes
    6-20 s)."""
    import jax.numpy as jnp
    from meshfem_tpu.sparse.contract import qp_contract as r_qp_contract

    g, vol, u = _tpu_inputs(dim, deg)
    ref = np.asarray(r_qp_contract(jnp.asarray(g), jnp.asarray(vol),
                                   jnp.asarray(u), LAM, MU, dim, deg,
                                   interpret=True))
    assert _rel(_tpu_kernel_body(g, vol, u, dim, deg), ref) < 1e-6


@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_model_matches_tpu_kernel(dim, deg):
    g, vol, u = _tpu_inputs(dim, deg)
    ref = _tpu_kernel_body(g, vol, u, dim, deg).reshape(dim, -1, 1024)
    n, K1 = _n(dim, deg), dim + 1
    out = _model_planes(torch.as_tensor(g.reshape(K1 * dim, 1024)),
                        torch.as_tensor(vol.reshape(1024)),
                        torch.as_tensor(u.reshape(dim, n, 1024)), dim, deg)
    assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize("m", [1, 3, 6])
@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_model_matches_plain_in_rows(dim, deg, m):
    rng = np.random.default_rng(100 * dim + 10 * deg + m)
    n, E = _n(dim, deg), 37
    g = torch.as_tensor(rng.standard_normal(((dim + 1) * dim, E))
                        .astype(np.float32))
    vol = torch.as_tensor((rng.random(E) + 0.5).astype(np.float32))
    rows = torch.as_tensor(rng.standard_normal((E * n, dim * m))
                           .astype(np.float32))
    u4 = rows.reshape(E, n, dim, m)
    out = torch.empty_like(u4)
    for j in range(m):
        out[..., j] = _model_planes(g, vol, u4[..., j].permute(2, 1, 0),
                                    dim, deg).permute(2, 1, 0)
    ref = qp.qp_contract_plain(g, vol, rows, LAM, MU, rows=True)
    assert _rel(out.reshape(rows.shape), ref) < 1e-5
