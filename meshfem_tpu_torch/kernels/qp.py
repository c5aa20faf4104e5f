"""Kernel C, ``qp_contract``: the isotropic element apply ``fe = vol Ke ue``
from grad_lambda and the volume alone, strain -> stress -> force at the
quadrature points of ``sparse.contract.qp_tables``.

Replaces ``meshfem_tpu/sparse/contract.py::_qp_kernel`` (:232), the
factored routed backend on the TPU.  Bound on the H100: memory, 4 (K1 d +
1 + 2 n d m) bytes an element (73 floats at d = 3, P2, m = 1: ~82 MB at
the bench size, ~24 us at 3.35 TB/s), with ~2.6 kFLOP an element and
column beside it (~11 us at the float32 peak), so the design overlaps the
two.  One thread per element and column keeps u and f in registers; lam
and mu are arguments; the quadrature tables are compiled into the kernel
(``csrc/qp_tables.cuh``, written by ``table_header`` from ``qp_tables``),
so that their zero entries cost no instruction.  Design notes and
measured times are in ``csrc/qp_contract.cu``.

Layout: ``g [K1*d, E]`` (row ``k*d + b`` = d lambda_k / d x_b) and ``vol
[E]``; the element values ``ue`` and the forces ``fe`` in one of two
layouts, which the kernel reads and writes through four strides (element,
node, component, column) and a column count m:

* planes ``[d, n, E]`` (m = 1), element index fastest: one thread per
  element reads and writes in place;
* element-major node rows ``[E*n, d*m]`` (``rows=True``: slot ``e*n + a``,
  value ``c*m + j``), kernels A and B's rows layout, in which the routed
  operator runs, all m columns in one launch.  A persistent grid of warps
  walks tiles of elements (one contiguous stretch each); each warp copies
  its next tile in with one bulk asynchronous copy while it computes the
  current one from shared memory and the previous one drains out.

Both layouts run the same per-element arithmetic: the same inputs give the
same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sparse.contract import qp_tables
from . import _build

# (dim, deg) -> (configuration index of the kernel's template instance,
# its number of quadrature points); csrc/qp_contract.cu and the header
# table_header writes (csrc/qp_tables.cuh) fix both
CONFIGS = {(3, 2): (0, 4), (3, 1): (1, 1), (2, 2): (2, 3), (2, 1): (3, 1)}
TABLE_HEADER = _build.CSRC / "qp_tables.cuh"


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


def _dim(g) -> int:
    """d from g's rows ``(d + 1) * d``."""
    for d in (2, 3):
        if g.shape[0] == (d + 1) * d:
            return d
    raise ValueError(f"g must have (d + 1) d rows for d = 2 or 3, got "
                     f"{tuple(g.shape)}")


def layout(g, ue, rows: bool, what: str):
    """(d, n, E, m, strides) of ``ue``: planes ``[d, n, E]`` or element-major
    rows ``[E*n, d*m]``; ``strides`` (element, node, component, column) in
    floats, shared by the forces."""
    d, E = _dim(g), g.shape[1]
    if rows:
        if ue.dim() != 2 or ue.shape[0] % max(E, 1) or ue.shape[1] % d:
            raise ValueError(f"{what}: rows must be [E*n, d*m] with E = {E}, "
                             f"d = {d}, got {tuple(ue.shape)}")
        n, m = ue.shape[0] // max(E, 1), ue.shape[1] // d
        return d, n, E, m, (n * d * m, d * m, m, 1)
    if ue.dim() != 3 or ue.shape[0] != d or ue.shape[2] != E:
        raise ValueError(f"{what}: planes must be [{d}, n, {E}], got "
                         f"{tuple(ue.shape)}")
    n = ue.shape[1]
    return d, n, E, 1, (1, E, n * E, 0)


def per_column(planes_fn, g, vol, ue, lam, mu):
    """Rows ``[E*n, d*m]`` through a planes function ``[d, n, E] -> [d, n,
    E]``, one column at a time: each column permuted to contiguous planes,
    so rows and planes give the same bits."""
    d, n, E, m, _ = layout(g, ue, True, planes_fn.__name__)
    u4 = ue.reshape(E, n, d, m)
    fe = torch.empty_like(u4)
    for j in range(m):
        fe[..., j] = planes_fn(g, vol, u4[..., j].permute(2, 1, 0)
                               .contiguous(), lam, mu).permute(2, 1, 0)
    return fe.reshape(ue.shape)


def qp_contract_plain(g, vol, ue, lam, mu, rows: bool = False):
    """Plain PyTorch version (same arithmetic as the kernel, batched over
    elements), on ``qp_tables`` of ue's dimension and degree; rows go
    through it column by column."""
    if rows:
        return per_column(qp_contract_plain, g, vol, ue, lam, mu)
    d, n, E, _, _ = layout(g, ue, False, "qp_contract")
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


def qp_contract(g, vol, ue, lam: float, mu: float,
                rows: bool = False) -> torch.Tensor:
    """g [K1*d, E], vol [E] float32; ue planes [d, n, E], or element-major
    rows [E*n, d*m] when ``rows`` -> fe of ue's shape.

    The dimension and degree (P1 or P2) follow from the shapes, and the
    quadrature tables from them (``sparse.contract.qp_tables``, compiled
    into the kernel from ``csrc/qp_tables.cuh``).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises).  Launches in rows are also counted in ``launches_rows``."""
    if g.device.type == "cpu":
        return qp_contract_plain(g, vol, ue, lam, mu, rows)
    d, n, E, m, strides = check_contract_args("qp_contract", g, vol, ue,
                                              rows)
    cfg, _ = CONFIGS[(d, _degree(d, n))]
    lib = _build.load()
    fe = torch.empty_like(ue)
    rc = lib.qp_contract_f32(
        cfg, g.data_ptr(), vol.data_ptr(), ue.data_ptr(), fe.data_ptr(),
        float(lam), float(mu), E, m, *strides,
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "qp_contract")
    qp_contract.launches += 1
    qp_contract.launches_rows += rows
    return fe


def _hex32(x: float) -> str:
    """A float32 value as an exact C++ hex-float literal."""
    h = float(np.float32(x)).hex()              # e.g. '-0x1.2bbae20000000p-1'
    sign, h = ("-", h[1:]) if h.startswith("-") else ("", h)
    mant, exp = h[2:].split("p")
    head, _, frac = mant.partition(".")
    frac = frac.rstrip("0") or "0"
    return f"{sign}0x{head}.{frac}p{exp}f"


def table_header() -> str:
    """Text of ``csrc/qp_tables.cuh``: ``qp_tables(d, deg)`` of the four
    configurations in float32, as exact hex-float literals that the kernel
    reads at compile time (``tests/test_torch_qp_hopper.py`` holds the
    committed file equal to this)."""
    out = ["// The quadrature tables of kernel C, dN [Q, n, K1] and W [Q] in",
           "// float32, one struct a configuration.  Written by",
           "// meshfem_tpu_torch.kernels.qp.table_header() from",
           "// sparse.contract.qp_tables; regenerate rather than edit:",
           "//   python -c 'from meshfem_tpu_torch.kernels import qp; "
           "qp.TABLE_HEADER.write_text(qp.table_header())'",
           "// The values are compile-time constants, so the compiler folds",
           "// them into the instructions and the kernel drops the zero",
           "// entries' terms.",
           "", "#pragma once", "", "namespace qp_tables {", "",
           "template <int CFG>", "struct Table;"]
    for (d, deg), (cfg, Q) in CONFIGS.items():
        dN, W = qp_tables(d, deg)
        if dN.shape[0] != Q:
            raise RuntimeError(f"qp_tables({d}, {deg}) has {dN.shape[0]} "
                               f"points, configuration {cfg} {Q}")
        n = dN.shape[1]
        rows = [", ".join(_hex32(x) for x in dN[q, i])
                for q in range(Q) for i in range(n)]
        out += ["", f"// (dim, deg) = ({d}, {deg}): Q = {Q}, n = {n}, "
                    f"K1 = {d + 1}; dN row (q, i) at (q n + i) K1",
                "template <>", f"struct Table<{cfg}> {{",
                f"  static constexpr int kDim = {d}, kNodes = {n}, "
                f"kQ = {Q};",
                "  __host__ __device__ static constexpr float dN(int t) {",
                f"    constexpr float v[{dN.size}] = {{"]
        out += [f"        {r}," for r in rows]
        out += ["    };", "    return v[t];", "  }",
                "  __host__ __device__ static constexpr float W(int q) {",
                f"    constexpr float v[{Q}] = {{"
                + ", ".join(_hex32(x) for x in W) + "};",
                "    return v[q];", "  }", "};"]
    out += ["", "}  // namespace qp_tables", ""]
    return "\n".join(out)


def check_contract_args(what, g, vol, ue, rows):
    """Validate kernel C's or D's tensors for a CUDA launch; returns
    ``layout``'s (d, n, E, m, strides)."""
    _build.check_cuda_args(what, g, dtypes=(torch.float32,))
    d, n, E, m, strides = layout(g, ue, rows, what)
    deg = _degree(d, n)
    if (d, deg) not in CONFIGS:
        raise ValueError(f"{what}: no kernel for dim {d}, degree {deg}")
    for t, shape in ((vol, (E,)), (ue, tuple(ue.shape))):
        if t.device != g.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous float32 {shape} "
                             f"on {g.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return d, n, E, m, strides


qp_contract.launches = 0
qp_contract.launches_rows = 0
