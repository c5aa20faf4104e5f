"""Constant tables of the two factored isotropic element contractions (the
factored routed backends).

Counterpart of ``meshfem_tpu/sparse/contract.py::qp_tables`` (:216).  For a
constant isotropic material on affine simplices ``f = vol Ke u`` follows
from grad_lambda and the volume alone, as strain -> stress -> force at the
points of the degree-2(deg-1) rule, one pass being exact (asserted against
the gradgrad table).  The contraction itself (the reference's
``qp_contract`` :309) is kernel C, ``kernels.qp_contract``, which builds its
tables here.  The TQ-table form (``_factored_kernel`` :91, the reference's
``factored_contract`` :326) is kernel D, ``kernels.factored_contract``; its
table comes from ``factored_tables``.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fem.quadrature import rule_np
from ..fem.shape_functions import grad_shape_np
from ..ops.element_matrices import gradgrad_table


@functools.lru_cache(maxsize=None)
def qp_tables(K: int, deg: int):
    """(dN [Q, n, K+1], W [Q]) float64: shape-function barycentric
    gradients at the degree-2(deg-1) quadrature points."""
    P, W = rule_np(K, max(2 * (deg - 1), 1))
    dN = grad_shape_np(K, deg, P)
    T = gradgrad_table(K, deg)
    Tq = np.einsum("q,qik,qjl->klij", W, dN, dN)
    if np.abs(Tq - T).max() >= 1e-10:
        raise AssertionError("quadrature rule not exact for the gradgrad "
                             "table")
    return dN, W


@functools.lru_cache(maxsize=None)
def factored_tables(K: int, deg: int) -> np.ndarray:
    """The gradgrad table ``T[k, l, i, j]`` in float32, [K+1, K+1, n, n]
    (counterpart of ``factored_tables`` :66).  The reference pads and
    re-blocks it three times (TM1, TM2, TQ) for the TPU's matrix unit; the
    Hopper kernel indexes the one unpadded table."""
    return np.ascontiguousarray(gradgrad_table(K, deg), dtype=np.float32)
