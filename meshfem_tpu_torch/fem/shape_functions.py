"""Lagrange shape functions on K-simplices, K = 1, 2, 3 and degree 0..4
(host tables).

Counterpart of ``meshfem_tpu/fem/shape_functions.py``: the degree-``deg``
basis on the barycentric lattice ``alpha / deg`` comes from inverting the
Vandermonde matrix of homogeneous barycentric monomials.  Node order is
GMSH-consistent: vertices, then edge nodes in edge order (start to end),
then face-interior nodes in ``_TET_FACES`` order, then interior nodes;
degree 0 is one node at the centroid.  The tables give values
(``eval_shape_np``, and ``eval_shape`` in torch, differentiable in the
barycentric points), barycentric gradients (``grad_shape_np``), exact
integrals (``integrated_shape_np``) and node positions
(``node_positions_barycentric``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import simplex


# Faces of the tetrahedron, in the order their interior nodes are numbered
_TET_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _interior(nv: int, deg: int, verts) -> list[tuple[int, ...]]:
    """Multi-indices over ``nv`` variables, |alpha| = deg, strictly
    positive on ``verts`` and zero elsewhere (lexicographic on ``verts``)."""
    out: list[tuple[int, ...]] = []

    def rec(prefix, remaining, slots):
        if slots == 1:
            a = [0] * nv
            for v, c in zip(verts, prefix + [remaining]):
                a[v] = c
            out.append(tuple(a))
            return
        for c in range(1, remaining - slots + 2):
            rec(prefix + [c], remaining - c, slots - 1)

    if deg >= len(verts):
        rec([], deg, len(verts))
    return out


@functools.lru_cache(maxsize=None)
def node_multi_indices(K: int, deg: int) -> tuple[tuple[int, ...], ...]:
    """Barycentric multi-indices (|alpha| = deg) of the element's nodes in
    GMSH order.  Node position = alpha / deg; degree 0 has one node (the
    centroid, see ``node_positions_barycentric``)."""
    nv = K + 1
    if deg == 0:
        return (tuple([0] * nv),)
    nodes: list[tuple[int, ...]] = []
    for v in range(nv):
        a = [0] * nv
        a[v] = deg
        nodes.append(tuple(a))
    for s, e in simplex.simplex_edges(K):
        for t in range(1, deg):
            a = [0] * nv
            a[s] = deg - t
            a[e] = t
            nodes.append(tuple(a))
    if K == 2:
        nodes.extend(_interior(nv, deg, (0, 1, 2)))
    if K == 3:
        for f in _TET_FACES:
            nodes.extend(_interior(nv, deg, f))
        nodes.extend(_interior(nv, deg, (0, 1, 2, 3)))
    if len(nodes) != simplex.num_nodes(K, deg):
        raise AssertionError(f"({K}, {deg}): {len(nodes)} nodes")
    return tuple(nodes)


@functools.lru_cache(maxsize=None)
def _monomial_exponents(K: int, deg: int) -> np.ndarray:
    """All multi-indices with |alpha| = deg over K+1 variables, lexicographic."""
    nv = K + 1
    exps: list[tuple[int, ...]] = []

    def rec(prefix, remaining, slots):
        if slots == 1:
            exps.append(tuple(prefix + [remaining]))
            return
        for v in range(remaining + 1):
            rec(prefix + [v], remaining - v, slots - 1)

    rec([], deg, nv)
    return np.array(exps, dtype=np.int64)


def _eval_monomials(exps: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """[..., nv] barycentric coords -> [..., M] monomial values (0^0 = 1)."""
    lam = np.asarray(lambdas, dtype=np.float64)
    M, nv = exps.shape
    out = np.ones(lam.shape[:-1] + (M,), dtype=np.float64)
    for m in range(M):
        for v in range(nv):
            e = exps[m, v]
            if e > 0:
                out[..., m] *= lam[..., v] ** e
    return out


@functools.lru_cache(maxsize=None)
def _lagrange_tables(K: int, deg: int):
    """(exps [M, nv], coeffs [M, n]) with phi_j = sum_m coeffs[m, j] mono_m."""
    if deg == 0:
        return np.zeros((1, K + 1), dtype=np.int64), np.ones((1, 1))
    exps = _monomial_exponents(K, deg)
    nodes = np.array(node_multi_indices(K, deg), dtype=np.float64) / deg
    V = _eval_monomials(exps, nodes)
    coeffs = np.linalg.inv(V)
    coeffs[np.abs(coeffs) < 1e-12] = 0.0
    return exps, coeffs


def eval_shape_np(K: int, deg: int, lambdas) -> np.ndarray:
    """Shape function values: [..., nv] barycentric -> [..., n_nodes]."""
    exps, coeffs = _lagrange_tables(K, deg)
    return _eval_monomials(exps, np.asarray(lambdas, dtype=np.float64)) \
        @ coeffs


def eval_shape(K: int, deg: int, lambdas) -> torch.Tensor:
    """``eval_shape_np`` in torch on the points' device and dtype (constant
    tables, differentiable in ``lambdas``)."""
    exps, coeffs = _lagrange_tables(K, deg)
    lam = torch.as_tensor(lambdas)
    monos = torch.stack([torch.prod(lam ** torch.as_tensor(
        e, dtype=lam.dtype, device=lam.device), dim=-1) for e in exps],
        dim=-1)
    return monos @ torch.as_tensor(coeffs, dtype=lam.dtype,
                                   device=lam.device)


def grad_shape_np(K: int, deg: int, lambdas) -> np.ndarray:
    """d phi / d lambda: [..., nv] -> [..., n_nodes, nv]."""
    exps, coeffs = _lagrange_tables(K, deg)
    lam = np.asarray(lambdas, dtype=np.float64)
    nv = K + 1
    M = exps.shape[0]
    grads = np.zeros(lam.shape[:-1] + (coeffs.shape[1], nv), dtype=np.float64)
    for v in range(nv):
        dmono = np.zeros(lam.shape[:-1] + (M,), dtype=np.float64)
        for m in range(M):
            e = exps[m].copy()
            if e[v] == 0:
                continue
            c = float(e[v])
            e[v] -= 1
            term = np.full(lam.shape[:-1], c, dtype=np.float64)
            for w in range(nv):
                if e[w] > 0:
                    term = term * lam[..., w] ** e[w]
            dmono[..., m] = term
        grads[..., v] = dmono @ coeffs
    return grads


@functools.lru_cache(maxsize=None)
def integrated_shape_np(K: int, deg: int) -> np.ndarray:
    """Exact integrals of each shape function over a unit-volume simplex:
    int prod lambda_i^{a_i} dV = K! prod(a_i!) / (|a| + K)!."""
    exps, coeffs = _lagrange_tables(K, deg)
    factors = np.array([
        math.factorial(K) * np.prod([math.factorial(int(a)) for a in e])
        / math.factorial(int(e.sum()) + K) for e in exps])
    return factors @ coeffs


def node_positions_barycentric(K: int, deg: int) -> np.ndarray:
    """[n_nodes, K+1] barycentric coordinates of the element nodes."""
    if deg == 0:
        return np.full((1, K + 1), 1.0 / (K + 1))
    return np.array(node_multi_indices(K, deg), dtype=np.float64) / deg
