"""Symmetric Gauss quadrature rules on K-simplices (host tables).

Counterpart of ``meshfem_tpu/fem/quadrature.py`` (``rule_np`` :36,
``rule`` :110, ``integrate`` :116; reference ``GaussQuadrature.hh``).
Points are barycentric coordinates and weights sum to 1, so
``integral = vol * sum_i w_i f(p_i)``.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from .. import config

MAX_DEGREE = {1: 5, 2: 5, 3: 4}


def _perms_orbit(vals):
    """All distinct permutations of a barycentric tuple."""
    return sorted(set(itertools.permutations(vals)))


@functools.lru_cache(maxsize=None)
def rule_np(K: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """(points [Q, K+1] barycentric, weights [Q] summing to 1) for exact
    integration of polynomials up to ``degree`` on a K-simplex."""
    degree = max(degree, 1)
    if degree > MAX_DEGREE[K]:
        raise ValueError(f"No degree-{degree} rule for K={K} "
                         f"(max {MAX_DEGREE[K]}, like the reference)")
    pts: list[tuple[float, ...]] = []
    wts: list[float] = []

    def orbit(w, *vals):
        for p in _perms_orbit(vals):
            pts.append(p)
            wts.append(w)

    if K == 1:
        if degree <= 1:
            orbit(1.0, 0.5, 0.5)
        elif degree <= 3:
            a = 0.5 + 0.5 / math.sqrt(3.0)
            orbit(0.5, a, 1.0 - a)
        else:
            a = 0.5 + 0.5 * math.sqrt(3.0 / 5.0)
            orbit(5.0 / 18.0, a, 1.0 - a)
            pts.append((0.5, 0.5))
            wts.append(8.0 / 18.0)
    elif K == 2:
        if degree <= 1:
            pts.append((1 / 3, 1 / 3, 1 / 3)); wts.append(1.0)
        elif degree == 2:
            orbit(1 / 3, 2 / 3, 1 / 6, 1 / 6)
        elif degree == 3:
            pts.append((1 / 3, 1 / 3, 1 / 3)); wts.append(-27.0 / 48.0)
            orbit(25.0 / 48.0, 3 / 5, 1 / 5, 1 / 5)
        elif degree == 4:
            orbit(0.223381589678011, 0.108103018168070,
                  0.445948490915965, 0.445948490915965)
            orbit(0.109951743655322, 0.816847572980459,
                  0.091576213509771, 0.091576213509771)
        else:
            pts.append((1 / 3, 1 / 3, 1 / 3)); wts.append(9.0 / 40.0)
            orbit(0.132394152788506, 0.059715871789770,
                  0.470142064105115, 0.470142064105115)
            orbit(0.125939180544827, 0.797426985353087,
                  0.101286507323456, 0.101286507323456)
    elif K == 3:
        if degree <= 1:
            pts.append((0.25,) * 4); wts.append(1.0)
        elif degree == 2:
            a = (5.0 + 3.0 * math.sqrt(5.0)) / 20.0
            b = (5.0 - math.sqrt(5.0)) / 20.0
            orbit(0.25, a, b, b, b)
        elif degree == 3:
            pts.append((0.25,) * 4); wts.append(-4.0 / 5.0)
            orbit(9.0 / 20.0, 0.5, 1 / 6, 1 / 6, 1 / 6)
        else:
            pts.append((0.25,) * 4); wts.append(-0.0131555555555556 * 6.0)
            orbit(0.00762222222222222 * 6.0,
                  0.785714285714286, 0.0714285714285714,
                  0.0714285714285714, 0.0714285714285714)
            orbit(0.0248888888888889 * 6.0,
                  0.399403576166799, 0.399403576166799,
                  0.100596423833201, 0.100596423833201)
    else:
        raise ValueError(f"unsupported simplex dimension {K}")

    P = np.array(pts, dtype=np.float64)
    W = np.array(wts, dtype=np.float64)
    if abs(W.sum() - 1.0) >= 1e-13:
        raise AssertionError(f"weights of rule ({K}, {degree}) sum to "
                             f"{W.sum()}")
    return P, W


def rule(K: int, degree: int, dtype=torch.float64, device=None):
    """(points, weights) of ``rule_np`` as tensors on ``device`` (the CUDA
    device unless the caller asks for another)."""
    P, W = rule_np(K, degree)
    dev = config.resolve_device(device)
    return (torch.as_tensor(P, dtype=dtype, device=dev),
            torch.as_tensor(W, dtype=dtype, device=dev))


def integrate(K: int, degree: int, f, volume=1.0, device=None):
    """Integral over the simplex, ``volume * sum_i w_i f(p_i)``; ``f`` maps
    a barycentric point [K+1] (a float64 tensor) to a value of any shape."""
    P, W = rule(K, degree, device=device)
    vals = torch.stack([torch.as_tensor(f(P[q]), dtype=W.dtype,
                                        device=W.device)
                        for q in range(P.shape[0])])
    return volume * torch.tensordot(W, vals, dims=1)
