"""Finite-difference validation harness (counterpart of
``meshfem_tpu/utils/fd_validation.py``, itself after the reference's
``python/fd_validation.py``): directional derivatives and Hessian-vector
products of a scalar function against central differences.

Derivatives come from ``torch.autograd`` (the reference's ``jax.grad`` and
forward-over-reverse ``jax.jvp``): the gradient by one backward pass, a
Hessian-vector product by differentiating ``<grad f, d>`` once more, which
equals ``H d`` since the Hessian is symmetric.  Directions are drawn from
``np.random.default_rng(seed)`` exactly as the reference draws them.
"""

from __future__ import annotations

import numpy as np
import torch


def grad_of(f, x: torch.Tensor, create_graph: bool = False) -> torch.Tensor:
    """Gradient of the scalar ``f`` at ``x`` (x itself is not modified)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        g, = torch.autograd.grad(f(xr), xr, create_graph=create_graph)
    return g


def hvp_of(f, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hessian-vector product ``H(x) v`` of the scalar ``f``."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        g, = torch.autograd.grad(f(xr), xr, create_graph=True)
        hv, = torch.autograd.grad(g, xr, v)
    return hv


def _direction(rng, x):
    d = torch.as_tensor(rng.standard_normal(tuple(x.shape)), dtype=x.dtype,
                        device=x.device)
    return d / torch.linalg.norm(d.reshape(-1))


def fd_gradient_check(f, x, grad=None, eps: float = 1e-6, n_dirs: int = 5,
                      seed: int = 0, rtol: float = 1e-5):
    """Directional derivatives of the scalar f against its gradient
    (autograd, or ``grad(x)``): the max relative error over ``n_dirs``
    random directions."""
    x = torch.as_tensor(x)
    g = grad_of(f, x) if grad is None else grad(x)
    rng = np.random.default_rng(seed)
    worst = 0.0
    with torch.no_grad():
        for _ in range(n_dirs):
            d = _direction(rng, x)
            fd = (float(f(x + eps * d)) - float(f(x - eps * d))) / (2 * eps)
            an = float(torch.vdot(g.reshape(-1), d.reshape(-1)))
            denom = max(abs(fd), abs(an), 1e-12)
            worst = max(worst, abs(fd - an) / denom)
    return worst


def fd_hessian_check(f, x, eps: float = 1e-5, n_dirs: int = 3,
                     seed: int = 0):
    """Hessian-vector products against central differences of the
    gradient: the max relative error over ``n_dirs`` random directions."""
    x = torch.as_tensor(x)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(n_dirs):
        d = _direction(rng, x)
        hv = hvp_of(f, x, d)
        fd = (grad_of(f, x + eps * d) - grad_of(f, x - eps * d)) / (2 * eps)
        denom = max(float(torch.linalg.norm(fd.reshape(-1))), 1e-12)
        worst = max(worst,
                    float(torch.linalg.norm((hv - fd).reshape(-1))) / denom)
    return worst
