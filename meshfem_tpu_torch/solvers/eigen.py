"""Eigensolvers: generalized LOBPCG for (K, M) pencils (counterpart of
``meshfem_tpu/solvers/eigen.py``).

The reference's stand-ins for Spectra (``Eigensolver.hh:8-26``: the
largest-magnitude eigenvalue, the n-th largest generalized pair, the
smallest nonzero generalized pairs with a known kernel) and for the python
layer's shift-invert ``eigsh``.  LOBPCG with M-orthonormalization; every
[N, k] computation stays on the device, and only [3m, 3m] Gram matrices
and [m] residual norms go to the host.

Two branches, taken by the reference's rule (``_ops_are_pytrees``): when
both operators are instances of classes the reference registers as pytrees
(their counterparts here: ``EBEKernel``, ``RoutedEBE``, ``ScatterPlan``,
the structured operators and multigrids, AMG's levels), the device loop runs
``chunk`` iterations at a time with the Ritz pencil solved on the device
by the parallel-Jacobi ``generalized_eigh``; any other callable (a
closure, as ``compute_vibrational_modes`` passes) takes the host-stage
loop: rank-revealing M-orthonormalization and the Ritz pencil by numpy /
scipy on the host, from the device's Grams.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config


def _proj(Zt, MZt, V):
    """M-orthogonal deflation projector (the identity for a 0-column
    basis)."""
    if Zt.shape[1] == 0:
        return V
    return V - Zt @ (MZt.T @ V)


def _registered_types():
    """The port's counterparts of the classes the reference registers as
    pytrees (``grep register_pytree meshfem_tpu``)."""
    from ..fem.elasticity_tensor import ElasticityTensor
    from ..ops.structured import StructuredP2Elasticity
    from ..ops.structured_mg import P1Level, StructuredMG
    from ..ops.structured_periodic import (PeriodicVarMG,
                                           PeriodicVarP2Elasticity,
                                           TorusP1Level)
    from ..ops.structured_periodic2d import (PeriodicVarMG2D,
                                             PeriodicVarP2Elasticity2D,
                                             TorusP1Level2D)
    from ..ops.structured_var import StructuredVarP2Elasticity
    from ..solvers.amg import AggLevel, UnstructuredMG
    from ..sparse.ebe import EBEKernel
    from ..sparse.routed_ebe import RoutedEBE
    from ..sparse.scatter import ScatterPlan

    return (EBEKernel, RoutedEBE, ScatterPlan, StructuredP2Elasticity,
            StructuredVarP2Elasticity, P1Level, StructuredMG,
            PeriodicVarP2Elasticity, TorusP1Level, PeriodicVarMG,
            PeriodicVarP2Elasticity2D, TorusP1Level2D, PeriodicVarMG2D,
            AggLevel, UnstructuredMG, ElasticityTensor)


def _ops_are_pytrees(*ops):
    """True when every operator is an instance of a class the reference
    registers as a pytree (its device-loop condition)."""
    types = _registered_types()
    return all(isinstance(op, types) for op in ops)


def _ortho_gram(M_op, V):
    G = V.T @ M_op(V)
    return 0.5 * (G + G.T)


def _apply_gram(K_op, M_op, Zt, MZt, S, Ror):
    S2 = _proj(Zt, MZt, S @ Ror)
    A = S2.T @ K_op(S2)
    B = S2.T @ M_op(S2)
    return S2, 0.5 * (A + A.T), 0.5 * (B + B.T)


def _residuals(K_op, M_op, Zt, MZt, X):
    KX = K_op(X)
    MX = M_op(X)
    theta = torch.einsum("nm,nm->m", X, KX) / torch.einsum("nm,nm->m", X,
                                                            MX)
    R = KX - MX * theta[None, :]
    return theta, torch.linalg.norm(R, dim=0), _proj(Zt, MZt, R)


def _device_chunk(K_op, M_op, Zt, MZt, X, Xp, chunk):
    """``chunk`` LOBPCG iterations on the device: the [3m, 3m] Ritz pencil
    by ``generalized_eigh``, no host round trip.  The trial block S = [X,
    R, X_prev] is column-scaled by 1/sqrt(diag(B)) before the Ritz solve
    (near convergence the residual columns shrink like rn^2 in B, and an
    unscaled rank cut would drop them while they still carry the
    correction)."""
    from ..utils import linalg as la

    m = X.shape[1]

    def rayleigh(X):
        KX = K_op(X)
        MX = M_op(X)
        gk = torch.einsum("nm,nm->m", X, KX)
        gm = torch.einsum("nm,nm->m", X, MX)
        theta = gk / torch.where(gm == 0, 1.0, gm)
        R = _proj(Zt, MZt, KX - MX * theta[None, :])
        return KX, MX, theta, R

    for _ in range(chunk):
        KX, MX, theta, R = rayleigh(X)
        S = torch.cat([X, R, Xp], dim=1)
        KS = torch.cat([KX, K_op(R), K_op(Xp)], dim=1)
        MS = torch.cat([MX, M_op(R), M_op(Xp)], dim=1)
        A = S.T @ KS
        B = S.T @ MS
        A = 0.5 * (A + A.T)
        B = 0.5 * (B + B.T)
        d = torch.sqrt(torch.diagonal(B).abs())
        dinv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0)
        w, v = la.generalized_eigh(A * dinv[:, None] * dinv[None, :],
                                   B * dinv[:, None] * dinv[None, :])
        X, Xp = _proj(Zt, MZt, S @ (dinv[:, None] * v[:, :m])), X
    _, _, theta, R = rayleigh(X)
    return X, Xp, theta, torch.linalg.norm(R, dim=0)


def lobpcg_generalized(K_apply, M_apply, X0, *, B_orth=None,
                       maxiter: int = 200, tol: float = 1e-8, deflate=None,
                       device_loop: bool | None = None, chunk: int = 10):
    """Smallest ``m`` eigenpairs of K x = lambda M x.

    K_apply / M_apply: matrix-free operators on [N, m] blocks.  X0: [N, m]
    initial block (a tensor: the solve runs on its device).  ``deflate``: optional
    [N, k] basis to project out M-orthogonally (rigid modes: the 'known
    kernel Z' of ``Eigensolver.hh:25``).  ``device_loop`` (default: on for
    registered operators) runs ``chunk`` iterations per round on the
    device.  Returns (lambdas [m] numpy, X [N, m], residual history: the
    relative residuals, one [m] array an iteration (host loop) or a chunk
    (device loop))."""
    dev = config.device_for(None, X0)
    X = torch.as_tensor(X0, dtype=config.REAL, device=dev)
    N, m = X.shape
    registered = _ops_are_pytrees(K_apply, M_apply)
    if device_loop is None:
        device_loop = registered

    if deflate is not None:
        # M-orthogonal deflation: restrict to the M-orthogonal complement of
        # span(Z) (a Euclidean projector would change the pencil)
        Z = torch.as_tensor(np.asarray(deflate, dtype=np.float64),
                            device=dev)
        G = (Z.T @ M_apply(Z)).cpu().numpy()
        w_g, Q_g = np.linalg.eigh(0.5 * (G + G.T))
        R = Q_g / np.sqrt(np.maximum(w_g, 1e-300))[None, :]
        Zt = Z @ torch.as_tensor(R, device=dev)  # M-orthonormal kernel basis
        MZt = M_apply(Zt)
    else:
        Zt = torch.zeros((N, 0), dtype=X.dtype, device=dev)
        MZt = Zt

    if device_loop and registered:
        Xp = torch.zeros_like(X)
        X = _proj(Zt, MZt, X)
        history = []
        it = 0
        while it < maxiter:
            n_it = min(chunk, maxiter - it)
            X, Xp, theta_d, rn_d = _device_chunk(K_apply, M_apply, Zt, MZt,
                                                 X, Xp, n_it)
            it += n_it
            theta = theta_d.cpu().numpy()
            rn = rn_d.cpu().numpy() / np.maximum(np.abs(theta), 1e-30)
            history.append(rn.copy())
            if np.all(rn < tol):
                break
        order = np.argsort(theta)
        return theta[order], X[:, torch.as_tensor(order, device=dev)], \
            history

    import scipy.linalg as sla

    def m_orthonormalize_factor(V):
        """Host factor of the rank-revealing M-orthonormalization: the
        [k, k'] mixing matrix, dropping near-dependent columns instead of
        amplifying them (amplification resurrects deflated kernel
        components from roundoff)."""
        w, Q = np.linalg.eigh(_ortho_gram(M_apply, V).cpu().numpy())
        keep = w > 1e-10 * max(w.max(), 1e-300)
        return torch.as_tensor(Q[:, keep] / np.sqrt(w[keep])[None, :],
                               device=dev)

    Xp = _proj(Zt, MZt, X)
    X = _proj(Zt, MZt, Xp @ m_orthonormalize_factor(Xp))
    X_prev = None
    history = []
    for it in range(maxiter):
        theta_d, rn_d, Rp = _residuals(K_apply, M_apply, Zt, MZt, X)
        theta = theta_d.cpu().numpy()
        rn = rn_d.cpu().numpy() / np.maximum(np.abs(theta), 1e-30)
        history.append(rn.copy())
        if np.all(rn < tol):
            break
        S = torch.cat([X, Rp] + ([X_prev] if X_prev is not None else []),
                      dim=1)
        S2, A, B = _apply_gram(K_apply, M_apply, Zt, MZt, S,
                               m_orthonormalize_factor(S))
        w, v = sla.eigh(A.cpu().numpy(), B.cpu().numpy())
        k = min(m, v.shape[1])
        X_prev = X
        X = _proj(Zt, MZt, S2 @ torch.as_tensor(v[:, :k], device=dev))
    # final Rayleigh quotients for the returned block (consistent pairing)
    theta = _residuals(K_apply, M_apply, Zt, MZt, X)[0].cpu().numpy()
    order = np.argsort(theta)
    return theta[order], X[:, torch.as_tensor(order, device=dev)], history


def largest_magnitude_eigenvalue(A_apply, n: int, iters: int = 200,
                                 tol: float = 1e-8, seed: int = 0,
                                 device=None):
    """Power iteration (``largestMagnitudeEigenvalue``,
    ``Eigensolver.hh:9``) on ``device`` (the CUDA device by default)."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(n),
                        device=config.resolve_device(device))
    v = v / torch.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = A_apply(v)
        lam_new = float(v @ w)
        v = w / torch.linalg.norm(w)
        if abs(lam_new - lam) < tol * abs(lam_new):
            lam = lam_new
            break
        lam = lam_new
    return lam, v


def nth_largest_generalized(K_apply, M_apply, n_vec: int, nth: int = 1,
                            N: int | None = None, seed: int = 0,
                            device=None, **kw):
    """n-th largest generalized eigenpair of (K, M)
    (``Eigensolver.hh:14-16``): LOBPCG on the negated pencil."""
    rng = np.random.default_rng(seed)
    m = max(nth, n_vec)
    X0 = torch.as_tensor(rng.standard_normal((N, m)),
                         device=config.resolve_device(device))
    lam, X, hist = lobpcg_generalized(lambda V: -K_apply(V), M_apply, X0,
                                      **kw)
    order = np.argsort(lam)  # ascending of -K: the largest of K first
    return -lam[order[nth - 1]], X[:, int(order[nth - 1])]


def negative_curvature_direction(H_apply, N: int, tol: float = 1e-6,
                                 maxiter: int = 200, seed: int = 0,
                                 device=None):
    """Most-negative-eigenvalue direction of a symmetric operator
    (``Eigensolver.hh`` negativeCurvatureDirection): (lambda_min, v) by
    LOBPCG with the identity metric."""
    rng = np.random.default_rng(seed)
    X0 = torch.as_tensor(rng.standard_normal((N, 2)),
                         device=config.resolve_device(device))
    lam, X, _ = lobpcg_generalized(H_apply, lambda V: V, X0, tol=tol,
                                   maxiter=maxiter)
    return float(lam[0]), X[:, 0]
