"""Small dense linear algebra on torch tensors (counterpart of
``meshfem_tpu/utils/linalg.py``).

The reference writes these out because XLA:TPU lacks float64 LU and
eigensolvers; the port keeps the same algorithms, not a library solver,
so that what depends on them gives the reference's numbers to float64
rounding: the unrolled Gauss-Jordan inverse with partial pivoting (``det``,
``inv``, ``solve``), the cyclic Jacobi eigensolver with a fixed sweep count
(``eigh_jacobi``, which the corotated and projected energies run at 8 and
10 sweeps; its rotation angle is written so that its derivative stays
finite once a sweep has converged, see ``_rotation``), the parallel-order
Jacobi on a round-robin schedule (``eigh_jacobi_par``) and the rank-masked
generalized eigensolver built on it (``generalized_eigh``, the Ritz pencil
of LOBPCG's device loop).  Every
function batches over leading axes; eigenvalues come ascending, with the
reference's eigenvector signs.
"""

from __future__ import annotations

import numpy as np
import torch


def det(A: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant for [..., n, n], n <= 3."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if n == 3:
        return (
            A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0])
        )
    raise ValueError("closed-form det only for n <= 3")


def inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small matrices [..., n, n] by Gauss-Jordan with
    partial pivoting, unrolled over n (n <~ 32)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)                     # [..., n, 2n]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        # partial pivot: the largest |entry| of column k in rows k..n-1
        col = M[..., :, k].abs()
        piv = torch.argmax(torch.where(rows >= k, col, -1.0), dim=-1)
        # swap rows k and piv
        perm = torch.where(rows == k, piv[..., None],
                           torch.where(rows == piv[..., None], k, rows))
        M = torch.gather(M, -2, perm[..., :, None].expand(M.shape))
        # eliminate column k from every other row
        pivot_row = M[..., k, :] / M[..., k, k][..., None]
        factors = M[..., :, k]
        update = factors[..., :, None] * pivot_row[..., None, :]
        keep = (rows != k)[:, None]
        M = torch.where(keep, M - update, pivot_row[..., None, :])
    return M[..., :, n:]


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small A [..., n, n], b [..., n] or [..., n, m]."""
    Ainv = inv(A)
    if b.dim() == A.dim() - 1:
        return torch.einsum("...ij,...j->...i", Ainv, b)
    return torch.einsum("...ij,...jm->...im", Ainv, b)


def _rotation(app, aqq, apq):
    """(c, s) of the Jacobi rotation that zeroes ``apq`` (the stable form;
    tau >= 0 counts as positive, so equal diagonals still rotate by 45
    degrees).  Past |tau| = 1e8, where sqrt(1 + tau^2) rounds to |tau|,
    t = 1 / (2 tau) is taken as apq / (aqq - app): the same value to an
    ulp, and a finite derivative where the reference's tau^2 overflows
    (an off-diagonal entry of 1e-160 and below, which a converged sweep
    leaves) and its gradient turns NaN."""
    num = aqq - app
    zero = apq == 0
    big = ~zero & (num.abs() > 2e8 * apq.abs())
    tau = num / (2.0 * torch.where(zero | big, 1.0, apq))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(big, apq / torch.where(big, num, 1.0), t)
    t = torch.where(zero, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _sorted_pairs(M, V):
    w = torch.diagonal(M, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def eigh_jacobi(A: torch.Tensor, sweeps: int = 12):
    """Batched symmetric eigendecomposition by cyclic Jacobi rotations:
    (w ascending, V with the eigenvectors as columns)."""
    n = A.shape[-1]
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = A
    rows = torch.arange(n, device=A.device)

    def rotate(M, V, p, q):
        c, s = _rotation(M[..., p, p], M[..., q, q], M[..., p, q])
        c, s = c[..., None], s[..., None]
        ep = (rows == p).to(M.dtype)
        eq = (rows == q).to(M.dtype)
        # G = I + (c-1)(ep ep^T + eq eq^T) + s ep eq^T - s eq ep^T:
        # M <- G^T M G, V <- V G
        Mp, Mq = M[..., :, p], M[..., :, q]
        new_p, new_q = c * Mp - s * Mq, s * Mp + c * Mq
        M = M + (new_p - Mp)[..., :, None] * ep \
            + (new_q - Mq)[..., :, None] * eq
        Mp, Mq = M[..., p, :], M[..., q, :]
        new_p, new_q = c * Mp - s * Mq, s * Mp + c * Mq
        M = M + ep[:, None] * (new_p - Mp)[..., None, :] \
            + eq[:, None] * (new_q - Mq)[..., None, :]
        Vp, Vq = V[..., :, p], V[..., :, q]
        new_p, new_q = c * Vp - s * Vq, s * Vp + c * Vq
        V = V + (new_p - Vp)[..., :, None] * ep \
            + (new_q - Vq)[..., :, None] * eq
        return M, V

    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                M, V = rotate(M, V, p, q)
    return _sorted_pairs(M, V)


def orthonormalize(Z: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Column-orthonormalize ``Z [n, k]`` (k small) by modified
    Gram-Schmidt with re-orthogonalization, in ``Z``'s dtype.  A nullspace
    projector of a singular CG system must be orthogonal to the working
    precision: a component left along the null space grows until the
    solve diverges."""
    cols = list(Z.unbind(dim=1))
    for _ in range(passes):
        out = []
        for v in cols:
            for q in out:
                v = v - q * torch.vdot(q, v)
            out.append(v / torch.sqrt(torch.vdot(v, v)))
        cols = out
    return torch.stack(cols, dim=1)


def _round_robin_schedule(n: int) -> np.ndarray:
    """[n-1, n/2, 2] disjoint-pair rotation schedule (circle method; n
    even, callers pad odd sizes with a dummy index)."""
    assert n % 2 == 0
    ring = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        idx = [0] + ring
        rounds.append([(idx[i], idx[n - 1 - i]) for i in range(n // 2)])
        ring = [ring[-1]] + ring[:-1]
    return np.asarray(rounds, np.int32)


def eigh_jacobi_par(A: torch.Tensor, sweeps: int = 14):
    """Batched symmetric eigendecomposition by parallel-order cyclic
    Jacobi: each round applies n/2 disjoint rotations at once, over the
    round-robin schedule (the Gram pencils of LOBPCG's device loop, n ~
    16-64).  An odd n is padded with an isolated unit diagonal, whose
    eigenpair is dropped again."""
    n0 = A.shape[-1]
    n = n0 + (n0 % 2)
    if n != n0:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
        A[..., n0, n0] = 1.0
    sched = torch.as_tensor(_round_robin_schedule(n), dtype=torch.long,
                            device=A.device)
    M = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for r in range(n - 1):
            P, Q = sched[r, :, 0], sched[r, :, 1]
            c, s = _rotation(M[..., P, P], M[..., Q, Q], M[..., P, Q])
            cc, sc = c[..., None, :], s[..., None, :]
            Mp, Mq = M[..., :, P], M[..., :, Q]
            M[..., :, P] = cc * Mp - sc * Mq
            M[..., :, Q] = sc * Mp + cc * Mq
            cr, sr = c[..., :, None], s[..., :, None]
            Mp, Mq = M[..., P, :], M[..., Q, :]
            M[..., P, :] = cr * Mp - sr * Mq
            M[..., Q, :] = sr * Mp + cr * Mq
            Vp, Vq = V[..., :, P], V[..., :, Q]
            V[..., :, P] = cc * Vp - sc * Vq
            V[..., :, Q] = sc * Vp + cc * Vq
    w, V = _sorted_pairs(M, V)
    if n != n0:   # the dummy's eigenpair is (1, e_n0): drop that column
        dummy = V[..., n0, :].abs()
        keep = torch.sort(torch.argsort(dummy, dim=-1,
                                        stable=True)[..., :n0], dim=-1)[0]
        w = torch.gather(w, -1, keep)
        V = V[..., :n0, :]
        V = torch.gather(V, -1, keep[..., None, :].expand(V.shape[:-1]
                                                           + (n0,)))
    return w, V


def generalized_eigh(A: torch.Tensor, B: torch.Tensor, sweeps: int = 14,
                     rcond: float = 1e-10):
    """Generalized symmetric eigensolve ``A v = w B v`` with B PSD, possibly
    rank-deficient: directions of B below ``rcond`` of its largest
    eigenvalue get zero weight, and their spurious eigenvalues a large
    shift, so a smallest-k selection skips them.  Returns (w ascending, V)
    with ``V^T B V = I`` on the kept subspace; two parallel Jacobi solves,
    no library eigensolver."""
    wB, QB = eigh_jacobi_par(B, sweeps=sweeps)
    good = wB > rcond * wB.max(dim=-1, keepdim=True)[0]
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.where(good, wB, 1.0)),
                           0.0)
    T = QB * inv_sqrt[..., None, :]
    At = torch.einsum("...ki,...kl,...lj->...ij", T, A, T)
    At = 0.5 * (At + At.transpose(-1, -2))
    big = 2.0 * torch.diagonal(At, dim1=-2, dim2=-1).abs().sum(dim=-1) + 1.0
    eye = torch.eye(At.shape[-1], dtype=At.dtype, device=At.device)
    At = At + eye * (big[..., None, None]
                     * (~good).to(At.dtype)[..., None, :] * eye)
    wA, QA = eigh_jacobi_par(At, sweeps=sweeps)
    return wA, torch.einsum("...ik,...kj->...ij", T, QA)
