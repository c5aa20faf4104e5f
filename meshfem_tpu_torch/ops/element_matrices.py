"""Exact per-element FEM matrices via reference-domain integral tables.

Counterpart of ``meshfem_tpu/ops/element_matrices.py``.  On an affine
simplex each element integral factors into a constant reference tensor
(exact closed-form monomial integrals, computed once per (K, deg) on the
host) times per-element geometry:

    K_e = vol_e * sum_klab g_k^a g_l^b C_{cafb} T_grad[k, l, i, j]

For a constant material the stiffness is ONE product
``Ke = (gg * vol) @ M`` with ``gg [E, ((K+1) d)^2]`` the geometry outer
products and ``M`` the fused constant tensor (``fused_matrix_for`` :160,
``element_elasticity_fused`` :223).  That product is an XLA matmul in the
reference, so here it is ``torch.matmul`` (TF32 off, ``config.py``).  The
scalar operators' tables (``mass_table``, ``element_mass``,
``element_mass_lumped``, ``element_laplacian``) follow the reference's
formulas term for term.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import config
from ..fem import shape_functions as sf
from ..fem.flattening import flat_rows_cols, full_to_flat_map


def _monomial_integral_factor(exps: np.ndarray, K: int) -> np.ndarray:
    """int over the unit-volume K-simplex of prod lambda^alpha per row."""
    out = np.empty(len(exps))
    for r, e in enumerate(exps):
        num = math.factorial(K) * np.prod([math.factorial(int(a)) for a in e])
        out[r] = num / math.factorial(int(e.sum()) + K)
    return out


def _poly_product_integrals(expsA, coeffsA, expsB, coeffsB, K):
    """[nA, nB] exact integrals int p_i q_j over the unit simplex."""
    MA, MB = len(expsA), len(expsB)
    fac = np.empty((MA, MB))
    for m in range(MA):
        for n in range(MB):
            e = expsA[m] + expsB[n]
            num = math.factorial(K) * np.prod(
                [math.factorial(int(a)) for a in e])
            fac[m, n] = num / math.factorial(int(e.sum()) + K)
    return coeffsA.T @ fac @ coeffsB


@functools.lru_cache(maxsize=None)
def _basis_and_derivs(K: int, deg: int):
    """(exps, coeffs, dexps, dcoeffs[v]): derivative polynomials w.r.t.
    each barycentric coordinate over the degree-(deg-1) monomials."""
    exps, coeffs = sf._lagrange_tables(K, deg)
    exps = np.asarray(exps)
    nv, n = K + 1, coeffs.shape[1]
    dexps = sf._monomial_exponents(K, deg - 1)
    index = {tuple(e): i for i, e in enumerate(dexps)}
    dcoeffs = np.zeros((nv, len(dexps), n))
    for v in range(nv):
        for m, e in enumerate(exps):
            if e[v] == 0:
                continue
            e2 = e.copy()
            e2[v] -= 1
            dcoeffs[v, index[tuple(e2)], :] += e[v] * coeffs[m, :]
    return exps, coeffs, dexps, dcoeffs


@functools.lru_cache(maxsize=None)
def mass_table(K: int, deg: int) -> np.ndarray:
    """[n, n] exact int phi_i phi_j over the unit-volume reference simplex."""
    exps, coeffs, _, _ = _basis_and_derivs(K, deg)
    return _poly_product_integrals(exps, coeffs, exps, coeffs, K)


@functools.lru_cache(maxsize=None)
def gradgrad_table(K: int, deg: int) -> np.ndarray:
    """[K+1, K+1, n, n] exact int (dphi_i/dlam_k)(dphi_j/dlam_l)."""
    _, _, dexps, dcoeffs = _basis_and_derivs(K, deg)
    nv = K + 1
    n = dcoeffs.shape[2]
    T = np.empty((nv, nv, n, n))
    for k in range(nv):
        for l in range(nv):
            T[k, l] = _poly_product_integrals(
                dexps, dcoeffs[k], dexps, dcoeffs[l], K)
    return T


@functools.lru_cache(maxsize=None)
def shape_grad_table(K: int, deg: int) -> np.ndarray:
    """[K+1, n] exact int dphi_i/dlam_k (constant-strain loads)."""
    _, _, dexps, dcoeffs = _basis_and_derivs(K, deg)
    fac = _monomial_integral_factor(np.asarray(dexps), K)
    return np.einsum("m,vmn->vn", fac, dcoeffs)


def _table(T: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(T, dtype=like.dtype, device=like.device)


def element_mass(volume, K: int, deg: int):
    """[E, n, n] consistent mass matrices (reference ``element_mass``
    :111, ``MassMatrix.hh:49``)."""
    return volume[:, None, None] * _table(mass_table(K, deg), volume)


def element_mass_lumped(volume, K: int, deg: int):
    """[E, n] row-sum lumped mass (``element_mass_lumped`` :117)."""
    return volume[:, None] * _table(mass_table(K, deg).sum(axis=1), volume)


def element_laplacian(grad_lambda, volume, deg: int):
    """[E, n, n] stiffness int grad phi_i . grad phi_j (reference
    ``element_laplacian`` :123, ``Laplacian.hh:28-56``) for K-simplices
    embedded in any dimension: ``grad_lambda [E, K+1, dim]``."""
    K = grad_lambda.shape[-2] - 1
    T = _table(gradgrad_table(K, deg), grad_lambda)
    G = torch.einsum("ekd,eld->ekl", grad_lambda, grad_lambda)
    return volume[:, None, None] * torch.einsum("ekl,klij->eij", G, T)


def fused_matrix_for(D, K: int, deg: int) -> np.ndarray:
    """The fused constant tensor M[(k,a,l,b), (i,c,j,f)] =
    T[k,l,i,j] C[c,a,f,b] (float64 numpy) turning element stiffness into
    ONE matmul: ``Ke = (gg @ M) * vol``."""
    D_np = np.asarray(torch.as_tensor(D).detach().cpu(), dtype=np.float64)
    dim = {1: 1, 3: 2, 6: 3}[D_np.shape[-1]]
    f2f = full_to_flat_map(dim)
    C_full = D_np[f2f[:, :, None, None], f2f[None, None, :, :]]
    T = gradgrad_table(K, deg)
    M = np.einsum("klij,cafb->kalbicjf", T, C_full)
    nv, n = K + 1, T.shape[-1]
    return M.reshape(nv * dim * nv * dim, n * dim * n * dim)


def element_elasticity(grad_lambda, volume, D, deg: int):
    """[E, n*dim, n*dim] elasticity stiffness, dofs interleaved
    component-fastest (``dof = node * dim + comp``) like the reference
    (``element_elasticity`` :262).  ``D``: a constant ``[fl, fl]`` (the fused
    single matmul) or per-element ``[E, fl, fl]`` (the batched einsum)."""
    if D.ndim == 2:
        return element_elasticity_fused(grad_lambda, volume, D, deg)
    K = grad_lambda.shape[-2] - 1
    dim = grad_lambda.shape[-1]
    T = torch.as_tensor(gradgrad_table(K, deg), dtype=grad_lambda.dtype,
                        device=grad_lambda.device)
    n = T.shape[-1]
    D = D.to(dtype=grad_lambda.dtype, device=grad_lambda.device)
    # C[e, i, j, k, l] = D[e, f2f[i, j], f2f[k, l]] as a product with a 0/1
    # selection matrix: exact (each entry is one D entry times 1), and its
    # gradient is a product too, where an index's would be an accumulating
    # index_put_ (material optimization differentiates Ke in D)
    fl = D.shape[-1]
    f2f = full_to_flat_map(dim)
    sel = np.zeros((fl, fl, dim, dim, dim, dim))
    i, j, k, l = np.indices((dim,) * 4)
    sel[f2f[i, j], f2f[k, l], i, j, k, l] = 1.0
    sel = torch.as_tensor(sel.reshape(fl * fl, dim ** 4), dtype=D.dtype,
                          device=D.device)
    C = (D.reshape(D.shape[:-2] + (fl * fl,)) @ sel).reshape(
        D.shape[:-2] + (dim,) * 4)                              # [E,d,d,d,d]
    H = torch.einsum("eka,elb,ecafb->eklcf", grad_lambda, grad_lambda, C)
    Ke = torch.einsum("klij,eklcf->eicjf", T, H)
    Ke = volume[:, None, None, None, None] * Ke
    return Ke.reshape(-1, n * dim, n * dim)


def element_elasticity_fused_apply(grad_lambda, volume, M, n: int):
    """Fused assembly given the precomputed matrix ``M [((K+1) d)^2,
    (n d)^2]`` (``fused_matrix_for``), counterpart of
    ``element_elasticity_fused_apply`` :174: the volume is folded into the
    small Gram operand and the product is one ``torch.matmul`` (TF32 off).
    It stays the default assembly; ``kernels.element_stiffness`` is its
    hand-written float32 drop-in."""
    E, K1, dim = grad_lambda.shape
    gdim = K1 * dim
    gg = torch.einsum("eka,elb->ekalb", grad_lambda,
                      grad_lambda).reshape(E, gdim * gdim)
    Ke = torch.matmul(gg * volume[:, None], M)
    return Ke.reshape(E, n * dim, n * dim)


def fused_matrix_sym_for(D, K: int, deg: int, dtype=torch.float64,
                         device=None):
    """``fused_matrix_for`` folded over the symmetric pairs of the Gram
    tensor ``gg[(k,a),(l,b)] = g_ka g_lb`` (reference :192): ``gdim (gdim +
    1) / 2`` rows instead of ``gdim^2``, half the assembly product.
    Returns ``(M_sym [npairs, (nd)^2], idx_a [npairs], idx_b [npairs])`` on
    ``device`` (the CUDA device unless the caller asks for another)."""
    M = fused_matrix_for(D, K, deg)
    gdim = int(round(M.shape[0] ** 0.5))
    ia, ib = np.triu_indices(gdim)
    M2 = M.reshape(gdim, gdim, -1)
    Ms = M2[ia, ib] + np.where((ia != ib)[:, None], M2[ib, ia], 0.0)
    dev = config.resolve_device(device)
    return (torch.as_tensor(Ms, dtype=dtype, device=dev),
            torch.as_tensor(ia, device=dev), torch.as_tensor(ib, device=dev))


def element_elasticity_fused_apply_sym(grad_lambda, volume, M_sym, idx_a,
                                       idx_b, n: int):
    """Fused assembly through the symmetric-pair matrix
    (``fused_matrix_sym_for``; reference :213): one ``[E, npairs]``
    product and one ``torch.matmul`` (TF32 off).  On no default path, as
    in the reference."""
    E, K1, dim = grad_lambda.shape
    gflat = grad_lambda.reshape(E, K1 * dim)
    gg = gflat[:, idx_a] * gflat[:, idx_b]                  # [E, npairs]
    Ke = torch.matmul(gg, M_sym) * volume[:, None]
    return Ke.reshape(E, n * dim, n * dim)


def element_elasticity_fused(grad_lambda, volume, D, deg: int):
    """Stiffness of a CONSTANT material (``element_elasticity_fused``
    :223): one batched outer product and one [E, gdim^2] x [gdim^2, (nd)^2]
    matmul; the geometry temporary is freed before return."""
    K = grad_lambda.shape[-2] - 1
    dim = grad_lambda.shape[-1]
    E = grad_lambda.shape[0]
    n = gradgrad_table(K, deg).shape[-1]
    M = torch.as_tensor(fused_matrix_for(D, K, deg), dtype=grad_lambda.dtype,
                        device=grad_lambda.device)
    gdim = (K + 1) * dim
    gg = torch.einsum("eka,elb->ekalb", grad_lambda,
                      grad_lambda).reshape(E, gdim * gdim)
    Ke = torch.matmul(gg, M)
    del gg
    Ke.mul_(volume[:, None])
    return Ke.reshape(E, n * dim, n * dim)


def element_strain_matrix(grad_lambda, deg: int, quad_points):
    """[E, Q, fl, n, dim] operator mapping nodal displacements u[e, n, dim]
    to raw-Voigt strains at the barycentric points ``quad_points``."""
    K = grad_lambda.shape[-2] - 1
    dim = grad_lambda.shape[-1]
    dN = torch.as_tensor(sf.grad_shape_np(K, deg, np.asarray(quad_points)),
                         dtype=grad_lambda.dtype, device=grad_lambda.device)
    gp = torch.einsum("qnk,ekd->eqnd", dN, grad_lambda)
    r, c = flat_rows_cols(dim)
    E_, Q, n, _ = gp.shape
    B = gp.new_zeros((E_, Q, len(r), n, dim))
    for a, (i, j) in enumerate(zip(r, c)):
        B[:, :, a, :, i] += 0.5 * gp[..., j]
        B[:, :, a, :, j] += 0.5 * gp[..., i]
    return B
