"""Nonlinear energy densities on torch tensors (counterpart of
``meshfem_tpu/physics/energies.py``).

Parity with the reference's ``EnergyDensities/`` (corotated linear
elasticity, NeoHookean, St. Venant-Kirchhoff, the membrane and
tension-field variants, F-based / C-based adaptors, the tangent elasticity
tensor), batched over elements.  Derivatives come from ``torch.autograd``
where the reference takes ``jax.grad`` / ``jax.jvp``: a stress is one
backward pass, and a tangent applied to a direction differentiates
``<stress, direction>`` once more, which is the Hessian applied to it (the
Hessian of a scalar is symmetric).

Conventions: F is the deformation gradient [..., d, d]; energies are per
unit reference volume; material parameters are Lame (lambda, mu).  The
element gather of :func:`deformation_gradients` is kernel A on the card,
and its adjoint, in every gradient of :func:`total_energy`, kernel B.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..fem import shape_functions as sf
from ..sparse.scatter import GatherPlan
from ..utils import linalg as small_linalg


def _trace(A):
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(dim=-1)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def green_lagrange(F):
    """E = 1/2 (F^T F - I)."""
    d = F.shape[-1]
    return 0.5 * (torch.einsum("...ki,...kj->...ij", F, F) - _eye(d, F))


def stvk_energy(F, lam, mu):
    """St. Venant-Kirchhoff: mu E:E + lam/2 tr(E)^2
    (``StVenantKirchhoff.hh``)."""
    E = green_lagrange(F)
    return mu * (E * E).sum(dim=(-2, -1)) + 0.5 * lam * _trace(E) ** 2


def neo_hookean_energy(F, lam, mu):
    """Compressible NeoHookean: mu/2 (I1 - d) - mu ln J + lam/2 (ln J)^2
    (``NeoHookeanEnergy.hh``)."""
    d = F.shape[-1]
    I1 = (F * F).sum(dim=(-2, -1))
    lnJ = torch.log(torch.clamp(small_linalg.det(F), min=1e-12))
    return 0.5 * mu * (I1 - d) - mu * lnJ + 0.5 * lam * lnJ ** 2


def corotated_energy(F, lam, mu, sweeps: int = 8):
    """Corotated linear elasticity: mu ||S - I||_F^2 + lam/2 tr(S - I)^2
    with S of the polar decomposition F = R S, from the Jacobi
    eigendecomposition of F^T F (``CorotatedLinearElasticity.hh``)."""
    d = F.shape[-1]
    C = torch.einsum("...ki,...kj->...ij", F, F)
    w, V = small_linalg.eigh_jacobi(C, sweeps=sweeps)
    s = torch.sqrt(torch.clamp(w, min=1e-14))
    S = torch.einsum("...ik,...k,...jk->...ij", V, s, V)
    D = S - _eye(d, F)
    return mu * (D * D).sum(dim=(-2, -1)) + 0.5 * lam * _trace(D) ** 2


def linear_elasticity_energy(F, lam, mu):
    """Small-strain quadratic energy: mu e:e + lam/2 tr(e)^2,
    e = sym(F) - I."""
    d = F.shape[-1]
    e = 0.5 * (F + F.transpose(-1, -2)) - _eye(d, F)
    return mu * (e * e).sum(dim=(-2, -1)) + 0.5 * lam * _trace(e) ** 2


ENERGY_DENSITIES = {
    "stvk": stvk_energy,
    "neo_hookean": neo_hookean_energy,
    "corotated": corotated_energy,
    "linear": linear_elasticity_energy,
}


def _grad_of_sum(fn, X):
    """d sum(fn(X)) / dX; differentiable again when X carries a graph."""
    with torch.enable_grad():
        if X.requires_grad:
            g, = torch.autograd.grad(fn(X).sum(), X, create_graph=True)
        else:
            Xr = X.detach().requires_grad_(True)
            g, = torch.autograd.grad(fn(Xr).sum(), Xr)
    return g


def _directional(stress, X, dX):
    """The derivative of ``stress`` at X along dX: the vector-Jacobian
    product with dX, which is the Jacobian applied to dX because the
    stress is a gradient."""
    with torch.enable_grad():
        Xr = X.detach().requires_grad_(True)
        out, = torch.autograd.grad(stress(Xr), Xr, dX)
    return out


def pk1_stress(energy_fn):
    """First Piola-Kirchhoff stress P = dPsi/dF (replaces the hand-coded
    ``denergy`` members)."""
    def P(F, *params):
        return _grad_of_sum(lambda F_: energy_fn(F_, *params), F)

    return P


def tangent_apply(energy_fn):
    """delta-P operator dP = d2Psi/dF2 : dF (replaces ``delta_denergy`` /
    ``TangentElasticityTensor.hh``)."""
    P = pk1_stress(energy_fn)

    def dP(F, dF, *params):
        return _directional(lambda F_: P(F_, *params), F, dF)

    return dP


# ---------------------------------------------------------------------------
# Total potential energy over a mesh (drives solvers/newton.py).
# ---------------------------------------------------------------------------

def element_gather(mesh, device) -> GatherPlan:
    """The gather of each element's node rows, ``[N, d] -> [E*n, d]``
    (kernel A on the card; its adjoint, built at the first gradient, is
    kernel B)."""
    return GatherPlan.build(mesh.elem_nodes.reshape(-1), mesh.num_nodes,
                            device)


def deformation_gradients(mesh, x, geometry=None, gather=None):
    """F [E, d, d] of a deformed nodal position field x [N, d] (P1 exact /
    P2 centroid), from the reference configuration's barycentric
    gradients; ``gather`` (optional) is a shared :func:`element_gather`."""
    g = geometry or mesh.geometry(x.device)
    centroid = np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
    dN = torch.as_tensor(sf.grad_shape_np(mesh.K, mesh.degree, centroid)[0],
                         dtype=g.grad_lambda.dtype, device=x.device)
    gp = torch.einsum("nk,ekd->end", dN, g.grad_lambda)     # [E, n, dim]
    gather = gather or element_gather(mesh, x.device)
    xe = gather(x).reshape(mesh.num_elements, mesh.nodes_per_elem,
                           x.shape[-1])
    return torch.einsum("enc,end->ecd", xe, gp)


def total_energy(mesh, energy: str, lam, mu, geometry=None, device=None):
    """A function x [N, d] -> scalar total strain energy (one-point
    quadrature: exact for P1), on ``device`` (the CUDA device by default,
    or ``geometry``'s)."""
    density = ENERGY_DENSITIES[energy]
    g = geometry or mesh.geometry(config.resolve_device(device))
    vol = g.volume
    gather = element_gather(mesh, vol.device)

    def E(x):
        F = deformation_gradients(mesh, x, g, gather)
        return torch.sum(vol * density(F, lam, mu))

    return E


def principal_stretches_2d(F, sweeps: int = 8):
    """Singular values of the (possibly 3x2) membrane deformation
    gradient."""
    C = torch.einsum("...ki,...kj->...ij", F, F)   # [.., 2, 2]
    tr = C[..., 0, 0] + C[..., 1, 1]
    det = C[..., 0, 0] * C[..., 1, 1] - C[..., 0, 1] * C[..., 1, 0]
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    l1 = torch.sqrt(torch.clamp(tr / 2 + disc, min=1e-30))
    l2 = torch.sqrt(torch.clamp(tr / 2 - disc, min=1e-30))
    return l1, l2


def membrane_stvk_energy(F, lam, mu):
    """Plane-stress StVK membrane energy, F [..., 3or2, 2], in smooth
    invariants of the 2x2 Green strain."""
    C = torch.einsum("...ki,...kj->...ij", F, F)
    Eg = 0.5 * (C - _eye(2, F))
    trE = Eg[..., 0, 0] + Eg[..., 1, 1]
    lam_ps = 2.0 * lam * mu / (lam + 2.0 * mu)
    return mu * (Eg * Eg).sum(dim=(-2, -1)) + 0.5 * lam_ps * trE ** 2


def tension_field_stvk_energy(F, lam, mu):
    """Relaxed (tension-field-theory) membrane StVK energy
    (``TensionFieldTheory.hh``, after Pipkin 1994): with principal strains
    e1 >= e2, taut (e2 >= -nu* e1) takes the full membrane energy, wrinkled
    (e1 > 0 > relaxed) the uniaxial envelope E* e1^2 / 2, slack (e1 <= 0)
    zero."""
    l1, l2 = principal_stretches_2d(F)
    e1 = 0.5 * (l1 ** 2 - 1.0)
    e2 = 0.5 * (l2 ** 2 - 1.0)
    lam_ps = 2.0 * lam * mu / (lam + 2.0 * mu)
    nu_star = lam_ps / (lam_ps + 2.0 * mu)
    E_star = 2.0 * mu * (1.0 + nu_star)   # plane-stress Young's modulus
    full = mu * (e1 ** 2 + e2 ** 2) + 0.5 * lam_ps * (e1 + e2) ** 2
    uni = 0.5 * E_star * e1 ** 2
    taut = e2 >= -nu_star * e1
    slack = e1 <= 0.0
    return torch.where(slack, torch.zeros_like(full),
                       torch.where(taut, full, uni))


ENERGY_DENSITIES["membrane_stvk"] = membrane_stvk_energy
ENERGY_DENSITIES["tension_field_stvk"] = tension_field_stvk_energy


# ---------------------------------------------------------------------------
# F-based / C-based adaptors and the tangent elasticity tensor (reference
# ``EnergyDensities/EDensityAdaptors.hh``, ``TangentElasticityTensor.hh``):
# densities are plain callables, so adapting is composing, and every
# derivative member is one autograd pass.
# ---------------------------------------------------------------------------

def spd_sqrt(C, iters: int = 18):
    """Principal square root of an SPD matrix [..., n, n]
    (``spdMatrixSqrt``) by the Denman-Beavers iteration: a smooth
    composition of inverses, differentiable at repeated eigenvalues (C = I,
    where every tangent elasticity tensor is taken), where Jacobi rotations
    are not."""
    d = C.shape[-1]
    I = _eye(d, C).expand(C.shape)
    # trace normalization keeps the iteration well-scaled for stiff C
    s = _trace(C)[..., None, None] / d
    Y = C / s
    Z = I
    for _ in range(iters):
        Yn = 0.5 * (Y + small_linalg.inv(Z))
        Z = 0.5 * (Z + small_linalg.inv(Y))
        Y = Yn
    return Y * torch.sqrt(s)


def f_based_from_c_based(psi_C):
    """C-based density Psi(C, *params) -> F-based Psi(F, *params)
    (``EnergyDensityFBasedFromCBased``); F may be [..., 3, 2], the
    membrane case, whose C = F^T F is 2x2."""
    def psi_F(F, *params):
        return psi_C(torch.einsum("...ki,...kj->...ij", F, F), *params)

    return psi_F


def c_based_from_f_based(psi_F):
    """F-based density -> C-based through F = sqrt(C)
    (``EnergyDensityCBasedFromFBased``; rotation-invariant densities)."""
    def psi_C(C, *params):
        return psi_F(spd_sqrt(C), *params)

    return psi_C


def pk2_stress(psi_C):
    """Second Piola-Kirchhoff stress S = 2 dPsi/dC of a C-based density
    (``PK2Stress``)."""
    def S(C, *params):
        return 2.0 * _grad_of_sum(lambda C_: psi_C(C_, *params), C)

    return S


def delta_pk2_stress(psi_C):
    """Directional derivative dS = 2 d2Psi/dC2 : dC (``delta_PK2Stress``)."""
    S = pk2_stress(psi_C)

    def dS(C, dC, *params):
        return _directional(lambda C_: S(C_, *params), C, dC)

    return dS


def tangent_elasticity_tensor(psi, dim: int, *params, F=None, C=None,
                              c_based: bool = False):
    """Tangent elasticity tensor dS/dE (flattened [fl, fl]) of a density
    around a deformation (``tangentElasticityTensor``,
    ``TangentElasticityTensor.hh:21-45``); around the identity, the
    linearized model's elasticity tensor.  ``psi``: F-based (default) or
    C-based (``c_based=True``).  Returns an ``ElasticityTensor``."""
    from ..fem import elasticity_tensor as et
    from ..fem.flattening import flat_len, flat_rows_cols

    psi_C = psi if c_based else c_based_from_f_based(psi)
    if C is None:
        if F is not None:
            F = torch.as_tensor(F, dtype=config.REAL)
            C = torch.einsum("ki,kj->ij", F, F)
        else:
            C = torch.eye(dim, dtype=config.REAL)
    C = torch.as_tensor(C, dtype=config.REAL)
    dS = delta_pk2_stress(psi_C)
    r, c = flat_rows_cols(dim)
    cols = []
    for kl in range(flat_len(dim)):
        # dC = 2 dE: the canonical strain basis kl has 1 on a diagonal
        # slot or 1/2 on the two symmetric shear slots
        dC = torch.zeros((dim, dim), dtype=C.dtype, device=C.device)
        dC[r[kl], c[kl]] = 1.0
        dC = 0.5 * (dC + dC.T) * 2.0
        cols.append(dS(C, dC, *params)[r, c])
    return et.ElasticityTensor(torch.stack(cols, dim=-1))


def projected_tangent_apply(energy_fn, sweeps: int = 10):
    """PSD-projected delta-P operator (``AutoHessianProjection``,
    ``EDensityAdaptors.hh``): the per-element d2Psi/dF2, a symmetric
    [d*d, d*d] matrix, is eigendecomposed by batched Jacobi and its
    negative eigenvalues clamped to zero before it meets dF."""
    P = pk1_stress(energy_fn)

    def dP_proj(F, dF, *params):
        shape = F.shape
        d2 = shape[-2] * shape[-1]
        flat = shape[:-2] + (d2,)
        with torch.enable_grad():
            Fr = F.detach().requires_grad_(True)
            Pf = P(Fr, *params).reshape(flat)
            basis = torch.eye(d2, dtype=F.dtype, device=F.device)
            rows = [torch.autograd.grad(Pf, Fr, basis[i].expand(flat),
                                        retain_graph=True)[0].reshape(flat)
                    for i in range(d2)]
        H = torch.stack(rows, dim=-1)                 # [..., d2, d2]
        H = 0.5 * (H + H.transpose(-1, -2))
        w, V = small_linalg.eigh_jacobi(H, sweeps=sweeps)
        w = torch.clamp(w, min=0.0)
        out = torch.einsum("...ik,...k,...jk,...j->...i", V, w, V,
                           dF.reshape(flat))
        return out.reshape(shape)

    return dP_proj


def stvk_energy_C(C, lam, mu):
    """C-based St. Venant-Kirchhoff (``StVenantKirchhoff.hh``'s native
    form): E = (C - I)/2."""
    d = C.shape[-1]
    E = 0.5 * (C - _eye(d, C))
    return mu * (E * E).sum(dim=(-2, -1)) + 0.5 * lam * _trace(E) ** 2
