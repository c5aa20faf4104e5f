"""Rank-4 elasticity tensors in flattened (Voigt) form, constant or per
element.

Counterpart of ``meshfem_tpu/fem/elasticity_tensor.py``.  A tensor is a
``[fl, fl]`` (or, per element, ``[..., fl, fl]``) float64 torch tensor
``D`` of raw components; contracting with a flattened strain inserts the
shear doubler: ``stress = D @ (S * strain)`` (``ElasticityTensor.hh:460-466``).
The small inverses and the symmetric eigenproblem go through
``torch.linalg`` (the reference unrolls Gauss-Jordan and Jacobi sweeps for
the TPU, ``utils/linalg.py``); ``eigenstrains`` returns the eigenvalues in
ascending order, as the reference's do, with eigenvectors defined up to
sign.  :class:`ElasticityTensor` is the reference's object API on top.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .flattening import (flat_len, flat_rows_cols, full_to_flat_map,
                         shear_doubler)


def _dim_of(D) -> int:
    return {1: 1, 3: 2, 6: 3}[D.shape[-1]]


def _S(D):
    return torch.as_tensor(shear_doubler(_dim_of(D)), dtype=D.dtype,
                           device=D.device)


# ---------------------------------------------------------------------------
# Constructors (ElasticityTensor.hh:100-170)
# ---------------------------------------------------------------------------

def isotropic_lame(dim: int, lam, mu, dtype=torch.float64) -> torch.Tensor:
    """D for ``lambda tr(e) I + 2 mu e`` (``setIsotropicLame``); ``lam`` and
    ``mu`` are floats or broadcastable arrays (a batch of tensors)."""
    fl = flat_len(dim)
    lam = torch.as_tensor(lam, dtype=dtype)
    mu = torch.as_tensor(mu, dtype=dtype)
    lam, mu = torch.broadcast_tensors(lam, mu)
    D = torch.zeros(lam.shape + (fl, fl), dtype=dtype, device=lam.device)
    D[..., :dim, :dim] = lam[..., None, None]
    for i in range(dim):
        D[..., i, i] += 2.0 * mu
    for s in range(dim, fl):
        D[..., s, s] = mu
    return D


def isotropic(dim: int, E, nu, dtype=torch.float64):
    """D from Young's modulus and Poisson ratio (floats or per-element
    arrays); 2D uses the plane-stress lambda (``setIsotropic``,
    ``ElasticityTensor.hh:100-118``)."""
    E = torch.as_tensor(E, dtype=dtype)
    nu = torch.as_tensor(nu, dtype=dtype)
    mu = E / (2.0 + 2.0 * nu)
    if dim == 2:
        lam = (nu * E) / (1.0 - nu * nu)
    else:
        lam = (nu * E) / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return isotropic_lame(dim, lam, mu, dtype=dtype)


def identity(dim: int, dtype=torch.float64):
    """Symmetric rank-4 identity: lambda = 0, mu = 1/2."""
    return isotropic_lame(dim, 0.0, 0.5, dtype=dtype)


def lame_parameters(D, rtol: float = 1e-9):
    """(lam, mu) floats if the constant flat tensor ``D`` has the isotropic
    Lame structure, else None (selects the factored routed contraction)."""
    Dn = np.asarray(torch.as_tensor(D).detach().cpu(), dtype=np.float64)
    if Dn.ndim != 2:
        return None
    fl = Dn.shape[-1]
    dim = {1: 1, 3: 2, 6: 3}.get(fl)
    if dim is None or dim == 1:
        return None
    lam = float(Dn[0, 1])
    mu = float(Dn[fl - 1, fl - 1])
    ref = isotropic_lame(dim, lam, mu).numpy()
    scale = max(abs(lam) + abs(mu), 1e-300)
    if np.abs(Dn - ref).max() <= rtol * scale:
        return lam, mu
    return None


def _inverse_of_rows(rows, batch, dtype):
    """Invert the matrix whose rows are lists of broadcastable entries."""
    M = torch.stack([torch.stack([torch.broadcast_to(e, batch) for e in r],
                                 dim=-1) for r in rows], dim=-2)
    return torch.linalg.inv(M)


def orthotropic_3d(Ex, Ey, Ez, nu_yx, nu_zx, nu_zy, mu_yz, mu_zx, mu_xy,
                   dtype=torch.float64):
    """``setOrthotropic3D`` (``ElasticityTensor.hh:136-153``): build the
    matrix inverse of D (not the flattened compliance tensor) and invert."""
    args = [torch.as_tensor(a, dtype=dtype) for a in
            (Ex, Ey, Ez, nu_yx, nu_zx, nu_zy, mu_yz, mu_zx, mu_xy)]
    Ex, Ey, Ez, nu_yx, nu_zx, nu_zy, mu_yz, mu_zx, mu_xy = args
    batch = torch.broadcast_shapes(*(a.shape for a in args))
    z = torch.zeros(batch, dtype=dtype)
    return _inverse_of_rows([
        (1.0 / Ex, -nu_yx / Ey, -nu_zx / Ez, z, z, z),
        (-nu_yx / Ey, 1.0 / Ey, -nu_zy / Ez, z, z, z),
        (-nu_zx / Ez, -nu_zy / Ez, 1.0 / Ez, z, z, z),
        (z, z, z, 1.0 / mu_yz, z, z),
        (z, z, z, z, 1.0 / mu_zx, z),
        (z, z, z, z, z, 1.0 / mu_xy)], batch, dtype)


def orthotropic_2d(Ex, Ey, nu_yx, mu_xy, dtype=torch.float64):
    """``setOrthotropic2D`` (``ElasticityTensor.hh:154-162``)."""
    args = [torch.as_tensor(a, dtype=dtype) for a in (Ex, Ey, nu_yx, mu_xy)]
    Ex, Ey, nu_yx, mu_xy = args
    batch = torch.broadcast_shapes(*(a.shape for a in args))
    z = torch.zeros(batch, dtype=dtype)
    return _inverse_of_rows([
        (1.0 / Ex, -nu_yx / Ey, z),
        (-nu_yx / Ey, 1.0 / Ey, z),
        (z, z, 1.0 / mu_xy)], batch, dtype)


def orthotropic(dim: int, moduli, dtype=torch.float64):
    """Moduli in the order of ``getOrthotropicParameters``: 2D (Ex Ey nuYX
    muXY), 3D (Ex Ey Ez nuYX nuZX nuZY muYZ muZX muXY)."""
    if dim == 2:
        return orthotropic_2d(*moduli, dtype=dtype)
    return orthotropic_3d(*moduli, dtype=dtype)


# ---------------------------------------------------------------------------
# Contractions (ElasticityTensor.hh:440-515)
# ---------------------------------------------------------------------------

def apply_D(D, flat):
    """D @ flat; ``flat`` must already be engineering (shear-doubled)
    strain."""
    return torch.einsum("...ab,...b->...a", D, flat)


def double_contract(D, strain_flat):
    """stress = C : strain for flattened raw-component symmetric strains;
    ``D`` and the strain broadcast over leading (element) axes."""
    return torch.einsum("...ab,...b->...a", D, _S(D) * strain_flat)


def double_contract_tensor(DA, DB):
    """F(A : B) = F(A) S F(B) (the result generally lacks major
    symmetry)."""
    return torch.einsum("...ab,...bc->...ac", DA * _S(DA), DB)


def double_double_contract(DA, DB):
    """F(A : B : A) = F(A) S F(B) S F(A) (``doubleDoubleContract``)."""
    return double_contract_tensor(DA, double_contract_tensor(DB, DA))


def quadruple_contract(DA, DB):
    """A :: B = A_ijkl B_ijkl (shear slots weighted by S on both axes)."""
    S = _S(DA)
    return torch.sum(S[:, None] * S[None, :] * DA * DB, dim=(-2, -1))


def frobenius_norm_sq(D):
    return quadruple_contract(D, D)


def inverse(D):
    """Tensor inverse: F(E^-1) = S^-1 F(E)^-1 S^-1
    (``ElasticityTensor.hh:315``)."""
    Sinv = 1.0 / _S(D)
    return Sinv[:, None] * torch.linalg.inv(D) * Sinv[None, :]


def to_full(D):
    """[..., fl, fl] -> [..., d, d, d, d] full rank-4 components."""
    f2f = torch.as_tensor(full_to_flat_map(_dim_of(D)), device=D.device)
    return D[..., f2f[:, :, None, None], f2f[None, None, :, :]]


def from_full(C):
    """[..., d, d, d, d] -> [..., fl, fl] (assumes minor symmetries)."""
    r, c = (torch.as_tensor(a, device=C.device)
            for a in flat_rows_cols(C.shape[-1]))
    return C[..., r[:, None], c[:, None], r[None, :], c[None, :]]


def transform(D, R):
    """Coordinate change E'_ijkl = E_pqrs R_ip R_jq R_kr R_ls
    (``ElasticityTensor.hh:515-545``)."""
    C2 = torch.einsum("...pqrs,...ip,...jq,...kr,...ls->...ijkl", to_full(D),
                      R, R, R, R)
    return from_full(C2)


def eigenstrains(D):
    """Eigen-decomposition E : s = lambda s through the symmetric problem
    S^1/2 F(E) S^1/2 (``computeEigenstrains``).  Returns (eigenstrains
    [..., fl, n] as flattened raw strains, eigenvalues ascending)."""
    sq = torch.sqrt(_S(D))
    lam, Q = torch.linalg.eigh(sq[:, None] * D * sq[None, :])
    return Q / sq[:, None], lam


def pseudoinverse(D, tol: float = 1e-8):
    """Moore-Penrose pseudoinverse in the tensor sense."""
    strains, lam = eigenstrains(D)
    inv_lam = torch.where(lam.abs() > tol,
                          1.0 / torch.where(lam == 0, torch.ones_like(lam),
                                            lam),
                          torch.zeros_like(lam))
    return torch.einsum("...an,...n,...bn->...ab", strains, inv_lam, strains)


def d_row_as_sym_flat(D, i):
    """Row i of D viewed as a flattened symmetric matrix
    (``DRowAsSymMatrix``)."""
    return D[..., i, :]


# ---------------------------------------------------------------------------
# Object wrapper with the reference's API surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticityTensor:
    """Object facade over a flattened D matrix."""

    D: torch.Tensor

    @property
    def dim(self) -> int:
        return _dim_of(self.D)

    @classmethod
    def zero(cls, dim: int, dtype=torch.float64):
        fl = flat_len(dim)
        return cls(torch.zeros((fl, fl), dtype=dtype))

    @classmethod
    def isotropic(cls, dim: int, E, nu, dtype=torch.float64):
        return cls(isotropic(dim, E, nu, dtype=dtype))

    @classmethod
    def isotropic_lame(cls, dim: int, lam, mu, dtype=torch.float64):
        return cls(isotropic_lame(dim, lam, mu, dtype=dtype))

    @classmethod
    def identity(cls, dim: int, dtype=torch.float64):
        return cls(identity(dim, dtype=dtype))

    @classmethod
    def orthotropic(cls, dim: int, *moduli, dtype=torch.float64):
        return cls(orthotropic(dim, moduli, dtype=dtype))

    @classmethod
    def anisotropic(cls, D):
        D = torch.as_tensor(D)
        return cls(0.5 * (D + D.transpose(-1, -2)))

    def double_contract(self, other):
        if isinstance(other, ElasticityTensor):
            return ElasticityTensor(double_contract_tensor(self.D, other.D))
        return double_contract(self.D, other)

    def double_double_contract(self, other):
        DB = other.D if isinstance(other, ElasticityTensor) else other
        return ElasticityTensor(double_double_contract(self.D, DB))

    def quadruple_contract(self, other):
        DB = other.D if isinstance(other, ElasticityTensor) else other
        return quadruple_contract(self.D, DB)

    def frobenius_norm_sq(self):
        return frobenius_norm_sq(self.D)

    def inverse(self):
        return ElasticityTensor(inverse(self.D))

    def pseudoinverse(self, tol: float = 1e-8):
        return ElasticityTensor(pseudoinverse(self.D, tol))

    def transform(self, R):
        return ElasticityTensor(transform(
            self.D, torch.as_tensor(R, dtype=self.D.dtype)))

    def eigenstrains(self):
        return eigenstrains(self.D)

    def to_full(self):
        return to_full(self.D)

    def component(self, i, j, k, l):
        f2f = full_to_flat_map(self.dim)
        return self.D[..., f2f[i, j], f2f[k, l]]

    def get_orthotropic_parameters(self):
        """2D: (Ex, Ey, nuYX, muXY); 3D: (Ex, Ey, Ez, nuYX, nuZX, nuZY,
        muYZ, muZX, muXY), from the tensor inverse (``getOrthotropic3D``)."""
        Einv = inverse(self.D)
        if self.dim == 2:
            Ex = 1.0 / Einv[..., 0, 0]
            Ey = 1.0 / Einv[..., 1, 1]
            return Ex, Ey, -Einv[..., 0, 1] * Ey, 0.25 / Einv[..., 2, 2]
        Ex = 1.0 / Einv[..., 0, 0]
        Ey = 1.0 / Einv[..., 1, 1]
        Ez = 1.0 / Einv[..., 2, 2]
        return (Ex, Ey, Ez, -Einv[..., 0, 1] * Ey, -Einv[..., 0, 2] * Ez,
                -Einv[..., 1, 2] * Ez, 0.25 / Einv[..., 3, 3],
                0.25 / Einv[..., 4, 4], 0.25 / Einv[..., 5, 5])

    def __add__(self, o):
        return ElasticityTensor(self.D + o.D)

    def __sub__(self, o):
        return ElasticityTensor(self.D - o.D)

    def __mul__(self, s):
        return ElasticityTensor(self.D * s)

    __rmul__ = __mul__
