"""Isotropic elasticity tensors in flattened (Voigt) form, constant or
per element.

Counterpart of ``meshfem_tpu/fem/elasticity_tensor.py`` for what this slice
uses: ``isotropic_lame``, ``isotropic``, ``lame_parameters``, ``to_full`` and
``double_contract``.  A tensor is a ``[fl, fl]`` (or, per element,
``[E, fl, fl]``) float64 torch tensor ``D`` of raw components; contracting with a flattened strain inserts the shear
doubler: ``stress = D @ (S * strain)`` (``ElasticityTensor.hh:460-466``).
"""

from __future__ import annotations

import numpy as np
import torch

from .flattening import flat_len, full_to_flat_map, shear_doubler


def _dim_of(D) -> int:
    return {1: 1, 3: 2, 6: 3}[D.shape[-1]]


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


def to_full(D):
    """[..., fl, fl] -> [..., d, d, d, d] full rank-4 components."""
    f2f = torch.as_tensor(full_to_flat_map(_dim_of(D)), device=D.device)
    return D[..., f2f[:, :, None, None], f2f[None, None, :, :]]


def double_contract(D, strain_flat):
    """stress = C : strain for flattened raw-component symmetric strains;
    ``D`` and the strain broadcast over leading (element) axes."""
    S = torch.as_tensor(shear_doubler(_dim_of(D)), dtype=D.dtype,
                        device=D.device)
    return torch.einsum("...ab,...b->...a", D, S * strain_flat)
