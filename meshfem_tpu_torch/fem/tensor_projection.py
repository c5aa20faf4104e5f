"""Tensor symmetrization projections (counterpart of
``meshfem_tpu/fem/tensor_projection.py``, reference ``TensorProjection.hh``):
the closest isotropic tensor in the Frobenius metric and the isotropy
distance that the homogenization report prints."""

from __future__ import annotations

import torch

from . import elasticity_tensor as et


def closest_isotropic_tensor(D):
    """Frobenius-closest isotropic tensor to D [..., fl, fl]: the projection
    onto span{P_hydro, P_dev}.  The hydrostatic projector P_h = (1/d) I x I
    and the deviatoric P_d = I_s - P_h are orthogonal idempotents, so the
    coefficients are <C, P> / <P, P> (quadruple contractions).  Returns
    (projection, hydrostatic coefficient, deviatoric coefficient)."""
    dim = {1: 1, 3: 2, 6: 3}[D.shape[-1]]
    I_s = et.identity(dim, dtype=D.dtype).to(D.device)
    Ph = torch.zeros_like(I_s)
    Ph[..., :dim, :dim] = 1.0 / dim
    Pd = I_s - Ph
    ch = et.quadruple_contract(D, Ph) / et.quadruple_contract(Ph, Ph)
    cd = et.quadruple_contract(D, Pd) / et.quadruple_contract(Pd, Pd)
    proj = ch[..., None, None] * Ph + cd[..., None, None] * Pd
    return proj, ch, cd


def isotropy_distance(D):
    """Relative Frobenius distance to the closest isotropic tensor."""
    proj, _, _ = closest_isotropic_tensor(D)
    return torch.sqrt(et.frobenius_norm_sq(D - proj)
                      / et.frobenius_norm_sq(D))
