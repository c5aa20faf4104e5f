"""Differential one-forms: linear functionals of vector fields
(counterpart of ``meshfem_tpu/fem/one_form.py``; parity with the
reference's ``OneForm.hh``, ``ScalarOneForm<N>``, which carries shape
derivatives, ``LinearElasticity.hh:448,721``).

A one-form is its coefficient field dJ/dX [N, dim]; pairing with a
velocity field is an inner product.  ``OneForm.of`` takes the coefficients
from ``torch.autograd.grad`` where the reference takes ``jax.grad``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config


@dataclasses.dataclass
class OneForm:
    """coefficients[..., N, dim]; leading axes for tensor-valued forms (a
    one-form per entry of the homogenized tensor)."""

    coeffs: torch.Tensor

    def __call__(self, velocity):
        """Pair with a velocity field [N, dim] -> [...] values."""
        v = torch.as_tensor(velocity, dtype=self.coeffs.dtype,
                            device=self.coeffs.device)
        return torch.einsum("...nd,nd->...", self.coeffs, v)

    def __add__(self, o):
        return OneForm(self.coeffs + o.coeffs)

    def __sub__(self, o):
        return OneForm(self.coeffs - o.coeffs)

    def __mul__(self, s):
        return OneForm(self.coeffs * s)

    __rmul__ = __mul__

    @classmethod
    def of(cls, scalar_fn, X, device=None):
        """One-form of a scalar function of node positions, by one reverse
        pass.  ``X`` a tensor keeps its device; numpy goes to the CUDA
        device unless ``device="cpu"``."""
        dev = config.device_for(device, X)
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(X, dtype=config.REAL)
        with torch.enable_grad():
            Xr = X.detach().to(dev).requires_grad_(True)
            (g,) = torch.autograd.grad(scalar_fn(Xr), Xr)
        return cls(g)


def compose(fn, form: OneForm) -> OneForm:
    """Push a linear map ``fn`` of the leading (value) axes through a
    tensor-valued one-form (reference ``compose`` on OneForms)."""
    return OneForm(torch.as_tensor(fn(form.coeffs)))
