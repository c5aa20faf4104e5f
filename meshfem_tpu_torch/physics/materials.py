"""Constant materials and per-element material fields (counterparts of
``Material`` and ``MaterialField`` :109 in
``meshfem_tpu/physics/materials.py``).  The ``.material`` JSON parser and
the material fit are not ported yet (ROADMAP)."""

from __future__ import annotations

import dataclasses

import torch

from ..fem import elasticity_tensor as et


@dataclasses.dataclass
class Material:
    """A constant material: a float64 elasticity tensor D [fl, fl] (CPU)
    plus metadata."""

    dim: int
    D: torch.Tensor
    density: float = 1.0
    type: str = "anisotropic"
    params: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def isotropic(cls, dim: int, young: float, poisson: float,
                  density: float = 1.0) -> "Material":
        return cls(dim, et.isotropic(dim, young, poisson), density,
                   "isotropic", {"young": young, "poisson": poisson})


@dataclasses.dataclass
class MaterialField:
    """Per-element materials (``MaterialField.hh``): D [E, fl, fl]."""

    dim: int
    D: torch.Tensor

    @classmethod
    def constant(cls, dim: int, D, num_elements: int) -> "MaterialField":
        D = torch.as_tensor(D)
        return cls(dim, D.expand((num_elements,) + tuple(D.shape)))

    @classmethod
    def isotropic_field(cls, dim: int, young, poisson) -> "MaterialField":
        """young / poisson: [E] arrays of per-element moduli."""
        return cls(dim, et.isotropic(dim, young, poisson))
