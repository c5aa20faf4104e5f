"""Constant materials (counterpart of ``Material`` in
``meshfem_tpu/physics/materials.py``).  Per-element material fields and the
``.material`` JSON parser are not ported yet (ROADMAP)."""

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
