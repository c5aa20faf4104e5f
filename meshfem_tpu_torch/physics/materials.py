"""Material models and ``.material`` JSON parsing (counterpart of
``meshfem_tpu/physics/materials.py``).

Isotropic, orthotropic 2D/3D and general anisotropic materials, constant
(``Material``) or per element (``MaterialField``); the reference's
``.material`` schema (``parse_material``, ``load_material``,
``save_material``); and the stress-strain fits ``fit_isotropic`` and
``fit_orthotropic``, which run on the host with numpy and scipy, as in the
reference.  ``D`` is a float64 torch tensor on the CPU; the simulator moves
it to its device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..fem import elasticity_tensor as et
from ..fem.flattening import flat_len


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

    @classmethod
    def orthotropic(cls, dim: int, moduli, density: float = 1.0) -> "Material":
        return cls(dim, et.orthotropic(dim, list(moduli)), density,
                   "orthotropic", {"moduli": list(moduli)})

    @classmethod
    def anisotropic(cls, dim: int, D, density: float = 1.0) -> "Material":
        D = torch.as_tensor(np.asarray(D, dtype=np.float64))
        fl = flat_len(dim)
        if tuple(D.shape) != (fl, fl):
            raise ValueError(f"anisotropic D must be {fl}x{fl}")
        return cls(dim, 0.5 * (D + D.t()), density, "anisotropic")

    @property
    def tensor(self) -> et.ElasticityTensor:
        return et.ElasticityTensor(self.D)


def parse_material(data: dict, dim: int | None = None) -> Material:
    """Parse the reference's ``.material`` JSON schema.  ``dim`` overrides
    the file's dimension: the reference instantiates the material at the
    run's dimension (``Simulate_cli.cc:104-175``)."""
    mtype = data.get("type", "isotropic_material")
    dim = int(data.get("dim", 3)) if dim is None else int(dim)
    density = float(data.get("density", 1.0))
    # "anisotropic" first: the type name contains "isotropic" (the
    # reference tests "isotropic" first and so cannot read this type)
    if "anisotropic" in mtype:
        fl = flat_len(dim)
        raw = np.asarray(data["material_matrix"], dtype=np.float64)
        return Material.anisotropic(dim, raw.reshape(fl, fl), density)
    if "isotropic" in mtype:
        return Material.isotropic(dim, float(data["young"]),
                                  float(data["poisson"]), density)
    if "orthotropic" in mtype:
        if dim == 2:
            m = [data["young_x"], data["young_y"],
                 data["poisson_yx"], data["shear_xy"]]
        else:
            m = [data["young_x"], data["young_y"], data["young_z"],
                 data["poisson_yx"], data["poisson_zx"], data["poisson_zy"],
                 data["shear_yz"], data["shear_zx"], data["shear_xy"]]
        return Material.orthotropic(dim, [float(v) for v in m], density)
    raise ValueError(f"unknown material type {mtype!r}")


def load_material(path, dim: int | None = None) -> Material:
    return parse_material(json.loads(Path(path).read_text()), dim=dim)


def save_material(mat: Material, path) -> None:
    if mat.type == "isotropic":
        data = {"type": "isotropic_material", "dim": mat.dim,
                "density": mat.density, **mat.params}
    elif mat.type == "orthotropic":
        keys2 = ["young_x", "young_y", "poisson_yx", "shear_xy"]
        keys3 = ["young_x", "young_y", "young_z", "poisson_yx", "poisson_zx",
                 "poisson_zy", "shear_yz", "shear_zx", "shear_xy"]
        keys = keys2 if mat.dim == 2 else keys3
        data = {"type": "orthotropic_material", "dim": mat.dim,
                "density": mat.density,
                **dict(zip(keys, mat.params["moduli"]))}
    else:
        data = {"type": "anisotropic_material", "dim": mat.dim,
                "density": mat.density,
                "material_matrix": np.asarray(mat.D.cpu()).tolist()}
    Path(path).write_text(json.dumps(data, indent=2))


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


# ---------------------------------------------------------------------------
# Stress-strain material fitting (the reference's optional Ceres-based
# StressStrainFitCostFunction, Materials.hh:200-400 — here scipy).
# ---------------------------------------------------------------------------

def fit_isotropic(strains, stresses, volumes=None, dim: int | None = None,
                  x0=(1.0, 0.3)):
    """Fit (E, nu) to per-sample (strain, stress) pairs by volume-weighted
    nonlinear least squares on the compliance residual
    r = sqrt(vol) * (S(E, nu) sigma - eps), shear rows scaled by sqrt(2)
    — exactly the reference's cost function (``Materials.hh:201-230``)."""
    import scipy.optimize as sopt

    eps = np.asarray(strains, dtype=np.float64)
    sig = np.asarray(stresses, dtype=np.float64)
    S, fl = eps.shape
    if dim is None:
        dim = {1: 1, 3: 2, 6: 3}[fl]
    vol = np.ones(S) if volumes is None else np.asarray(volumes, float)
    if (vol <= 0).any():
        raise ValueError("Volume must be positive")
    w = np.sqrt(vol)[:, None]
    row_scale = np.ones(fl)
    row_scale[dim:] = np.sqrt(2.0)

    def compliance_apply(E, nu, s):
        out = np.empty_like(s)
        if dim == 3:
            out[:, 0] = s[:, 0] - nu * (s[:, 1] + s[:, 2])
            out[:, 1] = s[:, 1] - nu * (s[:, 0] + s[:, 2])
            out[:, 2] = s[:, 2] - nu * (s[:, 0] + s[:, 1])
            out[:, 3:] = (1.0 + nu) * s[:, 3:]
        else:
            out[:, 0] = s[:, 0] - nu * s[:, 1]
            out[:, 1] = s[:, 1] - nu * s[:, 0]
            out[:, 2:] = (1.0 + nu) * s[:, 2:]
        return out / E

    def residual(x):
        E, nu = x
        r = (compliance_apply(E, nu, sig) - eps) * row_scale[None, :] * w
        return r.reshape(-1)

    res = sopt.least_squares(residual, np.asarray(x0, float),
                             bounds=([1e-12, -0.999], [np.inf, 0.4999]))
    E, nu = res.x
    return float(E), float(nu)


def fit_orthotropic(strains, stresses, volumes=None, dim: int | None = None):
    """Fit orthotropic engineering moduli by volume-weighted LINEAR least
    squares on the compliance entries (eps = S sigma is linear in S).

    Returns a dict: 2D {Ex, Ey, nu_yx, mu_xy}; 3D {Ex, Ey, Ez, nu_yx,
    nu_zx, nu_zy, mu_yz, mu_zx, mu_xy} (the reference's orthotropic
    parameterization, ``Materials.hh:275+``)."""
    eps = np.asarray(strains, dtype=np.float64)
    sig = np.asarray(stresses, dtype=np.float64)
    S, fl = eps.shape
    if dim is None:
        dim = {1: 1, 3: 2, 6: 3}[fl]
    vol = np.ones(S) if volumes is None else np.asarray(volumes, float)
    w = np.sqrt(vol)

    # Unknown compliance entries: diag block upper triangle + shear diag.
    n_c = dim * (dim + 1) // 2
    n_s = fl - dim
    A_rows, b_rows = [], []
    iu = np.triu_indices(dim)
    for s in range(S):
        for i in range(dim):
            row = np.zeros(n_c + n_s)
            for k, (a, b) in enumerate(zip(*iu)):
                if a == i:
                    row[k] += sig[s, b]
                elif b == i:
                    row[k] += sig[s, a]
            A_rows.append(w[s] * row)
            b_rows.append(w[s] * eps[s, i])
        for j in range(n_s):
            row = np.zeros(n_c + n_s)
            row[n_c + j] = sig[s, dim + j]
            A_rows.append(w[s] * np.sqrt(2.0) * row)
            b_rows.append(w[s] * np.sqrt(2.0) * eps[s, dim + j])
    x, *_ = np.linalg.lstsq(np.asarray(A_rows), np.asarray(b_rows),
                            rcond=None)
    C = np.zeros((dim, dim))
    for k, (a, b) in enumerate(zip(*iu)):
        C[a, b] = C[b, a] = x[k]
    Einv = np.diag(C)
    out = {}
    names = ["Ex", "Ey", "Ez"][:dim]
    for i, nm in enumerate(names):
        out[nm] = float(1.0 / Einv[i])
    # raw (tensor-component) shear compliance: eps_raw = sigma_raw / (2 mu)
    if dim == 2:
        out["nu_yx"] = float(-C[0, 1] / C[1, 1])
        out["mu_xy"] = float(1.0 / (2.0 * x[n_c]))
    else:
        out["nu_yx"] = float(-C[0, 1] / C[1, 1])
        out["nu_zx"] = float(-C[0, 2] / C[2, 2])
        out["nu_zy"] = float(-C[1, 2] / C[2, 2])
        out["mu_yz"] = float(1.0 / (2.0 * x[n_c + 0]))
        out["mu_zx"] = float(1.0 / (2.0 * x[n_c + 1]))
        out["mu_xy"] = float(1.0 / (2.0 * x[n_c + 2]))
    return out
