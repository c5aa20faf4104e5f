"""Voigt flattening conventions (counterpart of ``meshfem_tpu/fem/flattening.py``).

* ``flat_len(d) = d (d + 1) / 2``;
* 2D order ``[xx, yy, xy]``, 3D order ``[xx, yy, zz, yz, xz, xy]``;
* flattened rank-2 tensors store raw components (not engineering shear), so
  a contraction with a flattened rank-4 tensor inserts the shear doubler
  ``S = diag(1,..,1, 2,..,2)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def flat_len(dim: int) -> int:
    """Length of a flattened symmetric rank-2 tensor in ``dim`` dimensions."""
    return (dim * (dim + 1)) // 2


def flatten_indices(dim: int, i: int, j: int) -> int:
    """Symmetric (i, j) -> flat index (reference ``Flattening.hh:24-59``)."""
    if i == j:
        return i
    if i > j:
        i, j = j, i
    return (dim * (dim + 1) - j * (j - 1)) // 2 - (i + 1)


def unflatten_index(dim: int, f: int) -> tuple[int, int]:
    """Flat index -> (i, j) with i <= j (reference ``Flattening.hh:62-83``)."""
    if f < dim:
        return (f, f)
    if dim == 2:
        return (0, 1)
    if dim == 3:
        return {3: (1, 2), 4: (0, 2), 5: (0, 1)}[f]
    raise ValueError(f"unsupported dim {dim}")


@functools.lru_cache(maxsize=None)
def _tables(dim: int):
    fl = flat_len(dim)
    rows = np.empty(fl, dtype=np.int64)
    cols = np.empty(fl, dtype=np.int64)
    for f in range(fl):
        rows[f], cols[f] = unflatten_index(dim, f)
    full2flat = np.empty((dim, dim), dtype=np.int64)
    for i in range(dim):
        for j in range(dim):
            full2flat[i, j] = flatten_indices(dim, i, j)
    return rows, cols, full2flat


def flat_rows_cols(dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-flat-slot (i, j) tensor indices, i <= j."""
    r, c, _ = _tables(dim)
    return r, c


def full_to_flat_map(dim: int) -> np.ndarray:
    """(dim, dim) int array mapping full indices to flat slots."""
    return _tables(dim)[2]


def shear_doubler(dim: int) -> np.ndarray:
    """Diagonal of the shear-doubling matrix S: 1 on axial, 2 on shear slots."""
    r, c, _ = _tables(dim)
    return np.where(r == c, 1.0, 2.0)


def sqrt_shear_doubler(dim: int) -> np.ndarray:
    return np.sqrt(shear_doubler(dim))


_DIM_OF_FLAT = {1: 1, 3: 2, 6: 3}


def sym_to_flat(m, dim: int | None = None):
    """[..., d, d] symmetric -> [..., flat] in MeshFEM Voigt order (raw
    components)."""
    r, c, _ = _tables(m.shape[-1] if dim is None else dim)
    return m[..., r, c]


def flat_to_sym(v, dim: int | None = None):
    """[..., flat] -> [..., d, d] full symmetric tensor."""
    f2f = full_to_flat_map(_DIM_OF_FLAT[v.shape[-1]] if dim is None
                           else dim)
    return v[..., f2f]


def flat_trace(v, dim: int | None = None):
    """Trace of flattened symmetric matrices [..., flat] -> [...]."""
    dim = _DIM_OF_FLAT[v.shape[-1]] if dim is None else dim
    return v[..., :dim].sum(dim=-1)


def _shear(v, dim):
    dim = _DIM_OF_FLAT[v.shape[-1]] if dim is None else dim
    return torch.as_tensor(shear_doubler(dim), dtype=v.dtype,
                           device=v.device)


def flat_frobenius_sq(v, dim: int | None = None):
    """Squared Frobenius norm of flattened symmetric matrices (shear
    counted twice)."""
    return (_shear(v, dim) * v * v).sum(dim=-1)


def flat_double_contract(a, b, dim: int | None = None):
    """a : b = sum_ij a_ij b_ij for flattened symmetric matrices."""
    return (_shear(a, dim) * a * b).sum(dim=-1)
