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


def flat_to_sym(v, dim: int):
    """[..., flat] tensor -> [..., d, d] full symmetric tensor."""
    f2f = full_to_flat_map(dim)
    return v[..., f2f]
