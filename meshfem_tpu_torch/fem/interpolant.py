"""Polynomial interpolants on simplices (counterpart of
``meshfem_tpu/fem/interpolant.py``; parity with the reference's
``Functions.hh:357-672``, ``Interpolant<T, K, Deg>``).

Nodal-value containers with evaluation, exact integration, degree
promotion, arithmetic and construction by sampling a function, batched
over leading axes (a field of per-element interpolants) and over value
shapes (scalar, vector and symmetric-matrix values, in place of
``SymmetricMatrixInterpolant``).  Values are torch tensors; the tables
come from ``shape_functions`` on the host, in the values' dtype and
device.  The port carries degrees 1 and 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from . import shape_functions as sf
from . import simplex

_VALUE_AXES = "abcd"


@dataclasses.dataclass
class Interpolant:
    """values[..., n_nodes, *value_shape] nodal values of a degree-``deg``
    polynomial on a K-simplex."""

    K: int
    deg: int
    values: torch.Tensor
    value_ndim: int = 0     # trailing axes belonging to the value

    @property
    def n_nodes(self) -> int:
        return simplex.num_nodes(self.K, self.deg)

    @classmethod
    def from_function(cls, K: int, deg: int, f, value_ndim: int = 0,
                      device=None):
        """Sample f(barycentric) at the element nodes
        (``Interpolation<K,Deg>::interpolant``, ``Functions.hh:357-444``).
        Values that ``f`` returns as tensors keep their device; numpy or
        floats go to the CUDA device unless ``device="cpu"``."""
        samples = [f(p) for p in sf.node_positions_barycentric(K, deg)]
        dev = config.device_for(device, samples[0])
        vals = torch.stack([torch.as_tensor(v, dtype=config.REAL, device=dev)
                            for v in samples])
        return cls(K, deg, vals, value_ndim)

    def _contract(self, weights):
        """sum_n weights[..., n] values[..., n, *value] (the node axis of
        the values against the last axis of ``weights``)."""
        ax = _VALUE_AXES[:self.value_ndim]
        return torch.einsum(f"...n,...n{ax}->...{ax}", weights, self.values)

    def __call__(self, lambdas):
        """Evaluate at barycentric coordinates [..., K+1]."""
        lam = torch.as_tensor(lambdas, dtype=self.values.dtype,
                              device=self.values.device)
        phi = sf.eval_shape(self.K, self.deg, lam)       # [..., n]
        v = self.values
        if v.dim() == 1 + self.value_ndim:
            # one interpolant: any batch of points
            return torch.tensordot(phi, v, dims=([-1], [0]))
        return self._contract(phi)

    def integrate(self, volume=1.0):
        """Exact integral over an element of the given volume
        (``Functions.hh:239-318`` closed forms)."""
        w = torch.as_tensor(sf.integrated_shape_np(self.K, self.deg),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return volume * self._contract(w)

    def average(self):
        return self.integrate(1.0)

    def promoted(self, deg: int) -> "Interpolant":
        """Degree promotion (``Functions.hh:566``): resample at the
        higher-degree nodes (exact: the polynomial is unchanged)."""
        if deg < self.deg:
            raise ValueError("can only promote to a higher degree")
        pts = torch.as_tensor(sf.node_positions_barycentric(self.K, deg),
                              dtype=self.values.dtype,
                              device=self.values.device)
        phi = sf.eval_shape(self.K, self.deg, pts)       # [m, n]
        ax = _VALUE_AXES[:self.value_ndim]
        vals = torch.einsum(f"mn,...n{ax}->...m{ax}", phi, self.values)
        return Interpolant(self.K, deg, vals, self.value_ndim)

    def _binary(self, other, op):
        if isinstance(other, Interpolant):
            deg = max(self.deg, other.deg)
            a = self.promoted(deg) if self.deg < deg else self
            b = other.promoted(deg) if other.deg < deg else other
            return Interpolant(self.K, deg, op(a.values, b.values),
                               self.value_ndim)
        return Interpolant(self.K, self.deg, op(self.values, other),
                           self.value_ndim)

    def __add__(self, o):
        return self._binary(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._binary(o, lambda a, b: a - b)

    def __mul__(self, s):
        return Interpolant(self.K, self.deg, self.values * s,
                           self.value_ndim)

    __rmul__ = __mul__


def restrict_to_boundary(K: int, deg: int, face: int) -> np.ndarray:
    """Node indices, within the volume element, of the interpolant
    restricted to boundary sub-simplex ``face`` (in place of
    ``InterpolantRestriction.hh``)."""
    from ..mesh.simplicial import TET_FACE_CORNERS, TRI_FACE_CORNERS

    corners = (TRI_FACE_CORNERS if K == 2 else TET_FACE_CORNERS)[face]
    idx = [int(c) for c in corners]
    if deg == 2:
        pairs = simplex.simplex_edges(K)
        for a, b in simplex.simplex_edges(K - 1):
            va, vb = corners[a], corners[b]
            for ei, (s, e) in enumerate(pairs):
                if {s, e} == {va, vb}:
                    idx.append(K + 1 + ei)
                    break
    return np.asarray(idx)
