"""Field sampling at arbitrary points by closest-element queries
(counterpart of ``meshfem_tpu/analysis/field_sampler.py``; parity with the
reference library's ``FieldSampler.hh``, libigl-AABB closest element and
barycentric evaluation, and ``FieldSamplerMatrix.hh``, sampling as a sparse
operator).

The acceleration structure is the reference's host-side uniform bucket
grid over element bounding boxes, and ``locate`` is its algorithm on the
host: the same buckets, the same candidate order and the same tie rule
(an element that contains the point first, then the least distance to
the clamped projection).  ``sample_nodal`` and ``sample_element`` gather
and contract on ``device``: a tensor's own device by default, and the
CUDA device for an array unless the caller passes ``device="cpu"``;
``sample_matrix`` is scipy.
"""

from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np
import torch

from .. import config
from ..fem import shape_functions as sf
from ..mesh.femmesh import FEMMesh


class FieldSampler:
    def __init__(self, mesh: FEMMesh, grid_res: int | None = None):
        self.mesh = mesh
        V, F = mesh.V, mesh.F
        self.K = mesh.K
        E = len(F)
        if grid_res is None:
            grid_res = max(1, int(np.ceil(E ** (1.0 / mesh.dim))))
        bb = mesh.bbox()
        self.lo = bb.min - 1e-12
        self.h = (bb.dimensions + 2e-12) / grid_res
        self.res = grid_res
        # bucket the elements by the cells their bounding boxes overlap
        Xe = V[F]
        lo_cell = np.floor((Xe.min(axis=1) - self.lo) / self.h).astype(int)
        hi_cell = np.floor((Xe.max(axis=1) - self.lo) / self.h).astype(int)
        lo_cell = np.clip(lo_cell, 0, grid_res - 1)
        hi_cell = np.clip(hi_cell, 0, grid_res - 1)
        buckets = defaultdict(list)
        for e in range(E):
            rng = [range(lo_cell[e, d], hi_cell[e, d] + 1)
                   for d in range(mesh.dim)]
            for cell in itertools.product(*rng):
                buckets[cell].append(e)
        self.buckets = {k: np.asarray(v) for k, v in buckets.items()}

    def _candidates(self, p):
        cell = tuple(np.clip(np.floor((p - self.lo) / self.h).astype(int),
                             0, self.res - 1))
        cand = self.buckets.get(cell)
        if cand is None or len(cand) == 0:
            return np.arange(len(self.mesh.F))
        return cand

    def locate(self, points):
        """For each query point: (element index, barycentric coords [K+1]).
        Points outside the mesh snap to the closest candidate element
        (clamped barycentric coordinates)."""
        mesh = self.mesh
        V, F = mesh.V, mesh.F
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        elems = np.empty(len(pts), dtype=np.int64)
        barys = np.empty((len(pts), mesh.K + 1))
        for i, p in enumerate(pts):
            cand = self._candidates(p)
            X = V[F[cand]]
            lam = self._barycentric(X, p)
            clamped = np.clip(lam, 0.0, None)
            clamped /= clamped.sum(axis=1, keepdims=True)
            proj = np.einsum("ek,ekd->ed", clamped, X)
            d2 = ((proj - p) ** 2).sum(axis=1)
            # prefer true containment
            inside = (lam >= -1e-10).all(axis=1)
            d2 = np.where(inside, -1.0, d2)
            best = int(np.argmin(d2))
            elems[i] = cand[best]
            barys[i] = clamped[best] if not inside[best] else lam[best]
        return elems, barys

    @staticmethod
    def _barycentric(X, p):
        """[e, K+1, dim] corners, point p -> [e, K+1] barycentric coords."""
        A = np.swapaxes(X[:, 1:] - X[:, :1], 1, 2)       # [e, dim, K]
        rhs = (p - X[:, 0])                              # [e, dim]
        AtA = np.einsum("edk,edl->ekl", A, A)
        Atb = np.einsum("edk,ed->ek", A, rhs)
        lam_rest = np.linalg.solve(AtA, Atb[..., None])[..., 0]
        lam0 = 1.0 - lam_rest.sum(axis=1, keepdims=True)
        return np.concatenate([lam0, lam_rest], axis=1)

    def sample_nodal(self, field, points, device=None) -> torch.Tensor:
        """Sample a nodal field [N(, c)] at query points: [q(, c)] on
        ``device`` (default: a tensor's own device, else the CUDA
        device; pass ``device="cpu"`` for the host)."""
        field = torch.as_tensor(field,
                                device=config.device_for(device, field))
        elems, barys = self.locate(points)
        phi = torch.as_tensor(
            sf.eval_shape_np(self.mesh.K, self.mesh.degree, barys),
            dtype=field.dtype, device=field.device)              # [q, n]
        nodes = torch.as_tensor(self.mesh.elem_nodes[elems],
                                device=field.device)
        return torch.einsum("qn,qn...->q...", phi, field[nodes])

    def sample_element(self, field, points, device=None) -> torch.Tensor:
        """Sample a per-element field at query points, on ``device`` (as
        :meth:`sample_nodal`)."""
        field = torch.as_tensor(field,
                                device=config.device_for(device, field))
        elems, _ = self.locate(points)
        return field[torch.as_tensor(elems, device=field.device)]

    def sample_matrix(self, points):
        """Sampling as a scipy sparse matrix [n_pts, N]
        (``FieldSamplerMatrix.hh``)."""
        import scipy.sparse as sp

        elems, barys = self.locate(points)
        phi = sf.eval_shape_np(self.mesh.K, self.mesh.degree, barys)
        nodes = self.mesh.elem_nodes[elems]
        rows = np.repeat(np.arange(len(elems)), nodes.shape[1])
        return sp.coo_matrix(
            (phi.ravel(), (rows, nodes.ravel())),
            shape=(len(elems), self.mesh.num_nodes)).tocsr()
