"""Discrete curvature on triangle surfaces (counterpart of
``meshfem_tpu/analysis/curvature.py``; parity with the reference's
``Curvature.hh``, ``GaussianCurvatureSensitivity``).

Angle-deficit Gaussian curvature with mixed-Voronoi vertex areas, all
torch functions of the vertex positions, so the shape derivative that the
reference derives by hand comes from ``torch.autograd``.  The corner
gather ``V[F]`` is a ``GatherPlan`` and the vertex sums over ``F`` its
adjoint ``ScatterPlan``: on the card kernel A gathers and kernel B sums in
float64, and a gradient runs the two the other way round, so it sums in
a fixed order (no ``index_add_``, no accumulating ``index_put_``).
Each function builds the plan of its face table, or takes one that
``corner_plan`` built, so that a caller who evaluates many times on one
surface builds it once.  ``V`` a tensor keeps its device; numpy positions
go to the CUDA device unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..sparse.scatter import GatherPlan


def corner_plan(F, num_vertices: int, device) -> GatherPlan:
    """The ``GatherPlan`` of the corners ``F.reshape(-1)`` over
    ``num_vertices`` rows on ``device``; its ``adjoint`` sums corner values
    into vertices."""
    return GatherPlan.build(np.asarray(F).reshape(-1), num_vertices,
                            config.resolve_device(device))


def _positions(V, device=None) -> torch.Tensor:
    return torch.as_tensor(V, dtype=config.REAL,
                           device=config.device_for(device, V))


def _corners(V: torch.Tensor, F, plan: GatherPlan | None):
    """(X [E, 3, dim] corner positions, the plan that gathered them)."""
    F = np.asarray(F)
    if plan is None:
        plan = corner_plan(F, V.shape[0], V.device)
    elif (plan.num_sources != V.shape[0] or plan.ids.shape[0] != F.size
          or plan.ids.device != V.device):
        raise ValueError("the corner plan is not of this face table, "
                         "vertex count and device")
    return plan(V).reshape(len(F), 3, V.shape[-1]), plan


def _angles_of(X: torch.Tensor) -> torch.Tensor:
    out = []
    for c in range(3):
        a = X[:, (c + 1) % 3] - X[:, c]
        b = X[:, (c + 2) % 3] - X[:, c]
        na = torch.linalg.norm(a, dim=1)
        nb = torch.linalg.norm(b, dim=1)
        cosang = (a * b).sum(dim=1) / torch.clamp(na * nb, min=1e-300)
        out.append(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    return torch.stack(out, dim=1)


def _corner_angles(V, F, device=None, plan=None) -> torch.Tensor:
    """[E, 3] interior angles at each corner."""
    X, _ = _corners(_positions(V, device), F, plan)
    return _angles_of(X)


def angle_deficits(V, F, boundary_vertices=None, device=None,
                   plan=None) -> torch.Tensor:
    """[n] angle deficit: 2 pi - sum of angles (pi - sum on the
    boundary)."""
    V = _positions(V, device)
    X, plan = _corners(V, F, plan)
    total = plan.adjoint(_angles_of(X).reshape(-1))
    full = torch.full((V.shape[0],), 2 * np.pi, dtype=V.dtype,
                      device=V.device)
    if boundary_vertices is not None:
        full[torch.as_tensor(np.asarray(boundary_vertices),
                             device=V.device)] = np.pi
    return full - total


def mixed_voronoi_areas(V, F, device=None, plan=None) -> torch.Tensor:
    """[n] mixed Voronoi vertex areas (obtuse triangles clamped, Meyer et
    al.)."""
    V = _positions(V, device)
    X, plan = _corners(V, F, plan)
    ang = _angles_of(X)
    e1 = X[:, 1] - X[:, 0]
    e2 = X[:, 2] - X[:, 0]
    if X.shape[-1] == 3:
        area = 0.5 * torch.linalg.norm(torch.linalg.cross(e1, e2), dim=-1)
    else:
        area = 0.5 * torch.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    cot = 1.0 / torch.tan(torch.clamp(ang, 1e-9, np.pi - 1e-9))
    obtuse = torch.amax(ang, dim=1) > np.pi / 2
    cols = []
    for c in range(3):
        j, k = (c + 1) % 3, (c + 2) % 3
        l2j = ((X[:, k] - X[:, c]) ** 2).sum(dim=1)
        l2k = ((X[:, j] - X[:, c]) ** 2).sum(dim=1)
        vor = 0.125 * (l2j * cot[:, j] + l2k * cot[:, k])
        clamped = torch.where(ang[:, c] > np.pi / 2, area / 2.0, area / 4.0)
        cols.append(torch.where(obtuse, clamped, vor))
    return plan.adjoint(torch.stack(cols, dim=1).reshape(-1))


def gaussian_curvature(V, F, boundary_vertices=None, device=None,
                       plan=None) -> torch.Tensor:
    """Pointwise Gaussian curvature K = deficit / mixed area."""
    V = _positions(V, device)
    if plan is None:
        plan = corner_plan(F, V.shape[0], V.device)
    d = angle_deficits(V, F, boundary_vertices, plan=plan)
    a = mixed_voronoi_areas(V, F, plan=plan)
    return d / torch.clamp(a, min=1e-300)


def gaussian_curvature_sensitivity(V, F, boundary_vertices=None,
                                   device=None, plan=None) -> torch.Tensor:
    """d(total integrated deficit)/dV by one reverse pass (in place of the
    hand-coded deltas of ``Curvature.hh:19``)."""
    with torch.enable_grad():
        Vr = _positions(V, device).detach().requires_grad_(True)
        total = angle_deficits(Vr, F, boundary_vertices, plan=plan).sum()
        (g,) = torch.autograd.grad(total, Vr)
    return g
