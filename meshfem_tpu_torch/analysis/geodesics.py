"""Geodesics in heat (Crane-Weischedel-Wardetzky), counterpart of
``meshfem_tpu/analysis/geodesics.py``.

Parity with reference ``experiments/geodesic_heat/main.cc:25-92`` /
``GeodesicsInHeat.ipynb``: heat-kernel step (M + t L), normalized negative
gradient, divergence Poisson solve -- all operator-layer composition on
the device, each apply and load summed by kernel B in float64 on the card.
Both solves run at the reference CG's default ``maxiter`` (1000)."""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mesh.femmesh import FEMMesh
from ..ops import operators
from ..solvers import cg as cg_mod


def geodesic_distances(mesh: FEMMesh, source_nodes, t: float | None = None,
                       tol: float = 1e-11, device=None):
    """Approximate geodesic distance [N] from ``source_nodes`` to every
    node, on ``device`` (the CUDA device by default)."""
    dev = config.resolve_device(device)
    source_nodes = np.asarray(source_nodes).reshape(-1)
    L = operators.laplacian(mesh, device=dev)
    M = operators.mass(mesh, device=dev)
    if t is None:
        # t = mean edge length squared (the paper's recommendation; the
        # reference uses bbox-scaled steps).
        edges = mesh.cell.edges()
        el = np.linalg.norm(mesh.V[edges[:, 0]] - mesh.V[edges[:, 1]],
                            axis=1)
        t = float(np.mean(el) ** 2)

    A = lambda u: M(u) + t * L(u)
    fixed = np.zeros(mesh.num_nodes, dtype=bool)
    fixed[source_nodes] = True
    fixedj = torch.as_tensor(fixed, device=dev)
    zeros = torch.zeros(mesh.num_nodes, dtype=config.REAL, device=dev)
    vals = torch.where(fixedj, 1.0, zeros)

    diagA = M.diagonal() + t * L.diagonal()
    # Heat step: A u = 0 with u = 1 at sources (fixVariables equivalent).
    res = cg_mod.solve_dirichlet(A, zeros, fixedj, vals,
                                 M_inv=lambda r: r / diagA, tol=tol)
    u = res.x

    # Normalized negative gradient per element.
    g = operators.gradient(mesh, u)
    nrm = torch.linalg.norm(g, dim=1, keepdim=True)
    X = -g / torch.clamp(nrm, min=1e-300)

    # Divergence Poisson solve with distance 0 at the source:
    # L d = int grad(phi) . X  (weak form of  Laplace d = div X);
    # operators.divergence returns -int grad(phi) . X, hence the sign.
    b = -operators.divergence(mesh, X)
    diagL = L.diagonal()
    safe = torch.where(diagL > 0, diagL, torch.ones_like(diagL))
    res2 = cg_mod.solve_dirichlet(lambda d: L(d), b, fixedj, zeros,
                                  M_inv=lambda r: r / safe, tol=tol)
    d = res2.x
    return d - torch.min(d)
