"""Vibrational mode analysis (counterpart of ``meshfem_tpu/analysis/modes.py``,
parity with the reference's ``python/compute_vibrational_modes.py``): the
smallest nonzero eigenpairs of K x = lambda M x with the rigid modes
deflated, by generalized LOBPCG.

Both operators are the simulator's float64 ``EBEKernel`` applies (a plain
gather, one ``torch.bmm``, kernel B): LOBPCG hands them blocks of m and 3m
columns, so B sums 3m and 9m values a node.  They are passed as closures,
so LOBPCG takes its host-stage loop, as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import operators
from ..physics.elasticity import ElasticitySimulator
from ..solvers import eigen


def compute_vibrational_modes(sim: ElasticitySimulator, n_modes: int = 6,
                              fixed_mask=None, tol: float = 1e-7,
                              maxiter: int = 300, seed: int = 0,
                              history: list | None = None):
    """Returns (lambdas [n_modes] numpy, modes [N, dim, n_modes] on the
    simulator's device).

    With no Dirichlet constraints the 3 (2D) / 6 (3D) rigid modes are
    deflated (the reference's python layer shifts by sigma = -1e-6 and
    discards near-zero modes).  ``fixed_mask`` ([Nd, dim] bool) masks both
    operators.  ``history``, when given a list, receives LOBPCG's residual
    history (one [n_modes] array of relative residuals an iteration),
    which the reference drops."""
    mesh = sim.mesh
    d = sim.dim
    Nd = sim.num_dofs
    dev = sim.device
    Mv = operators.mass_elasticity(mesh, device=dev)

    free = None
    if fixed_mask is not None:
        free = torch.as_tensor(~np.asarray(fixed_mask), device=dev).reshape(
            Nd, d)[:, :, None].to(torch.float64)

    def masked(op):
        def apply(V):
            m = V.shape[1]
            U = V.reshape(Nd, d, m)
            if free is not None:
                U = U * free
            out = op(U)
            if free is not None:
                out = out * free
            return out.reshape(Nd * d, m)

        return apply

    deflate = sim.rigid_modes() if fixed_mask is None else None
    rng = np.random.default_rng(seed)
    X0 = torch.as_tensor(rng.standard_normal((Nd * d, n_modes)), device=dev)
    lam, X, hist = eigen.lobpcg_generalized(
        masked(sim.apply_K), masked(Mv), X0, maxiter=maxiter, tol=tol,
        deflate=deflate)
    if history is not None:
        history.extend(hist)
    dof_map = torch.as_tensor(sim.dof_map, device=dev)
    return np.asarray(lam), X.reshape(Nd, d, n_modes)[dof_map]
