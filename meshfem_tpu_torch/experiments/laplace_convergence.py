"""Laplace / Poisson convergence suite (counterpart of
``experiments/laplace_convergence.py``): P1 and P2 L2-error slopes on
refining ``grid_tri`` meshes for the manufactured solution
sin(pi x) sin(pi y) under zero Dirichlet conditions.

Each level solves ``PoissonProblem.solve(..., tol=1e-13)`` (the float64
EBE Laplacian, kernel B at one value a node on the card) and measures the
error through the consistent mass matrix.

Run: python -m meshfem_tpu_torch.experiments.laplace_convergence
     [--max 64] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.ops import operators
from meshfem_tpu_torch.physics import PoissonProblem


def exact(x):
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


def source(x):
    return 2 * np.pi ** 2 * exact(x)


def l2_error(mesh, u, exact_fn):
    """sqrt(d M d) of the nodal error d = u - exact (``u`` a tensor on the
    solve's device)."""
    ue = np.apply_along_axis(exact_fn, 1, mesh.node_positions)
    d = u - torch.as_tensor(ue, dtype=u.dtype, device=u.device)
    M = operators.mass(mesh, device=u.device)
    return float(np.sqrt(max(float(d @ M(d)), 0.0)))


def convergence(max_n: int = 64, degrees=(1, 2), device=None):
    """[(n, degree, L2 error, rate)] for n = 4, 8, ... <= ``max_n``; the
    rate is log2 of the previous level's error over this one's (nan on
    the first level)."""
    rows = []
    for deg in degrees:
        prev = None
        n = 4
        while n <= max_n:
            mesh = FEMMesh(*generators.grid_tri(n, n), degree=deg)
            prob = PoissonProblem(mesh, device=device)
            u, _ = prob.solve(mesh.bdry_nodes, 0.0, source=source,
                              tol=1e-13)
            err = l2_error(mesh, u, exact)
            rate = np.log2(prev / err) if prev else float("nan")
            rows.append((n, deg, err, rate))
            prev = err
            n *= 2
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    print(f"{'n':>5} {'deg':>4} {'L2 error':>14} {'rate':>6}")
    rows = convergence(args.max, device=device)
    for i, (n, deg, err, rate) in enumerate(rows):
        print(f"{n:>5} {deg:>4} {err:>14.6e} {rate:>6.2f}")
        if i + 1 == len(rows) or rows[i + 1][1] != deg:
            print()
    return rows


if __name__ == "__main__":
    main()
