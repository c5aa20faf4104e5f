"""Elasticity convergence suite (counterpart of
``experiments/elasticity_convergence.py``): P1 and P2 energy-norm error
slopes of plane-stress elasticity with a Poisson-ratio sweep, beside a
diagonal condition estimate.

The manufactured displacement u = (sin(pi x) sin(pi y), x^2 y) is imposed
on the boundary and its Galerkin projection (load K u_exact) solved with
``ElasticitySimulator.solve(extra_load=b, tol=1e-12)``; on the card that
is float32 CG inside float64 refinement.  Where refinement stops above
the tolerance (its float32 floor near nu = 0.5), the module prints the
float64 relative residual it reached after the table instead of relaxing
the tolerance.  (The reference imports ``largest_magnitude_eigenvalue``
and never uses it; the port does not.)

Run: python -m meshfem_tpu_torch.experiments.elasticity_convergence
     [--max 32] [--nu 0.3 0.45 0.49] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material

E_YOUNG = 1.0
TOL = 1e-12


def exact(x):
    return np.array([np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]),
                     x[0] ** 2 * x[1]])


def solve_level(n: int, deg: int, nu: float, device=None, tol: float = TOL):
    """One level: (energy-norm error, diagonal condition estimate, the
    float64 relative residual ||P(b - K u)|| / ||P(b - K u_d)|| on the
    free dofs P, with u_d the boundary values)."""
    mesh = FEMMesh(*generators.grid_tri(n, n), degree=deg)
    sim = ElasticitySimulator(mesh, Material.isotropic(2, E_YOUNG, nu),
                              device=device)
    ue = np.apply_along_axis(exact, 1, mesh.node_positions)
    sim.fix_nodes(mesh.bdry_nodes, ue[mesh.bdry_nodes])
    ue_t = torch.as_tensor(ue, device=sim.device)
    # Galerkin projection of the exact field: load = K u_exact
    b = sim.apply_K(ue_t)
    u, _ = sim.solve(extra_load=b, tol=tol)
    d = u - ue_t
    err = float(np.sqrt(max(float(torch.vdot(d.reshape(-1),
                                             sim.apply_K(d).reshape(-1))),
                            0.0)))
    diag = sim.K_diagonal().cpu().numpy()
    cond = float(diag.max() / max(diag[diag > 0].min(), 1e-30))
    free = torch.as_tensor(~sim.dirichlet_mask, device=sim.device)
    u_d = torch.where(free, torch.zeros_like(ue_t), ue_t)
    relres = float(torch.linalg.norm((b - sim.apply_K(u)) * free)
                   / torch.linalg.norm((b - sim.apply_K(u_d)) * free))
    return err, cond, relres


def convergence(max_n: int = 32, nus=(0.3, 0.45, 0.49), degrees=(1, 2),
                device=None):
    """{nu: [(n, degree, error, rate, cond, relres)]} for n = 4, 8, ...
    <= ``max_n``; the rate as in ``laplace_convergence``."""
    out = {}
    for nu in nus:
        rows = out[nu] = []
        for deg in degrees:
            prev = None
            n = 4
            while n <= max_n:
                err, cond, relres = solve_level(n, deg, nu, device)
                rate = np.log2(prev / err) if prev else float("nan")
                rows.append((n, deg, err, rate, cond, relres))
                prev = err
                n *= 2
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as --device cpu)")
    ap.add_argument("--nu", type=float, nargs="+",
                    default=[0.3, 0.45, 0.49])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    out = {}
    for nu in args.nu:
        print(f"--- nu = {nu} (plane stress) ---")
        print(f"{'n':>5} {'deg':>4} {'H1-seminorm err':>16} {'rate':>6} "
              f"{'cond est':>12}")
        rows = convergence(args.max, (nu,), device=device)[nu]
        out[nu] = rows
        for n, deg, err, rate, cond, _ in rows:
            print(f"{n:>5} {deg:>4} {err:>16.6e} {rate:>6.2f} "
                  f"{cond:>12.3e}")
        stalled = [(n, deg, r) for n, deg, _, _, _, r in rows if r > TOL]
        if stalled:
            print("refinement stopped above tol "
                  f"{TOL:g}: " + ", ".join(f"n={n} P{deg} relres {r:.3e}"
                                           for n, deg, r in stalled))
        print()
    return out


if __name__ == "__main__":
    main()
