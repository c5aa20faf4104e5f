"""3D cantilever bend, the canonical Simulate_cli workload (counterpart of
``examples/cantilever.py``).

Clamp one face of a P2 tet bar, press the opposite face down, solve, and
report the tip deflection and the von Mises range.  ``solve`` picks the
operator for the mesh (structured multigrid on box grids, the routed
operator in float64 refinement on large unstructured meshes on the card,
the EBE operator otherwise).

Run: python -m meshfem_tpu_torch.examples.cantilever [nx ny nz]
     [--device cpu]
"""

import argparse

import numpy as np
import torch

from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dims", nargs="*", type=int,
                    help="nx ny nz (default 24 6 6)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    nx, ny, nz = args.dims[:3] if len(args.dims) > 2 else (24, 6, 6)
    V, T = generators.grid_tet(nx, ny, nz, hi=(4.0, 1.0, 1.0))
    mesh = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device=args.device)

    X = np.asarray(mesh.node_positions)
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))          # clamp x = 0
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > 4.0 - 1e-9, 2] = -0.05                   # press the tip
    sim.neumann_load = torch.as_tensor(load, device=sim.device)

    u, info = sim.solve(tol=1e-10)
    vm = sim.von_mises_field(u)
    tip = torch.as_tensor(X[:, 0] > 4.0 - 1e-9, device=u.device)
    print(f"dofs={mesh.num_nodes * 3}  solver iters={int(info.iters)}  "
          f"relres={float(info.resnorm):.2e}")
    print(f"tip deflection (mean u_z at x=4): "
          f"{float(u[tip, 2].mean()):+.6f}")
    print(f"von Mises: min={float(vm.min()):.4f} max={float(vm.max()):.4f}")


if __name__ == "__main__":
    main()
