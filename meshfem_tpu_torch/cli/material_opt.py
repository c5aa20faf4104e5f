"""Material-field optimization CLI (counterpart of
``meshfem_tpu/cli/material_opt.py``; parity with
``MaterialOptimization_cli.cc``): fit per-element Young's moduli to target
boundary displacements.

    python -m meshfem_tpu_torch.cli.material_opt mesh.msh -b conditions.bc \\
        [--poisson 0.3] [--steps 50] [--lr 0.1] [-o fitted.msh] \\
        [--device cuda]

``target`` regions in the .bc file define the displacement targets; the
other regions set up the forward problem.  ``--device`` (the CUDA device
by default) is the port's; the reference's CLI takes none.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh")
    ap.add_argument("-b", "--boundaryConditions", required=True)
    ap.add_argument("--poisson", type=float, default=0.3)
    ap.add_argument("--young0", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--bounds", type=float, nargs=2, default=(0.1, 10.0))
    ap.add_argument("-o", "--outputMSH", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from ..io import meshio
    from ..mesh import FEMMesh
    from ..physics import ElasticitySimulator, Material, load_bc
    from ..physics.boundary_conditions import (expression_env,
                                               match_boundary_nodes)
    from ..analysis.material_optimization import (
        MaterialOptimizationProblem, optimize)

    V, F = meshio.load(args.mesh)
    dim = F.shape[1] - 1
    if dim == 2:
        V = V[:, :2]
    mesh = FEMMesh(V, F, degree=1)
    bc = load_bc(args.boundaryConditions, dim=dim)

    # the forward problem's set-up through a scratch simulator
    sim = ElasticitySimulator(mesh, Material.isotropic(dim, args.young0,
                                                       args.poisson),
                              device=args.device)
    sim.apply_boundary_conditions(bc)
    env = expression_env(mesh)
    tnodes, tvals = [], []
    for region in bc.regions:
        if region.type == "target":
            nodes = match_boundary_nodes(mesh, region)
            tnodes.append(nodes)
            tvals.append(region.eval_value(mesh.node_positions[nodes],
                                           env)[:, :dim])
    if not tnodes:
        raise SystemExit("no 'target' regions in the .bc file")

    prob = MaterialOptimizationProblem(
        mesh, args.poisson, np.asarray(sim.dirichlet_mask),
        np.asarray(sim.dirichlet_values), sim.neumann_load,
        np.concatenate(tnodes), np.concatenate(tvals),
        bounds=tuple(args.bounds), device=sim.device)
    y0 = torch.full((mesh.num_elements,), args.young0, dtype=torch.float64,
                    device=sim.device)
    young, hist = optimize(prob, y0, steps=args.steps,
                           learning_rate=args.lr, verbose=True)
    print(f"objective: {hist[0]:.6e} -> {hist[-1]:.6e}")
    print(f"young range: [{float(young.min()):.4g}, "
          f"{float(young.max()):.4g}]")
    if args.outputMSH:
        meshio.save_msh(args.outputMSH, mesh.node_positions,
                        mesh.elem_nodes, fields=[
                            {"name": "young", "data": young.cpu().numpy(),
                             "where": "element", "kind": "scalar"}])
        print(f"wrote {args.outputMSH}")


if __name__ == "__main__":
    main()
