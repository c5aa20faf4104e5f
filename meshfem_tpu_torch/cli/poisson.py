"""Poisson solve CLI (counterpart of ``meshfem_tpu/cli/poisson.py``;
parity with ``Poisson_cli.cc``):

    python -m meshfem_tpu_torch.cli.poisson mesh.off -b dirichlet.bc \\
        -o out.msh [--degree 2] [--device cuda]

Dirichlet regions come from the .bc file (value[0] is the scalar field).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh")
    ap.add_argument("-b", "--boundaryConditions", required=True)
    ap.add_argument("-o", "--outputMSH", default=None)
    ap.add_argument("-d", "--degree", type=int, default=1)
    ap.add_argument("--tol", type=float, default=1e-12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..io import meshio
    from ..mesh import FEMMesh
    from ..physics import PoissonProblem, load_bc
    from ..physics.boundary_conditions import match_boundary_nodes
    from ..utils.expressions import evaluate

    V, F = meshio.load(args.mesh)
    if F.shape[1] == 3 and np.allclose(V[:, 2], 0):
        V = V[:, :2]
    mesh = FEMMesh(V, F, degree=args.degree)
    bc = load_bc(args.boundaryConditions, dim=mesh.dim)
    prob = PoissonProblem(mesh, device=args.device)

    nodes_all, vals_all = [], []
    for region in bc.regions:
        if region.type != "dirichlet":
            continue
        nodes = match_boundary_nodes(mesh, region)
        nodes_all.append(nodes)
        vals_all.append(evaluate(region.value[0], mesh.node_positions[nodes]))
    u, res = prob.solve(np.concatenate(nodes_all), np.concatenate(vals_all),
                        tol=args.tol)
    u_host = u.cpu().numpy()
    print(f"solved: {int(res.iters)} iterations, "
          f"residual {float(res.resnorm):.3e}")
    print(f"u range: [{float(np.min(u_host)):.6g}, "
          f"{float(np.max(u_host)):.6g}]")
    if args.outputMSH:
        g = prob.gradient(u).cpu().numpy()
        meshio.save_msh(args.outputMSH, mesh.node_positions,
                        mesh.elem_nodes, fields=[
                            {"name": "u", "data": u_host,
                             "where": "node", "kind": "scalar"},
                            {"name": "grad_u", "data": g,
                             "where": "element", "kind": "vector"},
                        ])
        print(f"wrote {args.outputMSH}")


if __name__ == "__main__":
    main()
