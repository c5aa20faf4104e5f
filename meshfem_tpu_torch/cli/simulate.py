"""Linear elasticity simulation CLI (counterpart of
``meshfem_tpu/cli/simulate.py``; parity with ``Simulate_cli.cc``):

    python -m meshfem_tpu_torch.cli.simulate mesh.msh -m material.material \\
        -b conditions.bc -o out.msh [--degree 2] [--dumpMatrix K.txt] \\
        [--device cuda]

Outputs u, strain, stress, von Mises (and the load) as MSH fields.
``--precond amg`` runs on the routed operator (``--operator routed``, or
``auto`` on CUDA past ``MESHFEM_ROUTED_MIN_E`` elements).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh")
    ap.add_argument("-m", "--material", required=True,
                    help=".material JSON file")
    ap.add_argument("-b", "--boundaryConditions", required=True,
                    help=".bc JSON file")
    ap.add_argument("-o", "--outputMSH", default=None)
    ap.add_argument("-d", "--degree", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "block", "chebyshev", "twolevel",
                             "twolevel-mult", "amg"])
    ap.add_argument("--operator", default="auto",
                    choices=["auto", "structured", "routed", "ebe"],
                    help="auto picks structured multigrid on Kuhn grids, "
                         "routed SpMV on large meshes (CUDA), EBE otherwise")
    ap.add_argument("--dumpMatrix", default=None,
                    help="write assembled stiffness triplets (text)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..io import meshio
    from ..mesh import FEMMesh
    from ..physics import ElasticitySimulator, load_bc, load_material

    V, F = meshio.load(args.mesh)
    K = F.shape[1] - 1
    if K == 2:
        V = V[:, :2]
    mesh = FEMMesh(V, F, degree=args.degree)
    mat = load_material(args.material, dim=mesh.dim)
    sim = ElasticitySimulator(mesh, mat, device=args.device)
    bc = load_bc(args.boundaryConditions, dim=mesh.dim)
    sim.apply_boundary_conditions(bc)

    if args.dumpMatrix:
        A = sim.to_scipy().tocoo()
        with open(args.dumpMatrix, "w") as f:
            f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
            for i, j, v in zip(A.row, A.col, A.data):
                f.write(f"{i} {j} {v:.17g}\n")

    u, res = sim.solve(tol=args.tol, precond=args.precond,
                       operator=args.operator)
    print(f"solved: {int(res.iters)} CG iterations, "
          f"residual {float(res.resnorm):.3e}")
    u_host = u.cpu().numpy()
    vm = sim.von_mises_field(u).cpu().numpy()
    print(f"max |u| = {float(np.abs(u_host).max()):.6g}")
    print(f"max von Mises = {float(vm.max()):.6g}")

    if args.outputMSH:
        meshio.save_msh(
            args.outputMSH, mesh.node_positions, mesh.elem_nodes,
            fields=[
                {"name": "u", "data": u_host, "where": "node",
                 "kind": "vector"},
                {"name": "load", "data": sim.neumann_load.cpu().numpy(),
                 "where": "node", "kind": "vector"},
                {"name": "strain",
                 "data": sim.average_strain_field(u).cpu().numpy(),
                 "where": "element", "kind": "smatrix"},
                {"name": "stress",
                 "data": sim.average_stress_field(u).cpu().numpy(),
                 "where": "element", "kind": "smatrix"},
                {"name": "von_mises", "data": vm, "where": "element",
                 "kind": "scalar"},
            ])
        print(f"wrote {args.outputMSH}")


if __name__ == "__main__":
    main()
