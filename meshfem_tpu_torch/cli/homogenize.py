"""Periodic homogenization CLI (counterpart of
``meshfem_tpu/cli/homogenize.py``; parity with
``PeriodicHomogenization_cli.cc``):

    python -m meshfem_tpu_torch.cli.homogenize cell.msh -m base.material \\
        [--degree 2] [--orthotropicCell] [-o fluctuations.msh] \\
        [--device cuda]

Prints the homogenized elasticity tensor, the orthotropic moduli and the
anisotropy (the relative distance to the closest isotropic tensor).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh")
    ap.add_argument("-m", "--material", required=True)
    ap.add_argument("-d", "--degree", type=int, default=2)
    ap.add_argument("--orthotropicCell", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--precond", default="block",
                    choices=["jacobi", "block", "chebyshev", "twolevel",
                             "twolevel-mult"],
                    help="cell-problem preconditioner (twolevel = "
                         "P1-coarse two-level, the high-contrast choice)")
    ap.add_argument("-o", "--outputMSH", default=None,
                    help="write fluctuation displacement/strain fields")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..analysis.homogenization import homogenize
    from ..fem.tensor_projection import isotropy_distance
    from ..io import meshio
    from ..mesh import FEMMesh
    from ..physics import load_material

    V, F = meshio.load(args.mesh)
    K = F.shape[1] - 1
    if K == 2:
        V = V[:, :2]
    mesh = FEMMesh(V, F, degree=args.degree)
    mat = load_material(args.material)
    res = homogenize(mesh, mat, orthotropic_cell=args.orthotropicCell,
                     tol=args.tol, precond=args.precond, device=args.device)
    Ch = res.Ch.cpu().numpy()
    print("Homogenized elasticity tensor:")
    for row in Ch:
        print("  " + "  ".join(f"{x:12.6g}" for x in row))
    moduli = [float(x) for x in res.tensor.get_orthotropic_parameters()]
    names2 = ["Ex", "Ey", "nu_yx", "mu_xy"]
    names3 = ["Ex", "Ey", "Ez", "nu_yx", "nu_zx", "nu_zy",
              "mu_yz", "mu_zx", "mu_xy"]
    for n, v in zip(names2 if mesh.dim == 2 else names3, moduli):
        print(f"{n} = {v:.8g}")
    print(f"anisotropy (rel. distance to isotropic) = "
          f"{float(isotropy_distance(res.Ch)):.6g}")
    print(f"CG iterations per cell problem: {res.cg_iters}")

    if args.outputMSH:
        fields = []
        for i in range(res.w.shape[0]):
            fields.append({"name": f"w_{i}", "data": res.w[i].cpu().numpy(),
                           "where": "node", "kind": "vector"})
            fields.append({"name": f"strain_w_{i}",
                           "data": res.strain_w[i].cpu().numpy(),
                           "where": "element", "kind": "smatrix"})
        meshio.save_msh(args.outputMSH, mesh.node_positions,
                        mesh.elem_nodes, fields=fields)
        print(f"wrote {args.outputMSH}")


if __name__ == "__main__":
    main()
