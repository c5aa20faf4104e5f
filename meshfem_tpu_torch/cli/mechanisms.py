"""Mechanisms CLIs (counterpart of ``meshfem_tpu/cli/mechanisms.py``;
parity with the reference's ``src/bin/mechanisms/``):

    python -m meshfem_tpu_torch.cli.mechanisms open NAME MESH [-m MAT]
        [-d DEG] [-s SPEED] [-n STEPS] [--outputFreq F] [-O]
        [--ignorePeriodicMismatch] [--device cuda]
    python -m meshfem_tpu_torch.cli.mechanisms optimize MESH [-m MAT]
        [-d DEG] [-n STEPS] [-o FIELDS.msh] [--device cuda]

``open`` (OpenLinkage.cc) opens a periodic linkage cell along its softest
eigenstrain step by step and writes ``{NAME}_minEigenvalue.txt``,
``{NAME}_openingStrain_ellipse.txt`` (ImageMagick draw commands,
``OpenLinkage.cc:228-238``), ``{NAME}open_it_{i}.msh`` every
``--outputFreq`` steps with the opening direction field, and a final
``opened.msh``; it prints the maximum relative edge-length change.
``optimize`` (OptimizeLinkage.cc) takes shape-derivative descent steps on
the softest mode's eigenstrain, writes ``vertical_linkage_it{i}.msh`` each
step, then prints the compliance tensor, the moduli, the Poisson ratios
and the anisotropy.  Both take the reference's flags and defaults, plus
``--device`` (the CUDA device by default).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def _load_mesh(path, degree):
    from ..io import meshio
    from ..mesh import FEMMesh

    V, F = meshio.load(path)
    if F.shape[1] == 3:
        V = V[:, :2]
    return FEMMesh(V, F, degree=degree)


def _material(args, dim):
    from ..fem import elasticity_tensor as et
    from ..physics import load_material

    if args.material:
        return load_material(args.material, dim=dim)
    return et.ElasticityTensor.isotropic(dim, 1.0, 0.3)


def _print_matrix(M):
    for row in M:
        print("  " + "  ".join(f"{x:16.10g}" for x in row))


def main_open(args):
    from ..analysis import mechanisms as mech
    from ..io import meshio

    mesh = _load_mesh(args.mesh, args.degree)
    if mesh.dim != 2:
        raise SystemExit("OpenLinkage supports triangle meshes only "
                         "(reference OpenLinkage.cc:271)")
    mat = _material(args, mesh.dim)
    name = args.name
    eig_lines, ellipse_lines = [], []

    def cb(it, m, step):
        eig_lines.append(f"{step.min_eigenvalue:.17g}")
        if it % args.outputFreq == 0:
            fields = [{"name": "opening direction",
                       "data": step.step_field / args.openingSpeed,
                       "where": "node", "kind": "vector"}]
            meshio.save_msh(f"{name}open_it_{it}.msh", m.V, m.F,
                            fields=fields)
            # the principal-strain ellipse (ImageMagick draw commands)
            s = step.opening_strain
            lam, Q = np.linalg.eigh(np.array([[s[0], s[2]], [s[2], s[1]]]))
            ps = Q * lam[None, :]
            theta = -math.atan2(ps[1, 0], ps[0, 0])
            w = 100 * np.linalg.norm(ps[:, 0])
            h = 100 * np.linalg.norm(ps[:, 1])
            ellipse_lines.append(
                "push graphic-context translate 100,100 rotate "
                f"{180 * theta / math.pi} fill purple stroke black "
                f"ellipse 0,0 {w},{h} 0,360 pop graphic-context")

    res = mech.open_linkage(mesh, mat, num_steps=args.numSteps,
                            opening_speed=args.openingSpeed,
                            orthotropic_cell=args.orthotropicCell,
                            permit_mismatch=args.ignorePeriodicMismatch,
                            callback=cb, device=args.device)
    with open(f"{name}_minEigenvalue.txt", "w") as f:
        f.write("\n".join(eig_lines) + "\n")
    with open(f"{name}_openingStrain_ellipse.txt", "w") as f:
        f.write("\n".join(ellipse_lines) + "\n")
    meshio.save_msh("opened.msh", res.vertices, mesh.F)
    print(f"Maximum relative edge length change: {res.max_rel_edge_change}")


def main_optimize(args):
    from ..analysis import mechanisms as mech
    from ..fem import elasticity_tensor as et
    from ..fem.tensor_projection import isotropy_distance
    from ..io import meshio

    mesh = _load_mesh(args.mesh, args.degree)
    mat = _material(args, mesh.dim)
    dim = mesh.dim

    def cb(it, m, step):
        print("Homogenized elasticity tensor:")
        _print_matrix(step.Eh)
        print(f"Minimum Eh eigenvalue {step.min_eigenvalue:.16g} "
              f"for eigenstrain: {step.opening_strain}")
        meshio.save_msh(f"vertical_linkage_it{it}.msh", m.V, m.F,
                        fields=[{"name": "descent step",
                                 "data": step.step_field, "where": "node",
                                 "kind": "vector"}])

    res = mech.optimize_linkage(mesh, mat, num_steps=args.numSteps,
                                step_size=0.01, callback=cb,
                                device=args.device)
    Eh = torch.as_tensor(res.Eh)
    S = et.ElasticityTensor(Eh).inverse().D.numpy()
    print("Homogenized compliance tensor:")
    _print_matrix(S)
    moduli = [(1.0 if i < dim else 0.25) / S[i, i] for i in range(len(S))]
    if dim == 2:
        print(f"Approximate Young moduli:\t{moduli[0]}\t{moduli[1]}")
        print(f"Approximate shear modulus:\t{moduli[2]}")
        print(f"v_yx, v_xy:\t{-S[0, 1] / S[1, 1]}\t{-S[1, 0] / S[0, 0]}")
    else:
        print(f"Approximate Young moduli:\t{moduli[0]}\t{moduli[1]}\t"
              f"{moduli[2]}")
        print(f"Approximate shear moduli:\t{moduli[3]}\t{moduli[4]}\t"
              f"{moduli[5]}")
    print(f"Anisotropy:\t{float(isotropy_distance(Eh))}")
    if args.fieldOutput:
        meshio.save_msh(args.fieldOutput, res.vertices, mesh.F)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    o = sub.add_parser("open", help="OpenLinkage")
    o.add_argument("name")
    o.add_argument("mesh")
    o.add_argument("-m", "--material", default=None)
    o.add_argument("-d", "--degree", type=int, default=1)
    o.add_argument("-s", "--openingSpeed", type=float, default=0.01)
    o.add_argument("-n", "--numSteps", type=int, default=20)
    o.add_argument("--outputFreq", type=int, default=100)
    o.add_argument("-O", "--orthotropicCell", action="store_true")
    o.add_argument("--ignorePeriodicMismatch", action="store_true")
    o.set_defaults(fn=main_open)

    p = sub.add_parser("optimize", help="OptimizeLinkage")
    p.add_argument("mesh")
    p.add_argument("-m", "--material", default=None)
    p.add_argument("-d", "--degree", type=int, default=2)
    p.add_argument("-n", "--numSteps", type=int, default=20)
    p.add_argument("-o", "--fieldOutput", default=None)
    p.set_defaults(fn=main_optimize)

    for sp in (o, p):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
