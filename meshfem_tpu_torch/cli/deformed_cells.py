"""Deformed-cell homogenization CLI (counterpart of
``meshfem_tpu/cli/deformed_cells.py``; parity with ``DeformedCells_cli.cc``):

    python -m meshfem_tpu_torch.cli.deformed_cells cell.msh -m base.material \\
        --jacobian 1 0 0 1 [--transformVersion] [--degree 2] [--device cuda]
    echo "1 0 0 1\\n1 0.1 0 1" | python -m meshfem_tpu_torch.cli.deformed_cells \\
        cell.msh -m base.material --parametrizedTransform

``--jacobian`` takes dim*dim row-major entries; ``--parametrizedTransform``
reads one jacobian per stdin line and prints one moduli line each.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _report(res):
    Ch = res.Ch.cpu().numpy()
    moduli = [float(x) for x in res.tensor.get_orthotropic_parameters()]
    print("Ch:", " ".join(f"{x:.8g}" for x in Ch[np.triu_indices(len(Ch))]))
    print("moduli:", " ".join(f"{x:.8g}" for x in moduli))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mesh")
    ap.add_argument("-m", "--material", required=True)
    ap.add_argument("-d", "--degree", type=int, default=2)
    ap.add_argument("--jacobian", type=float, nargs="+", default=None)
    ap.add_argument("--transformVersion", action="store_true")
    ap.add_argument("--parametrizedTransform", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..analysis.deformed_cells import homogenize_deformed
    from ..io import meshio
    from ..mesh import FEMMesh
    from ..physics import load_material

    V, F = meshio.load(args.mesh)
    dim = F.shape[1] - 1
    if dim == 2:
        V = V[:, :2]
    mesh = FEMMesh(V, F, degree=args.degree)
    mat = load_material(args.material)

    def run(jac_flat):
        J = np.asarray(jac_flat, dtype=float).reshape(dim, dim)
        _report(homogenize_deformed(mesh, mat, J,
                                    transform_version=args.transformVersion,
                                    tol=args.tol, device=args.device))

    if args.parametrizedTransform:
        for line in sys.stdin:
            vals = [float(x) for x in line.split()]
            if vals:
                run(vals)
                sys.stdout.flush()
    else:
        run(args.jacobian if args.jacobian is not None
            else np.eye(dim).ravel())


if __name__ == "__main__":
    main()
