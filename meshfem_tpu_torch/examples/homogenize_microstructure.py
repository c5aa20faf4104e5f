"""Periodic homogenization of a 2D two-phase microstructure cell
(counterpart of ``examples/homogenize_microstructure.py``).

The effective elasticity tensor C^h of a two-phase (1000:1 contrast) cell
with periodic boundary conditions, by ONE multi-column block CG over all
cell problems with the P1-coarse two-level preconditioner.

The reference reads its cell from a mesh collection outside this
repository.  Given no mesh, this example writes ``2D_microstructure.msh``
into the working directory first: ``grid_tri(128)`` on [-1, 1]^2, which
the split at x = 0 makes two phases.

Run: python -m meshfem_tpu_torch.examples.homogenize_microstructure
     [mesh.msh] [--device cpu]
"""

import argparse

import numpy as np

from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.io import meshio
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics.materials import MaterialField


def write_cell(path, n: int = 128) -> None:
    """``grid_tri(n)`` on [-1, 1]^2 as an MSH file."""
    meshio.save(path, *generators.grid_tri(n, n, lo=(-1.0, -1.0),
                                           hi=(1.0, 1.0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    path = args.mesh
    if path is None:
        path = "2D_microstructure.msh"
        write_cell(path)
        print(f"no mesh given: wrote {path} (grid_tri(128) on [-1, 1]^2)")
    V, F = meshio.load(path)
    mesh = FEMMesh(V[:, :2], F, degree=2)

    c = np.asarray(mesh.V)[np.asarray(mesh.F)].mean(axis=1)
    E_field = np.where(c[:, 0] < 0.0, 1000.0, 1.0)       # stiff left phase
    mats = MaterialField.isotropic_field(2, E_field,
                                         np.full(len(E_field), 0.3))

    res = hom.homogenize(mesh, mats, tol=1e-11, precond="twolevel",
                         device=args.device)
    Ch = res.Ch.cpu().numpy()
    print(f"cell problems converged in {res.cg_iters[0]} block-CG "
          f"iterations")
    print("effective C^h:")
    print(np.array_str(Ch, precision=5, suppress_small=True))
    w = np.linalg.eigvalsh(Ch)
    print(f"SPD check: eigenvalues in [{w.min():.4g}, {w.max():.4g}]")


if __name__ == "__main__":
    main()
