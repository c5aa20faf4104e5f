"""Voxel microstructure homogenization, the Elastic Textures workload
(counterpart of ``examples/homogenize_voxels.py``).

A cross-lattice unit cell as a boolean voxel array, homogenized through
the periodic torus multigrid.

Run: python -m meshfem_tpu_torch.examples.homogenize_voxels [n]
     [--device cpu]
"""

import argparse

import numpy as np

from meshfem_tpu_torch.analysis.homogenization import homogenize_voxels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    n = args.n
    lo, hi = n // 2 - max(n // 8, 1), n // 2 + max(n // 8, 1)
    occ = np.zeros((n, n, n), bool)
    occ[lo:hi, :, lo:hi] = True      # three orthogonal square struts
    occ[:, lo:hi, lo:hi] = True
    occ[lo:hi, lo:hi, :] = True

    res = homogenize_voxels(occ, E_solid=1.0, nu=0.3, device=args.device)
    Ch = res.Ch.cpu().numpy()
    print(f"volume fraction: {occ.mean():.3f}")
    print(f"cell problems converged in {res.cg_iters} V-cycle CG iterations")
    print("effective C^h:")
    print(np.array_str(Ch, precision=5, suppress_small=True))
    d = np.diag(Ch)
    print(f"cubic check: normal moduli spread "
          f"{abs(d[:3] - d[:3].mean()).max() / d[:3].mean():.2e}")


if __name__ == "__main__":
    main()
