"""SIMP compliance topology optimization of a 3D cantilever (counterpart
of ``examples/topology_optimization.py``).

Every state solve is a variable-material multigrid V-cycle PCG on the
device (``ops/structured_mg.VarStructuredMG``), the density filter a
convolution, and the compliance gradient the exact self-adjoint one (no
extra solve an iteration).

Run: python -m meshfem_tpu_torch.examples.topology_optimization
     [--nx 24 --ny 12 --nz 8] [--iters 20] [--volfrac 0.4]
     [--out $TMPDIR/topopt_rho.npy] [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from meshfem_tpu_torch.analysis.topopt import ComplianceTopOpt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=12)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--volfrac", type=float, default=0.4)
    ap.add_argument("--rmin", type=float, default=1.5)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "topopt_rho.npy"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    top = ComplianceTopOpt(args.nx, args.ny, args.nz,
                           volfrac=args.volfrac, rmin=args.rmin,
                           device=args.device)
    t0 = time.time()
    rho, hist = top.run(iters=args.iters, verbose=True)
    dt = time.time() - t0
    rho_f = top.filtered(rho).cpu().numpy()
    np.save(args.out, rho_f)
    c0, cN = hist[0]["compliance"], hist[-1]["compliance"]
    print(f"\n{args.iters} iterations in {dt:.1f}s "
          f"({dt / max(args.iters, 1):.2f}s/it incl. MG rebuild+solve)")
    print(f"compliance {c0:.4e} -> {cN:.4e} "
          f"({c0 / cN:.2f}x stiffer at volume "
          f"{hist[-1]['volume']:.3f})")
    print(f"density field saved to {args.out} "
          f"(shape {rho_f.shape}, solid fraction "
          f"{(rho_f > 0.5).mean():.3f})")
    if not cN < c0:
        raise AssertionError("optimization failed to reduce compliance")


if __name__ == "__main__":
    main()
