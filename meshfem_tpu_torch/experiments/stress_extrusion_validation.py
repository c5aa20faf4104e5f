"""Stress-extrusion validation: full stress-distribution curves
(counterpart of ``experiments/stress_extrusion_validation.py``).

On the machinery of :mod:`extrusion_validation` (its stand-in mesh,
boundary conditions and material unless given others), each thickness's
3D von Mises field is reduced to a distribution curve (cumulative
element-volume fraction against the sorted per-element stress) and
compared with the 2D plane-stress curve by the relative L2 distance on a
common volume-fraction grid.  Asserted outcomes:

  1. the thin extrusion's curve matches the 2D curve (distance < 5%);
  2. the distance grows with thickness (the thickest above the thinnest);
  3. mesh stability: the thin extrusion with twice the layers gives the
     same curve (within 0.03).

Run: python -m meshfem_tpu_torch.experiments.stress_extrusion_validation
     [--thicknesses 0.25 1.0 2.0] [--degree 2] [--mesh M] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from meshfem_tpu_torch.experiments.extrusion_validation import (
    SAMPLE, SAMPLE_AREA, sample_path, solve_2d, solve_extruded)
from meshfem_tpu_torch.mesh.geometry import simplex_geometry


def distribution_curve(mesh, vm):
    """Per-element stresses sorted ascending, paired with the cumulative
    volume fraction.  Returns (cum_vol_fraction [E], sorted_stress
    [E])."""
    X = torch.as_tensor(np.asarray(mesh.node_positions)[
        np.asarray(mesh.elem_nodes)[:, : mesh.K + 1]])
    _, vol = simplex_geometry(X, mesh.K)
    vol = vol.abs().numpy()
    perm = np.argsort(vm)
    s = vm[perm]
    cum = np.cumsum(vol[perm])
    return cum / cum[-1], s


def curve_distance(c2, c3, lo=0.02, hi=0.98, n=512):
    """Relative L2 distance between two distribution curves on a common
    volume-fraction grid over the bulk [lo, hi] (the extreme tails carry
    mesh-dependent stress concentrations)."""
    grid = np.linspace(lo, hi, n)
    s2 = np.interp(grid, *c2)
    s3 = np.interp(grid, *c3)
    return float(np.linalg.norm(s3 - s2) / np.linalg.norm(s2))


def study(thicknesses=(0.25, 1.0, 2.0), degree=2, mesh_path=None,
          device=None):
    """The curve distances of each thickness and of the thinnest with
    twice its layers; raises where the reference asserts.  Returns
    (distances, the refined distance)."""
    mesh_path = sample_path(mesh_path)
    mesh2, _, _, vm2 = solve_2d(degree=degree, mesh_path=mesh_path,
                                device=device)
    curve2 = distribution_curve(mesh2, vm2)

    dists = []
    for t in thicknesses:
        mesh3, _, _, vm3, layers = solve_extruded(
            t, degree=degree, mesh_path=mesh_path, device=device)
        # the fixed total force spreads over a face growing with t: the 3D
        # stresses carry an exact 1/t against the 2D unit depth
        d = curve_distance(curve2, distribution_curve(mesh3, t * vm3))
        dists.append(d)
        print(f"t={t:<5} layers={layers:<2} elems={mesh3.num_elements:<8} "
              f"curve_L2={d:.4f}", flush=True)

    # mesh stability: the thinnest extrusion with twice the layers
    t0 = thicknesses[0]
    mesh3r, _, _, vm3r, _ = solve_extruded(
        t0, degree=degree, layers=2 * max(1, int(round(t0 / 0.25))),
        mesh_path=mesh_path, device=device)
    d_ref = curve_distance(distribution_curve(mesh3r, t0 * vm3r), curve2)
    print(f"t={t0} x2-layers curve_L2={d_ref:.4f}", flush=True)

    # 1. the thin extrusion matches plane stress
    assert dists[0] < 0.05, dists
    # 2. thicker extrusions drift
    assert dists[-1] > dists[0], dists
    # 3. refinement stability
    assert abs(d_ref - dists[0]) < 0.03, (d_ref, dists[0])
    return dists, d_ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--thicknesses", type=float, nargs="+",
                    default=[0.25, 1.0, 2.0])
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--mesh", default=None,
                    help="2D mesh (default: write the stand-in)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.mesh is None:
        print(f"no mesh given: writing {os.path.abspath(SAMPLE)} (the "
              f"stand-in domain, target area {SAMPLE_AREA:g})")
    out = study(tuple(args.thicknesses), args.degree, args.mesh,
                args.device)
    print("stress_extrusion_validation OK")
    return out


if __name__ == "__main__":
    main()
