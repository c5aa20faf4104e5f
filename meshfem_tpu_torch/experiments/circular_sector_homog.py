"""Circular-sector homogenization convergence study (counterpart of
``experiments/circular_sector_homog.py``).

A unit square with a p-norm circular hole, optionally with ``skip``
vertices cut around the start point so that the hole closes through the
centre in one REENTRANT corner, is meshed by Ruppert refinement
(``mesh.triangulate.triangulate_pslg``) at a halving sweep of target
areas and homogenized at each level (``analysis.homogenization.homogenize``,
block CG over the three cell problems).  Asserted outcomes:

  1. the homogenized tensor converges toward the finest level along the
     sweep (the first level's gap exceeds the last one's);
  2. the smooth hole converges no slower than the reentrant sector
     (within 0.5 of fit noise), and at least first order in h.

Run: python -m meshfem_tpu_torch.experiments.circular_sector_homog
     [--levels 4] [--base-area 2e-3] [--degree 2] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from meshfem_tpu_torch.analysis.homogenization import homogenize
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
from meshfem_tpu_torch.physics import Material

UNIT_CELL = 0.5 * np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)


def sector_hole(radius=0.3, nsubdiv=64, pnorm=2.0, skip=0):
    """Hole polygon: the p-norm circle of ``radius`` with ``skip``
    vertices removed on each side of the start vertex (angle 0); with
    ``skip`` > 0 the polygon closes through the centre, its one reentrant
    corner."""
    ks = np.arange(nsubdiv)
    keep = (ks > skip) & (ks < nsubdiv - skip) if skip else ks >= 0
    th = 2.0 * np.pi * ks[keep] / nsubdiv
    d = np.stack([np.cos(th), np.sin(th)], axis=1)
    scale = (np.abs(d) ** pnorm).sum(axis=1) ** (1.0 / pnorm)
    pts = radius * d / scale[:, None]
    if skip:
        pts = np.vstack([[0.0, 0.0], pts])
    return pts


def homogenize_sector(area, radius=0.3, skip=0, pnorm=2.0, degree=2,
                      nsubdiv=64, tol=1e-10, device=None):
    """(Ch [3, 3] numpy, node count) of the cell meshed at ``area``.  The
    square's sides are sampled uniformly, finely enough that Ruppert never
    splits them, so opposite sides match node for node (periodicity)."""
    h_b = 0.9 * np.sqrt(area)
    per_side = max(1, int(np.ceil(1.0 / h_b)))
    pts = []
    for s in range(4):
        a, b = UNIT_CELL[s], UNIT_CELL[(s + 1) % 4]
        for t in range(per_side):
            pts.append(a + (b - a) * (t / per_side))
    outline = np.asarray(pts)
    hole = sector_hole(radius=radius, nsubdiv=nsubdiv, pnorm=pnorm,
                       skip=skip)
    V, F = triangulate_pslg(outline, holes=[hole], target_area=area)
    mesh = FEMMesh(V, F, degree=degree)
    mat = Material.isotropic(2, 1.0, 0.3)
    res = homogenize(mesh, mat, tol=tol, base_cell_volume=1.0,
                     device=device)
    return res.Ch.cpu().numpy(), mesh.num_nodes


def sweep(levels=4, base_area=2e-3, skip=0, degree=2, **kw):
    """Homogenize along a halving area sweep; returns (areas, tensors,
    node counts)."""
    areas = [base_area * 0.5 ** i for i in range(levels)]
    Chs, dofs = [], []
    for a in areas:
        Ch, n = homogenize_sector(a, skip=skip, degree=degree, **kw)
        Chs.append(Ch)
        dofs.append(n)
        print(f"skip={skip} area={a:.2e} nodes={n:<7} "
              f"C1111={Ch[0, 0]:.8f} C1122={Ch[0, 1]:.8f} "
              f"C1212={Ch[2, 2]:.8f}", flush=True)
    return np.asarray(areas), np.asarray(Chs), dofs


def rate(areas, Chs):
    """Convergence rate p in ||Ch_i - Ch_ref|| ~ C h^p, h = sqrt(area),
    fitted over the levels before the finest against the finest."""
    errs = np.linalg.norm(Chs[:-1] - Chs[-1], axis=(1, 2))
    h = np.sqrt(areas[:-1])
    mask = errs > 1e-14
    if mask.sum() < 2:
        return np.inf, errs
    p = np.polyfit(np.log(h[mask]), np.log(errs[mask]), 1)[0]
    return float(p), errs


def study(levels=4, base_area=2e-3, degree=2, device=None):
    """Both sweeps (the smooth hole, and skip 12 of 64 vertices each way:
    the wedge cut) and their rates; raises where the reference asserts.
    Returns {"smooth": (p, errs), "sector": (p, errs)}."""
    a_s, C_s, _ = sweep(levels, base_area, skip=0, degree=degree,
                        device=device)
    p_smooth, errs_s = rate(a_s, C_s)
    a_r, C_r, _ = sweep(levels, base_area, skip=12, degree=degree,
                        device=device)
    p_sector, errs_r = rate(a_r, C_r)

    print(f"rate smooth={p_smooth:.2f}  errs={errs_s}")
    print(f"rate sector={p_sector:.2f}  errs={errs_r}")

    # 1. convergence toward the finest level
    assert errs_s[0] > errs_s[-1], errs_s
    assert errs_r[0] > errs_r[-1], errs_r
    # 2. the smooth hole converges no slower than the reentrant sector
    #    (the corner singularity caps the rate), within fit noise
    assert p_smooth >= p_sector - 0.5, (p_smooth, p_sector)
    # 3. the smooth hole's rate is at least first order in h
    assert p_smooth > 0.9, p_smooth
    return {"smooth": (p_smooth, errs_s), "sector": (p_sector, errs_r)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--base-area", type=float, default=2e-3)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    out = study(args.levels, args.base_area, args.degree, args.device)
    print("circular_sector_homog OK")
    return out


if __name__ == "__main__":
    main()
