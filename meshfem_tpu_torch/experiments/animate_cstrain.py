"""Constant-macroscopic-strain (cstrain) cell animation (counterpart of
``experiments/animate_cstrain.py``).

The fluctuation fields of a periodic cell with a circular hole come from
the periodic cell solver (``analysis.homogenization``); the microscopic
displacement under the macro strain ``e`` is u(x) = e x + sum_i c_i w_i
(:func:`~meshfem_tpu_torch.analysis.homogenization.probe`).  The module
writes the self-contained WebGL viewer (``vis.write_html_viewer``, a sine
animation) of the microstructure cell and of the homogenized square, and
optionally PNG frames (``vis.save_mesh_png``, which needs matplotlib).

Asserted outcomes: the homogenized tensor is symmetric, positive definite
and below the Voigt bound (volume fraction times the base material); and
Hill's condition: the cell's microscopic elastic energy under ``e``, from
quadrature-point strains, equals 1/2 e : Ch : e to 1e-6.

Run: python -m meshfem_tpu_torch.experiments.animate_cstrain
     [--out DIR] [--area 2e-3] [--frames 24] [--png-frames 0]
     [--device cpu]
(``--out`` defaults to ``cstrain`` under the system's temporary
directory.)
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from meshfem_tpu_torch import vis
from meshfem_tpu_torch.analysis.homogenization import (homogenize,
                                                       periodic_simulator,
                                                       probe)
from meshfem_tpu_torch.experiments.circular_sector_homog import (UNIT_CELL,
                                                                sector_hole)
from meshfem_tpu_torch.fem import quadrature
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.mesh.geometry import simplex_geometry
from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
from meshfem_tpu_torch.ops.element_matrices import element_strain_matrix
from meshfem_tpu_torch.physics import Material

MACRO_STRAIN = np.array([1.0, 0.0, 0.4])   # x stretch and some shear
DBL = np.array([1.0, 1.0, 2.0])            # flat shear doubler, 2D


def build_cell(area=2e-3, radius=0.3, degree=2):
    hole = sector_hole(radius=radius, nsubdiv=64)
    V, F = triangulate_pslg(UNIT_CELL, holes=[hole], target_area=area)
    return FEMMesh(V, F, degree=degree)


def cstrain_checks(mesh, Ch, sim, u_fluct, e=MACRO_STRAIN):
    """The two checks' numbers: (volume fraction, eigenvalues of
    S Ch S, eigenvalues of S (vol_frac D - Ch) S with S = sqrt(DBL), the
    microscopic energy from quadrature-point strains on the fluctuation's
    device, the homogenized energy 1/2 e : Ch : e).

    Flat conventions (``fem.flattening``): strains store raw tensor
    components, sigma_flat = D (DBL * eps_raw), and the flat double
    contraction is sigma . (DBL * eps)."""
    dev = u_fluct.device
    Xv = torch.as_tensor(np.asarray(mesh.node_positions)[
        np.asarray(mesh.elem_nodes)[:, : mesh.K + 1]])
    _, vol = simplex_geometry(Xv, mesh.K)
    vol = vol.abs().numpy()
    vol_frac = float(vol.sum())             # the base cell's volume is 1
    S = np.diag(np.sqrt(DBL))
    eigs = np.linalg.eigvalsh(S @ Ch @ S)
    D = sim.D.cpu().numpy()
    voigt = np.linalg.eigvalsh(S @ (vol_frac * D - Ch) @ S)

    # Hill's condition, exact at the discrete optimum when the energy is
    # integrated with quadrature-point strains (P2 strains vary inside an
    # element; element-average strains underestimate the quadratic energy)
    homog_energy = 0.5 * float((DBL * e) @ Ch @ (DBL * e))
    qp, qw = quadrature.rule_np(mesh.K, 2 * (mesh.degree - 1))
    B = element_strain_matrix(sim.geom.grad_lambda, mesh.degree, qp)
    u_el = u_fluct[torch.as_tensor(mesh.elem_nodes, device=dev)]
    eps_q = torch.einsum("eqanc,enc->eqa", B, u_el) \
        + torch.as_tensor(e, device=dev)[None, None]
    s = eps_q * torch.as_tensor(DBL, device=dev)                # DBL * eps
    sig = s @ sim.D.T                                           # sigma_flat
    dens = (sig * s).sum(-1) @ torch.as_tensor(qw, device=dev)  # [E]
    micro_energy = 0.5 * float((dens.cpu().numpy() * vol).sum())
    return vol_frac, eigs, voigt, micro_energy, homog_energy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "cstrain"))
    ap.add_argument("--area", type=float, default=2e-3)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--png-frames", type=int, default=0,
                    help="also render this many PNG stills per cell")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    mesh = build_cell(area=args.area)
    mat = Material.isotropic(2, 1.0, 0.3)
    res = homogenize(mesh, mat, tol=1e-10, base_cell_volume=1.0,
                     device=args.device)
    Ch = res.Ch.cpu().numpy()

    e = MACRO_STRAIN
    sim = periodic_simulator(mesh, mat, device=args.device)
    u_fluct, _ = probe(sim, res.w, e)
    X = np.asarray(mesh.node_positions)
    E = np.array([[e[0], e[2]], [e[2], e[1]]])
    u_total = X @ E.T + u_fluct.cpu().numpy()

    vol_frac, eigs, voigt, micro_energy, homog_energy = cstrain_checks(
        mesh, Ch, sim, u_fluct, e)
    # check 1: Ch symmetric, positive definite, below the Voigt bound (a
    # perforated cell is strictly softer than the volume-scaled material)
    assert np.abs(Ch - Ch.T).max() < 1e-8 * np.abs(Ch).max(), Ch
    print(f"vol_frac={vol_frac:.4f} Ch eigs {eigs} voigt-slack {voigt}")
    assert eigs.min() > 0, eigs
    assert voigt.min() > -1e-9, voigt
    # check 2 (Hill's condition)
    rel = abs(micro_energy - homog_energy) / abs(homog_energy)
    print(f"micro energy {micro_energy:.8f} vs homog {homog_energy:.8f} "
          f"(rel {rel:.2e})")
    assert rel < 1e-6, (micro_energy, homog_energy)

    # the microstructure cell (deformation with the fluctuation); the
    # viewer's geometry is vertex-based: restrict the P2 nodal field
    micro_html = os.path.join(args.out, "cell_cstrain.html")
    u_vtx = u_total[np.asarray(mesh.vertex_nodes)]
    vis.write_html_viewer(micro_html, mesh, mode=u_vtx,
                          n_frames=args.frames, scale=0.15,
                          title="cstrain: microstructure cell")
    # the homogenized square: the same macro strain, no fluctuation
    Vh, Fh = triangulate_pslg(UNIT_CELL, target_area=args.area * 4)
    hmesh = FEMMesh(Vh, Fh, degree=1)
    uh = np.asarray(hmesh.node_positions) @ E.T
    homog_html = os.path.join(args.out, "homogenized_cstrain.html")
    vis.write_html_viewer(homog_html, hmesh, mode=uh,
                          n_frames=args.frames, scale=0.15,
                          title="cstrain: homogenized cell")

    for path in (micro_html, homog_html):
        assert os.path.getsize(path) > 1000, path
    print(f"wrote {micro_html} and {homog_html}")

    if args.png_frames:
        for k in range(args.png_frames):
            amp = 0.15 * np.sin(2 * np.pi * k / args.png_frames) \
                / max(np.abs(u_total).max(), 1e-30)
            vis.save_mesh_png(
                os.path.join(args.out, f"frame_{k:03d}.png"),
                mesh, deformation=amp * u_total)
        print(f"wrote {args.png_frames} PNG frames")
    print("animate_cstrain OK")
    return dict(Ch=Ch, vol_frac=vol_frac, eigs=eigs, voigt=voigt,
                micro_energy=micro_energy, homog_energy=homog_energy)


if __name__ == "__main__":
    main()
