"""Extrusion validation suite: 2D plane stress against thin 3D extrusions
(counterpart of ``experiments/extrusion_validation.py``).

A 2D domain is solved in plane stress under opposing compression forces
with ``no_rigid_motion``; extruded copies (``mesh.filters.extrude``, the
conforming prism split) at several thicknesses are solved in 3D under the
same forces on their extruded faces.  Asserted outcomes:

  1. the mid-plane 3D displacement converges to the 2D plane-stress field
     as the thickness goes to 0: the thinnest extrusion agrees to 5%, and
     closer than the thickest;
  2. the von Mises median over the mid-layer elements agrees likewise
     (the stress_extrusion_validation criterion).

The reference reads its mesh (``sample_poisson.msh``), two ``.bc`` files
and a material file from a collection outside this repository.  The
port's functions take the mesh path, the boundary conditions and the
material as arguments, and their defaults are the port's own STAND-INS;
nothing here claims to equal the reference's files:

* the mesh: given no path, :func:`write_sample` writes
  ``sample_poisson.msh`` into the working directory, the rectangle
  [0, 4] x [0, 2] with three round holes (24-gons) meshed by
  ``triangulate_pslg`` at a target area of 2e-3 (5,446 triangles; the
  6-layer extrusion has 98,028 tets);
* the boundary conditions :data:`BC2` and :data:`BC3`: the ``.bc`` form
  ``parse_bc`` reads, a total force of 100 pushing on the x = min edge
  (face) and its opposite on the x = max one, with ``no_rigid_motion``,
  as the reference's docstring describes its files;
* the material :data:`MAT`: isotropic, Young's modulus 2000, Poisson
  ratio 0.3.

Run: python -m meshfem_tpu_torch.experiments.extrusion_validation
     [--thicknesses 0.25 1.0 3.0] [--degree 2] [--mesh M] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from meshfem_tpu_torch.io import meshio
from meshfem_tpu_torch.mesh import FEMMesh, filters
from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
from meshfem_tpu_torch.physics import ElasticitySimulator, Material, parse_bc

SAMPLE = "sample_poisson.msh"
SAMPLE_SIZE = (4.0, 2.0)
SAMPLE_HOLES = ((1.0, 1.2, 0.35), (2.2, 0.7, 0.3), (3.1, 1.35, 0.25))
SAMPLE_AREA = 2e-3


def _box(lo, hi):
    return {"box%": {"minCorner": list(lo), "maxCorner": list(hi)}}


# stand-in boundary conditions: opposing total forces on the two x ends
BC2 = {"no_rigid_motion": True, "regions": [
    {"type": "force", "value": [100.0, 0.0],
     **_box((-0.001, -0.001), (0.001, 1.001))},
    {"type": "force", "value": [-100.0, 0.0],
     **_box((0.999, -0.001), (1.001, 1.001))}]}
BC3 = {"no_rigid_motion": True, "regions": [
    {"type": "force", "value": [100.0, 0.0, 0.0],
     **_box((-0.001, -0.001, -0.001), (0.001, 1.001, 1.001))},
    {"type": "force", "value": [-100.0, 0.0, 0.0],
     **_box((0.999, -0.001, -0.001), (1.001, 1.001, 1.001))}]}
# stand-in material
MAT = {"type": "isotropic_material", "dim": 2, "young": 2000.0,
       "poisson": 0.3}


def write_sample(path, target_area: float = SAMPLE_AREA) -> None:
    """The stand-in 2D domain (see the module's docstring) as an MSH
    file."""
    w, h = SAMPLE_SIZE
    outline = np.array([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]])
    th = 2.0 * np.pi * np.arange(24) / 24
    holes = [np.column_stack([cx + r * np.cos(th), cy + r * np.sin(th)])
             for cx, cy, r in SAMPLE_HOLES]
    V, F = triangulate_pslg(outline, holes=holes, target_area=target_area)
    meshio.save(path, V, F)


def sample_path(mesh_path=None):
    """``mesh_path``, or the stand-in written to ``sample_poisson.msh`` in
    the working directory when None."""
    if mesh_path is None:
        mesh_path = SAMPLE
        write_sample(mesh_path)
    return mesh_path


def solve_2d(degree=2, tol=1e-10, mesh_path=None, bc=BC2, material=MAT,
             device=None):
    """Plane stress on the 2D mesh; returns (mesh, simulator, u [N, 2]
    numpy, von Mises [E] numpy)."""
    V, F = meshio.load(sample_path(mesh_path))
    mesh = FEMMesh(V[:, :2], F, degree=degree)
    sim = ElasticitySimulator(
        mesh, Material.isotropic(2, material["young"], material["poisson"]),
        device=device)
    sim.apply_boundary_conditions(parse_bc(json.dumps(bc), dim=2))
    u, _ = sim.solve(tol=tol)
    vm = sim.von_mises_field(u).cpu().numpy()
    return mesh, sim, u.cpu().numpy(), vm


def solve_extruded(thickness, degree=2, tol=1e-9, layers=None,
                   mesh_path=None, bc=BC3, material=MAT, device=None):
    """The 2D mesh extruded to ``thickness`` in ``layers`` layers (one per
    0.25 of thickness, at most 6, when None), solved in 3D; returns (mesh,
    simulator, u [N, 3] numpy, von Mises [E] numpy, layers)."""
    V, F = meshio.load(sample_path(mesh_path))
    if layers is None:
        layers = min(6, max(1, int(round(thickness / 0.25))))
    V3, T3 = filters.extrude(V[:, :2], F, height=thickness, layers=layers)
    mesh = FEMMesh(V3, T3, degree=degree)
    sim = ElasticitySimulator(
        mesh, Material.isotropic(3, material["young"], material["poisson"]),
        device=device)
    sim.apply_boundary_conditions(parse_bc(json.dumps(bc), dim=3))
    u, _ = sim.solve(tol=tol)
    vm = sim.von_mises_field(u).cpu().numpy()
    return mesh, sim, u.cpu().numpy(), vm, layers


def compare(thicknesses=(0.25, 1.0, 3.0), degree=2, mesh_path=None,
            device=None):
    """For each thickness: the mid-plane displacement gap to the 2D field
    and the mid-layer von Mises median and p90 gaps, each relative.
    Returns a list of dicts (thickness, layers, dofs, disp_err,
    vm_med_err, vm_p90_err)."""
    mesh_path = sample_path(mesh_path)
    mesh2, _, u2, vm2 = solve_2d(degree=degree, mesh_path=mesh_path,
                                 device=device)
    n2v = mesh2.num_vertices
    v2 = np.asarray(mesh2.vertex_nodes)                 # vertex -> node
    X = np.asarray(mesh2.node_positions)[v2]
    Xc = X - X.mean(axis=0)
    perp = np.column_stack([-Xc[:, 1], Xc[:, 0]])
    results = []
    for t in thicknesses:
        mesh3, _, u3, vm3, layers = solve_extruded(
            t, degree=degree, mesh_path=mesh_path, device=device)
        # the extrusion stacks the 2D vertices layer by layer (vertex i of
        # layer L is vertex i + L n2v); P2 edge nodes differ, so compare
        # on vertex nodes, in the middle layer
        mid = layers // 2
        v3 = np.asarray(mesh3.vertex_nodes)[mid * n2v:(mid + 1) * n2v]
        d2 = u2[v2]
        # the .bc applies a fixed TOTAL force, spread over a face whose
        # area grows with the thickness: the linear 3D fields carry an
        # exact 1/t against the 2D run's unit depth, so scale by t
        d3 = t * u3[v3][:, :2]
        vm3 = t * vm3
        # a common gauge: remove each field's mean translation and its
        # best-fit in-plane infinitesimal rotation about the centroid
        for d in (d2, d3):
            d -= d.mean(axis=0)
            d -= (perp * d).sum() / (perp * perp).sum() * perp
        disp_err = np.abs(d3 - d2).max() / np.abs(d2).max()
        # the stress distribution on the mid layer (elements whose
        # centroid is nearest the mid-plane): quantiles
        cz = np.asarray(mesh3.barycenters())[:, 2]
        band = np.abs(cz - t / 2.0) < t / (2.0 * layers)
        q = lambda v, p: float(np.quantile(v, p))
        vm_med_err = abs(q(vm3[band], 0.5) - q(vm2, 0.5)) / q(vm2, 0.5)
        vm_p90_err = abs(q(vm3[band], 0.9) - q(vm2, 0.9)) / q(vm2, 0.9)
        results.append(dict(thickness=t, layers=layers,
                            dofs=mesh3.num_nodes * 3, disp_err=disp_err,
                            vm_med_err=vm_med_err, vm_p90_err=vm_p90_err))
        print(f"t={t:<5} layers={layers:<2} dofs={mesh3.num_nodes * 3:<8} "
              f"disp_err={disp_err:.4f} vm_med_err={vm_med_err:.4f} "
              f"vm_p90_err={vm_p90_err:.4f}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--thicknesses", type=float, nargs="+",
                    default=[0.25, 1.0, 3.0])
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--mesh", default=None,
                    help="2D mesh (default: write the stand-in)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.mesh is None:
        print(f"no mesh given: writing {os.path.abspath(SAMPLE)} (the "
              f"stand-in domain, target area {SAMPLE_AREA:g})")
    res = compare(tuple(args.thicknesses), degree=args.degree,
                  mesh_path=args.mesh, device=args.device)
    thin, thick = res[0], res[-1]
    # plane-stress convergence: the thin extrusion is close to 2D, and
    # closer than the thick one
    assert thin["disp_err"] < 0.05, thin
    assert thin["vm_med_err"] < 0.05, thin
    if len(res) > 1 and thick["thickness"] > thin["thickness"]:
        assert thin["disp_err"] <= thick["disp_err"] + 1e-9, (thin, thick)
    print("extrusion_validation OK")
    return res


if __name__ == "__main__":
    main()
