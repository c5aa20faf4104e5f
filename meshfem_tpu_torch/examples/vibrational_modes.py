"""Vibrational modes of a ball (counterpart of
``examples/vibrational_modes.py``, BASELINE config 5).

The smallest nonzero eigenpairs of K x = lambda M x with the six rigid
modes deflated, by generalized LOBPCG over matrix-free multi-column
operators; an HTML viewer animating the first mode shape is written to
``ball_modes.html`` in the working directory.

The reference reads its ball from a mesh collection outside this
repository.  Given no mesh, this example writes ``ball.msh`` into the
working directory first: the ``grid_tet(24)`` tets of the unit cube whose
centroids lie inside the inscribed sphere, without dangling vertices.

Run: python -m meshfem_tpu_torch.examples.vibrational_modes [mesh.msh]
     [n_modes] [--device cpu]
"""

import argparse

import numpy as np

from meshfem_tpu_torch import vis
from meshfem_tpu_torch.analysis.modes import compute_vibrational_modes
from meshfem_tpu_torch.io import meshio
from meshfem_tpu_torch.mesh import FEMMesh, filters, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material


def write_ball(path, n: int = 24) -> None:
    """The tets of ``grid_tet(n)`` whose centroids lie inside the sphere
    inscribed in the unit cube, as an MSH file."""
    V, T = generators.grid_tet(n, n, n)
    inside = np.linalg.norm(V[T].mean(axis=1) - 0.5, axis=1) < 0.5
    meshio.save(path, *filters.remove_dangling_vertices(V, T[inside]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh", nargs="?", default=None)
    ap.add_argument("n_modes", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    path = args.mesh
    if path is None:
        path = "ball.msh"
        write_ball(path)
        print(f"no mesh given: wrote {path} (grid_tet(24) tets inside the "
              f"inscribed sphere)")

    V, T = meshio.load(path)
    mesh = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.35),
                              device=args.device)

    lam, modes = compute_vibrational_modes(sim, n_modes=args.n_modes)
    print("smallest nonzero eigenvalues:", np.array_str(np.asarray(lam),
                                                        precision=6))
    out = "ball_modes.html"
    mode0 = modes[:, :, 0].cpu().numpy()[mesh.vertex_nodes]  # vertex part
    vis.write_html_viewer(out, mesh, mode=mode0, scale=0.3)
    print(f"wrote {out} (open in a browser; animates the first mode shape)")


if __name__ == "__main__":
    main()
