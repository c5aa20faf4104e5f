"""Mesh conversion and filter pipeline CLI (counterpart of
``meshfem_tpu/cli/mesh_convert.py``; parity with ``mesh_convert.cc``
and its filter flags, ``mesh_convert.cc:56-90``), on the port's
``mesh.filters`` and ``io.meshio``.  Host only, so it takes no device:

    python -m meshfem_tpu_torch.cli.mesh_convert in.obj out.msh \\
        [--info] [--boundary] [--subdivide N] [--reflect [xyz]] \\
        [--extrude H] [--clean] [--reorient] [--keepLargestComponent] \\
        [--Sx s --Ty t ...] [--truncateElements N] \\
        [--quadAspectSubdiv --quadAspectThreshold a] \\
        [--quadSubdivideAndTriangulate N] [--quadTriangulateAsymmetric] \\
        [--sortVertices] [--sortElementCorners] [--sortElements] \\
        [--extraMesh other.msh] [--dumpDanglingVertices pts.obj] [--binary]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("-i", "--info", action="store_true")
    ap.add_argument("-b", "--boundary", action="store_true",
                    help="extract the boundary surface")
    ap.add_argument("--subdivide", type=int, default=0)
    ap.add_argument("-r", "--reflect", nargs="?", const="", default=None,
                    metavar="AXES",
                    help="reflect into 2^d tiling (optionally e.g. 'xy')")
    ap.add_argument("--extrude", type=float, default=None,
                    help="extrude 2D mesh to a tet mesh of this height")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--clean", action="store_true",
                    help="merge duplicate + remove dangling vertices")
    ap.add_argument("--reorient", "--reorientNegativeElements",
                    action="store_true")
    ap.add_argument("--keepLargestComponent", action="store_true")
    ap.add_argument("--truncateElements", type=int, default=None)
    for c in "xyz":
        ap.add_argument(f"--S{c}", type=float, default=None,
                        help=f"scale {c} (after translation)")
        ap.add_argument(f"--T{c}", type=float, default=None,
                        help=f"translate {c} (before scale)")
    ap.add_argument("-A", "--quadAspectSubdiv", action="store_true")
    ap.add_argument("-a", "--quadAspectThreshold", type=float, default=1.75)
    ap.add_argument("-q", "--quadSubdivideAndTriangulate", type=int,
                    default=None, metavar="ITERS")
    ap.add_argument("--quadTriangulateAsymmetric", action="store_true")
    ap.add_argument("--sortVertices", action="store_true")
    ap.add_argument("--sortElementCorners", action="store_true")
    ap.add_argument("--sortElements", action="store_true")
    ap.add_argument("--extraMesh", default=None)
    ap.add_argument("-D", "--dumpDanglingVertices", default=None)
    ap.add_argument("--binary", action="store_true", help="binary MSH")
    args = ap.parse_args(argv)

    from ..io import meshio
    from ..mesh import filters

    V, F = meshio.load(args.input)
    if F.shape[1] == 3 and V.shape[1] == 3 and np.allclose(V[:, 2], 0):
        V = V[:, :2]

    if args.extraMesh:
        V2, F2 = meshio.load(args.extraMesh)
        if V2.shape[1] != V.shape[1]:
            V2 = V2[:, :V.shape[1]]
        F = np.vstack([F, F2 + len(V)])
        V = np.vstack([V, V2])

    # translate then scale, per axis (mesh_convert.cc Sx/Tx semantics)
    V = np.asarray(V, dtype=np.float64).copy()
    for c, axis in zip("xyz", range(V.shape[1])):
        t = getattr(args, f"T{c}")
        if t is not None:
            V[:, axis] += t
    for c, axis in zip("xyz", range(V.shape[1])):
        s = getattr(args, f"S{c}")
        if s is not None:
            V[:, axis] *= s

    if args.truncateElements is not None:
        F = F[:args.truncateElements]
    if args.clean:
        V, F = filters.merge_duplicate_vertices(V, F, eps=1e-12)
        V, F = filters.remove_dangling_vertices(V, F)
    if args.keepLargestComponent:
        V, F = filters.remove_small_components(V, F)
    if args.reorient:
        V, F = filters.reorient_negative_elements(V, F)

    if args.quadAspectSubdiv and F.shape[1] == 4:
        did = True
        qi = None
        while did:
            V, F, qi, did = filters.quad_subdiv_high_aspect(
                V, F, args.quadAspectThreshold, qi)
    if args.quadSubdivideAndTriangulate is not None and F.shape[1] == 4:
        qi = None
        for _ in range(args.quadSubdivideAndTriangulate):
            V, F, qi = filters.quad_subdiv(V, F, qi)
        V, F, qi = filters.quad_tri_subdiv(V, F, qi)
    elif args.quadTriangulateAsymmetric and F.shape[1] == 4:
        V, F, _ = filters.quad_tri_subdiv_asymmetric(V, F)

    if args.subdivide:
        V, F = filters.subdivide(V, F, args.subdivide)
    if args.reflect is not None:
        axes = None if args.reflect == "" else \
            ["xyz".index(c) for c in args.reflect]
        V, F = filters.reflect(V, F, axes=axes)
    if args.extrude is not None:
        V, F = filters.extrude(V, F, args.extrude, args.layers)

    if args.boundary:
        from ..mesh import FEMMesh

        mesh = FEMMesh(V, F)
        bf = np.asarray(mesh.bdry_elems)
        V, F = filters.remove_dangling_vertices(V, bf)

    if args.sortVertices:
        order = np.lexsort(tuple(V[:, c] for c in
                                 range(V.shape[1] - 1, -1, -1)))
        rank = np.empty(len(V), dtype=np.int64)
        rank[order] = np.arange(len(V))
        V = V[order]
        F = rank[F]
    if args.sortElementCorners:
        F = np.sort(F, axis=1)
    if args.sortElements:
        F = F[np.lexsort(tuple(F[:, c] for c in
                               range(F.shape[1] - 1, -1, -1)))]

    if args.dumpDanglingVertices:
        used = np.unique(F)
        dangling = np.setdiff1d(np.arange(len(V)), used)
        with open(args.dumpDanglingVertices, "w") as f:
            for i in dangling:
                p = V[i]
                f.write(f"v {p[0]} {p[1]} "
                        f"{p[2] if len(p) > 2 else 0.0}\n")

    if args.info or args.output is None:
        bb_lo, bb_hi = V.min(axis=0), V.max(axis=0)
        print(f"{args.input}: {len(V)} vertices, {len(F)} elements "
              f"({F.shape[1]} nodes each)")
        print(f"bbox min {bb_lo} max {bb_hi}")
        if args.output is None:
            return

    if args.output.endswith(".msh") and args.binary:
        meshio.save_msh(args.output, V, F, binary=True)
    else:
        meshio.save(args.output, V, F)
    print(f"{args.input} -> {args.output}: {len(V)} vertices, "
          f"{len(F)} elements")


if __name__ == "__main__":
    main()
