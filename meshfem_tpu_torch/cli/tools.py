"""Small tool CLIs (counterpart of ``meshfem_tpu/cli/tools.py``; parity
with the reference's ``src/bin/tools`` generators and the
ConstStrainDisplacement / ExtractBMatrix binaries):

    python -m meshfem_tpu_torch.cli.tools grid 16 16 -o grid.msh
    python -m meshfem_tpu_torch.cli.tools grid3d 8 8 8 -o box.msh
    python -m meshfem_tpu_torch.cli.tools ellipse 64 --a 1 --b 0.6 -o e.off
    python -m meshfem_tpu_torch.cli.tools lshape 16 -o L.off
    python -m meshfem_tpu_torch.cli.tools const_strain mesh.msh \\
        --strain 0.1 0 0 -o u.msh
    python -m meshfem_tpu_torch.cli.tools extract_b mesh.msh -o B.txt \\
        [--device cuda]

``extract_b`` (the strain matrix) and ``isotropic_validation``
(``homogenize`` and ``isotropy_distance``) compute on ``--device``, the
CUDA device by default; ``isotropic_validation`` prints the homogenized
tensor with every digit (numpy's shortest round-trip form), where the
reference prints numpy's default eight.  The other subcommands are host
code on the port's generators, filters, triangulation and I/O.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grid")
    g.add_argument("nx", type=int)
    g.add_argument("ny", type=int)
    g.add_argument("-o", "--output", required=True)

    g3 = sub.add_parser("grid3d")
    g3.add_argument("nx", type=int)
    g3.add_argument("ny", type=int)
    g3.add_argument("nz", type=int)
    g3.add_argument("-o", "--output", required=True)

    e = sub.add_parser("ellipse")
    e.add_argument("n", type=int)
    e.add_argument("--a", type=float, default=1.0)
    e.add_argument("--b", type=float, default=0.6)
    e.add_argument("-o", "--output", required=True)

    l = sub.add_parser("lshape")
    l.add_argument("n", type=int)
    l.add_argument("-o", "--output", required=True)

    cs = sub.add_parser("const_strain",
                        help="displacement field with prescribed constant "
                             "strain (ConstStrainDisplacement_cli)")
    cs.add_argument("mesh")
    cs.add_argument("--strain", type=float, nargs="+", required=True,
                    help="flattened strain (Voigt raw components)")
    cs.add_argument("-o", "--output", required=True)

    eb = sub.add_parser("extract_b",
                        help="displacement->strain matrix in triplet form "
                             "(ExtractBMatrix)")
    eb.add_argument("mesh")
    eb.add_argument("--degree", type=int, default=1)
    eb.add_argument("-o", "--output", required=True)
    eb.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")

    ps = sub.add_parser("plus_shape", help="triangulated plus/cross outline "
                                           "(tools/plus_shape.cc)")
    for name in ("a", "b", "h1", "h2"):
        ps.add_argument(name, type=float)
    ps.add_argument("-o", "--output", required=True)
    ps.add_argument("--area", type=float, default=1e-4)

    cu = sub.add_parser("cursor", help="crosshair cursor geometry at points "
                                       "(tools/cursor.cc)")
    cu.add_argument("points", nargs="+",
                    help="'x y' or 'x y z' per point (quoted)")
    cu.add_argument("--radius", type=float, default=1.0)
    cu.add_argument("-o", "--output", required=True)

    cl = sub.add_parser("clip", help="keep elements inside a bbox "
                                     "(tools/clip.cc, element-level)")
    cl.add_argument("mesh")
    cl.add_argument("--min", type=float, nargs="+", required=True)
    cl.add_argument("--max", type=float, nargs="+", required=True)
    cl.add_argument("-o", "--output", required=True)

    se = sub.add_parser("selector", help="mark nodes/elements in a box as a "
                                         "field (tools/selector.cc)")
    se.add_argument("mesh")
    se.add_argument("--min", type=float, nargs="+", required=True)
    se.add_argument("--max", type=float, nargs="+", required=True)
    se.add_argument("--print-indices", action="store_true")
    se.add_argument("-o", "--output", required=True)

    bd = sub.add_parser("bc_debug", help="visualize .bc region matching "
                                         "(tools/bc_debug.cc)")
    bd.add_argument("mesh")
    bd.add_argument("bc")
    bd.add_argument("-o", "--output", required=True)

    ib = sub.add_parser("import_bo_geometry",
                        help="Bo Zhu ascii voxel format ('#slices #rows "
                             "#cols' header + 0/1 grid) -> tet mesh "
                             "(tools/import_bo_geometry.cc)")
    ib.add_argument("input")
    ib.add_argument("output")

    iv = sub.add_parser("import_voxels_raw",
                        help="raw uint8 voxel file -> tet mesh "
                             "(tools/import_voxels_raw.cc)")
    iv.add_argument("raw")
    iv.add_argument("nx", type=int)
    iv.add_argument("ny", type=int)
    iv.add_argument("nz", type=int)
    iv.add_argument("--threshold", type=int, default=1)
    iv.add_argument("-o", "--output", required=True)

    gb = sub.add_parser("gen_bar_with_shell",
                        help="bar mesh with a one-cell shell, labeled by an "
                             "element material field "
                             "(tools/gen_bar_with_shell.cc)")
    gb.add_argument("nx", type=int)
    gb.add_argument("ny", type=int)
    gb.add_argument("nz", type=int)
    gb.add_argument("-o", "--output", required=True)

    eo = sub.add_parser("extract_ortho_cell",
                        help="positive-quadrant/octant orthotropic base "
                             "cell of a period cell "
                             "(tools/extract_ortho_cell.cc)")
    eo.add_argument("mesh")
    eo.add_argument("-o", "--output", required=True)

    isov = sub.add_parser("isotropic_validation",
                          help="homogenize and report distance to the "
                               "closest isotropic tensor "
                               "(tools/IsotropicValidation.cc)")
    isov.add_argument("mesh")
    isov.add_argument("--young", type=float, default=1.0)
    isov.add_argument("--poisson", type=float, default=0.3)
    isov.add_argument("--degree", type=int, default=2)
    isov.add_argument("--device", default=None,
                      help="torch device (default: the CUDA device)")

    ts = sub.add_parser("triangulate",
                        help="triangulate a PSLG .poly file "
                             "(tools/triangulate_standalone.cc)")
    ts.add_argument("poly")
    ts.add_argument("--area", type=float, default=0.01)
    ts.add_argument("-o", "--output", required=True)

    args = ap.parse_args(argv)
    from ..io import meshio
    from ..mesh import generators, FEMMesh

    if args.cmd == "grid":
        V, F = generators.grid_tri(args.nx, args.ny)
        meshio.save(args.output, V, F)
    elif args.cmd == "grid3d":
        V, F = generators.grid_tet(args.nx, args.ny, args.nz)
        meshio.save(args.output, V, F)
    elif args.cmd == "ellipse":
        V, F = generators.ellipse(args.n, args.a, args.b)
        meshio.save(args.output, V, F)
    elif args.cmd == "lshape":
        V, F = generators.l_shape(args.n)
        meshio.save(args.output, V, F)
    elif args.cmd == "const_strain":
        from ..fem.flattening import flat_to_sym

        V, F = meshio.load(args.mesh)
        dim = F.shape[1] - 1
        if dim == 2:
            V = V[:, :2]
        mesh = FEMMesh(V, F, degree=1)
        eps = flat_to_sym(np.asarray(args.strain), dim)
        u = mesh.node_positions @ eps.T
        meshio.save_msh(args.output, mesh.node_positions, mesh.elem_nodes,
                        fields=[{"name": "u", "data": u, "where": "node",
                                 "kind": "vector"}])
    elif args.cmd == "extract_b":
        from ..ops import element_matrices as em

        V, F = meshio.load(args.mesh)
        dim = F.shape[1] - 1
        if dim == 2:
            V = V[:, :2]
        mesh = FEMMesh(V, F, degree=args.degree)
        g = mesh.geometry(args.device)
        centroid = np.full((1, mesh.K + 1), 1.0 / (mesh.K + 1))
        B = em.element_strain_matrix(
            g.grad_lambda, mesh.degree, centroid)[:, 0]  # [E, fl, n, d]
        B = B.cpu().numpy()
        E_, fl, n, d = B.shape
        # the reference's (element, row, node, component) loop order
        e, a, i, c = np.nonzero(B)
        rows = e * fl + a
        cols = mesh.elem_nodes[e, i] * d + c
        with open(args.output, "w") as f:
            f.write(f"{E_ * fl} {mesh.num_nodes * d}\n")
            f.writelines(f"{r} {col} {v:.17g}\n" for r, col, v in
                         zip(rows.tolist(), cols.tolist(),
                             B[e, a, i, c].tolist()))
    elif args.cmd == "plus_shape":
        from ..mesh.triangulate import triangulate_pslg

        a, b, h1, h2 = args.a, args.b, args.h1, args.h2
        pts = np.asarray([
            (h2 / 2, -h1 / 2), (a / 2, -h1 / 2), (a / 2, h1 / 2),
            (h2 / 2, h1 / 2), (h2 / 2, b / 2), (-h2 / 2, b / 2),
            (-h2 / 2, h1 / 2), (-a / 2, h1 / 2), (-a / 2, -h1 / 2),
            (-h2 / 2, -h1 / 2), (-h2 / 2, -b / 2), (h2 / 2, -b / 2)])
        V, F = triangulate_pslg(pts, target_area=args.area)
        meshio.save(args.output, V, F)
    elif args.cmd == "cursor":
        r = args.radius
        verts, lines = [], []
        for ptstr in args.points:
            p = np.zeros(3)
            vals = [float(x) for x in ptstr.split()]
            p[:len(vals)] = vals
            base = len(verts)
            for axis in range(3):
                lo, hi = p.copy(), p.copy()
                lo[axis] -= r
                hi[axis] += r
                verts += [lo, hi]
                lines.append((base + 2 * axis, base + 2 * axis + 1))
        with open(args.output, "w") as f:   # OBJ line elements
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for l0, l1 in lines:
                f.write(f"l {l0 + 1} {l1 + 1}\n")
    elif args.cmd in ("clip", "selector"):
        from ..io import msh_fields

        V, F = meshio.load(args.mesh)
        dim = 2 if F.shape[1] == 3 else 3
        lo = np.asarray(args.min)[:dim]
        hi = np.asarray(args.max)[:dim]
        cent = V[:, :dim][F].mean(axis=1)
        inside_e = np.all((cent >= lo) & (cent <= hi), axis=1)
        if args.cmd == "clip":
            from ..mesh import filters

            V2, F2 = filters.remove_dangling_vertices(V, F[inside_e])
            meshio.save(args.output, V2, F2)
        else:
            inside_n = np.all((V[:, :dim] >= lo) & (V[:, :dim] <= hi),
                              axis=1)
            if args.print_indices:
                print("nodes:", np.flatnonzero(inside_n).tolist())
                print("elements:", np.flatnonzero(inside_e).tolist())
            meshio.save_msh(args.output, V, F, fields=[
                {"name": "selected_nodes",
                 "data": inside_n.astype(float), "where": "node",
                 "kind": "scalar"},
                {"name": "selected_elements",
                 "data": inside_e.astype(float), "where": "element",
                 "kind": "scalar"}])
    elif args.cmd == "bc_debug":
        from ..physics import boundary_conditions as bcm, \
            ElasticitySimulator, Material

        V, F = meshio.load(args.mesh)
        dim = 2 if F.shape[1] == 3 else 3
        mesh = FEMMesh(V[:, :dim], F, degree=1)
        sim = ElasticitySimulator(mesh, Material.isotropic(dim, 1.0, 0.3),
                                  device="cpu")
        conds = bcm.load_bc(args.bc, dim=dim)
        sim.apply_boundary_conditions(conds)
        dmask = np.asarray(sim.dirichlet_mask, dtype=float)
        load = sim.neumann_load.cpu().numpy()
        meshio.save_msh(args.output, mesh.node_positions, mesh.elem_nodes,
                        fields=[
            {"name": "dirichlet_components",
             "data": dmask.sum(axis=1)[np.asarray(sim.dof_map)],
             "where": "node", "kind": "scalar"},
            {"name": "neumann_load",
             "data": load[np.asarray(sim.dof_map)],
             "where": "node", "kind": "vector"}])
    elif args.cmd == "import_voxels_raw":
        from ..mesh import filters

        data = np.fromfile(args.raw, dtype=np.uint8)
        occ = (data.reshape(args.nx, args.ny, args.nz)
               >= args.threshold)
        V, T = filters.voxels_to_simplices(occ)
        meshio.save(args.output, V, T)
    elif args.cmd == "import_bo_geometry":
        from ..mesh import filters

        tokens = open(args.input).read().split()
        ns, nr, nc = (int(t) for t in tokens[:3])
        if len(tokens) != 3 + ns * nr * nc:
            raise SystemExit(
                f"expected {ns * nr * nc} voxel values, "
                f"got {len(tokens) - 3}")
        vals = np.asarray(tokens[3:], dtype=np.int64)
        # indicator[s][r][c]; the reference's gen_grid(ncols, nrows,
        # nslices) voxel (c, r, s) -> occupancy[x, y, z]
        occ = (vals.reshape(ns, nr, nc) != 0).transpose(2, 1, 0)
        V, T = filters.voxels_to_simplices(occ)
        meshio.save(args.output, V, T)
    elif args.cmd == "gen_bar_with_shell":
        V, T = generators.grid_tet(args.nx + 2, args.ny + 2, args.nz + 2,
                                   hi=(args.nx + 2.0, args.ny + 2.0,
                                       args.nz + 2.0))
        cent = V[T].mean(axis=1)
        inner = np.all((cent >= 1.0) & (cent <= np.asarray(
            [args.nx + 1.0, args.ny + 1.0, args.nz + 1.0])), axis=1)
        meshio.save_msh(args.output, V, T, fields=[
            {"name": "material", "data": inner.astype(float),
             "where": "element", "kind": "scalar"}])
    elif args.cmd == "extract_ortho_cell":
        from ..mesh import filters

        V, F = meshio.load(args.mesh)
        dim = 2 if F.shape[1] == 3 else 3
        Vd = V[:, :dim]
        mid = 0.5 * (Vd.min(axis=0) + Vd.max(axis=0))
        cent = Vd[F].mean(axis=1)
        keep = np.all(cent >= mid - 1e-12, axis=1)
        V2, F2 = filters.remove_dangling_vertices(V, F[keep])
        meshio.save(args.output, V2, F2)
    elif args.cmd == "isotropic_validation":
        from ..physics import Material
        from ..analysis import homogenization as hom
        from ..fem import tensor_projection

        V, F = meshio.load(args.mesh)
        dim = 2 if F.shape[1] == 3 else 3
        mesh = FEMMesh(V[:, :dim], F, degree=args.degree)
        mat = Material.isotropic(dim, args.young, args.poisson)
        r = hom.homogenize(mesh, mat, device=args.device)
        dist = float(tensor_projection.isotropy_distance(r.Ch))
        print("homogenized tensor:")
        with np.printoptions(floatmode="unique", linewidth=200):
            print(r.Ch.cpu().numpy())
        print(f"relative isotropy distance: {dist:.6g}")
        return
    elif args.cmd == "triangulate":
        from ..io.meshio import load_poly
        from ..mesh.triangulate import triangulate_pslg

        pts, segs, hole_pts = load_poly(args.poly)
        # chain segments into closed loops; the largest-area loop is the
        # outline, the rest are holes
        nxt = {int(a): int(b) for a, b in segs}
        loops, seen = [], set()
        for start in list(nxt):
            if start in seen:
                continue
            loop, cur = [start], nxt[start]
            seen.add(start)
            while cur != start:
                loop.append(cur)
                seen.add(cur)
                cur = nxt[cur]
            loops.append(np.asarray(loop))

        def loop_area(lp):
            P = pts[lp][:, :2]
            Q = np.roll(P, -1, axis=0)
            return 0.5 * abs(np.sum(P[:, 0] * Q[:, 1] - Q[:, 0] * P[:, 1]))

        loops.sort(key=loop_area, reverse=True)
        outline = pts[loops[0]][:, :2]
        holes = [pts[lp][:, :2] for lp in loops[1:]]
        V, F = triangulate_pslg(outline, holes=holes,
                                target_area=args.area)
        meshio.save(args.output, V, F)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
