"""The port's mesh tool CLIs (``meshfem_tpu_torch.cli.mesh_convert``,
``.msh_processor`` and ``.tools``) against the reference's on the same
files: every ``tools`` subcommand, the ``mesh_convert`` flags of
``tests/test_cli_extras.py`` and the rest of its pipeline, and the
``msh_processor`` ops of ``tests/test_cli_extras.py`` and the rest of its
op set.  Written files must be equal byte for byte where both sides
compute on the host; numbers computed with torch (``--device cpu``)
against JAX are compared to 1e-12 relative, and ``extract_b``'s
``%.17g`` entries to 1e-14 with their (row, col) pairs equal."""

import json
import re

import numpy as np
import pytest
import torch

from meshfem_tpu.cli import mesh_convert as rconvert
from meshfem_tpu.cli import msh_processor as rproc
from meshfem_tpu.cli import tools as rtools
from meshfem_tpu.io import meshio as rmeshio
from meshfem_tpu.io import msh_fields as rfields
from meshfem_tpu.mesh import generators as rgen

from meshfem_tpu_torch.cli import mesh_convert as tconvert
from meshfem_tpu_torch.cli import msh_processor as tproc
from meshfem_tpu_torch.cli import tools as ttools

NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_poly(path, loops):
    """A Triangle .poly of closed loops (1-based), no hole points."""
    pts = np.vstack(loops)
    lines = [f"{len(pts)} 2 0 0"]
    lines += [f"{i + 1} {x:.17g} {y:.17g}" for i, (x, y) in enumerate(pts)]
    segs, base = [], 0
    for loop in loops:
        n = len(loop)
        segs += [(base + i + 1, base + (i + 1) % n + 1) for i in range(n)]
        base += n
    lines.append(f"{len(segs)} 0")
    lines += [f"{k + 1} {a} {b}" for k, (a, b) in enumerate(segs)]
    lines.append("0")
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    """Input files shared by every case."""
    d = tmp_path_factory.mktemp("mesh_cli")
    V, F = rgen.grid_tri(4, 4)
    rmeshio.save(d / "grid.msh", V, F)
    rmeshio.save(d / "grid.off", V, F)
    Vt, T = rgen.grid_tet(3, 3, 3)
    rmeshio.save(d / "box.msh", Vt, T)
    rmeshio.save(d / "half.msh", *rgen.grid_tri(2, 2, hi=(0.5, 0.5)))
    rmeshio.save(d / "twin.msh", np.vstack([V, V + [3.0, 0.0]]),
                 np.vstack([F, F[:5] + len(V)]))
    # quads in an OBJ: a ring of radially long quads, and a grid
    n = 32
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    inner = np.stack([np.cos(th), np.sin(th), 0 * th], axis=1)
    ring = np.vstack([inner, 2.0 * inner])
    Q = [[k, n + k, n + (k + 1) % n, (k + 1) % n] for k in range(n)]
    (d / "ring.obj").write_text(
        "".join(f"v {x:.17g} {y:.17g} {z:.17g}\n" for x, y, z in ring)
        + "".join("f " + " ".join(str(i + 1) for i in q) + "\n"
                  for q in Q))
    # a field file (tests/test_cli_extras.py::test_msh_processor_...)
    V3 = np.hstack([V, np.zeros((len(V), 1))])
    u = np.stack([V[:, 0] ** 2, -V[:, 1]], axis=1)
    c = V[F].mean(1)
    stress = np.stack([c[:, 0], c[:, 1], 0.3 * c[:, 0] * c[:, 1]], axis=1)
    rmeshio.save_msh(d / "fields.msh", V3, F, fields=[
        {"name": "u", "data": u, "where": "node", "kind": "vector"},
        {"name": "stress", "data": stress, "where": "element",
         "kind": "vector"},
        {"name": "p", "data": V[:, 0] - 2 * V[:, 1], "where": "node",
         "kind": "scalar"}])
    np.savetxt(d / "s.txt", np.linspace(0, 1, len(V)))
    (d / "c.bc").write_text(json.dumps({"regions": [
        {"type": "dirichlet", "value": [0, 0],
         "box": {"minCorner": [0, 0], "maxCorner": [0, 1]}},
        {"type": "force", "value": [0.5, 0],
         "box": {"minCorner": [1, 0], "maxCorner": [1, 1]}}]}))
    occ = np.zeros((3, 3, 3), np.uint8)
    occ[1, 1, 1] = occ[0, 1, 1] = 255
    (d / "vox.raw").write_bytes(occ.tobytes())
    (d / "bo.txt").write_text("2 2 3\n1 1 0  0 0 0\n1 0 0  1 0 0\n")
    write_poly(d / "plate.poly", [
        np.asarray([[0, 0], [2, 0], [2, 1], [0, 1.0]]),
        np.asarray([[0.8, 0.4], [1.2, 0.4], [1.2, 0.6], [0.8, 0.6]])])
    return d


def run(main, args, capsys):
    capsys.readouterr()
    main(args)
    return capsys.readouterr().out


def words_and_numbers(text, paths=()):
    """(the text with numbers blanked, the numbers), paths replaced."""
    for p in paths:
        text = text.replace(str(p), "<path>")
    return NUM.sub("#", text), [float(x) for x in NUM.findall(text)]


def same_numbers(got, ref, rel, paths=()):
    gw, gn = words_and_numbers(got, paths)
    rw, rn = words_and_numbers(ref, paths)
    assert gw == rw and len(gn) == len(rn)
    scale = max([abs(x) for x in rn] + [1e-300])
    assert all(abs(a - b) <= rel * max(abs(b), scale * 1e-3)
               for a, b in zip(gn, rn)), (gn, rn)


def same_msh_fields(a, b, rel=0.0):
    fa, fb = rfields.read_fields(str(a)), rfields.read_fields(str(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]["data"]), np.asarray(fb[k]["data"])
        assert x.shape == y.shape
        assert np.abs(x - y).max(initial=0) <= rel * max(
            np.abs(y).max(initial=0), 1e-300), k


# ---------------------------------------------------------------------------
# tools: all 17 subcommands
# ---------------------------------------------------------------------------

TOOLS = {
    "grid": lambda d: ["grid", "4", "3"],
    "grid3d": lambda d: ["grid3d", "2", "2", "3"],
    "ellipse": lambda d: ["ellipse", "24", "--a", "1.5", "--b", "0.5"],
    "lshape": lambda d: ["lshape", "6"],
    "const_strain": lambda d: ["const_strain", str(d / "grid.msh"),
                               "--strain", "0.1", "-0.05", "0.02"],
    "extract_b": lambda d: ["extract_b", str(d / "grid.msh"), "--degree",
                            "2"],
    "plus_shape": lambda d: ["plus_shape", "1.0", "1.0", "0.4", "0.4",
                             "--area", "0.01"],
    "cursor": lambda d: ["cursor", "0 0 0", "1 2 3", "--radius", "0.5"],
    "clip": lambda d: ["clip", str(d / "grid.msh"), "--min", "0", "0",
                       "--max", "0.5", "1.0"],
    "selector": lambda d: ["selector", str(d / "grid.msh"), "--min", "0",
                           "0", "--max", "0.5", "1.0", "--print-indices"],
    "bc_debug": lambda d: ["bc_debug", str(d / "grid.msh"),
                           str(d / "c.bc")],
    "import_bo_geometry": lambda d: ["import_bo_geometry",
                                     str(d / "bo.txt")],
    "import_voxels_raw": lambda d: ["import_voxels_raw", str(d / "vox.raw"),
                                    "3", "3", "3", "--threshold", "128"],
    "gen_bar_with_shell": lambda d: ["gen_bar_with_shell", "2", "1", "2"],
    "extract_ortho_cell": lambda d: ["extract_ortho_cell",
                                     str(d / "grid.off")],
    "triangulate": lambda d: ["triangulate", str(d / "plate.poly"),
                              "--area", "0.005"],
}
OUT_SUFFIX = {"cursor": ".obj", "extract_b": ".txt", "ellipse": ".off",
              "lshape": ".off", "extract_ortho_cell": ".off"}


@pytest.mark.parametrize("cmd", list(TOOLS))
def test_tools_subcommand_matches_reference(d, capsys, cmd):
    suffix = OUT_SUFFIX.get(cmd, ".msh")
    ro, to = d / f"r_{cmd}{suffix}", d / f"t_{cmd}{suffix}"
    args = TOOLS[cmd](d)

    def out_args(path):
        # import_bo_geometry takes its output as a positional argument
        return [str(path)] if cmd == "import_bo_geometry" else \
            ["-o", str(path)]

    dev = ["--device", "cpu"] if cmd == "extract_b" else []
    ref = run(rtools.main, args + out_args(ro), capsys)
    got = run(ttools.main, args + out_args(to) + dev, capsys)
    assert got.replace(str(to), "<out>") == ref.replace(str(ro), "<out>")
    if cmd == "extract_b":
        rl = ro.read_text().splitlines()
        tl = to.read_text().splitlines()
        assert tl[0] == rl[0] and len(tl) == len(rl) > 100
        rc = np.asarray([l.split() for l in rl[1:]])
        tc = np.asarray([l.split() for l in tl[1:]])
        assert np.array_equal(tc[:, :2], rc[:, :2])
        rv, tv = rc[:, 2].astype(float), tc[:, 2].astype(float)
        assert np.abs(tv - rv).max() <= 1e-14 * np.abs(rv).max()
    else:
        assert to.read_bytes() == ro.read_bytes()


def test_tools_isotropic_validation_matches_reference(d, capsys):
    """The reference prints the tensor at numpy's eight digits, the port
    at every digit: compared at the reference's precision, and the
    distance line to 1e-12."""
    args = ["isotropic_validation", str(d / "grid.msh"), "--degree", "1",
            "--young", "2.0", "--poisson", "0.25"]
    ref = run(rtools.main, args, capsys)
    got = run(ttools.main, args + ["--device", "cpu"], capsys)
    ref_t, got_t = ref.split("relative"), got.split("relative")
    same_numbers(got_t[1], ref_t[1], 1e-5)
    _, rn = words_and_numbers(ref_t[0])
    _, gn = words_and_numbers(got_t[0])
    assert len(gn) == len(rn) == 9
    np.testing.assert_allclose(gn, rn, rtol=1e-7, atol=1e-8 * max(rn))
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import Material

    Ch = hom.homogenize(FEMMesh(*generators.grid_tri(4, 4), degree=1),
                        Material.isotropic(2, 2.0, 0.25),
                        device="cpu").Ch.numpy()
    assert np.array_equal(np.asarray(gn).reshape(3, 3), Ch)


# ---------------------------------------------------------------------------
# mesh_convert
# ---------------------------------------------------------------------------

CONVERT = {
    "info": ("box.msh", None, ["--info"]),
    "boundary": ("box.msh", ".off", ["--boundary"]),
    "translate_scale": ("box.msh", ".msh", ["--Tx", "1.0", "--Sx", "2.0",
                                            "--Sz", "0.5", "--Ty", "-1"]),
    "truncate_sorts_clean": ("box.msh", ".msh", [
        "--truncateElements", "10", "--sortVertices",
        "--sortElementCorners", "--sortElements", "--clean"]),
    "extra_mesh": ("box.msh", ".msh", ["--extraMesh", "box.msh",
                                       "--clean"]),
    "reflect_x_clean_reorient_sort": ("box.msh", ".msh", [
        "--reflect", "x", "--clean", "--reorient", "--sortElements"]),
    "reflect_all": ("half.msh", ".msh", ["--reflect"]),
    "subdivide": ("grid.msh", ".obj", ["--subdivide", "1"]),
    "extrude": ("grid.msh", ".msh", ["--extrude", "0.5", "--layers", "2"]),
    "keep_largest": ("twin.msh", ".msh", ["--keepLargestComponent"]),
    "quad_aspect": ("ring.obj", ".obj", ["-A", "-a", "1.75"]),
    "quad_subdivide_triangulate": ("ring.obj", ".msh", ["-q", "1"]),
    "quad_asymmetric": ("ring.obj", ".msh", ["--quadTriangulateAsymmetric"]),
    "dangling_binary": ("grid.msh", ".msh", [
        "--truncateElements", "7", "-D", "<dump>", "--binary"]),
}


@pytest.mark.parametrize("case", list(CONVERT))
def test_mesh_convert_matches_reference(d, capsys, case):
    src, suffix, flags = CONVERT[case]

    def args(tag):
        out = [] if suffix is None else [str(d / f"{tag}_{case}{suffix}")]
        fl = [str(d / f) if f.endswith((".msh", ".obj")) else f
              for f in flags]
        fl = [str(d / f"{tag}_{case}_dump.obj") if f == "<dump>" else f
              for f in fl]
        return [str(d / src)] + out + fl

    ref = run(rconvert.main, args("r"), capsys)
    got = run(tconvert.main, args("t"), capsys)
    assert got.replace(f"t_{case}", "X") == ref.replace(f"r_{case}", "X")
    for name in (f"_{case}{suffix}", f"_{case}_dump.obj"):
        if (d / f"r{name}").exists():
            assert (d / f"t{name}").read_bytes() == \
                (d / f"r{name}").read_bytes()


# ---------------------------------------------------------------------------
# msh_processor
# ---------------------------------------------------------------------------

PROC = {
    # tests/test_cli_extras.py::test_msh_processor_extended_ops
    "extended_ops": [
        "-e", "u", "norm", "outer:max", "print",
        "-e", "u", "elementAverage", "rename:uavg", "print",
        "-e", "stress", "vonMises", "smoothedElementField",
        "rename:vm_nodal", "outMSH:<out>",
        "-e", "u", "norm", "percentile:90", "print",
        "-e", "stress", "eigenvalues", "maxMag", "outer:mean", "print",
        "-e", "generate:volume", "sum", "print",
        "-e", "expression:x*x+y", "outer:max", "print",
        "-e", "u", "sample:0.5,0.5", "norm", "print"],
    # the rest of the op set
    "stack_and_arithmetic": [
        "-e", "p", "dup", "mul", "sqrt", "neg", "abs", "max", "print",
        "-e", "u", "p", "swap", "pop", "scale:2.5", "min", "print",
        "-e", "p", "u", "reverse", "pop", "set:3", "mean", "print",
        "-e", "u", "index:1", "2", "div", "sum", "print",
        "-e", "u", "dup", "scale:0.5", "sub", "minMag", "outer:minMag",
        "print",
        "-e", "u", "p", "pull:u", "norm", "outer:sum", "print",
        "-e", "p", "1.5", "extract:p", "index:3", "print"],
    "fields_and_io": [
        "-e", "extractAll", "list", "noprint",
        "-e", "stress", "frobeniusNorm", "maxMag", "print",
        "-e", "generate:barycenter", "outer:mean", "print",
        "-e", "u", "p", "transferFieldsToPerElem", "pop", "outer:max",
        "print",
        "-e", "import_sfield:s=<s>", "p", "mul", "sum", "print",
        "-e", "p", "sample:0.3,0.7", "print",
        "-e", "stress", "sample:0.31,0.62", "outer:sum", "print",
        "-e", "expression:x,y*y", "outer:sum", "print",
        "-e", "stress", "eigenvalues", "outer:max", "print",
        "-e", "u", "elementAverage"],
}


@pytest.mark.parametrize("case", list(PROC))
def test_msh_processor_matches_reference(d, capsys, case):
    def args(tag):
        a = [t.replace("<out>", str(d / f"{tag}_{case}.msh"))
             .replace("<s>", str(d / "s.txt")) for t in PROC[case]]
        return [str(d / "fields.msh")] + a + \
            ["-o", str(d / f"{tag}_{case}_all.msh")]

    ref = run(rproc.main, args("r"), capsys)
    got = run(tproc.main, args("t") + ["--device", "cpu"], capsys)
    same_numbers(got.replace("t_", "r_"), ref, 1e-12)
    for name in (f"_{case}.msh", f"_{case}_all.msh"):
        if (d / f"r{name}").exists():
            same_msh_fields(d / f"t{name}", d / f"r{name}", 1e-12)


def test_msh_processor_errors_match_reference(d):
    for ops in (["frobnicate"], ["pull:nothere"], ["u", "index:7"],
                ["generate:area"]):
        args = [str(d / "fields.msh"), "-e", *ops]
        with pytest.raises(ValueError) as ref:
            rproc.main(args)
        with pytest.raises(ValueError) as got:
            tproc.main(args + ["--device", "cpu"])
        assert str(got.value) == str(ref.value)
