"""Mesh and field I/O and the Poisson and Simulate CLIs of the port against
meshfem_tpu, on the CPU.

* every ``meshio`` format (OFF, OBJ, MSH ASCII and binary, P1 and P2,
  MEDIT, STL ASCII and binary, node/ele; poly read only), on triangle and
  tet meshes: the two packages write the same bytes, and each package
  reads the other's file to the same arrays;
* MSH with node and element fields (scalar, vector, symmetric matrix),
  binary and ASCII: the same bytes, read back through both ``msh_fields``
  readers;
* ``cli.poisson`` and ``cli.simulate`` with ``--device cpu`` on the meshes
  of ``tests/test_cli.py``: each output read by the reference's reader and
  held against the reference CLI's output on the same files (1e-10 of
  max), the stiffness dump too, and ``--precond amg`` on the routed
  operator (1e-8 of max).
"""

import json

import numpy as np
import pytest
import torch

from meshfem_tpu.io import meshio as rio, msh_fields as rfields
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen

from meshfem_tpu_torch.io import meshio as tio, msh_fields as tfields


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes():
    V2, F2 = rgen.grid_tri(4, 3, hi=(1.5, 1.0))
    V3, F3 = rgen.grid_tet(2, 2, 3)
    rng = np.random.default_rng(0)
    V2 = V2 + 0.01 * rng.normal(size=V2.shape)     # digits to round-trip
    V3 = V3 + 0.01 * rng.normal(size=V3.shape)
    return {"tri": (V2, F2), "tet": (V3, F3)}


MESHES = _meshes()
SAVES = {"off": "save_off", "obj": "save_obj", "msh": "save_msh",
         "msh_bin": "save_msh", "medit": "save_medit", "node": "save_node_ele",
         "stl_bin": "save_stl", "stl_ascii": "save_stl"}
EXT = {"off": ".off", "obj": ".obj", "msh": ".msh", "msh_bin": ".msh",
       "medit": ".mesh", "node": ".node", "stl_bin": ".stl",
       "stl_ascii": ".stl"}
CASES = [(m, f) for m in ("tri", "tet") for f in SAVES
         if not (m == "tet" and f.startswith("stl"))]


def _save(mod, fmt, path, V, F):
    kw = {"msh_bin": {"binary": True}, "stl_ascii": {"binary": False}}
    getattr(mod, SAVES[fmt])(path, V, F, **kw.get(fmt, {}))


def _read_bytes(path):
    if path.suffix == ".node":
        return path.read_bytes() + path.with_suffix(".ele").read_bytes()
    return path.read_bytes()


@pytest.mark.parametrize("mesh,fmt", CASES)
def test_formats_cross(tmp_path, mesh, fmt):
    V, F = MESHES[mesh]
    pt, pr = tmp_path / ("t" + EXT[fmt]), tmp_path / ("r" + EXT[fmt])
    _save(tio, fmt, pt, V, F)
    _save(rio, fmt, pr, V, F)
    assert _read_bytes(pt) == _read_bytes(pr)
    # each package reads the other's file, through the extension's guess
    Vt, Ft = tio.load(pr)
    Vr, Fr = rio.load(pt)
    assert np.array_equal(Vt, Vr) and np.array_equal(Ft, Fr)
    assert Ft.shape == F.shape
    if fmt.startswith("stl"):      # float32, vertices merged and reordered
        np.testing.assert_allclose(Vt[Ft], np.pad(V, [(0, 0), (0, 1)])[F],
                                   atol=1e-6)
    else:
        assert np.array_equal(Ft, F)
        assert np.array_equal(Vt[:, :V.shape[1]], V)


@pytest.mark.parametrize("mesh", ["tri", "tet"])
@pytest.mark.parametrize("binary", [False, True])
def test_msh_p2_cross(tmp_path, mesh, binary):
    V, F = MESHES[mesh]
    m = RFEMMesh(V, F, degree=2)
    pt, pr = tmp_path / "t.msh", tmp_path / "r.msh"
    tio.save_msh(pt, m.node_positions, m.elem_nodes, binary=binary)
    rio.save_msh(pr, m.node_positions, m.elem_nodes, binary=binary)
    assert pt.read_bytes() == pr.read_bytes()
    Vt, Ft = tio.load_msh(pr)
    assert np.array_equal(Ft, m.elem_nodes)
    assert np.array_equal(Vt[:, :V.shape[1]], m.node_positions)


MIXED_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
30 1 1 0
10 0 0 0
20 1 0 0
40 0 1 0
50 0.5 0.5 0
$EndNodes
$Elements
7
1 15 2 0 1 10
2 1 2 0 1 10 20
3 1 3 0 1 7 20 30
4 2 2 0 1 10 20 50
5 2 2 0 1 20 30 50
6 2 3 0 1 9 30 40 50
7 2 2 0 1 40 10 50
$EndElements
"""


@pytest.mark.parametrize("bad", [False, True])
def test_msh_mixed_elements_cross(tmp_path, bad):
    """A Gmsh-style ASCII file: unsorted, non-contiguous node ids, point and
    line elements beside the triangles, and varying tag counts (the
    loader's line-by-line path); an element naming a missing node raises
    KeyError in both packages."""
    p = tmp_path / "mixed.msh"
    p.write_text(MIXED_MSH.replace("40 10 50", "40 11 50") if bad
                 else MIXED_MSH)
    if bad:
        for mod in (tio, rio):
            with pytest.raises(KeyError):
                mod.load(p)
        return
    (Vt, Ft), (Vr, Fr) = tio.load(p), rio.load(p)
    assert np.array_equal(Vt, Vr) and np.array_equal(Ft, Fr)
    assert Ft.tolist() == [[1, 2, 4], [2, 0, 4], [0, 3, 4], [3, 1, 4]]


def test_poly_and_guess_format(tmp_path):
    p = tmp_path / "square.poly"
    p.write_text("# a square with a hole\n4 2 0 0\n1 0 0\n2 1 0\n3 1 1\n"
                 "4 0 1\n4 0\n1 1 2\n2 2 3\n3 3 4\n4 4 1\n1\n1 0.5 0.5\n")
    for a, b in zip(tio.load(p), rio.load(p)):
        assert np.array_equal(a, b)
    for name in ("a.off", "b.OBJ", "c.msh", "d.mesh", "e.stl", "f.node",
                 "g.ele", "h.poly"):
        assert tio.guess_format(name) == rio.guess_format(name)
    with pytest.raises(ValueError):
        tio.guess_format("x.vtk")


def _fields(mesh, dim):
    rng = np.random.default_rng(dim)
    N, E = mesh.num_nodes, mesh.num_elements
    fl = {2: 3, 3: 6}[dim]
    return [
        {"name": "u", "data": rng.normal(size=(N, dim)), "where": "node",
         "kind": "vector"},
        {"name": "phi", "data": rng.normal(size=N), "where": "node",
         "kind": "scalar"},
        {"name": "stress", "data": rng.normal(size=(E, fl)),
         "where": "element", "kind": "smatrix"},
        {"name": "von_mises", "data": rng.uniform(size=E),
         "where": "element"},                     # kind guessed
    ]


@pytest.mark.parametrize("mesh", ["tri", "tet"])
@pytest.mark.parametrize("binary", [False, True])
def test_msh_fields_cross(tmp_path, mesh, binary):
    V, F = MESHES[mesh]
    m = RFEMMesh(V, F, degree=2)
    dim = m.dim
    fields = _fields(m, dim)
    pt, pr = tmp_path / "t.msh", tmp_path / "r.msh"
    tio.save_msh(pt, m.node_positions, m.elem_nodes, binary=binary,
                 fields=fields)
    rio.save_msh(pr, m.node_positions, m.elem_nodes, binary=binary,
                 fields=fields)
    assert pt.read_bytes() == pr.read_bytes()
    readers = [(tfields, pr), (tfields, pt)]
    if binary:
        # the reference reads the file as text: its binary blocks fail
        with pytest.raises(UnicodeDecodeError):
            rfields.read_fields(pt)
    else:
        readers.append((rfields, pt))
    for mod, path in readers:
        got = mod.read_fields(path)
        assert {k: v["where"] for k, v in got.items()} == {
            f["name"]: f["where"] for f in fields}
        # written with 17 significant digits: float64 round-trips exactly
        assert np.array_equal(mod.vector_field(got, "u", dim),
                              fields[0]["data"])
        assert np.array_equal(mod.scalar_field(got, "phi"),
                              fields[1]["data"])
        assert np.array_equal(mod.smatrix_field(got, "stress", dim),
                              fields[2]["data"])
        assert np.array_equal(mod.scalar_field(got, "von_mises"),
                              fields[3]["data"])
        # the 9-component tensor layout of the symmetric matrices
        full = got["stress"]["data"].reshape(-1, 3, 3)
        assert np.array_equal(full, full.transpose(0, 2, 1))
    Vt, Ft = tio.load(pr)
    assert np.array_equal(Ft, m.elem_nodes)


# -- the CLIs ----------------------------------------------------------------

CANTILEVER_BC = {"regions": [
    {"type": "dirichlet", "value": [0, 0],
     "box%": {"minCorner": [-0.001, -0.001], "maxCorner": [0.001, 1.001]}},
    {"type": "force", "value": [0, -10],
     "box%": {"minCorner": [0.999, -0.001], "maxCorner": [1.001, 1.001]}},
]}
POISSON_BC = {"regions": [
    {"type": "dirichlet", "value": ["sin(pi * x)", 0, 0],
     "box%": {"minCorner": [-0.001, 0.999], "maxCorner": [1.001, 1.001]}},
    {"type": "dirichlet", "value": [0, 0, 0],
     "box%": {"minCorner": [-0.001, -0.001], "maxCorner": [1.001, 0.001]}},
]}


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """The inputs of ``tests/test_cli.py``: the cantilever .msh, its
    material and .bc, and the Poisson square .off with its .bc."""
    d = tmp_path_factory.mktemp("cli")
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    rio.save_msh(d / "bar.msh", V, F)
    (d / "mat.material").write_text(json.dumps(
        {"type": "isotropic_material", "dim": 2, "young": 200.0,
         "poisson": 0.35}))
    (d / "bc.bc").write_text(json.dumps(CANTILEVER_BC))
    V, F = rgen.grid_tri(6, 6)
    rio.save_off(d / "sq.off", V, F)
    (d / "p.bc").write_text(json.dumps(POISSON_BC))
    return d


def _close(a, b, rel=1e-10):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def test_poisson_cli(cli_files, capsys):
    from meshfem_tpu.cli import poisson as rcli
    from meshfem_tpu_torch.cli import poisson as tcli

    d = cli_files
    rcli.main([str(d / "sq.off"), "-b", str(d / "p.bc"), "-o",
               str(d / "pr.msh")])
    tcli.main([str(d / "sq.off"), "-b", str(d / "p.bc"), "-o",
               str(d / "pt.msh"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("solved:") == 2 and "wrote" in out
    ref, got = (rfields.read_fields(d / "pr.msh"),
                rfields.read_fields(d / "pt.msh"))
    u = rfields.scalar_field(got, "u")
    assert u.max() <= 1.0 + 1e-9 and u.min() >= -1e-6
    _close(u, rfields.scalar_field(ref, "u"))
    _close(rfields.vector_field(got, "grad_u", 2),
           rfields.vector_field(ref, "grad_u", 2))
    assert [np.array_equal(a, b) for a, b in zip(rio.load(d / "pt.msh"),
                                                 rio.load(d / "pr.msh"))] \
        == [True, True]


def _triplets(path):
    import scipy.sparse as sp

    lines = path.read_text().splitlines()
    n, m, nnz = map(int, lines[0].split())
    t = np.loadtxt(lines[1:]).reshape(-1, 3)
    assert len(t) == nnz
    return sp.coo_matrix((t[:, 2], (t[:, 0].astype(int),
                                    t[:, 1].astype(int))), shape=(n, m))


def test_simulate_cli(cli_files, capsys):
    from meshfem_tpu.cli import simulate as rcli
    from meshfem_tpu_torch.cli import simulate as tcli

    d = cli_files
    args = [str(d / "bar.msh"), "-m", str(d / "mat.material"), "-b",
            str(d / "bc.bc"), "--degree", "2"]
    rcli.main(args + ["-o", str(d / "sr.msh"), "--dumpMatrix",
                      str(d / "Kr.txt")])
    tcli.main(args + ["-o", str(d / "st.msh"), "--dumpMatrix",
                      str(d / "Kt.txt"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("solved:") == 2
    ref, got = (rfields.read_fields(d / "sr.msh"),
                rfields.read_fields(d / "st.msh"))
    assert set(got) == set(ref) == {"u", "load", "strain", "stress",
                                    "von_mises"}
    u = rfields.vector_field(got, "u", 2)
    assert u[:, 1].min() < -0.01           # deflects downward
    for name in ("u", "load"):
        _close(rfields.vector_field(got, name, 2),
               rfields.vector_field(ref, name, 2))
    for name in ("strain", "stress"):
        _close(rfields.smatrix_field(got, name, 2),
               rfields.smatrix_field(ref, name, 2))
    _close(rfields.scalar_field(got, "von_mises"),
           rfields.scalar_field(ref, "von_mises"))
    Kt, Kr = _triplets(d / "Kt.txt"), _triplets(d / "Kr.txt")
    assert Kt.shape == Kr.shape and Kt.shape[0] == Kt.shape[1]
    _close(Kt.toarray(), Kr.toarray(), 1e-14)
    # AMG: on the routed operator only, as in the reference
    with pytest.raises(ValueError, match="routed operator only"):
        tcli.main(args + ["--precond", "amg", "--device", "cpu"])
    tcli.main(args + ["-o", str(d / "sa.msh"), "--precond", "amg",
                      "--operator", "routed", "--device", "cpu"])
    _close(rfields.vector_field(rfields.read_fields(d / "sa.msh"), "u", 2),
           rfields.vector_field(ref, "u", 2), 1e-8)
