"""The port's host core (``meshfem_tpu_torch.native``, built from its own
copy of ``hostcore.cpp`` into ``build/``) and PSLG triangulation
(``meshfem_tpu_torch.mesh.triangulate``) against ``meshfem_tpu.native``
and ``meshfem_tpu.mesh.triangulate``: the five bindings, the scipy and
Ruppert paths and the entity links equal to the bit; the port's meshes
built with the core equal to those built without it
(``MESHFEM_TORCH_NO_NATIVE=1``); and none of this slice's modules
imports JAX or the reference."""

import ctypes
import subprocess
import sys

import numpy as np
import pytest

from meshfem_tpu import native as rnative
from meshfem_tpu.mesh import triangulate as rtri
from meshfem_tpu.mesh import generators as rgen

from meshfem_tpu_torch import native
from meshfem_tpu_torch.mesh import FEMMesh, triangulate as tri


SQUARE = np.asarray([[0.0, 0], [1, 0], [1, 1], [0, 1]])
OUTLINE = np.asarray([[0, 0], [3, 0], [3, 3], [0, 3.0]])
HOLE = np.asarray([[1, 1], [2, 1], [2, 2], [1, 2.0]])
L_OUTLINE = np.asarray([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2.0]])
SLOT = np.asarray([[0.8, 0.4], [1.2, 0.4], [1.2, 0.6], [0.8, 0.6]])
RECT = np.asarray([[0, 0], [2, 0], [2, 1], [0, 1.0]])


@pytest.fixture(scope="module")
def core():
    """The port's library (built on first use) and the reference's."""
    assert native.available(), "g++ could not build the host core"
    assert rnative.available()
    return native.get_lib(), rnative.get_lib()


def test_core_builds_into_build_dir(core):
    so = native.library_path()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent == native.SOURCE.parents[2]
    assert native.SOURCE.read_bytes() == (
        native.SOURCE.parents[2] / "meshfem_tpu/native/hostcore.cpp"
    ).read_bytes()


def test_no_native_switch_read_at_each_call(core, monkeypatch):
    monkeypatch.setenv("MESHFEM_TORCH_NO_NATIVE", "1")
    assert native.get_lib() is None and native.unique_edges(
        np.zeros((1, 2), np.int64)) is None
    monkeypatch.delenv("MESHFEM_TORCH_NO_NATIVE")
    assert native.get_lib() is not None


@pytest.mark.parametrize("mesh", ["tri", "tet"])
def test_match_faces_matches_reference(core, mesh):
    from meshfem_tpu_torch.mesh.simplicial import (TET_FACE_CORNERS,
                                                   TRI_FACE_CORNERS)
    if mesh == "tri":
        _, F = rgen.grid_tri(9, 7)
        hv = F[:, TRI_FACE_CORNERS].reshape(-1, 2)
    else:
        _, F = rgen.grid_tet(4, 3, 3)
        hv = F[:, TET_FACE_CORNERS].reshape(-1, 3)
    got = native.match_faces(hv)
    assert np.array_equal(got, rnative.match_faces(hv))
    assert (got >= 0).any() and (got < 0).any()
    bad = np.vstack([hv, hv[:1]])               # a face shared three times
    with pytest.raises(ValueError, match="non-manifold"):
        native.match_faces(bad)


def test_unique_edges_matches_reference(core):
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 40, (500, 2))
    got, ref = native.unique_edges(pairs), rnative.unique_edges(pairs)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    uniq, inv = np.unique(np.sort(pairs, axis=1), axis=0,
                          return_inverse=True)
    assert np.array_equal(got[1], uniq)
    assert np.array_equal(got[0], inv.ravel())


def test_build_scatter_plan_matches_reference(core):
    ids = np.random.default_rng(1).integers(0, 50, 900)
    got = native.build_scatter_plan(ids, 60, g1=8)
    ref = rnative.build_scatter_plan(ids, 60, g1=8)
    assert got[2] == ref[2]
    assert all(np.array_equal(a, b) and a.dtype == np.int32
               for a, b in zip(got[:2], ref[:2]))
    # the ladder sums: gather rows into groups of g1, groups into segments
    vals = np.random.default_rng(2).standard_normal(len(ids))
    g1, g2 = 8, got[2]
    lvl1 = np.append(vals, 0.0)[got[0]].reshape(-1, g1).sum(axis=1)
    seg = np.append(lvl1, 0.0)[got[1]].reshape(60, g2).sum(axis=1)
    np.testing.assert_allclose(seg, np.bincount(ids, vals, 60), atol=1e-12)


@pytest.mark.parametrize("d", [2, 3])
def test_morton_codes_match_reference_and_reorder(core, d):
    from meshfem_tpu_torch.mesh.reorder import _morton_codes

    pts = np.random.default_rng(d).random((300, d))
    nb = min(21, 63 // d)
    lo, span = pts.min(axis=0), np.ptp(pts, axis=0)
    q = np.minimum(((pts - lo) / span * ((1 << nb) - 1)).astype(np.uint64),
                   (1 << nb) - 1)
    got = native.morton_codes(q, nb)
    ref = np.empty(len(q), dtype=np.uint64)
    rlib = rnative.get_lib()
    rlib.morton_codes(q.ctypes.data_as(ctypes.c_void_p), len(q), d, nb,
                      ref.ctypes.data_as(ctypes.c_void_p))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _morton_codes(pts))


RUPPERT = {
    "square_25": (SQUARE, [], None, 25.0, 1e-3),
    "holes_22": (OUTLINE, [HOLE], [[1.5, 1.5]], 22.0, 0.05),
    "l_shape_retry": (L_OUTLINE, [], None, 20.0, 2e-4),   # > 8192 tris
    "kept_hole": (OUTLINE, [HOLE], None, 20.0, 0.1),      # no seed
}


@pytest.mark.parametrize("case", list(RUPPERT))
def test_triangulate_ruppert_matches_reference(core, case):
    outline, holes, seeds, angle, area = RUPPERT[case]
    pts = np.vstack([outline, *holes])
    segs, base = [], 0
    for loop in [outline, *holes]:
        n = len(loop)
        segs += [(base + i, base + (i + 1) % n) for i in range(n)]
        base += n
    seeds = None if seeds is None else np.asarray(seeds, np.float64)
    got = native.triangulate_ruppert(pts, np.asarray(segs), seeds, angle,
                                     area)
    ref = rnative.triangulate_ruppert(pts, np.asarray(segs), seeds, angle,
                                      area)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype == np.int64
    if case == "l_shape_retry":
        assert len(got[1]) > 8192


PSLG = {
    "quality_hole": dict(outline=OUTLINE, holes=[HOLE], target_area=0.05,
                         min_angle=22),
    "quality_slot": dict(outline=RECT, holes=[SLOT], target_area=0.02),
    "quality_l": dict(outline=L_OUTLINE, target_area=0.01, min_angle=25),
    "scipy_hole": dict(outline=OUTLINE, holes=[HOLE], target_area=0.05,
                       quality=False),
    "scipy_slot_seed": dict(outline=RECT, holes=[SLOT], target_area=0.02,
                            quality=False, seed=3, interior_jitter=0.2),
}


@pytest.mark.parametrize("case", list(PSLG))
def test_triangulate_pslg_matches_reference(core, case):
    got = tri.triangulate_pslg(**PSLG[case])
    ref = rtri.triangulate_pslg(**PSLG[case])
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    kw = PSLG[case]
    holes = kw.get("holes", [])
    kind, ent = tri.classify_pslg_entities(got[0], kw["outline"], holes)
    rkind, rent = rtri.classify_pslg_entities(ref[0], kw["outline"], holes)
    assert np.array_equal(kind, rkind) and np.array_equal(ent, rent)
    if kw.get("quality", True):
        # Ruppert keeps every input corner
        assert (kind == 0).sum() == len(kw["outline"]) + sum(map(len, holes))


def test_quality_falls_back_to_scipy_without_core(core, monkeypatch):
    """Without the core, ``quality=True`` takes the scipy path, as in the
    reference."""
    monkeypatch.setenv("MESHFEM_TORCH_NO_NATIVE", "1")
    assert tri.triangulate_pslg_quality(OUTLINE, [HOLE], 0.05) is None
    got = tri.triangulate_pslg(OUTLINE, holes=[HOLE], target_area=0.05)
    ref = tri.triangulate_pslg(OUTLINE, holes=[HOLE], target_area=0.05,
                               quality=False)
    assert np.array_equal(got[1], ref[1])


def _mesh_arrays(m):
    out = [m.elem_nodes, m.node_positions, m.cell.O, m.bdry_elems,
           m.bdry_elem_nodes, m.bdry_elem_vol_elem, m.bdry_nodes]
    out.append(m.cell.edges())
    return out


@pytest.mark.parametrize("shape", ["tri_9x7", "tet_4"])
def test_mesh_with_core_equals_mesh_without(core, monkeypatch, shape):
    V, F = rgen.grid_tri(9, 7) if shape == "tri_9x7" else \
        rgen.grid_tet(4, 4, 4)
    with_core = _mesh_arrays(FEMMesh(V, F, degree=2))
    monkeypatch.setenv("MESHFEM_TORCH_NO_NATIVE", "1")
    without = _mesh_arrays(FEMMesh(V, F, degree=2))
    for a, b in zip(with_core, without):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mesh_tools_import_no_jax():
    """Every module of the host tools imports neither JAX nor the
    reference package (``test_parallel_imports_no_jax``'s check)."""
    mods = ["native", "mesh.filters", "mesh.triangulate", "mesh.aabb",
            "mesh.collision_grid", "analysis.field_sampler",
            "io.edge_fields", "cli.mesh_convert", "cli.msh_processor",
            "cli.tools"]
    code = ("import sys\n"
            + "".join(f"import meshfem_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'meshfem_tpu')]; print(bad); "
              "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
