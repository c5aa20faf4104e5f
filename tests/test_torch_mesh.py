"""meshfem_tpu_torch mesh layer == meshfem_tpu: generators, P2 node
numbering (exactly equal, whether the reference numbers edges through its
native host core or its numpy fallback), simplex geometry (1e-12), the RCB
order (exactly equal) and a triangle mesh (the 2D mesh layer's own tests
are in ``test_torch_tri.py``)."""

import numpy as np
import pytest
import torch

import meshfem_tpu.native as rnative
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.mesh.geometry import simplex_geometry as r_simplex_geometry
from meshfem_tpu.mesh.reorder import rcb_order as r_rcb_order

from meshfem_tpu_torch.mesh import FEMMesh, generators as tgen
from meshfem_tpu_torch.mesh.geometry import simplex_geometry
from meshfem_tpu_torch.mesh.reorder import rcb_order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MESHES = [("grid", (3, 3, 3)), ("grid", (4, 4, 4)), ("grid", (2, 3, 4)),
          ("bar", (6, 2, 2))]


def _gen(mod, kind, size):
    return mod.grid_tet(*size) if kind == "grid" else mod.bar_tet(*size)


@pytest.mark.parametrize("kind,size", MESHES)
def test_generators_equal(kind, size):
    V0, T0 = _gen(rgen, kind, size)
    V1, T1 = _gen(tgen, kind, size)
    np.testing.assert_array_equal(V1, V0)
    np.testing.assert_array_equal(T1, T0)
    assert T1.dtype == T0.dtype


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind,size", MESHES)
@pytest.mark.parametrize("degree", [1, 2])
def test_femmesh_numbering_equal(kind, size, degree, native, monkeypatch):
    if not native:   # force the reference onto its numpy fallbacks
        monkeypatch.setattr(rnative, "unique_edges", lambda pairs: None)
        monkeypatch.setattr(rnative, "match_faces", lambda fv: None)
    V, T = _gen(rgen, kind, size)
    ref = RFEMMesh(V, T, degree=degree)
    port = FEMMesh(V, T, degree=degree)
    np.testing.assert_array_equal(port.elem_nodes, ref.elem_nodes)
    np.testing.assert_array_equal(port.node_positions, ref.node_positions)
    np.testing.assert_array_equal(port.bdry_elems, ref.bdry_elems)
    np.testing.assert_array_equal(port.bdry_elem_nodes, ref.bdry_elem_nodes)
    np.testing.assert_array_equal(port.bdry_nodes, ref.bdry_nodes)
    assert port.num_nodes == ref.num_nodes


@pytest.mark.parametrize("kind,size", MESHES)
def test_simplex_geometry(kind, size):
    V, T = _gen(rgen, kind, size)
    rng = np.random.default_rng(3)
    V = V + 0.05 * rng.standard_normal(V.shape)     # non-uniform elements
    g0, v0 = r_simplex_geometry(V[T], 3)
    g1, v1 = simplex_geometry(torch.as_tensor(V[T]), 3)
    g0, v0 = np.asarray(g0), np.asarray(v0)
    assert np.abs(g1.numpy() - g0).max() <= 1e-12 * np.abs(g0).max()
    assert np.abs(v1.numpy() - v0).max() <= 1e-12 * np.abs(v0).max()


def test_femmesh_geometry_matches_reference():
    V, T = rgen.grid_tet(3, 3, 3)
    ref = RFEMMesh(V, T, degree=2).geometry()
    port = FEMMesh(V, T, degree=2).geometry("cpu")
    g0 = np.asarray(ref.grad_lambda)
    assert np.abs(port.grad_lambda.numpy() - g0).max() \
        <= 1e-12 * np.abs(g0).max()
    np.testing.assert_allclose(port.volume.numpy(), np.asarray(ref.volume),
                               rtol=1e-12)


@pytest.mark.parametrize("n,leaf", [(1000, 128), (5000, 128), (777, 16)])
def test_rcb_order_random_points(n, leaf):
    pts = np.random.default_rng(n).random((n, 3))
    np.testing.assert_array_equal(rcb_order(pts, leaf), r_rcb_order(pts, leaf))


def test_rcb_order_grid_centroids():
    """Ties everywhere: Kuhn-grid P2 node positions and element centroids."""
    V, T = rgen.grid_tet(6, 6, 6)
    mesh = RFEMMesh(V, T, degree=2)
    cent = mesh.node_positions[mesh.elem_nodes].mean(axis=1)
    np.testing.assert_array_equal(rcb_order(cent), r_rcb_order(cent))
    np.testing.assert_array_equal(rcb_order(mesh.node_positions),
                                  r_rcb_order(mesh.node_positions))


def test_femmesh_rejects_triangles():
    """A triangle mesh now builds (the port refused one before it carried
    K = 2) and matches the reference's FEMMesh: numbering equal, geometry
    to 1e-14."""
    V, F = rgen.grid_tri(2, 2)
    for degree in (1, 2):
        ref, port = RFEMMesh(V, F, degree=degree), FEMMesh(V, F,
                                                           degree=degree)
        for k in ("elem_nodes", "node_positions", "bdry_elems",
                  "bdry_elem_nodes", "bdry_nodes"):
            np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
        g, rg = port.geometry("cpu"), ref.geometry()
        for k in ("grad_lambda", "volume", "bdry_normal", "bdry_volume"):
            assert np.abs(getattr(g, k).numpy()
                          - np.asarray(getattr(rg, k))).max() <= 1e-14
