"""The port's host queries against the reference's on the same seeded
inputs: ``mesh.aabb.AABBTree`` (closest points and ray hits, the cases of
``tests/test_aabb.py``), ``mesh.collision_grid``'s two grids,
``analysis.field_sampler.FieldSampler`` (the case of
``tests/test_applications.py::test_field_sampler`` and a P2 tet mesh; the
port samples on the field tensor's device) and ``io.edge_fields``."""

import json

import numpy as np
import pytest
import torch

from meshfem_tpu.analysis.field_sampler import FieldSampler as RSampler
from meshfem_tpu.io import edge_fields as redge
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.mesh import filters as rfilters
from meshfem_tpu.mesh import generators as rgen
from meshfem_tpu.mesh.aabb import AABBTree as RTree
from meshfem_tpu.mesh.collision_grid import (
    CollisionGrid as RGrid, DenseCollisionGrid as RDense)

from meshfem_tpu_torch.analysis.field_sampler import FieldSampler
from meshfem_tpu_torch.io import edge_fields
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.mesh.aabb import AABBTree
from meshfem_tpu_torch.mesh.collision_grid import (CollisionGrid,
                                                   DenseCollisionGrid)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _holed_tri(n=5):
    V, F = rgen.grid_tri(n, n)
    c = V[F].mean(axis=1)
    return V, F[~(((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2) < 0.05)]


def _cube_surface(n=4):
    V, T = rgen.grid_tet(n, n, n)
    bf = np.asarray(FEMMesh(V, T).bdry_elems)
    return rfilters.remove_dangling_vertices(V, bf)


TREES = {
    "tri_2d": (_holed_tri, lambda r: r.uniform(-0.3, 1.3, (25, 2))),
    "tet_3d": (lambda: rgen.grid_tet(3, 3, 3),
               lambda r: r.uniform(-0.2, 1.2, (15, 3))),
    "surface_3d": (_cube_surface, lambda r: r.uniform(-0.3, 1.3, (20, 3))),
}


@pytest.mark.parametrize("case", list(TREES))
def test_aabb_closest_points_match_reference(case):
    mesh, pts = TREES[case]
    V, F = mesh()
    P = pts(np.random.default_rng(0))
    tree, rtree = AABBTree(V, F, leaf_size=4), RTree(V, F, leaf_size=4)
    for name in ("nodes_lo", "nodes_hi", "left", "right", "start", "count",
                 "order"):
        assert np.array_equal(getattr(tree, name), getattr(rtree, name))
    got, ref = tree.closest_points(P), rtree.closest_points(P)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    e, q, d2 = tree.closest_point(P[0])
    assert (e, d2) == rtree.closest_point(P[0])[::2]


def test_aabb_ray_intersect_matches_reference():
    Vs, Fs = _cube_surface()
    tree, rtree = AABBTree(Vs, Fs), RTree(Vs, Fs)
    rng = np.random.default_rng(2)
    rays = [([-1.0, 0.4, 0.6], [1.0, 0.0, 0.0]),
            ([-1.0, 2.5, 0.5], [1.0, 0.0, 0.0])]
    for _ in range(10):
        o = np.asarray([-0.5, 0, 0]) + rng.uniform(0, 1, 3) * [0, 1, 1]
        rays.append((o, [1.0, 0, 0] + 0.2 * rng.standard_normal(3)))
    hits = 0
    for o, d in rays:
        got, ref = tree.ray_intersect(o, d), rtree.ray_intersect(o, d)
        assert (got is None) == (ref is None)
        if got is not None:
            hits += 1
            assert got[:2] == ref[:2] and got[2] == ref[2]
    assert 0 < hits < len(rays)
    with pytest.raises(ValueError):
        AABBTree(*rgen.grid_tet(1, 1, 1)).ray_intersect([0, 0, 0], [1, 0, 0])


@pytest.mark.parametrize("dim", [2, 3])
def test_collision_grid_matches_reference(dim):
    rng = np.random.default_rng(dim)
    P = rng.random((200, dim))
    Q = np.vstack([P[::7] + 1e-10, rng.random((20, dim)),
                   [[5.0] * dim]])
    grid, rgrid = CollisionGrid(P), RGrid(P)
    assert grid.h == rgrid.h and np.array_equal(grid._sorted, rgrid._sorted)
    for q in Q:
        assert grid.closest_point(q) == rgrid.closest_point(q)
        assert grid.closest_point(q, max_dist=0.05) == \
            rgrid.closest_point(q, max_dist=0.05)
    assert np.array_equal(grid.match_points(Q, 1e-8),
                          rgrid.match_points(Q, 1e-8))
    assert (grid.match_points(Q, 1e-8) >= 0).sum() == len(P[::7])


def test_dense_collision_grid_matches_reference():
    V, T = rgen.grid_tet(3, 3, 3)
    X = V[T]
    lo, hi = X.min(axis=1), X.max(axis=1)
    grid, rgrid = DenseCollisionGrid(lo, hi, 6), RDense(lo, hi, 6)
    assert dict(grid.buckets) == dict(rgrid.buckets)
    for q in np.random.default_rng(5).uniform(-0.1, 1.1, (30, 3)):
        assert np.array_equal(grid.candidates(q), rgrid.candidates(q))


SAMPLERS = {
    "tri6_p2": (lambda: rgen.grid_tri(6, 6), 2,
                lambda r: r.uniform(0.05, 0.95, (20, 2))),
    "tet3_p2": (lambda: rgen.grid_tet(3, 3, 3), 2,
                lambda r: r.uniform(0.05, 0.95, (20, 3))),
    "holed_tri_p1": (_holed_tri, 1,
                     lambda r: r.uniform(-0.2, 1.2, (30, 2))),
}


@pytest.fixture(scope="module", params=list(SAMPLERS))
def samplers(request):
    mesh, deg, pts = SAMPLERS[request.param]
    V, F = mesh()
    pmesh = FEMMesh(V, F, degree=deg)
    return (FieldSampler(pmesh), RSampler(RFEMMesh(V, F, degree=deg)),
            pmesh, pts(np.random.default_rng(0)))


def test_field_sampler_locate_matches_reference(samplers):
    fs, rfs, _, q = samplers
    assert fs.buckets.keys() == rfs.buckets.keys()
    assert all(np.array_equal(fs.buckets[k], rfs.buckets[k])
               for k in fs.buckets)
    e, b = fs.locate(q)
    re_, rb = rfs.locate(q)
    assert np.array_equal(e, re_) and np.array_equal(b, rb)


def test_field_sampler_samples_match_reference(samplers):
    fs, rfs, pmesh, q = samplers
    X = pmesh.node_positions
    rng = np.random.default_rng(1)
    f = X[:, 0] ** 2 - X[:, 1]                 # in the P2 space
    fv = np.stack([f, rng.standard_normal(len(X))], axis=1)
    for field in (f, fv):
        got = fs.sample_nodal(torch.as_tensor(field), q)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), rfs.sample_nodal(field, q),
                                   rtol=0, atol=1e-14)
    if pmesh.degree == 2 and pmesh.dim == 2:
        np.testing.assert_allclose(
            fs.sample_nodal(torch.as_tensor(f), q).numpy(),
            q[:, 0] ** 2 - q[:, 1], atol=1e-12)
    S, rS = fs.sample_matrix(q), rfs.sample_matrix(q)
    assert (S != rS).nnz == 0
    np.testing.assert_allclose(S @ f, fs.sample_nodal(f, q, "cpu").numpy(),
                               atol=1e-13)
    ef = rng.standard_normal((pmesh.num_elements, 3))
    assert np.array_equal(fs.sample_element(torch.as_tensor(ef), q).numpy(),
                          rfs.sample_element(ef, q))


@pytest.mark.parametrize("entry", ["sample_nodal", "sample_element"])
def test_numpy_input_goes_to_the_default_device(entry):
    """An array lands on the CUDA device, or raises where there is none;
    ``device="cpu"`` and a CPU tensor stay on the host."""
    V, F = rgen.grid_tri(3, 3)
    fs = FieldSampler(FEMMesh(V, F, degree=2))
    n = fs.mesh.num_nodes if entry == "sample_nodal" else len(F)
    field = np.arange(n, dtype=np.float64)
    q = np.asarray([[0.3, 0.4], [0.9, 0.1]])
    sample = getattr(fs, entry)
    if torch.cuda.is_available():
        assert sample(field, q).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sample(field, q)
    assert sample(field, q, device="cpu").device.type == "cpu"
    assert sample(torch.as_tensor(field), q).device.type == "cpu"


def test_edge_fields_round_trip(tmp_path):
    V, F = rgen.grid_tri(3, 3)
    edges = FEMMesh(V, F).cell.edges()
    rng = np.random.default_rng(0)
    ef = edge_fields.EdgeFields(edges)
    ef.add_field("length", np.linalg.norm(V[edges[:, 0]] - V[edges[:, 1]],
                                          axis=1))
    ef.add_field("noise", rng.standard_normal(len(edges)))
    with pytest.raises(ValueError):
        ef.add_field("short", np.zeros(3))
    ef.save(tmp_path / "t.txt")
    ref = redge.EdgeFields(edges)
    ref.fields = dict(ef.fields)
    ref.save(tmp_path / "r.txt")
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "r.txt").read_text()
    back = edge_fields.EdgeFields.load(tmp_path / "r.txt")
    assert np.array_equal(back.edges, edges)
    assert all(np.array_equal(back.fields[k], ef.fields[k])
               for k in ef.fields)


@pytest.mark.parametrize("suffix", [".json", ".js"])
def test_write_js_fields_matches_reference(tmp_path, suffix):
    V, F = rgen.grid_tri(2, 2)
    fields = {"x": V[:, 0], "u": np.random.default_rng(0).random((9, 2))}
    edge_fields.write_js_fields(tmp_path / f"t{suffix}", FEMMesh(V, F),
                                fields)
    redge.write_js_fields(tmp_path / f"r{suffix}", RFEMMesh(V, F), fields)
    text = (tmp_path / f"t{suffix}").read_text()
    assert text == (tmp_path / f"r{suffix}").read_text()
    if suffix == ".json":
        assert json.loads(text)["elements"] == F.tolist()
