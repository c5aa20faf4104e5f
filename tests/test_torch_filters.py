"""The mesh filters of ``meshfem_tpu_torch.mesh.filters`` against
``meshfem_tpu.mesh.filters`` on the same seeded inputs: every public
function, on the cases of ``tests/test_filters_extra.py`` and
``tests/test_applications.py`` and a few more.  Integer arrays (element
tables, labels, loops) must be equal, floats within 1e-14."""

import numpy as np
import pytest

from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.mesh import filters as rfilters
from meshfem_tpu.mesh import generators as rgen

from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.mesh import filters


def same(a, b, path="out"):
    """Recursive equality: integer and boolean arrays exactly, floats to
    1e-14 relative to the array's largest magnitude."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
            assert float(np.abs(a - b).max(initial=0.0)) <= 1e-14 * scale, \
                path
        else:
            assert a.dtype.kind == b.dtype.kind, (path, a.dtype, b.dtype)
            assert np.array_equal(a, b), path


def quad_grid(nx, ny, w=1.0, h=1.0):
    xs = np.linspace(0, w, nx + 1)
    ys = np.linspace(0, h, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    V = np.stack([X.ravel(), Y.ravel()], axis=1)
    Q = np.asarray([[i * (ny + 1) + j, (i + 1) * (ny + 1) + j,
                     (i + 1) * (ny + 1) + j + 1, i * (ny + 1) + j + 1]
                    for i in range(nx) for j in range(ny)])
    return V, Q


def quad_ring(n=32):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    inner = np.stack([np.cos(th), np.sin(th)], axis=1)
    V = np.vstack([inner, 2.0 * inner])
    Q = np.asarray([[k, n + k, n + (k + 1) % n, (k + 1) % n]
                    for k in range(n)])
    return V, Q


def holed_grid(n=8):
    V, F = rgen.grid_tri(n, n)
    c = V[F].mean(axis=1)
    hole = ((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2) < 0.04
    V2, F2 = rfilters.remove_dangling_vertices(V, F[~hole])
    return V2, F2, c[~hole]


def void_tets(n=4):
    V, T = rgen.grid_tet(n, n, n)
    T = T[((V[T].mean(axis=1) - 0.5) ** 2).sum(axis=1) > 0.3 ** 2]
    return rfilters.remove_dangling_vertices(V, T)


def duplicated_grid():
    V, F = rgen.grid_tri(2, 2)
    return np.vstack([V, V + [10.0, 0.0]]), np.vstack([F, F + len(V)])


def flipped(V, F, seed):
    """Swap the last two corners of a seeded half of the elements."""
    F = np.array(F)
    flip = np.random.default_rng(seed).random(len(F)) < 0.5
    F[flip, -1], F[flip, -2] = F[flip, -2], F[flip, -1].copy()
    return V, F


def noisy_loop(seed, n=40):
    """A closed curve with seeded near-duplicates and collinear points."""
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(0, 2 * np.pi, n))
    P = np.stack([np.cos(th), 0.6 * np.sin(th)], axis=1)
    P = np.insert(P, 5, P[5] + 1e-9, axis=0)
    mid = 0.5 * (P[10] + P[11])
    return np.insert(P, 11, mid, axis=0)


def _merge_eps(f):
    V, F = rgen.grid_tri(2, 2)
    Vm = np.vstack([V, V[:1] + 1e-15])
    Fm = F.copy()
    Fm[0, 0] = len(V)
    return f.merge_duplicate_vertices(Vm, Fm, eps=1e-12)


def _high_aspect(f, V, Q, a=2.0):
    return f.quad_subdiv_high_aspect(V, Q, a)


def _high_aspect_iterated(f):
    """mesh_convert's loop: split until nothing splits."""
    V, Q = quad_ring(32)
    did, qi = True, None
    while did:
        V, Q, qi, did = f.quad_subdiv_high_aspect(V, Q, 1.75, qi)
    return V, Q, qi


CASES = {
    "merge_duplicate_vertices_eps": _merge_eps,
    "merge_duplicate_vertices_exact": lambda f: f.merge_duplicate_vertices(
        np.vstack([rgen.grid_tri(2, 2)[0]] * 2), duplicated_grid()[1]),
    "remove_dangling_vertices": lambda f: f.remove_dangling_vertices(
        *rgen.grid_tri(4, 4)[:1], rgen.grid_tri(4, 4)[1][::3]),
    "reorient_tri2d": lambda f: f.reorient_negative_elements(
        *flipped(*rgen.grid_tri(4, 3), seed=1)),
    "reorient_tet": lambda f: f.reorient_negative_elements(
        *flipped(*rgen.grid_tet(2, 2, 2), seed=2)),
    "reorient_surface": lambda f: f.reorient_negative_elements(
        np.column_stack([rgen.grid_tri(2, 2)[0], np.zeros(9)]),
        rgen.grid_tri(2, 2)[1]),
    "get_element_components": lambda f: f.get_element_components(
        duplicated_grid()[1]),
    "remove_small_components": lambda f: f.remove_small_components(
        *duplicated_grid()),
    "remove_small_components_min": lambda f: f.remove_small_components(
        *duplicated_grid(), min_elems=4),
    "subdivide_tri": lambda f: f.subdivide(*rgen.grid_tri(2, 2),
                                           iterations=2),
    "subdivide_tet": lambda f: f.subdivide(*rgen.grid_tet(1, 1, 1)),
    "subdivide_tet_perturbed": lambda f: f.subdivide(
        rgen.grid_tet(2, 2, 2)[0] + 0.05 * np.random.default_rng(3)
        .standard_normal((27, 3)), rgen.grid_tet(2, 2, 2)[1]),
    "reflect_tri": lambda f: f.reflect(*rgen.grid_tri(2, 2,
                                                      hi=(0.5, 0.5))),
    "reflect_tri_x": lambda f: f.reflect(*rgen.grid_tri(3, 2), axes=[0]),
    "reflect_tet": lambda f: f.reflect(*rgen.grid_tet(2, 2, 2)),
    "extrude": lambda f: f.extrude(*rgen.grid_tri(2, 2), height=2.0,
                                   layers=2),
    "voxels_to_simplices": lambda f: f.voxels_to_simplices(
        np.random.default_rng(4).random((3, 3, 2)) < 0.5),
    "quad_tri_split_diagonal": lambda f: f.quad_tri_split_diagonal(
        quad_grid(3, 2)[0] + 0.1 * np.random.default_rng(5)
        .standard_normal((12, 2)), quad_grid(3, 2)[1]),
    "hex_tet_subdiv": lambda f: f.hex_tet_subdiv(
        np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                  for x in (0, 1)], dtype=float),
        np.array([[0, 1, 2, 3, 4, 5, 6, 7]])),
    "highlight_dangling_vertices": lambda f: f.highlight_dangling_vertices(
        *rgen.grid_tri(4, 4)[:1], rgen.grid_tri(4, 4)[1][::3]),
    "resample_curve_closed": lambda f: f.resample_curve(noisy_loop(6), 0.1),
    "resample_curve_open": lambda f: f.resample_curve(noisy_loop(6), 0.07,
                                                      closed=False),
    "curve_cleanup_closed": lambda f: f.curve_cleanup(noisy_loop(7),
                                                      min_len=1e-6),
    "curve_cleanup_open": lambda f: f.curve_cleanup(noisy_loop(7),
                                                    closed=False),
    "quad_subdiv": lambda f: f.quad_subdiv(*quad_grid(2, 3)),
    "quad_tri_subdiv": lambda f: f.quad_tri_subdiv(*quad_grid(2, 2)),
    "quad_tri_subdiv_asymmetric": lambda f: f.quad_tri_subdiv_asymmetric(
        *quad_grid(2, 2)),
    "quad_subdiv_high_aspect_ring": lambda f: _high_aspect(
        f, *quad_ring()),
    "quad_subdiv_high_aspect_lone": lambda f: _high_aspect(
        f, np.asarray([[0, 0], [3, 0], [3, 1], [0, 1.0]]),
        np.asarray([[0, 1, 2, 3]])),
    "quad_subdiv_high_aspect_iterated": _high_aspect_iterated,
    "extract_hole_boundaries_tri": lambda f: f.extract_hole_boundaries(
        *holed_grid()[:2]),
    "extract_hole_boundaries_tet": lambda f: f.extract_hole_boundaries(
        *void_tets()),
    "extract_component_polygons": lambda f: f.extract_component_polygons(
        *holed_grid()[:2], np.zeros(len(holed_grid()[1]), dtype=int)),
    "extract_component_polygons_two": lambda f: (
        f.extract_component_polygons(
            *holed_grid()[:2], (holed_grid()[2][:, 0] > 0.5).astype(int))),
    "extract_component_polygons_skip": lambda f: (
        f.extract_component_polygons(
            *holed_grid()[:2],
            np.where(holed_grid()[2][:, 0] > 0.5, -1, 0))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_filter_matches_reference(case):
    same(CASES[case](filters), CASES[case](rfilters))


def test_extract_boundary_polygons_matches_reference():
    V, F, _ = holed_grid()
    got = filters.extract_boundary_polygons(FEMMesh(V, F))
    ref = rfilters.extract_boundary_polygons(RFEMMesh(V, F))
    same(got, ref)
    assert len(got) == 2


@pytest.mark.parametrize("call", [
    lambda f: f.quad_subdiv_high_aspect(*quad_ring(), 1.4),
    lambda f: f.extract_hole_boundaries(*duplicated_grid()),
    lambda f: f.extract_component_polygons(
        *rgen.grid_tri(2, 2), np.zeros(3, dtype=int)),
], ids=["aspect_threshold", "two_outer_components", "indicator_length"])
def test_filter_errors_match_reference(call):
    """The reference's ValueErrors, raised alike."""
    with pytest.raises(ValueError) as ref:
        call(rfilters)
    with pytest.raises(ValueError) as got:
        call(filters)
    assert str(got.value) == str(ref.value)
