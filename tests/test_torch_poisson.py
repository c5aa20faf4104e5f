"""Scalar Poisson, the discrete operators and geodesics in heat of the port
against meshfem_tpu, on the CPU in float64.

The same seeded numpy inputs go through both packages:

* the element tables ``mass_table``, ``element_mass(_lumped)`` and
  ``element_laplacian`` for K = 2, 3 and degree 1, 2 (1e-14 relative);
* ``FEMMesh.geometry(node_positions=)``, ``sparse.assembly``'s applies and
  ``scatter_load``, and every ``ops.operators`` function, at the stored and
  at perturbed node positions (1e-12 of max);
* ``ops.extra_operators``: ``boundary_laplacian`` (edges in 2D, triangles
  in 3D, with and without the cell faces), ``uniform_laplacian``,
  ``perturb_mesh`` and ``GridFunction`` (``sample`` inside, on the edge
  and outside the grid);
* ``PoissonProblem``: solves with scalar and per-node Dirichlet values, a
  callable and a nodal source, Neumann loads, ``average_gradient`` and
  ``energy`` (1e-10), and ``geodesic_distances`` on grid_tri(16) with
  equal CG iteration counts in both solves.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.analysis import geodesics as rgeo
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.ops import element_matrices as rem
from meshfem_tpu.ops import extra_operators as rext, operators as rops
from meshfem_tpu.physics import PoissonProblem as RPoisson
from meshfem_tpu.solvers import cg as rcg
from meshfem_tpu.sparse import assembly as rasm

from meshfem_tpu_torch.analysis import geodesics as tgeo
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.ops import element_matrices as tem
from meshfem_tpu_torch.ops import extra_operators as text, operators as tops
from meshfem_tpu_torch.physics import PoissonProblem
from meshfem_tpu_torch.solvers import cg as tcg
from meshfem_tpu_torch.sparse import assembly as tasm

CPU = torch.device("cpu")
MESHES = ("tri1", "tri2", "tet1", "tet2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    """name -> (reference FEMMesh, port FEMMesh, perturbed node positions)."""
    out = {}
    rng = np.random.default_rng(11)
    for name in MESHES:
        if name.startswith("tri"):
            V, F = rgen.grid_tri(16, 16)      # geodesics' mesh too
        else:
            V, F = rgen.grid_tet(2, 3, 2)
        deg = int(name[-1])
        rm, tm = RFEMMesh(V, F, degree=deg), FEMMesh(V, F, degree=deg)
        X = rm.node_positions
        X = X + 0.01 * rng.uniform(-1, 1, X.shape)
        out[name] = (rm, tm, X)
    return out


def close(a, b, rel, what="", scale=0.0):
    """max|a - b| <= rel * max(max|b|, scale)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    # non-finite entries (the P2 lumped mass has zero vertex weights on
    # triangles, so the bilaplacian's inverse is not finite) must sit in
    # the same places; inf or nan there depends on the summation order
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), what
    a, b = a[fin], b[fin]
    scale = max(float(np.abs(b).max(initial=0.0)), scale, 1e-300)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= rel * scale, (what, err, scale)


# -- element tables ------------------------------------------------------

@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("deg", [1, 2])
@pytest.mark.parametrize("fn", ["mass_table", "element_mass",
                                "element_mass_lumped", "element_laplacian"])
def test_element_tables(K, deg, fn):
    rng = np.random.default_rng(K * 10 + deg)
    E, dim = 7, K
    g = rng.normal(size=(E, K + 1, dim))
    vol = rng.uniform(0.5, 2.0, E)
    if fn == "mass_table":
        ref, out = rem.mass_table(K, deg), tem.mass_table(K, deg)
    elif fn == "element_laplacian":
        ref = rem.element_laplacian(jnp.asarray(g), jnp.asarray(vol), deg)
        out = tem.element_laplacian(torch.as_tensor(g), torch.as_tensor(vol),
                                    deg)
    else:
        ref = getattr(rem, fn)(jnp.asarray(vol), K, deg)
        out = getattr(tem, fn)(torch.as_tensor(vol), K, deg)
    close(out, ref, 1e-14, fn)


# -- geometry and assembly -------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("perturbed", [False, True])
def test_geometry_node_positions(meshes, name, perturbed):
    rm, tm, X = meshes[name]
    rg = rm.geometry(X if perturbed else None)
    tg = tm.geometry(CPU, node_positions=X if perturbed else None)
    for field in ("grad_lambda", "volume", "bdry_normal", "bdry_volume"):
        close(getattr(tg, field), getattr(rg, field), 1e-14, field)
    if perturbed:
        # a node_positions tensor carries its device
        tg2 = tm.geometry(node_positions=torch.as_tensor(X))
        assert torch.equal(tg2.volume, tg.volume)


@pytest.mark.parametrize("name", ["tet1"])
def test_assembly(meshes, name):
    rm, tm, _ = meshes[name]
    rng = np.random.default_rng(5)
    E, n = rm.elem_nodes.shape
    N = rm.num_nodes
    A = rng.normal(size=(E, n, n))
    Ke = A + A.transpose(0, 2, 1)
    d = rm.dim
    B = rng.normal(size=(E, n * d, n * d))
    Kv = B + B.transpose(0, 2, 1)
    en = rm.elem_nodes
    u, um, uv = (rng.normal(size=(N,)), rng.normal(size=(N, 3)),
                 rng.normal(size=(N, d)))
    fe, fev = rng.normal(size=(E, n)), rng.normal(size=(E, n, d))
    T = torch.as_tensor
    pairs = [
        (tasm.ebe_apply(T(Ke), en, T(u), N),
         rasm.ebe_apply(jnp.asarray(Ke), jnp.asarray(en), jnp.asarray(u), N)),
        (tasm.ebe_apply(T(Ke), en, T(um), N),
         rasm.ebe_apply(jnp.asarray(Ke), jnp.asarray(en), jnp.asarray(um),
                        N)),
        (tasm.ebe_apply_vector(T(Kv), en, T(uv), N),
         rasm.ebe_apply_vector(jnp.asarray(Kv), jnp.asarray(en),
                               jnp.asarray(uv), N)),
        (tasm.ebe_diagonal(T(Ke), en, N),
         rasm.ebe_diagonal(jnp.asarray(Ke), jnp.asarray(en), N)),
        (tasm.ebe_diagonal(T(Kv), T(en), N, d),
         rasm.ebe_diagonal(jnp.asarray(Kv), jnp.asarray(en), N, d)),
        (tasm.scatter_load(T(fe), en, N), rasm.scatter_load(fe, en, N)),
        (tasm.scatter_load(T(fev), en, N), rasm.scatter_load(fev, en, N)),
    ]
    for i, (out, ref) in enumerate(pairs):
        close(out, ref, 1e-12, i)


# -- operators -------------------------------------------------------------

OPS = ("laplacian", "laplacian_diagonal", "laplacian_scipy", "mass",
       "mass_lumped", "mass_elasticity", "gradient", "divergence",
       "bilaplacian_apply")


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("perturbed", [False, True])
def test_operators(meshes, name, op, perturbed):
    rm, tm, X = meshes[name]
    P = X if perturbed else None
    rng = np.random.default_rng(OPS.index(op))
    N, E, d = rm.num_nodes, rm.num_elements, rm.dim
    u = rng.normal(size=N)
    if op.startswith("laplacian"):
        r, t = rops.laplacian(rm, P), tops.laplacian(tm, P, device=CPU)
        assert t.shape == r.shape == (N, N)
        if op == "laplacian":
            out, ref = t(torch.as_tensor(u)), r(jnp.asarray(u))
        elif op == "laplacian_diagonal":
            out, ref = t.diagonal(), r.diagonal()
        else:
            out, ref = t.to_scipy().toarray(), r.to_scipy().toarray()
    elif op == "mass":
        r, t = rops.mass(rm, node_positions=P), tops.mass(
            tm, node_positions=P, device=CPU)
        out, ref = t(torch.as_tensor(u)), r(jnp.asarray(u))
    elif op == "mass_lumped":
        ref = rops.mass(rm, lumped=True, node_positions=P)
        out = tops.mass(tm, lumped=True, node_positions=P, device=CPU)
    elif op == "mass_elasticity":
        r = rops.mass_elasticity(rm, P)
        t = tops.mass_elasticity(tm, P, device=CPU)
        assert t.shape == r.shape == (N * d, N * d)
        v = rng.normal(size=(N, d))
        out, ref = t(torch.as_tensor(v)), r(jnp.asarray(v))
    elif op == "gradient":
        out = tops.gradient(tm, torch.as_tensor(u), P)
        ref = rops.gradient(rm, jnp.asarray(u), P)
    elif op == "divergence":
        Xe = rng.normal(size=(E, d))
        out = tops.divergence(tm, torch.as_tensor(Xe), P)
        ref = rops.divergence(rm, jnp.asarray(Xe), P)
    else:
        out = tops.bilaplacian_apply(tm, P, device=CPU)(torch.as_tensor(u))
        ref = rops.bilaplacian_apply(rm, P)(jnp.asarray(u))
    close(out, ref, 1e-12, op)


# -- extra operators -------------------------------------------------------

@pytest.mark.parametrize("name,exclude", [
    ("tri1", False), ("tri2", False), ("tet1", False), ("tet2", False),
    ("lshape", True)])
def test_boundary_laplacian(meshes, name, exclude):
    """Edges in 2D and triangles in 3D; with the cell faces excluded on an
    L-shaped domain (its re-entrant edges lie on no face of the bounding
    box, the others do) and on a box (every boundary element lies on a
    face: an empty operator)."""
    if name == "lshape":
        V, F = rgen.l_shape(4)
        rm, tm = RFEMMesh(V, F, degree=2), FEMMesh(V, F, degree=2)
        empty = text.boundary_laplacian(meshes["tet2"][1],
                                        exclude_cell_faces=True, device=CPU)
        assert empty.Ke.shape[0] == 0
        zero = empty(torch.ones(meshes["tet2"][1].num_nodes,
                                dtype=torch.float64))
        assert zero.shape == (meshes["tet2"][1].num_nodes,)
        assert not bool(zero.any())
    else:
        rm, tm, _ = meshes[name]
    r = rext.boundary_laplacian(rm, exclude_cell_faces=exclude)
    t = text.boundary_laplacian(tm, exclude_cell_faces=exclude, device=CPU)
    assert t.Ke.shape == r.Ke.shape
    assert 0 < t.Ke.shape[0] <= rm.num_boundary_elements
    assert (t.Ke.shape[0] < rm.num_boundary_elements) == exclude
    close(t.Ke, r.Ke, 1e-14)
    u = np.random.default_rng(3).normal(size=rm.num_nodes)
    close(t(torch.as_tensor(u)), r(jnp.asarray(u)), 1e-12)
    close(t.diagonal(), r.diagonal(), 1e-12)
    close(t.to_scipy().toarray(), r.to_scipy().toarray(), 1e-12)


@pytest.mark.parametrize("name", ["tri1", "tet1"])
def test_uniform_laplacian_and_perturb_mesh(meshes, name):
    rm, tm, _ = meshes[name]
    edges = rm.cell.edges()
    assert np.array_equal(edges, tm.cell.edges())
    r = rext.uniform_laplacian(rm.V, edges)
    t = text.uniform_laplacian(tm.V, edges)
    assert np.array_equal(r.toarray(), t.toarray())
    bv = rm.cell.boundary_vertices()
    vel = np.random.default_rng(2).normal(size=(len(bv), rm.dim)) * 0.05
    close(text.perturb_mesh(tm, vel, 0.5), rext.perturb_mesh(rm, vel, 0.5),
          1e-14)


@pytest.mark.parametrize("shape", [(7, 5), (4, 5, 6)])
def test_grid_function(shape):
    rng = np.random.default_rng(len(shape))
    v = rng.normal(size=shape)
    h = 0.25
    r, t = rext.GridFunction(v, h), text.GridFunction(v, h, device=CPU)
    close(t.laplacian(), r.laplacian(), 1e-14)
    close(t.smoothed(3, 0.3).values, r.smoothed(3, 0.3).values, 1e-14)
    size = np.asarray(shape, dtype=float) - 1
    inside = rng.uniform(0.1, 0.9, (9, len(shape))) * size
    edge = rng.uniform(0, 1, (len(shape), len(shape))) * size
    edge[np.arange(len(shape)), np.arange(len(shape))] = \
        size                                      # on the far faces
    near = inside.copy()
    near[:, 0] = size[0] - 0.3                    # the last half cell
    outside = inside.copy()
    outside[:3, 0] = [-0.5, size[0] + 0.5, size[0] + 3.0]
    outside[3:5, -1] = [-2.0, -0.01]
    for pts in (inside, edge, near, outside):
        out = t.sample(torch.as_tensor(pts * h))
        ref = r.sample(jnp.asarray(pts * h))
        close(out, ref, 1e-14)
    # a point past the last grid line blends toward 0 (constant mode)
    past = np.zeros((1, len(shape)))
    past[0, 0] = size[0] + 0.5
    past = torch.as_tensor(past * h)
    assert abs(float(t.sample(past)[0])
               - 0.5 * float(v[(-1,) + (0,) * (len(shape) - 1)])) < 1e-14


# -- PoissonProblem and geodesics ------------------------------------------

@pytest.fixture(scope="module")
def problems(meshes):
    """name -> (reference PoissonProblem, port PoissonProblem)."""
    return {name: (RPoisson(rm), PoissonProblem(tm, device=CPU))
            for name, (rm, tm, _) in meshes.items()}


def _quadratic(X):
    c = np.array([1.0, -2.0, 1.5])[:X.shape[1]]
    return (X ** 2) @ c, -2.0 * c.sum()


SOLVES = [("tri1", "scalar"), ("tri2", "per_node"), ("tet2", "neumann")]


@pytest.mark.parametrize("name,case", SOLVES)
def test_poisson_solve(meshes, problems, name, case):
    rm, tm, _ = meshes[name]
    rp, tp = problems[name]
    X = rm.node_positions
    bn = rm.bdry_nodes
    kw = dict(tol=1e-13)
    if case == "scalar":                   # a callable source
        args = (bn, 0.5)
        kw["source"] = lambda x: 1.0 + x[0]
    elif case == "per_node":               # values as a list, nodal source
        exact, f = _quadratic(X)
        args = (bn, list(exact[bn]))
        kw["source"] = np.full(rm.num_nodes, f)
    else:
        # Dirichlet on the x = 0 face, a flux on the rest of the boundary
        box = (np.zeros(rm.dim), np.r_[0.0, np.full(rm.dim - 1, 10.0)])
        left = rm.nodes_in_box(*box)
        be = np.setdiff1d(np.arange(rm.num_boundary_elements),
                          rm.boundary_elems_in_box(*box))
        flux = np.random.default_rng(9).normal(size=len(be))
        rload = rp.neumann_load(jnp.asarray(flux), be)
        tload = tp.neumann_load(flux, be)
        close(tload, rload, 1e-12, "neumann_load")
        close(tp.neumann_load(list(np.ones(rm.num_boundary_elements))),
              rp.neumann_load(jnp.ones(rm.num_boundary_elements)), 1e-12)
        args = (left, 0.25)
        kw.update(extra_load=tload, source=lambda x: np.cos(3 * x[0]) * x[1])
    rkw = dict(kw, extra_load=rload) if case == "neumann" else kw
    ru, rres = rp.solve(*args, **rkw)
    tu, tres = tp.solve(*args, **kw)
    close(tu, ru, 1e-10, "u")
    assert abs(tres.iters - int(rres.iters)) <= 2
    umax = float(np.abs(np.asarray(ru)).max())
    close(tp.average_gradient(tu), rp.average_gradient(ru), 1e-10,
          scale=umax)
    close(tp.gradient(tu), rp.gradient(ru), 1e-10, scale=umax)
    close(tp.energy(tu), rp.energy(ru), 1e-10)
    if case == "per_node" and rm.degree == 2:
        close(tu, exact, 1e-10, "P2 reproduces the quadratic")


def test_poisson_load_from_source(meshes, problems):
    rm, _, _ = meshes["tet2"]
    rp, tp = problems["tet2"]
    f = np.random.default_rng(1).normal(size=rm.num_nodes)
    close(tp.load_from_source(f), rp.load_from_source(f), 1e-12)
    close(tp.load_from_source(torch.as_tensor(f)),
          rp.load_from_source(jnp.asarray(f)), 1e-12)
    g = lambda x: x[0] * x[1] - x[2]
    close(tp.load_from_source(g), rp.load_from_source(g), 1e-12)


def test_poisson_perturbed_gradient(meshes):
    """At perturbed node positions the port's gradient reads those
    positions: a linear field of them has its exact gradient.  The
    reference's ``PoissonProblem.gradient`` reads the stored positions
    (``meshfem_tpu/physics/poisson.py:97-100``), so its average is off."""
    rm, tm, X = meshes["tri1"]
    tp = PoissonProblem(tm, node_positions=X, device=CPU)
    rp = RPoisson(rm, node_positions=jnp.asarray(X))
    u = X @ np.array([3.0, -4.0])
    close(tp.gradient(torch.as_tensor(u)),
          np.tile([3.0, -4.0], (rm.num_elements, 1)), 1e-12)
    close(tp.average_gradient(torch.as_tensor(u)), [3.0, -4.0], 1e-13)
    assert float(np.abs(np.asarray(rp.average_gradient(jnp.asarray(u)))
                        - [3.0, -4.0]).max()) > 1e-3
    # the operators agree with the reference's at those positions
    close(tp.L(torch.as_tensor(u)), rp.L(jnp.asarray(u)), 1e-12)
    close(tp.M(torch.as_tensor(u)), rp.M(jnp.asarray(u)), 1e-12)


def _recording(monkeypatch, module, log):
    orig = module.solve_dirichlet

    def rec(*args, **kw):
        res = orig(*args, **kw)
        log.append(int(res.iters))
        return res

    monkeypatch.setattr(module, "solve_dirichlet", rec)


def test_geodesic_distances(meshes, monkeypatch):
    rm, tm, _ = meshes["tri1"]
    src = rm.nodes_in_box((0, 0), (0, 0))
    riters, titers = [], []
    _recording(monkeypatch, rcg, riters)
    _recording(monkeypatch, tcg, titers)
    ref = rgeo.geodesic_distances(rm, src)
    out = tgeo.geodesic_distances(tm, src, device=CPU)
    assert len(titers) == len(riters) == 2 and titers == riters, \
        (titers, riters)
    close(out, ref, 1e-10)
    d = out.numpy()
    exact = np.linalg.norm(tm.node_positions, axis=1)
    assert np.abs(d - exact).max() < 0.08
    diag = [tm.nodes_in_box((x, x), (x, x))[0]
            for x in (0.25, 0.5, 0.75, 1.0)]
    assert np.all(np.diff(d[diag]) > 0)
