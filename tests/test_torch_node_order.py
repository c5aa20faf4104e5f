"""``FEMMesh(node_order=...)`` of ``meshfem_tpu_torch`` against
``meshfem_tpu`` on the CPU, and the paths that read a renumbered mesh.

On ``grid_tet(4, 3, 3)`` P1 and P2 and ``grid_tri(6, 5)`` P2, in each of
"reference", "morton", "rcb" and "firsttouch": ``elem_nodes``,
``node_positions``, ``bdry_nodes``, ``bdry_elem_nodes``,
``is_bdry_node``, ``vertex_nodes``, ``node_perm`` and
``node_endpoint_vertices`` equal to the bit, ``geometry()`` to 1e-14, and
the corner and endpoint gathers reading the node rows of each vertex.  On
morton meshes: a clamped float64 EBE solve equal to the reference's to
1e-10 of max|u|; the two-level preconditioner (endpoints, transfers, one
application, 1e-12) and the AMG hierarchy (aggregates, prolongator and
coarse inverse, 1e-12) equal to the reference's.  On a Morton P1
``grid_tri(10)`` paraboloid ``harmonic`` and ``lscm`` (with their
``scale_factor`` and ``conformal_distortion``) and ``scp``'s operator
equal the reference order's, renumbered through ``node_perm``; the
reference's ``harmonic`` there puts other nodes than the boundary's on
the circle.
``sparse.scatter.plan_for`` caches by content in a bounded cache, and
its plan sums as the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu.analysis import parametrization as rpar
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.mesh import generators as rgen
from meshfem_tpu.physics import ElasticitySimulator as RSim
from meshfem_tpu.physics import Material as RMaterial
from meshfem_tpu.solvers import amg as ramg
from meshfem_tpu.solvers.twolevel import (TwoLevel as RTwoLevel,
                                          p2_vertex_endpoints as r_endpoints)
from meshfem_tpu.sparse import scatter as rscatter

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.analysis import parametrization as par
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.solvers import amg
from meshfem_tpu_torch.solvers.twolevel import TwoLevel, p2_vertex_endpoints
from meshfem_tpu_torch.sparse import scatter

ORDERS = ("reference", "morton", "rcb", "firsttouch")
MESHES = {"tet_p1": (rgen.grid_tet(4, 3, 3), 1),
          "tet_p2": (rgen.grid_tet(4, 3, 3), 2),
          "tri_p2": (rgen.grid_tri(6, 5), 2)}
ARRAYS = ("elem_nodes", "node_positions", "bdry_nodes", "bdry_elem_nodes",
          "is_bdry_node", "vertex_nodes", "node_perm")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(MESHES))
def test_node_order_matches_reference(name, order):
    (V, F), deg = MESHES[name]
    r = RFEMMesh(V, F, degree=deg, node_order=order)
    p = FEMMesh(V, F, degree=deg, node_order=order)
    assert p.node_order == r.node_order == order
    for a in ARRAYS:
        np.testing.assert_array_equal(getattr(p, a), np.asarray(getattr(r, a)),
                                      err_msg=a)
    np.testing.assert_array_equal(p.node_endpoint_vertices(),
                                  r.node_endpoint_vertices())
    gp, gr = p.geometry("cpu"), r.geometry()
    for f in ("grad_lambda", "volume", "bdry_normal", "bdry_volume"):
        assert _rel(getattr(gp, f).numpy(), getattr(gr, f)) <= 1e-14, f
    # the gathers read each vertex's own node row
    X = torch.as_tensor(p.node_positions)
    corners = p.corner_gather("cpu")(X).reshape(len(F), -1, X.shape[1])
    np.testing.assert_array_equal(corners.numpy(), p.V[p.F])
    np.testing.assert_array_equal(
        p.node_positions_from_vertices(p.V, "cpu").numpy(),
        np.asarray(r.node_positions_from_vertices(jnp.asarray(r.V))))
    if order == "morton":       # (rcb keeps so few nodes in one leaf)
        assert not np.array_equal(p.node_perm, np.arange(p.num_nodes))
    with pytest.raises(ValueError):
        FEMMesh(V, F, degree=deg, node_order="hilbert")


def test_interop_carries_node_order():
    (V, T), _ = MESHES["tet_p2"]
    mesh = FEMMesh(V, T, degree=2)
    sim = interop.simulator_from_arrays(dict(
        V=V, T=T, degree=2, node_order="morton",
        D=Material.isotropic(3, 200.0, 0.3).D), device="cpu")
    assert sim.mesh.node_order == "morton"
    np.testing.assert_array_equal(sim.mesh.elem_nodes,
                                  sim.mesh.node_perm[mesh.elem_nodes])


def _clamp(sim, mesh):
    """x = 0 clamped; returns the far face's load in -y."""
    X = np.asarray(mesh.node_positions)
    sim.dirichlet_mask[X[:, 0] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -0.01
    return load


@pytest.fixture(scope="module")
def morton_pair():
    """A clamped grid_tet(3) P2 in Morton node order in both packages."""
    V, T = rgen.grid_tet(3, 3, 3)
    rmesh = RFEMMesh(V, T, degree=2, node_order="morton")
    rsim = RSim(rmesh, RMaterial.isotropic(3, 200.0, 0.3))
    load = _clamp(rsim, rmesh)
    rsim.neumann_load = jnp.asarray(load)
    mesh = FEMMesh(V, T, degree=2, node_order="morton")
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device="cpu")
    _clamp(sim, mesh)
    sim.neumann_load = torch.as_tensor(load)
    return rsim, sim


def test_morton_clamped_ebe_solve(morton_pair):
    rsim, sim = morton_pair
    u_r, _ = rsim.solve(tol=1e-12, operator="ebe")
    u, res = sim.solve(tol=1e-12, operator="ebe")
    assert _rel(u.numpy(), u_r) <= 1e-10
    assert res.resnorm <= 1e-12


def test_morton_twolevel(morton_pair):
    rsim, sim = morton_pair
    np.testing.assert_array_equal(p2_vertex_endpoints(sim.mesh),
                                  r_endpoints(rsim.mesh))
    free = ~np.asarray(sim.dirichlet_mask)
    f64 = torch.as_tensor(free, dtype=torch.float64)
    rfree = jnp.asarray(free, jnp.float64)
    tl = TwoLevel.from_simulator(sim, mode="additive", free_mask=free,
                                 project=lambda v: v * f64)
    rtl = RTwoLevel.from_simulator(rsim, mode="additive", free_mask=free,
                                   project=lambda v: v * rfree)
    assert tl.n_coarse == rtl.n_coarse
    rng = np.random.default_rng(1)
    r = rng.standard_normal((sim.num_dofs, 3)) * free
    rc = rng.standard_normal((tl.n_coarse, 3))
    assert _rel(tl.prolong(torch.as_tensor(rc)).numpy(),
                rtl.prolong(jnp.asarray(rc))) <= 1e-12
    assert _rel(tl.restrict(torch.as_tensor(r)).numpy(),
                rtl.restrict(jnp.asarray(r))) <= 1e-12
    assert _rel(tl.M_inv(torch.as_tensor(r)).numpy(),
                rtl.M_inv(jnp.asarray(r))) <= 1e-12


def test_morton_amg_hierarchy(morton_pair):
    rsim, sim = morton_pair
    rmg = ramg.UnstructuredMG.build(rsim, agg_size=12, coarse_target=200,
                                    dtype=jnp.float64)
    pmg = amg.UnstructuredMG.build(sim, agg_size=12, coarse_target=200,
                                   dtype=torch.float64)
    assert (pmg.Nf, pmg.NC) == (rmg.Nf, rmg.NC)
    assert np.array_equal(pmg.free_c.numpy(), np.asarray(rmg.free_c))
    assert len(pmg.levels) == len(rmg.levels)
    for lp, lr in zip(pmg.levels, rmg.levels):
        assert np.array_equal(lp.agg_of.numpy(), np.asarray(lr.agg_of))
        assert _rel(lp.Pblk.numpy(), lr.Pblk) <= 1e-12
    assert _rel(pmg.Cinv.numpy(), rmg.Cinv) <= 1e-12


@pytest.fixture(scope="module")
def param_pair():
    """grid_tri(10) P1 on the paraboloid z = (x - 1/2)^2 + (y - 1/2)^2,
    in the reference order and in Morton order."""
    V, F = rgen.grid_tri(10, 10)
    V3 = np.column_stack([V, ((V - 0.5) ** 2).sum(axis=1)])
    return (FEMMesh(V3, F, degree=1, embedding_dim=3),
            FEMMesh(V3, F, degree=1, embedding_dim=3, node_order="morton"))


@pytest.mark.parametrize("method", ["harmonic", "lscm"])
def test_parametrization_in_morton_order(param_pair, method):
    """The maps of a Morton mesh are the reference order's, renumbered."""
    ref, mor = param_pair
    fn = getattr(par, method)
    uv_r, uv_m = fn(ref, device="cpu"), fn(mor, device="cpu")
    assert mor.node_perm.tolist() != list(range(mor.num_nodes))
    assert _rel(uv_m[torch.as_tensor(mor.node_perm)].numpy(),
                uv_r.numpy()) <= 1e-9
    for q in (par.scale_factor, par.conformal_distortion):
        assert _rel(q(mor, uv_m, "cpu").numpy(),
                    q(ref, uv_r, "cpu").numpy()) <= 1e-9


def test_conformal_operator_in_morton_order(param_pair):
    """``scp``'s operator H (the Laplacian less the boundary area pairing)
    on a Morton mesh is the reference order's, renumbered.  (``scp``
    itself is not compared: its two smallest eigenvalues, 0.0078429 and
    0.0078436 here, are resolved by LOBPCG only to ~1e-5, so each order
    returns another vector of that pair's span.)"""
    ref, mor = param_pair
    H_r, _, _ = par._conformal_operator(ref, "cpu")
    H_m, _, _ = par._conformal_operator(mor, "cpu")
    perm = torch.as_tensor(mor.node_perm)
    z = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (ref.num_nodes, 2, 3)))
    z_m = torch.empty_like(z)
    z_m[perm] = z
    assert _rel(H_m(z_m)[perm].numpy(), H_r(z).numpy()) <= 1e-12


def test_reference_harmonic_reads_vertex_ids_as_nodes(param_pair):
    """The reference's ``harmonic`` fixes nodes numbered as the boundary
    loop's vertices, which in Morton order are other nodes: the boundary
    vertices' nodes leave the unit circle.  The port's stay on it."""
    _, mor = param_pair
    loop = max(mor.cell.boundary_loops(), key=len)
    nodes = mor.vertex_nodes[loop]
    uv_r = np.asarray(rpar.harmonic(RFEMMesh(mor.V, mor.F, degree=1,
                                             embedding_dim=3,
                                             node_order="morton")))
    uv_p = par.harmonic(mor, device="cpu").numpy()
    assert np.abs(np.linalg.norm(uv_p[nodes], axis=1) - 1).max() <= 1e-12
    assert np.abs(np.linalg.norm(uv_r[nodes], axis=1) - 1).max() > 0.1


def test_plan_for_caches_by_content():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, 300)
    p1 = scatter.plan_for(ids, 40, device="cpu")
    assert scatter.plan_for(ids.copy(), 40, device="cpu") is p1
    assert scatter.plan_for(ids, 41, device="cpu") is not p1
    other = ids.copy()
    other[0] = (other[0] + 1) % 40
    assert scatter.plan_for(other, 40, device="cpu") is not p1
    rows = rng.standard_normal((300, 3))
    ref = rscatter.plan_for(ids, 40)(jnp.asarray(rows))
    assert _rel(p1(torch.as_tensor(rows)).numpy(), ref) <= 1e-12


def test_plan_for_keeps_the_plans_used_last():
    """The cache is bounded: a plan used since stays, the oldest goes."""
    rng = np.random.default_rng(4)
    first = rng.integers(0, 10, 50)
    p1 = scatter.plan_for(first, 10, device="cpu")
    for k in range(scatter.PLAN_CACHE_SIZE - 1):
        scatter.plan_for(rng.integers(0, 10, 50), 10, device="cpu")
        assert scatter.plan_for(first, 10, device="cpu") is p1
    for k in range(scatter.PLAN_CACHE_SIZE):
        scatter.plan_for(rng.integers(0, 10, 50), 10, device="cpu")
    assert len(scatter._PLAN_CACHE) == scatter.PLAN_CACHE_SIZE
    assert scatter.plan_for(first, 10, device="cpu") is not p1


def test_linkage_loops_take_the_reference_order():
    """``open_linkage`` and ``optimize_linkage`` renumber a mesh in another
    order as the reference does (``mechanisms.py:160,244``) before their
    loops."""
    from meshfem_tpu_torch.analysis import mechanisms

    (V, F), _ = MESHES["tri_p2"]
    ref = FEMMesh(V, F, degree=2)
    assert mechanisms._in_reference_order(ref) is ref
    back = mechanisms._in_reference_order(
        FEMMesh(V, F, degree=2, node_order="morton"))
    assert back.node_order == "reference"
    np.testing.assert_array_equal(back.elem_nodes, ref.elem_nodes)
