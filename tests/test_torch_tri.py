"""Triangle meshes, 2D elasticity and 2D homogenization of the port against
meshfem_tpu, on the CPU in float64.

The same numpy inputs go through both packages:

* ``TriMesh`` (half-edges, boundary edges and loops, adjacency) and the
  half-face queries of ``TetMesh``, the 2D generators and ``reorder_mesh``:
  equal arrays; 2D ``FEMMesh`` numbering equal, its geometry to 1e-14
  (triangles embedded in 3D too), the 2D boundary normals to 1e-14;
* 2D elasticity on P1 and P2: the boundary-condition paths of the
  reference's ``tests/test_elasticity.py:50-210`` (loads to 1e-14 of their
  scale, solves to 1e-10 relative, the closed forms to 1e-9), the EBE and
  routed solves of the cantilever (dense, ``MESHFEM_FACTORED`` and
  ``MESHFEM_FACTORED_TQ``, through the kernels' plain versions at 2 and 6
  values a node), ``rigid_modes``, the fields and ``no_rigid_motion``
  (1e-10 relative);
* 2D homogenization through ``homogenize`` (block, jacobi, the routed block
  CG, two-level) and ``homogenize_orthotropic`` (jacobi, two-level): Ch to
  1e-10 relative;
* a reference 2D P2 simulator handed to the port as numpy arrays
  (``interop``): Ke to 1e-14, u to 1e-10.
"""

import json
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import meshfem_tpu.native as rnative
from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.mesh import geometry as rgeom, reorder as rreorder
from meshfem_tpu.mesh import simplicial as rsimp
from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                 Material as RMat, parse_bc as rparse_bc)
from meshfem_tpu.physics.materials import MaterialField as RField

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators as tgen
from meshfem_tpu_torch.mesh import geometry as tgeom, reorder as treorder
from meshfem_tpu_torch.mesh import simplicial as tsimp
from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                       MaterialField, parse_bc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _box(lo, hi):
    return {"minCorner": list(lo), "maxCorner": list(hi)}


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

MESHES_2D = {
    "grid": lambda g: g.grid_tri(5, 3, hi=(2.0, 1.0)),
    "right": lambda g: g.grid_tri(4, 4, diagonal="right"),
    "l_shape": lambda g: g.l_shape(6),
    "ellipse": lambda g: g.ellipse(9),
}


@pytest.mark.parametrize("name,make", [
    ("grid_alternate", lambda g: g.grid_tri(5, 3)),
    ("grid_right", lambda g: g.grid_tri(4, 6, diagonal="right")),
    ("grid_box", lambda g: g.grid_tri(3, 7, lo=(1.0, 2.0), hi=(3.0, 5.0))),
    ("grid_box_right", lambda g: g.grid_tri(
        6, 2, lo=(-1.0, 0.5), hi=(1.0, 1.0), diagonal="right")),
    ("square", lambda g: g.square(3)),
    ("cube", lambda g: g.cube(2)),
    ("l_shape_8", lambda g: g.l_shape(8)),
    ("l_shape_5", lambda g: g.l_shape(5)),
    ("ellipse", lambda g: g.ellipse(7, 2.0, 0.5))])
def test_generators_equal(name, make):
    V0, F0 = make(rgen)
    V1, F1 = make(tgen)
    np.testing.assert_array_equal(V1, V0)
    np.testing.assert_array_equal(F1, F0)
    assert F1.dtype == F0.dtype


@pytest.mark.parametrize("name", sorted(MESHES_2D))
def test_trimesh_matches_reference(name):
    """Half-edge tables, boundary edges (their order and outward winding),
    loops, vertex-face adjacency, edges and the half-edge arithmetic:
    equal arrays."""
    V, F = MESHES_2D[name](rgen)
    ref, port = rsimp.TriMesh.build(V, F), tsimp.TriMesh.build(V, F)
    for k in ("V", "F", "O", "VH", "bdry_halfedge"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    np.testing.assert_array_equal(port.boundary_edges(), ref.boundary_edges())
    np.testing.assert_array_equal(port.boundary_vertices(),
                                  ref.boundary_vertices())
    loops, rloops = port.boundary_loops(), ref.boundary_loops()
    assert len(loops) == len(rloops)
    for a, b in zip(loops, rloops):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.vertex_face_adjacency(),
                    ref.vertex_face_adjacency()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.edges(), ref.edges())
    h = np.arange(3 * len(F))
    for f in ("face", "corner", "tail", "tip", "opposite_vertex", "next",
              "prev", "mate", "is_boundary_halfedge"):
        np.testing.assert_array_equal(getattr(port, f)(h), getattr(ref, f)(h))
    hb = port.bdry_halfedge
    np.testing.assert_array_equal(port.boundary_edge_index(hb),
                                  ref.boundary_edge_index(hb))
    np.testing.assert_array_equal(port.boundary_edge_index(hb),
                                  np.arange(len(hb)))
    interior = np.flatnonzero(port.O >= 0)
    np.testing.assert_array_equal(port.mate(port.mate(interior)), interior)
    assert (port.num_vertices, port.num_faces, port.num_boundary_edges) == \
        (ref.num_vertices, ref.num_faces, ref.num_boundary_edges)
    np.testing.assert_array_equal(port.bbox().min, ref.bbox().min)
    np.testing.assert_array_equal(port.bbox().max, ref.bbox().max)


def test_tetmesh_halfface_queries_match_reference():
    V, T = rgen.grid_tet(2, 3, 2)
    ref, port = rsimp.TetMesh.build(V, T), tsimp.TetMesh.build(V, T)
    hf = np.arange(4 * len(T))
    for f in ("tet", "corner", "mate", "is_boundary_halfface",
              "face_vertices"):
        np.testing.assert_array_equal(getattr(port, f)(hf),
                                      getattr(ref, f)(hf))
    np.testing.assert_array_equal(port.face_vertices(5), ref.face_vertices(5))
    hb = port.bdry_halfface
    np.testing.assert_array_equal(port.boundary_face_index(hb),
                                  ref.boundary_face_index(hb))
    np.testing.assert_array_equal(port.boundary_vertices(),
                                  ref.boundary_vertices())
    np.testing.assert_array_equal(port.edges(), ref.edges())
    assert (port.num_vertices, port.num_tets, port.num_boundary_faces) == \
        (ref.num_vertices, ref.num_tets, ref.num_boundary_faces)


@pytest.mark.parametrize("order", ["morton", "rcb"])
@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_reorder_mesh_equal(order, kind):
    """Morton codes, element permutation, first-touch vertex numbering:
    equal arrays."""
    V, F = rgen.grid_tri(9, 7) if kind == "tri" else rgen.grid_tet(3, 4, 3)
    for a, b in zip(treorder.reorder_mesh(V, F, order),
                    rreorder.reorder_mesh(V, F, order)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(treorder._morton_codes(V),
                                  rreorder._morton_codes(V))


FEM_CASES = [(name, deg, native) for name in sorted(MESHES_2D)
             for deg in (1, 2) for native in (True, False)
             if native or name == "grid"]


@pytest.fixture(scope="module")
def reference_geometry():
    """The reference's element and boundary geometry of every 2D test mesh
    (``simplex_geometry`` of the corners, ``boundary_normals`` of the
    outward-wound boundary edges, what its ``FEMMesh.geometry`` computes),
    in ONE call each over all meshes: JAX compiles once, not per mesh."""
    meshes = {name: RFEMMesh(*make(rgen), degree=1)
              for name, make in MESHES_2D.items()}
    names = sorted(meshes)
    gl, vol = rgeom.simplex_geometry(np.concatenate(
        [meshes[k].V[meshes[k].F] for k in names]), 2)
    bn, bm = rgeom.boundary_normals(np.concatenate(
        [meshes[k].V[meshes[k].bdry_elems] for k in names]))
    out, e0, b0 = {}, 0, 0
    for k in names:
        E, B = meshes[k].num_elements, meshes[k].num_boundary_elements
        out[k] = dict(grad_lambda=_np(gl)[e0:e0 + E],
                      volume=_np(vol)[e0:e0 + E],
                      bdry_normal=_np(bn)[b0:b0 + B],
                      bdry_volume=_np(bm)[b0:b0 + B])
        e0, b0 = e0 + E, b0 + B
    return out


@pytest.mark.parametrize("name,deg,native", FEM_CASES)
def test_femmesh_2d_matches_reference(name, deg, native, monkeypatch,
                                      reference_geometry):
    """Numbering (nodes, boundary elements and nodes, the element behind
    each boundary edge) equal, whether the reference numbers through its
    native host core or its numpy fallback; geometry to 1e-14 of the
    reference's; the lumped nodal measure sums to the area."""
    if not native:
        monkeypatch.setattr(rnative, "unique_edges", lambda pairs: None)
        monkeypatch.setattr(rnative, "match_faces", lambda fv: None)
    V, F = MESHES_2D[name](rgen)
    ref, port = RFEMMesh(V, F, degree=deg), FEMMesh(V, F, degree=deg)
    for k in ("elem_nodes", "node_positions", "bdry_elems", "bdry_elem_nodes",
              "bdry_nodes", "bdry_elem_vol_elem", "vertex_nodes"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    np.testing.assert_array_equal(port.node_endpoint_vertices(),
                                  ref.node_endpoint_vertices())
    assert (port.num_nodes, port.nodes_per_elem, port.dim, port.K) == \
        (ref.num_nodes, ref.nodes_per_elem, ref.dim, ref.K)
    g = port.geometry("cpu")
    for k, b in reference_geometry[name].items():
        a = _np(getattr(g, k))
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(b).max(), 1.0), k
    assert float(port.node_mass_lumped("cpu").sum()) == pytest.approx(
        float(g.volume.sum()), rel=1e-14)


@pytest.mark.parametrize("deg", [1, 2])
def test_embedded_triangles_in_3d(deg):
    """A triangle mesh padded to 3D (``embedding_dim=3``) and a curved
    surface: tangential gradients and unsigned areas to 1e-14 of the
    reference's; the boundary edges' in-plane normals equal the 2D mesh's
    padded with z = 0 (the reference's ``boundary_normals`` has no branch
    for edges in 3D and returns zeros)."""
    V, F = rgen.grid_tri(4, 3, hi=(2.0, 1.0))
    port = FEMMesh(V, F, degree=deg, embedding_dim=3)
    ref = RFEMMesh(V, F, degree=deg, embedding_dim=3)
    np.testing.assert_array_equal(port.node_positions, ref.node_positions)
    g, rg = port.geometry("cpu"), ref.geometry()
    assert np.abs(_np(g.grad_lambda) - _np(rg.grad_lambda)).max() <= 1e-14
    assert np.abs(_np(g.volume) - _np(rg.volume)).max() <= 1e-14
    g2 = FEMMesh(V, F, degree=deg).geometry("cpu")
    assert np.abs(_np(g.bdry_normal)[:, :2] - _np(g2.bdry_normal)).max() \
        <= 1e-14
    assert np.abs(_np(g.bdry_normal)[:, 2]).max() == 0.0
    np.testing.assert_allclose(_np(g.bdry_volume), _np(g2.bdry_volume),
                               rtol=1e-14)
    # a bent surface z = 0.3 x y: tangential gradients from the Gram form
    Vb = np.concatenate([V, 0.3 * V[:, :1] * V[:, 1:]], axis=1)
    gb = FEMMesh(Vb, F, degree=deg).geometry("cpu")
    gl, vol = rgeom.simplex_geometry(Vb[F], 2)
    assert np.abs(_np(gb.grad_lambda) - _np(gl)).max() \
        <= 1e-14 * np.abs(_np(gl)).max()
    np.testing.assert_allclose(_np(gb.volume), _np(vol), rtol=1e-14)


def test_boundary_normals_2d_match_reference():
    """The cantilever mesh's boundary edges, perturbed and wound either
    way, with and without the ``vol_centroids`` flip; 1-simplices embedded
    in 2D (Gram form)."""
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    Xb = V[FEMMesh(V, F).bdry_elems]
    rng = np.random.default_rng(4)
    Xb = Xb + 0.05 * rng.standard_normal(Xb.shape)
    flip = rng.random(len(Xb)) < 0.5
    Xb[flip] = Xb[flip, ::-1]
    cen = Xb.mean(axis=1) + rng.standard_normal((len(Xb), 2))
    for vc in (None, cen):
        n, m = tgeom.boundary_normals(torch.as_tensor(Xb), vc)
        rn, rm = rgeom.boundary_normals(jnp.asarray(Xb), vc)
        assert np.abs(_np(n) - _np(rn)).max() <= 1e-14
        assert np.abs(_np(m) - _np(rm)).max() <= 1e-14
    gl, vol = tgeom.simplex_geometry(torch.as_tensor(Xb), 1)
    rgl, rvol = rgeom.simplex_geometry(jnp.asarray(Xb), 1)
    assert _rel(gl, rgl) < 1e-14 and _rel(vol, rvol) < 1e-14


# ---------------------------------------------------------------------------
# 2D elasticity
# ---------------------------------------------------------------------------

CANTILEVER_BC = json.dumps({"regions": [
    {"type": "dirichlet", "value": [0, 0],
     "box%": _box([-0.001, -0.001], [0.001, 1.001])},
    {"type": "force", "value": [0, -1.0],
     "box%": _box([0.999, -0.001], [1.001, 1.001])}]})


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def cantilever(request):
    """BASELINE config 1 at a small size: grid_tri(8, 4) over [0, 2] x
    [0, 1], x = 0 clamped and the tip loaded in -y through ``parse_bc(...,
    dim=2)``; the reference's EBE solve to 1e-12."""
    deg = request.param
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    rsim = RSim(RFEMMesh(V, F, degree=deg), RMat.isotropic(2, 100.0, 0.3))
    rsim.apply_boundary_conditions(rparse_bc(CANTILEVER_BC, dim=2))
    u_ref, _ = rsim.solve(tol=1e-12)
    return dict(V=V, F=F, deg=deg, rsim=rsim, u_ref=np.asarray(u_ref))


def _port_cantilever(c):
    sim = ElasticitySimulator(FEMMesh(c["V"], c["F"], degree=c["deg"]),
                              Material.isotropic(2, 100.0, 0.3),
                              device="cpu")
    sim.apply_boundary_conditions(parse_bc(CANTILEVER_BC, dim=2))
    return sim


@pytest.mark.parametrize("backend", ["ebe", "routed", "factored", "tq"])
def test_cantilever_matches_reference(cantilever, backend, monkeypatch):
    """The clamped P1/P2 cantilever: loads and masks equal (loads 1e-14);
    u from the float64 EBE CG and from the routed float32 CG inside float64
    refinement (A rows and B rows at 2 values a node, between them the
    dense ``bmm`` or the factored C or D in rows) against the reference's
    EBE solve, 1e-10 relative; the routed f64 residual <= tol."""
    monkeypatch.delenv("MESHFEM_FACTORED", raising=False)
    monkeypatch.delenv("MESHFEM_FACTORED_TQ", raising=False)
    if backend in ("factored", "tq"):
        monkeypatch.setenv("MESHFEM_FACTORED", "1")
    if backend == "tq":
        monkeypatch.setenv("MESHFEM_FACTORED_TQ", "1")
    rsim = cantilever["rsim"]
    sim = _port_cantilever(cantilever)
    np.testing.assert_array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
    np.testing.assert_array_equal(sim.dirichlet_values,
                                  rsim.dirichlet_values)
    assert np.abs(_np(sim.neumann_load) - _np(rsim.neumann_load)).max() \
        <= 1e-14
    u, res = sim.solve(tol=1e-12, operator="ebe" if backend == "ebe"
                       else "routed")
    assert _rel(u, cantilever["u_ref"]) < 1e-10
    if backend != "ebe":
        rk = sim.routed_kernel()
        assert (rk.KeP is None) == (backend != "routed")
        assert res.resnorm <= 1e-12 and res.rounds >= 1


def test_cantilever_fields_match_reference(cantilever):
    """The fields of the reference's u through both packages: strains and
    stresses at the default and at given barycentric points, element
    averages, von Mises, the strain energy and ``constant_strain_load``
    (1e-12 relative)."""
    rsim, u_ref = cantilever["rsim"], cantilever["u_ref"]
    sim = _port_cantilever(cantilever)
    u, ru = torch.as_tensor(u_ref), jnp.asarray(u_ref)
    pts = np.asarray([[0.2, 0.3, 0.5], [1.0, 0.0, 0.0]])
    pairs = [(sim.strain_at(u), rsim.strain_at(ru)),
             (sim.stress_at(u, pts), rsim.stress_at(ru, pts)),
             (sim.average_strain_field(u), rsim.average_strain_field(ru)),
             (sim.average_stress(u), rsim.average_stress(ru)),
             (sim.von_mises_field(u), rsim.von_mises_field(ru)),
             (sim.constant_strain_load([0.2, -0.1, 0.05]),
              rsim.constant_strain_load(jnp.asarray([0.2, -0.1, 0.05])))]
    for a, b in pairs:
        assert _rel(a, b) < 1e-12
    assert float(sim.strain_energy(u)) == pytest.approx(
        float(rsim.strain_energy(ru)), rel=1e-12)
    assert _rel(sim.Ke, rsim.Ke) < 1e-14
    assert _rel(sim.K_diagonal(), rsim.K_diagonal()) < 1e-14


def test_uniaxial_tension_bc_2d():
    """The reference test's uniaxial bar (``tests/test_elasticity.py:50-
    80``): rollers on x = 0 and y = 0 and a traction t on the far edge
    through ``parse_bc(..., dim=2)``; plane stress gives eps_xx = t/E,
    eps_yy = -nu t/E (u to 1e-9, von Mises = t to 1e-9), and u agrees with
    the reference's to 1e-10."""
    E, nu, t = 10.0, 0.3, 0.5
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    spec = json.dumps({"regions": [
        {"type": "dirichletx", "value": [0, 0],
         "box%": _box([-0.001, -0.001], [0.001, 1.001])},
        {"type": "dirichlety", "value": [0, 0],
         "box%": _box([-0.001, -0.001], [1.001, 0.001])},
        {"type": "traction", "value": [t, 0],
         "box%": _box([0.999, -0.001], [1.001, 1.001])}]})
    sim = ElasticitySimulator(FEMMesh(V, F, degree=2),
                              Material.isotropic(2, E, nu), device="cpu")
    sim.apply_boundary_conditions(parse_bc(spec, dim=2))
    rsim = RSim(RFEMMesh(V, F, degree=2), RMat.isotropic(2, E, nu))
    rsim.apply_boundary_conditions(rparse_bc(spec, dim=2))
    u, _ = sim.solve(tol=1e-13)
    X = sim.mesh.node_positions
    expect = np.stack([(t / E) * X[:, 0], (-nu * t / E) * X[:, 1]], axis=1)
    np.testing.assert_allclose(_np(u), expect, atol=1e-9)
    np.testing.assert_allclose(_np(sim.von_mises_field(u)), t, atol=1e-9)
    ru, _ = rsim.solve(tol=1e-13)
    assert _rel(u, ru) < 1e-10


def test_neumann_and_dirichlet_regions_match_reference():
    """Force, traction, pressure and point forces on boundary edges, and
    expression-valued, element and node-set Dirichlet regions, on P1 and
    P2: masks and values equal, loads to 1e-14; 'force' spreads the total
    over the region's length and the pressure load on the far edge points
    in -x (the outward normal's sign).  The cantilever's mesh, so the
    reference reuses its compiled geometry."""
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    spec = {"regions": [
        {"type": "dirichlet", "value": ["sin(pi * x)", 0],
         "box%": _box([-0.001, 0.999], [1.001, 1.001])},
        {"type": "dirichlet", "value": [0, 0],
         "box%": _box([-0.001, -0.001], [1.001, 0.001])},
        {"type": "force", "value": [2.0, 0],
         "box%": _box([0.999, -0.001], [1.001, 1.001])},
        {"type": "traction", "value": [0.5, "y"],
         "box": _box([-0.05, 0.2], [0.05, 0.8])},
        {"type": "pressure", "value": [3.0],
         "box%": _box([0.999, -0.001], [1.001, 1.001])},
        {"type": "delta_force", "value": [0.0, -1.0],
         "box": _box([0.45, 0.45], [0.55, 0.55])}]}
    for deg in (1, 2):
        sim = ElasticitySimulator(FEMMesh(V, F, degree=deg),
                                  Material.isotropic(2, 5.0, 0.25),
                                  device="cpu")
        rsim = RSim(RFEMMesh(V, F, degree=deg), RMat.isotropic(2, 5.0, 0.25))
        sim.apply_boundary_conditions(parse_bc(json.dumps(spec), dim=2))
        rsim.apply_boundary_conditions(rparse_bc(json.dumps(spec), dim=2))
        np.testing.assert_array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
        np.testing.assert_allclose(sim.dirichlet_values,
                                   rsim.dirichlet_values, rtol=0,
                                   atol=1e-14)
        assert np.abs(_np(sim.neumann_load)
                      - _np(rsim.neumann_load)).max() <= 1e-14
        for only, fx in ((2, 2.0), (4, -3.0)):
            s1 = ElasticitySimulator(sim.mesh, Material.isotropic(2, 5.0,
                                                                  0.25),
                                     device="cpu")
            s1.apply_boundary_conditions(parse_bc(json.dumps(
                {"regions": [spec["regions"][only]]}), dim=2))
            assert float(s1.neumann_load[:, 0].sum()) == pytest.approx(
                fx, rel=1e-12)


def test_indexed_regions_2d_match_reference():
    """Node sets, element sets (Neumann 'elements' conditions matched by
    their two vertex ids, Dirichlet 'element vertices'), point forces and a
    polygon target on the boundary edges of the cantilever's P2 mesh:
    masks, values and the region dof lists equal, loads to 1e-14; the
    periodic cell-face boundary elements equal."""
    from meshfem_tpu.mesh.periodic import cell_face_boundary_elements as rcf
    from meshfem_tpu_torch.mesh.periodic import cell_face_boundary_elements

    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))   # vertex (i, j): 5 i + j
    spec = json.dumps({"regions": [
        {"type": "dirichlet nodes",
         "values": [[[0, 0], [0, 1, 2]], [[0.1, 0], [3, 4]]]},
        {"type": "dirichlet", "value": [0, 0.5],
         "element vertices": [[20, 25], [25, 30]]},
        {"type": "traction elements",
         "values": [[[1.0, 0.0], [[40, 41], [41, 42]]],
                    [[0.0, -1.0], [[42, 43]]]]},
        {"type": "pressure elements", "values": [[[2.0], [[43, 44]]]]},
        {"type": "force elements",
         "values": [[[0.5, 0.5], [[4, 9], [9, 14]]]]},
        {"type": "delta_force nodes", "values": [[[0, -1], [22]]]},
        {"type": "target", "value": [0, 0],
         "polygon": [[1.9, 0.9], [2.1, 0.9], [2.1, 1.1], [1.9, 1.1]]}]})
    sim = ElasticitySimulator(FEMMesh(V, F, degree=2),
                              Material.isotropic(2, 100.0, 0.3), device="cpu")
    rsim = RSim(RFEMMesh(V, F, degree=2), RMat.isotropic(2, 100.0, 0.3))
    sim.apply_boundary_conditions(parse_bc(spec, dim=2))
    rsim.apply_boundary_conditions(rparse_bc(spec, dim=2))
    np.testing.assert_array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
    np.testing.assert_array_equal(sim.dirichlet_values,
                                  rsim.dirichlet_values)
    assert len(sim._region_nodes) == len(rsim._region_nodes) == 2
    for a, b in zip(sim._region_nodes, rsim._region_nodes):
        np.testing.assert_array_equal(a, b)
    assert np.abs(_np(sim.neumann_load) - _np(rsim.neumann_load)).max() \
        <= 1e-14
    assert float(sim.neumann_load.abs().sum()) > 0
    np.testing.assert_array_equal(cell_face_boundary_elements(sim.mesh),
                                  rcf(rsim.mesh))


@pytest.fixture(scope="module")
def free_square():
    """The reference's pure-traction square under ``no_rigid_motion``
    (``tests/test_elasticity.py:160-190``, here on 8 x 4 cells): its
    inputs, rigid modes, posedness analysis and solution, shared by both
    port operators."""
    V, F = rgen.grid_tri(8, 4, lo=(-1, -1), hi=(1, 1))
    spec = json.dumps({"no_rigid_motion": True, "regions": [
        {"type": "traction", "value": [0, 0.3],
         "box": _box([-1.05, -1.05], [1.05, -0.95])},
        {"type": "traction", "value": [0, -0.3],
         "box": _box([-1.05, 0.95], [1.05, 1.05])}]})
    rsim = RSim(RFEMMesh(V, F, degree=1), RMat.isotropic(2, 10.0, 0.3))
    rsim.apply_boundary_conditions(rparse_bc(spec, dim=2))
    ru, _ = rsim.solve(tol=1e-12)
    return dict(V=V, F=F, spec=spec, Z=np.asarray(rsim.rigid_modes()),
                posedness=rsim.analyze_dirichlet_posedness(), u=ru)


@pytest.mark.parametrize("operator", ["ebe", "routed"])
def test_no_rigid_motion_2d(free_square, operator):
    """The reference test's pure-traction square under ``no_rigid_motion``:
    u's part orthogonal to the
    rigid modes against the reference's to 1e-10 relative (the routed
    solve's rigid part is float32 projection rounding, ~2e-8 of u), zero
    mean to 1e-9, compression in y; rigid modes (3) and the posedness analysis
    equal."""
    c = free_square
    sim = ElasticitySimulator(FEMMesh(c["V"], c["F"], degree=1),
                              Material.isotropic(2, 10.0, 0.3), device="cpu")
    sim.apply_boundary_conditions(parse_bc(c["spec"], dim=2))
    Z = sim.rigid_modes()
    assert Z.shape == (2 * sim.num_dofs, 3)
    np.testing.assert_allclose(Z, c["Z"], atol=1e-15)
    nt, nr = sim.analyze_dirichlet_posedness()
    rnt, rnr = c["posedness"]
    np.testing.assert_array_equal(nt, rnt)
    assert nr == rnr
    u, _ = sim.solve(tol=1e-12, operator=operator)
    ru = c["u"]
    Q, _ = np.linalg.qr(Z)

    def free_part(v):
        v = _np(v).reshape(-1)
        return v - Q @ (Q.T @ v)

    assert _rel(free_part(u), free_part(ru)) < 1e-10
    u = _np(u)
    np.testing.assert_allclose(u.mean(axis=0), 0.0, atol=1e-9)
    top = sim.mesh.nodes_in_box((-1, 1), (1, 1))
    assert u[top, 1].mean() < -1e-3


@pytest.mark.parametrize("deg", [1, 2])
def test_constant_strain_patch_2d(deg):
    """Dirichlet u = eps0 x on the boundary reproduces the uniform strain
    (1e-9, the reference test's bound): the EBE solve and the routed
    refined solve."""
    V, F = rgen.grid_tri(3, 3)
    sim = ElasticitySimulator(FEMMesh(V, F, degree=deg),
                              Material.isotropic(2, 10.0, 0.3), device="cpu")
    eps = np.asarray([[0.1, 0.03], [0.03, -0.05]])
    exact = sim.mesh.node_positions @ eps.T
    sim.fix_nodes(sim.mesh.bdry_nodes, exact[sim.mesh.bdry_nodes])
    for operator in ("ebe", "routed"):
        u, _ = sim.solve(tol=1e-13, operator=operator)
        np.testing.assert_allclose(_np(u), exact, atol=1e-9)
        np.testing.assert_allclose(_np(sim.average_strain(u)),
                                   [0.1, -0.05, 0.03], atol=1e-9)


@pytest.mark.parametrize("deg", [1, 2])
def test_routed_2d_plans(deg, monkeypatch):
    """The 2D routed operator through the kernels' plain versions: the
    dense apply at 2 values a node (A rows, ``bmm``, B rows) and the block
    apply of 3 columns at 6 values a node against the float64 EBE operator
    (5e-6 relative, float32), and the factored C and D applies in rows
    against the dense one (5e-6)."""
    V, F = rgen.grid_tri(5, 4)
    mesh = FEMMesh(V, F, degree=deg)
    sim = ElasticitySimulator(mesh, Material.isotropic(2, 100.0, 0.3),
                              device="cpu")
    monkeypatch.delenv("MESHFEM_FACTORED", raising=False)
    monkeypatch.delenv("MESHFEM_FACTORED_TQ", raising=False)
    rk = sim.routed_kernel(block_rhs=3)
    rng = np.random.default_rng(deg)
    U = torch.as_tensor(rng.standard_normal((sim.num_dofs, 2, 3)))
    ref = sim.apply_K(U)
    got = rk.permute_out(rk.apply_block(rk.permute_in(U)))
    assert _rel(got, ref) < 5e-6
    y = rk.permute_out(rk(rk.permute_in(U[..., 0])))
    assert _rel(y, ref[..., 0]) < 5e-6
    for tq in ("0", "1"):
        monkeypatch.setenv("MESHFEM_FACTORED", "1")
        monkeypatch.setenv("MESHFEM_FACTORED_TQ", tq)
        sim._routed = None
        fk = sim.routed_kernel(block_rhs=3)
        assert fk.KeP is None
        yf = fk.permute_out(fk.apply_block(fk.permute_in(U)))
        assert _rel(yf, got) < 5e-6


# ---------------------------------------------------------------------------
# 2D homogenization
# ---------------------------------------------------------------------------

def _void_cell(n=6, r=0.2):
    """grid_tri(n, n) without the triangles whose centroid lies within r
    of the centre: at (6, 0.2), 64 of 72 remain, the cantilever mesh's
    count, so the reference reuses its compiled element geometry."""
    V, F = rgen.grid_tri(n, n)
    c = V[F].mean(axis=1)
    return V, F[((c - 0.5) ** 2).sum(axis=1) > r * r]


@pytest.fixture(scope="module")
def void_cell():
    """The P2 void cell and the reference's block-preconditioned
    homogenization of it."""
    V, F = _void_cell()
    ref = rhom.homogenize(RFEMMesh(V, F, degree=2),
                          RMat.isotropic(2, 1.0, 0.3), tol=1e-11,
                          precond="block")
    return dict(V=V, F=F, ref=ref, rmesh=RFEMMesh(V, F, degree=2))


def _port_Ch(mesh, path):
    """Ch of the port's homogenization of ``mesh`` by ``path``: 'routed'
    forces the routed block CG (float32 inside float64 refinement)."""
    mat = Material.isotropic(2, 1.0, 0.3)
    if path != "routed":
        return hom.homogenize(mesh, mat, tol=1e-11, precond=path,
                              device="cpu").Ch
    sim = hom.periodic_simulator(mesh, mat, device="cpu")
    w, _ = hom.solve_cell_problems(sim, tol=1e-11, operator="routed",
                                   precond="block")
    assert sim.routed_kernel().bm == 3
    return hom.homogenized_tensor_stress_form(
        sim, w - w.mean(dim=1, keepdim=True))


@pytest.mark.parametrize("deg,path", [
    (1, "jacobi"), (1, "routed"),
    (2, "block"), (2, "jacobi"), (2, "routed"), (2, "twolevel")])
def test_homogenize_2d_matches_reference(void_cell, deg, path):
    """Ch of the triangle void cell (fl = 3), 1e-10 relative: at P2 the
    port's block and jacobi EBE solves, the routed block CG (6 values a
    node) and the two-level preconditioner against the reference's block
    solve; at P1 the jacobi and routed solves against the port's block
    solve.  Ch is symmetric and square symmetric."""
    mesh = FEMMesh(void_cell["V"], void_cell["F"], degree=deg)
    Ch = _port_Ch(mesh, path)
    ref = void_cell["ref"].Ch if deg == 2 else _port_Ch(mesh, "block")
    assert _rel(Ch, ref) < 1e-10
    Ch = _np(Ch)
    assert np.abs(Ch - Ch.T).max() <= 1e-12 * np.abs(Ch).max()
    assert abs(Ch[0, 0] - Ch[1, 1]) <= 1e-10 * Ch[0, 0]


def test_homogenize_2d_forms_match_reference(void_cell):
    """The displacement (boundary) form, which reads the boundary edges'
    outward normals, the macro-to-micro strains and a probe, on the
    reference's fluctuations (1e-12 relative)."""
    ref = void_cell["ref"]
    mesh = FEMMesh(void_cell["V"], void_cell["F"], degree=2)
    mat = Material.isotropic(2, 1.0, 0.3)
    sim = hom.periodic_simulator(mesh, mat, device="cpu")
    rsim = rhom.periodic_simulator(void_cell["rmesh"],
                                   RMat.isotropic(2, 1.0, 0.3))
    w = torch.as_tensor(np.asarray(ref.w))
    assert _rel(hom.homogenized_tensor_displacement_form(sim, w),
                rhom.homogenized_tensor_displacement_form(rsim, ref.w)) \
        < 1e-12
    assert _rel(hom.homogenized_tensor_displacement_form(sim, w),
                ref.Ch) < 1e-8
    assert _rel(hom.macro_to_micro_strain(sim, w),
                rhom.macro_to_micro_strain(rsim, ref.w)) < 1e-12
    e = [0.01, -0.02, 0.005]
    for a, b in zip(hom.probe(sim, w, e), rhom.probe(rsim, ref.w,
                                                     jnp.asarray(e))):
        assert _rel(a, b) < 1e-12


@pytest.fixture(scope="module")
def soft_disc_cell():
    """The cantilever's grid_tri(8, 4) over [0, 2] x [0, 1], P2, with a
    100:1 soft disc: an orthotropic base cell."""
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))
    c = V[F].mean(axis=1)
    E = np.where(((c - [1.0, 0.5]) ** 2).sum(axis=1) < 0.09, 0.01, 1.0)
    nu = np.full(len(E), 0.3)
    return dict(mesh=FEMMesh(V, F, degree=2),
                mat=MaterialField.isotropic_field(2, E, nu),
                rmesh=RFEMMesh(V, F, degree=2),
                rmat=RField.isotropic_field(2, jnp.asarray(E),
                                            jnp.asarray(nu)))


@pytest.mark.parametrize("precond", ["jacobi", "twolevel"])
def test_homogenize_orthotropic_2d(soft_disc_cell, precond):
    """``homogenize_orthotropic`` on a 2D cell (the 2D shear pins: the
    tangential component of each face) against the reference, 1e-10
    relative, with equal iteration counts; the orthotropic multigrid needs
    a 3D Kuhn grid and raises ValueError, as the reference's does."""
    c = soft_disc_cell
    res = hom.homogenize_orthotropic(c["mesh"], c["mat"], tol=1e-11,
                                     precond=precond, device="cpu")
    ref = rhom.homogenize_orthotropic(c["rmesh"], c["rmat"], tol=1e-11,
                                      precond=precond)
    assert _rel(res.Ch, ref.Ch) < 1e-10
    assert res.cg_iters == list(ref.cg_iters)
    with pytest.raises(ValueError, match="3D Kuhn grid"):
        hom.homogenize_orthotropic(c["mesh"], c["mat"], precond="multigrid",
                                   device="cpu")


# ---------------------------------------------------------------------------
# State carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", [False, True], ids=["constant", "field"])
def test_simulator_from_arrays_2d(field):
    """A reference 2D P2 simulator (a constant [3, 3] D, or a per-element
    [E, 3, 3] field) with its Dirichlet mask and loads as numpy: the port's
    ``simulator_from_arrays`` assembles the same Ke (1e-14) and solves the
    same u (1e-10); ``routed_from_arrays`` on the reference's element dofs
    and Ke applies as the port's own routed operator does (1e-6)."""
    V, F = rgen.grid_tri(8, 4, hi=(2.0, 1.0))     # the cantilever's mesh
    if field:
        c = V[F].mean(axis=1)
        E = np.where(c[:, 0] < 1.0, 100.0, 10.0)
        rmat = RField.isotropic_field(2, jnp.asarray(E),
                                      jnp.full(len(E), 0.3))
    else:
        rmat = RMat.isotropic(2, 100.0, 0.3)
    rsim = RSim(RFEMMesh(V, F, degree=2), rmat)
    rsim.apply_boundary_conditions(rparse_bc(CANTILEVER_BC, dim=2))
    ru, _ = rsim.solve(tol=1e-12)
    sim = interop.simulator_from_arrays(dict(
        V=V, T=F, degree=2, D=np.asarray(rsim.D),
        dirichlet_mask=np.asarray(rsim.dirichlet_mask),
        dirichlet_values=np.asarray(rsim.dirichlet_values),
        neumann_load=np.asarray(rsim.neumann_load)), device="cpu")
    assert sim.dim == 2 and sim.D.shape == tuple(np.asarray(rsim.D).shape)
    assert np.abs(_np(sim.Ke) - _np(rsim.Ke)).max() \
        <= 1e-14 * np.abs(_np(rsim.Ke)).max()
    u, _ = sim.solve(tol=1e-12)
    assert _rel(u, ru) < 1e-10
    rk = interop.routed_from_arrays(dict(
        elem_dofs=np.asarray(rsim.elem_dofs), num_dofs=rsim.num_dofs,
        vector_dim=2, Ke=np.asarray(rsim.Ke),
        coords=sim.mesh.node_positions), device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (sim.num_dofs, 2)))
    y = rk.permute_out(rk(rk.permute_in(x)))
    assert _rel(y, sim.routed_kernel().permute_out(
        sim.routed_kernel()(sim.routed_kernel().permute_in(x)))) < 1e-6
    assert _rel(y, sim.apply_K(x)) < 5e-6


def test_readme_2d_quickstart():
    """The port's 2D quick start exactly as README.md prints it: it runs on
    the CPU, and its u solves the assembled system (the clamped rows
    replaced by the identity) to 1e-8 of max|u|, by a direct solve."""
    import scipy.sparse.linalg as spla

    text = open(os.path.join(REPO, "README.md")).read()
    part = text[text.index("## PyTorch/CUDA port"):]
    code = next(c for c in re.findall(r"```python\n(.*?)```", part, re.S)
                if "grid_tri" in c)
    assert 'device="cpu"' in code and "dim=2" in code
    ns = {}
    exec(compile(code, "README.md", "exec"), ns)
    sim, u = ns["sim"], _np(ns["u"])
    A = sim.to_scipy().tolil()
    b = _np(sim.neumann_load).ravel()
    for i in np.flatnonzero(sim.dirichlet_mask.ravel()):
        A[i, :] = 0.0
        A[i, i] = 1.0
        b[i] = 0.0
    u_direct = spla.spsolve(A.tocsc(), b).reshape(-1, 2)
    assert np.abs(u - u_direct).max() <= 1e-8 * np.abs(u_direct).max()
    assert u[:, 1].min() < 0 and _np(ns["vm"]).shape == (2048,)
