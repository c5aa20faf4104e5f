"""Boundary conditions, the rigid-motion projection and warm starts of the
port's ElasticitySimulator against meshfem_tpu's, on the CPU in float64.

The same numpy inputs go through both packages:

* ``utils/expressions``, ``parse_bc`` and ``apply_boundary_conditions``
  (masks, values and region node lists equal, loads to 1e-13), with the
  invalid inputs raising in both; ``fix_nodes`` on a periodic dof map;
* the README quick start (the port's block of ``README.md``, run as it
  stands) against the reference's: u and von Mises to 1e-8;
* a free body under opposite end forces (``no_rigid_motion``): EBE with
  each preconditioner and the routed path against the reference's EBE
  solve, and the analytic solution of the uniform tension to 1e-9;
* ``x0`` in ``cg``, ``refine`` and ``solve``; the refined EBE branch
  (called directly: it runs on CUDA only) against the reference's;
* the mesh queries, the solver helpers, the materials and the elasticity
  tensor methods.

The ``cuda``-marked cases run the routed projection in planes and the
refined EBE branch on the card; they skip without one.
"""

import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.fem import elasticity_tensor as et
from meshfem_tpu_torch.fem import tensor_projection as tp
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.physics import boundary_conditions as bc
from meshfem_tpu_torch.physics import materials as mats
from meshfem_tpu_torch.solvers import cg as cg_mod
from meshfem_tpu_torch.solvers import refine as refine_mod
from meshfem_tpu_torch.utils import expressions as expr


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Lazy:
    """A module of the reference (or JAX), imported on first use: the
    ``cuda`` cases run on a machine with a card and no JAX."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jnp = _Lazy("jax.numpy")
ret = _Lazy("meshfem_tpu.fem.elasticity_tensor")
rtp = _Lazy("meshfem_tpu.fem.tensor_projection")
rmesh = _Lazy("meshfem_tpu.mesh")
rperiodic = _Lazy("meshfem_tpu.mesh.periodic")
rphys = _Lazy("meshfem_tpu.physics")
rbc = _Lazy("meshfem_tpu.physics.boundary_conditions")
rmats = _Lazy("meshfem_tpu.physics.materials")
rcg = _Lazy("meshfem_tpu.solvers.cg")
rrefine = _Lazy("meshfem_tpu.solvers.refine")
rexpr = _Lazy("meshfem_tpu.utils.expressions")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _box(lo, hi, pct=True):
    return {"box%" if pct else "box": {"minCorner": lo, "maxCorner": hi}}


X0 = _box([-0.001, -0.001, -0.001], [0.001, 1.001, 1.001])   # x = 0 face
X1 = _box([0.999, -0.001, -0.001], [1.001, 1.001, 1.001])    # x = 1 face


# -- expressions ---------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "0.5", "x + 2*y - z", "sin(pi*x) * exp(-y) + sqrt(abs(z))",
    "atan2(y, x + 1) + pow(x, 2) - ln(1 + y) + log(2 + z)",
    "x if mesh_size_x > 1 else -z", "mesh_size_x * (x - mesh_min_x) % 0.3",
    "min(x, y) + max(y, z) + floor(3*x) + ceil(2*y) + sign(z - 0.5)"])
def test_expression_values_equal(text):
    pts = np.random.default_rng(0).random((50, 3))
    env = {"mesh_size_x": 2.0, "mesh_min_x": -0.5}
    out = expr.evaluate(text, pts, env)
    assert out.shape == (50,) and np.array_equal(
        out, rexpr.evaluate(text, pts, env))
    assert np.array_equal(expr.evaluate(1.5, pts), rexpr.evaluate(1.5, pts))


@pytest.mark.parametrize("text", [
    "__import__('os')", "x.real", "[x, y]", "lambda: 1", "open('f')",
    "foo(x)", "x and y", "(x, y)"])
def test_expression_disallowed_raises(text):
    for mod in (expr, rexpr):
        with pytest.raises(ValueError):
            mod.Expression(text)


# -- parse_bc ------------------------------------------------------------------

PARSE_CASES = {
    "box": {"regions": [{"type": "dirichlet", "value": [0, 0, 0],
                         **_box([0, 0, 0], [0, 1, 1], pct=False)}]},
    "box%": {"regions": [{"type": "force", "value": [0, 0, -10], **X1}]},
    "mask_xz": {"regions": [{"type": "dirichletxz", "value": [0.1, 0.2],
                             **X0}]},
    "expression": {"regions": [{"type": "dirichlet",
                                "value": ["0.01*x", "0", "-0.02*y*z"],
                                **X0}]},
    "dirichlet_nodes": {"regions": [{"type": "dirichlet nodes", "values": [
        [[0.1, 0, 0], [0, 1, 2]], [[0, 0.2, 0], [5]]]}]},
    "force_elements": {"regions": [{"type": "force elements", "values": [
        [[1, 0, 0], [[0, 1, 5], [1, 5, 6]]]]}]},
    "element_vertices": {"regions": [{"type": "dirichlet", "value": [0, 0, 0],
                                      "element vertices": [[0, 1, 5]]}]},
    "polygon": {"regions": [{"type": "dirichlet", "value": 0.0,
                             "polygon": [[0, 0], [0.5, 0], [0.5, 0.5],
                                         [0, 0.5]]}]},
    "delta_force": {"regions": [{"type": "delta_force", "value": [0, 1, 0],
                                 **X1}]},
    "pressure": {"regions": [{"type": "pressure", "value": ["1 + x"],
                              **X1}]},
    "traction": {"regions": [{"type": "traction", "value": [0, "y", 0],
                              **X1}]},
    "target": {"regions": [{"type": "targety", "value": [0, 0.1, 0], **X1}]},
    "no_rigid_motion": {"no_rigid_motion": True, "regions": [
        {"type": "force", "value": [1, 0, 0], **X1}]},
}


def _same_regions(a, b):
    assert a.no_rigid_motion == b.no_rigid_motion
    assert len(a.regions) == len(b.regions)
    for p, r in zip(a.regions, b.regions):
        assert (p.type, p.value, p.percent, p.kind, p.component_mask.mask) \
            == (r.type, r.value, r.percent, r.kind, r.component_mask.mask)
        for f in ("min_corner", "max_corner", "polygon", "indices",
                  "indexed_values"):
            x, y = getattr(p, f), getattr(r, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(x, y)
        assert p.element_corners == r.element_corners


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_bc_equal(case):
    text = json.dumps(PARSE_CASES[case])
    _same_regions(bc.parse_bc(text, dim=3), rbc.parse_bc(text, dim=3))


@pytest.mark.parametrize("region", [
    {"type": "bogus", "value": [0], **X0},
    {"type": "dirichlet elements", "values": []},
    {"type": "force nodes", "values": []},
    {"type": "dirichlet", "value": [0, 0, 0]}])
def test_parse_bc_invalid_raises(region):
    text = json.dumps({"regions": [region]})
    for mod in (bc, rbc):
        with pytest.raises(ValueError):
            mod.parse_bc(text)


def test_load_bc(tmp_path):
    path = tmp_path / "case.bc"
    path.write_text(json.dumps(PARSE_CASES["expression"]))
    _same_regions(bc.load_bc(path), rbc.load_bc(path))


# -- apply_boundary_conditions -------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    """grid_tet(4,3,3) P2 in both packages (unit cube)."""
    V, T = generators.grid_tet(4, 3, 3)
    return V, T, rmesh.FEMMesh(V, T, degree=2), FEMMesh(V, T, degree=2)


def _sims(grid, **kw):
    V, T, ref_mesh, mesh = grid
    return (rphys.ElasticitySimulator(
                ref_mesh, rphys.Material.isotropic(3, 200.0, 0.3), **kw),
            ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                                device="cpu", **kw))


def _bdry_tri(mesh, k):
    return [int(v) for v in mesh.bdry_elems[k]]


APPLY_CASES = {
    "clamp_and_force": [{"type": "dirichlet", "value": [0, 0, 0], **X0},
                        {"type": "force", "value": [0, 0, -10], **X1}],
    "mask_expressions": [
        {"type": "dirichletxz", "value": ["0.01*x", "0.02*y*z"], **X0},
        {"type": "dirichlety", "value": [0, "0.1*mesh_size_y", 0],
         **_box([-0.001, -0.001, -0.001], [1.001, 0.001, 1.001])}],
    "neumann_mix": [{"type": "pressure", "value": ["1 + y"], **X1},
                    {"type": "traction", "value": [0, "x*z", 0.5],
                     **_box([-0.001, -0.001, 0.999], [1.001, 1.001, 1.001])},
                    {"type": "force", "value": [1, 2, 3], **X0}],
    "delta_force": [{"type": "delta_force", "value": [0, "z", 1], **X1}],
    "polygon": [{"type": "dirichlet", "value": [0, 0, "0.1*z"],
                 "polygon": [[-0.1, -0.1], [0.6, -0.1], [0.6, 0.6],
                             [-0.1, 0.6]]}],
    "target_and_force": [{"type": "target", "value": [0, 0, 0], **X0},
                         {"type": "force", "value": [0, 1, 0], **X1}],
}


def _apply_both(grid, regions, extra=None):
    rsim, sim = _sims(grid)
    text = json.dumps(dict({"regions": regions}, **(extra or {})))
    rsim.apply_boundary_conditions(rbc.parse_bc(text))
    sim.apply_boundary_conditions(bc.parse_bc(text))
    return rsim, sim


def _same_state(rsim, sim):
    assert np.array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
    assert np.array_equal(sim.dirichlet_values, rsim.dirichlet_values)
    assert len(sim._region_nodes) == len(rsim._region_nodes)
    for a, b in zip(sim._region_nodes, rsim._region_nodes):
        assert np.array_equal(a, b)
    f_ref = np.asarray(rsim.neumann_load)
    assert np.abs(sim.neumann_load.numpy() - f_ref).max() \
        <= 1e-13 * max(np.abs(f_ref).max(), 1.0)
    assert sim.no_rigid_motion == rsim.no_rigid_motion


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_boundary_conditions_equal(grid, case):
    _same_state(*_apply_both(grid, APPLY_CASES[case]))


def test_apply_indexed_regions_equal(grid):
    """dirichlet nodes, element vertices, force / pressure elements and
    delta_force nodes, on boundary entities of the mesh, plus the
    no_rigid_motion flag."""
    mesh = grid[3]
    b = mesh.bdry_nodes
    # boundary triangles clear of the nodes the node sets name
    named = {int(b[i]) for i in (0, 1, 7, 30, 31)}
    tris = [k for k in range(mesh.num_boundary_elements)
            if not named & set(mesh.bdry_elem_nodes[k].tolist())]
    tri = lambda i: _bdry_tri(mesh, tris[i])
    regions = [
        {"type": "dirichlet nodes", "values": [
            [[0.1, 0, 0], [int(b[0]), int(b[1])]], [[0, 0.2, 0], [int(b[7])]]]},
        {"type": "dirichletz", "value": [0, 0, 0.3],
         "element vertices": [tri(0), tri(1)]},
        {"type": "force elements", "values": [
            [[1, 0, 2], [tri(10), tri(11)]]]},
        {"type": "pressure elements", "values": [[[2.0], [tri(20)]]]},
        {"type": "delta_force nodes", "values": [
            [[0, 0, 1], [int(b[30]), int(b[31])]]]}]
    _same_state(*_apply_both(grid, regions, {"no_rigid_motion": True}))


@pytest.mark.parametrize("regions", [
    [{"type": "dirichlet", "value": [0, 0, 0], **X0},
     {"type": "dirichlet", "value": [0.1, 0, 0], **X0}],
    [{"type": "dirichlet", "value": [0, 0, 0],
      **_box([5, 5, 5], [6, 6, 6], pct=False)}],
    [{"type": "force", "value": [0, 0, 1],
      **_box([5, 5, 5], [6, 6, 6], pct=False)}],
    [{"type": "delta_force nodes", "values": [[[0, 0, 1], [10 ** 6]]]}]],
    ids=["conflict", "unmatched_dirichlet", "unmatched_force",
         "delta_out_of_range"])
def test_apply_invalid_raises(grid, regions):
    rsim, sim = _sims(grid)
    text = json.dumps({"regions": regions})
    with pytest.raises(ValueError):
        rsim.apply_boundary_conditions(rbc.parse_bc(text))
    with pytest.raises(ValueError):
        sim.apply_boundary_conditions(bc.parse_bc(text))


def test_interior_node_condition_raises(grid):
    mesh = grid[3]
    interior = int(np.setdiff1d(np.arange(mesh.num_nodes), mesh.bdry_nodes)[0])
    text = json.dumps({"regions": [{"type": "dirichlet nodes", "values": [
        [[0, 0, 0], [interior]]]}]})
    rsim, sim = _sims(grid)
    for s, mod in ((rsim, rbc), (sim, bc)):
        with pytest.raises(ValueError, match="non-boundary"):
            s.apply_boundary_conditions(mod.parse_bc(text))


def test_fix_nodes_periodic_dof_map():
    """The repaired fault: ``fix_nodes`` maps node ids through the dof map
    (``meshfem_tpu/physics/elasticity.py:389``); on a periodic cell the
    masks and values equal the reference's."""
    V, T = generators.grid_tet(3, 3, 3)
    ref_mesh, mesh = rmesh.FEMMesh(V, T, degree=2), FEMMesh(V, T, degree=2)
    dof_map, nd, _ = rperiodic.match_periodic_nodes(
        np.asarray(ref_mesh.node_positions))
    assert nd < mesh.num_nodes
    rsim = rphys.ElasticitySimulator(
        ref_mesh, rphys.Material.isotropic(3, 1.0, 0.3), dof_map=dof_map)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 1.0, 0.3),
                              device="cpu", dof_map=dof_map)
    X = mesh.node_positions
    nodes = np.flatnonzero(X[:, 0] > 1 - 1e-9)          # the x = 1 face
    vals = np.stack([X[nodes, 1], 0.5 * X[nodes, 2], -X[nodes, 1]], axis=1)
    for s in (rsim, sim):
        s.fix_nodes(nodes, vals, components=[0, 2])
        s.fix_nodes(nodes[:3])
    assert np.array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
    assert np.array_equal(sim.dirichlet_values, rsim.dirichlet_values)


# -- the README quick start ----------------------------------------------------

def _port_quickstart_code():
    """The port's quick start exactly as README.md prints it."""
    text = open(os.path.join(REPO, "README.md")).read()
    part = text[text.index("## PyTorch/CUDA port"):]
    return re.search(r"```python\n(.*?)```", part, re.S).group(1)


@pytest.fixture(scope="module")
def quickstart():
    code = _port_quickstart_code()
    assert 'device="cpu"' in code and "meshfem_tpu_torch" in code
    ns = {}
    exec(compile(code, "README.md", "exec"), ns)
    V, T = generators.bar_tet(12, 3, 3, length=4.0)
    mesh = rmesh.FEMMesh(V, T, degree=2)
    rsim = rphys.ElasticitySimulator(
        mesh, rphys.Material.isotropic(3, 200.0, 0.35))
    rsim.fix_nodes(mesh.nodes_in_box((0, 0, 0), (0, 1, 1)))
    rsim.apply_boundary_conditions(rbc.parse_bc(
        '{"regions": [{"type": "force", "value": [0, 0, -10], "box%": '
        '{"minCorner": [0.999, -0.001, -0.001], "maxCorner": '
        '[1.001, 1.001, 1.001]}}]}', dim=3))
    u_ref, _ = rsim.solve(tol=1e-10)
    return ns, rsim, u_ref


def test_readme_quickstart_matches_reference(quickstart):
    ns, rsim, u_ref = quickstart
    sim = ns["sim"]
    assert ns["mesh"].num_elements == 648
    assert np.array_equal(sim.dirichlet_mask, rsim.dirichlet_mask)
    assert _rel(ns["u"], u_ref) < 1e-8
    assert _rel(ns["vm"], rsim.von_mises_field(u_ref)) < 1e-8


@pytest.fixture(scope="module")
def clamped(grid):
    """The clamp-and-force regions on grid_tet(4,3,3) P2, solved in both
    packages to 1e-11."""
    rsim, sim = _apply_both(grid, APPLY_CASES["clamp_and_force"])
    u, _ = sim.solve(tol=1e-11)
    u_ref, _ = rsim.solve(tol=1e-11)
    return rsim, sim, u, u_ref


def test_report_region_surface_forces(clamped):
    """A clamp region's reaction carries the applied force (0, 0, 10)."""
    rsim, sim, u, u_ref = clamped
    f = sim.report_region_surface_forces(u)
    f_ref = np.asarray(rsim.report_region_surface_forces(u_ref))
    assert f.shape == (1, 3) and np.abs(f - f_ref).max() < 1e-8
    assert np.abs(f[0] - [0, 0, 10]).max() < 1e-8


def test_warm_starts(clamped):
    """``solve(operator="ebe", x0=u/2)`` reaches the reference's u;
    ``solve(operator="routed", x0=u)`` returns in 0 refinement rounds;
    x0 = u/2 refines to 1e-10."""
    rsim, sim, u, u_ref = clamped
    ue, res = sim.solve(operator="ebe", tol=1e-10, x0=0.5 * u)
    ur, _ = rsim.solve(operator="ebe", tol=1e-10, x0=0.5 * jnp.asarray(_np(u)))
    assert _rel(ue, u_ref) < 1e-8 and _rel(ue, ur) < 1e-8 and res.iters > 0
    u0, r0 = sim.solve(operator="routed", tol=1e-10, x0=u)
    assert r0.rounds == 0 and r0.iters == 0 and r0.resnorm <= 1e-10
    assert torch.equal(u0, u)
    uh, rh = sim.solve(operator="routed", tol=1e-10, x0=0.5 * u)
    assert rh.rounds >= 1 and rh.resnorm <= 1e-10 and _rel(uh, u_ref) < 1e-8
    with pytest.raises(ValueError, match="x0"):
        sim.solve(operator="structured", x0=u)


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev"])
def test_ebe_refined_matches_reference(clamped, precond):
    """The refined EBE branch, called directly on the CPU in both packages
    (the solve takes it on CUDA, the reference on the TPU); Chebyshev runs
    on the block-Jacobi preconditioner."""
    rsim, sim, u_ebe, u_ref = clamped
    args = (torch.as_tensor(sim.dirichlet_mask),
            torch.as_tensor(sim.dirichlet_values))
    u, res = sim._solve_ebe_refined(sim.neumann_load, *args, 1e-10, 50000,
                                    precond)
    ru, _ = rsim._solve_ebe_refined(
        rsim.neumann_load, jnp.asarray(rsim.dirichlet_mask),
        jnp.asarray(rsim.dirichlet_values), 1e-10, 50000, precond)
    assert res.rounds >= 1 and res.resnorm <= 1e-10
    assert _rel(u, ru) < 1e-8 and _rel(u, u_ref) < 1e-8


# -- the free body (no_rigid_motion) -------------------------------------------

FREE_BC = json.dumps({"no_rigid_motion": True, "regions": [
    {"type": "force", "value": [-1, 0, 0], **X0},
    {"type": "force", "value": [1, 0, 0], **X1}]})


@pytest.fixture(scope="module")
def free_body(grid):
    rsim, sim = _sims(grid)
    rsim.apply_boundary_conditions(rbc.parse_bc(FREE_BC))
    sim.apply_boundary_conditions(bc.parse_bc(FREE_BC))
    Q, _ = np.linalg.qr(sim.rigid_modes())
    X = sim.mesh.node_positions
    exact = np.stack([X[:, 0] / 200, -0.3 * X[:, 1] / 200,
                      -0.3 * X[:, 2] / 200], axis=1)

    def free_part(u):
        u = _np(u).reshape(-1)
        return (u - Q @ (Q.T @ u)).reshape(-1, 3)

    u_ref, _ = rsim.solve(tol=1e-10)
    return rsim, sim, free_part, exact, u_ref


@pytest.mark.parametrize("precond", ["jacobi", "block", "chebyshev"])
def test_free_body_ebe_matches_reference(free_body, precond):
    rsim, sim, free_part, _, _ = free_body
    u, res = sim.solve(tol=1e-10, precond=precond)
    ur, rres = rsim.solve(tol=1e-10, precond=precond)
    assert abs(res.iters - int(rres.iters)) <= 2
    assert _rel(u, ur) < 1e-8


def test_free_body_routed_matches_reference(free_body):
    rsim, sim, free_part, _, u_ref = free_body
    u, res = sim.solve(operator="routed", tol=1e-10)
    assert res.rounds >= 1 and res.resnorm <= 1e-10
    assert _rel(free_part(u), free_part(u_ref)) < 1e-8


@pytest.mark.parametrize("operator", ["ebe", "routed"])
def test_free_body_analytic(free_body, operator):
    """A uniform traction on the unit cube: stress (1, 0, 0, 0, 0, 0) on
    every element, u equal to (x, -nu y, -nu z) / E up to a rigid motion
    (P2 holds the linear field exactly)."""
    _, sim, free_part, exact, _ = free_body
    u, _ = sim.solve(operator=operator, tol=1e-12)
    s = sim.average_stress_field(u).numpy()
    assert np.abs(s - [1, 0, 0, 0, 0, 0]).max() < 1e-9
    assert _rel(free_part(u), free_part(exact)) < 1e-9


def test_free_body_stress_at(free_body):
    rsim, sim, _, _, u_ref = free_body
    s = sim.stress_at(torch.as_tensor(_np(u_ref)))
    assert s.shape == (sim.mesh.num_elements, 4, 6)
    assert _rel(s, rsim.stress_at(u_ref)) < 1e-12


def test_rigid_projector_float32_built_in_float64(free_body, monkeypatch):
    """The port builds its float32 rigid-mode basis in float64 and casts
    it; building it in float32 (the reference's way) gives the same u."""
    _, sim, free_part, _, _ = free_body
    u64, _ = sim.solve(operator="routed", tol=1e-10)
    built = cg_mod.nullspace_projector

    def in_float32(Z, dtype=None):
        return built(Z if dtype is None else Z.to(dtype))

    monkeypatch.setattr(cg_mod, "nullspace_projector", in_float32)
    u32, res = sim.solve(operator="routed", tol=1e-10)
    assert res.resnorm <= 1e-10
    assert _rel(free_part(u32), free_part(u64)) < 1e-8


def test_free_body_refined_matches_reference(free_body):
    """Rigid modes removed: the float32 inner solves leave a rigid
    component of ~1e-8 of max|u| that neither package corrects (K Z = 0),
    and the two build their float32 projectors differently."""
    rsim, sim, free_part, _, _ = free_body
    args = (torch.as_tensor(sim.dirichlet_mask),
            torch.as_tensor(sim.dirichlet_values))
    u, res = sim._solve_ebe_refined(sim.neumann_load, *args, 1e-10, 50000,
                                    "jacobi")
    ru, _ = rsim._solve_ebe_refined(
        rsim.neumann_load, jnp.asarray(rsim.dirichlet_mask),
        jnp.asarray(rsim.dirichlet_values), 1e-10, 50000, "jacobi")
    assert res.resnorm <= 1e-10
    assert _rel(free_part(u), free_part(ru)) < 1e-8


def test_rigid_modes_and_posedness(free_body):
    rsim, sim, _, _, _ = free_body
    for t in (False, True):
        assert np.array_equal(sim.rigid_modes(t), rsim.rigid_modes(t))
    nt, nr = sim.analyze_dirichlet_posedness()
    assert nt.all() and nr


@pytest.mark.parametrize("case", ["face", "x_only", "three_points"])
def test_analyze_dirichlet_posedness(grid, case):
    """One face clamped (posed); only x components on a face
    (translations y, z and a rotation free); three pinned points."""
    mesh = grid[3]
    X = mesh.node_positions
    face = np.flatnonzero(X[:, 0] < 1e-9)
    sims = _sims(grid)
    for s in sims:
        if case == "face":
            s.fix_nodes(face)
        elif case == "x_only":
            s.fix_nodes(face, components=[0])
        else:
            pts = [int(np.argmin(np.abs(X - p).sum(axis=1)))
                   for p in ((0, 0, 0), (1, 0, 0), (0, 1, 0))]
            s.fix_nodes(pts)
    (rt, rr), (pt, pr) = (s.analyze_dirichlet_posedness() for s in sims)
    assert np.array_equal(pt, rt) and pr == rr
    if case == "x_only":
        assert list(pt) == [False, True, True] and pr


def test_clear_and_interop(free_body):
    """``simulator_from_arrays`` carries no_rigid_motion and the region
    lists across; ``clear_boundary_conditions`` resets them."""
    rsim, sim, _, _, u_ref = free_body
    mesh = rsim.mesh
    s2 = interop.simulator_from_arrays(dict(
        V=mesh.V, T=mesh.F, degree=mesh.degree, D=np.asarray(rsim.D),
        dirichlet_mask=rsim.dirichlet_mask,
        dirichlet_values=rsim.dirichlet_values,
        neumann_load=np.asarray(rsim.neumann_load),
        no_rigid_motion=rsim.no_rigid_motion,
        region_nodes=rsim._region_nodes), device="cpu")
    assert s2.no_rigid_motion
    u, _ = s2.solve(tol=1e-10)
    assert _rel(u, u_ref) < 1e-8
    s2.clear_boundary_conditions()
    assert not (s2.no_rigid_motion or s2.dirichlet_mask.any()
                or s2._region_nodes or bool(s2.neumann_load.any()))


def test_to_scipy(grid):
    rsim, sim = _sims(grid)
    A, Ar = sim.to_scipy(), rsim.to_scipy()
    assert A.shape == Ar.shape and np.array_equal(A.indptr, Ar.indptr) \
        and np.array_equal(A.indices, Ar.indices)
    assert np.abs(A.data - Ar.data).max() <= 1e-14 * np.abs(Ar.data).max()


# -- mesh queries --------------------------------------------------------------

def test_femmesh_queries(grid):
    _, _, ref_mesh, mesh = grid
    assert np.array_equal(mesh.barycenters(), ref_mesh.barycenters())
    assert np.array_equal(mesh.boundary_barycenters(),
                          ref_mesh.boundary_barycenters())
    assert mesh.volume("cpu") == pytest.approx(ref_mesh.volume(), rel=1e-14)
    assert mesh.boundary_volume("cpu") == pytest.approx(
        ref_mesh.boundary_volume(), rel=1e-14)
    m = mesh.node_mass_lumped("cpu")
    assert m.dtype == torch.float64 and _rel(m, ref_mesh.node_mass_lumped()) \
        < 1e-14
    lo, hi = (0.2, 0, 0.3), (0.8, 1, 1)
    assert np.array_equal(mesh.nodes_in_box(lo, hi),
                          ref_mesh.nodes_in_box(lo, hi))
    assert np.array_equal(mesh.boundary_elems_in_box(lo, hi),
                          ref_mesh.boundary_elems_in_box(lo, hi))


# -- solver helpers ------------------------------------------------------------

@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(7)
    B = rng.standard_normal((40, 40))
    A = B @ B.T + 40 * np.eye(40)
    return A, rng.standard_normal(40), rng.standard_normal(40)


def test_cg_x0_atol_matches_reference(spd):
    A, b, x0 = spd
    At = torch.as_tensor(A)
    for kw in ({}, {"atol": 1e-3, "tol": 0.0}):
        res = cg_mod.cg(lambda v: At @ v, torch.as_tensor(b),
                        torch.as_tensor(x0), tol=kw.get("tol", 1e-12),
                        atol=kw.get("atol", 0.0), maxiter=200)
        ref = rcg.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                     jnp.asarray(x0), tol=kw.get("tol", 1e-12),
                     atol=kw.get("atol", 0.0), maxiter=200)
        assert res.iters == int(ref.iters)
        assert _rel(res.x, ref.x) < 1e-10


def test_refine_x0_matches_reference(spd):
    A, b, x0 = spd
    A32 = A.astype(np.float32)
    sol = np.linalg.solve(A, b)

    def lo(r):
        return (torch.as_tensor(np.linalg.solve(A32, _np(r))), 3)

    def rlo(r):
        return (jnp.asarray(np.linalg.solve(A32, np.asarray(r))), 3)

    res = refine_mod.refine(lambda x: torch.as_tensor(A) @ x, lo,
                            torch.as_tensor(b), tol=1e-12,
                            x0=torch.as_tensor(x0))
    ref = rrefine.refine(lambda x: jnp.asarray(A) @ x, rlo, jnp.asarray(b),
                         tol=1e-12, x0=jnp.asarray(x0))
    assert res.rounds == ref.rounds and res.inner_iters == ref.inner_iters
    assert _rel(res.x, ref.x) < 1e-12 and _rel(res.x, sol) < 1e-11
    done = refine_mod.refine(lambda x: torch.as_tensor(A) @ x, lo,
                             torch.as_tensor(b), tol=1e-12,
                             x0=torch.as_tensor(sol))
    assert done.rounds == 0 and done.inner_iters == 0


def test_fixed_iteration_cg_matches_reference(spd):
    A, b, x0 = spd
    res = cg_mod.cg_fixed_iters(lambda v: torch.as_tensor(A) @ v,
                                torch.as_tensor(b), torch.as_tensor(x0),
                                iters=12)
    ref = rcg.cg_fixed_iters(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                             jnp.asarray(x0), iters=12)
    assert res.iters == 12 and _rel(res.x, ref.x) < 1e-12
    assert res.resnorm == pytest.approx(float(ref.resnorm), rel=1e-9)


def test_operator_fixed_and_solve_dirichlet(grid):
    rsim, sim = _sims(grid)
    n = sim.num_dofs
    rng = np.random.default_rng(3)
    b = rng.standard_normal((n, 3))
    fixed = np.zeros((n, 3), bool)
    fixed[:40] = True
    vals = rng.standard_normal((n, 3))
    res = cg_mod.cg_operator_fixed(sim._kernel, torch.as_tensor(b),
                                   sim.K_diagonal(),
                                   torch.as_tensor(~fixed), iters=30)
    ref = rcg.cg_operator_fixed(rsim._kernel, jnp.asarray(b),
                                rsim.K_diagonal(), jnp.asarray(~fixed),
                                iters=30)
    assert _rel(res.x, ref.x) < 1e-10
    res = cg_mod.solve_dirichlet(sim.apply_K, torch.as_tensor(b),
                                 torch.as_tensor(fixed), torch.as_tensor(vals),
                                 tol=1e-11, maxiter=3000)
    ref = rcg.solve_dirichlet(rsim.apply_K, jnp.asarray(b),
                              jnp.asarray(fixed), jnp.asarray(vals),
                              tol=1e-11, maxiter=3000)
    assert _rel(res.x, ref.x) < 1e-8
    assert np.array_equal(res.x.numpy()[fixed], vals[fixed])


def test_nullspace_projector_matches_reference(grid):
    _, sim = _sims(grid)
    Z = sim.rigid_modes()
    v = np.random.default_rng(4).standard_normal((sim.num_dofs, 3))
    p = cg_mod.nullspace_projector(torch.as_tensor(Z))(torch.as_tensor(v))
    pr = rcg.nullspace_projector(jnp.asarray(Z))(jnp.asarray(v))
    assert p.shape == v.shape and _rel(p, pr) < 1e-12
    assert np.abs(Z.T @ p.numpy().reshape(-1)).max() < 1e-10
    p32 = cg_mod.nullspace_projector(torch.as_tensor(Z), dtype=torch.float32)
    assert p32(torch.as_tensor(v, dtype=torch.float32)).dtype == torch.float32


# -- materials and tensors -----------------------------------------------------

MODULI3 = [200.0, 150.0, 100.0, 0.25, 0.2, 0.3, 40.0, 50.0, 60.0]
MODULI2 = [200.0, 120.0, 0.3, 45.0]


def test_material_tensors_match_reference():
    for dim, mod in ((3, MODULI3), (2, MODULI2)):
        assert _rel(Material.orthotropic(dim, mod).D,
                    rphys.Material.orthotropic(dim, mod).D) < 1e-13
    A = np.random.default_rng(2).standard_normal((6, 6))
    assert _rel(Material.anisotropic(3, A).D,
                rphys.Material.anisotropic(3, A).D) < 1e-15
    assert isinstance(Material.isotropic(3, 1.0, 0.3).tensor,
                      et.ElasticityTensor)


MATERIAL_FILES = {
    "isotropic": {"type": "isotropic_material", "dim": 3, "young": 200.0,
                  "poisson": 0.3},
    "orthotropic3": dict(zip(
        ["young_x", "young_y", "young_z", "poisson_yx", "poisson_zx",
         "poisson_zy", "shear_yz", "shear_zx", "shear_xy"], MODULI3),
        type="orthotropic_material", dim=3),
    "orthotropic2": dict(zip(["young_x", "young_y", "poisson_yx",
                              "shear_xy"], MODULI2),
                         type="orthotropic_material", dim=2),
    "anisotropic": {"type": "anisotropic_material", "dim": 3,
                    "material_matrix": (np.eye(6) * 50 + 1).tolist()},
}


@pytest.mark.parametrize("case", sorted(MATERIAL_FILES))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_material_files_cross(tmp_path, case, writer):
    """``save_material`` with one package, ``load_material`` with the
    other.  The reference reads an "anisotropic_material" file as
    isotropic ("isotropic" is in the type name) and fails on the missing
    moduli; the port tests "anisotropic" first and reads both packages'
    files."""
    data = MATERIAL_FILES[case]
    path = tmp_path / "m.material"
    if case == "anisotropic":
        D_ref = rmats.Material.anisotropic(3, data["material_matrix"]).D
        rmat = rmats.Material.anisotropic(3, data["material_matrix"])
    else:
        D_ref = rmats.parse_material(data).D
        rmat = rmats.parse_material(data)
    if writer == "port":
        mats.save_material(mats.parse_material(data), path)
        if case == "anisotropic":
            with pytest.raises(KeyError):
                rmats.load_material(path)
            other = mats.load_material(path)
        else:
            other = rmats.load_material(path)
    else:
        rmats.save_material(rmat, path)
        other = mats.load_material(path)
    assert _rel(mats.parse_material(data).D, D_ref) < 1e-14
    assert _rel(other.D, D_ref) < 1e-14
    assert other.type == mats.parse_material(data).type


def test_material_fits_match_reference():
    rng = np.random.default_rng(9)
    eps = 1e-3 * rng.standard_normal((12, 6))
    vol = rng.random(12) + 0.5
    for D in (et.isotropic(3, 150.0, 0.28), et.orthotropic(3, MODULI3)):
        sig = et.double_contract(D, torch.as_tensor(eps)).numpy()
        fi, rfi = (m.fit_isotropic(eps, sig, vol) for m in (mats, rmats))
        assert np.allclose(fi, rfi, rtol=1e-10, atol=0)
        fo, rfo = (m.fit_orthotropic(eps, sig, vol) for m in (mats, rmats))
        assert fo.keys() == rfo.keys()
        for k in fo:
            assert fo[k] == pytest.approx(rfo[k], rel=1e-10)
    assert fo["Ex"] == pytest.approx(MODULI3[0], rel=1e-8)


def _random_spd_tensors(n=4):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        B = rng.standard_normal((6, 6))
        out.append(B @ B.T + 6 * np.eye(6))
    return np.stack(out)


def _rotation():
    q, _ = np.linalg.qr(np.random.default_rng(12).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


TENSOR_OPS = {
    "double_contract": lambda m, D, E: m.double_contract(D, E[:, 0]),
    "double_contract_tensor": lambda m, D, E: m.double_contract_tensor(D, E),
    "double_double_contract": lambda m, D, E: m.double_double_contract(D, E),
    "quadruple_contract": lambda m, D, E: m.quadruple_contract(D, E),
    "frobenius_norm_sq": lambda m, D, E: m.frobenius_norm_sq(D),
    "inverse": lambda m, D, E: m.inverse(D),
    "pseudoinverse": lambda m, D, E: m.pseudoinverse(D),
    "eigenvalues": lambda m, D, E: m.eigenstrains(D)[1],
    "to_full_from_full": lambda m, D, E: m.from_full(m.to_full(D) * 2),
    "transform": lambda m, D, E: m.transform(D, _rotation()),
    "apply_D": lambda m, D, E: m.apply_D(D, E[:, 1]),
    "d_row": lambda m, D, E: m.d_row_as_sym_flat(D, 4),
    "identity_orthotropic": lambda m, D, E: m.identity(3)
    + m.orthotropic(3, MODULI3),
}


@pytest.mark.parametrize("op", sorted(TENSOR_OPS))
def test_elasticity_tensor_functions(op):
    Ds = _random_spd_tensors()
    Es = _random_spd_tensors()[::-1].copy()
    fn = TENSOR_OPS[op]
    if op == "transform":
        R = _rotation()
        out = et.transform(torch.as_tensor(Ds), torch.as_tensor(R))
        ref = ret.transform(jnp.asarray(Ds), jnp.asarray(R))
    else:
        out = fn(et, torch.as_tensor(Ds), torch.as_tensor(Es))
        ref = fn(ret, jnp.asarray(Ds), jnp.asarray(Es))
    assert tuple(out.shape) == tuple(ref.shape)
    assert _rel(out, ref) < 1e-12


def test_eigenstrains_and_class():
    """Eigenstrains up to sign, and the ElasticityTensor methods."""
    D = _random_spd_tensors(1)[0]
    s, lam = et.eigenstrains(torch.as_tensor(D))
    rs, rlam = ret.eigenstrains(jnp.asarray(D))
    assert _rel(lam, rlam) < 1e-12
    sgn = np.sign((s.numpy() * np.asarray(rs)).sum(axis=0))
    assert _rel(s.numpy() * sgn, rs) < 1e-10
    T, R = et.ElasticityTensor(torch.as_tensor(D)), \
        ret.ElasticityTensor(jnp.asarray(D))
    O = et.ElasticityTensor.orthotropic(3, *MODULI3)
    RO = ret.ElasticityTensor.orthotropic(3, *MODULI3)
    for a, b in ((T.inverse().D, R.inverse().D),
                 (T.transform(_rotation()).D, R.transform(_rotation()).D),
                 (T.double_contract(O).D, R.double_contract(RO).D),
                 (T.double_double_contract(O).D,
                  R.double_double_contract(RO).D),
                 ((T + O - 2.0 * O).D, (R + RO - 2.0 * RO).D),
                 (T.to_full(), R.to_full()),
                 (et.ElasticityTensor.anisotropic(D + 0.1).D,
                  ret.ElasticityTensor.anisotropic(D + 0.1).D)):
        assert _rel(a, b) < 1e-12
    assert float(T.quadruple_contract(O)) == pytest.approx(
        float(R.quadruple_contract(RO)), rel=1e-12)
    assert float(T.component(0, 1, 1, 2)) == float(R.component(0, 1, 1, 2))
    for a, b in zip(O.get_orthotropic_parameters(),
                    RO.get_orthotropic_parameters()):
        assert float(a) == pytest.approx(float(b), rel=1e-12)
    assert [float(v) for v in O.get_orthotropic_parameters()] == \
        pytest.approx(MODULI3, rel=1e-12)
    assert et.ElasticityTensor.zero(3).D.abs().max() == 0


def test_tensor_projection_matches_reference():
    Ds = _random_spd_tensors()
    proj, ch, cd = tp.closest_isotropic_tensor(torch.as_tensor(Ds))
    rproj, rch, rcd = rtp.closest_isotropic_tensor(jnp.asarray(Ds))
    assert _rel(proj, rproj) < 1e-12 and _rel(ch, rch) < 1e-12 \
        and _rel(cd, rcd) < 1e-12
    assert _rel(tp.isotropy_distance(torch.as_tensor(Ds)),
                rtp.isotropy_distance(jnp.asarray(Ds))) < 1e-12
    iso = et.isotropic(3, 100.0, 0.3)
    assert float(tp.isotropy_distance(iso)) < 1e-14


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _free_sim(device):
    V, T = generators.grid_tet(6, 4, 4)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3),
                              device=device)
    sim.apply_boundary_conditions(bc.parse_bc(FREE_BC))
    return sim


@pytest.mark.cuda
def test_cuda_routed_free_body_matches_cpu(cuda):
    """The routed projection in planes on the card: a free body through
    the routed operator against the float64 EBE solve on the CPU, rigid
    modes removed, 1e-8; the stress is uniform."""
    from meshfem_tpu_torch import kernels

    sim, ref = _free_sim(cuda), _free_sim("cpu")
    kernels.reset_launch_counts()
    u, res = sim.solve(operator="routed", tol=1e-10)
    assert kernels.gather_rows.launches > 0 and res.resnorm <= 1e-10
    uc, _ = ref.solve(operator="ebe", tol=1e-10)
    Q, _ = np.linalg.qr(ref.rigid_modes())
    part = lambda v: _np(v).reshape(-1) - Q @ (Q.T @ _np(v).reshape(-1))
    assert _rel(part(u), part(uc)) < 1e-8
    s = sim.average_stress_field(u).cpu().numpy()
    assert np.abs(s - [1, 0, 0, 0, 0, 0]).max() < 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("rigid", [False, True])
def test_cuda_ebe_refined_matches_cpu(cuda, rigid):
    """``solve(tol=1e-10)`` of a small mesh on the card takes the refined
    EBE branch (kernel B in float and double) and matches the CPU's
    float64 solve to 1e-8."""
    from meshfem_tpu_torch import kernels

    def build(device):
        if rigid:
            return _free_sim(device)
        V, T = generators.bar_tet(12, 3, 3, length=4.0)
        mesh = FEMMesh(V, T, degree=2)
        sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.35),
                                  device=device)
        sim.fix_nodes(mesh.nodes_in_box((0, 0, 0), (0, 1, 1)))
        sim.apply_boundary_conditions(bc.parse_bc(json.dumps({"regions": [
            {"type": "force", "value": [0, 0, -10], **X1}]})))
        return sim

    sim, ref = build(cuda), build("cpu")
    kernels.reset_launch_counts()
    u, res = sim.solve(tol=1e-10)
    torch.cuda.synchronize()
    assert sim._kernel32 is not None and res.rounds >= 1
    assert kernels.segment_sum_rows.launches > 0
    uc, _ = ref.solve(tol=1e-10)
    Q, _ = np.linalg.qr(ref.rigid_modes())
    part = (lambda v: _np(v).reshape(-1) - Q @ (Q.T @ _np(v).reshape(-1))) \
        if rigid else _np
    assert _rel(part(u), part(uc)) < 1e-8
