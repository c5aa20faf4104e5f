"""Each configuration and traffic at a tiny mesh on the CPU: the port
through the harness, and the port against the plain reference."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fembench import spec, traffic as traffic_mod
from fembench.reference import elastic, mesh as ref_mesh
from fembench.tests.cpu import CPU, cpu_run, routed_on_cpu, tiny, within

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("n", [2, 5])
def test_grid_is_the_ports_kuhn_grid(n):
    from meshfem_tpu_torch.mesh import generators

    V, T = traffic_mod.grid_tet(n)
    V2, T2 = generators.grid_tet(n, n, n)
    assert np.array_equal(V, V2) and np.array_equal(T, T2)


@pytest.mark.parametrize("name,grid", [("kuhn64", True),
                                       ("unstructured36", False)])
def test_structured_path_sees_the_grid_only_where_meant(name, grid):
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.ops.structured import validate_kuhn_grid

    traffic = json.loads((spec.HERE / "traffic" / f"{name}.json")
                         .read_text())
    traffic["mesh"]["n"] = 4
    mesh = FEMMesh(*traffic_mod.make_mesh(traffic["mesh"]), degree=2)
    if grid:
        validate_kuhn_grid(mesh)
    else:
        with pytest.raises(ValueError):
            validate_kuhn_grid(mesh)


def test_job_streams_repeat_by_seed_and_cycle_whole_sets():
    jobs = {"d": {"cycle": [1, 2, 3]}, "m": {"log_uniform": [0.1, 10.0]},
            "v": {"unit_vector": 3}, "u": {"uniform": [0.2, 0.4]}}
    seed = 2 ** 31 + 12345
    a = [traffic_mod.JobStream(jobs, seed).next() for _ in range(1)]
    s1, s2 = traffic_mod.JobStream(jobs, seed), traffic_mod.JobStream(jobs,
                                                                     seed)
    draws = [s1.next() for _ in range(6)]
    assert draws == [s2.next() for _ in range(6)] and draws[0] == a[0]
    assert sorted(d["d"] for d in draws[:3]) == [1, 2, 3]
    assert sorted(d["d"] for d in draws[3:]) == [1, 2, 3]
    assert all(0.1 <= d["m"] <= 10.0 and 0.2 <= d["u"] <= 0.4
               and abs(np.linalg.norm(d["v"]) - 1) < 1e-12 for d in draws)
    other = traffic_mod.JobStream(jobs, seed + 1)
    assert [other.next() for _ in range(6)] != draws


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name, trace):
    cell = spec.load_cell(name)
    res = cpu_run(name, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert within(res["checks"])
    if trace:
        names = {m["name"] for m in cell.per_layer}
        assert set(res["metrics"]) <= names
        # device numbers (events, the profiler) are left out on the CPU
        assert {"mesh_s"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def _port_solve(traffic, params):
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           parse_bc)

    cell = spec.load_cell("clamped.unstructured36")
    config_mod = cell.module()
    problem = config_mod.Problem(cell.config, traffic, CPU)
    V, T = traffic_mod.make_mesh(traffic["mesh"])
    mesh = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device=CPU)
    sim.apply_boundary_conditions(parse_bc(problem.bc(params), dim=3))
    with routed_on_cpu():
        u, _ = sim.solve(tol=1e-10)
    return V, T, mesh, sim, u


@pytest.mark.parametrize("traffic_name", ["unstructured36", "kuhn64"])
def test_static_solve_matches_the_reference_solve(traffic_name):
    cell = spec.load_cell("clamped.unstructured36")
    traffic = tiny(cell, 4)
    traffic["mesh"] = dict(json.loads((spec.HERE / "traffic"
                                       / f"{traffic_name}.json").read_text())
                           ["mesh"], n=4)
    params = {"direction": [0.0, 0.6, 0.8], "magnitude": 2.5}
    V, T, mesh, sim, u = _port_solve(traffic, params)
    ref = ref_mesh.p2_mesh(V, T)
    perm, gap = ref_mesh.match_nodes(ref.nodes, mesh.node_positions)
    assert gap == 0.0
    el = elastic.Elasticity(ref, 200.0, 0.3, CPU)
    free = torch.as_tensor(ref.nodes[:, 0] > 1e-9).double()[:, None]
    b = el.traction_load([0.0, 1.5, 2.0]) * free
    x, _ = elastic.pcg(el.apply, b, el.diagonal(), free=free, tol=1e-13)
    ur = torch.empty_like(u)
    ur[torch.as_tensor(perm)] = u
    assert float((ur - x).abs().max() / x.abs().max()) < 1e-8
    vm = sim.von_mises_field(u)
    assert float((vm - el.von_mises(ur)).abs().max() / vm.max()) < 1e-12


def test_operator_matches_the_reference_operator():
    cell = spec.load_cell("clamped.unstructured36")
    traffic = tiny(cell, 3)
    V, T, mesh, sim, _ = _port_solve(traffic, {"direction": [1.0, 0, 0],
                                               "magnitude": 1.0})
    ref = ref_mesh.p2_mesh(V, T)
    perm, _ = ref_mesh.match_nodes(ref.nodes, mesh.node_positions)
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (mesh.num_nodes, 3)))
    ur = torch.empty_like(u)
    ur[torch.as_tensor(perm)] = u
    Ku = sim.apply_K(u)
    Kr = elastic.Elasticity(ref, 200.0, 0.3, CPU).apply(ur)
    assert float((Kr[torch.as_tensor(perm)] - Ku).abs().max()
                 / Ku.abs().max()) < 1e-12


def test_homogenized_tensor_matches_the_reference_solve():
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import Material

    cell = spec.load_cell("homog.voidcell36")
    V, T = traffic_mod.make_mesh(tiny(cell, 5)["mesh"])
    mesh = FEMMesh(V, T, degree=2)
    with routed_on_cpu():
        res = hom.homogenize(mesh, Material.isotropic(3, 7.0, 0.35),
                             tol=1e-10, device=CPU)
    ref = ref_mesh.p2_mesh(V, T)
    dof, nd = ref_mesh.periodic_dofs(ref.nodes)
    sim = hom.periodic_simulator(mesh, Material.isotropic(3, 7.0, 0.35),
                                 device=CPU)
    perm, _ = ref_mesh.match_nodes(ref.nodes, mesh.node_positions)
    # the same identification: nodes share a port dof iff they share one
    pairs = np.unique(np.stack([sim.dof_map, dof[perm]], 1), axis=0)
    assert len(pairs) == nd == sim.num_dofs
    el = elastic.Elasticity(ref, 7.0, 0.35, CPU, dof=dof, num_dofs=nd)
    P = elastic.project_translations
    X, _ = elastic.pcg(lambda v: P(el.apply(v)), el.cell_loads(),
                       el.diagonal(), project=P, tol=1e-13)
    w = X.permute(2, 0, 1)[:, el.dof]
    Ch = el.homogenized_tensor(w)
    assert float((res.Ch - Ch).abs().max() / Ch.abs().max()) < 1e-8
