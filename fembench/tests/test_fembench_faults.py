"""``correct`` comes out false: for each cell's control (one precision
below the configuration's, ``configs/<config>.py::control``, here at a
tiny mesh; on the card at the cell's own size by ``fembench/control.py``),
and for a run whose timed path is broken underneath, once for each fault
the cell can have.

The faults: a step that returns its state unchanged (the solve hands back
its starting point, zero); half of the batch left out (the six cell
problems solved for three, the other three left at zero); an answer
altered where it is produced (one displacement, one von Mises stress,
one tensor entry, one fluctuation value).  The exchange between chips
has no counterpart: every cell runs on one chip."""

from __future__ import annotations

import pytest
import torch

from fembench import spec, traffic as traffic_mod
from fembench.tests.cpu import CPU, cpu_run, routed_on_cpu, tiny, within

CELLS = ["clamped.unstructured36", "homog.voidcell36", "clamped.kuhn64"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(2)
    cell = spec.load_cell(name)
    config_mod = cell.module()
    traffic = tiny(cell)
    problem = config_mod.Problem(cell.config, traffic, CPU)
    problem.setup({})
    with routed_on_cpu():
        problem.job(traffic_mod.JobStream(traffic["jobs"], 0, 1).next())
        stream = traffic_mod.JobStream(traffic["jobs"], 99)
        kept, nodes = [], None
        for k in range(2):
            params = stream.next()
            out, nodes = config_mod.control(problem, params)
            kept.append((dict(index=k, params=params), out))
    inputs = problem.release()
    if nodes is not None:
        inputs["nodes"] = nodes
    checks = config_mod.judge(cell.config, traffic, inputs, kept, CPU)
    assert not within(checks)
    assert checks["relres"]["value"] > 100 * checks["relres"]["limit"]


def _patch(monkeypatch, owner, name, make):
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))


def _solve_fault(kind):
    def make(solve):
        def broken(sim, *args, **kw):
            u, res = solve(sim, *args, **kw)
            if kind == "unchanged":
                u = torch.zeros_like(u)
            else:
                u = u.clone()
                u[u.shape[0] // 2, 1] += 1e-6 * float(u.abs().max())
            return u, res
        return broken
    return make


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
@pytest.mark.parametrize("name", ["clamped.unstructured36", "clamped.kuhn64"])
def test_broken_static_solve_is_not_correct(monkeypatch, name, kind):
    from meshfem_tpu_torch.physics.elasticity import ElasticitySimulator

    _patch(monkeypatch, ElasticitySimulator, "solve", _solve_fault(kind))
    res = cpu_run(name)
    assert not res["correct"] and not within(res["checks"])


def test_altered_von_mises_is_not_correct(monkeypatch):
    from meshfem_tpu_torch.physics.elasticity import ElasticitySimulator

    def make(vm_field):
        def broken(sim, u):
            vm = vm_field(sim, u).clone()
            vm[len(vm) // 3] *= 1 + 1e-6
            return vm
        return broken

    _patch(monkeypatch, ElasticitySimulator, "von_mises_field", make)
    res = cpu_run("clamped.unstructured36")
    assert not res["correct"]
    assert res["checks"]["vm_gap"]["value"] > res["checks"]["vm_gap"]["limit"]


def _cells_fault(kind):
    def make(solve_cells):
        def broken(sim, *args, **kw):
            w, iters = solve_cells(sim, *args, **kw)
            w = w.clone()
            if kind == "unchanged":
                w.zero_()
            elif kind == "half":
                w[3:] = 0.0
            else:
                w[1, w.shape[1] // 2, 0] += 1e-6 * float(w.abs().max())
            return w, iters
        return broken
    return make


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_cell_problems_are_not_correct(monkeypatch, kind):
    from meshfem_tpu_torch.analysis import homogenization as hom

    _patch(monkeypatch, hom, "solve_cell_problems", _cells_fault(kind))
    res = cpu_run("homog.voidcell36")
    assert not res["correct"] and not within(res["checks"])


def test_altered_tensor_is_not_correct(monkeypatch):
    from meshfem_tpu_torch.analysis import homogenization as hom

    def make(tensor):
        def broken(*args, **kw):
            Ch = tensor(*args, **kw).clone()
            Ch[2, 4] += 1e-6 * float(Ch.abs().max())
            return Ch
        return broken

    _patch(monkeypatch, hom, "homogenized_tensor_stress_form", make)
    res = cpu_run("homog.voidcell36")
    assert not res["correct"]
    assert res["checks"]["ch_gap"]["value"] > res["checks"]["ch_gap"]["limit"]


def test_a_run_that_leaves_the_path_is_not_correct(monkeypatch):
    """The path guard: a routed cell whose solve takes another operator
    counts its jobs as failed (here the float64 EBE path, as the port
    takes on the CPU by default)."""
    import time

    from fembench import harness

    cell = spec.load_cell("clamped.unstructured36")
    torch.set_num_threads(2)
    with pytest.raises(RuntimeError, match="left the cell's path"):
        harness.run(cell, 5, 0.2, False, CPU, time.perf_counter(),
                    traffic=tiny(cell))
