"""The port's tracer (``meshfem_tpu_torch/utils/timer.py``) inside
``solve`` and ``homogenize``: nothing is recorded while it is off; with
it on, one request's spans nest inside each other and share their root's
index, the refinement's spans and the CG counters agree with what the
solve returns, and no section synchronises the card."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material, parse_bc
from meshfem_tpu_torch.solvers import cg as cg_mod
from meshfem_tpu_torch.utils import timer as tm

CPU = torch.device("cpu")
CLAMPED_BC = json.dumps({"regions": [
    {"type": "dirichlet", "value": [0.0, 0.0, 0.0],
     "box%": {"minCorner": [-0.01, -0.01, -0.01],
              "maxCorner": [0.01, 1.01, 1.01]}},
    {"type": "traction", "value": [0.0, 0.3, 1.0],
     "box%": {"minCorner": [0.99, -0.01, -0.01],
              "maxCorner": [1.01, 1.01, 1.01]}}]})


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tracer(monkeypatch):
    """The global tracer, on, with nothing recorded; off again after."""
    monkeypatch.setattr(tm.GLOBAL_TIMER, "enabled", True)
    tm.GLOBAL_TIMER.reset()
    yield tm.GLOBAL_TIMER
    tm.GLOBAL_TIMER.enabled = False
    tm.GLOBAL_TIMER.reset()


@pytest.fixture
def routed(monkeypatch):
    """The routed operator on the CPU, where the card would take it."""
    monkeypatch.setattr(ElasticitySimulator, "_routed_auto",
                        lambda self: True)


@pytest.fixture
def no_sync(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a section synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)


@pytest.fixture
def reads(monkeypatch):
    """The CG loops' timed flag reads, counted: [number]."""
    n = [0]
    timed = cg_mod._read

    def counted(flag, wait):
        n[0] += wait is not None
        return timed(flag, wait)

    monkeypatch.setattr(cg_mod, "_read", counted)
    return n


def _clamped(n):
    V, T = generators.grid_tet(n, n, n)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3), device=CPU)
    return sim


def _job(sim, tol=1e-10):
    sim.clear_boundary_conditions()
    sim.apply_boundary_conditions(parse_bc(CLAMPED_BC, dim=3))
    u, res = sim.solve(tol=tol)
    sim.von_mises_field(u)
    return res


def _paths(spans):
    return [s[0] for s in spans]


def _check_tree(spans):
    """Every record closed, inside the record its parent index names, and
    carrying its root's index."""
    for i, (path, parent, root, t0, t1) in enumerate(spans):
        assert t1 is not None and t0 <= t1
        if parent is None:
            assert root == i and "/" not in path
            continue
        p_path, _, p_root, p0, p1 = spans[parent]
        assert parent < i and p0 <= t0 and t1 <= p1
        assert path.rsplit("/", 1)[0] == p_path
        assert root == p_root


def test_off_records_nothing(routed, no_sync):
    assert not tm.GLOBAL_TIMER.enabled
    tm.GLOBAL_TIMER.reset()
    res = _job(_clamped(3))
    assert res.rounds >= 1
    assert tm.GLOBAL_TIMER.take() == ([], {})
    assert tm.GLOBAL_TIMER.sections == {}
    # an instrumented site is a shared no-op context while off
    assert tm.GLOBAL_TIMER.section("a") is tm.GLOBAL_TIMER.section("b")


def test_routed_solve_spans_and_counters(routed, tracer, no_sync, reads):
    sim = _clamped(4)
    res = _job(sim)
    spans, counters = tracer.take()
    _check_tree(spans)
    roots = [s[0] for s in spans if s[1] is None]
    assert roots == ["bc", "solve", "von_mises"]
    paths = _paths(spans)
    assert paths.count("solve/refine") == 1
    assert paths.count("solve/build.routed") == 1
    assert paths.count("solve/precond") == 1
    assert res.rounds >= 1
    assert paths.count("solve/refine/inner") == res.rounds
    assert paths.count("solve/refine/residual") == res.rounds + 1
    assert set(counters) == {"cg.iters", "cg.readback_wait_ns"}
    assert counters["cg.iters"] == res.iters
    # one timed read of the continue flag an iteration, and the read that
    # stops each inner solve
    assert reads[0] == res.iters + res.rounds
    assert 0 < counters["cg.readback_wait_ns"]
    # the sections' sums follow the same records
    assert tracer.counts["solve/refine/inner"] == res.rounds
    # a second job finds the operator built
    res2 = _job(sim)
    spans, counters = tracer.take()
    assert "solve/build.routed" not in _paths(spans)
    assert counters["cg.iters"] == res2.iters


def test_structured_solve_spans(tracer, no_sync):
    """A Kuhn grid past 3,000 elements: the grid check and the multigrid
    build in the solve's spans, the build once; the two-tuple cache (mask
    key, multigrid)."""
    sim = _clamped(8)
    res = _job(sim, tol=1e-8)
    spans, counters = tracer.take()
    _check_tree(spans)
    paths = _paths(spans)
    assert paths.count("solve/validate") == 1
    assert paths.count("solve/build.mg") == 1
    assert counters["cg.iters"] == res.iters
    key, mg = sim._mg
    assert key == sim.dirichlet_mask.tobytes()
    assert type(mg).__name__ == "StructuredMG"
    _job(sim, tol=1e-8)
    spans, counters = tracer.take()
    assert "solve/build.mg" not in _paths(spans)


def test_cg_block_counts_a_readback_an_iteration(tracer, no_sync, reads):
    g = torch.Generator().manual_seed(7)
    n = 60
    Q = torch.randn(n, n, generator=g, dtype=torch.float64)
    A = Q @ Q.T + n * torch.eye(n, dtype=torch.float64)
    B = torch.randn(n, 4, generator=g, dtype=torch.float64)
    res = cg_mod.cg_block(lambda X: A @ X, B, tol=1e-10)
    _, counters = tracer.take()
    assert res.iters > 0 and counters["cg.iters"] == res.iters
    # one read before each iteration, the one that ends the loop, and the
    # chunk's closing check
    assert reads[0] == res.iters + 2
    assert 0 < counters["cg.readback_wait_ns"]
    assert bool((res.resnorm <= 1e-10 * torch.linalg.norm(B, dim=0)).all())


def _void_cell(n=4, radius=0.3):
    V, T = generators.grid_tet(n, n, n)
    centroid = V[T].mean(axis=1)
    keep = np.linalg.norm(centroid - 0.5, axis=1) > radius
    used, T = np.unique(T[keep], return_inverse=True)
    return FEMMesh(V[used], T.reshape(-1, 4), degree=2)


def test_homogenize_spans(routed, tracer, no_sync):
    res = hom.homogenize(_void_cell(), Material.isotropic(3, 1.0, 0.3),
                         tol=1e-10, device=CPU)
    spans, counters = tracer.take()
    _check_tree(spans)
    paths = _paths(spans)
    assert [p for p in paths if "/" not in p] == ["homogenize"]
    for name in ("periodic", "simulator", "build.routed", "precond",
                 "refine", "tensor"):
        assert paths.count(f"homogenize/{name}") == 1, name
    inner = paths.count("homogenize/refine/inner")
    assert inner >= 1
    assert paths.count("homogenize/refine/residual") == inner + 1
    assert counters["cg.iters"] == res.cg_iters[0]


def test_tracer_records_and_take(no_sync):
    t = tm.Timer()
    with t.section("x"):
        pass
    assert t.take() == ([], {})
    t.enabled = True
    with t.section("job"):
        with t.section("a"):
            t.add("n", 2)
        t.add("n")
        t.start_section("b")
        spans, counters = t.take()       # "job" and "b" still open
        t.stop_section()
    assert [s[0] for s in spans] == ["job", "job/a", "job/b"]
    assert spans[0][4] is None and spans[2][4] is None
    assert spans[1][1:3] == [0, 0] and spans[1][4] is not None
    assert counters == {"n": 3}
    assert t.take() == ([], {})          # closed after take: not recorded
    assert t.counts == {"job/a": 1, "job/b": 1, "job": 1}
    with t.section("next"):
        pass
    spans, _ = t.take()
    assert spans[0][:3] == ["next", None, 0]
    t.reset()
    assert (t.sections, t.counts, t.spans, t.counters) == ({}, {}, [], {})
