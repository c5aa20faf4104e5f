"""The readers of the program's own spans and counters
(``fembench/spans.py``), the attribution of idle device time to host
spans, the probe that takes the records, and the traced CPU run of each
cell with the host-span metrics in its line."""

from __future__ import annotations

import contextlib
import json
import types

import pytest
import torch

from fembench import spans as sp
from fembench import spec
from fembench.tests.cpu import cpu_run

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
HOST_SPAN_METRICS = ("entry_s", "residual_ms", "inner_iter_ms",
                     "readback_wait_pct")
MS = 1_000_000                 # nanoseconds


def _solve_job(base, index):
    """One static solve job's span records from ``base`` ns, its roots'
    indices offset by ``index``: bc 10 ms, solve 100 ms holding refine 80
    ms (residuals 5 and 5 ms, inner 60 ms), von Mises 10 ms."""
    i = index
    return [["bc", None, i, base, base + 10 * MS],
            ["solve", None, i + 1, base + 10 * MS, base + 110 * MS],
            ["solve/refine", i + 1, i + 1, base + 20 * MS, base + 100 * MS],
            ["solve/refine/residual", i + 2, i + 1, base + 20 * MS,
             base + 25 * MS],
            ["solve/refine/inner", i + 2, i + 1, base + 25 * MS,
             base + 85 * MS],
            ["solve/refine/residual", i + 2, i + 1, base + 85 * MS,
             base + 90 * MS],
            ["von_mises", None, i + 6, base + 110 * MS, base + 120 * MS]]


def _record(kind="solve", program=True):
    starts = [1_000 * MS, 2_000 * MS]
    jobs = [dict(index=k + 1, iters=100, start_s=s * 1e-9, wall_s=0.125)
            for k, s in enumerate(starts)]
    spans = _solve_job(starts[0], 0) + _solve_job(starts[1], 7)
    rec = dict(setup={}, jobs=jobs, spans={}, events={},
               info=dict(job_kind=kind, kind="cpu"))
    if program:
        rec["program"] = dict(spans=spans, counters={
            "cg.iters": 240, "cg.readback_wait_ns": 30 * MS})
    return rec


def test_readers_of_the_programs_spans():
    rec = _record()
    # roots 120 ms a job, less refine's 80 ms
    assert sp.entry_s(rec, "solve") == pytest.approx(0.040)
    assert sp.residual_ms(rec, "solve") == pytest.approx(5.0)
    # 2 x 60 ms of inner solves over 240 iterations
    assert sp.inner_iter_ms(rec, "solve") == pytest.approx(0.5)
    assert sp.readback_wait_pct(rec, "solve") == pytest.approx(25.0)
    for name in HOST_SPAN_METRICS:
        assert spec.reader(f"{name}.solve").read(rec) is not None
        # the other kind's readers, and a window without the program's
        # records (a program without the tracer), find nothing
        assert spec.reader(f"{name}.homog").read(rec) is None
        assert spec.reader(f"{name}.solve").read(
            _record(program=False)) is None


def test_roots_go_to_the_job_whose_clock_holds_them():
    rec = _record()
    rec["jobs"] = rec["jobs"][1:]                 # the first job not kept
    rec["program"]["spans"][1][4] += 100 * MS     # a longer solve: 140 ms
    assert sp.entry_s(rec, "solve") == pytest.approx(0.040)
    rec["jobs"][0]["wall_s"] = 0.110              # ends inside von Mises
    assert sp.entry_s(rec, "solve") == pytest.approx(0.030)


def test_idle_goes_to_the_innermost_open_span():
    spans = [["bc", None, 0, 1000, 1100],
             ["solve", None, 1, 1100, 2100],
             ["solve/refine", 1, 1, 1200, 2000],
             ["solve/refine/residual", 2, 1, 1200, 1250],
             ["solve/refine/inner", 2, 1, 1250, 1850],
             ["solve/refine/residual", 2, 1, 1850, 1900],
             ["von_mises", None, 6, 2100, 2200]]
    # host ns above; the device clock runs 500 ns ahead of the host's
    gaps = [(1450, 1700),      # 950-1200: no span 50, bc 100, solve 100
            (1720, 1760),      # 1220-1260: residual 30, inner 10
            (2390, 2410),      # 1890-1910: residual 10, refine 10
            (2650, 2800)]      # 2150-2300: von_mises 50, no span 100
    got = dict(sp.idle_by_span(gaps, spans, [[0, 500]]))
    assert got == pytest.approx({
        "no span": 150e-9, "bc": 100e-9, "solve": 100e-9,
        "solve/refine/residual": 40e-9, "solve/refine/inner": 10e-9,
        "solve/refine": 10e-9, "von_mises": 50e-9})
    assert sum(got.values()) == pytest.approx(
        sum(e - s for s, e in gaps) * 1e-9)
    assert sp.entry_share(sp.idle_by_span(gaps, spans, [[0, 500]])) == \
        pytest.approx(250e-9)
    # the order is by idle time, largest first
    order = [v for _, v in sp.idle_by_span(gaps, spans, [[0, 500]])]
    assert order == sorted(order, reverse=True)
    # no spans at all: everything is "no span"
    assert sp.idle_by_span(gaps, [], [[0, 0]]) == [["no span", pytest.approx(
        460e-9)]]


def test_the_soonest_anchor_maps_the_host_clock():
    # fills started 500 and 600 ns after their host times: the second
    # was held up 100 ns more, so the first gives the offset
    anchors = [[0, 500], [1000, 1600]]
    clock = sp.to_device(anchors)
    assert (clock(0), clock(1000)) == (500, 1500)
    assert sp.to_device(anchors[::-1])(0) == 500
    spans = [["solve", None, 0, 100, 900]]     # device 600 - 1400
    got = dict(sp.idle_by_span([(400, 700), (1300, 1700)], spans, anchors))
    assert got == pytest.approx({"solve": 200e-9, "no span": 500e-9})


def test_probe_leaves_a_program_without_the_records_alone(monkeypatch):
    from meshfem_tpu_torch.utils import timer as tm

    probe = spec.load_module(spec.HERE / "probes" / "program_spans.py")
    old = types.SimpleNamespace(enabled=False)
    monkeypatch.setattr(tm, "GLOBAL_TIMER", old)
    rec = {}
    probe.install(rec)()
    assert rec == {} and old.enabled is False


def test_probe_takes_the_windows_records():
    from meshfem_tpu_torch.utils.timer import GLOBAL_TIMER

    probe = spec.load_module(spec.HERE / "probes" / "program_spans.py")
    assert not GLOBAL_TIMER.enabled
    with GLOBAL_TIMER.section("before"):
        pass
    rec = {}
    undo = probe.install(rec)
    try:
        with GLOBAL_TIMER.section("job"):
            GLOBAL_TIMER.add("n", 3)
    finally:
        undo()
    assert not GLOBAL_TIMER.enabled
    assert [s[0] for s in rec["program"]["spans"]] == ["job"]
    assert rec["program"]["counters"] == {"n": 3}
    GLOBAL_TIMER.reset()


@contextlib.contextmanager
def structured_f32_on_cpu():
    """The structured multigrid built in float32 on the CPU, as on the
    card, so the solve refines in float64 around it."""
    from meshfem_tpu_torch.ops.structured_mg import StructuredMG

    build = StructuredMG.build.__func__

    def f32(cls, *args, **kw):
        return build(cls, *args, **dict(kw, dtype=torch.float32))

    StructuredMG.build = classmethod(f32)
    try:
        yield
    finally:
        StructuredMG.build = classmethod(build)


@pytest.mark.parametrize("name", CELLS)
def test_traced_cpu_run_reports_the_host_span_metrics(name):
    cell = spec.load_cell(name)
    with structured_f32_on_cpu():
        res = cpu_run(name, trace=True)
    assert res["correct"] and res["failed"] == 0
    suffix = "." + name.split(".")[0].replace("clamped", "solve")
    wanted = {m + suffix for m in HOST_SPAN_METRICS}
    assert wanted <= {m["name"] for m in cell.per_layer}
    assert wanted <= set(res["metrics"])
    values = {m: res["metrics"][m]["value"] for m in wanted}
    assert all(v > 0 for v in values.values()), values
    assert values["readback_wait_pct" + suffix] < 100
    # the device's numbers are left out on the CPU
    assert not {"idle_pct" + suffix, "apply_roofline" + suffix,
                "vcycle_ms.solve"} & set(res["metrics"])

