"""The result line's shape, the refusals of ``run.py``, and
``BENCHMARK.json`` against the benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from fembench import spec
from fembench.tests.cpu import cpu_run

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    res = cpu_run("homog.voidcell36", trace=trace)
    line = json.loads(json.dumps(res))
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and line["attempted"] >= 1
    assert isinstance(line["failed"], int)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _run(args, cwd):
    return subprocess.run([sys.executable, "fembench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_refuses_without_cuda_or_without_the_port(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal is for one without")
    args = ["--workload", "clamped.unstructured36", "--seed", "3",
            "--seconds", "1", "--trace", "0"]
    p = _run(args, spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(args, tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fembench"]
    assert BENCH["command"] == ["python3", "fembench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a check of 24 cells (2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s
    # of compiling a cell, 1,200 s spare) fits in 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("fembench/")
        assert (spec.ROOT / c["file"]).exists()
        assert (spec.HERE / "configs" / f"{c['name']}.py").exists()
        assert json.loads((spec.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) == 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in
                                  spec.load_cell(w).end_to_end}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (spec.ROOT / "PERF.md").read_text()
    assert all(layer in perf for layer in layers)
