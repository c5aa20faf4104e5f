"""The harness finds cells, traffic and metric readers by the names
``BENCHMARK.json`` gives: a new traffic file and its entry add a cell,
and a new reader file and its entry add a per-layer metric, with no
edit to any file the benchmark has."""

from __future__ import annotations

import json
import shutil

import pytest

from fembench import spec
from fembench.tests.cpu import cpu_run


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, as a later change would find
    them; returns (root, the original files' contents)."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "fembench").rglob("*") if p.is_file()}
    return tmp_path, before


def _unchanged(root, before):
    return all((root / rel).read_bytes() == data
               for rel, data in before.items())


def test_a_traffic_file_adds_a_cell(checkout):
    root, before = checkout
    (root / "fembench" / "traffic" / "holes3.json").write_text(json.dumps({
        "mesh": {"generator": "grid_tet", "n": 3, "void_radius": 0.2},
        "jobs": {"E": {"log_uniform": [10.0, 20.0]},
                 "nu": {"cycle": [0.25, 0.3]}},
        "path": "routed_block"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "homog.holes3", "config": "periodic_homog_p2",
        "traffic": "holes3", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "homog.voidcell36" in m.get("workloads", []):
            m["workloads"].append("homog.holes3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = cpu_run("homog.holes3", root=root, n=3)
    assert res["correct"] and set(res["metrics"]) == {
        "setup_s", "homog_s", "peak_mem_gib"}
    assert _unchanged(root, before)


def test_a_reader_file_adds_a_metric(checkout):
    root, before = checkout
    (root / "fembench" / "metrics" / "jobs_done.solve.py").write_text(
        "def read(record):\n"
        "    return float(len(record['jobs']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "jobs_done.solve", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "solvers", "moves": "solve_s",
        "workloads": ["clamped.unstructured36"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = cpu_run("clamped.unstructured36", root=root, trace=True)
    assert res["metrics"]["jobs_done.solve"]["value"] >= 1.0
    assert _unchanged(root, before)
