"""What ``BENCHMARK.json`` says about one cell, and the files the harness
finds by name: the configuration's JSON and module
(``configs/<config>.json``, ``configs/<config>.py``), the traffic
(``traffic/<traffic>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "fembench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict               # the configuration file's contents
    traffic_name: str
    end_to_end: list           # BENCHMARK.json entries reported at --trace 0
    per_layer: list            # ... at --trace 1
    root: Path = ROOT          # where ``file`` paths and ``fembench/`` lie

    def module(self):
        """The configuration's module (``configs/<config>.py``)."""
        return load_module(self.root / "fembench" / "configs"
                           / f"{self.config_name}.py")

    def traffic(self) -> dict:
        """The traffic file's contents (``traffic/<traffic>.json``)."""
        return json.loads((self.root / "fembench" / "traffic"
                           / f"{self.traffic_name}.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; its files are
    looked up under ``root`` by the names that file gives."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                e2e, per_layer, root)


def reader(metric: str, root: Path = ROOT):
    """The per-layer metric's reader module (``metrics/<metric>.py``)."""
    return load_module(Path(root) / "fembench" / "metrics" / f"{metric}.py")
