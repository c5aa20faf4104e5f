"""Helpers of the benchmark's CPU tests: a cell's run at a tiny mesh on
the CPU, through the harness as the card runs it.

The port's CPU entry points take the float64 EBE path where the card
takes the routed operator; ``routed_on_cpu`` sends them down the routed
path (kernels A and B in their plain versions), the path the card's
cells run.  Kernel launch counters stay 0 on the CPU, so the path guards
check there what they can see without them."""

from __future__ import annotations

import contextlib
import time

import torch

from fembench import harness, spec

TINY = {"unstructured36": 4, "voidcell36": 6, "kuhn64": 8}
CPU = torch.device("cpu")


@contextlib.contextmanager
def routed_on_cpu():
    from meshfem_tpu_torch.physics.elasticity import ElasticitySimulator

    original = ElasticitySimulator._routed_auto
    ElasticitySimulator._routed_auto = lambda self: True
    try:
        yield
    finally:
        ElasticitySimulator._routed_auto = original


def tiny(cell: spec.Cell, n: int | None = None) -> dict:
    traffic = cell.traffic()
    traffic["mesh"]["n"] = n or TINY[cell.traffic_name]
    return traffic


def cpu_run(name, seed=20261018, trace=False, seconds=0.3, root=spec.ROOT,
            n=None):
    """One run of cell ``name`` on the CPU at its tiny mesh; returns the
    result line's object."""
    torch.set_num_threads(2)
    cell = spec.load_cell(name, root)
    with routed_on_cpu():
        return harness.run(cell, seed, seconds, trace, CPU,
                           time.perf_counter(), traffic=tiny(cell, n))


def within(checks) -> bool:
    return all(isinstance(c["value"], float) and c["value"] <= c["limit"]
               for c in checks.values())
