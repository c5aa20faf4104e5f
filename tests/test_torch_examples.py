"""The port's examples (``meshfem_tpu_torch/examples``) against the
reference's scripts (``examples/*.py``) on the CPU, on the same small
arguments and the same mesh files.

Each reference script runs as ``tests/test_examples.py`` runs it
(``runpy``, ``sys.argv``); each port example through its ``main`` with
``--device cpu``; both in ``tmp_path``, where ``vibrational_modes``
writes its viewer.  The printed numbers are parsed and compared at the
precision printed: counts exactly, the cantilever's tip deflection and
von Mises range and the tensors' entries to their last printed digit,
the float32 topology optimization's compliances to 1e-5 relative; the
residual-like values (relres, the cubic spread) are held to their gates
in both.  The ball and the two-phase cell are the port's own default
meshes, written small (``write_ball``, ``write_cell``).
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from meshfem_tpu_torch.examples import (cantilever, homogenize_microstructure,
                                        homogenize_voxels,
                                        topology_optimization,
                                        vibrational_modes)

EX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(capsys, module, script, argv):
    """(port lines, reference lines) printed on the same arguments."""
    module.main(list(argv) + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    old = sys.argv
    sys.argv = [script] + list(argv)
    try:
        runpy.run_path(os.path.join(EX, script), run_name="__main__")
    finally:
        sys.argv = old
    ref = capsys.readouterr().out.splitlines()
    assert len(port) == len(ref), (port, ref)
    return port, ref


def _numbers(line):
    return [float(x) for x in NUMBER.findall(line)]


def _same_digits(p, r, atol):
    """Lines of printed numbers equal to their last printed digit."""
    a, b = _numbers(p), _numbers(r)
    assert len(a) == len(b), (p, r)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_cantilever(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, ref = _both(capsys, cantilever, "cantilever.py", ["8", "3", "3"])
    (dofs, iters, relres), (rdofs, riters, rrelres) = \
        _numbers(port[0]), _numbers(ref[0])
    assert (dofs, iters) == (rdofs, riters)
    assert relres <= 1e-10 and rrelres <= 1e-10
    assert port[1:] == ref[1:]          # tip deflection, von Mises range


def test_homogenize_voxels(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, ref = _both(capsys, homogenize_voxels, "homogenize_voxels.py",
                      ["4"])
    assert port[:3] == ref[:3]          # fraction, iterations, heading
    for p, r in zip(port[3:-1], ref[3:-1]):
        _same_digits(p, r, 1e-5)
    assert _numbers(port[-1])[-1] <= 1e-8 and _numbers(ref[-1])[-1] <= 1e-8


def test_topology_optimization(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--nx", "8", "--ny", "4", "--nz", "4", "--iters", "3"]
    port, ref = _both(capsys, topology_optimization,
                      "topology_optimization.py",
                      argv + ["--out", str(tmp_path / "rho.npy")])
    for p, r in zip(port, ref):
        if p.startswith("it "):         # it, c, vol, inner
            a, b = _numbers(p), _numbers(r)
            assert a[0] == b[0] and a[3] == b[3]
            np.testing.assert_allclose(a[1:3], b[1:3], rtol=1e-5)
        elif p.startswith(("compliance", "density")):
            np.testing.assert_allclose(_numbers(p), _numbers(r), rtol=1e-4)
    c0, cN = _numbers(next(p for p in port if p.startswith("compliance")))[:2]
    assert cN < c0


def test_vibrational_modes(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vibrational_modes.write_ball("ball6.msh", 6)
    port, ref = _both(capsys, vibrational_modes, "vibrational_modes.py",
                      ["ball6.msh", "3"])
    lam, rlam = _numbers(port[0]), _numbers(ref[0])
    assert len(lam) == 3 and min(lam) > 0
    np.testing.assert_allclose(lam, rlam, rtol=0, atol=1e-6)
    assert port[1] == ref[1]
    assert (tmp_path / "ball_modes.html").stat().st_size > 0


def test_homogenize_microstructure(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    homogenize_microstructure.write_cell("cell16.msh", 16)
    port, ref = _both(capsys, homogenize_microstructure,
                      "homogenize_microstructure.py", ["cell16.msh"])
    assert port[:2] == ref[:2]          # iterations, heading
    for p, r in zip(port[2:-1], ref[2:-1]):
        _same_digits(p, r, 1e-5)
    lo, hi = _numbers(port[-1])
    assert lo > 0 and port[-1] == ref[-1]


def test_default_meshes(tmp_path):
    """The meshes the two examples write when given none: a ball inside
    the unit cube without dangling vertices, and the two-phase square."""
    from meshfem_tpu_torch.io import meshio

    vibrational_modes.write_ball(tmp_path / "b.msh", 4)
    V, T = meshio.load(str(tmp_path / "b.msh"))
    assert np.array_equal(np.unique(T), np.arange(len(V)))
    assert np.all(np.linalg.norm(V[T].mean(axis=1) - 0.5, axis=1) < 0.5)
    homogenize_microstructure.write_cell(tmp_path / "c.msh", 4)
    V, F = meshio.load(str(tmp_path / "c.msh"))
    assert len(F) == 32 and np.allclose(V[:, :2].min(0), -1.0) \
        and np.allclose(V[:, :2].max(0), 1.0)
