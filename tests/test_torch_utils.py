"""``utils/{checkpoint,timer,sim_utils}.py`` of ``meshfem_tpu_torch``
against ``meshfem_tpu`` on the CPU.

The binary triplet dump of a stiffness matrix is byte for byte the
reference's, and each package reads the other's file back equal.  The
solver state round-trips tensors bit for bit (dtype kept) and reads in
the reference's loader; ``save_tree`` writes the reference's npz form
(``leaf{i}`` and the ``treedef`` record, byte-equal to what the reference
writes when orbax is not there) and ``load_tree`` reads it back.  The
``Timer``'s section names and counts equal the reference's for the same
nesting, off by default; ``torch_profile_trace`` writes a Chrome trace.
``dofs_in_bbox``, ``BoxRegion`` and ``rigid_registration`` (1e-12) equal
the reference's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.mesh import generators as rgen
from meshfem_tpu.utils import checkpoint as rck
from meshfem_tpu.utils import sim_utils as rsu
from meshfem_tpu.utils import timer as rtm

from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.utils import checkpoint as pck
from meshfem_tpu_torch.utils import sim_utils as psu
from meshfem_tpu_torch.utils import timer as ptm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_matrix_dump_is_the_reference_format(tmp_path):
    V, T = rgen.grid_tet(2, 2, 2)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3),
                              device="cpu")
    A = sim.to_scipy()
    pck.dump_matrix(tmp_path / "p.bin", A)
    rck.dump_matrix(tmp_path / "r.bin", A)
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "r.bin").read_bytes()
    for reader, path in ((pck.read_matrix, "r.bin"),
                         (rck.read_matrix, "p.bin")):
        B = reader(tmp_path / path)
        assert B.shape == A.shape and (B.tocsr() != A).nnz == 0


def test_solver_state_round_trip(tmp_path):
    g = torch.Generator().manual_seed(3)
    state = {"x": torch.randn((7, 3), generator=g, dtype=torch.float64),
             "r": torch.randn(5, generator=g),
             "it": torch.tensor([12, 5], dtype=torch.int32),
             "mask": np.array([True, False])}
    path = tmp_path / "state.npz"
    pck.save_solver_state(path, state)
    back = pck.load_solver_state(path, device="cpu")
    assert set(back) == set(state)
    for k, v in state.items():
        v = torch.as_tensor(v)
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    ref = rck.load_solver_state(path)
    for k, v in state.items():
        np.testing.assert_array_equal(ref[k], np.asarray(v))


def test_save_tree_is_the_reference_npz(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(4)
    tree = {"b": [torch.randn(3, generator=g), (torch.arange(4),)],
            "a": torch.randn((2, 2), generator=g, dtype=torch.float64),
            "c": None, "d": (torch.ones(1), torch.zeros(2))}
    pck.save_tree(tmp_path / "p", tree)
    # the reference takes orbax where it can be imported; its npz form is
    # what it writes without it
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    rtree = {"b": [np.asarray(tree["b"][0]), (np.asarray(tree["b"][1][0]),)],
             "a": np.asarray(tree["a"]), "c": None,
             "d": (np.ones(1, np.float32), np.zeros(2, np.float32))}
    rck.save_tree(tmp_path / "r", rtree)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "r.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        assert bytes(p["treedef"]) == bytes(r["treedef"])
        for k in p.files:
            assert p[k].dtype == r[k].dtype
            np.testing.assert_array_equal(p[k], r[k])
    back = pck.load_tree(tmp_path / "p", device="cpu")
    assert back["c"] is None and isinstance(back["d"], tuple)
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)
    for got, want in ((back["a"], tree["a"]), (back["b"][0], tree["b"][0]),
                      (back["b"][1][0], tree["b"][1][0]),
                      (back["d"][1], tree["d"][1])):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _nest(timer):
    """The same nesting in either package's Timer."""
    for _ in range(2):
        with timer.section("assemble"):
            with timer.section("geometry"):
                pass
            timer.start_section("ke")
            timer.stop_section("ke")
    with timer.section("solve"):
        with timer.section("cg"):
            with timer.section("apply"):
                pass


def test_timer_sections_match_reference(tmp_path):
    p, r = ptm.Timer(), rtm.Timer()
    _nest(p)
    assert p.sections == {} and p.counts == {}     # off by default
    p.enabled = r.enabled = True
    _nest(p)
    _nest(r)
    assert sorted(p.sections) == sorted(r.sections)
    assert p.counts == r.counts
    assert p.counts["assemble/geometry"] == 2
    assert p.sections["solve"] >= p.sections["solve/cg/apply"] >= 0.0
    lines = p.report().splitlines()
    assert len(lines) == 1 + len(p.sections)
    assert [ln.split()[0] for ln in lines[1:]] == sorted(p.sections)
    p.reset()
    assert p.sections == {} and p.counts == {}

    @ptm.benchmarkit(name="decorated")
    def f(x):
        return 2 * x

    assert not ptm.GLOBAL_TIMER.enabled
    try:
        ptm.enable_benchmarking(True)
        assert f(3) == 6 and f(1) == 2
        assert ptm.GLOBAL_TIMER.counts["decorated"] == 2
    finally:
        ptm.enable_benchmarking(False)
        ptm.GLOBAL_TIMER.reset()
    with ptm.torch_profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(100).cumsum(0)
    assert prof.key_averages()
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_sim_utils_match_reference():
    V, T = rgen.grid_tet(3, 2, 2)
    p, r = FEMMesh(V, T, degree=2), RFEMMesh(V, T, degree=2)
    for comps in (None, [1], [0, 2]):
        np.testing.assert_array_equal(
            psu.dofs_in_bbox(p, (0, 0, 0), (0.5, 1, 1), comps),
            rsu.dofs_in_bbox(r, (0, 0, 0), (0.5, 1, 1), comps))
    pts = np.random.default_rng(5).uniform(-0.2, 1.2, (50, 3))
    np.testing.assert_array_equal(
        psu.BoxRegion((0, 0, 0), (1, 0.5, 1)).contains(pts),
        rsu.BoxRegion((0, 0, 0), (1, 0.5, 1)).contains(pts))
    rng = np.random.default_rng(6)
    P = rng.standard_normal((20, 3))
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    for scaling in (False, True):
        Qp = 1.7 * P @ Q.T + np.array([0.3, -1.0, 2.0])
        sp_, Rp, tp = psu.rigid_registration(P, Qp, scaling)
        sr, Rr, tr = rsu.rigid_registration(P, Qp, scaling)
        assert abs(sp_ - sr) <= 1e-12 * abs(sr)
        np.testing.assert_allclose(Rp, Rr, atol=1e-12)
        np.testing.assert_allclose(tp, tr, atol=1e-12)
        if scaling:
            np.testing.assert_allclose(sp_ * P @ Rp.T + tp, Qp, atol=1e-10)


def test_set_max_num_threads(monkeypatch):
    threads = torch.get_num_threads()
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    try:
        psu.set_max_num_threads(2)
        assert torch.get_num_threads() == 2
        assert all(os.environ[v] == "2" for v in (
            "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"))
    finally:
        torch.set_num_threads(threads)
