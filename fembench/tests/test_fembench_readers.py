"""The per-layer readers, the roofline's arithmetic and the device
trace's reduction, on records made by hand; and, on a card, one traced
job read end to end."""

from __future__ import annotations

import pytest
import torch

from fembench import spec
from fembench.device_trace import _gap_labels, _merge, profile_call, \
    short_name
from fembench.roofline import PEAKS, apply_bound_s

H100 = "NVIDIA H100 80GB HBM3"


class Ev:
    """Stands in for a pair of CUDA events: ``elapsed_time`` in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(kind, **more):
    jobs = [dict(index=1, iters=100, wall_s=1.0),
            dict(index=2, iters=300, wall_s=2.0)]
    rec = dict(setup={"mesh_s": 0.5}, jobs=jobs, spans={}, events={},
               info=dict(job_kind=kind, kind=H100),
               profile=dict(busy_s=0.25, window_s=1.0))
    rec.update(more)
    return rec


def read(name, rec):
    return spec.reader(name).read(rec)


def test_solve_readers():
    rec = _record("solve", events={"vcycle": [(Ev(0), Ev(2)),
                                              (Ev(5), Ev(9))]})
    assert read("mesh_s", rec) == 0.5
    assert read("inner_iters.solve", rec) == 200.0
    assert read("iter_ms.solve", rec) == pytest.approx(7.5)
    assert read("vcycle_ms.solve", rec) == 3.0
    assert read("idle_pct.solve", rec) == 75.0
    # the other kind's readers find nothing
    assert read("block_iters.homog", rec) is None
    assert read("idle_pct.homog", rec) is None
    assert read("apply_roofline.solve", rec) is None


def test_homog_readers():
    rec = _record("homog", spans={"cg_block": [(1, 0.4, 80), (1, 0.2, 20),
                                               (2, 1.5, 300)]})
    assert read("block_iters.homog", rec) == 200.0
    assert read("block_iter_ms.homog", rec) == pytest.approx(
        1e3 * 2.1 / 400)
    assert read("build_s.homog", rec) == pytest.approx((0.4 + 0.5) / 2)
    assert read("inner_iters.solve", rec) is None


def test_apply_roofline_reader():
    E, N, n, d = 279936, 389017, 10, 3
    bound = apply_bound_s(1, E, N, n, d, PEAKS[H100])
    ms = 4 * bound * 1e3                       # each apply at 4x its bound
    applies = [(1, E, N, n, d, Ev(0), Ev(ms)) for _ in range(3)]
    rec = _record("solve", events={"apply": applies})
    assert read("apply_roofline.solve", rec) == pytest.approx(25.0)
    assert read("apply_roofline.homog", rec) is None
    rec["info"]["kind"] = "another card"
    assert read("apply_roofline.solve", rec) is None


def test_apply_bound_counts_inputs_once():
    """The bench mesh's one-column apply is bound by its bytes: 11.2 MB of
    connectivity, 14.6 MB of gradients and volumes, 9.3 MB of node
    values in and out; six columns by the quadrature form's operations."""
    peaks = PEAKS[H100]
    E, N = 279936, 389017
    nbytes = E * 10 * 4 + E * 13 * 4 + 2 * N * 3 * 4
    assert apply_bound_s(1, E, N, 10, 3, peaks) == pytest.approx(
        nbytes / peaks["hbm_bytes_per_s"])
    quad6 = 4 * (2 * 10 * 4 * 3 + 6 * (2 * 9 * 10 + 4 + 36 + 6 + 180))
    assert quad6 < 2 * 30 * 30 * 6
    assert apply_bound_s(6, E, N, 10, 3, peaks) == pytest.approx(
        E * quad6 / peaks["f32_flop_per_s"])


def test_quadrature_points_are_the_ports():
    from meshfem_tpu_torch.sparse.contract import qp_tables

    from fembench.roofline import QUAD_POINTS_P2

    assert qp_tables(3, 2)[0].shape[0] == QUAD_POINTS_P2


def test_trace_reduction():
    assert _merge([(5, 9), (0, 3), (2, 4), (9, 10)]) == [[0, 4], [5, 10]]
    dev = [(0, 10, "void ns::a<int>(int)"), (20, 30, "Memcpy DtoH (x)")]
    assert _gap_labels(dev, [(10, 20), (30, 40)]) == [
        "after ns::a / before Memcpy DtoH", "after Memcpy DtoH / before "
        "window end"]
    assert short_name("std::enable_if<true, void>::type "
                      "internal::gemvx::kernel<int, float>(int)") == \
        "gemvx::kernel"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_profile_reads_device_time(card):
    x = torch.randn(1 << 22, device=card)

    def work():
        y = x
        for _ in range(20):
            y = y * 1.0001 + 1
        return y

    _, info = profile_call(work, torch.cuda.synchronize, card)
    assert 0 < info["busy_s"] <= info["window_s"]
    assert info["device_ops"]
