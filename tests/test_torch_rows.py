"""Kernels A and B in node rows, kernel F, and the dense routed applies
built on them, against the reference.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as the reference's own tests run them
(``tests/test_route.py``).  Tolerances:

* A ``gather_rows`` == ``route.plan_copy`` (``_copy_kernel_p`` /
  ``_copy_kernel``), exactly, from node rows and from planes;
* B ``segment_sum_rows`` == ``route.plan_reduce`` (``_reduce_kernel_p`` /
  ``_reduce_kernel``) to 1e-6 of max|y| (the two sum in different orders);
* B rows == B planes bit for bit on the same contributions in the same
  order, in float32 and float64, including RoutedEBE's element-major plan
  against its slot-major one;
* the dense ``apply_planes`` and ``apply_block`` == the reference's
  ``RoutedEBE`` to 5e-6 of max|y| (the reference's tolerance for its own
  routed operator); the f64 ``EBEKernel`` block apply == the reference's
  to 1e-12;
* F ``route_window`` == ``experiments/probe_route.py::route_kernel``
  through ``pl.pallas_call(..., interpret=True)`` with the grid spec of
  ``probe_route.build``, exactly.

The ``cuda``-marked cases hold each CUDA kernel against its plain version
(and B rows against B planes, bitwise; A rows also on float64 rows, which
it moves as float32 pairs) on the card and skip without one.
They need neither JAX nor the reference package: ``python -m pytest
--noconftest -m cuda tests/test_torch_rows.py``.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from meshfem_tpu_torch import kernels
from meshfem_tpu_torch.sparse.scatter import ScatterPlan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _local_ids(rng, n_src, n_out):
    """Locality-structured ids with far outliers and -1 padding."""
    base = np.repeat(rng.integers(0, n_src - 700, n_out // 100 + 1),
                     100)[:n_out]
    sid = np.minimum(base + rng.integers(0, 700, n_out), n_src - 1)
    sid[rng.integers(0, n_out, 40)] = rng.integers(0, n_src, 40)
    sid[rng.integers(0, n_out, 25)] = -1
    return sid


def _dst_ids(rng, n_out, S):
    dst = rng.integers(0, n_out, S)
    hot = rng.integers(0, n_out, 60)
    dst[:S // 10] = hot[rng.integers(0, 60, S // 10)]   # long runs
    return dst[np.argsort(dst + rng.integers(0, 40, S))]


# --------------------------------------------------------------------------
# A and B in rows against the TPU kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("planes", [1, 3, 18])
def test_gather_rows_matches_routed_copy(planes):
    import jax.numpy as jnp
    from meshfem_tpu.sparse import route

    rng = np.random.default_rng(20 + planes)
    n_src, n_out = 1500, 500
    sid = _local_ids(rng, n_src, n_out)
    src = rng.standard_normal((planes, n_src)).astype(np.float32)
    plan = route.plan_copy(sid, n_src, planes=planes)
    ref = np.asarray(plan(jnp.asarray(src if planes > 1 else src[0]),
                          interpret=True)).reshape(planes, n_out)
    ids = torch.as_tensor(sid.astype(np.int32))
    rows = kernels.gather_rows(torch.as_tensor(src.T.copy()), ids)
    np.testing.assert_array_equal(rows.numpy(), ref.T)
    from_planes = kernels.gather_rows(torch.as_tensor(src), ids,
                                      planes_in=True)
    np.testing.assert_array_equal(from_planes.numpy(), ref.T)


@pytest.mark.parametrize("planes", [1, 3, 18])
def test_segment_sum_rows_matches_routed_reduce(planes):
    import jax.numpy as jnp
    from meshfem_tpu.sparse import route

    rng = np.random.default_rng(30 + planes)
    n_out, S = 500, 3000
    dst = _dst_ids(rng, n_out, S)
    src = rng.standard_normal((planes, S)).astype(np.float32)
    plan = route.plan_reduce(dst, n_out, S, blk_rows=256, planes=planes)
    ref = np.asarray(plan(jnp.asarray(src if planes > 1 else src[0]),
                          interpret=True)).reshape(planes, n_out)
    sp = ScatterPlan.build(dst, n_out, "cpu")
    rows = torch.as_tensor(src.T.copy())
    out = kernels.segment_sum_rows(rows, sp.perm, sp.offsets)
    assert _rel(out.numpy(), ref.T) < 1e-6
    out_p = kernels.segment_sum_rows(rows, sp.perm, sp.offsets,
                                     planes_out=True)
    np.testing.assert_array_equal(out_p.numpy(), out.numpy().T)


# --------------------------------------------------------------------------
# B rows == B planes, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planes", [3, 18])
def test_segment_sum_rows_equals_planes_bitwise(dtype, planes):
    rng = np.random.default_rng(planes)
    dst = rng.integers(0, 700, 9000)
    dst[::7] = 3                                       # one long run
    sp = ScatterPlan.build(dst, 701, "cpu")            # 701: one empty
    src = torch.as_tensor(rng.standard_normal((planes, 9000)), dtype=dtype)
    y_planes = kernels.segment_sum_csr(src, sp.perm, sp.offsets)
    rows = src.t().contiguous()
    assert torch.equal(kernels.segment_sum_rows(rows, sp.perm, sp.offsets,
                                                planes_out=True), y_planes)
    assert torch.equal(sp.sum_rows(rows).t(), y_planes)
    assert torch.equal(sp(rows).t(), y_planes)
    assert float(y_planes[:, 700].abs().max()) == 0.0


@pytest.fixture(scope="module")
def p2_cell():
    """grid_tet(2,2,2) P2: Ke, element nodes, positions (float64)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    V, T = generators.grid_tet(2, 2, 2)
    mesh = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 2.3, 0.31),
                              device="cpu")
    return sim, V, T


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_routed_element_major_plan_equals_slot_major(p2_cell, dtype):
    """RoutedEBE's two plans sum every node's contributions in one order:
    planes over slots ``a*E + e`` and rows over ``e*n + a`` agree bitwise
    at 3 and 18 values a node."""
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    sim, _, _ = p2_cell
    mesh = sim.mesh
    rk = RoutedEBE.build(sim.Ke, mesh.elem_nodes, mesh.num_nodes, 3,
                         coords=mesh.node_positions, device="cpu")
    E, n = rk.num_elements, rk.nodes_per_elem
    np.testing.assert_array_equal(
        rk.ids_em.numpy().reshape(E, n), rk.ids.numpy().reshape(n, E).T)
    rng = np.random.default_rng(3)
    for P in (3, 18):
        fe = torch.as_tensor(rng.standard_normal((P, n * E)), dtype=dtype)
        rows = fe.reshape(P, n, E).permute(2, 1, 0).reshape(E * n, P)
        y_planes = rk.plan.sum_planes(fe)
        assert torch.equal(rk.plan_em.sum_rows(rows.contiguous(),
                                               planes_out=True), y_planes)


# --------------------------------------------------------------------------
# the dense applies in node rows against the reference's RoutedEBE
# --------------------------------------------------------------------------

def test_dense_applies_match_reference(p2_cell):
    import jax.numpy as jnp
    from meshfem_tpu.sparse.routed_ebe import RoutedEBE as RRoutedEBE
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    sim, _, _ = p2_cell
    mesh = sim.mesh
    Ke = sim.Ke.numpy()
    args = (mesh.elem_nodes, mesh.num_nodes, 3)
    rk_ref = RRoutedEBE.build(Ke, *args, coords=mesh.node_positions,
                              block_rhs=6)
    rk = RoutedEBE.build(torch.as_tensor(Ke), *args,
                         coords=mesh.node_positions, device="cpu",
                         block_rhs=6)
    np.testing.assert_array_equal(rk.order.numpy(), np.asarray(rk_ref.order))
    rng = np.random.default_rng(8)
    N = mesh.num_nodes
    src = rng.standard_normal((3, N)).astype(np.float32)
    yp = rk.apply_planes(torch.as_tensor(src))
    assert _rel(yp.numpy(), rk_ref.apply_planes(jnp.asarray(src))) < 5e-6
    # rows in, rows out: the same values through the same three steps
    assert torch.equal(rk(torch.as_tensor(src.T.copy())), yp.t())
    U = rng.standard_normal((N, 3, 6)).astype(np.float32)
    yb = rk.apply_block(torch.as_tensor(U))
    assert _rel(yb.numpy(), rk_ref.apply_block(jnp.asarray(U))) < 5e-6
    y0 = rk.apply_block(torch.as_tensor(U[..., :1].copy()))
    assert _rel(yb[..., :1].numpy(), y0.numpy()) < 1e-6
    assert _rel(rk.diagonal_planes().numpy(),
                np.asarray(rk_ref.diagonal_planes())) < 5e-6


@pytest.mark.parametrize("factored", [False, True])
def test_block_apply_takes_its_backends_layout(p2_cell, monkeypatch,
                                               factored):
    """The dense block apply runs kernel A and B in rows, once each, and
    never in planes; the factored one keeps planes."""
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.sparse import routed_ebe as re_mod
    from meshfem_tpu_torch.sparse import scatter as sc_mod
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    calls = []

    def recording(mod, name):
        inner = getattr(mod, name)

        def wrapper(*args, **kw):
            calls.append(name)
            return inner(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("gather_rows", "gather_planes"):
        recording(re_mod, name)
    for name in ("segment_sum_rows", "segment_sum_csr"):
        recording(sc_mod, name)
    sim, _, _ = p2_cell
    mesh = sim.mesh
    factor = None
    if factored:
        lam, mu = et.lame_parameters(sim.D)
        factor = (sim.geom.grad_lambda, sim.geom.volume, lam, mu, 2)
    rk = RoutedEBE.build(None if factored else sim.Ke, mesh.elem_nodes,
                         mesh.num_nodes, 3, factor=factor, device="cpu")
    rk.apply_block(torch.randn(mesh.num_nodes, 3, 6))
    assert calls == (["gather_planes", "segment_sum_csr"] if factored
                     else ["gather_rows", "segment_sum_rows"])


def test_ebe_block_apply_f64_matches_reference(p2_cell):
    import jax.numpy as jnp
    from meshfem_tpu.sparse.ebe import EBEKernel as REBEKernel
    from meshfem_tpu_torch.sparse.ebe import EBEKernel

    sim, _, _ = p2_cell
    mesh = sim.mesh
    Ke = sim.Ke.numpy()
    k_ref = REBEKernel.build(Ke, mesh.elem_nodes, mesh.num_nodes, 3)
    k = EBEKernel.build(torch.as_tensor(Ke), mesh.elem_nodes,
                        mesh.num_nodes, 3)
    U = np.random.default_rng(9).standard_normal((mesh.num_nodes, 3, 6))
    y = k(torch.as_tensor(U))
    assert y.dtype == torch.float64 and tuple(y.shape) == U.shape
    assert _rel(y.numpy(), k_ref(jnp.asarray(U))) < 1e-12
    assert _rel(k(torch.as_tensor(U[..., 2].copy())).numpy(),
                k_ref(jnp.asarray(U[..., 2]))) < 1e-12


# --------------------------------------------------------------------------
# F against the probe's Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

def _route_inputs(NV, NT, CHAIN, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((NT, 128)).astype(np.float32)
    win0 = rng.integers(0, NT - CHAIN, NV).astype(np.int32)
    widx = rng.integers(0, CHAIN, (NV, 8, 128)).astype(np.int32)
    widx.reshape(-1)[rng.integers(0, widx.size, 50)] = 255   # PAD_WIDX
    lidx = rng.integers(0, 128, (NV, 8, 128)).astype(np.int32)
    return x, win0, widx, lidx


def test_route_window_matches_probe_kernel():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    try:
        from probe_route import route_kernel
    finally:
        sys.path.remove(os.path.join(ROOT, "experiments"))
    NV, NT, CHAIN, B = 8, 20, 4, 4
    f = pl.pallas_call(              # the grid spec of probe_route.build
        functools.partial(route_kernel, B=B, CHAIN=CHAIN),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(NV // B,),
            in_specs=[
                pl.BlockSpec((NT, 128), lambda i, *_: (0, 0)),
                pl.BlockSpec((B, 8, 128), lambda i, *_: (i, 0, 0)),
                pl.BlockSpec((B, 8, 128), lambda i, *_: (i, 0, 0)),
            ],
            out_specs=pl.BlockSpec((B, 8, 128), lambda i, *_: (i, 0, 0)),
        ),
        out_shape=jax.ShapeDtypeStruct((NV, 8, 128), jnp.float32),
        interpret=True)
    x, win0, widx, lidx = _route_inputs(NV, NT, CHAIN)
    ref = np.asarray(f(win0, x, widx, lidx))
    out = kernels.route_window(*(torch.as_tensor(a)
                                 for a in (x, win0, widx, lidx)), CHAIN)
    np.testing.assert_array_equal(out.numpy(), ref)
    ok = widx < CHAIN
    np.testing.assert_array_equal(
        out.numpy()[ok], x[(win0[:, None, None] + widx)[ok], lidx[ok]])


# --------------------------------------------------------------------------
# CUDA kernels == plain versions (on the card only)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 3, 18])
@pytest.mark.parametrize("planes_in", [False, True])
@pytest.mark.parametrize("n_slots", [7001, 7002])   # 18 x 7002: 16-B stores
def test_cuda_gather_rows(cuda, planes, planes_in, n_slots):
    rng = np.random.default_rng(planes)
    sid = torch.as_tensor(_local_ids(rng, 30000, n_slots).astype(np.int32),
                          device=cuda)
    shape = (planes, 30000) if planes_in else (30000, planes)
    src = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device=cuda)
    before = kernels.gather_rows.launches
    out = kernels.gather_rows(src, sid, planes_in=planes_in)
    torch.cuda.synchronize()
    assert kernels.gather_rows.launches == before + 1
    assert torch.equal(out, kernels.gather_rows_plain(src, sid, planes_in))


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 3, 18])
def test_cuda_gather_rows_f64(cuda, planes):
    """Float64 node rows move as float32 pairs: the same bits as the plain
    gather, counted in ``launches`` and ``launches_f64``."""
    rng = np.random.default_rng(planes)
    sid = torch.as_tensor(_local_ids(rng, 30000, 7001).astype(np.int32),
                          device=cuda)
    src = torch.as_tensor(rng.standard_normal((30000, planes)),
                          dtype=torch.float64, device=cuda)
    before = kernels.gather_rows.launches
    before_f64 = kernels.gather_rows.launches_f64
    out = kernels.gather_rows(src, sid)
    torch.cuda.synchronize()
    assert kernels.gather_rows.launches == before + 1
    assert kernels.gather_rows.launches_f64 == before_f64 + 1
    assert out.dtype == torch.float64
    assert torch.equal(out, kernels.gather_rows_plain(src, sid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("planes", [1, 3, 18])
def test_cuda_segment_sum_rows(cuda, dtype, planes):
    rng = np.random.default_rng(planes)
    dst = _dst_ids(rng, 5000, 40000)
    sp = ScatterPlan.build(dst, 5001, cuda)
    src = torch.as_tensor(rng.standard_normal((planes, 40000)), dtype=dtype,
                          device=cuda)
    rows = src.t().contiguous()
    before = kernels.segment_sum_rows.launches
    before_f64 = kernels.segment_sum_rows.launches_f64
    out = kernels.segment_sum_rows(rows, sp.perm, sp.offsets)
    out_p = kernels.segment_sum_rows(rows, sp.perm, sp.offsets,
                                     planes_out=True)
    torch.cuda.synchronize()
    assert kernels.segment_sum_rows.launches == before + 2
    assert kernels.segment_sum_rows.launches_f64 == before_f64 + (
        2 if dtype == torch.float64 else 0)
    assert torch.equal(out_p, kernels.segment_sum_csr(src, sp.perm,
                                                      sp.offsets))
    assert torch.equal(out.t(), out_p)
    ref = kernels.segment_sum_rows_plain(rows.cpu(), sp.perm.cpu(),
                                         sp.offsets.cpu())
    assert torch.equal(out.cpu(), ref)             # same summation order


@pytest.mark.cuda
def test_cuda_route_window(cuda):
    x, win0, widx, lidx = _route_inputs(1001, 300, 4, seed=2)
    args = [torch.as_tensor(a, device=cuda) for a in (x, win0, widx, lidx)]
    before = kernels.route_window.launches
    out = kernels.route_window(*args, 4)
    torch.cuda.synchronize()
    assert kernels.route_window.launches == before + 1
    assert torch.equal(out, kernels.route_window_plain(*args, 4))
