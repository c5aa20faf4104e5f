"""The port's kernels A-C against the TPU kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as the reference's own tests run them
(``tests/test_route.py``, ``tests/test_routed_factored.py``):

* A ``gather_planes`` == ``route.plan_copy`` (``_copy_kernel[_p]``),
  exactly;
* B ``segment_sum_csr`` == ``route.plan_reduce`` (``_reduce_kernel[_p]``)
  to 1e-6 relative (the two sum in different orders);
* C ``qp_contract`` == ``contract.qp_contract`` (``_qp_kernel``) to 1e-5
  relative, including a padded superblock tail.

The ``cuda``-marked cases hold each CUDA kernel against its plain version
on the card and skip without one.  They need neither JAX nor the reference
package, so on a machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from meshfem_tpu_torch import kernels
from meshfem_tpu_torch.sparse.scatter import ScatterPlan


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference():
    """The reference's kernels, imported here so that the CUDA cases also
    run where JAX is not installed."""
    import jax.numpy as jnp
    from meshfem_tpu.sparse import route
    from meshfem_tpu.sparse.contract import qp_contract

    return jnp, route, qp_contract


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _local_ids(rng, n_src, n_out):
    """Locality-structured ids with far outliers and -1 padding."""
    base = np.repeat(rng.integers(0, n_src - 700, n_out // 100 + 1),
                     100)[:n_out]
    sid = np.minimum(base + rng.integers(0, 700, n_out), n_src - 1)
    sid[rng.integers(0, n_out, 40)] = rng.integers(0, n_src, 40)
    sid[rng.integers(0, n_out, 25)] = -1
    return sid


@pytest.mark.parametrize("planes", [1, 3])
def test_gather_planes_matches_routed_copy(planes):
    jnp, route, _ = _reference()
    rng = np.random.default_rng(planes)
    n_src, n_out = 30000, 7000
    sid = _local_ids(rng, n_src, n_out)
    src = rng.standard_normal((planes, n_src)).astype(np.float32)
    plan = route.plan_copy(sid, n_src, planes=planes)
    ref = np.asarray(plan(jnp.asarray(src if planes > 1 else src[0]),
                          interpret=True)).reshape(planes, n_out)
    out = kernels.gather_planes(torch.as_tensor(src),
                                torch.as_tensor(sid.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), ref)


def _dst_ids(rng, n_out, S):
    dst = rng.integers(0, n_out, S)
    hot = rng.integers(0, n_out, 60)
    dst[:3000] = hot[rng.integers(0, 60, 3000)]    # degrees up to ~60
    return dst[np.argsort(dst + rng.integers(0, 40, S))]


@pytest.mark.parametrize("planes", [1, 3])
def test_segment_sum_matches_routed_reduce(planes):
    jnp, route, _ = _reference()
    rng = np.random.default_rng(10 + planes)
    n_out, S = 5000, 40000
    dst = _dst_ids(rng, n_out, S)
    src = rng.standard_normal((planes, S)).astype(np.float32)
    plan = route.plan_reduce(dst, n_out, S, blk_rows=256, planes=planes)
    ref = np.asarray(plan(jnp.asarray(src if planes > 1 else src[0]),
                          interpret=True)).reshape(planes, n_out)
    sp = ScatterPlan.build(dst, n_out, "cpu")
    out = kernels.segment_sum_csr(torch.as_tensor(src), sp.perm, sp.offsets)
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() / scale < 1e-6


def test_segment_sum_float64_and_empty_segments():
    rng = np.random.default_rng(5)
    dst = rng.integers(0, 50, 300) * 2            # odd segments stay empty
    src = rng.standard_normal((2, 300))
    sp = ScatterPlan.build(dst, 101, "cpu")
    out = kernels.segment_sum_csr(torch.as_tensor(src), sp.perm, sp.offsets)
    ref = np.zeros((2, 101))
    for p in range(2):
        np.add.at(ref[p], dst, src[p])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13, atol=1e-13)
    assert out.dtype == torch.float64


def _qp_inputs(dim, n_el, E8, seed):
    rng = np.random.default_rng(seed)
    K1 = dim + 1
    g = rng.standard_normal((E8, K1, dim)).astype(np.float32)
    GB = np.broadcast_to(g[:, :, :, None], (E8, K1, dim, 1024)).copy()
    GB += 0.1 * rng.standard_normal(GB.shape).astype(np.float32)
    volB = rng.random((E8, 1024)).astype(np.float32) + 0.5
    volB[-1, 700:] = 0.0                 # padded tail of the last superblock
    ue = rng.standard_normal((dim, E8, n_el, 1024)).astype(np.float32)
    return GB, volB, ue


@pytest.mark.parametrize("dim,deg,n_el", [(3, 2, 10), (2, 2, 6), (3, 1, 4)])
def test_qp_contract_matches_tpu_kernel(dim, deg, n_el):
    jnp, _, r_qp_contract = _reference()
    E8 = 2
    GB, volB, ue = _qp_inputs(dim, n_el, E8, seed=dim * 10 + deg)
    K1 = dim + 1
    lam, mu = 1.7, 0.9
    ref = np.asarray(r_qp_contract(
        jnp.asarray(GB.reshape(E8, K1 * dim, 8, 128)),
        jnp.asarray(volB.reshape(E8, 8, 128)),
        jnp.asarray(ue.reshape(dim, E8, n_el, 8, 128)),
        lam, mu, dim, deg, interpret=True)).reshape(dim, E8, n_el, 1024)
    E = E8 * 1024
    g = torch.as_tensor(GB.transpose(1, 2, 0, 3).reshape(K1 * dim, E))
    vol = torch.as_tensor(volB.reshape(E))
    u = torch.as_tensor(ue.transpose(0, 2, 1, 3).reshape(dim, n_el, E))
    out = kernels.qp_contract(g, vol, u, lam, mu).numpy()
    out = out.reshape(dim, n_el, E8, 1024).transpose(0, 2, 1, 3)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


# --------------------------------------------------------------------------
# CUDA kernel == plain version (on the card only)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 3])
def test_cuda_gather_planes(cuda, planes):
    rng = np.random.default_rng(planes)
    sid = torch.as_tensor(_local_ids(rng, 30000, 7001).astype(np.int32),
                          device=cuda)
    src = torch.as_tensor(rng.standard_normal((planes, 30000)),
                          dtype=torch.float32, device=cuda)
    before = kernels.gather_planes.launches
    out = kernels.gather_planes(src, sid)
    torch.cuda.synchronize()
    assert kernels.gather_planes.launches == before + 1
    assert torch.equal(out, kernels.gather_planes_plain(src, sid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_segment_sum(cuda, dtype):
    rng = np.random.default_rng(7)
    dst = _dst_ids(rng, 5000, 40000)
    sp = ScatterPlan.build(dst, 5000, cuda)
    src = torch.as_tensor(rng.standard_normal((3, 40000)), dtype=dtype,
                          device=cuda)
    out = kernels.segment_sum_csr(src, sp.perm, sp.offsets)
    again = kernels.segment_sum_csr(src, sp.perm, sp.offsets)
    ref = kernels.segment_sum_csr_plain(src.cpu(), sp.perm.cpu(),
                                        sp.offsets.cpu())
    assert torch.equal(out, again)                 # bit-identical reruns
    assert torch.equal(out.cpu(), ref)             # same summation order


@pytest.mark.cuda
@pytest.mark.parametrize("dim,deg,n_el", [(3, 2, 10), (2, 2, 6), (3, 1, 4),
                                          (2, 1, 3)])
def test_cuda_qp_contract(cuda, dim, deg, n_el):
    rng = np.random.default_rng(dim + deg)
    E, K1 = 3001, dim + 1
    g = torch.as_tensor(rng.standard_normal((K1 * dim, E)),
                        dtype=torch.float32, device=cuda)
    vol = torch.as_tensor(rng.random(E) + 0.5, dtype=torch.float32,
                          device=cuda)
    u = torch.as_tensor(rng.standard_normal((dim, n_el, E)),
                        dtype=torch.float32, device=cuda)
    out = kernels.qp_contract(g, vol, u, 1.7, 0.9)
    ref = kernels.qp_contract_plain(g, vol, u, 1.7, 0.9)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5


def test_scatter_plan_rejects_out_of_range_ids():
    """Index streams are validated on the host, before any kernel reads
    them."""
    with pytest.raises(ValueError):
        ScatterPlan.build(np.array([0, 5, 2]), 5, "cpu")
    with pytest.raises(ValueError):
        ScatterPlan.build(np.array([0, -1, 2]), 5, "cpu")
