"""The port's kernels D and E against the TPU kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as the reference's own tests run them
(``tests/test_routed_factored.py:82-118``, ``tests/test_kernels.py``):

* D ``factored_contract`` == ``contract.factored_contract``
  (``_factored_kernel``) to 1e-5 of max|y| (float32 sums in another order),
  on a grid whose block count is not a multiple of B, and == kernel C's
  plain version (the same product by quadrature) to 5e-6;
* E ``element_stiffness`` == ``element_stiffness_pallas`` (``_asm_kernel``)
  and == ``element_elasticity_fused_apply`` to 1e-5 of max|Ke|.

The ``cuda``-marked cases hold each CUDA kernel against its plain version
on the card and skip without one.  They need neither JAX nor the reference
package: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels2.py``.
"""

import numpy as np
import pytest
import torch

from meshfem_tpu_torch import kernels
from meshfem_tpu_torch.ops import element_matrices as em
from meshfem_tpu_torch.fem import elasticity_tensor as et
from meshfem_tpu_torch.sparse.contract import factored_tables

CASES = [(3, 2, 10), (2, 2, 6), (3, 1, 4), (2, 1, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _contract_inputs(dim, n_el, Eb, seed=1):
    """Lane-major inputs of the reference kernel ([Eb, ., 128] blocks) and
    the same data in the port's element-fastest layout."""
    rng = np.random.default_rng(seed)
    K1 = dim + 1
    g = rng.standard_normal((Eb, K1, dim, 128)).astype(np.float32)
    vol = (rng.random((Eb, 128)) + 0.5).astype(np.float32)
    ue = rng.standard_normal((dim, Eb, n_el, 128)).astype(np.float32)
    E = Eb * 128
    g_t = torch.as_tensor(g.transpose(1, 2, 0, 3).reshape(K1 * dim, E).copy())
    vol_t = torch.as_tensor(vol.reshape(E).copy())
    ue_t = torch.as_tensor(ue.transpose(0, 2, 1, 3).reshape(dim, n_el, E)
                           .copy())
    return g, vol, ue, g_t, vol_t, ue_t


@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_factored_contract_matches_pallas_kernel(dim, deg, n_el):
    import jax.numpy as jnp
    from meshfem_tpu.sparse.contract import factored_contract as ref_fc

    Eb, lam, mu = 3, 1.7, 0.9                # Eb not a multiple of B = 2
    g, vol, ue, g_t, vol_t, ue_t = _contract_inputs(dim, n_el, Eb)
    ref = np.asarray(ref_fc(jnp.asarray(g.reshape(Eb, (dim + 1) * dim, 128)),
                            jnp.asarray(vol), jnp.asarray(ue), lam, mu, dim,
                            deg, interpret=True, B=2))     # [d, Eb, n, 128]
    ref = ref.transpose(0, 2, 1, 3).reshape(dim, n_el, Eb * 128)
    out = kernels.factored_contract(g_t, vol_t, ue_t, lam, mu).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_factored_contract_matches_qp_contract(dim, deg, n_el):
    """Table form == quadrature form (kernel C's plain version), 5e-6."""
    _, _, _, g_t, vol_t, ue_t = _contract_inputs(dim, n_el, 2, seed=5)
    d = kernels.factored_contract_plain(g_t, vol_t, ue_t, 1.7, 0.9)
    c = kernels.qp_contract_plain(g_t, vol_t, ue_t, 1.7, 0.9)
    assert float((d - c).abs().max() / c.abs().max()) < 5e-6


@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_factored_tables_match_reference(dim, deg, n_el):
    """The unpadded table equals every block of the reference's padded
    TM1 / TM2 / TQ, entry for entry."""
    from meshfem_tpu.sparse.contract import factored_tables as ref_tables

    T = factored_tables(dim, deg)
    TM1, TM2, TQ = ref_tables(dim, deg)
    K1, npd = dim + 1, -(-n_el // 8) * 8
    assert T.shape == (K1, K1, n_el, n_el) and T.dtype == np.float32
    for k in range(K1):
        for l in range(K1):
            r, c = k * npd, l * npd
            np.testing.assert_array_equal(TM1[r:r + n_el, c:c + n_el],
                                          T[k, l])
            np.testing.assert_array_equal(TM2[c:c + n_el, r:r + n_el],
                                          T[k, l])
            q = (k * K1 + l) * npd
            np.testing.assert_array_equal(TQ[q:q + n_el, :n_el], T[k, l])


def _stiffness_inputs(E=300, seed=0):
    rng = np.random.default_rng(seed)
    gl = rng.standard_normal((E, 4, 3)).astype(np.float32)
    vol = (np.abs(rng.standard_normal(E)) + 0.1).astype(np.float32)
    return gl, vol


def test_element_stiffness_matches_pallas_and_xla():
    import jax.numpy as jnp
    from meshfem_tpu.fem import elasticity_tensor as ret
    from meshfem_tpu.kernels import element_stiffness_pallas
    from meshfem_tpu.ops import element_matrices as rem

    gl, vol = _stiffness_inputs()
    Mr = rem.fused_matrix_for(ret.isotropic(3, 200.0, 0.3), 3, 2,
                              jnp.float32)
    Kp = np.asarray(element_stiffness_pallas(jnp.asarray(gl),
                                             jnp.asarray(vol), Mr,
                                             interpret=True))
    Kx = np.asarray(rem.element_elasticity_fused_apply(
        jnp.asarray(gl), jnp.asarray(vol), Mr, 10))
    M = em.fused_matrix_for(et.isotropic(3, 200.0, 0.3), 3, 2)
    np.testing.assert_allclose(M, np.asarray(Mr, np.float64),
                               atol=1e-6 * np.abs(M).max())
    M32 = torch.as_tensor(M, dtype=torch.float32)
    Ke = kernels.element_stiffness(torch.as_tensor(gl), torch.as_tensor(vol),
                                   M32).numpy()
    Kf = em.element_elasticity_fused_apply(
        torch.as_tensor(gl), torch.as_tensor(vol), M32, 10).numpy()
    tol = 1e-5 * np.abs(Kx).max()
    assert Ke.shape == (300, 30, 30) and Ke.dtype == np.float32
    assert np.abs(Ke - Kp).max() < tol
    assert np.abs(Ke - Kx).max() < tol
    assert np.abs(Kf - Kx).max() < tol


def test_element_stiffness_feeds_simulator_Ke():
    """The float32 assembly agrees with the simulator's float64 Ke (1e-5 of
    max|Ke|) on a real mesh."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    mat = Material.isotropic(3, 200.0, 0.3)
    sim = ElasticitySimulator(FEMMesh(*generators.grid_tet(2, 2, 2),
                                      degree=2), mat, device="cpu")
    M32 = torch.as_tensor(em.fused_matrix_for(mat.D, 3, 2),
                          dtype=torch.float32)
    Ke32 = kernels.element_stiffness(sim.geom.grad_lambda.float(),
                                     sim.geom.volume.float(), M32)
    assert float((Ke32 - sim.Ke.float()).abs().max()
                 / sim.Ke.abs().max()) < 1e-5


def test_wrappers_registered_with_launch_counts():
    names = [w.__name__ for w in kernels.WRAPPERS]
    assert names == ["gather_planes", "gather_rows", "segment_sum_csr",
                     "segment_sum_rows", "qp_contract", "factored_contract",
                     "element_stiffness", "route_window"]
    kernels.factored_contract.launches = 3
    kernels.reset_launch_counts()
    assert all(w.launches == 0 for w in kernels.WRAPPERS)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_cuda_factored_contract_matches_plain(cuda, dim, deg, n_el):
    _, _, _, g_t, vol_t, ue_t = _contract_inputs(dim, n_el, 5, seed=7)
    g_t, vol_t, ue_t = (t[..., :601].contiguous().to(cuda)
                        for t in (g_t, vol_t, ue_t))      # ragged last block
    n0 = kernels.factored_contract.launches
    out = kernels.factored_contract(g_t, vol_t, ue_t, 1.7, 0.9)
    torch.cuda.synchronize()
    assert kernels.factored_contract.launches == n0 + 1
    ref = kernels.factored_contract_plain(g_t, vol_t, ue_t, 1.7, 0.9)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5
    c = kernels.qp_contract(g_t, vol_t, ue_t, 1.7, 0.9)
    assert float((out - c).abs().max() / c.abs().max()) < 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("K,deg,E", [(3, 2, 1000), (3, 1, 333), (3, 2, 1)])
def test_cuda_element_stiffness_matches_plain(cuda, K, deg, E):
    gl, vol = _stiffness_inputs(E, seed=3)
    M32 = torch.as_tensor(em.fused_matrix_for(et.isotropic(3, 200.0, 0.3),
                                              K, deg),
                          dtype=torch.float32, device=cuda)
    gl, vol = torch.as_tensor(gl, device=cuda), torch.as_tensor(vol,
                                                                device=cuda)
    n0 = kernels.element_stiffness.launches
    Ke = kernels.element_stiffness(gl, vol, M32)
    torch.cuda.synchronize()
    assert kernels.element_stiffness.launches == n0 + 1
    ref = kernels.element_stiffness_plain(gl, vol, M32)
    assert float((Ke - ref).abs().max() / ref.abs().max()) < 1e-5
    with pytest.raises(ValueError):
        kernels.element_stiffness(gl.double(), vol.double(), M32.double())
