"""The port's kernels D and E against the TPU kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as the reference's own tests run them
(``tests/test_routed_factored.py:82-118``, ``tests/test_kernels.py``):

* D ``factored_contract`` == ``contract.factored_contract``
  (``_factored_kernel``) to 1e-5 of max|y| (float32 sums in another order),
  on a grid whose block count is not a multiple of B, and == kernel C's
  plain version (the same product by quadrature) to 5e-6; the CUDA
  kernel's reassociated algorithm (``S d1`` and ``W u``), written as
  float32 einsums, is held to the Pallas kernel the same way;
* E ``element_stiffness`` (fed ``D``) == ``element_stiffness_pallas``
  (``_asm_kernel``, fed ``fused_matrix_for(D)``) and ==
  ``element_elasticity_fused_apply`` to 1e-5 of max|Ke|, for the four
  (dim, degree) and an isotropic and an anisotropic material; the CUDA
  kernel's material-first contraction, written as float64 einsums rounded
  once to float32 as the kernel sums, is held to the Pallas kernel the same
  way and to the float64 ``Ke`` within one float32 ulp of each entry.

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
from meshfem_tpu_torch.fem.flattening import full_to_flat_map
from meshfem_tpu_torch.sparse.contract import factored_tables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [(3, 2, 10), (2, 2, 6), (3, 1, 4), (2, 1, 3)]
MATERIALS = ["isotropic", "anisotropic"]


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


def _factored_reassociated(g, vol, ue, lam, mu, deg):
    """The CUDA kernel D's algorithm in float32 einsums: ``lam m1 + mu m2 =
    S d1`` with ``S[(k,i),(l,j)] = lam T[k,l,i,j] + mu T[l,k,i,j]``, and the
    f phase through ``W = mu sum_km G2[km] T[k,m]``."""
    d, n, E = ue.shape
    K1 = d + 1
    T = torch.as_tensor(factored_tables(d, deg))
    S = (lam * T + mu * T.transpose(0, 1)).permute(0, 2, 1, 3) \
        .reshape(K1 * n, K1 * n)
    gl = g.reshape(K1, d, E)
    d1 = torch.einsum("kce,cje->kje", gl, ue).reshape(K1 * n, E)
    A = (S @ d1).reshape(K1, n, E)
    G2 = torch.einsum("kce,mce->kme", gl, gl)
    W = mu * torch.einsum("kme,kmij->eij", G2, T)
    return vol * (torch.einsum("eij,cje->cie", W, ue)
                  + torch.einsum("kce,kie->cie", gl, A))


@pytest.mark.parametrize("form", ["wrapper", "reassociated"])
@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_factored_contract_matches_pallas_kernel(dim, deg, n_el, form):
    import jax.numpy as jnp
    from meshfem_tpu.sparse.contract import factored_contract as ref_fc

    Eb, lam, mu = 3, 1.7, 0.9                # Eb not a multiple of B = 2
    g, vol, ue, g_t, vol_t, ue_t = _contract_inputs(dim, n_el, Eb)
    ref = np.asarray(ref_fc(jnp.asarray(g.reshape(Eb, (dim + 1) * dim, 128)),
                            jnp.asarray(vol), jnp.asarray(ue), lam, mu, dim,
                            deg, interpret=True, B=2))     # [d, Eb, n, 128]
    ref = ref.transpose(0, 2, 1, 3).reshape(dim, n_el, Eb * 128)
    if form == "wrapper":
        out = kernels.factored_contract(g_t, vol_t, ue_t, lam, mu)
    else:
        out = _factored_reassociated(g_t, vol_t, ue_t, lam, mu, deg)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() < 1e-5


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


def _stiffness_inputs(E=300, seed=0, K=3, d=3):
    rng = np.random.default_rng(seed)
    gl = rng.standard_normal((E, K + 1, d)).astype(np.float32)
    vol = (np.abs(rng.standard_normal(E)) + 0.1).astype(np.float32)
    return gl, vol


def _material(dim, kind):
    """A constant material [fl, fl]: isotropic, or a seeded symmetric
    positive definite matrix with every entry non-zero."""
    if kind == "isotropic":
        return et.isotropic(dim, 200.0, 0.3)
    fl = dim * (dim + 1) // 2
    A = np.random.default_rng(11 + dim).standard_normal((fl, fl))
    return torch.as_tensor(50.0 * (A @ A.T + fl * np.eye(fl)))


def _material_first(gl, vol, D, deg):
    """The CUDA kernel E's algorithm, material first and table second, in
    float64 einsums rounded once to float32, as the kernel sums:
    ``H[k,l,c,f] = sum_ab g_ka g_lb C[c,a,f,b]`` (9 terms), then ``Ke =
    vol sum_kl T[k,l,i,j] H[k,l,c,f]`` (16 terms)."""
    E, K1, d = gl.shape
    f2f = full_to_flat_map(d)
    C = torch.as_tensor(np.asarray(D, np.float64)[f2f[:, :, None, None],
                                                  f2f[None, None, :, :]])
    T = torch.as_tensor(em.gradgrad_table(K1 - 1, deg), dtype=torch.float64)
    gl, vol = gl.double(), vol.double()
    H = torch.einsum("eka,elb,cafb->eklcf", gl, gl, C)
    Ke = vol[:, None, None, None, None] * torch.einsum("klij,eklcf->eicjf",
                                                       T, H)
    n = T.shape[-1]
    return Ke.reshape(E, n * d, n * d).float()


def _ulps_from(Ke32, K64):
    """max over entries of ``|Ke32 - K64| / (2^-23 |K64| + 2^-40
    max|K64|)``: at most 1 when float32 ``Ke32`` is the float64 ``K64``
    rounded once, to within an ulp of each entry.  The floor covers the
    float64 rounding of entries that cancel to near zero; a float32 sum
    errs by ~2^-24 of its terms, some 10^5 times more."""
    Ke32 = torch.as_tensor(Ke32).double()
    K64 = torch.as_tensor(K64).to(Ke32.device).double()
    bound = 2.0 ** -23 * K64.abs() + 2.0 ** -40 * K64.abs().max()
    return float(((Ke32 - K64).abs() / bound).max())


@pytest.mark.parametrize("form", ["wrapper", "material_first"])
@pytest.mark.parametrize("kind", MATERIALS)
@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_element_stiffness_matches_pallas_and_xla(dim, deg, n_el, kind,
                                                  form):
    """The port's E fed ``D`` (on the CPU its plain version, the TPU
    kernel's one product with ``fused_matrix_for(D)``), or the CUDA
    kernel's material-first contraction summed in float64, against the
    Pallas kernel and the XLA fused path fed the reference's
    ``fused_matrix_for(D)``, and against the float64 ``Ke``: 1e-5 of
    max|Ke|; the material-first form also within one ulp of each entry of
    the float64 ``Ke``."""
    import jax.numpy as jnp
    from meshfem_tpu.kernels import element_stiffness_pallas
    from meshfem_tpu.ops import element_matrices as rem

    D = _material(dim, kind)
    gl, vol = _stiffness_inputs(K=dim, d=dim)
    Mr = rem.fused_matrix_for(np.asarray(D), dim, deg, jnp.float32)
    Kp = np.asarray(element_stiffness_pallas(jnp.asarray(gl),
                                             jnp.asarray(vol), Mr,
                                             interpret=True))
    Kx = np.asarray(rem.element_elasticity_fused_apply(
        jnp.asarray(gl), jnp.asarray(vol), Mr, n_el))
    M = em.fused_matrix_for(D, dim, deg)
    np.testing.assert_allclose(M, np.asarray(Mr, np.float64),
                               atol=1e-6 * np.abs(M).max())
    K64 = em.element_elasticity_fused(torch.as_tensor(gl).double(),
                                      torch.as_tensor(vol).double(), D,
                                      deg).numpy()
    gl_t, vol_t = torch.as_tensor(gl), torch.as_tensor(vol)
    if form == "wrapper":
        Ke = kernels.element_stiffness(gl_t, vol_t, D, deg).numpy()
        Kf = em.element_elasticity_fused_apply(
            gl_t, vol_t, torch.as_tensor(M, dtype=torch.float32),
            n_el).numpy()
        assert np.abs(Kf - Kx).max() < 1e-5 * np.abs(Kx).max()
    else:
        Ke = _material_first(gl_t, vol_t, D, deg).numpy()
        assert _ulps_from(Ke, K64) <= 1.0
    tol = 1e-5 * np.abs(K64).max()
    assert Ke.shape == (300, n_el * dim, n_el * dim)
    assert Ke.dtype == np.float32
    assert np.abs(Ke - Kp).max() < tol
    assert np.abs(Ke - Kx).max() < tol
    assert np.abs(Ke - K64).max() < tol


def test_element_stiffness_feeds_simulator_Ke():
    """The float32 assembly agrees with the simulator's float64 Ke (1e-5 of
    max|Ke|) on a real mesh."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    mat = Material.isotropic(3, 200.0, 0.3)
    sim = ElasticitySimulator(FEMMesh(*generators.grid_tet(2, 2, 2),
                                      degree=2), mat, device="cpu")
    Ke32 = kernels.element_stiffness(sim.geom.grad_lambda.float(),
                                     sim.geom.volume.float(), mat.D, 2)
    assert float((Ke32 - sim.Ke.float()).abs().max()
                 / sim.Ke.abs().max()) < 1e-5


def test_element_stiffness_rejects_nonsymmetric_material():
    """The kernel mirrors ``H`` across ``k <= l``, which needs a symmetric
    ``D``: an asymmetric one raises (in the plain version as well), and
    one that is symmetric to float32 rounding is taken."""
    gl, vol = (torch.as_tensor(a) for a in _stiffness_inputs(E=4))
    D = _material(3, "anisotropic").clone()
    D[0, 5] += 1e-3 * float(D.abs().max())
    with pytest.raises(ValueError, match="symmetric"):
        kernels.element_stiffness(gl, vol, D, 2)
    D = _material(3, "anisotropic").clone()
    D[0, 5] *= 1 + 2.0 ** -24
    assert kernels.element_stiffness(gl, vol, D, 2).shape == (4, 30, 30)


def test_wrappers_registered_with_launch_counts():
    names = [w.__name__ for w in kernels.WRAPPERS]
    assert names == ["gather_planes", "gather_rows", "segment_sum_csr",
                     "segment_sum_rows", "qp_contract", "factored_contract",
                     "element_stiffness", "route_window"]
    kernels.factored_contract.launches = 3
    kernels.segment_sum_rows.launches_f64 = 2
    kernels.reset_launch_counts()
    assert all(w.launches == 0 for w in kernels.WRAPPERS)
    assert kernels.segment_sum_csr.launches_f64 == 0
    assert kernels.segment_sum_rows.launches_f64 == 0


RAGGED = [1, 333, 1000, 4099]     # 1000 and 4099: no multiple of a tile


@pytest.mark.cuda
@pytest.mark.parametrize("E", RAGGED)
@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_cuda_factored_contract_matches_plain(cuda, dim, deg, n_el, E):
    """Against its plain version (1e-5 of max|y|) and kernel C (5e-6)."""
    _, _, _, g_t, vol_t, ue_t = _contract_inputs(dim, n_el, 33, seed=7)
    g_t, vol_t, ue_t = (t[..., :E].contiguous().to(cuda)
                        for t in (g_t, vol_t, ue_t))
    n0 = kernels.factored_contract.launches
    out = kernels.factored_contract(g_t, vol_t, ue_t, 1.7, 0.9)
    torch.cuda.synchronize()
    assert kernels.factored_contract.launches == n0 + 1
    ref = kernels.factored_contract_plain(g_t, vol_t, ue_t, 1.7, 0.9)
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5
    c = kernels.qp_contract(g_t, vol_t, ue_t, 1.7, 0.9)
    assert float((out - c).abs().max() / c.abs().max()) < 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MATERIALS)
@pytest.mark.parametrize("E", RAGGED)
@pytest.mark.parametrize("dim,deg,n_el", CASES)
def test_cuda_element_stiffness_matches_plain(cuda, dim, deg, n_el, E, kind):
    """Against its plain version (1e-5 of max|Ke|) and the float64 ``Ke``
    (within one ulp of each entry: the kernel sums in float64)."""
    D = _material(dim, kind)
    gl, vol = _stiffness_inputs(E, seed=3, K=dim, d=dim)
    gl, vol = torch.as_tensor(gl, device=cuda), torch.as_tensor(vol,
                                                                device=cuda)
    n0 = kernels.element_stiffness.launches
    Ke = kernels.element_stiffness(gl, vol, D, deg)
    torch.cuda.synchronize()
    assert kernels.element_stiffness.launches == n0 + 1
    assert Ke.shape == (E, n_el * dim, n_el * dim)
    ref = kernels.element_stiffness_plain(gl, vol, D, deg)
    K64 = em.element_elasticity_fused(gl.double(), vol.double(), D, deg)
    scale = float(K64.abs().max())
    assert float((Ke - ref).abs().max()) < 1e-5 * scale
    assert float((Ke - K64).abs().max()) < 1e-5 * scale
    assert _ulps_from(Ke, K64) <= 1.0
    with pytest.raises(ValueError):
        kernels.element_stiffness(gl.double(), vol.double(), D, deg)
