"""meshfem_tpu_torch foundations == meshfem_tpu: quadrature rules, shape
gradients, integral tables, quadrature-point tables and the isotropic
elasticity tensor, all to 1e-14."""

import numpy as np
import pytest
import torch

from meshfem_tpu.fem import quadrature as rq
from meshfem_tpu.fem import shape_functions as rsf
from meshfem_tpu.fem import elasticity_tensor as ret
from meshfem_tpu.ops import element_matrices as rem
from meshfem_tpu.sparse import contract as rcontract

from meshfem_tpu_torch import config
from meshfem_tpu_torch.fem import quadrature as tq
from meshfem_tpu_torch.fem import shape_functions as tsf
from meshfem_tpu_torch.fem import elasticity_tensor as tet
from meshfem_tpu_torch.ops import element_matrices as tem
from meshfem_tpu_torch.sparse import contract as tcontract


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-14


@pytest.mark.parametrize("K,deg", [(K, d) for K in (1, 2, 3)
                                   for d in range(1, rq.MAX_DEGREE[K] + 1)])
def test_quadrature_rules(K, deg):
    P0, W0 = rq.rule_np(K, deg)
    P1, W1 = tq.rule_np(K, deg)
    np.testing.assert_allclose(P1, P0, rtol=0, atol=TOL)
    np.testing.assert_allclose(W1, W0, rtol=0, atol=TOL)


@pytest.mark.parametrize("K,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_shape_gradients(K, deg):
    lam = np.random.default_rng(K * 10 + deg).random((7, K + 1))
    lam /= lam.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(tsf.grad_shape_np(K, deg, lam),
                               rsf.grad_shape_np(K, deg, lam),
                               rtol=0, atol=TOL)
    assert tsf.node_multi_indices(K, deg) == rsf.node_multi_indices(K, deg)


@pytest.mark.parametrize("K,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_integral_tables(K, deg):
    np.testing.assert_allclose(tem.gradgrad_table(K, deg),
                               rem.gradgrad_table(K, deg), rtol=0, atol=TOL)
    np.testing.assert_allclose(tem.shape_grad_table(K, deg),
                               rem.shape_grad_table(K, deg), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("K,deg", [(3, 2), (2, 2), (3, 1), (2, 1)])
def test_qp_tables(K, deg):
    dN0, W0 = rcontract.qp_tables(K, deg)
    dN1, W1 = tcontract.qp_tables(K, deg)
    np.testing.assert_allclose(dN1, dN0, rtol=0, atol=TOL)
    np.testing.assert_allclose(W1, W0, rtol=0, atol=TOL)


@pytest.mark.parametrize("dim,E,nu", [(3, 200.0, 0.3), (2, 1.0, 0.3),
                                      (3, 2.3, 0.31)])
def test_isotropic_tensor_and_lame(dim, E, nu):
    D0 = np.asarray(ret.isotropic(dim, E, nu))
    D1 = tet.isotropic(dim, E, nu)
    np.testing.assert_allclose(D1.numpy(), D0, rtol=TOL, atol=0)
    assert tet.lame_parameters(D1) == pytest.approx(ret.lame_parameters(D0),
                                                    rel=TOL)
    np.testing.assert_allclose(tet.to_full(D1).numpy(),
                               np.asarray(ret.to_full(D0)), rtol=TOL, atol=0)
    strain = np.random.default_rng(dim).standard_normal((5, D0.shape[0]))
    np.testing.assert_allclose(
        tet.double_contract(D1, torch.as_tensor(strain)).numpy(),
        np.asarray(ret.double_contract(D0, strain)), rtol=TOL, atol=TOL * E)


def test_lame_parameters_rejects_anisotropic():
    D = tet.isotropic(3, 200.0, 0.3)
    D[0, 1] += 1.0
    assert tet.lame_parameters(D) is None


@pytest.mark.parametrize("K,deg", [(3, 2), (3, 1)])
def test_fused_matrix(K, deg):
    D = ret.isotropic(3, 200.0, 0.3)
    M0 = np.asarray(rem.fused_matrix_for(D, K, deg, np.float64))
    M1 = tem.fused_matrix_for(torch.as_tensor(np.array(D)), K, deg)
    np.testing.assert_allclose(M1, M0, rtol=0, atol=TOL * np.abs(M0).max())


def test_default_device_never_picks_cpu():
    if torch.cuda.is_available():
        assert config.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.default_device()
    assert config.resolve_device("cpu").type == "cpu"


def test_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
