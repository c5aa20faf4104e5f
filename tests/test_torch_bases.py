"""Lagrange bases of degree 0 to 4, interpolants at degree 3, quadrature,
the flattening helpers, the symmetric-pair assembly, ``config``'s dtype
accessors and ``simplex.num_vertices`` of ``meshfem_tpu_torch`` against
``meshfem_tpu`` on the CPU.

Shape-function values and barycentric gradients at seeded points, exact
integrals and node positions agree for K in {1, 2, 3} and degree 0..4 to
1e-12 (the node multi-indices exactly); the torch ``eval_shape`` matches
the reference's jnp one to 1e-12.  Interpolants sampled at degree 3 agree
in their values, evaluation, integrals, promotion to 4 and mixed-degree
sums and differences (1e-12).  ``restrict_to_boundary`` raises at degree
3, where the reference returns the face's corners alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu import config as rconfig
from meshfem_tpu.fem import elasticity_tensor as ret
from meshfem_tpu.fem import flattening as rfl
from meshfem_tpu.fem import interpolant as rint
from meshfem_tpu.fem import quadrature as rq
from meshfem_tpu.fem import shape_functions as rsf
from meshfem_tpu.fem import simplex as rsx
from meshfem_tpu.ops import element_matrices as rem

from meshfem_tpu_torch import config as pconfig
from meshfem_tpu_torch.fem import flattening as pfl
from meshfem_tpu_torch.fem import interpolant as pint
from meshfem_tpu_torch.fem import quadrature as pq
from meshfem_tpu_torch.fem import shape_functions as psf
from meshfem_tpu_torch.fem import simplex as psx
from meshfem_tpu_torch.ops import element_matrices as pem

TOL = 1e-12
CASES = [(K, deg) for K in (1, 2, 3) for deg in range(5)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale, \
        float(np.abs(a - b).max())


def _points(K, seed, n=7):
    lam = np.random.default_rng(seed).random((n, K + 1))
    return lam / lam.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("K,deg", CASES)
def test_shape_functions(K, deg):
    lam = _points(K, 10 * K + deg)
    assert psf.node_multi_indices(K, deg) == rsf.node_multi_indices(K, deg)
    _close(psf.eval_shape_np(K, deg, lam), rsf.eval_shape_np(K, deg, lam))
    _close(psf.grad_shape_np(K, deg, lam), rsf.grad_shape_np(K, deg, lam))
    _close(psf.eval_shape(K, deg, torch.tensor(lam)),
           rsf.eval_shape(K, deg, jnp.asarray(lam)))
    _close(psf.integrated_shape_np(K, deg), rsf.integrated_shape_np(K, deg))
    _close(psf.node_positions_barycentric(K, deg),
           rsf.node_positions_barycentric(K, deg))
    # a Lagrange basis: one at its own node, zero at the others
    _close(psf.eval_shape_np(K, deg, psf.node_positions_barycentric(K, deg)),
           np.eye(rsx.num_nodes(K, deg)))


def _cubic(K, kind):
    """A seeded cubic of the barycentric coordinates, scalar or 3-vector."""
    c = np.random.default_rng(K).standard_normal((3,) if kind else ())

    def f(p):
        p = np.asarray(p)
        return c * (p[0] ** 3 - 2.0 * p[0] * p[1] * p[-1]) + p[1] ** 2

    return f


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("vector", [False, True])
def test_interpolant_degree3(K, vector):
    f, nd = _cubic(K, vector), int(vector)
    r = rint.Interpolant.from_function(K, 3, f, nd)
    p = pint.Interpolant.from_function(K, 3, f, nd, device="cpu")
    _close(p.values, r.values)
    lam = _points(K, 3 + K)
    _close(p(torch.tensor(lam)), r(jnp.asarray(lam)))
    _close(p.integrate(0.7), r.integrate(0.7))
    _close(p.promoted(4).values, r.promoted(4).values)
    g = lambda x: np.asarray(x)[0] * np.ones(3 if vector else ())
    r1 = rint.Interpolant.from_function(K, 1, g, nd)
    p1 = pint.Interpolant.from_function(K, 1, g, nd, device="cpu")
    for rr, pp in ((r + r1, p + p1), (r1 - r, p1 - p), (r * 2.5, p * 2.5)):
        assert pp.deg == rr.deg == 3
        _close(pp.values, rr.values)


def test_restrict_to_boundary_degree3_raises():
    """The reference returns the face's corners alone at degree 3, which is
    not the face's node set (a P3 triangle has 10 nodes); the port raises."""
    assert len(rint.restrict_to_boundary(3, 3, 0)) == 3
    assert len(rint.restrict_to_boundary(2, 3, 0)) == 2
    for deg in (3, 4):
        with pytest.raises(ValueError):
            pint.restrict_to_boundary(3, deg, 0)
    np.testing.assert_array_equal(pint.restrict_to_boundary(3, 2, 1),
                                  rint.restrict_to_boundary(3, 2, 1))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_quadrature_rule_and_integrate(K):
    for degree in range(1, rq.MAX_DEGREE[K] + 1):
        P, W = pq.rule(K, degree, device="cpu")
        Pr, Wr = rq.rule(K, degree)
        assert P.dtype == W.dtype == torch.float64
        np.testing.assert_array_equal(_np(P), np.asarray(Pr))
        np.testing.assert_array_equal(_np(W), np.asarray(Wr))
        f = lambda p: np.stack([p[0] ** degree, p[-1] * p[0]])
        _close(pq.integrate(K, degree, lambda p: f(_np(p)), volume=0.3,
                            device="cpu"),
               rq.integrate(K, degree, lambda p: f(np.asarray(p)),
                            volume=0.3))
    with pytest.raises(ValueError):
        pq.rule(K, rq.MAX_DEGREE[K] + 1, device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_flattening_helpers(dim):
    rng = np.random.default_rng(dim)
    A = rng.standard_normal((5, dim, dim))
    A = A + np.swapaxes(A, 1, 2)
    B = rng.standard_normal((5, dim, dim))
    B = B + np.swapaxes(B, 1, 2)
    np.testing.assert_array_equal(pfl.sqrt_shear_doubler(dim),
                                  rfl.sqrt_shear_doubler(dim))
    va = pfl.sym_to_flat(torch.tensor(A))
    vb = pfl.sym_to_flat(torch.tensor(B), dim)
    np.testing.assert_array_equal(_np(va), np.asarray(rfl.sym_to_flat(A)))
    np.testing.assert_array_equal(_np(pfl.flat_to_sym(va)), A)
    _close(pfl.flat_trace(va), rfl.flat_trace(jnp.asarray(_np(va))))
    _close(pfl.flat_frobenius_sq(va),
           rfl.flat_frobenius_sq(jnp.asarray(_np(va))))
    _close(pfl.flat_double_contract(va, vb, dim),
           rfl.flat_double_contract(jnp.asarray(_np(va)),
                                    jnp.asarray(_np(vb)), dim))
    _close(pfl.flat_double_contract(va, vb),
           np.einsum("eij,eij->e", A, B))


@pytest.mark.parametrize("K", [2, 3])
def test_symmetric_pair_assembly(K):
    """``fused_matrix_sym_for`` and ``element_elasticity_fused_apply_sym``
    against the reference's and against the unfolded fused assembly."""
    rng = np.random.default_rng(7 + K)
    D = np.asarray(ret.isotropic(K, 200.0, 0.3))
    g = rng.standard_normal((6, K + 1, K))
    v = rng.random(6)
    n = psx.num_nodes(K, 2)
    Ms, ia, ib = pem.fused_matrix_sym_for(torch.tensor(D), K, 2,
                                          device="cpu")
    Msr, iar, ibr = rem.fused_matrix_sym_for(jnp.asarray(D), K, 2,
                                             jnp.float64)
    _close(Ms, Msr)
    np.testing.assert_array_equal(_np(ia), np.asarray(iar))
    np.testing.assert_array_equal(_np(ib), np.asarray(ibr))
    Ke = pem.element_elasticity_fused_apply_sym(
        torch.tensor(g), torch.tensor(v), Ms, ia, ib, n)
    _close(Ke, rem.element_elasticity_fused_apply_sym(
        jnp.asarray(g), jnp.asarray(v), Msr, iar, ibr, n))
    M = torch.tensor(pem.fused_matrix_for(torch.tensor(D), K, 2))
    _close(Ke, pem.element_elasticity_fused_apply(torch.tensor(g),
                                                  torch.tensor(v), M, n))


def test_config_accessors_and_num_vertices():
    assert pconfig.real_dtype() is pconfig.REAL is torch.float64
    assert pconfig.index_dtype() is pconfig.INDEX is torch.int32
    assert pconfig.accum_dtype() is torch.float64
    assert pconfig.x64_enabled() is rconfig.x64_enabled() is True
    try:
        pconfig.set_real_dtype(torch.float32)
        assert pconfig.real_dtype() is torch.float32
        assert pconfig.REAL is torch.float64       # nothing else changes
    finally:
        pconfig.set_real_dtype(torch.float64)
    for K in (1, 2, 3):
        assert psx.num_vertices(K) == rsx.num_vertices(K) == K + 1
