"""Interpolants (``fem/interpolant.py``) and one-forms (``fem/one_form.py``)
of ``meshfem_tpu_torch`` against ``meshfem_tpu`` on the CPU.

The same seeded polynomials are sampled by both packages at scalar,
vector and symmetric-matrix values for every (K, deg) in {2, 3} x {1, 2};
the nodal values, evaluation at seeded barycentric points, integrals,
promotion and arithmetic across degrees agree to 1e-12, as do
``restrict_to_boundary`` on every face and ``OneForm.of`` (torch.autograd)
against ``jax.grad`` of the same function, its pairing and ``compose``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshfem_tpu.fem import interpolant as rint
from meshfem_tpu.fem import one_form as rof

from meshfem_tpu_torch.fem import interpolant as pint
from meshfem_tpu_torch.fem import one_form as pof

TOL = 1e-12


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


VALUE_SHAPES = {"scalar": (), "vector": (3,), "symmetric": (3, 3)}


def _poly(K, deg, kind, seed):
    """A seeded degree-``deg`` polynomial of the barycentric coordinates
    with values of ``kind``: f(lam) = sum_i c_i lam_i^deg (+ a cross term
    c' lam_0 lam_1 at degree 2), symmetrized for matrix values."""
    shape = VALUE_SHAPES[kind]
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((K + 1,) + shape)
    cross = rng.standard_normal(shape)
    if kind == "symmetric":
        coef = coef + np.swapaxes(coef, -1, -2)
        cross = cross + cross.T

    def f(lam):
        lam = np.asarray(lam, dtype=np.float64)
        v = sum(coef[i] * lam[i] ** deg for i in range(K + 1))
        if deg == 2:
            v = v + cross * lam[0] * lam[1]
        return np.asarray(v, dtype=np.float64)

    return f, len(shape)


@pytest.mark.parametrize("kind", sorted(VALUE_SHAPES))
@pytest.mark.parametrize("K,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_interpolant_matches_reference(K, deg, kind):
    f, vnd = _poly(K, deg, kind, seed=10 * K + deg)
    g, _ = _poly(K, 2, kind, seed=100 + K)
    r = rint.Interpolant.from_function(K, deg, f, value_ndim=vnd)
    p = pint.Interpolant.from_function(K, deg, f, value_ndim=vnd,
                                      device="cpu")
    assert p.n_nodes == r.n_nodes
    _close(p.values, r.values)
    lam = np.random.default_rng(K + deg).dirichlet(np.ones(K + 1), size=5)
    _close(p(lam), r(jnp.asarray(lam)))
    # sampling reproduces the polynomial
    _close(p(lam), np.stack([f(x) for x in lam]))
    _close(p.integrate(0.7), r.integrate(0.7))
    _close(p.average(), r.average())
    if deg == 1:
        _close(p.promoted(2).values, r.promoted(2).values)
    rg = rint.Interpolant.from_function(K, 2, g, value_ndim=vnd)
    pg = pint.Interpolant.from_function(K, 2, g, value_ndim=vnd,
                                       device="cpu")
    for op in (lambda a, b: a + b, lambda a, b: a - b,
               lambda a, b: b - a):
        pr, rr = op(p, pg), op(r, rg)
        assert (pr.deg, pr.value_ndim) == (rr.deg, rr.value_ndim)
        _close(pr.values, rr.values)
        _close(pr(lam), rr(jnp.asarray(lam)))
    _close((2.5 * p).values, (2.5 * r).values)
    _close((p * -0.5).values, (r * -0.5).values)


@pytest.mark.parametrize("K,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_interpolant_batched_matches_reference(K, deg):
    """A field of per-element interpolants with vector values: evaluation
    at one point per element and the integrals over elements of seeded
    volumes."""
    rng = np.random.default_rng(7 + K + deg)
    n = rint.Interpolant(K, deg, jnp.zeros(1)).n_nodes
    vals = rng.standard_normal((4, n, 2))
    r = rint.Interpolant(K, deg, jnp.asarray(vals), value_ndim=1)
    p = pint.Interpolant(K, deg, torch.as_tensor(vals), value_ndim=1)
    lam = rng.dirichlet(np.ones(K + 1), size=4)
    _close(p(lam), r(jnp.asarray(lam)))
    vol = rng.uniform(0.5, 2.0, size=4)[:, None]
    _close(p.integrate(torch.as_tensor(vol)), r.integrate(jnp.asarray(vol)))


@pytest.mark.parametrize("K,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_restrict_to_boundary_matches_reference(K, deg):
    for face in range(K + 1):
        np.testing.assert_array_equal(
            pint.restrict_to_boundary(K, deg, face),
            rint.restrict_to_boundary(K, deg, face))


def _scalar_fn(lib, W):
    """The same scalar function of node positions in torch or jax.numpy."""
    def f(X):
        return lib.sum(lib.sin(X) * W) + 0.1 * lib.sum(X ** 3) \
            + lib.sum(X[:, 0] * X[:, 1])
    return f


def test_one_form_of_matches_jax_grad():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((9, 2))
    W = rng.standard_normal((9, 2))
    vel = rng.standard_normal((9, 2))
    r = rof.OneForm.of(_scalar_fn(jnp, jnp.asarray(W)), jnp.asarray(X))
    p = pof.OneForm.of(_scalar_fn(torch, torch.as_tensor(W)), X,
                       device="cpu")
    _close(p.coeffs, r.coeffs)
    _close(p(vel), r(jnp.asarray(vel)))
    r2 = rof.OneForm(r.coeffs * 0.5 + 1.0)
    p2 = pof.OneForm(p.coeffs * 0.5 + 1.0)
    _close((p + p2).coeffs, (r + r2).coeffs)
    _close((p - p2).coeffs, (r - r2).coeffs)
    _close((3.0 * p)(vel), (3.0 * r)(jnp.asarray(vel)))


def test_one_form_compose_matches_reference():
    """A tensor-valued form (one per output of a 3-vector function) pushed
    through a seeded linear map of its value axis."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((7, 3))
    Ws = rng.standard_normal((3, 7, 3))
    A = rng.standard_normal((2, 3))
    vel = rng.standard_normal((7, 3))
    r = rof.OneForm(jnp.stack([
        jax.grad(_scalar_fn(jnp, jnp.asarray(W)))(jnp.asarray(X))
        for W in Ws]))
    p = pof.OneForm(torch.stack([
        pof.OneForm.of(_scalar_fn(torch, torch.as_tensor(W)), X,
                       device="cpu").coeffs
        for W in Ws]))
    _close(p.coeffs, r.coeffs)
    rc = rof.compose(lambda c: jnp.einsum("ij,jnd->ind", jnp.asarray(A), c),
                     r)
    pc = pof.compose(lambda c: torch.einsum("ij,jnd->ind",
                                            torch.as_tensor(A), c), p)
    _close(pc.coeffs, rc.coeffs)
    _close(pc(vel), rc(jnp.asarray(vel)))


def _default_device_or_raises(make):
    """``make()`` lands on the CUDA device, or raises where there is none:
    numpy input never falls back to the CPU."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("entry", ["interpolant", "one_form"])
def test_numpy_input_goes_to_the_default_device(entry):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((6, 2))
    W = torch.as_tensor(rng.standard_normal((6, 2)))
    if entry == "interpolant":
        f, vnd = _poly(2, 2, "vector", seed=5)
        _default_device_or_raises(
            lambda: pint.Interpolant.from_function(2, 2, f, vnd).values)
        # values that f returns as CPU tensors stay on the CPU
        p = pint.Interpolant.from_function(
            2, 2, lambda lam: torch.as_tensor(f(lam)), vnd)
        assert p.values.device.type == "cpu"
    else:
        fn = _scalar_fn(torch, W)
        _default_device_or_raises(lambda: pof.OneForm.of(fn, X).coeffs)
        # a CPU tensor keeps its device
        assert pof.OneForm.of(fn, torch.as_tensor(X)).coeffs.device.type \
            == "cpu"
