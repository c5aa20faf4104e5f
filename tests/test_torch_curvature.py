"""Discrete curvature (``analysis/curvature.py``) of ``meshfem_tpu_torch``
against ``meshfem_tpu`` on the CPU.

Angle deficits, mixed Voronoi areas and Gaussian curvature on a flat grid
(K = 0 inside, 1e-10), a seeded bumpy grid in 3D, a perturbed planar mesh
(the reference's 2D ``cross`` branch) and the icosahedron of
``tests/test_applications.py`` (Gauss-Bonnet 4 pi, 1e-10), each against
the reference to 1e-12; the autograd sensitivity against ``jax.grad``
(1e-10), and the sum of squared deficits by the port's
``fd_gradient_check`` (error < 1e-5).  The port's vertex sums run through
its ``ScatterPlan`` (the plain segment sum on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshfem_tpu.analysis import curvature as rcurv

from meshfem_tpu_torch.analysis import curvature as curv
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.utils.fd_validation import fd_gradient_check


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, err


def _flat():
    V, F = generators.grid_tri(8, 8)
    return np.column_stack([V, np.zeros(len(V))]), F


def _bumpy():
    V, F = generators.grid_tri(6, 6)
    z = 0.1 * np.random.default_rng(5).standard_normal(len(V))
    return np.column_stack([V, z]), F


def _planar():
    V, F = generators.grid_tri(6, 6)
    inner = np.all((V > 1e-9) & (V < 1 - 1e-9), axis=1)
    V = V.copy()
    V[inner] += 0.04 * np.random.default_rng(6).uniform(
        -1, 1, (int(inner.sum()), 2))
    return V, F


def _icosahedron():
    t = (1 + 5 ** 0.5) / 2
    V = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1.]])
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                  [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return V, F


SURFACES = {"flat": _flat, "bumpy": _bumpy, "planar": _planar,
            "icosahedron": _icosahedron}


def _boundary(V, F):
    if len(F) == 20:       # the closed icosahedron
        return None
    return FEMMesh(V, F, degree=1).cell.boundary_vertices()


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_curvature_matches_reference(name):
    V, F = SURFACES[name]()
    bv = _boundary(V, F)
    _close(curv._corner_angles(V, F, device="cpu"),
           rcurv._corner_angles(jnp.asarray(V), F), 1e-12)
    _close(curv.angle_deficits(V, F, bv, device="cpu"),
           rcurv.angle_deficits(V, F, bv), 1e-12)
    _close(curv.mixed_voronoi_areas(V, F, device="cpu"),
           rcurv.mixed_voronoi_areas(V, F), 1e-12)
    _close(curv.gaussian_curvature(V, F, bv, device="cpu"),
           rcurv.gaussian_curvature(V, F, bv), 1e-12)


def test_flat_grid_has_no_curvature_inside():
    V, F = _flat()
    bv = _boundary(V, F)
    K = curv.gaussian_curvature(V, F, bv, device="cpu").numpy()
    inner = np.setdiff1d(np.arange(len(V)), bv)
    np.testing.assert_allclose(K[inner], 0.0, atol=1e-10)


def test_gauss_bonnet_on_the_icosahedron():
    V, F = _icosahedron()
    total = float(curv.angle_deficits(torch.as_tensor(V), F).sum())
    assert total == pytest.approx(4 * np.pi, rel=1e-10)


@pytest.mark.parametrize("name", ["bumpy", "planar", "icosahedron"])
def test_sensitivity_matches_jax_grad(name):
    V, F = SURFACES[name]()
    bv = _boundary(V, F)
    g = curv.gaussian_curvature_sensitivity(V, F, bv, device="cpu")
    g_ref = jax.grad(lambda V_: jnp.sum(rcurv.angle_deficits(V_, F, bv))
                     )(jnp.asarray(V))
    _close(g, g_ref, 1e-10)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(rcurv.gaussian_curvature_sensitivity(V, F, bv)),
        atol=1e-10)


def test_squared_deficits_against_finite_differences():
    """The reference test's check (``tests/test_applications.py``): the
    autograd gradient of sum(deficit^2) against central differences."""
    rng = np.random.default_rng(0)
    V, F = generators.grid_tri(4, 4)
    V3 = np.column_stack([V, 0.1 * rng.standard_normal(len(V))])
    err = fd_gradient_check(
        lambda V_: (curv.angle_deficits(V_, F) ** 2).sum(),
        torch.as_tensor(V3), eps=1e-6)
    assert err < 1e-5


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_prebuilt_corner_plan_is_the_same(name):
    """A plan from ``corner_plan`` passed to every function gives the same
    values, to the bit, as each function's own; a plan of another surface
    is refused."""
    V, F = SURFACES[name]()
    bv = _boundary(V, F)
    plan = curv.corner_plan(F, len(V), "cpu")
    for fn, args in ((curv.angle_deficits, (bv,)),
                     (curv.mixed_voronoi_areas, ()),
                     (curv.gaussian_curvature, (bv,)),
                     (curv.gaussian_curvature_sensitivity, (bv,))):
        assert torch.equal(fn(V, F, *args, device="cpu", plan=plan),
                           fn(V, F, *args, device="cpu"))
    other = curv.corner_plan(F[:-1], len(V), "cpu")
    with pytest.raises(ValueError, match="corner plan"):
        curv.angle_deficits(V, F, device="cpu", plan=other)
