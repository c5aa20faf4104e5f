"""The port's generalized LOBPCG (``solvers/eigen.py``, both branches) and
vibrational modes (``analysis/modes.py``) against the reference's on the
CPU (the small dense kernels and ``SPSDSystem``:
``tests/test_torch_linalg.py``).

Same inputs (numpy, from a seed) through both packages.  Tolerances:
LOBPCG eigenvalues 1e-10 relative and the
returned blocks through their M-orthogonal projectors 1e-6 (both codes stop
near a residual of 1e-7, the vectors' own accuracy); at a fixed iteration
count the residual histories 1e-5 relative; scipy's shift-invert
``eigsh`` 1e-4 (the reference test's gate), the reference test's
residuals 1e-4.  The reference runs the host-stage loop for closures and the device loop
for registered operators (``EBEKernel``); each port branch is held
against the same branch.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from meshfem_tpu.analysis import modes as rmodes
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.ops import operators as rops
from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                 Material as RMaterial)
from meshfem_tpu.solvers import eigen as reigen

from meshfem_tpu_torch.analysis import modes
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.ops import operators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.solvers import eigen


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- LOBPCG and the modes ---------------------------------------------------

def _pair(V, F, degree=1, E=5.0, nu=0.3):
    dim = V.shape[1]
    rsim = RSim(RFEMMesh(V, F, degree=degree),
                RMaterial.isotropic(dim, E, nu))
    sim = ElasticitySimulator(FEMMesh(V, F, degree=degree),
                              Material.isotropic(dim, E, nu), device="cpu")
    return rsim, sim


def _projector_gap(X, Y, Mop):
    """max |P_X - P_Y| of the M-orthogonal projectors onto span(X), span(Y)
    ([N, k] host arrays, M as a host matrix)."""
    def P(X):
        G = X.T @ (Mop @ X)
        return X @ np.linalg.solve(G, X.T @ Mop)

    return float(np.abs(P(X) - P(Y)).max())


@pytest.fixture(scope="module")
def tri5():
    """grid_tri(5, 5) P1: the reference test's scipy cross-check, run once
    in each package (400 iterations, the reference's own count)."""
    V, F = rgen.grid_tri(5, 5)
    rsim, sim = _pair(V, F)
    kw = dict(n_modes=4, tol=1e-7, maxiter=400)
    lr, Xr = rmodes.compute_vibrational_modes(rsim, **kw)
    lp, Xp = modes.compute_vibrational_modes(sim, **kw)
    return rsim, sim, (lr, Xr), (lp, Xp)


def test_modes_against_reference_and_scipy(tri5):
    """The host-stage branch (closures): eigenvalues to 1e-10 relative,
    the mode blocks through their M-projectors to 1e-6, and the first
    three against scipy's shift-invert eigsh to 1e-4 (the reference's
    test, ``tests/test_solvers_autodiff.py:41-56``)."""
    rsim, sim, (lr, Xr), (lp, Xp) = tri5
    assert _rel(lp, lr) <= 1e-10
    M = operators.mass_elasticity(sim.mesh, device="cpu").to_scipy()
    gap = _projector_gap(_np(Xp).reshape(-1, 4), np.asarray(Xr).reshape(-1, 4),
                         M)
    assert gap <= 1e-6
    K = sim.to_scipy()
    w_ref = np.sort(spla.eigsh(K, k=7, M=M, sigma=-1e-6, which="LM",
                               return_eigenvectors=False))[3:]
    np.testing.assert_allclose(lp[:3], w_ref[:3], rtol=1e-4)


def test_modes_free_square_residuals():
    """The reference test's free square (grid_tri(6), tol 1e-6) on the
    port, with its checks: rigid modes deflated, ascending, K x = lam M x
    to 1e-4 (the host branch against the reference's: ``tri5`` and the
    fixed-count cases)."""
    V, F = rgen.grid_tri(6, 6)
    sim = ElasticitySimulator(FEMMesh(V, F, degree=1),
                              Material.isotropic(2, 5.0, 0.3), device="cpu")
    hist = []
    lam, X = modes.compute_vibrational_modes(sim, n_modes=4, tol=1e-6,
                                             history=hist)
    assert np.all(lam > 1e-6) and np.all(np.diff(lam) > -1e-8)
    Mv = operators.mass_elasticity(sim.mesh, device="cpu")
    for j in range(2):
        x = X[:, :, j]
        r = sim.apply_K(x) - lam[j] * Mv(x)
        rel = float(torch.linalg.norm(r)) / (lam[j] * float(
            torch.linalg.norm(Mv(x))))
        assert rel < 1e-4, (j, rel)
    # the history the reference drops: one [4] array an iteration (this
    # case stalls near 3e-6 and runs all 300, in both packages)
    assert 0 < len(hist) <= 300 and np.all(np.isfinite(hist[-1]))


@pytest.mark.parametrize("case", ["free_tet3_p2", "clamped_tri"])
def test_modes_fixed_iterations(case):
    """At a fixed iteration count, where neither code converges: the same
    trajectory (eigenvalues to 1e-10 relative at every one of its
    Rayleigh quotients' end, the block's projector to 1e-6).  The free
    grid_tet(3) P2 body deflates its six rigid modes; the clamped square
    masks both operators with ``fixed_mask``."""
    if case == "free_tet3_p2":
        V, F = rgen.grid_tet(3, 3, 3)
        rsim, sim = _pair(V, F, degree=2, E=200.0, nu=0.35)
        kw = dict(n_modes=6, maxiter=10)
    else:
        V, F = rgen.grid_tri(5, 5)
        rsim, sim = _pair(V, F)
        fixed = np.zeros((sim.num_dofs, 2), bool)
        fixed[sim.mesh.node_positions[:, 0] < 1e-9] = True
        kw = dict(n_modes=3, maxiter=25, fixed_mask=fixed)
    lr, Xr = rmodes.compute_vibrational_modes(rsim, **kw)
    lam, X = modes.compute_vibrational_modes(sim, **kw)
    assert _rel(lam, lr) <= 1e-10
    m = kw["n_modes"]
    Mh = operators.mass_elasticity(sim.mesh, device="cpu").to_scipy()
    gap = _projector_gap(_np(X).reshape(-1, m), np.asarray(Xr).reshape(-1, m),
                         Mh)
    assert gap <= 1e-6


def test_lobpcg_device_loop_against_reference():
    """Registered operators (``EBEKernel``: the scalar Laplacian and mass
    of grid_tri(8) P1) take the device loop in both packages, the constant
    deflated, 30 iterations (neither reaches 1e-7): the residual history
    to 1e-5, eigenvalues to 1e-10, projectors to 1e-6, and the branch is
    the one ``_ops_are_pytrees`` picks."""
    V, F = rgen.grid_tri(8, 8)
    rm = RFEMMesh(V, F, degree=1)
    pm = FEMMesh(V, F, degree=1)
    rK, rM = rops.laplacian(rm)._kernel, rops.mass(rm)._kernel
    K = operators.laplacian(pm, device="cpu")._kernel
    Mk = operators.mass(pm, device="cpu")._kernel
    assert reigen._ops_are_pytrees(rK, rM) and eigen._ops_are_pytrees(K, Mk)
    assert not eigen._ops_are_pytrees(lambda v: v, Mk)
    N = pm.num_nodes
    X0 = np.random.default_rng(3).standard_normal((N, 3))
    ones = np.ones((N, 1))
    lr, Xr, hr = reigen.lobpcg_generalized(rK, rM, jnp.asarray(X0), tol=1e-7,
                                           maxiter=30, deflate=ones)
    lp, Xp, hp = eigen.lobpcg_generalized(K, Mk, torch.as_tensor(X0),
                                          tol=1e-7, maxiter=30,
                                          deflate=ones)
    assert len(hp) == len(hr) == 3          # one entry a chunk of 10
    assert _rel(np.stack(hp), np.stack(hr)) <= 1e-5
    assert _rel(lp, lr) <= 1e-10
    assert _projector_gap(_np(Xp), np.asarray(Xr), Mk_host(pm)) <= 1e-6


def Mk_host(mesh):
    return operators.mass(mesh, device="cpu").to_scipy()


def test_eigen_helpers_against_reference():
    """``largest_magnitude_eigenvalue`` (power iteration, the reference
    test's matrix), ``nth_largest_generalized`` and
    ``negative_curvature_direction`` on seeded dense operators: the same
    values to 1e-10 relative (vectors up to sign, 1e-6)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((30, 30))
    A = A @ A.T
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    lr, vr = reigen.largest_magnitude_eigenvalue(lambda x: Aj @ x, 30,
                                                 iters=2000, tol=1e-12)
    lp, vp = eigen.largest_magnitude_eigenvalue(lambda x: At @ x, 30,
                                                iters=2000, tol=1e-12,
                                                device="cpu")
    assert abs(lp - lr) <= 1e-10 * abs(lr)
    assert lp == pytest.approx(np.linalg.eigvalsh(A)[-1], rel=1e-6)
    assert _rel(_np(vp), vr) <= 1e-6

    Mm = np.diag(1.0 + rng.random(30))
    Mj, Mt = jnp.asarray(Mm), torch.as_tensor(Mm)
    kr = reigen.nth_largest_generalized(lambda V: Aj @ V, lambda V: Mj @ V,
                                        2, nth=2, N=30, tol=1e-9,
                                        maxiter=300)
    kp = eigen.nth_largest_generalized(lambda V: At @ V, lambda V: Mt @ V,
                                       2, nth=2, N=30, tol=1e-9,
                                       maxiter=300, device="cpu")
    assert abs(kp[0] - kr[0]) <= 1e-10 * abs(kr[0])
    H = A - 2.0 * np.trace(A) / 30 * np.eye(30)
    Hj, Ht = jnp.asarray(H), torch.as_tensor(H)
    nr = reigen.negative_curvature_direction(lambda V: Hj @ V, 30,
                                             tol=1e-9, maxiter=300)
    npt = eigen.negative_curvature_direction(lambda V: Ht @ V, 30, tol=1e-9,
                                             maxiter=300, device="cpu")
    assert npt[0] < 0 and abs(npt[0] - nr[0]) <= 1e-10 * abs(nr[0])
    s = np.sign(float(np.dot(_np(npt[1]), np.asarray(nr[1]))))
    assert _rel(s * _np(npt[1]), nr[1]) <= 1e-6
