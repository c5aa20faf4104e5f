"""The port's nonlinear energy densities, stresses, tangents and adaptors
(``physics/energies.py``) against the reference's on the CPU (the total
energy over a mesh and Newton: ``tests/test_torch_newton.py``).

Same inputs (numpy, from a seed) through both packages.  Tolerances:
densities, stresses and tangents 1e-12 of max against the reference's
``jax.grad`` / ``jax.jvp``; where the reference has no finite answer (the
corotated stress) or its F-based tangent tensors would cost a minute of
eager JAX, central differences (1e-6) or the closed forms at rtol 1e-6 /
1e-8 (the reference tests' gates).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu.fem import elasticity_tensor as ret
from meshfem_tpu.physics import energies as ren

from meshfem_tpu_torch.physics import energies as en
from meshfem_tpu_torch.utils import fd_validation as fd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# -- energies -----------------------------------------------------------------

@pytest.fixture(scope="module")
def random_F():
    rng = np.random.default_rng(9)
    F3 = np.eye(3) + 0.1 * rng.standard_normal((5, 3, 3))
    Fm = np.concatenate([np.eye(2), np.zeros((1, 2))]) \
        + 0.05 * rng.standard_normal((6, 3, 2))
    dF3 = rng.standard_normal((5, 3, 3))
    dFm = rng.standard_normal((6, 3, 2))
    return F3, Fm, dF3, dFm


@pytest.mark.parametrize("name", ["stvk", "neo_hookean", "corotated",
                                  "linear", "membrane_stvk",
                                  "tension_field_stvk"])
def test_energy_density_stress_tangent(random_F, name):
    """Each density, its PK1 stress and its tangent applied to a direction
    at seeded F, to 1e-12 of max against the reference's (grad / jvp).
    The corotated stress is NaN in the reference (its Jacobi angle's tau^2
    overflows once a sweep has converged, and the derivative of the
    overflow is NaN); the port's is finite and is held against central
    differences instead (1e-6)."""
    F3, Fm, dF3, dFm = random_F
    membrane = "membrane" in name or "tension" in name
    F, dF = (Fm, dFm) if membrane else (F3, dF3)
    rfn, pfn = ren.ENERGY_DENSITIES[name], en.ENERGY_DENSITIES[name]
    args = (1.2, 0.8)
    assert _rel(pfn(_t(F), *args), rfn(jnp.asarray(F), *args)) <= 1e-12
    P_r = ren.pk1_stress(rfn)(jnp.asarray(F), *args)
    P_p = en.pk1_stress(pfn)(_t(F), *args)
    if name == "corotated":
        assert bool(jnp.isnan(P_r).any()) and bool(torch.isfinite(P_p).all())
        f = lambda F_: pfn(F_, *args).sum()
        assert fd.fd_gradient_check(f, _t(F)) <= 1e-6
        assert fd.fd_hessian_check(f, _t(F), n_dirs=1) <= 1e-6
        return
    assert _rel(P_p, P_r) <= 1e-12
    dP_r = ren.tangent_apply(rfn)(jnp.asarray(F), jnp.asarray(dF), *args)
    assert _rel(en.tangent_apply(pfn)(_t(F), _t(dF), *args), dP_r) <= 1e-12


def test_tension_field_branches():
    """The tension-field energy and its stress across its three regimes
    (taut, wrinkled, slack), including F on the taut/wrinkled branch
    boundary, against the reference to 1e-12."""
    lam, mu = 1.2, 0.8
    lam_ps = 2 * lam * mu / (lam + 2 * mu)
    nu_star = lam_ps / (lam_ps + 2 * mu)
    l1 = 1.1
    e1 = 0.5 * (l1 ** 2 - 1)
    l2_edge = np.sqrt(1 - 2 * nu_star * e1)          # e2 = -nu* e1
    Fs = np.zeros((5, 3, 2))
    for i, (a, b) in enumerate([(1.1, 1.05), (1.1, 0.8), (0.9, 0.8),
                                (l1, l2_edge), (1.0, 1.0)]):
        Fs[i, 0, 0], Fs[i, 1, 1] = a, b
    rot = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1.0]])
    Fs = rot @ Fs
    r = ren.tension_field_stvk_energy(jnp.asarray(Fs), lam, mu)
    p = en.tension_field_stvk_energy(_t(Fs), lam, mu)
    assert _rel(p, r) <= 1e-12
    P_r = ren.pk1_stress(ren.tension_field_stvk_energy)(jnp.asarray(Fs[:4]),
                                                         lam, mu)
    P_p = en.pk1_stress(en.tension_field_stvk_energy)(_t(Fs[:4]), lam, mu)
    assert _rel(P_p, P_r) <= 1e-12


def test_energy_adaptors_against_reference(random_F):
    """The F/C adaptors, ``spd_sqrt``, PK2 and its directional derivative
    (C-based, and through the F-adaptor's square root), the C-based
    tangent elasticity tensor at I and at a stretched C: each equal to the
    reference's to 1e-12 of max; the PSD-projected tangent at an
    indefinite state equal to a numpy eigenprojection
    of the exact tangent's columns (1e-10; the reference's eager one costs
    ten seconds).  The F-based tangent tensors (through
    ``spd_sqrt``) against their closed forms: at the identity, StVK and
    NeoHookean give the isotropic tensor (rtol 1e-6, also in 2D, the
    plane-strain one); at a stretched F, StVK's is constant (1e-8)."""
    F3, Fm, dF3, _ = random_F
    lam, mu = 0.58, 0.38
    Fj, Ft = jnp.asarray(F3), _t(F3)
    assert _rel(en.f_based_from_c_based(en.stvk_energy_C)(Ft, lam, mu),
                ren.f_based_from_c_based(ren.stvk_energy_C)(Fj, lam, mu)) \
        <= 1e-12
    C = np.einsum("eki,ekj->eij", F3, F3)
    assert _rel(en.spd_sqrt(_t(C)), ren.spd_sqrt(jnp.asarray(C))) <= 1e-12
    assert _rel(en.c_based_from_f_based(en.neo_hookean_energy)(_t(C), lam, mu),
                ren.c_based_from_f_based(ren.neo_hookean_energy)(
                    jnp.asarray(C), lam, mu)) <= 1e-12
    assert _rel(en.pk2_stress(en.stvk_energy_C)(_t(C), lam, mu),
                ren.pk2_stress(ren.stvk_energy_C)(jnp.asarray(C), lam, mu)) \
        <= 1e-12
    dC = np.einsum("eki,ekj->eij", dF3, dF3)
    assert _rel(en.delta_pk2_stress(en.stvk_energy_C)(_t(C), _t(dC), lam, mu),
                ren.delta_pk2_stress(ren.stvk_energy_C)(
                    jnp.asarray(C), jnp.asarray(dC), lam, mu)) <= 1e-12
    Fd = np.diag([1.2, 0.9, 1.05])
    for C0 in (None, Fd.T @ Fd):
        kr = {} if C0 is None else dict(C=jnp.asarray(C0))
        kp = {} if C0 is None else dict(C=C0)
        Tr = ren.tangent_elasticity_tensor(ren.stvk_energy_C, 3, lam, mu,
                                           c_based=True, **kr)
        Tp = en.tangent_elasticity_tensor(en.stvk_energy_C, 3, lam, mu,
                                          c_based=True, **kp)
        assert _rel(Tp.D, Tr.D) <= 1e-12
    D_ref = np.asarray(ret.isotropic_lame(3, lam, mu))
    for psi in (en.stvk_energy, en.neo_hookean_energy):
        T = en.tangent_elasticity_tensor(psi, 3, lam, mu)
        np.testing.assert_allclose(T.D.numpy(), D_ref, rtol=1e-6,
                                   atol=1e-8 * np.abs(D_ref).max())
    D2 = np.asarray(ret.isotropic_lame(2, lam, mu))
    T2 = en.tangent_elasticity_tensor(en.stvk_energy, 2, lam, mu)
    np.testing.assert_allclose(T2.D.numpy(), D2, rtol=1e-6,
                               atol=1e-8 * np.abs(D2).max())
    T = en.tangent_elasticity_tensor(en.stvk_energy, 3, lam, mu, F=Fd)
    np.testing.assert_allclose(T.D.numpy(), D_ref, rtol=1e-8,
                               atol=1e-10 * np.abs(D_ref).max())
    rng = np.random.default_rng(4)
    Fc = 0.3 * np.eye(3)[None] + 0.02 * rng.standard_normal((2, 3, 3))
    dF = rng.standard_normal((2, 3, 3))
    q_p = en.projected_tangent_apply(en.neo_hookean_energy)(_t(Fc), _t(dF),
                                                             lam, mu)
    # the same projection built by numpy from the exact tangent's columns
    exact = en.tangent_apply(en.neo_hookean_energy)
    H = np.stack([exact(_t(Fc), _t(np.broadcast_to(np.eye(9)[i].reshape(
        3, 3), Fc.shape)), lam, mu).numpy().reshape(2, 9)
        for i in range(9)], axis=-1)
    w, V = np.linalg.eigh(0.5 * (H + np.swapaxes(H, -1, -2)))
    assert (w < 0).any()                      # the state is indefinite
    q_np = np.einsum("eik,ek,ejk,ej->ei", V, np.maximum(w, 0), V,
                     dF.reshape(2, 9)).reshape(2, 3, 3)
    assert _rel(q_p, q_np) <= 1e-10
    assert float((q_p * _t(dF)).sum()) >= -1e-10


def _lame(E, nu):
    return E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))


@pytest.mark.parametrize("case", ["rest_state", "densities_fd",
                                  "small_strain", "membrane_embedding",
                                  "c_from_f_roundtrip", "pk2_closed_form",
                                  "projected_exact_when_psd"])
def test_reference_test_cases(case):
    """The port through the checks of ``tests/test_solvers_autodiff.py``
    and ``tests/test_energy_adaptors.py`` that hold each package against
    itself or a closed form, with their tolerances: zero energy and
    stress at rest (1e-12 / 1e-10), stresses against central differences
    (1e-5), the small-strain limit (rel 5e-3), the 3x2 membrane F through
    the C adaptor (1e-12), the square-root round trip (1e-9), StVK's PK2
    closed form (1e-10), the projection exact where the Hessian is PSD
    (1e-5)."""
    rng = np.random.default_rng(11)
    if case == "rest_state":
        F = torch.eye(3, dtype=torch.float64).expand(5, 3, 3)
        Fm = torch.eye(3, dtype=torch.float64)[:, :2].expand(5, 3, 2)
        for name, fn in en.ENERGY_DENSITIES.items():
            Fx = Fm if "membrane" in name or "tension" in name else F
            assert float(fn(Fx, 1.2, 0.8).abs().max()) <= 1e-12, name
            if "tension" in name:
                continue       # the relaxed energy is only C^0 at rest
            P = en.pk1_stress(fn)(Fx, 1.2, 0.8)
            assert float(P.abs().max()) <= 1e-10, name
    elif case == "densities_fd":
        F = _t(np.eye(3) + 0.1 * rng.standard_normal((4, 3, 3)))
        for name in ("stvk", "neo_hookean", "linear", "corotated"):
            fn = en.ENERGY_DENSITIES[name]
            err = fd.fd_gradient_check(lambda F_: fn(F_, 1.2, 0.8).sum(), F)
            assert err < 1e-5, (name, err)
    elif case == "small_strain":
        F = _t(np.eye(3) + 1e-4 * rng.standard_normal((3, 3)))[None]
        e_lin = float(en.linear_elasticity_energy(F, 1.3, 0.7)[0])
        for name in ("stvk", "neo_hookean", "corotated"):
            e = float(en.ENERGY_DENSITIES[name](F, 1.3, 0.7)[0])
            assert e == pytest.approx(e_lin, rel=5e-3), name
    elif case == "membrane_embedding":
        F = _t(np.concatenate([np.eye(2), np.zeros((1, 2))])
               + 0.05 * rng.standard_normal((5, 3, 2)))
        lam, mu = _lame(1.0, 0.3)
        w = en.f_based_from_c_based(en.stvk_energy_C)(F, lam, mu)
        C = torch.einsum("eki,ekj->eij", F, F)
        assert _rel(w, en.stvk_energy_C(C, lam, mu).numpy()) <= 1e-12
    elif case == "c_from_f_roundtrip":
        A = 0.1 * rng.standard_normal((3, 3))
        F = _t(np.eye(3) + A @ A.T)           # symmetric positive F
        lam, mu = _lame(1.0, 0.3)
        psi_C = en.c_based_from_f_based(en.neo_hookean_energy)
        assert float(psi_C(F.T @ F, lam, mu)) == pytest.approx(
            float(en.neo_hookean_energy(F, lam, mu)), rel=1e-9)
    elif case == "pk2_closed_form":
        C = np.eye(3) + 0.1 * rng.standard_normal((3, 3))
        C = 0.5 * (C + C.T) + np.eye(3)
        lam, mu = _lame(1.0, 0.3)
        S = en.pk2_stress(en.stvk_energy_C)(_t(C), lam, mu)
        E = 0.5 * (C - np.eye(3))
        assert _rel(S, lam * np.trace(E) * np.eye(3) + 2 * mu * E) <= 1e-10
    else:              # the reference test's draws (its seed, 5)
        rng = np.random.default_rng(5)
        lam, mu = _lame(1.0, 0.3)
        F = _t(np.eye(3) + 0.01 * rng.standard_normal((3, 3)))
        dF = _t(rng.standard_normal((3, 3)))
        dP = en.projected_tangent_apply(en.stvk_energy)(F, dF, lam, mu)
        dP_exact = en.tangent_apply(en.stvk_energy)(F, dF, lam, mu)
        np.testing.assert_allclose(dP.numpy(), dP_exact.numpy(), rtol=1e-5,
                                   atol=1e-8)
