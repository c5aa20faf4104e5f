"""Material-fit validation suite: generate -> fit -> compare (counterpart
of ``experiments/fit_validation.py``).

1. **algebraic round-trip**: (strain, stress) pairs synthesized from a
   known isotropic / orthotropic tensor (raw-component flattening,
   ``stress = D S eps``) are fitted with ``fit_isotropic`` /
   ``fit_orthotropic``; the moduli come back to 1e-7;
2. **simulation round-trip**: a 2D compression problem (fixed bottom,
   compressed top) is solved with a known material, fitted from the
   solver's per-element average strains, stresses and volumes, and solved
   again with the fitted material; the moduli and the displacement field
   must match (isotropic, and orthotropic from a compression and a shear
   probe);
3. **robustness**: fits under multiplicative noise.

Run: python -m meshfem_tpu_torch.experiments.fit_validation [--n 12]
     [--degree 2] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from meshfem_tpu_torch.fem import elasticity_tensor as et
from meshfem_tpu_torch.fem.flattening import shear_doubler
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.physics.materials import (fit_isotropic,
                                                 fit_orthotropic)


def synth_pairs(D, n_samples: int, dim: int, rng, noise: float = 0.0):
    """Random strains and exact stresses sigma = D S eps (raw
    components)."""
    fl = D.shape[0]
    eps = rng.standard_normal((n_samples, fl))
    S = shear_doubler(dim)
    sig = eps @ (np.asarray(D) * S[None, :]).T
    if noise:
        sig = sig * (1.0 + noise * rng.standard_normal(sig.shape))
    return eps, sig


def check_isotropic_roundtrip(rng, dim: int, E0=2.3, nu0=0.31):
    D = et.isotropic(dim, E0, nu0).numpy()
    eps, sig = synth_pairs(D, 40, dim, rng)
    E, nu = fit_isotropic(eps, sig, dim=dim)
    errE, errnu = abs(E - E0) / E0, abs(nu - nu0)
    print(f"  iso {dim}D: E={E:.6f} (err {errE:.2e})  "
          f"nu={nu:.6f} (err {errnu:.2e})")
    assert errE < 1e-7 and errnu < 1e-7
    return E, nu


def check_orthotropic_roundtrip(rng, dim: int):
    if dim == 2:
        moduli = dict(Ex=1.7, Ey=0.9, nu_yx=0.23, mu_xy=0.4)
        D = et.orthotropic_2d(**moduli).numpy()
    else:
        moduli = dict(Ex=1.7, Ey=0.9, Ez=1.2, nu_yx=0.23, nu_zx=0.11,
                      nu_zy=0.31, mu_yz=0.35, mu_zx=0.45, mu_xy=0.4)
        D = et.orthotropic_3d(**moduli).numpy()
    eps, sig = synth_pairs(D, 60, dim, rng)
    fit = fit_orthotropic(eps, sig, dim=dim)
    worst = max(abs(fit[k] - v0) / abs(v0) for k, v0 in moduli.items())
    print(f"  ortho {dim}D: worst modulus err {worst:.2e}  ({fit})")
    assert worst < 1e-7
    return fit


def compression_sim(mesh, material, tol=1e-10, device=None):
    """Fixed bottom edge, downward traction on the top edge, solved to
    ``tol``.  Returns (simulator, u as numpy, the solver's result)."""
    sim = ElasticitySimulator(mesh, material, device=device)
    X = np.asarray(mesh.node_positions)
    ymin, ymax = X[:, 1].min(), X[:, 1].max()
    sim.dirichlet_mask[X[:, 1] < ymin + 1e-9] = True
    load = np.zeros((mesh.num_nodes, 2))
    load[X[:, 1] > ymax - 1e-9, 1] = -0.05
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    u, res = sim.solve(tol=tol)
    return sim, u.cpu().numpy(), res


def _samples(sim, u):
    """(average strains, average stresses) [E, fl] of the field ``u``
    (numpy) as numpy."""
    ut = torch.as_tensor(u, device=sim.device)
    return (sim.average_strain_field(ut).cpu().numpy(),
            sim.average_stress_field(ut).cpu().numpy())


def check_simulation_roundtrip(n: int, degree: int, E0=2.0, nu0=0.28,
                               tol=1e-10, device=None):
    """Solve with a known isotropic material; fit from the solver's own
    per-element (strain, stress, volume) samples; solve again with the
    fitted material; compare the moduli and the displacement fields.
    Returns the relative displacement gap."""
    mesh = FEMMesh(*generators.grid_tri(n, n), degree=degree)
    sim, u, _ = compression_sim(mesh, Material.isotropic(2, E0, nu0),
                                tol=tol, device=device)
    eps, sig = _samples(sim, u)
    vol = sim.geom.volume.cpu().numpy()
    E, nu = fit_isotropic(eps, sig, volumes=vol, dim=2)
    errE, errnu = abs(E - E0) / E0, abs(nu - nu0)
    print(f"  sim fit: E={E:.8f} (err {errE:.2e})  nu={nu:.8f} "
          f"(err {errnu:.2e})")
    assert errE < 1e-6 and errnu < 1e-6

    # an orthotropic fit of isotropic data recovers the isotropic tensor
    fit_o = fit_orthotropic(eps, sig, volumes=vol, dim=2)
    assert abs(fit_o["Ex"] - E0) / E0 < 1e-5
    assert abs(fit_o["Ey"] - E0) / E0 < 1e-5
    assert abs(fit_o["nu_yx"] - nu0) < 1e-5
    mu0 = E0 / (2.0 * (1.0 + nu0))
    assert abs(fit_o["mu_xy"] - mu0) / mu0 < 1e-5

    # solve again with the FITTED material: the displacement fields match
    _, u_fit, _ = compression_sim(mesh, Material.isotropic(2, E, nu),
                                  tol=tol, device=device)
    du = np.abs(u_fit - u).max() / np.abs(u).max()
    print(f"  re-sim displacement rel err: {du:.2e}")
    assert du < 1e-5
    return du


def check_orthotropic_simulation(n: int, degree: int, tol=1e-10,
                                 device=None):
    """The same loop with an orthotropic material, from a compression and
    a shear probe (compression alone leaves the xy block rank-deficient):
    the orthotropic fit recovers the moduli."""
    moduli = dict(Ex=2.0, Ey=0.8, nu_yx=0.1, mu_xy=0.5)
    mat = Material.orthotropic(2, [moduli["Ex"], moduli["Ey"],
                                   moduli["nu_yx"], moduli["mu_xy"]])
    mesh = FEMMesh(*generators.grid_tri(n, n), degree=degree)
    sim, u, _ = compression_sim(mesh, mat, tol=tol, device=device)
    X = np.asarray(mesh.node_positions)
    sim2 = ElasticitySimulator(mesh, mat, device=device)
    sim2.dirichlet_mask[X[:, 1] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 2))
    load[X[:, 1] > X[:, 1].max() - 1e-9, 0] = 0.05   # shear the top
    sim2.neumann_load = torch.as_tensor(load, device=sim2.device)
    u2, _ = sim2.solve(tol=tol)
    (e1, s1), (e2, s2) = _samples(sim, u), _samples(sim2, u2.cpu().numpy())
    eps, sig = np.concatenate([e1, e2]), np.concatenate([s1, s2])
    vol = np.concatenate([sim.geom.volume.cpu().numpy()] * 2)
    fit = fit_orthotropic(eps, sig, volumes=vol, dim=2)
    worst = max(abs(fit[k] - v0) / abs(v0) for k, v0 in moduli.items())
    print(f"  ortho sim fit: worst modulus err {worst:.2e}  ({fit})")
    assert worst < 1e-5
    return fit


def check_noise_robustness(rng, dim=2, noise=1e-3):
    D = et.isotropic(dim, 2.3, 0.31).numpy()
    eps, sig = synth_pairs(D, 400, dim, rng, noise=noise)
    E, nu = fit_isotropic(eps, sig, dim=dim)
    errE = abs(E - 2.3) / 2.3
    print(f"  noisy fit (sigma {noise:.0e}): E err {errE:.2e}, "
          f"nu err {abs(nu - 0.31):.2e}")
    assert errE < 50 * noise and abs(nu - 0.31) < 50 * noise
    return E, nu


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12, help="grid resolution")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    print("[1] algebraic round-trips")
    for dim in (2, 3):
        check_isotropic_roundtrip(rng, dim)
        check_orthotropic_roundtrip(rng, dim)
    print("[2] simulation round-trip (isotropic)")
    check_simulation_roundtrip(args.n, args.degree, device=args.device)
    print("[3] simulation round-trip (orthotropic, 2 probes)")
    check_orthotropic_simulation(args.n, args.degree, device=args.device)
    print("[4] noise robustness")
    check_noise_robustness(rng)
    print("fit_validation: ALL CHECKS PASSED")


if __name__ == "__main__":
    main()
