"""Surface parametrization (``analysis/parametrization.py``) of
``meshfem_tpu_torch`` against ``meshfem_tpu`` on the CPU.

grid_tri(8) P1 flat and grid_tri(10) P1 lifted onto a paraboloid in 3D
(two mesh shapes, so the reference compiles for two):
``harmonic`` (the map to 1e-8, the boundary on the unit circle to 1e-8,
every scale factor positive), ``lscm`` (1e-8; a flat grid's conformal
distortion 1 to 1e-6, the lifted grid's against the reference's to
1e-8), ``scp`` at a fixed LOBPCG iteration count (the
eigenvalues to 1e-10, the map up to its sign to 1e-8; the reference's SCP
ends at its ``maxiter`` on these meshes), ``scale_factor`` and
``conformal_distortion`` of the same map (1e-10), and ``harmonic`` on a
P2 mesh as the reference computes it: the boundary vertices fixed, its
boundary edge nodes free and off the circle by the same amount.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu.analysis import parametrization as rpar
from meshfem_tpu.mesh import FEMMesh as RFEMMesh

from meshfem_tpu_torch.analysis import parametrization as par
from meshfem_tpu_torch.mesh import FEMMesh, generators


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _surface(n, lifted, degree=1):
    """(port mesh, reference mesh) of grid_tri(n) in 3D, flat or on the
    paraboloid z = (x - 1/2)^2 + (y - 1/2)^2."""
    V, F = generators.grid_tri(n, n)
    z = ((V - 0.5) ** 2).sum(axis=1) if lifted else np.zeros(len(V))
    V3 = np.column_stack([V, z])
    return (FEMMesh(V3, F, degree=degree, embedding_dim=3),
            RFEMMesh(V3, F, degree=degree, embedding_dim=3))


@pytest.mark.parametrize("n,lifted", [(8, False), (10, True)])
def test_harmonic_matches_reference(n, lifted):
    pm, rm = _surface(n, lifted)
    uv = par.harmonic(pm, device="cpu")
    uv_ref = np.asarray(rpar.harmonic(rm))
    assert _rel(uv, uv_ref) <= 1e-8
    r = np.linalg.norm(uv.numpy()[pm.cell.boundary_vertices()], axis=1)
    np.testing.assert_allclose(r, 1.0, atol=1e-8)
    sf = par.scale_factor(pm, uv)
    assert bool((sf > 0).all())
    assert _rel(sf, rpar.scale_factor(rm, jnp.asarray(uv_ref))) <= 1e-10
    assert _rel(par.conformal_distortion(pm, uv),
                rpar.conformal_distortion(rm, jnp.asarray(uv_ref))) <= 1e-10


@pytest.mark.parametrize("n,lifted", [(8, False), (10, True)])
def test_lscm_matches_reference(n, lifted):
    pm, rm = _surface(n, lifted)
    uv = par.lscm(pm, device="cpu")
    uv_ref = np.asarray(rpar.lscm(rm))
    assert _rel(uv, uv_ref) <= 1e-8
    dist = par.conformal_distortion(pm, uv)
    if lifted:
        assert _rel(dist, rpar.conformal_distortion(
            rm, jnp.asarray(uv_ref))) <= 1e-8
    else:
        # a planar mesh maps by a similarity: no conformal distortion.
        # Near 1 the distortion is the square root of a cancellation
        # (sigma_max^2 - sigma_min^2 ~ roundoff), so it is held to 1e-6
        # here, not against the reference's
        np.testing.assert_allclose(dist.numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,lifted", [(8, False), (10, True)])
def test_scp_fixed_iterations_matches_reference(n, lifted):
    """tol = 0: both LOBPCGs run exactly 12 iterations."""
    pm, rm = _surface(n, lifted)
    z, lam = par.scp(pm, tol=0.0, maxiter=12, device="cpu")
    z_ref, lam_ref = rpar.scp(rm, tol=0.0, maxiter=12)
    lam_ref = np.asarray(lam_ref)
    assert np.abs(lam - lam_ref).max() <= 1e-10 * np.abs(lam_ref).max()
    z_ref = np.asarray(z_ref)
    s = np.sign(float((z.numpy() * z_ref).sum()))
    assert _rel(s * z, z_ref) <= 1e-8
    # the translations are deflated: z is M-orthogonal to constants
    from meshfem_tpu_torch.ops import operators

    M = operators.mass(pm, device="cpu")
    Mz = M(z.contiguous())
    assert float(Mz.sum(dim=0).abs().max()) <= 1e-10 * float(Mz.abs().sum())


def test_harmonic_p2_as_the_reference_does_it():
    """A P2 mesh: only the boundary VERTICES are fixed on the circle; the
    boundary edge nodes stay free and end up off it, in both packages."""
    pm, rm = _surface(8, True, degree=2)
    uv = par.harmonic(pm, device="cpu").numpy()
    uv_ref = np.asarray(rpar.harmonic(rm))
    assert _rel(uv, uv_ref) <= 1e-8
    nv = pm.num_vertices
    bv = pm.cell.boundary_vertices()
    np.testing.assert_allclose(np.linalg.norm(uv[bv], axis=1), 1.0,
                               atol=1e-8)
    edge_nodes = pm.bdry_nodes[pm.bdry_nodes >= nv]
    off = np.abs(np.linalg.norm(uv[edge_nodes], axis=1) - 1.0).max()
    off_ref = np.abs(np.linalg.norm(uv_ref[edge_nodes], axis=1) - 1.0).max()
    assert off > 1e-3
    assert abs(off - off_ref) <= 1e-8
