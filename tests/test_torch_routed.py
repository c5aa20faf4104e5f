"""The port's RoutedEBE == meshfem_tpu's RoutedEBE on grid_tet(4,4,4) P2.

Dense and factored (``MESHFEM_FACTORED=1``, as the reference's own test
sets it) backends: internal ``order``/``rank`` exactly equal; apply and
diagonal to 5e-6 relative to ``max|y|`` (the reference's tolerance,
``tests/test_routed_factored.py:52``).  The reference runs its routing
kernels in interpret mode on the CPU; the port runs its kernels' plain
versions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators
from meshfem_tpu.physics import ElasticitySimulator as RSim, Material as RMat
from meshfem_tpu.sparse.routed_ebe import RoutedEBE as RRoutedEBE

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.physics import ElasticitySimulator, Material

TOL = 5e-6


@pytest.fixture(scope="module")
def problem():
    V, T = generators.grid_tet(4, 4, 4)
    rmesh = RFEMMesh(V, T, degree=2)
    rsim = RSim(rmesh, RMat.isotropic(3, 2.3, 0.31))
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 2.3, 0.31), device="cpu")
    u = np.random.default_rng(0).standard_normal(
        (sim.num_dofs, 3)).astype(np.float32)
    return rsim, sim, u


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _check(rk_ref, rk, u):
    np.testing.assert_array_equal(rk.order.numpy(), np.asarray(rk_ref.order))
    np.testing.assert_array_equal(rk.rank.numpy(), np.asarray(rk_ref.rank))
    y0 = rk_ref.permute_out(rk_ref(rk_ref.permute_in(jnp.asarray(u))))
    y1 = rk.permute_out(rk(rk.permute_in(torch.as_tensor(u))))
    assert _rel(y1.numpy(), y0) < TOL
    assert _rel(rk.permute_out(rk.diagonal()).numpy(),
                rk_ref.permute_out(rk_ref.diagonal())) < TOL
    # plane layout: apply_planes / diagonal_planes agree with __call__
    u_i = rk.permute_in(torch.as_tensor(u))
    yp = rk.apply_planes(u_i.t().contiguous()).t()
    assert _rel(yp.numpy(), rk(u_i).numpy()) < 1e-7
    assert _rel(rk.diagonal_planes().t().numpy(), rk.diagonal().numpy()) \
        < 1e-7


@pytest.mark.parametrize("factored", [False, True])
def test_routed_kernel_matches_reference(problem, factored, monkeypatch):
    rsim, sim, u = problem
    if factored:
        monkeypatch.setenv("MESHFEM_FACTORED", "1")
    else:
        monkeypatch.delenv("MESHFEM_FACTORED", raising=False)
    rsim._routed = None
    sim._routed = None
    rk_ref = rsim.routed_kernel()
    rk = sim.routed_kernel()
    assert (rk_ref.KeB is None) == factored
    assert (rk.KeP is None) == factored
    _check(rk_ref, rk, u)


@pytest.mark.parametrize("factored", [False, True])
def test_routed_from_arrays(problem, factored):
    """State carried across as numpy: the reference's Ke / geometry."""
    rsim, _, u = problem
    mesh = rsim.mesh
    coords = np.asarray(mesh.node_positions)
    arrays = dict(elem_dofs=np.asarray(rsim.elem_dofs),
                  num_dofs=rsim.num_dofs, vector_dim=3, coords=coords)
    if factored:
        from meshfem_tpu.fem.elasticity_tensor import lame_parameters

        lam, mu = lame_parameters(rsim.D)
        arrays.update(grad_lambda=np.asarray(rsim.geom.grad_lambda),
                      volume=np.asarray(rsim.geom.volume), lam=lam, mu=mu,
                      deg=2)
        rk_ref = RRoutedEBE.build(None, arrays["elem_dofs"], rsim.num_dofs,
                                  3, coords=coords,
                                  factor=(rsim.geom.grad_lambda,
                                          rsim.geom.volume, lam, mu, 2))
    else:
        arrays["Ke"] = np.asarray(rsim.Ke)
        rk_ref = RRoutedEBE.build(rsim.Ke, arrays["elem_dofs"],
                                  rsim.num_dofs, 3, coords=coords)
    rk = interop.routed_from_arrays(arrays, device="cpu")
    _check(rk_ref, rk, u)


def test_routed_without_coords_keeps_numbering(problem):
    rsim, sim, u = problem
    rk_ref = RRoutedEBE.build(rsim.Ke, np.asarray(rsim.elem_dofs),
                              rsim.num_dofs, 3)
    rk = interop.routed_from_arrays(
        dict(Ke=np.asarray(rsim.Ke), elem_dofs=np.asarray(rsim.elem_dofs),
             num_dofs=rsim.num_dofs, vector_dim=3), device="cpu")
    assert rk.order is None and rk_ref.order is None
    assert _rel(rk(torch.as_tensor(u)).numpy(), rk_ref(jnp.asarray(u))) < TOL


def test_apply_block_not_ported(problem):
    """Once a NotImplementedError; now ``apply_block`` and
    ``routed_kernel(block_rhs=...)`` are ported: the block apply equals the
    single-vector apply column by column (1e-6 of max|y|, the reference's
    own consistency check, ``tests/test_routed_factored.py:60-64``)."""
    _, sim, u = problem
    sim._routed = None
    rk = sim.routed_kernel(block_rhs=2)
    assert rk.bm == 2
    U = torch.as_tensor(np.stack([u, u[::-1].copy()], axis=-1))
    yb = rk.apply_block(U)
    yc = torch.stack([rk(U[..., j]) for j in range(2)], dim=-1)
    assert yb.shape == U.shape
    assert _rel(yb.numpy(), yc.numpy()) < 1e-6
    # a new count is recorded on the SAME operator (no plan depends on it)
    rk6 = sim.routed_kernel(block_rhs=6)
    assert rk6 is rk and rk6.bm == 6
    U5 = torch.as_tensor(np.stack([u * (j + 1) for j in range(5)], axis=-1))
    y5 = rk6.apply_block(U5)
    y1 = rk6(U5[..., 0])
    assert _rel(y5[..., 3].numpy(), 4 * y1.numpy()) < 1e-6


def test_dense_routed_Ke_assembled_by_element_stiffness(problem, monkeypatch):
    """A constant material's dense routed operator takes its float32 ``Ke``
    from ``kernels.element_stiffness`` (one call per build), and it equals
    the float64 ``Ke`` cast to float32 to 1e-6 of max|Ke|; a ``Ke`` shared
    from elsewhere, and a material field's, skip the assembly."""
    from meshfem_tpu_torch.physics import MaterialField
    from meshfem_tpu_torch.physics import elasticity as el

    _, sim, u = problem
    calls = []
    inner = el.element_stiffness

    def recording(gl, vol, D, deg):
        calls.append((gl.dtype, tuple(D.shape), deg))
        return inner(gl, vol, D, deg)

    monkeypatch.setattr(el, "element_stiffness", recording)
    monkeypatch.delenv("MESHFEM_FACTORED", raising=False)
    sim._routed = None
    rk = sim.routed_kernel()
    assert calls == [(torch.float32, (6, 6), 2)]
    E = sim.mesh.num_elements
    Ke32 = rk.KeP                     # node-major, as Ke
    # build() sorted the elements along its RCB order: compare as sets of
    # per-element norms and through the apply
    assert _rel(np.sort(Ke32.reshape(E, -1).norm(dim=1).numpy()),
                np.sort(sim.Ke.float().reshape(E, -1).norm(dim=1).numpy())) \
        < 1e-6
    y = rk.permute_out(rk(rk.permute_in(torch.as_tensor(u))))
    assert _rel(y.numpy(), sim.apply_K(torch.as_tensor(u).double()).numpy()) \
        < TOL

    shared = ElasticitySimulator(sim.mesh, sim.D, device="cpu", Ke=sim.Ke)
    shared.routed_kernel()
    young = np.full(E, 2.3)
    field = ElasticitySimulator(
        sim.mesh, MaterialField.isotropic_field(3, young, np.full(E, 0.31)),
        device="cpu")
    yf = field.routed_kernel()(torch.as_tensor(u))
    assert len(calls) == 1
    assert _rel(yf.numpy(), sim.routed_kernel()(torch.as_tensor(u)).numpy()) \
        < TOL
    sim._routed = None
