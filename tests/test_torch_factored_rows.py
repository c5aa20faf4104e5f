"""The factored routed backend in element-major node rows, against the
reference and against the component-planes composition it replaced.

On the CPU each wrapper runs its plain PyTorch version; the reference's
``RoutedEBE`` runs its factored contraction in its einsum form and its
routing kernels in interpret mode, as ``tests/test_torch_routed.py`` runs
it.  Tolerances:

* kernels C and D's plain versions in rows ``[E*n, d*m]`` (m = 1 and 3)
  equal the planes version column by column, bit for bit, for (dim, deg) =
  (3, 2), (3, 1), (2, 2), (2, 1);
* the factored ``apply_planes``, ``__call__`` and ``apply_block`` (C, and
  D under ``MESHFEM_FACTORED_TQ=1``) on ``grid_tet(3,3,3)`` P2 and
  ``grid_tri(4,4)`` P2 == the reference's factored ``RoutedEBE`` to 1e-5 of
  max|y| (float32 against the reference's float32 einsums), and == the
  planes composition (kernels A and B in planes, the contraction per column
  with its copies) bit for bit: the same contributions summed in the same
  order;
* through the wrappers' launch counters: every factored apply and a
  factored routed solve launch A and B in rows and never in planes, and a
  block apply launches its contraction once, in rows.

The ``cuda``-marked cases hold C and D in rows against their plain
versions (1e-5 of max|y|) and against themselves in planes (bit for bit),
and the factored applies against the planes composition (bit for bit), on
the card; kernel C's pipelined rows path also at the edges of its
persistent loop (E = 1, a partial last tile whose stretch is no whole
number of 16-byte units, more tiles than the card holds warps at once; m
= 1, 2, 3, 6, 7 and 33, the last on the direct path), two launches on the
same inputs equal bit for bit, and rows not 16-byte aligned (the direct
path) equal to aligned ones; they skip without one and need neither JAX nor the reference
package: ``python -m pytest --noconftest -m cuda
tests/test_torch_factored_rows.py``.
"""

import numpy as np
import pytest
import torch

from meshfem_tpu_torch import kernels
from meshfem_tpu_torch.kernels import gather as gather_mod
from meshfem_tpu_torch.kernels import segment_sum as seg_mod
from meshfem_tpu_torch.sparse import routed_ebe as re_mod
from meshfem_tpu_torch.sparse import scatter as sc_mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIGS = [(3, 2), (3, 1), (2, 2), (2, 1)]
CONTRACTIONS = {
    "C": (kernels.qp_contract, kernels.qp_contract_plain),
    "D": (kernels.factored_contract, kernels.factored_contract_plain)}
TQ = {"C": "0", "D": "1"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a, b = (np.asarray(torch.as_tensor(x).cpu()) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _contract_inputs(dim, deg, E, m, seed):
    """g [(d+1) d, E], vol [E] and rows [E*n, d*m], float32."""
    rng = np.random.default_rng(seed)
    n = dim + 1 if deg == 1 else (dim + 1) * (dim + 2) // 2
    g = rng.standard_normal(((dim + 1) * dim, E)).astype(np.float32)
    vol = (rng.random(E) + 0.5).astype(np.float32)
    rows = rng.standard_normal((E * n, dim * m)).astype(np.float32)
    return (torch.as_tensor(g), torch.as_tensor(vol), torch.as_tensor(rows),
            n)


def _columns(rows, E, n, d, m):
    """Rows [E*n, d*m] -> the m contiguous planes [d, n, E]."""
    u4 = rows.reshape(E, n, d, m)
    return [u4[..., j].permute(2, 1, 0).contiguous() for j in range(m)]


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("name", ["C", "D"])
@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_plain_rows_equal_planes_bitwise(dim, deg, name, m):
    wrapper, plain = CONTRACTIONS[name]
    g, vol, rows, n = _contract_inputs(dim, deg, 37, m, seed=dim * deg + m)
    fr = plain(g, vol, rows, 1.7, 0.9, rows=True)
    assert fr.shape == rows.shape and fr.dtype == torch.float32
    for fr_j, up in zip(_columns(fr, 37, n, dim, m),
                        _columns(rows, 37, n, dim, m)):
        assert torch.equal(fr_j, plain(g, vol, up, 1.7, 0.9))
    assert torch.equal(wrapper(g, vol, rows, 1.7, 0.9, rows=True), fr)


def test_rows_layout_rejects_bad_shapes():
    g, vol, rows, _ = _contract_inputs(3, 2, 5, 1, seed=0)
    with pytest.raises(ValueError, match="rows must be"):
        kernels.qp_contract_plain(g, vol, rows[:-1], 1.0, 1.0, rows=True)
    with pytest.raises(ValueError, match="planes must be"):
        kernels.factored_contract_plain(g, vol, rows, 1.0, 1.0)


# ---------------------------------------------------------------------------
# The factored applies
# ---------------------------------------------------------------------------

def _planes_composition(op, contract):
    """The factored applies as they ran before the move to node rows:
    kernels A and B in planes over the slot-major ``ids`` and ``plan``, the
    contraction per column on contiguous planes."""
    d, n, E, N = (op.vector_dim, op.nodes_per_elem, op.num_elements,
                  op.num_dofs)

    def planes(src):                                   # [d, N] -> [d, N]
        ue = kernels.gather_planes(src.contiguous(), op.ids)
        fe = contract(op.g, op.vol, ue.reshape(d, n, E).contiguous(),
                      op.lam, op.mu)
        return op.plan.sum_planes(fe.reshape(d, n * E))

    def block(U):                                      # [N, d, m]
        m = U.shape[-1]
        src = U.permute(1, 2, 0).reshape(d * m, N).contiguous()
        ue = kernels.gather_planes(src, op.ids).reshape(d, m, n, E)
        fe = torch.stack([contract(op.g, op.vol, ue[:, j].reshape(d, n, E)
                                   .contiguous(), op.lam, op.mu)
                          for j in range(m)], dim=1)
        y = op.plan.sum_planes(fe.reshape(d * m, n * E))
        return y.reshape(d, m, N).permute(2, 0, 1)

    return planes, block


def _mesh(dim):
    from meshfem_tpu_torch.mesh import generators

    return (generators.grid_tet(3, 3, 3) if dim == 3
            else generators.grid_tri(4, 4))


@pytest.fixture(scope="module", params=[3, 2], ids=["tet", "tri"])
def factored(request):
    """The port's factored operator (CPU) and the reference's, built from
    the same float64 geometry, with seeded inputs."""
    import meshfem_tpu.mesh as rmesh_mod
    from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                     Material as RMat)
    from meshfem_tpu.fem.elasticity_tensor import lame_parameters
    from meshfem_tpu.sparse.routed_ebe import RoutedEBE as RRoutedEBE
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    dim = request.param
    V, T = _mesh(dim)
    rsim = RSim(rmesh_mod.FEMMesh(V, T, degree=2),
                RMat.isotropic(dim, 2.3, 0.31))
    lam, mu = lame_parameters(rsim.D)
    gl = np.array(rsim.geom.grad_lambda)
    vol = np.array(rsim.geom.volume)
    elem = np.asarray(rsim.elem_dofs)
    coords = np.asarray(rsim.mesh.node_positions)
    N = rsim.num_dofs
    rk_ref = RRoutedEBE.build(None, elem, N, dim, coords=coords,
                              factor=(rsim.geom.grad_lambda,
                                      rsim.geom.volume, lam, mu, 2))
    rk = RoutedEBE.build(None, elem, N, dim, coords=coords,
                         factor=(gl, vol, lam, mu, 2), device="cpu")
    rng = np.random.default_rng(dim)
    u = rng.standard_normal((N, dim)).astype(np.float32)
    U = rng.standard_normal((N, dim, 2 * dim)).astype(np.float32)
    return dict(dim=dim, rk_ref=rk_ref, rk=rk, u=u, U=U)


@pytest.mark.parametrize("name", ["C", "D"])
def test_factored_applies_match_reference(factored, name, monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("MESHFEM_FACTORED_TQ", TQ[name])
    rk_ref, rk, u, U = (factored[k] for k in ("rk_ref", "rk", "u", "U"))
    np.testing.assert_array_equal(rk.order.numpy(), np.asarray(rk_ref.order))
    u_i = rk.permute_in(torch.as_tensor(u))
    y = rk(u_i)
    y_ref = rk_ref(rk_ref.permute_in(jnp.asarray(u)))
    assert y.dtype == torch.float32 and _rel(y, np.asarray(y_ref)) < 1e-5
    yp = rk.apply_planes(u_i.t().contiguous())
    assert _rel(yp.t(), np.asarray(y_ref)) < 1e-5
    U_i = rk.permute_in(torch.as_tensor(U))
    yb = rk.apply_block(U_i)
    yb_ref = rk_ref.apply_block(rk_ref.permute_in(jnp.asarray(U)))
    assert yb.shape == U_i.shape and _rel(yb, np.asarray(yb_ref)) < 1e-5
    assert _rel(rk.diagonal_planes(),
                np.asarray(rk_ref.diagonal_planes())) < 1e-5


@pytest.mark.parametrize("name", ["C", "D"])
def test_factored_applies_equal_planes_composition(factored, name,
                                                   monkeypatch):
    monkeypatch.setenv("MESHFEM_FACTORED_TQ", TQ[name])
    rk = factored["rk"]
    planes, block = _planes_composition(rk, CONTRACTIONS[name][0])
    src = torch.as_tensor(factored["u"]).t().contiguous()
    assert torch.equal(rk.apply_planes(src), planes(src))
    assert torch.equal(rk(src.t().contiguous()), planes(src).t())
    U = torch.as_tensor(factored["U"])
    assert torch.equal(rk.apply_block(U), block(U))
    # the diagonal: the same element diagonal through either plan
    d, n, E = rk.vector_dim, rk.nodes_per_elem, rk.num_elements
    de = torch.randn(d, n, E)
    assert torch.equal(
        rk.plan_em.sum_rows(de.permute(2, 1, 0).reshape(E * n, d),
                            planes_out=True),
        rk.plan.sum_planes(de.reshape(d, n * E)))


def _count_launches(monkeypatch):
    """Make the CPU path count launches as the card's does: each wrapper
    that the routed operator and the scatter plan call counts one launch
    (C and D also in ``launches_rows``), and the planes kernels' plain
    versions, which any route to kernels A and B in planes ends in, count
    one each."""
    kernels.reset_launch_counts()

    def counting(mod, name, wrapper):
        inner = getattr(mod, name)

        def counted(*args, **kw):
            wrapper.launches += 1
            if kw.get("rows"):
                wrapper.launches_rows += 1
            return inner(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    for name in ("gather_rows", "qp_contract", "factored_contract"):
        counting(re_mod, name, getattr(kernels, name))
    for name in ("segment_sum_rows", "segment_sum_csr"):
        counting(sc_mod, name, getattr(kernels, name))
    counting(gather_mod, "gather_planes_plain", kernels.gather_planes)
    counting(seg_mod, "segment_sum_csr_plain", kernels.segment_sum_csr)


def _counts():
    return {w.__name__: (w.launches, getattr(w, "launches_rows", None))
            for w in kernels.WRAPPERS}


@pytest.mark.parametrize("name", ["C", "D"])
def test_factored_applies_launch_rows_kernels(factored, name, monkeypatch):
    monkeypatch.setenv("MESHFEM_FACTORED_TQ", TQ[name])
    _count_launches(monkeypatch)
    rk = factored["rk"]
    wrapper = CONTRACTIONS[name][0].__name__
    other = "qp_contract" if name == "D" else "factored_contract"
    src = torch.as_tensor(factored["u"])
    for apply, x in ((rk.apply_planes, src.t().contiguous()), (rk, src),
                     (rk.apply_block, torch.as_tensor(factored["U"]))):
        kernels.reset_launch_counts()
        apply(x)
        c = _counts()
        assert c["gather_rows"][0] == 1 and c["segment_sum_rows"][0] == 1
        assert c[wrapper] == (1, 1) and c[other] == (0, 0)
        assert c["gather_planes"][0] == 0 and c["segment_sum_csr"][0] == 0
    kernels.reset_launch_counts()


@pytest.mark.parametrize("name", ["C", "D"])
def test_factored_solve_launches_rows_kernels(name, monkeypatch):
    """A factored routed solve (``MESHFEM_FACTORED=1``): one gather in
    rows and one contraction in rows an apply, no kernel in planes."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    monkeypatch.setenv("MESHFEM_FACTORED", "1")
    monkeypatch.setenv("MESHFEM_FACTORED_TQ", TQ[name])
    V, T = generators.grid_tet(3, 3, 3)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 2.3, 0.31), device="cpu")
    X = sim.mesh.node_positions
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((sim.mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    sim.neumann_load = torch.as_tensor(load)
    _count_launches(monkeypatch)
    applies = []
    inner = re_mod.RoutedEBE.apply_planes
    monkeypatch.setattr(re_mod.RoutedEBE, "apply_planes",
                        lambda op, src: applies.append(1) or inner(op, src))
    u, res = sim.solve(operator="routed", tol=1e-10)
    c = _counts()
    wrapper = CONTRACTIONS[name][0].__name__
    assert sim.routed_kernel().KeP is None and res.resnorm <= 1e-10
    assert len(applies) > 0 and c["gather_rows"][0] == len(applies)
    assert c[wrapper] == (len(applies), len(applies))
    assert c["segment_sum_rows"][0] >= len(applies)
    assert c["gather_planes"][0] == 0 and c["segment_sum_csr"][0] == 0
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

RAGGED = [1, 333, 4099]         # 333 and 4099: no multiple of a block


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 6])
@pytest.mark.parametrize("E", RAGGED)
@pytest.mark.parametrize("name", ["C", "D"])
@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_cuda_rows_match_plain_and_planes(cuda, dim, deg, name, E, m):
    """C and D in rows: one launch for all m columns, against the plain
    version (1e-5 of max|y|) and the kernel in planes column by column
    (bit for bit)."""
    wrapper, plain = CONTRACTIONS[name]
    g, vol, rows, n = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                       for t in _contract_inputs(dim, deg, E, m, seed=E + m))
    n0, r0 = wrapper.launches, wrapper.launches_rows
    fr = wrapper(g, vol, rows, 1.7, 0.9, rows=True)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_rows) == (n0 + 1, r0 + 1)
    assert _rel(fr, plain(g, vol, rows, 1.7, 0.9, rows=True)) < 1e-5
    for fr_j, up in zip(_columns(fr, E, n, dim, m),
                        _columns(rows, E, n, dim, m)):
        assert torch.equal(fr_j, wrapper(g, vol, up, 1.7, 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 6, 7, 33])
@pytest.mark.parametrize("E", [1, 333, 100_003])
@pytest.mark.parametrize("dim,deg", CONFIGS)
def test_cuda_qp_rows_pipeline_edges(cuda, dim, deg, E, m):
    """Kernel C in rows at the edges of its persistent loop: E = 1 (one
    partial tile), 333 (at d = 2, P1, m = 1 the last tile's 13 elements
    are 312 bytes, no whole number of 16-byte units) and 100,003 (more
    tiles than the card's resident warps, so each walks several); m = 33
    takes the direct path.  Two launches give the same bits; against the
    plain version (1e-5 of max|y|) and the kernel in planes column by
    column (bit for bit)."""
    g, vol, rows, n = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                       for t in _contract_inputs(dim, deg, E, m,
                                                 seed=E + 7 * m))
    f1 = kernels.qp_contract(g, vol, rows, 1.7, 0.9, rows=True)
    f2 = kernels.qp_contract(g, vol, rows, 1.7, 0.9, rows=True)
    torch.cuda.synchronize()
    assert torch.equal(f1, f2)
    assert _rel(f1, kernels.qp_contract_plain(g, vol, rows, 1.7, 0.9,
                                              rows=True)) < 1e-5
    for fr_j, up in zip(_columns(f1, E, n, dim, m),
                        _columns(rows, E, n, dim, m)):
        assert torch.equal(fr_j, kernels.qp_contract(g, vol, up, 1.7, 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6])
def test_cuda_qp_rows_unaligned_equal_aligned(cuda, m):
    """Rows that start off a 16-byte boundary cannot be copied in bulk and
    take the direct path: the same bits as the pipelined path."""
    g, vol, rows, n = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                       for t in _contract_inputs(3, 2, 4099, m, seed=m))
    buf = torch.empty(rows.numel() + 1, device=cuda)
    shifted = buf[1:].view(rows.shape)
    shifted.copy_(rows)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(
        kernels.qp_contract(g, vol, shifted, 1.7, 0.9, rows=True),
        kernels.qp_contract(g, vol, rows, 1.7, 0.9, rows=True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["C", "D"])
@pytest.mark.parametrize("dim", [3, 2])
def test_cuda_factored_applies_equal_planes_composition(cuda, dim, name,
                                                        monkeypatch):
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    monkeypatch.setenv("MESHFEM_FACTORED_TQ", TQ[name])
    V, T = _mesh(dim)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(dim, 2.3, 0.31),
                              device=cuda)
    lam, mu = et.lame_parameters(sim.D)
    rk = RoutedEBE.build(None, sim.mesh.elem_nodes, sim.num_dofs, dim,
                         coords=sim.mesh.node_positions,
                         factor=(sim.geom.grad_lambda, sim.geom.volume, lam,
                                 mu, 2), device=cuda)
    planes, block = _planes_composition(rk, CONTRACTIONS[name][0])
    gen = torch.Generator(device=cuda).manual_seed(dim)
    src = torch.randn((dim, sim.num_dofs), generator=gen, device=cuda)
    assert torch.equal(rk.apply_planes(src), planes(src))
    U = torch.randn((sim.num_dofs, dim, 2 * dim), generator=gen, device=cuda)
    assert torch.equal(rk.apply_block(U), block(U))


def test_reset_clears_rows_launches():
    kernels.qp_contract.launches_rows = 3
    kernels.factored_contract.launches_rows = 2
    kernels.reset_launch_counts()
    assert kernels.qp_contract.launches_rows == 0
    assert kernels.factored_contract.launches_rows == 0
