"""Deformed configurations (``ElasticitySimulator(node_positions=...)``),
deformed-cell homogenization, the homogenized tensor's shape gradient and
the Homogenize and DeformedCells CLIs of ``meshfem_tpu_torch`` against
``meshfem_tpu`` on the CPU.

It also holds the two places where the reference reads the mesh's stored
positions for a simulator built at other positions, which the port does
not copy: the structured-path dispatch (a deformed Kuhn grid passes the
reference's pre-filter and validation, and its structured multigrid is
built from the undeformed mesh) and ``rigid_modes`` (rotations about the
stored positions are not the null space of the deformed ``K``).
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu.analysis import deformed_cells as rdc
from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.fem import elasticity_tensor as ret
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.ops.structured import validate_kuhn_grid as r_validate
from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                 Material as RMaterial)
from meshfem_tpu.physics.materials import MaterialField as RMaterialField

from meshfem_tpu_torch.analysis import deformed_cells as dc
from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.physics.materials import MaterialField


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


def _perturbed(n, seed=0, amp=0.15):
    """grid_tet(n) with its interior vertices moved by up to ``amp`` of a
    cell, seeded: (V, T, the perturbed P2 node positions)."""
    V, T = generators.grid_tet(n, n, n)
    rng = np.random.default_rng(seed)
    inner = np.all((V > 1e-9) & (V < 1 - 1e-9), axis=1)
    Vp = V.copy()
    Vp[inner] += amp / n * rng.uniform(-1.0, 1.0, (int(inner.sum()), 3))
    return V, T, FEMMesh(Vp, T, degree=2).node_positions


def _clamp_and_load(sim, X, load_scale=-0.01, jnp_load=False):
    sim.dirichlet_mask[X[:, 0] < 1e-9] = True
    load = np.zeros((len(X), 3))
    load[X[:, 0] > 1 - 1e-9, 1] = load_scale
    sim.neumann_load = jnp.asarray(load) if jnp_load else torch.as_tensor(load)


@pytest.fixture(scope="module")
def deformed3():
    """A clamped grid_tet(3) P2 simulator built at perturbed positions, in
    both packages."""
    V, T, Xp = _perturbed(3)
    rsim = RSim(RFEMMesh(V, T, degree=2), RMaterial.isotropic(3, 200.0, 0.3),
                node_positions=jnp.asarray(Xp))
    psim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                               Material.isotropic(3, 200.0, 0.3),
                               device="cpu", node_positions=Xp)
    X = psim.mesh.node_positions
    _clamp_and_load(rsim, X, jnp_load=True)
    _clamp_and_load(psim, X)
    return rsim, psim, Xp


def test_node_positions_keyword_only(deformed3):
    _, psim, Xp = deformed3
    with pytest.raises(TypeError):
        ElasticitySimulator(psim.mesh, Material.isotropic(3, 1.0, 0.3),
                            "cpu", None, None, Xp)
    # a tensor sets the device when none is given
    sim = ElasticitySimulator(psim.mesh, Material.isotropic(3, 1.0, 0.3),
                              node_positions=torch.as_tensor(Xp))
    assert sim.device.type == "cpu" and sim.deformed


def test_node_positions_matches_reference(deformed3):
    """Ke, the fields of a seeded u and a clamped solve at the perturbed
    positions, to 1e-12."""
    rsim, psim, _ = deformed3
    assert _rel(psim.Ke.numpy(), rsim.Ke) <= 1e-12
    assert _rel(psim.geom.volume.numpy(), rsim.geom.volume) <= 1e-12
    assert _rel(psim.geom.bdry_normal.numpy(), rsim.geom.bdry_normal) \
        <= 1e-12
    u = np.random.default_rng(1).standard_normal((psim.num_dofs, 3))
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    for name in ("average_strain_field", "average_stress_field",
                 "von_mises_field", "strain_at", "stress_at"):
        assert _rel(getattr(psim, name)(ut).numpy(),
                    getattr(rsim, name)(uj)) <= 1e-12, name
    assert abs(float(psim.strain_energy(ut)) - float(rsim.strain_energy(uj))) \
        <= 1e-12 * abs(float(rsim.strain_energy(uj)))
    e0 = np.array([1.0, -0.5, 0.25, 0.1, 0.2, 0.3])
    assert _rel(psim.constant_strain_load(e0).numpy(),
                rsim.constant_strain_load(jnp.asarray(e0))) <= 1e-12
    up, _ = psim.solve(tol=1e-13, operator="ebe")
    ur, _ = rsim.solve(tol=1e-13, operator="ebe")
    assert _rel(up.numpy(), ur) <= 1e-12
    # the routed operator's dense Ke (kernel E's float32 product on the
    # card, the float64 one cast here) follows the deformed geometry
    rk = psim.routed_kernel()
    y = rk.permute_out(rk(rk.permute_in(
        torch.as_tensor(u, dtype=torch.float32))))
    assert _rel(y.numpy(), rsim.apply_K(uj)) <= 1e-5


def test_rigid_modes_follow_node_positions(deformed3):
    """Step 0, the rigid modes: the reference's rotations sit at the
    stored positions, so ``K Z`` is far from 0 at the perturbed ones; the
    port's are the null space of its ``K`` there.  A free body under
    ``no_rigid_motion`` then solves to a float64 saddle-point solve at the
    perturbed positions (1e-10), where the reference's projected solve
    does not."""
    rsim, psim, Xp = deformed3
    K = rsim.to_scipy().toarray()               # the reference's K, perturbed
    Zr, Zp = rsim.rigid_modes(), psim.rigid_modes()
    scale = np.abs(K).max()
    res_r = np.abs(K @ Zr).max() / (scale * np.abs(Zr).max())
    res_p = np.abs(K @ Zp).max() / (scale * np.abs(Zp).max())
    assert res_r > 1e-3 and res_p < 1e-13
    # free body: a seeded load, the float64 saddle-point solve with the
    # true rigid modes as constraints
    fb_r = RSim(rsim.mesh, RMaterial.isotropic(3, 200.0, 0.3),
                node_positions=jnp.asarray(Xp))
    fb_p = ElasticitySimulator(psim.mesh, Material.isotropic(3, 200.0, 0.3),
                               device="cpu", node_positions=Xp)
    b = np.random.default_rng(2).standard_normal((psim.num_dofs, 3))
    Q, _ = np.linalg.qr(Zp)
    b_eq = b.reshape(-1) - Q @ (Q.T @ b.reshape(-1))
    nz = Q.shape[1]
    Ksad = np.block([[K, Q], [Q.T, np.zeros((nz, nz))]])
    u_true = np.linalg.solve(Ksad, np.concatenate([b_eq, np.zeros(nz)])
                             )[:-nz].reshape(-1, 3)
    for s, load in ((fb_r, jnp.asarray(b)), (fb_p, torch.as_tensor(b))):
        s.no_rigid_motion = True
        s.neumann_load = load
    up, _ = fb_p.solve(tol=1e-13, operator="ebe", maxiter=5000)
    ur, _ = fb_r.solve(tol=1e-13, operator="ebe", maxiter=5000)
    assert _rel(up.numpy(), u_true) <= 1e-10
    assert _rel(np.asarray(ur), u_true) > 1e-4


def test_structured_path_needs_stored_positions():
    """Step 0, the structured path: a clamped grid_tet(8) P2 Kuhn grid
    (3,072 tets) built at perturbed positions passes the reference's
    pre-filter and Kuhn-grid validation, so the reference's default solve
    takes the structured multigrid, which is built from the undeformed
    mesh and solves the undeformed problem.  The port's simulator is not
    eligible, ``operator="structured"`` raises, and the default call
    solves the deformed problem: relative residual <= 1e-10 through the
    reference's float64 EBE operator at the perturbed positions, and far
    from a solution of the undeformed system."""
    V, T, Xp = _perturbed(8)
    rsim = RSim(RFEMMesh(V, T, degree=2), RMaterial.isotropic(3, 200.0, 0.3),
                node_positions=jnp.asarray(Xp))
    X = np.asarray(rsim.mesh.node_positions)
    _clamp_and_load(rsim, X, jnp_load=True)
    assert rsim._structured_eligible()
    r_validate(rsim.mesh)                        # passes: the stored grid
    mesh = FEMMesh(V, T, degree=2)
    psim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                               device="cpu", node_positions=Xp)
    _clamp_and_load(psim, X)
    assert not psim._structured_eligible()
    with pytest.raises(ValueError, match="own node positions"):
        psim.solve(operator="structured")
    u, _ = psim.solve(tol=1e-12)
    free = ~rsim.dirichlet_mask
    b = np.asarray(rsim.neumann_load) * free
    r = (b - np.asarray(rsim.apply_K(jnp.asarray(u.numpy())))) * free
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b)
    # what the reference's structured path solves is the undeformed
    # problem, which the deformed solution is far from solving
    flat = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                               device="cpu")
    _clamp_and_load(flat, X)
    assert flat._structured_eligible()
    free_t = torch.as_tensor(free, dtype=torch.float64)
    r_flat = (flat.neumann_load - flat.apply_K(u)) * free_t
    assert float(torch.linalg.norm(r_flat)) > 1e-3 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# Deformed cells on the reference's 2D hole cell
# ---------------------------------------------------------------------------

def _hole(n=8):
    V, F = rgen.grid_tri(n, n)
    c = V[F].mean(axis=1)
    keep = ~((c[:, 0] > 0.375) & (c[:, 0] < 0.625)
             & (c[:, 1] > 0.375) & (c[:, 1] < 0.625))
    F2 = F[keep]
    used = np.unique(F2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[F2].astype(np.int32)


@pytest.fixture(scope="module")
def hole():
    V, F = _hole(8)
    return (RFEMMesh(V, F, degree=1), FEMMesh(V, F, degree=1),
            RMaterial.isotropic(2, 5.0, 0.3), Material.isotropic(2, 5.0, 0.3))


_TH = np.pi / 2
JACOBIANS = {
    "identity": (np.eye(2), False),
    "rotation": (np.array([[np.cos(_TH), -np.sin(_TH)],
                           [np.sin(_TH), np.cos(_TH)]]), False),
    "shear": (np.array([[1.0, 0.35], [0.0, 1.2]]), False),
    "transform_version": (np.array([[1.0, 0.3], [0.1, 1.1]]), True),
}


@pytest.mark.parametrize("kind", list(JACOBIANS))
def test_homogenize_deformed_matches_reference(hole, kind):
    rmesh, pmesh, rmat, pmat = hole
    J, tv = JACOBIANS[kind]
    r = rdc.homogenize_deformed(rmesh, rmat, J, transform_version=tv,
                                tol=1e-12)
    p = dc.homogenize_deformed(pmesh, pmat, J, transform_version=tv,
                               tol=1e-12, device="cpu")
    assert np.abs(p.Ch.numpy() - np.asarray(r.Ch)).max() <= 1e-9
    assert _rel(p.w.numpy(), r.w) <= 1e-8
    if kind == "rotation":
        # rotating the cell rotates the effective tensor
        plain = hom.homogenize(pmesh, pmat, tol=1e-12, device="cpu")
        expect = ret.transform(jnp.asarray(plain.Ch.numpy()), jnp.asarray(J))
        assert np.abs(p.Ch.numpy() - np.asarray(expect)).max() <= 1e-7


def test_sheared_homogeneous_cell_gives_D():
    """w = 0 solves the cell problems of a homogeneous cell under any
    jacobian: the matching on the ORIGINAL cell and the |det F| volume."""
    V, F = generators.grid_tri(6, 6)
    mat = Material.isotropic(2, 5.0, 0.3)
    r = dc.homogenize_deformed(FEMMesh(V, F, degree=1), mat,
                               np.array([[1.0, 0.35], [0.0, 1.2]]),
                               tol=1e-12, device="cpu")
    assert np.allclose(r.Ch.numpy(), mat.D.numpy(), rtol=1e-8, atol=1e-8)


@pytest.fixture(scope="module")
def hole_w(hole):
    """The hole cell's fluctuations from the reference's solve, and both
    packages' periodic simulators."""
    rmesh, pmesh, rmat, pmat = hole
    rsim = rhom.periodic_simulator(rmesh, rmat)
    w, _ = rhom.solve_cell_problems(rsim, tol=1e-13)
    psim = hom.periodic_simulator(pmesh, pmat, device="cpu")
    return rsim, np.asarray(w), psim


def test_shape_gradient_matches_jax_grad(hole_w):
    """``torch.autograd`` through the energy form against the reference's
    ``jax.grad`` on the same frozen w (1e-10 of max), and the energy form
    against the stress form (1e-8)."""
    rsim, w, psim = hole_w
    w = np.array(w)
    W = np.zeros((3, 3))
    W[0, 0], W[0, 1], W[1, 0], W[2, 2] = 1.0, 0.5, 0.5, -0.25
    g_ref = np.asarray(rdc.homogenized_tensor_shape_gradient(rsim, w, W))
    g = dc.homogenized_tensor_shape_gradient(psim, torch.as_tensor(w), W)
    assert g.shape == g_ref.shape and _rel(g.numpy(), g_ref) <= 1e-10
    Eh = dc.homogenized_tensor_at(psim, torch.as_tensor(w))
    Ch_stress = hom.homogenized_tensor_stress_form(
        psim, torch.as_tensor(w), base_cell_volume=1.0)
    assert np.abs(Eh.numpy() - Ch_stress.numpy()).max() <= 1e-8


def _void_tet(n=4, r=0.3):
    """grid_tet(n) without the tets whose centroid lies within ``r`` of the
    centre, vertices renumbered."""
    V, T = generators.grid_tet(n, n, n)
    T = T[((V[T].mean(axis=1) - 0.5) ** 2).sum(axis=1) > r ** 2]
    used = np.unique(T)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[T]


def _perturbed_slot(n=8, a=0.2, b=0.42, tilt=0.35, seed=0):
    """grid_tri(n) without a tilted elliptical slot about the centre, its
    interior vertices moved by up to an eighth of a cell, seeded."""
    V, F = generators.grid_tri(n, n)
    c = V[F].mean(axis=1) - 0.5
    x = np.cos(tilt) * c[:, 0] + np.sin(tilt) * c[:, 1]
    y = -np.sin(tilt) * c[:, 0] + np.cos(tilt) * c[:, 1]
    F = F[(x / a) ** 2 + (y / b) ** 2 > 1]
    used = np.unique(F)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    V, F = V[used].copy(), remap[F]
    inner = np.all((V > 1e-9) & (V < 1 - 1e-9), axis=1)
    rng = np.random.default_rng(seed)
    V[inner] += 0.25 / n * (rng.random((int(inner.sum()), 2)) - 0.5)
    return V, F


def _young_field(num_elements, seed=7):
    """Per-element Young's moduli in [1, 9), seeded; Poisson 0.3."""
    young = 1.0 + 8.0 * np.random.default_rng(seed).random(num_elements)
    return young, np.full(num_elements, 0.3)


def _cell(V, F, dim, degree, field):
    """Both packages' periodic simulators on one cell (an isotropic
    material, or a seeded per-element one) and the port's fluctuations
    solved to 1e-13."""
    if field:
        young, nu = _young_field(len(F))
        pmat = MaterialField.isotropic_field(dim, torch.as_tensor(young),
                                             torch.as_tensor(nu))
        rmat = RMaterialField.isotropic_field(dim, young, nu)
    else:
        pmat = Material.isotropic(dim, 5.0, 0.3)
        rmat = RMaterial.isotropic(dim, 5.0, 0.3)
    psim = hom.periodic_simulator(FEMMesh(V, F, degree=degree), pmat,
                                  device="cpu")
    rsim = rhom.periodic_simulator(RFEMMesh(V, F, degree=degree), rmat)
    w, _ = hom.solve_cell_problems(psim, tol=1e-13)
    return psim, rsim, w - w.mean(dim=1, keepdim=True)


@pytest.fixture(scope="module",
                params=["tet4_void", "tri8_slot", "tri8_slot_field"])
def p2_cell(request):
    """A P2 periodic cell, both packages' simulators and the port's
    fluctuations solved to 1e-13 (``_field``: a per-element material)."""
    if request.param == "tet4_void":
        (V, F), dim = _void_tet(), 3
    else:
        (V, F), dim = _perturbed_slot(), 2
    return _cell(V, F, dim, 2, request.param.endswith("_field"))


def test_p2_energy_form_is_the_stress_form(p2_cell):
    """On P2 cells the energy form integrates the P2 strains exactly: the
    port's ``homogenized_tensor_at`` is the stress-form tensor (1e-10
    relative), where the reference's centroid-strain form misses it by
    more than 1e-3; the shape gradient is the central difference of the
    port's form, w frozen, along two seeded directions (1e-6)."""
    psim, rsim, w = p2_cell
    Ch = hom.homogenized_tensor_stress_form(psim, w, base_cell_volume=1.0)
    Eh = dc.homogenized_tensor_at(psim, w)
    assert _rel(Eh.numpy(), Ch.numpy()) <= 1e-10
    Eh_ref = rdc.homogenized_tensor_at(rsim, jnp.asarray(w.numpy()))
    assert _rel(np.asarray(Eh_ref), Ch.numpy()) > 1e-3

    fl = w.shape[0]
    W = np.random.default_rng(3).standard_normal((fl, fl))
    g = dc.homogenized_tensor_shape_gradient(psim, w, W)
    X0 = torch.as_tensor(psim.mesh.node_positions)
    assert g.shape == X0.shape
    assert not g[psim.mesh.num_vertices:].any()   # edge-node rows

    def J(X):
        return float((torch.as_tensor(W) * dc.homogenized_tensor_at(
            psim, w, X)).sum())

    rng = np.random.default_rng(4)
    h = 1e-6
    for _ in range(2):
        d = torch.as_tensor(rng.standard_normal(tuple(X0.shape)))
        fd = (J(X0 + h * d) - J(X0 - h * d)) / (2 * h)
        ad = float((g * d).sum())
        assert abs(fd - ad) <= 1e-6 * abs(ad)


def test_p1_energy_form_with_a_per_element_material():
    """A per-element material on the P1 slot cell: the energy form is the
    stress-form tensor (1e-10 relative) and, P1 strains being constant,
    the reference's centroid-strain form too."""
    psim, rsim, w = _cell(*_perturbed_slot(), 2, 1, field=True)
    assert psim.D.dim() == 3
    Ch = hom.homogenized_tensor_stress_form(psim, w, base_cell_volume=1.0)
    Eh = dc.homogenized_tensor_at(psim, w)
    assert _rel(Eh.numpy(), Ch.numpy()) <= 1e-10
    Eh_ref = rdc.homogenized_tensor_at(rsim, jnp.asarray(w.numpy()))
    assert _rel(Eh.numpy(), np.asarray(Eh_ref)) <= 1e-10


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _numbers(text):
    """Every printed line: (its words, its numbers); CG iteration counts
    are left out (they may differ by a summation order)."""
    out = []
    for line in text.splitlines():
        if line.startswith(("CG iterations", "wrote")):
            continue
        words, nums = [], []
        for tok in line.replace("=", " = ").split():
            try:
                nums.append(float(tok))
            except ValueError:
                words.append(tok)
        out.append((words, nums))
    return out


def _same_report(got, ref, rel):
    a, b = _numbers(got), _numbers(ref)
    assert [w for w, _ in a] == [w for w, _ in b] and len(a) > 2
    for (_, x), (_, y) in zip(a, b):
        assert len(x) == len(y)
        if x:
            assert np.abs(np.subtract(x, y)).max() \
                <= rel * max(np.abs(y).max(), 1.0)


@pytest.fixture(scope="module")
def cli_cell(tmp_path_factory):
    from meshfem_tpu_torch.io import meshio

    d = tmp_path_factory.mktemp("deformed_cli")
    V, F = _hole(8)
    meshio.save_msh(d / "cell.msh", V, F)
    (d / "mat.material").write_text(
        '{"type": "isotropic_material", "dim": 2, "young": 5.0, '
        '"poisson": 0.3}')
    return d


def test_homogenize_cli_matches_reference(cli_cell, capsys):
    from meshfem_tpu.cli import homogenize as rcli
    from meshfem_tpu_torch.cli import homogenize as tcli

    d = cli_cell
    args = [str(d / "cell.msh"), "-m", str(d / "mat.material"), "-d", "1"]
    rcli.main(args + ["-o", str(d / "r.msh")])
    ref = capsys.readouterr().out
    tcli.main(args + ["-o", str(d / "t.msh"), "--device", "cpu"])
    got = capsys.readouterr().out
    _same_report(got, ref, 1e-6)
    from meshfem_tpu.io import msh_fields as rfields

    fr, ft = rfields.read_fields(d / "r.msh"), rfields.read_fields(d / "t.msh")
    assert set(fr) == set(ft) and len(ft) == 6
    assert _rel(rfields.vector_field(ft, "w_0", 2),
                rfields.vector_field(fr, "w_0", 2)) <= 1e-7


def test_deformed_cells_cli_matches_reference(cli_cell, capsys,
                                              monkeypatch):
    from meshfem_tpu.cli import deformed_cells as rcli
    from meshfem_tpu_torch.cli import deformed_cells as tcli

    d = cli_cell
    args = [str(d / "cell.msh"), "-m", str(d / "mat.material"), "-d", "1"]
    rcli.main(args + ["--jacobian", "1", "0.2", "0", "1"])
    tcli.main(args + ["--jacobian", "1", "0.2", "0", "1", "--device", "cpu"])
    monkeypatch.setattr(sys, "stdin", io.StringIO("1 0 0 1\n1 0.1 0 1\n"))
    rcli.main(args + ["--parametrizedTransform"])
    monkeypatch.setattr(sys, "stdin", io.StringIO("1 0 0 1\n1 0.1 0 1\n"))
    tcli.main(args + ["--parametrizedTransform", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 12
    ref = "\n".join(lines[0:2] + lines[4:8])
    got = "\n".join(lines[2:4] + lines[8:12])
    _same_report(got, ref, 1e-7)
