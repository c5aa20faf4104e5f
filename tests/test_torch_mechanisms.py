"""Linkage mechanisms (``analysis/mechanisms.py``, ``cli/mechanisms.py``,
``FEMMesh.node_positions_from_vertices``) of ``meshfem_tpu_torch`` against
``meshfem_tpu`` on the CPU.

The cell is grid_tri(8) P2 with a tilted elliptical void and its other
vertices moved by a seeded quarter cell, as ``tests/test_mechanisms.py``
moves them (one mesh shape for everything compared with the reference, so
the reference compiles once).  ``tests/test_mechanisms.py``'s own cells
are homogeneous: their Eh is the isotropic base tensor, whose two
smallest eigenvalues are equal, so the softest eigenstrain is not
determined and the two packages' eigensolvers pick different ones.  On
this cell the softest eigenstrain is simple and its first component is
far from zero (>= 0.3 of its largest, checked at every step), so the
sign flip is decided the same way in both packages.  The reference's
fluctuations ``w`` go into both packages as numpy.

Gates: the energy form at the vertices and at seeded perturbed vertices
(1e-12); dEh against ``jax.jacrev`` (1e-10); the port's central
difference of the whole pipeline, the cell problems re-solved at +-h, on
``tests/test_mechanisms.py``'s grid_tri(6) cell (2e-4, that test's gate);
the identified-vertex sums and equal steps (1e-12); ``open_linkage`` (3
steps) and ``optimize_linkage`` (2 steps): each step's Eh, minimum
eigenvalue, opening strain and step field and the final vertices against
the reference (1e-8); one step of ``open_linkage`` on the orthotropic
base cell, up to the opening's sign (its softest eigenstrain is pure
shear, first component exactly 0, so the flip leaves the sign to the
eigensolver: ROADMAP Queue 3); both CLI subcommands beside the
reference's (the same files and printed lines, the printed numbers to
1e-8, the written fields to 1e-7 of their largest entry, the CLIs' own
solver tolerance); and the
energy form with the corner gather through the mesh's ``GatherPlan``
equal bit for bit to the plain index it replaced.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu.analysis import homogenization as rhom
from meshfem_tpu.analysis import mechanisms as rmech
from meshfem_tpu.fem import elasticity_tensor as ret
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen

from meshfem_tpu_torch.analysis import deformed_cells as dc
from meshfem_tpu_torch.analysis import homogenization as hom
from meshfem_tpu_torch.analysis import mechanisms as mech
from meshfem_tpu_torch.fem import elasticity_tensor as et
from meshfem_tpu_torch.mesh import FEMMesh, periodic


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
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _perturbed_interior(V, n, seed=3):
    """Move the vertices off the cell's outer boundary by a seeded quarter
    cell (``tests/test_mechanisms.py::_cell_mesh``)."""
    V = np.asarray(V, np.float64).copy()
    rng = np.random.default_rng(seed)
    interior = ((V[:, 0] > 1e-9) & (V[:, 0] < 1 - 1e-9)
                & (V[:, 1] > 1e-9) & (V[:, 1] < 1 - 1e-9))
    V[interior] += 0.25 / n * (rng.random((interior.sum(), 2)) - 0.5)
    return V


def _cell_vertices(n):
    """``tests/test_mechanisms.py::_cell_mesh``'s arrays."""
    V, F = rgen.grid_tri(n, n)
    return _perturbed_interior(V, n), np.asarray(F)


def _slot_cell(n=8, a=0.2, b=0.42, tilt=0.35):
    """grid_tri(n) without the triangles whose centroid lies in the
    ellipse of semi-axes (a, b) about the centre, turned by ``tilt``
    radians, vertices renumbered and then perturbed."""
    V, F = rgen.grid_tri(n, n)
    V, F = np.asarray(V, np.float64), np.asarray(F)
    c = V[F].mean(axis=1) - 0.5
    x = np.cos(tilt) * c[:, 0] + np.sin(tilt) * c[:, 1]
    y = -np.sin(tilt) * c[:, 0] + np.cos(tilt) * c[:, 1]
    F = F[(x / a) ** 2 + (y / b) ** 2 > 1]
    used = np.unique(F)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return _perturbed_interior(V[used], n), remap[F]


@pytest.fixture(scope="module")
def cell():
    """The slot cell, P2, in both packages, the reference's cell problems
    (tol 1e-10, as the drivers below solve them: one
    compile of the reference's block CG) and its dEh."""
    V, F = _slot_cell()
    rmesh = RFEMMesh(V, F, degree=2)
    pmesh = FEMMesh(V, F, degree=2)
    D = ret.isotropic(2, 1.0, 0.3)
    rsim = rhom.periodic_simulator(rmesh, D)
    w, _ = rhom.solve_cell_problems(rsim, tol=1e-10)
    dEh_ref = np.asarray(rmech.eh_vertex_differential(rmesh, D, w))
    return dict(V=V, F=F, rmesh=rmesh, pmesh=pmesh, D=D,
                Dp=et.isotropic(2, 1.0, 0.3), w=np.asarray(w),
                rsim=rsim, dEh_ref=dEh_ref)


def test_node_positions_from_vertices(cell):
    pmesh, rmesh = cell["pmesh"], cell["rmesh"]
    Xv = cell["V"] + 0.01 * np.random.default_rng(1).standard_normal(
        cell["V"].shape)
    X = pmesh.node_positions_from_vertices(Xv, device="cpu")
    assert torch.equal(X, torch.as_tensor(np.asarray(
        rmesh.node_positions_from_vertices(jnp.asarray(Xv)))))
    np.testing.assert_array_equal(
        pmesh.node_positions_from_vertices(cell["V"], device="cpu").numpy(),
        pmesh.node_positions)
    np.testing.assert_array_equal(pmesh.is_bdry_node, rmesh.is_bdry_node)


def test_energy_form_matches_reference(cell):
    pmesh, rmesh, w = cell["pmesh"], cell["rmesh"], cell["w"]
    Eh_ref = np.asarray(rmech.energy_form_Eh(rmesh, cell["D"], w))
    Eh = mech.energy_form_Eh(pmesh, cell["Dp"], torch.as_tensor(w))
    assert _rel(Eh, Eh_ref) <= 1e-12
    # and equal to the reference's stress form (tests/test_mechanisms.py)
    Eh_s = np.asarray(rhom.homogenized_tensor_stress_form(cell["rsim"], w))
    np.testing.assert_allclose(Eh.numpy(), Eh_s, rtol=1e-9, atol=1e-11)
    Xv = cell["V"] + 0.02 * np.random.default_rng(2).standard_normal(
        cell["V"].shape)
    for vol in (None, 1.3):
        Eh_ref = np.asarray(rmech.energy_form_Eh(
            rmesh, cell["D"], w, jnp.asarray(Xv), base_cell_volume=vol))
        Eh = mech.energy_form_Eh(pmesh, cell["Dp"], torch.as_tensor(w),
                                 torch.as_tensor(Xv), base_cell_volume=vol)
        assert _rel(Eh, Eh_ref) <= 1e-12


def test_eh_vertex_differential_matches_jacrev(cell):
    dEh = mech.eh_vertex_differential(cell["pmesh"], cell["Dp"],
                                      torch.as_tensor(cell["w"]))
    nv = cell["pmesh"].num_vertices
    assert tuple(dEh.shape) == cell["dEh_ref"].shape == (nv, 2, 3, 3)
    assert _rel(dEh, cell["dEh_ref"]) <= 1e-10
    # with an explicit base-cell volume: a constant, so dEh scales by it
    dEh2 = mech.eh_vertex_differential(cell["pmesh"], cell["Dp"],
                                       torch.as_tensor(cell["w"]),
                                       base_cell_volume=2.0)
    assert _rel(dEh2 * 2.0, dEh) <= 1e-14


def test_energy_form_gather_is_bitwise_the_plain_index(cell, monkeypatch):
    """The corner gather through the mesh's GatherPlan gives the energy
    form, and its gradient, exactly as the plain index ``X[F]`` did."""
    pmesh = cell["pmesh"]
    w = torch.as_tensor(cell["w"])
    X0 = torch.as_tensor(pmesh.node_positions)
    W = torch.as_tensor(np.random.default_rng(9).standard_normal((3, 3)))

    def run():
        X = X0.clone().requires_grad_(True)
        Eh = dc._energy_form_tensor(pmesh, cell["Dp"], w, X)
        (g,) = torch.autograd.grad((W * Eh).sum(), X)
        return Eh.detach(), g

    Eh_plan, g_plan = run()
    F = torch.as_tensor(pmesh.F)
    monkeypatch.setattr(pmesh, "corner_gather",
                        lambda dev: (lambda X: X[F].reshape(-1, 2)))
    Eh_plain, g_plain = run()
    assert torch.equal(Eh_plan, Eh_plain)
    assert _rel(g_plan, g_plain) <= 1e-14


def test_eh_vertex_differential_against_finite_differences():
    """The port's own central difference of the whole pipeline on the
    grid_tri(6) cell: re-mesh at V +- h delta (the periodic boundary held),
    re-solve the cell problems, stress-form Eh[0, 0]."""
    V, F = _cell_vertices(6)
    mesh = FEMMesh(V, F, degree=2)
    D = et.isotropic(2, 1.0, 0.3)
    sim = hom.periodic_simulator(mesh, D, device="cpu")
    w, _ = hom.solve_cell_problems(sim, tol=1e-12)
    dEh = mech.eh_vertex_differential(mesh, D, w).numpy()
    rng = np.random.default_rng(0)
    delta = rng.standard_normal(V.shape)
    onb = ((np.abs(V[:, 0]) < 1e-9) | (np.abs(V[:, 0] - 1) < 1e-9)
           | (np.abs(V[:, 1]) < 1e-9) | (np.abs(V[:, 1] - 1) < 1e-9))
    delta[onb] = 0.0
    directional = float(np.einsum("vc,vcij->ij", delta, dEh)[0, 0])

    def full_Eh00(t):
        m = FEMMesh(V + t * delta, F, degree=2)
        s = hom.periodic_simulator(m, D, device="cpu")
        wt, _ = hom.solve_cell_problems(s, tol=1e-13)
        return float(hom.homogenized_tensor_stress_form(s, wt)[0, 0])

    h = 1e-5
    fd = (full_Eh00(h) - full_Eh00(-h)) / (2 * h)
    assert abs(fd - directional) <= 2e-4 * max(abs(fd), 1e-12) + 1e-9, \
        (fd, directional)


def test_sum_identified_vertex_field(cell):
    pmesh, rmesh = cell["pmesh"], cell["rmesh"]
    dof_map, _, _ = periodic.match_periodic_nodes(pmesh.node_positions,
                                                  pmesh.bbox(), 1e-7)
    v = np.random.default_rng(4).standard_normal((pmesh.num_vertices, 2))
    s = mech.sum_identified_vertex_field(pmesh, dof_map, v)
    np.testing.assert_array_equal(
        s, np.asarray(rmech.sum_identified_vertex_field(rmesh, dof_map, v)))
    vdofs = dof_map[pmesh.vertex_nodes]
    for dof in np.unique(vdofs):
        grp = s[vdofs == dof]
        np.testing.assert_allclose(grp - grp[0], 0.0, atol=1e-12)


def _steps_close(res, ref, tol=1e-8, signed=True):
    """Each step and the result against the reference's.  ``signed=False``
    compares the opening strain, the step field and the vertices' moves
    up to one sign per step."""
    assert len(res.steps) == len(ref.steps)
    for s, r in zip(res.steps, ref.steps):
        assert _rel(s.Eh, r.Eh) <= tol
        assert abs(s.min_eigenvalue - r.min_eigenvalue) \
            <= tol * np.abs(r.Eh).max()
        o = np.asarray(r.opening_strain)
        sign = 1.0
        if signed:
            # the flip is decided far from zero
            assert abs(o[0]) >= 0.3 * np.abs(o).max()
        else:
            sign = np.sign(float(np.dot(s.opening_strain, o)))
        assert _rel(sign * s.opening_strain, o) <= tol
        assert _rel(sign * s.step_field, r.step_field) <= tol
    V0 = np.asarray(ref.vertices) - sum(r.step_field for r in ref.steps)
    assert _rel(sign * (res.vertices - V0), ref.vertices - V0) <= tol
    assert _rel(res.Eh, ref.Eh) <= tol
    assert abs(res.max_rel_edge_change - ref.max_rel_edge_change) \
        <= tol * ref.max_rel_edge_change


@pytest.mark.parametrize("ortho", [False, True])
def test_open_linkage_matches_reference(cell, ortho):
    kw = dict(num_steps=1 if ortho else 3, opening_speed=0.005, tol=1e-10,
              orthotropic_cell=ortho)
    ref = rmech.open_linkage(cell["rmesh"], cell["D"], **kw)
    res = mech.open_linkage(cell["pmesh"], cell["Dp"], device="cpu", **kw)
    _steps_close(res, ref, signed=not ortho)
    for s in res.steps:
        assert s.opening_strain[0] >= 0
        assert abs(np.linalg.norm(s.step_field, axis=1).max() - 0.005) \
            < 1e-9


def test_optimize_linkage_matches_reference(cell):
    kw = dict(num_steps=2, step_size=0.002, tol=1e-10)
    ref = rmech.optimize_linkage(cell["rmesh"], cell["D"], **kw)
    res = mech.optimize_linkage(cell["pmesh"], cell["Dp"], device="cpu", **kw)
    _steps_close(res, ref)
    # identified periodic vertices receive identical descent steps
    dof_map, _, _ = periodic.match_periodic_nodes(
        cell["pmesh"].node_positions, cell["pmesh"].bbox(), 1e-7)
    vdofs = dof_map[cell["pmesh"].vertex_nodes]
    for dof in np.unique(vdofs):
        grp = res.steps[0].step_field[vdofs == dof]
        np.testing.assert_allclose(grp - grp[0], 0.0, atol=1e-12)


def _numbers(text):
    return np.array([float(x) for x in re.findall(
        r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?", text)])


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("sub", ["open", "optimize"])
def test_mechanisms_cli_matches_reference(cell, sub, tmp_path, monkeypatch):
    """Both subcommands on the same .off cell in two directories: the same
    files, the same printed lines, their numbers equal to 1e-8."""
    from meshfem_tpu.cli import mechanisms as rcli
    from meshfem_tpu.io import meshio as rio

    from meshfem_tpu_torch.cli import mechanisms as cli
    from meshfem_tpu_torch.io import msh_fields

    mesh_path = tmp_path / "cell.off"
    rio.save_off(mesh_path, cell["V"], cell["F"])
    if sub == "open":
        args = ["open", "link", str(mesh_path), "-n", "2", "-s", "0.002",
                "--outputFreq", "1", "-d", "2"]
    else:
        args = ["optimize", str(mesh_path), "-n", "1", "-o", "fit.msh"]
    out = {}
    for name, main, extra in (("ref", rcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        out[name] = _run(main, args + extra)
    files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == (5 if sub == "open" else 2)
    lines = [[re.sub(r"[-+0-9.e]+", "#", x) for x in out[k].splitlines()]
             for k in ("ref", "port")]
    assert lines[0] == lines[1]
    a, b = _numbers(out["port"]), _numbers(out["ref"])
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    for f in files:
        if f.endswith(".txt"):
            np.testing.assert_allclose(
                _numbers((tmp_path / "port" / f).read_text()),
                _numbers((tmp_path / "ref" / f).read_text()),
                rtol=1e-8, atol=1e-12)
        else:
            fp = msh_fields.read_fields(tmp_path / "port" / f)
            fr = msh_fields.read_fields(tmp_path / "ref" / f)
            assert sorted(fp) == sorted(fr)
            for k in fp:
                # the CLIs solve to their default tol 1e-7: the fields
                # agree to that of their largest entry
                a, b = np.asarray(fp[k]["data"]), np.asarray(fr[k]["data"])
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-7 * np.abs(b).max())
