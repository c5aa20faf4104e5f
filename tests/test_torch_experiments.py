"""The port's validation suites (``meshfem_tpu_torch/experiments``) against
the reference's scripts (``experiments/*.py``) on the CPU, on the same
small arguments.

The importable reference scripts are imported from ``experiments/``
through ``sys.path`` (as ``tests/test_experiments.py`` does) or run
through ``runpy`` with ``sys.argv``; the port's modules are called with
``device="cpu"`` / ``--device cpu``.  ``extrusion_validation`` and
``stress_extrusion_validation`` read files outside this repository when
imported, so for them the test composes the reference script's steps
through ``meshfem_tpu``'s API on the port's stand-in mesh and boundary
conditions.

Tolerances, each set from how far the two solves carry the compared
digits (a solve stopped at tol t in both packages is compared well above
t):

* printed tables at their printed digits (two units in the last place);
* the Laplace errors (solved to 1e-13, errors >= 1e-5): printed digits;
* the elasticity "errors" are the distance of the solve from the exact
  Galerkin solution, i.e. the solver's own error at tol 1e-12 (1e-16 to
  1e-12 in both packages): held below 1e-9 in both, not against each
  other; the diagonal condition estimates at printed digits;
* algebraic fits 1e-10 relative; the compression solves (tol 1e-10) 1e-7
  of max|u|; their fitted moduli 1e-7;
* homogenized tensors solved to 1e-10: 1e-8 of max|Ch|;
* the conductivity field and its error quantiles (forward CG to 1e-11,
  through a regularized inverse) 1e-8 of max|a|;
* the extrusion fields (2D to 1e-10, 3D to 1e-9) 1e-7 / 1e-6 of their
  largest entry, the derived errors and curve distances 1e-6.
"""

import contextlib
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshfem_tpu_torch.experiments import (animate_cstrain,
                                           circular_sector_homog,
                                           conductivity_inverse,
                                           elasticity_convergence,
                                           extrusion_validation,
                                           fit_validation,
                                           laplace_convergence,
                                           stress_extrusion_validation)

EXP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")
sys.path.insert(0, EXP)
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?|nan")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_script(name, argv):
    """The reference script's standard output, run as ``__main__``."""
    old, buf = sys.argv, io.StringIO()
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(EXP, name), run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def _run_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def _numbers(line):
    return [float(x) for x in NUMBER.findall(line)]


def _last_digit(token):
    """One unit in the last printed place of a number as printed."""
    mant, _, exp = token.lower().partition("e")
    places = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - places)


def _same_table(port, ref):
    """Two printed tables equal but for their numbers, and those within
    two units in the last printed place (nan equal to nan)."""
    assert len(port) == len(ref), (port, ref)
    for p, r in zip(port, ref):
        assert NUMBER.sub("#", p) == NUMBER.sub("#", r), (p, r)
        for a, b in zip(NUMBER.findall(p), NUMBER.findall(r)):
            if b == "nan":
                assert a == "nan", (p, r)
            else:
                assert abs(float(a) - float(b)) <= 2 * _last_digit(b), (p, r)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- 1. laplace_convergence ---------------------------------------------------

def test_laplace_convergence_matches_reference():
    """``--max 8``: the same table (errors at their printed digits)."""
    ref = _run_script("laplace_convergence.py", ["--max", "8", "--cpu"])
    port = _run_main(laplace_convergence.main, ["--max", "8",
                                                "--device", "cpu"])
    _same_table(port.splitlines(), ref.splitlines())
    rows = laplace_convergence.convergence(8, device="cpu")
    assert [(n, d) for n, d, _, _ in rows] == [(4, 1), (8, 1), (4, 2),
                                               (8, 2)]
    errs = [_numbers(x)[2] for x in ref.splitlines()[1:]
            if len(_numbers(x)) == 4]
    np.testing.assert_allclose([e for _, _, e, _ in rows], errs,
                               rtol=1e-5)


# -- 2. elasticity_convergence ------------------------------------------------

def test_elasticity_convergence_matches_reference():
    """``--max 8 --nu 0.3``: the same table layout and condition
    estimates; the solve's distance from the exact Galerkin solution, the
    solver's own error at tol 1e-12, below 1e-9 in both."""
    ref = _run_script("elasticity_convergence.py",
                      ["--max", "8", "--nu", "0.3", "--cpu"]).splitlines()
    out = elasticity_convergence.convergence(8, (0.3,), device="cpu")[0.3]
    port = _run_main(elasticity_convergence.main,
                     ["--max", "8", "--nu", "0.3", "--device",
                      "cpu"]).splitlines()
    assert len(port) == len(ref) and port[:2] == ref[:2]
    rows = [(_numbers(p), _numbers(r)) for p, r in zip(port[2:], ref[2:])
            if p]
    assert len(rows) == len(out) == 4
    for (p, r), (n, deg, err, _, cond, relres) in zip(rows, out):
        assert p[:2] == r[:2] == [n, deg]
        assert abs(p[4] - r[4]) <= 2 * 1e-3 * abs(r[4])      # cond est
        assert 0 <= err < 1e-9 and 0 <= r[2] < 1e-9
        assert relres < 1e-10


# -- 3. fit_validation --------------------------------------------------------

def test_fit_validation_matches_reference():
    """``n=6, degree=2``: the algebraic fits on the same seeded pairs
    (1e-10), the compression solve (1e-7 of max|u|), the simulation
    round trips and the orthotropic probes gated in both."""
    import fit_validation as rfv
    from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
    from meshfem_tpu.physics import Material as RMat
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import Material

    with contextlib.redirect_stdout(io.StringIO()):
        for dim in (2, 3):
            r = rfv.check_isotropic_roundtrip(np.random.default_rng(dim), dim)
            p = fit_validation.check_isotropic_roundtrip(
                np.random.default_rng(dim), dim)
            assert _rel(p, r) < 1e-10
            r = rfv.check_orthotropic_roundtrip(np.random.default_rng(dim),
                                                dim)
            p = fit_validation.check_orthotropic_roundtrip(
                np.random.default_rng(dim), dim)
            assert r.keys() == p.keys()
            assert _rel([p[k] for k in r], [r[k] for k in r]) < 1e-10
    # the noisy fit (the reference's returns nothing): its printed line
    rline = _run_main(lambda a: rfv.check_noise_robustness(
        np.random.default_rng(4)), [])
    pline = _run_main(lambda a: fit_validation.check_noise_robustness(
        np.random.default_rng(4)), [])
    _same_table(pline.splitlines(), rline.splitlines())
    with contextlib.redirect_stdout(io.StringIO()):
        # the compression problem, and the samples the fits read
        rsim, ru, _ = rfv.compression_sim(
            RFEMMesh(*rgen.grid_tri(6, 6), degree=2),
            RMat.isotropic(2, 2.0, 0.28))
        sim, u, _ = fit_validation.compression_sim(
            FEMMesh(*generators.grid_tri(6, 6), degree=2),
            Material.isotropic(2, 2.0, 0.28), device="cpu")
        assert _rel(u, ru) < 1e-7
        assert _rel(sim.average_stress_field(torch.as_tensor(u)),
                    rsim.average_stress_field(jnp.asarray(ru))) < 1e-7
        assert rfv.check_simulation_roundtrip(6, 2) < 1e-5
        assert fit_validation.check_simulation_roundtrip(
            6, 2, device="cpu") < 1e-5
        r = rfv.check_orthotropic_simulation(6, 2)
        p = fit_validation.check_orthotropic_simulation(6, 2, device="cpu")
        assert _rel([p[k] for k in r], [r[k] for k in r]) < 1e-7
    out = _run_main(fit_validation.main, ["--n", "6", "--device", "cpu"])
    assert out.splitlines()[-1] == "fit_validation: ALL CHECKS PASSED"


# -- 4. circular_sector_homog -------------------------------------------------

@pytest.mark.parametrize("skip", [0, 12])
def test_circular_sector_matches_reference(skip):
    """The hole polygon equal; area 8e-3 at P1 with ``nsubdiv=24``: the
    same mesh and ``Ch`` (tol 1e-10) to 1e-8 of max|Ch|."""
    import circular_sector_homog as rcs

    np.testing.assert_array_equal(
        circular_sector_homog.sector_hole(nsubdiv=24, skip=skip),
        rcs.sector_hole(nsubdiv=24, skip=skip))
    kw = dict(radius=0.3, skip=skip, degree=1, nsubdiv=24, tol=1e-10)
    rCh, rn = rcs.homogenize_sector(8e-3, **kw)
    Ch, n = circular_sector_homog.homogenize_sector(8e-3, device="cpu",
                                                    **kw)
    assert n == rn
    assert _rel(Ch, rCh) < 1e-8


def test_circular_sector_rate_and_study():
    """``rate`` on the same tensors (1e-12), and the port's study at two
    small levels (P1, area 8e-3) gated as the reference gates."""
    import circular_sector_homog as rcs

    rng = np.random.default_rng(5)
    areas = 2e-3 * 0.5 ** np.arange(4)
    Chs = np.eye(3)[None] + np.sqrt(areas)[:, None, None] ** 2 \
        * rng.standard_normal((4, 3, 3))
    p, errs = circular_sector_homog.rate(areas, Chs)
    rp, rerrs = rcs.rate(areas, Chs)
    assert abs(p - rp) <= 1e-12 * abs(rp) and _rel(errs, rerrs) < 1e-12
    with contextlib.redirect_stdout(io.StringIO()):
        out = circular_sector_homog.study(3, 8e-3, 1, device="cpu")
    assert out["smooth"][0] > 0.9


# -- 5. animate_cstrain -------------------------------------------------------

def test_animate_cstrain_matches_reference(tmp_path):
    """Area 1.5e-2, 6 frames: the same printed checks at their printed
    digits, both viewer files written."""
    ref = _run_script("animate_cstrain.py",
                      ["--out", str(tmp_path / "ref"), "--area", "1.5e-2",
                       "--frames", "6"]).splitlines()
    port = _run_main(animate_cstrain.main,
                     ["--out", str(tmp_path / "port"), "--area", "1.5e-2",
                      "--frames", "6", "--device", "cpu"]).splitlines()
    _same_table([x for x in port if not x.startswith("wrote")],
                [x for x in ref if not x.startswith("wrote")])
    for d in ("ref", "port"):
        for f in ("cell_cstrain.html", "homogenized_cstrain.html"):
            assert (tmp_path / d / f).stat().st_size > 1000


# -- 6. conductivity_inverse --------------------------------------------------

def test_conductivity_inverse_matches_reference(tmp_path):
    """The stand-in domain written small (area 2e-3) and passed to both
    ``run(mesh_path=...)``: the recovered field and the quantiles of its
    error (both in units of max|a|) to 1e-8, both gated.  The quantiles
    are errors of ~1e-6 that the forward CG's tol 1e-11 reaches through
    the regularized inverse: they agree to ~4e-10, 4e-5 of themselves, so
    they are compared in max|a|, not relative to themselves."""
    import conductivity_inverse as rci

    path = str(tmp_path / "omega.msh")
    conductivity_inverse.write_omega(path, target_area=2e-3)
    with contextlib.redirect_stdout(io.StringIO()):
        r = rci.run(mesh_path=path)
        p = conductivity_inverse.run(mesh_path=path, device="cpu")
    np.testing.assert_allclose([p["median"], p["p95"]],
                               [r["median"], r["p95"]], rtol=0, atol=1e-8)
    assert p["median"] < 1e-3 and p["p95"] < 1e-2
    np.testing.assert_array_equal(p["interior"], r["interior"])
    assert np.abs(p["a_inf"] - r["a_inf"]).max() < 1e-8 * np.abs(r["a"]).max()


def test_conductivity_forward_pieces_match_reference():
    """``forward_matrices``, ``inverse_matrices`` and ``load_vector`` on
    the same small mesh and fields: 1e-12 relative."""
    import conductivity_inverse as rci
    from meshfem_tpu.mesh import FEMMesh as RFEMMesh
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg

    V, F = triangulate_pslg(conductivity_inverse.OMEGA_OUTLINE,
                            holes=[conductivity_inverse.OMEGA_HOLE],
                            target_area=1e-2)
    mesh, rmesh = FEMMesh(V, F, degree=2), RFEMMesh(V, F, degree=2)
    X = mesh.node_positions
    a = 1.5 + np.cos(0.5 * np.pi * X[:, 0] * X[:, 1])
    f = np.sin(2 * np.pi * X[:, 0] * X[:, 1])
    assert _rel(conductivity_inverse.forward_matrices(mesh, a, "cpu"),
                rci.forward_matrices(rmesh, a)) < 1e-12
    assert _rel(conductivity_inverse.load_vector(mesh, f, "cpu"),
                rci.load_vector(rmesh, f)) < 1e-12
    u = np.cos(X[:, 0]) * X[:, 1]
    assert _rel(conductivity_inverse.inverse_matrices(
        mesh, torch.as_tensor(u)), rci.inverse_matrices(rmesh, u)) < 1e-12


# -- 7, 8. extrusion_validation, stress_extrusion_validation ------------------

@pytest.fixture(scope="module")
def extrusion(tmp_path_factory):
    """The port's stand-in mesh written small (area 5e-2) and the
    reference script's steps composed through ``meshfem_tpu``: the 2D
    solve and the extrusion at t = 0.25 (1 layer) and t = 1.0 (4 layers),
    as ``experiments/extrusion_validation.py`` solves them."""
    from meshfem_tpu.io import meshio as rio
    from meshfem_tpu.mesh import FEMMesh as RFEMMesh, filters as rfilters
    from meshfem_tpu.physics import (ElasticitySimulator as RSim,
                                     Material as RMat, parse_bc as rparse)

    path = str(tmp_path_factory.mktemp("extrusion") / "sample.msh")
    extrusion_validation.write_sample(path, target_area=5e-2)
    mat = extrusion_validation.MAT
    V, F = rio.load(path)
    rmesh2 = RFEMMesh(V[:, :2], F, degree=2)
    rsim2 = RSim(rmesh2, RMat.isotropic(2, mat["young"], mat["poisson"]))
    rsim2.apply_boundary_conditions(rparse(
        json.dumps(extrusion_validation.BC2), dim=2))
    u2, _ = rsim2.solve(tol=1e-10)
    ref = {"2d": (rmesh2, np.asarray(u2),
                  np.asarray(rsim2.von_mises_field(u2)))}
    for t, layers in ((0.25, 1), (1.0, 4)):
        V3, T3 = rfilters.extrude(V[:, :2], F, height=t, layers=layers)
        rmesh3 = RFEMMesh(V3, T3, degree=2)
        rsim3 = RSim(rmesh3, RMat.isotropic(3, mat["young"],
                                            mat["poisson"]))
        rsim3.apply_boundary_conditions(rparse(
            json.dumps(extrusion_validation.BC3), dim=3))
        u3, _ = rsim3.solve(tol=1e-9)
        ref[t] = (rmesh3, np.asarray(u3),
                  np.asarray(rsim3.von_mises_field(u3)))
    return path, ref


def _reference_compare(ref, t):
    """``experiments/extrusion_validation.py::compare``'s numbers for one
    thickness, from the reference's fields."""
    rmesh2, u2, vm2 = ref["2d"]
    rmesh3, u3, vm3 = ref[t]
    layers = {0.25: 1, 1.0: 4}[t]
    n2v = rmesh2.num_vertices
    v2 = np.asarray(rmesh2.vertex_nodes)
    v3 = np.asarray(rmesh3.vertex_nodes)[layers // 2 * n2v:
                                         (layers // 2 + 1) * n2v]
    d2, d3, vm3 = u2[v2].copy(), t * u3[v3][:, :2], t * vm3
    X = np.asarray(rmesh2.node_positions)[v2]
    Xc = X - X.mean(axis=0)
    perp = np.column_stack([-Xc[:, 1], Xc[:, 0]])
    for d in (d2, d3):
        d -= d.mean(axis=0)
        d -= (perp * d).sum() / (perp * perp).sum() * perp
    cz = np.asarray(rmesh3.barycenters())[:, 2]
    band = np.abs(cz - t / 2.0) < t / (2.0 * layers)
    q = lambda v, p: float(np.quantile(v, p))
    return dict(disp_err=np.abs(d3 - d2).max() / np.abs(d2).max(),
                vm_med_err=abs(q(vm3[band], 0.5) - q(vm2, 0.5)) / q(vm2, 0.5),
                vm_p90_err=abs(q(vm3[band], 0.9) - q(vm2, 0.9)) / q(vm2, 0.9))


def _reference_curve(mesh, vm):
    """``experiments/stress_extrusion_validation.py::distribution_curve``
    through ``meshfem_tpu.mesh.geometry.simplex_geometry``."""
    from meshfem_tpu.mesh.geometry import simplex_geometry

    X = np.asarray(mesh.node_positions)[
        np.asarray(mesh.elem_nodes)[:, : mesh.K + 1]]
    _, vol = simplex_geometry(X, mesh.K)
    vol = np.abs(np.asarray(vol))
    perm = np.argsort(vm)
    cum = np.cumsum(vol[perm])
    return cum / cum[-1], vm[perm]


def test_extrusion_fields_match_reference(extrusion):
    """The port's ``solve_2d`` (1e-7 of max|u|, von Mises 1e-7) and
    ``solve_extruded`` at t = 0.25 and 1.0 (1e-6) on the same files."""
    path, ref = extrusion
    _, _, u2, vm2 = extrusion_validation.solve_2d(mesh_path=path,
                                                  device="cpu")
    assert _rel(u2, ref["2d"][1]) < 1e-7 and _rel(vm2, ref["2d"][2]) < 1e-7
    for t in (0.25, 1.0):
        mesh3, _, u3, vm3, layers = extrusion_validation.solve_extruded(
            t, mesh_path=path, device="cpu")
        assert layers == {0.25: 1, 1.0: 4}[t]
        np.testing.assert_array_equal(mesh3.elem_nodes,
                                      ref[t][0].elem_nodes)
        assert _rel(u3, ref[t][1]) < 1e-6 and _rel(vm3, ref[t][2]) < 1e-6


def test_extrusion_compare_matches_reference(extrusion, capsys):
    """``compare`` at t = 0.25 and 1.0 against the reference script's
    arithmetic on the reference's fields: each error to 1e-6, and the
    plane-stress gates of its ``main`` hold."""
    path, ref = extrusion
    res = extrusion_validation.compare((0.25, 1.0), mesh_path=path,
                                       device="cpu")
    for r in res:
        want = _reference_compare(ref, r["thickness"])
        for k, v in want.items():
            assert abs(r[k] - v) <= 1e-6 * max(abs(v), 1e-3), (k, r, want)
    assert res[0]["disp_err"] < 0.05 and res[0]["vm_med_err"] < 0.05
    assert res[0]["disp_err"] <= res[1]["disp_err"]
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_stress_extrusion_curves_match_reference(extrusion):
    """``distribution_curve`` and ``curve_distance`` on the same fields
    as the reference script's (1e-12; the curves 1e-6 from the port's own
    solves), and the port's study (t = 0.25 and 1.0, twice the layers at
    0.25) gated as the reference gates."""
    path, ref = extrusion
    rmesh2, _, rvm2 = ref["2d"]
    curve2 = stress_extrusion_validation.distribution_curve(rmesh2, rvm2)
    rcurve2 = _reference_curve(rmesh2, rvm2)
    assert _rel(curve2[0], rcurve2[0]) < 1e-12
    np.testing.assert_array_equal(curve2[1], rcurve2[1])
    rmesh3, _, rvm3 = ref[0.25]
    c3 = _reference_curve(rmesh3, 0.25 * rvm3)
    grid = np.linspace(0.02, 0.98, 512)
    s2, s3 = np.interp(grid, *rcurve2), np.interp(grid, *c3)
    want = float(np.linalg.norm(s3 - s2) / np.linalg.norm(s2))
    assert abs(stress_extrusion_validation.curve_distance(rcurve2, c3)
               - want) <= 1e-12 * want
    with contextlib.redirect_stdout(io.StringIO()):
        dists, d_ref = stress_extrusion_validation.study(
            (0.25, 1.0), mesh_path=path, device="cpu")
    assert abs(dists[0] - want) <= 1e-6
    assert dists[0] < 0.05 and dists[-1] > dists[0]
    assert abs(d_ref - dists[0]) < 0.03
