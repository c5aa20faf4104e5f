"""The port's ElasticitySimulator == meshfem_tpu's, on the CPU in float64.

(a) the ``__graft_entry__.entry`` problem (residual and energy of the P2
    operator on grid_tet(4,4,4)) to 1e-10;
(b) ``Ke`` and the float64 ``apply_K`` to 1e-12;
(c) a clamped, end-loaded bar (``bench.py:397-404``): the port's
    ``solve(operator="routed", tol=1e-10)`` (float32 inner CG inside float64
    refinement) and ``solve(operator="ebe")`` against the reference's
    ``solve(operator="ebe", tol=1e-10)``: u and von Mises to 1e-8 relative;
(d) (c) again in a subprocess where ``jax`` and ``meshfem_tpu`` cannot be
    imported, with a homogenization, an ``auto`` solve of a clamped
    grid_tet(8), which takes the structured multigrid (f64 relative
    residual < 1e-10), and a free body in uniform tension through
    ``parse_bc`` and ``no_rigid_motion`` (stress to 1e-9): the port stands
    alone, boundary-condition modules included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import __graft_entry__
from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators
from meshfem_tpu.physics import ElasticitySimulator as RSim, Material as RMat

from meshfem_tpu_torch import interop
from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.physics import ElasticitySimulator, Material


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_graft_entry_residual_and_energy():
    fn, (u0, b_ref) = __graft_entry__.entry()
    V, T = generators.grid_tet(4, 4, 4)
    sim = ElasticitySimulator(FEMMesh(V, T, degree=2),
                              Material.isotropic(3, 200.0, 0.3), device="cpu")
    b = sim.constant_strain_load([1e-3, 0, 0, 0, 0, 0.0])
    assert _rel(b.numpy(), b_ref) < 1e-10
    rng = np.random.default_rng(1)
    for u_np in (np.zeros(tuple(u0.shape)),
                 1e-3 * rng.standard_normal(tuple(u0.shape))):
        r_ref, e_ref = fn(jnp.asarray(u_np), b_ref)
        u = torch.as_tensor(u_np)
        Ku = sim.apply_K(u)
        r = b - Ku
        energy = 0.5 * torch.vdot(u.reshape(-1), Ku.reshape(-1)) \
            - torch.vdot(b.reshape(-1), u.reshape(-1))
        assert _rel(r.numpy(), r_ref) < 1e-10
        assert abs(float(energy) - float(e_ref)) \
            <= 1e-10 * max(abs(float(e_ref)), 1e-30) + 1e-300
        if u_np.any():
            assert float(sim.strain_energy(u)) == pytest.approx(
                0.5 * float(jnp.vdot(jnp.asarray(u_np), jnp.asarray(
                    np.asarray(r_ref) * -1 + np.asarray(b_ref)))), rel=1e-10)


@pytest.mark.parametrize("deg", [1, 2])
def test_stiffness_and_apply(deg):
    V, T = generators.grid_tet(3, 3, 3)
    V = V + 0.03 * np.random.default_rng(deg).standard_normal(V.shape)
    rsim = RSim(RFEMMesh(V, T, degree=deg), RMat.isotropic(3, 200.0, 0.3))
    sim = ElasticitySimulator(FEMMesh(V, T, degree=deg),
                              Material.isotropic(3, 200.0, 0.3), device="cpu")
    Ke0 = np.asarray(rsim.Ke)
    assert np.abs(sim.Ke.numpy() - Ke0).max() <= 1e-12 * np.abs(Ke0).max()
    u = np.random.default_rng(0).standard_normal((sim.num_dofs, 3))
    assert _rel(sim.apply_K(torch.as_tensor(u)).numpy(),
                rsim.apply_K(jnp.asarray(u))) < 1e-12
    assert _rel(sim.K_diagonal().numpy(), rsim.K_diagonal()) < 1e-12


def _clamped_bar(mod_mesh, mod_sim, mod_mat, device=None):
    """bench.py:397-404: fix the x = 0 face, load the far face in -y."""
    V, T = generators.bar_tet(6, 2, 2)
    mesh = mod_mesh(V, T, degree=2)
    kw = {} if device is None else {"device": device}
    sim = mod_sim(mesh, mod_mat.isotropic(3, 200.0, 0.3), **kw)
    X = np.asarray(mesh.node_positions)
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    return sim, load


@pytest.fixture(scope="module")
def reference_solution():
    rsim, load = _clamped_bar(RFEMMesh, RSim, RMat)
    rsim.neumann_load = jnp.asarray(load)
    u, _ = rsim.solve(operator="ebe", tol=1e-10)
    return rsim, load, np.asarray(u), np.asarray(rsim.von_mises_field(u))


@pytest.mark.parametrize("operator", ["routed", "ebe"])
def test_solve_matches_reference(reference_solution, operator):
    rsim, load, u_ref, vm_ref = reference_solution
    sim, _ = _clamped_bar(FEMMesh, ElasticitySimulator, Material, "cpu")
    sim.neumann_load = torch.as_tensor(load)
    u, res = sim.solve(operator=operator, tol=1e-10)
    assert u.dtype == torch.float64
    assert res.resnorm <= 1e-10 if operator == "routed" else True
    if operator == "routed":
        assert res.rounds >= 1 and res.iters > 0
    assert _rel(u.numpy(), u_ref) < 1e-8
    assert _rel(sim.von_mises_field(u).numpy(), vm_ref) < 1e-8
    assert _rel(sim.average_stress(u).numpy(),
                rsim.average_stress(jnp.asarray(u_ref))) < 1e-8


def test_routed_float32_solve(reference_solution):
    """tol >= 1e-5 takes the routed solve without refinement: float32 CG
    only, so u agrees with the float64 reference to the f32 solve's
    accuracy (1.2e-4 measured at tol 1e-5), not to 1e-8."""
    _, load, u_ref, _ = reference_solution
    sim, _ = _clamped_bar(FEMMesh, ElasticitySimulator, Material, "cpu")
    sim.neumann_load = torch.as_tensor(load)
    u, res = sim.solve(operator="routed", tol=1e-5)
    assert u.dtype == torch.float64 and res.rounds == 0 and res.iters > 0
    assert _rel(u.numpy(), u_ref) < 1e-3


def test_simulator_from_arrays(reference_solution):
    rsim, load, u_ref, _ = reference_solution
    mesh = rsim.mesh
    sim = interop.simulator_from_arrays(dict(
        V=mesh.V, T=mesh.F, degree=mesh.degree, D=np.asarray(rsim.D),
        dirichlet_mask=rsim.dirichlet_mask,
        dirichlet_values=rsim.dirichlet_values,
        neumann_load=np.asarray(rsim.neumann_load),
        Ke=np.asarray(rsim.Ke)), device="cpu")
    assert np.array_equal(sim.Ke.numpy(), np.asarray(rsim.Ke))
    u, _ = sim.solve(operator="routed", tol=1e-10)
    assert _rel(u.numpy(), u_ref) < 1e-8


def test_solve_scope_raises(reference_solution):
    """The solve's scope: the structured and AMG paths' ValueErrors, and
    precond='amg' running on the routed operator (float64 refinement
    around float32 MG-PCG) to the reference's float64 EBE solution."""
    _, load, u_ref, _ = reference_solution
    sim, _ = _clamped_bar(FEMMesh, ElasticitySimulator, Material, "cpu")
    with pytest.raises(ValueError, match="requires a 3D P2 mesh"):
        sim.solve(operator="structured")      # 144 tets: not eligible
    with pytest.raises(ValueError, match="routed operator only"):
        sim.solve(operator="ebe", precond="amg")
    sim.neumann_load = torch.as_tensor(load)
    u, res = sim.solve(operator="routed", precond="amg", tol=1e-10)
    assert res.resnorm <= 1e-10 and res.rounds >= 1
    assert _rel(u.numpy(), u_ref) < 1e-8
    with pytest.raises(ValueError, match="unknown precond"):
        sim.solve(operator="ebe", precond="nope")


_STANDALONE = r"""
import importlib.abc, json, sys
assert "jax" not in sys.modules and "meshfem_tpu" not in sys.modules

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        for banned in ("jax", "jaxlib", "meshfem_tpu"):
            if name == banned or name.startswith(banned + "."):
                raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np, torch
from meshfem_tpu_torch.mesh import FEMMesh, generators
from meshfem_tpu_torch.physics import ElasticitySimulator, Material
from meshfem_tpu_torch.analysis import homogenization as hom
import meshfem_tpu_torch.mesh.periodic, meshfem_tpu_torch.solvers.precond
import meshfem_tpu_torch.kernels.factored, meshfem_tpu_torch.interop
from meshfem_tpu_torch.kernels import element_stiffness, factored_contract
from meshfem_tpu_torch.physics import parse_bc, load_bc, load_material
import meshfem_tpu_torch.physics.boundary_conditions
import meshfem_tpu_torch.utils.expressions, meshfem_tpu_torch.utils.linalg
import meshfem_tpu_torch.fem.tensor_projection, meshfem_tpu_torch.solvers
import meshfem_tpu_torch.ops.structured_periodic
import meshfem_tpu_torch.solvers.twolevel, meshfem_tpu_torch.analysis.topopt
import meshfem_tpu_torch.solvers.amg, meshfem_tpu_torch.analysis.deformed_cells
import meshfem_tpu_torch.cli.homogenize, meshfem_tpu_torch.cli.deformed_cells
V, T = generators.bar_tet(6, 2, 2)
mesh = FEMMesh(V, T, degree=2)
sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                          device="cpu")
X = mesh.node_positions
sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
load = np.zeros((mesh.num_nodes, 3))
load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
sim.neumann_load = torch.as_tensor(load)
out = {}
for op in ("routed", "ebe"):
    u, _ = sim.solve(operator=op, tol=1e-10)
    out[op] = u.numpy().tolist()
    out[op + "_vm"] = sim.von_mises_field(u).numpy().tolist()
grid = FEMMesh(*generators.grid_tet(8, 8, 8), degree=2)
gsim = ElasticitySimulator(grid, Material.isotropic(3, 200.0, 0.3),
                           device="cpu")
gX = grid.node_positions
gsim.fix_nodes(np.flatnonzero(gX[:, 0] < 1e-9))
gload = np.zeros((grid.num_nodes, 3))
gload[gX[:, 0] > 1 - 1e-9, 1] = -1.0
gsim.neumann_load = torch.as_tensor(gload)
ug, rg = gsim.solve(tol=1e-10)
out["grid_mg"] = type(gsim._mg[1]).__name__
out["grid_iters"] = rg.iters
gfree = torch.as_tensor(~gsim.dirichlet_mask)
out["grid_relres"] = float(torch.linalg.norm(
    (gsim.neumann_load - gsim.apply_K(ug)) * gfree)
    / torch.linalg.norm(gsim.neumann_load * gfree))
free = ElasticitySimulator(FEMMesh(*generators.grid_tet(3, 2, 2), degree=2),
                           Material.isotropic(3, 200.0, 0.3), device="cpu")
free.apply_boundary_conditions(parse_bc(json.dumps({
    "no_rigid_motion": True, "regions": [
        {"type": "force", "value": [s, 0, 0], "box%": {
            "minCorner": [x - 0.001, -0.001, -0.001],
            "maxCorner": [x + 0.001, 1.001, 1.001]}}
        for s, x in ((-1, 0.0), (1, 1.0))]})))
uf, _ = free.solve(tol=1e-12)
out["free_stress_err"] = float((free.average_stress_field(uf) - torch.tensor(
    [1.0, 0, 0, 0, 0, 0], dtype=torch.float64)).abs().max())
mat = Material.isotropic(3, 5.0, 0.3)
cell = FEMMesh(*generators.grid_tet(2, 2, 2), degree=1)
out["Ch_err"] = float((hom.homogenize(cell, mat, tol=1e-12, device="cpu").Ch
                       - mat.D).abs().max())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "meshfem_tpu" or m.startswith("meshfem_tpu."))
out["loaded"] = bad
print(json.dumps(out))
"""


def test_port_stands_alone(reference_solution):
    _, _, u_ref, vm_ref = reference_solution
    # one torch thread, as in the test processes (six share eight cores)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _STANDALONE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["Ch_err"] < 1e-9        # the uniform cell homogenizes to D
    assert out["free_stress_err"] < 1e-9   # a free body in uniform tension
    assert out["grid_mg"] == "StructuredMG"      # auto took the multigrid
    assert out["grid_iters"] <= 40 and out["grid_relres"] < 1e-10
    for op in ("routed", "ebe"):
        assert _rel(out[op], u_ref) < 1e-8
        assert _rel(out[op + "_vm"], vm_ref) < 1e-8
