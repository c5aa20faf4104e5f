"""Jobs and judge of ``clamped_elasticity_p2``: a static solve of the
clamped cube under one traction a job, through the port's user path
(``FEMMesh``, ``ElasticitySimulator``, ``parse_bc`` and
``apply_boundary_conditions``, ``solve``, ``von_mises_field``), judged
by the plain reference in ``fembench/reference``.

A job: the boundary conditions of its load case (the clamp region and a
traction region, as a ``.bc`` file gives them), the solve with the
configuration's defaults, and the element von Mises field.  The mesh and
the simulator are built once in set-up; the routed operator or the
multigrid is built by the warm-up job and cached by the port, as a user's
second load case finds it.

The judge reads, for each sampled job, the port's P2 node positions, the
displacements and the von Mises field, and compares:

* ``node_gap``: the largest coordinate difference between a port node
  and the reference's node at its position (P2 nodes paired by position,
  not numbering; ``inf`` when they cannot be paired one to one);
* ``relres``: the float64 relative residual of the free dofs under the
  reference's own operator and load, the configuration's ``tol`` (the
  operator reads every node's displacement, the clamped ones too, so a
  clamp not held to 0 shows here);
* ``vm_gap``: the largest gap between the port's von Mises stress and the
  reference's from the same displacements, over the largest stress.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from fembench import traffic as traffic_mod
from fembench.job import Job
from fembench.reference import elastic, mesh as ref_mesh

JOB_METRIC = "solve_s"
# limits of the numbers the judge compares, beside ``tol`` (the
# configuration's own residual); readings in PERF.md
LIMITS = {"node_gap": 1e-10, "vm_gap": 1e-9}


def traction(params):
    return [params["magnitude"] * c for c in params["direction"]]


class Problem:
    JOB_METRIC = JOB_METRIC
    JOB_KIND = "solve"

    def __init__(self, config, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device

    def setup(self, timings):
        from meshfem_tpu_torch.mesh import FEMMesh
        from meshfem_tpu_torch.physics import ElasticitySimulator, Material

        self.V, self.T = traffic_mod.make_mesh(self.traffic["mesh"])
        t0 = time.perf_counter()
        self.mesh = FEMMesh(self.V, self.T, degree=self.config["degree"])
        timings["mesh_s"] = time.perf_counter() - t0
        m = self.config["material"]
        self.sim = ElasticitySimulator(
            self.mesh, Material.isotropic(3, m["E"], m["nu"]),
            device=self.device)

    def bc(self, params):
        return json.dumps({"regions": [
            {"type": "dirichlet", "value": [0.0, 0.0, 0.0],
             "box%": self.config["clamp_box"]},
            {"type": "traction", "value": traction(params),
             "box%": self.config["traction_box"]}]})

    def job(self, params) -> Job:
        from meshfem_tpu_torch import kernels
        from meshfem_tpu_torch.physics import parse_bc

        sim = self.sim
        kernels.reset_launch_counts()
        sim.clear_boundary_conditions()
        sim.apply_boundary_conditions(parse_bc(self.bc(params), dim=3))
        u, res = sim.solve(tol=self.config["tol"], **self.config["solve"])
        vm = sim.von_mises_field(u)
        evidence = dict(cuda=u.is_cuda, routed=sim._routed is not None,
                        multigrid=sim._mg is not None,
                        gather_rows=kernels.gather_rows.launches,
                        segment_sum_rows=kernels.segment_sum_rows.launches)
        return Job({"u": u, "vm": vm}, int(res.iters),
                   {"rounds": int(res.rounds),
                    "relres": float(res.resnorm)}, evidence)

    def guard(self, job: Job):
        """None if the job took its cell's path and met ``tol`` by its
        own account, else why not."""
        ev, path = job.evidence, self.traffic["path"]
        if not job.fields["relres"] <= self.config["tol"]:
            return f"own relres {job.fields['relres']:.3e} above tol"
        if path == "routed":
            if not ev["routed"] or ev["multigrid"]:
                return "the routed operator did not run alone"
            if ev["cuda"] and not (
                    0 < job.iters <= ev["gather_rows"]
                    and job.iters <= ev["segment_sum_rows"]):
                return (f"{job.iters} inner iterations but A / B launched "
                        f"{ev['gather_rows']} / {ev['segment_sum_rows']}")
            return None
        if path == "structured":
            if not ev["multigrid"] or ev["routed"]:
                return "not the structured multigrid alone"
            return None
        return f"unknown path {path!r}"

    def release(self):
        """Free the program's state; returns what the judge reads."""
        inputs = dict(V=self.V, T=self.T,
                      nodes=np.array(self.mesh.node_positions))
        del self.sim, self.mesh
        return inputs


def control(problem, params, maxiter=4000):
    """The control: the reference in the program's place, every step in
    float32 (P2 nodes, load, Jacobi CG to ``tol``, von Mises); the
    float32 CG stops at ``maxiter``.  Returns (outputs, the float32
    reference's P2 nodes)."""
    f32, dev = torch.float32, problem.device
    mesh = ref_mesh.p2_mesh(problem.V.astype(np.float32), problem.T,
                            dtype=np.float32)
    m = problem.config["material"]
    el = elastic.Elasticity(mesh, m["E"], m["nu"], dev, dtype=f32)
    free = torch.as_tensor(mesh.nodes[:, 0] > 1e-9, device=dev).to(f32)
    u, _ = elastic.pcg(el.apply, el.traction_load(traction(params)),
                       el.diagonal(), free=free[:, None],
                       tol=problem.config["tol"], maxiter=maxiter)
    return ({"u": u.double(), "vm": el.von_mises(u).double()},
            mesh.nodes.astype(np.float64))


def _num(x):
    x = float(x)
    return x if np.isfinite(x) else str(x)


def judge(config, traffic, inputs, kept, device):
    """The compared numbers, each the worst over the sampled jobs, with
    their limits."""
    mesh = ref_mesh.p2_mesh(inputs["V"], inputs["T"])
    perm, node_gap = ref_mesh.match_nodes(mesh.nodes, inputs["nodes"])
    worst = dict(relres=float("inf"), vm_gap=float("inf"))
    if perm is not None and kept:
        worst = dict(relres=0.0, vm_gap=0.0)
        m = config["material"]
        el = elastic.Elasticity(mesh, m["E"], m["nu"], device)
        clamp = torch.as_tensor(mesh.nodes[:, 0] <= 1e-9, device=device)
        free = (~clamp).to(torch.float64)[:, None]
        perm_t = torch.as_tensor(perm, device=device)
        for meta, out in kept:
            u = torch.empty_like(out["u"], device=device)
            u[perm_t] = out["u"].to(device)
            b = el.traction_load(traction(meta["params"])) * free
            r = b - el.apply(u) * free
            rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
            vm = el.von_mises(u)
            gap = float((out["vm"].to(device) - vm).abs().max() / vm.max())
            for k, v in (("relres", rel), ("vm_gap", gap)):
                worst[k] = max(worst[k], v) if np.isfinite(v) else v
    limits = dict(LIMITS, relres=config["tol"])
    values = dict(worst, node_gap=node_gap)
    return {k: {"value": _num(values[k]), "limit": limits[k]}
            for k in ("node_gap", "relres", "vm_gap")}
