"""Jobs and judge of ``periodic_homog_p2``: one ``homogenize`` call a
job on the cell the traffic builds, with the job's base material, through
the port's user entry (``analysis.homogenization.homogenize`` with its
defaults: a periodic simulator, the routed block CG at six columns inside
float64 refinement, the stress-form tensor), judged by the plain
reference in ``fembench/reference``.

Each call pays its own builds (periodic matching, ``Ke``, kernel E, the
routed operator), as every user call does; only the mesh is built once
in set-up.

The judge reads, for each sampled job, the port's P2 node positions, the
six fluctuation fields and the tensor, and compares:

* ``node_gap``: as in ``clamped_elasticity_p2``;
* ``relres``: the float64 relative residual of the six cell problems
  together under the reference's operator, loads and identification,
  translations projected out, the configuration's ``tol``; the operator
  reads every node's field value and sums the forces into the
  reference's periodic dofs, so fields that differ at nodes the
  reference identifies show here;
* ``ch_gap``: the largest gap between the port's tensor and the
  reference's stress-form tensor of the same fields, over its largest
  entry.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from fembench import traffic as traffic_mod
from fembench.job import Job
from fembench.reference import elastic, mesh as ref_mesh

JOB_METRIC = "homog_s"
LIMITS = {"node_gap": 1e-10, "ch_gap": 1e-9}


class Problem:
    JOB_METRIC = JOB_METRIC
    JOB_KIND = "homog"

    def __init__(self, config, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device

    def setup(self, timings):
        from meshfem_tpu_torch.mesh import FEMMesh
        from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

        self.V, self.T = traffic_mod.make_mesh(self.traffic["mesh"])
        t0 = time.perf_counter()
        self.mesh = FEMMesh(self.V, self.T, degree=self.config["degree"])
        timings["mesh_s"] = time.perf_counter() - t0
        # the path guard's count of block applies by their column count
        self.block_columns = {}
        original = RoutedEBE.apply_block

        def counted(op, U, *args, **kw):
            m = int(U.shape[-1])
            self.block_columns[m] = self.block_columns.get(m, 0) + 1
            return original(op, U, *args, **kw)

        RoutedEBE.apply_block = counted
        self._undo = lambda: setattr(RoutedEBE, "apply_block", original)

    def job(self, params) -> Job:
        from meshfem_tpu_torch.analysis.homogenization import homogenize
        from meshfem_tpu_torch.physics import Material

        self.block_columns.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = homogenize(self.mesh,
                             Material.isotropic(3, params["E"], params["nu"]),
                             tol=self.config["tol"],
                             precond=self.config["solve"]["precond"],
                             device=self.device)
        stalled = [str(c.message) for c in caught
                   if "stagnated" in str(c.message)]
        return Job({"w": res.w, "Ch": res.Ch}, int(res.cg_iters[0]), {},
                   dict(block_columns=dict(self.block_columns),
                        stalled=stalled, cuda=res.Ch.is_cuda))

    def guard(self, job: Job):
        ev = job.evidence
        if ev["stalled"]:
            return ev["stalled"][0]
        if self.traffic["path"] != "routed_block":
            return f"unknown path {self.traffic['path']!r}"
        cols = ev["block_columns"]
        if not (set(cols) == {6} and 0 < job.iters <= cols[6]):
            return (f"{job.iters} block iterations but block applies by "
                    f"column count {cols}")
        return None

    def release(self):
        inputs = dict(V=self.V, T=self.T,
                      nodes=np.array(self.mesh.node_positions))
        self._undo()
        del self.mesh
        return inputs


def control(problem, params, maxiter=3000):
    """The control: the reference in the program's place, every step in
    float32 (P2 nodes, periodic identification, Jacobi block CG to
    ``tol``, fields and tensor); the float32 CG stops at ``maxiter``.
    Returns (outputs, the float32 reference's P2 nodes)."""
    f32, dev = torch.float32, problem.device
    mesh = ref_mesh.p2_mesh(problem.V.astype(np.float32), problem.T,
                            dtype=np.float32)
    dof, nd = ref_mesh.periodic_dofs(mesh.nodes)
    el = elastic.Elasticity(mesh, params["E"], params["nu"], dev, dtype=f32,
                            dof=dof, num_dofs=nd)
    P = elastic.project_translations
    X, _ = elastic.pcg(lambda v: P(el.apply(v)), el.cell_loads(),
                       el.diagonal(), project=P, tol=problem.config["tol"],
                       maxiter=maxiter)
    w = X.permute(2, 0, 1)[:, el.dof]
    w = w - w.mean(dim=1, keepdim=True)
    return ({"w": w.double(), "Ch": el.homogenized_tensor(w).double()},
            mesh.nodes.astype(np.float64))


def _num(x):
    x = float(x)
    return x if np.isfinite(x) else str(x)


def judge(config, traffic, inputs, kept, device):
    mesh = ref_mesh.p2_mesh(inputs["V"], inputs["T"])
    perm, node_gap = ref_mesh.match_nodes(mesh.nodes, inputs["nodes"])
    names = ("relres", "ch_gap")
    worst = dict.fromkeys(names, float("inf"))
    if perm is not None and kept:
        worst = dict.fromkeys(names, 0.0)
        dof, nd = ref_mesh.periodic_dofs(mesh.nodes, config["cell"]["min"][0],
                                         config["cell"]["max"][0])
        perm_t = torch.as_tensor(perm, device=device)
        P = elastic.project_translations
        for meta, out in kept:
            p = meta["params"]
            el = elastic.Elasticity(mesh, p["E"], p["nu"], device, dof=dof,
                                    num_dofs=nd)
            w = torch.empty_like(out["w"], device=device)
            w[:, perm_t] = out["w"].to(device)
            B = P(el.cell_loads())
            R = B - P(el.to_dofs(el.apply_nodes(w.permute(1, 2, 0))))
            rel = float(torch.linalg.norm(R) / torch.linalg.norm(B))
            Ch = el.homogenized_tensor(w)
            gap = float((out["Ch"].to(device) - Ch).abs().max()
                        / Ch.abs().max())
            for k, v in zip(names, (rel, gap)):
                worst[k] = max(worst[k], v) if np.isfinite(v) else v
    limits = dict(LIMITS, relres=config["tol"])
    values = dict(worst, node_gap=node_gap)
    return {k: {"value": _num(values[k]), "limit": limits[k]}
            for k in ("node_gap",) + names}
