"""Material field optimization: fit per-element moduli to target boundary
displacements (counterpart of
``meshfem_tpu/analysis/material_optimization.py``).

Parity with the reference's ``MaterialOptimization.hh`` (objective
1/2 int_dO ||u - t||^2 dA, ``:4-11``; adjoint solve and per-element dK/dvar
contraction, ``:294-338``; the optimizer loop ``:340-394``).  The adjoint
is the implicit-function solve (``solvers/implicit.py``) and autograd; the
optimizer is Adam, written out with optax's defaults.

The forward matvec ``scatter(Ke gather(u))`` runs on the differentiable
pair of ``sparse/scatter.py``: the gather is kernel A and the scatter
kernel B on the card (float64 rows, 3 values a node), and the gradient in
``Ke`` runs B's adjoint, kernel A, on the adjoint solution.  The problem
lives on ``device`` (the CUDA device by default, or ``load``'s).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..fem import elasticity_tensor as et
from ..fem import shape_functions as sf
from ..mesh.femmesh import FEMMesh
from ..ops import element_matrices as em
from ..solvers import cg as cg_mod
from ..solvers.implicit import solve_implicit
from ..sparse.scatter import ScatterPlan

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


@dataclasses.dataclass
class MaterialOptimizationProblem:
    """Differentiable forward model u(E_field) and L2 boundary objective."""

    mesh: FEMMesh
    poisson: float
    fixed_mask: np.ndarray        # [N, d] bool
    fixed_values: np.ndarray      # [N, d]
    load: object                  # [N, d]
    target_nodes: np.ndarray      # boundary nodes with target displacements
    target_values: object         # [len(target_nodes), d]
    bounds: tuple = (0.1, 10.0)   # reference variable bounds
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        self.device = config.device_for(self.device, self.load)
        dev = self.device
        self.load = torch.as_tensor(self.load, dtype=config.REAL, device=dev)
        self.geom = mesh.geometry(dev)
        self.plan = ScatterPlan.build(mesh.elem_nodes.reshape(-1),
                                      mesh.num_nodes, dev)
        self.gather = self.plan.adjoint     # kernel A, B's adjoint
        # boundary mass weights of the L2 objective, lumped over the
        # target region (host, float64)
        w = np.zeros(mesh.num_nodes)
        wgt = sf.integrated_shape_np(mesh.K - 1, mesh.degree)
        bv = self.geom.bdry_volume.cpu().numpy()
        np.add.at(w, mesh.bdry_elem_nodes.reshape(-1),
                  (bv[:, None] * wgt[None, :]).reshape(-1))
        mask = np.zeros(mesh.num_nodes, dtype=bool)
        mask[self.target_nodes] = True
        self.area_weight = torch.as_tensor(np.where(mask, w, 0.0),
                                           device=dev)
        tv = np.zeros((mesh.num_nodes, mesh.dim))
        tv[self.target_nodes] = np.asarray(
            torch.as_tensor(self.target_values).cpu())
        self.target_field = torch.as_tensor(tv, device=dev)

    def displacement(self, young, tol: float = 1e-10, M_inv=None):
        """Differentiable forward solve u(young [E]).  ``M_inv``: optional
        preconditioner (the grid multigrid V-cycle rebuilt per step: the
        gradient does not depend on it, by the implicit function
        theorem)."""
        mesh = self.mesh
        d = mesh.dim
        dev = self.device
        young = torch.as_tensor(young, dtype=config.REAL, device=dev)
        D = et.isotropic(d, young, torch.full_like(young, self.poisson))
        Ke = em.element_elasticity(self.geom.grad_lambda, self.geom.volume,
                                   D, mesh.degree)
        n = mesh.nodes_per_elem
        E_ = mesh.num_elements
        fixed = torch.as_tensor(np.asarray(self.fixed_mask), device=dev)
        u_d = torch.where(fixed, torch.as_tensor(
            np.asarray(self.fixed_values, np.float64), device=dev), 0.0)

        def matvec(u):
            ue = self.gather(u).reshape(E_, n * d)
            fe = torch.einsum("eij,ej->ei", Ke, ue)
            return self.plan(fe.reshape(E_ * n, d))

        project = cg_mod.mask_projector(~fixed)
        b = self.load - matvec(u_d)
        z = solve_implicit(matvec, b, params=(Ke,), project=project,
                           tol=tol, M_inv=M_inv)
        return z + u_d

    def objective(self, young, M_inv=None):
        """1/2 int_target ||u - t||^2 dA."""
        u = self.displacement(young, M_inv=M_inv)
        diff = u - self.target_field
        return 0.5 * torch.sum(self.area_weight[:, None] * diff * diff)

    def gradient(self, young):
        young = torch.as_tensor(young, dtype=config.REAL,
                                device=self.device)
        with torch.enable_grad():
            y = young.detach().requires_grad_(True)
            g, = torch.autograd.grad(self.objective(y), y)
        return g


def _clip(x, lo, hi):
    """``jnp.clip``: min(hi, max(lo, x)); a value on a bound passes half
    its gradient, as JAX's max and min split a tie."""
    return torch.minimum(torch.full_like(x, hi),
                         torch.maximum(torch.full_like(x, lo), x))


class _Adam:
    """``optax.adam(lr)`` with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0): bias-corrected moments, update -lr m_hat / (sqrt(v_hat) +
    eps)."""

    def __init__(self, lr, like):
        self.lr = lr
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def step(self, theta, g):
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * g * g + ADAM_B2 * self.nu
        self.count += 1
        mu_hat = self.mu / (1 - ADAM_B1 ** self.count)
        nu_hat = self.nu / (1 - ADAM_B2 ** self.count)
        return theta + (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))


def optimize(problem: MaterialOptimizationProblem, young0, *,
             steps: int = 50, learning_rate: float = 0.1,
             verbose: bool = False, precond: str = "jacobi"):
    """Projected-Adam loop in log space (the reference's optax Adam; the
    C++ reference uses OPT++ LBFGS / gradient descent,
    ``MaterialOptimization.hh:340-394``).  ``precond="jacobi"`` solves
    unpreconditioned, as the reference does under that name;
    ``precond="multigrid"`` (Kuhn grids, dim 3) rebuilds the
    variable-material V-cycle (``VarStructuredMG``) from the current field
    each step and passes it into the differentiated solve.  Returns (young
    [E], objective history)."""
    lo, hi = problem.bounds
    dev = problem.device
    theta = torch.log(torch.as_tensor(young0, dtype=config.REAL,
                                      device=dev))
    opt = _Adam(learning_rate, theta)
    history = []
    make_M_inv = (lambda th: None)
    if precond == "multigrid":
        from ..ops.structured_mg import VarStructuredMG

        mesh = problem.mesh

        def make_M_inv(th):
            young = _clip(torch.exp(th), lo, hi)
            D = et.isotropic(mesh.dim, young,
                             torch.full_like(young, problem.poisson))
            mg = VarStructuredMG.build(
                mesh, D, fixed_mask=torch.as_tensor(problem.fixed_mask),
                device=dev)
            return lambda r: mg.fine.from_channels(
                mg.precondition(mg.fine.to_channels(r)))

    for it in range(steps):
        M_inv = make_M_inv(theta)
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            val = problem.objective(_clip(torch.exp(th), lo, hi),
                                    M_inv=M_inv)
            g, = torch.autograd.grad(val, th)
        theta = opt.step(theta, g)
        history.append(float(val.detach()))
        if verbose and it % 10 == 0:
            print(f"material-opt it {it}: J = {history[-1]:.6e}")
    return _clip(torch.exp(theta), lo, hi), history
