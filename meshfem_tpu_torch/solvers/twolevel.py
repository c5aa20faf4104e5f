"""P1-coarse two-level preconditioner for unstructured P2 meshes.

Counterpart of ``meshfem_tpu/solvers/twolevel.py``.  Matrix-free CG pays
O(sqrt(kappa)) iterations, which explodes on high-contrast material fields;
the textbook two-level method restores bounded iteration counts, built on a
fact special to degree-2 spaces: P1 on the same mesh is exactly nested in
P2 (every P2 edge node is its edge's midpoint), so linear interpolation is
exact and the Galerkin coarse operator is the P1 stiffness.

* transfers: prolongation ``u2[dof] = (u1[cA] + u1[cB]) / 2`` where cA / cB
  are the coarse dofs of the endpoint vertices of the dof's node (a vertex
  node is its own both endpoints): ONE launch of kernel A in node rows
  (``gather_rows`` on the ``2 ND`` endpoint ids), float32 or float64, any
  number of columns.  Restriction, the adjoint, sums the ``2 ND`` halves
  into the ``NC`` coarse dofs through a ``ScatterPlan`` built once: kernel
  B in rows, in a fixed order, with no float atomics (the reference's
  ``jax.ops.segment_sum`` pair);
* coarse matrix: the host Galerkin triple product ``P^T A P`` on the
  scipy-assembled fine operator (``sim.to_scipy()``; exact for any
  material field, periodic dof identification included), masked to the
  Dirichlet-free subspace or shifted by a relative 1e-10, factorized once
  with SuperLU.  The coarse solve copies the coarse residual to the host,
  solves in float64 and copies the correction back: that is the
  reference's own design (its ``jax.pure_callback``), not a fallback;
* smoother: exact per-node d x d block Jacobi;
* modes: ``additive`` (B = S + P Ac^-1 R, no extra operator applies per
  application) and ``multiplicative`` (pre- and post-smoothed symmetric
  cycle, 2 extra fine applies per application, the smoother damped by
  1 / lam_max(S A) from a power iteration).

Both variants are fixed linear SPD maps, hence valid plain-CG
preconditioners.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels import gather_rows
from ..sparse.scatter import ScatterPlan
from . import precond as pc


def p2_vertex_endpoints(mesh):
    """[N, 2] endpoint VERTEX ids for every P2 node (vertex nodes repeat
    themselves)."""
    if mesh.degree != 2:
        raise ValueError("two-level preconditioner requires a P2 mesh")
    return mesh.node_endpoint_vertices()


class TwoLevel:
    """Two-level preconditioner; use :meth:`M_inv` inside ``cg`` /
    ``cg_block``.  Vectors are [ND, d] or [ND, d, m] in the fine dof order
    given at build (``node_order``)."""

    def __init__(self, ids_ab, plan, n_coarse, lu_solve, base_smoother,
                 mode, apply_A=None, project=None, damping=1.0):
        self.ids_ab = ids_ab          # [2 ND] int32: cA then cB
        self.plan = plan              # 2 ND halves -> NC coarse dofs
        self.n_coarse = int(n_coarse)
        self._lu_solve = lu_solve
        self.base_smoother = base_smoother
        self.mode = mode
        self.apply_A = apply_A
        self.project = project or (lambda v: v)
        self.damping = float(damping)  # 1 / lam_max(S A) when multiplicative
        self.timings = {}             # host seconds of the build's parts

    # -- build ----------------------------------------------------------
    @classmethod
    def from_simulator(cls, sim, mode: str = "additive",
                       free_mask=None, project=None,
                       node_order=None, apply_A=None) -> "TwoLevel":
        """sim: ElasticitySimulator (any dof map, periodic included).

        ``free_mask [num_dofs, d]`` (True = free) masks the coarse matrix
        to the Dirichlet-free subspace; without one (periodic or pure
        Neumann problems) the coarse matrix is regularized by a relative
        1e-10 diagonal shift (the outer CG's projector owns the
        nullspace).  ``node_order [num_dofs]``: when the outer solve runs
        in a PERMUTED dof order (the routed operator's internal order,
        ``RoutedEBE.order``), the fine-side transfer indices and smoother
        blocks follow it; the coarse side is order-free.  ``apply_A``
        overrides the fine operator of the multiplicative cycle (the
        routed operator in its own order)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        t_start = time.perf_counter()
        mesh = sim.mesh
        d = sim.dim
        ND = sim.num_dofs
        dev = sim.device
        dof_map = np.asarray(sim.dof_map)

        # endpoint vertices per node -> per dof (through a representative
        # node; periodic identification maps edges consistently)
        ep = p2_vertex_endpoints(mesh)
        first = np.zeros(ND, np.int64)
        uniq_dofs, firsts = np.unique(dof_map, return_index=True)
        first[uniq_dofs] = firsts
        epd = ep[first]                                  # [ND, 2] vertices
        # coarse space: the unique dofs carried by vertices
        vdofs = dof_map[np.asarray(mesh.vertex_nodes)]
        cuniq, cidx = np.unique(vdofs, return_inverse=True)
        NC = len(cuniq)
        cA = cidx[epd[:, 0]]
        cB = cidx[epd[:, 1]]

        # Galerkin coarse matrix on the host (exact, material-agnostic)
        t0 = time.perf_counter()
        A2 = sim.to_scipy().tocsr()
        rows = np.repeat(np.arange(ND * d), 2)
        cols = np.stack([cA[:, None] * d + np.arange(d),
                         cB[:, None] * d + np.arange(d)],
                        axis=-1).reshape(-1)
        vals = np.full(2 * ND * d, 0.5)
        P = sp.coo_matrix((vals, (rows, cols)),
                          shape=(ND * d, NC * d)).tocsr()
        Ac = (P.T @ A2 @ P).tocsc()
        if free_mask is not None:
            fm_np = np.asarray(torch.as_tensor(free_mask).cpu().numpy(),
                               np.float64)
            m = fm_np.reshape(ND, d)[cuniq].reshape(-1)
            M = sp.diags(m)
            Ac = (M @ Ac @ M + sp.diags(1.0 - m)).tocsc()
        else:
            shift = 1e-10 * float(Ac.diagonal().mean())
            Ac = (Ac + shift * sp.eye(NC * d)).tocsc()
        t_galerkin = time.perf_counter() - t0
        t0 = time.perf_counter()
        lu = spla.splu(Ac)
        t_splu = time.perf_counter() - t0

        def lu_solve(r):
            """Host float64 solve of a [NC, d(, m)] numpy array."""
            return lu.solve(r.reshape(NC * d, -1)).reshape(r.shape)

        blocks = pc.node_block_diagonal(sim.Ke, sim.elem_dofs, ND, d)
        fm = None if free_mask is None else torch.as_tensor(
            free_mask, device=dev)
        if node_order is not None:
            order = np.asarray(node_order)
            cA = cA[order]
            cB = cB[order]
            order_t = torch.as_tensor(order, device=dev)
            blocks = blocks[order_t]
            if fm is not None:
                fm = fm[order_t]
        base = pc.block_jacobi_apply(pc.block_jacobi_inv(
            blocks, None if fm is None else fm.to(blocks.dtype)))

        ids_ab = torch.as_tensor(np.concatenate([cA, cB]).astype(np.int32),
                                 device=dev)
        # each fine dof k contributes its half twice, to cA[k] and cB[k]:
        # the plan's rows 2 ND renumbered k -> k mod ND read r's own rows
        plan = ScatterPlan.build(np.concatenate([cA, cB]), NC, dev) \
            .renumbered(torch.arange(2 * ND, device=dev) % ND)

        if mode != "multiplicative":
            apply_A = None
        elif apply_A is None:
            if node_order is not None:
                raise ValueError(
                    "multiplicative + node_order needs an apply_A in the "
                    "permuted ordering")
            apply_A = sim.apply_K
        tl = cls(ids_ab, plan, NC, lu_solve, base, mode, apply_A, project)
        t_lam = 0.0
        if mode == "multiplicative":
            # the multiplicative cycle needs a CONTRACTIVE smoother
            # (rho(I - S A) < 1): damp block Jacobi by 1/lam_max(S A),
            # estimated in the operator's own dtype (the routed operator
            # is float32)
            t0 = time.perf_counter()
            proj = tl.project
            est_dt = sim.Ke.dtype if node_order is None else torch.float32
            lam = pc.estimate_lambda_max(
                lambda v: proj(apply_A(v)), lambda r: proj(base(r)),
                (ND, d), dtype=est_dt, iters=25, device=dev)
            tl.damping = 1.0 / lam
            t_lam = time.perf_counter() - t0
        tl.timings = dict(galerkin_s=t_galerkin, splu_s=t_splu,
                          lambda_s=t_lam, coarse_dofs=NC * d,
                          coarse_nnz=int(Ac.nnz),
                          total_s=time.perf_counter() - t_start)
        return tl

    # -- the pieces -------------------------------------------------------
    def smoother(self, r):
        z = self.base_smoother(r)
        return z * self.damping if self.mode == "multiplicative" else z

    def prolong(self, uc):
        """[NC, d(, m)] -> [ND, d(, m)]: one kernel A launch on the
        endpoint ids, then the midpoint average."""
        ND = self.ids_ab.shape[0] // 2
        rows = gather_rows(uc.reshape(self.n_coarse, -1).contiguous(),
                           self.ids_ab)
        return (0.5 * (rows[:ND] + rows[ND:])).reshape(
            (ND,) + tuple(uc.shape[1:]))

    def restrict(self, r):
        """Adjoint of :meth:`prolong`: [ND, d(, m)] -> [NC, d(, m)], kernel
        B over the ``2 ND`` halves."""
        half = (0.5 * r).reshape(r.shape[0], -1).contiguous()
        return self.plan.sum_rows(half).reshape(
            (self.n_coarse,) + tuple(r.shape[1:]))

    def coarse_solve(self, rc):
        """Host SuperLU in float64: rc is copied to the host and the
        correction back, in rc's dtype."""
        x = self._lu_solve(rc.cpu().numpy().astype(np.float64))
        return torch.as_tensor(x, dtype=rc.dtype, device=rc.device)

    def M_inv(self, r):
        """The preconditioner application (linear, symmetric)."""
        proj = self.project
        if self.mode == "additive":
            xc = self.coarse_solve(self.restrict(r))
            return proj(self.smoother(r) + self.prolong(xc))
        x = proj(self.smoother(r))
        res = r - proj(self.apply_A(x))
        xc = self.coarse_solve(self.restrict(res))
        x = x + proj(self.prolong(xc))
        return x + proj(self.smoother(r - proj(self.apply_A(x))))
