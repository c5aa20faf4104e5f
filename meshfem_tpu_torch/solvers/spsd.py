"""SPSDSystem facade (counterpart of ``meshfem_tpu/solvers/spsd.py``): the
reference's constrained-solve orchestrator (``SparseMatrices.hh:2298-2718``:
``setConstrained``, ``fixVariables``, ``solve``) over projection-PCG, with
a host direct solve for small assembled systems.

Constraints become projections, so the operator stays SPD:

* ``fix_variables(vars, values)``: Dirichlet elimination (mask projection);
* ``set_constrained(C, rhs)``: affine constraints C u = c, by projecting
  onto null(C) plus a particular solution;
* one system solves many right-hand sides.

A scipy matrix is applied on the host (the reference wraps it in
``jax.pure_callback`` to run under its traced loop; here the CG loop is
Python, so the call is direct).  A block of right-hand sides [n, m] goes
through the operator as one block apply where the operator takes one (an
``EBEKernel`` or ``EBEOperator`` of a scalar field), and column by column
otherwise (the reference vmaps it).  The system lives on ``device`` (the
CUDA device by default).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import cg as cg_mod


class SPSDSystem:
    """Constrained SPSD solver over a matrix-free operator (or scipy CSR)."""

    def __init__(self, A, n: int | None = None, M_inv=None, *,
                 device=None):
        """A: callable [n] -> [n] (flat dof vectors) or a scipy sparse
        matrix."""
        from ..ops.operators import EBEOperator
        from ..sparse.ebe import EBEKernel

        self.device = config.resolve_device(device)
        if callable(A):
            if n is None:
                raise ValueError("matrix-free SPSDSystem needs n")
            self._apply = A
            self.n = n
            self._scipy = None
        else:
            self._scipy = A.tocsr()
            self.n = A.shape[0]
            self._apply = self._scipy_apply
        self._block = (isinstance(A, (EBEKernel, EBEOperator))
                       and A.vector_dim == 1)
        self._M_inv = M_inv
        self._fixed = np.zeros(self.n, dtype=bool)
        self._fixed_values = np.zeros(self.n)
        self._C = None          # [k, n] constraint matrix
        self._c_rhs = None
        self._null_proj = None

    def _scipy_apply(self, u):
        x = u.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(self._scipy @ x, dtype=x.dtype),
                               device=u.device)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=config.REAL, device=self.device)

    # -- constraint API (reference names) --------------------------------
    def fix_variables(self, vars, values) -> None:
        vars = np.asarray(vars)
        self._fixed[vars] = True
        self._fixed_values[vars] = np.broadcast_to(values, vars.shape)

    def set_constrained(self, C, rhs=None) -> None:
        """Add affine constraints C u = rhs (default 0): homogeneous ones
        become a nullspace projection, inhomogeneous ones add a particular
        solution by least squares."""
        C = np.atleast_2d(np.asarray(C))
        self._C = C if self._C is None else np.vstack([self._C, C])
        r = np.zeros(C.shape[0]) if rhs is None else np.asarray(rhs)
        self._c_rhs = r if self._c_rhs is None else \
            np.concatenate([self._c_rhs, r])
        self._null_proj = None

    # -- solve ------------------------------------------------------------
    def _basis(self):
        """Orthonormal basis of range(C^T) on the device, or None."""
        if self._C is None:
            return None
        if self._null_proj is None:
            Q, _ = np.linalg.qr(self._C.T)
            self._null_proj = self._tensor(Q)
        return self._null_proj

    def particular_solution(self):
        u = np.where(self._fixed, self._fixed_values, 0.0)
        if self._C is not None and np.any(self._c_rhs != 0):
            up, *_ = np.linalg.lstsq(self._C, self._c_rhs, rcond=None)
            u = u + up
        return self._tensor(u)

    def solve(self, b, tol: float = 1e-12, maxiter: int = 100000,
              direct: bool = False):
        """Solve the constrained system for b [n] (or a block [n, m])."""
        b = self._tensor(b)
        if direct or (self._scipy is not None and self.n <= 20000):
            return self._solve_direct(b)
        multi = b.dim() == 2
        free = self._tensor(~self._fixed)
        mask = free[:, None] if multi else free
        Q = self._basis()

        def proj(v):
            v = v * mask
            if Q is not None:
                v = v - Q @ (Q.T @ v)   # [n, k] @ [k, (m)]: a block too
                v = v * mask
            return v

        u_p = self.particular_solution()
        if not multi:
            Ap = self._apply
            rhs = b - Ap(u_p)
        elif self._scipy is not None:
            Ap = self._scipy_apply
            rhs = b - Ap(u_p[:, None].expand(b.shape))
        else:
            if self._block:
                Ap = self._apply
            else:
                def Ap(V):
                    return torch.stack([self._apply(V[:, j])
                                        for j in range(V.shape[1])], dim=1)
            rhs = b - self._apply(u_p)[:, None]
        res = cg_mod.cg(Ap, rhs, M_inv=self._M_inv, project=proj, tol=tol,
                        maxiter=maxiter)
        return res.x + (u_p[:, None] if multi else u_p)

    def _solve_direct(self, b):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        A = self._scipy
        if A is None:
            raise ValueError("direct solve requires an assembled matrix")
        n = self.n
        bh = b.cpu().numpy()
        if self._C is not None:
            # KKT system [A C'; C 0] like the reference's Lagrange path
            C = sp.csr_matrix(self._C)
            K = sp.bmat([[A, C.T], [C, None]], format="csr").tolil()
            bfull = np.concatenate([bh, self._c_rhs])
        else:
            K = A.tolil()
            bfull = bh.copy()
        for i in np.flatnonzero(self._fixed):
            K.rows[i] = [i]
            K.data[i] = [1.0]
            bfull[i] = self._fixed_values[i]
        x = spla.spsolve(K.tocsc(), bfull)
        return self._tensor(np.asarray(x)[:n])
