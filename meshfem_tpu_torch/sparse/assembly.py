"""Assembly of per-element matrices and loads into global quantities
(counterpart of ``meshfem_tpu/sparse/assembly.py``).

* ``ebe_apply``, ``ebe_apply_vector``, ``ebe_diagonal`` (reference :22-60)
  and ``scatter_load`` (:63): element-by-element applies and load sums on
  the device.  The reference sums with ``jax.ops.segment_sum``; here every
  sum runs through a ``ScatterPlan``, kernel B on the card: a fixed
  summation order and no float atomics, where ``index_add_`` on CUDA
  would use them.  Each call builds its plan from ``elem_nodes`` on the
  host; an operator applied many times keeps one (``sparse/ebe.py``).
* ``assemble_scipy``: host-side CSR export, numpy and scipy in float64
  (the structured multigrid's cube and coarse P1 matrices,
  ``ops/structured.py``, ``ops/structured_mg.py``; ``to_scipy``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ebe import EBEKernel
from .scatter import ScatterPlan


def host_ids(elem_nodes) -> np.ndarray:
    if isinstance(elem_nodes, torch.Tensor):
        elem_nodes = elem_nodes.cpu().numpy()
    return np.asarray(elem_nodes, dtype=np.int64)


def ebe_apply(Ke, elem_nodes, u, num_nodes: int):
    """Matrix-free A @ u for scalar dofs: Ke [E, n, n], elem_nodes [E, n],
    u [N] or [N, m]."""
    return EBEKernel.build(Ke, host_ids(elem_nodes), num_nodes)(u)


def ebe_apply_vector(Ke, elem_nodes, u, num_nodes: int):
    """Matrix-free A @ u for vector dofs: Ke [E, n*d, n*d] (dof ``local_node
    * d + component``), u [N, d] -> [N, d]."""
    d = Ke.shape[-1] // elem_nodes.shape[1]
    return EBEKernel.build(Ke, host_ids(elem_nodes), num_nodes, d)(u)


def ebe_diagonal(Ke, elem_nodes, num_nodes: int, d: int = 1):
    """Diagonal of the assembled operator: [N] (d = 1) or [N, d]."""
    return EBEKernel.build(Ke, host_ids(elem_nodes), num_nodes,
                           d).diagonal()


def scatter_load(fe, elem_nodes, num_nodes: int):
    """Sum per-element nodal loads fe [E, n] or [E, n, d] into [N(, d)] on
    fe's device."""
    plan = ScatterPlan.build(host_ids(elem_nodes).reshape(-1), num_nodes,
                             fe.device)
    return plan(fe.reshape((-1,) + tuple(fe.shape[2:])))


def assemble_scipy(Ke, elem_nodes, num_nodes: int, d: int = 1):
    """Assemble a scipy CSR matrix from element matrices ``Ke [E, n*d,
    n*d]`` (host, f64).  For d > 1 the global DOF layout is node-major:
    dof = node * d + comp."""
    import scipy.sparse as sp

    Ke = np.asarray(Ke)
    elem_nodes = np.asarray(elem_nodes)
    E, n = elem_nodes.shape
    nd = n * d
    dofs = (elem_nodes[:, :, None] * d
            + np.arange(d)[None, None, :]).reshape(E, nd)
    rows = np.repeat(dofs, nd, axis=1).ravel()
    cols = np.tile(dofs, (1, nd)).ravel()
    A = sp.coo_matrix((Ke.ravel(), (rows, cols)),
                      shape=(num_nodes * d, num_nodes * d))
    return A.tocsr()
