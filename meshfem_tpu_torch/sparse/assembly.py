"""Host-side CSR export of per-element matrices (counterpart of
``meshfem_tpu/sparse/assembly.py::assemble_scipy``).

numpy and scipy on the host, float64: the structured multigrid builds its
27-node cube matrix and its coarse P1 matrices with it
(``ops/structured.py``, ``ops/structured_mg.py``).
"""

from __future__ import annotations

import numpy as np


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
