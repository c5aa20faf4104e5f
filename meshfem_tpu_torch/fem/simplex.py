"""K-simplex node counts and GMSH-consistent edge order.

Counterpart of ``meshfem_tpu/fem/simplex.py`` (reference ``Simplex.hh``):
FEM nodes are ordered vertices first, then edge nodes; edge ``i`` runs from
``EDGE_START_NODE[i]`` to ``EDGE_END_NODE[i]``.
"""

from __future__ import annotations

EDGE_START_NODE = (0, 1, 2, 0, 2, 1)
EDGE_END_NODE = (1, 2, 0, 3, 3, 3)


def num_vertices(K: int) -> int:
    return K + 1


def num_edges(K: int) -> int:
    return (K * (K + 1)) // 2


def num_nodes(K: int, deg: int) -> int:
    """Number of Lagrange nodes of a degree-``deg`` K-simplex element."""
    if K == 1:
        return deg + 1
    if K == 2:
        return ((deg + 1) * (deg + 2)) // 2
    if K == 3:
        return ((deg + 1) * (deg + 2) * (deg + 3)) // 6
    raise ValueError("Simplex dimension must be 1, 2, or 3")


def simplex_edges(K: int) -> list[tuple[int, int]]:
    """Vertex pairs of the K-simplex's edges in GMSH edge order."""
    return [(EDGE_START_NODE[i], EDGE_END_NODE[i]) for i in range(num_edges(K))]
