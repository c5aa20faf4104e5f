"""Simplicial mesh connectivity as flat index arrays.

Counterpart of ``meshfem_tpu/mesh/simplicial.py``:

* ``TriMesh``, a corner table: half-edge ``h = 3 f + c`` is the edge of face
  ``f`` opposite corner ``c``, oriented CCW (tail = corner c+1, tip = corner
  c+2); ``O[h]`` is the mate half-edge or ``-2 - b`` for boundary edge
  ``b``;
* ``TetMesh``, half-faces: ``hf = 4 t + c`` is the face of tet ``t``
  opposite corner ``c``; ``O[hf]`` is the mate half-face or ``-1 - b`` for
  boundary face ``b``.

Faces are matched by the numpy lexsort of the reference's fallback
(``simplicial.py:40-58``); the reference's native host core gives the same
pairing on manifold meshes, so boundary edges and faces come out in the
reference's order (increasing half-entity index), wound outward.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fem import simplex
from .geometry import BBox

# Outward-oriented faces of a positively oriented element, opposite vertex i.
TRI_FACE_CORNERS = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int64)
TET_FACE_CORNERS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int64)


def _match_faces(face_verts: np.ndarray) -> np.ndarray:
    """Pair half-entities with identical vertex sets: [H, k] -> opposite
    [H] (-1 where unmatched)."""
    H = face_verts.shape[0]
    key = np.sort(face_verts, axis=1)
    order = np.lexsort(key.T[::-1])
    sk = key[order]
    same_as_next = np.all(sk[:-1] == sk[1:], axis=1)
    if np.any(same_as_next[:-1] & same_as_next[1:]):
        raise ValueError("non-manifold: face shared by > 2 elements")
    opp = -np.ones(H, dtype=np.int64)
    idx = np.flatnonzero(same_as_next)
    a, b = order[idx], order[idx + 1]
    opp[a], opp[b] = b, a
    return opp


def _unique_edges(E: np.ndarray, pairs) -> np.ndarray:
    """[ne, 2] unique undirected edges (sorted pairs) of elements ``E``
    through their local vertex ``pairs``."""
    pairs = np.asarray(pairs)
    e = np.stack([E[:, pairs[:, 0]].ravel(), E[:, pairs[:, 1]].ravel()],
                 axis=1)
    return np.unique(np.sort(e, axis=1), axis=0)


@dataclasses.dataclass
class TriMesh:
    """Corner-table triangle mesh.  V: [n, dim] positions, F: [m, 3] CCW."""

    V: np.ndarray
    F: np.ndarray
    O: np.ndarray              # [3m] mate half-edge or -2 - bdry_edge_index
    VH: np.ndarray             # [n] one incident half-edge per vertex (or -1)
    bdry_halfedge: np.ndarray  # [nb] the interior half-edge along bdry edge b

    @classmethod
    def build(cls, V, F) -> "TriMesh":
        V = np.ascontiguousarray(V, dtype=np.float64)
        F = np.ascontiguousarray(F, dtype=np.int64)
        m = F.shape[0]
        # half-edge h = 3f + c: tail F[f, c+1], tip F[f, c+2]
        he_verts = np.stack([F[:, TRI_FACE_CORNERS[:, 0]].ravel(),
                             F[:, TRI_FACE_CORNERS[:, 1]].ravel()], axis=1)
        opp = _match_faces(he_verts)
        bdry_halfedge = np.flatnonzero(opp < 0)
        O = opp.copy()
        O[bdry_halfedge] = -2 - np.arange(len(bdry_halfedge))
        VH = -np.ones(len(V), dtype=np.int64)
        VH[he_verts[:, 0]] = np.arange(3 * m)     # the last half-edge out
        return cls(V, F, O, VH, bdry_halfedge)

    # -- handle arithmetic (vectorized over integer arrays) -------------
    def face(self, h):
        return np.asarray(h) // 3

    def corner(self, h):
        return np.asarray(h) % 3

    def tail(self, h):
        h = np.asarray(h)
        return self.F[h // 3, (h % 3 + 1) % 3]

    def tip(self, h):
        h = np.asarray(h)
        return self.F[h // 3, (h % 3 + 2) % 3]

    def opposite_vertex(self, h):
        h = np.asarray(h)
        return self.F[h // 3, h % 3]

    def next(self, h):
        h = np.asarray(h)
        return (h // 3) * 3 + (h % 3 + 1) % 3

    def prev(self, h):
        h = np.asarray(h)
        return (h // 3) * 3 + (h % 3 + 2) % 3

    def mate(self, h):
        """Opposite half-edge (``-2 - b`` on boundary edge ``b``)."""
        return self.O[np.asarray(h)]

    def is_boundary_halfedge(self, h):
        return self.O[np.asarray(h)] < 0

    def boundary_edge_index(self, h):
        return -2 - self.O[np.asarray(h)]

    # -- global queries ---------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return len(self.V)

    @property
    def num_faces(self) -> int:
        return len(self.F)

    @property
    def num_boundary_edges(self) -> int:
        return len(self.bdry_halfedge)

    def boundary_edges(self) -> np.ndarray:
        """[nb, 2] boundary edge vertices wound CCW (interior on the
        left)."""
        h = self.bdry_halfedge
        return np.stack([self.tail(h), self.tip(h)], axis=1)

    def boundary_vertices(self) -> np.ndarray:
        return np.unique(self.boundary_edges())

    def boundary_loops(self) -> list[np.ndarray]:
        """Ordered vertex loops of each boundary component, each started
        at its first vertex in boundary-edge order."""
        edges = self.boundary_edges()
        nxt = dict(zip(edges[:, 0].tolist(), edges[:, 1].tolist()))
        seen: set[int] = set()
        loops = []
        for start in edges[:, 0].tolist():
            if start in seen:
                continue
            loop = [start]
            seen.add(start)
            cur = nxt[start]
            while cur != start:
                loop.append(cur)
                seen.add(cur)
                cur = nxt[cur]
            loops.append(np.asarray(loop))
        return loops

    def vertex_face_adjacency(self):
        """CSR (offsets [n+1], faces) of the faces around each vertex, in
        face order."""
        v = self.F.ravel()
        f = np.repeat(np.arange(len(self.F)), 3)
        order = np.argsort(v, kind="stable")
        counts = np.bincount(v, minlength=len(self.V))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return offsets, f[order]

    def edges(self) -> np.ndarray:
        """[ne, 2] unique undirected edges (sorted pairs)."""
        return _unique_edges(self.F, TRI_FACE_CORNERS)

    def bbox(self) -> BBox:
        return BBox.of(self.V)


@dataclasses.dataclass
class TetMesh:
    """Half-face tet mesh.  V: [n, 3], T: [m, 4] positively oriented."""

    V: np.ndarray
    T: np.ndarray
    O: np.ndarray               # [4m] mate half-face or -1 - bdry_face_index
    bdry_halfface: np.ndarray   # [nb] interior half-face behind bdry face b

    @classmethod
    def build(cls, V, T) -> "TetMesh":
        V = np.ascontiguousarray(V, dtype=np.float64)
        T = np.ascontiguousarray(T, dtype=np.int64)
        m = T.shape[0]
        opp = _match_faces(T[:, TET_FACE_CORNERS].reshape(4 * m, 3))
        bdry_halfface = np.flatnonzero(opp < 0)
        O = opp.copy()
        O[bdry_halfface] = -1 - np.arange(len(bdry_halfface))
        return cls(V, T, O, bdry_halfface)

    def tet(self, hf):
        return np.asarray(hf) // 4

    def corner(self, hf):
        return np.asarray(hf) % 4

    def face_vertices(self, hf):
        """[..., 3] vertices of half-face(s), wound outward of their tet."""
        hf = np.asarray(hf)
        return np.take_along_axis(self.T[hf // 4], TET_FACE_CORNERS[hf % 4],
                                  axis=-1)

    def mate(self, hf):
        return self.O[np.asarray(hf)]

    def is_boundary_halfface(self, hf):
        return self.O[np.asarray(hf)] < 0

    def boundary_face_index(self, hf):
        return -1 - self.O[np.asarray(hf)]

    @property
    def num_vertices(self) -> int:
        return len(self.V)

    @property
    def num_tets(self) -> int:
        return len(self.T)

    @property
    def num_boundary_faces(self) -> int:
        return len(self.bdry_halfface)

    def boundary_faces(self) -> np.ndarray:
        """[nb, 3] boundary triangles wound outward."""
        return self.face_vertices(self.bdry_halfface)

    def boundary_vertices(self) -> np.ndarray:
        return np.unique(self.boundary_faces())

    def edges(self) -> np.ndarray:
        """[ne, 2] unique undirected edges (sorted pairs)."""
        return _unique_edges(self.T, simplex.simplex_edges(3))

    def bbox(self) -> BBox:
        return BBox.of(self.V)
