"""Half-face tetrahedral connectivity as flat index arrays.

Counterpart of ``TetMesh`` in ``meshfem_tpu/mesh/simplicial.py``: half-face
``hf = 4 t + c`` is the face of tet ``t`` opposite corner ``c``; ``O[hf]`` is
the mate half-face or ``-1 - b`` for boundary face ``b``.  Faces are matched
by the numpy lexsort of the reference's fallback (``simplicial.py:40-58``);
the reference's native host core gives the same pairing on manifold meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Outward-oriented faces of a positively oriented tet, opposite vertex i.
TET_FACE_CORNERS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int64)


def _match_faces(face_verts: np.ndarray) -> np.ndarray:
    """Pair half-faces with identical vertex sets: [H, k] -> opposite [H]
    (-1 where unmatched)."""
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

    def boundary_faces(self) -> np.ndarray:
        """[nb, 3] boundary triangles wound outward."""
        hf = self.bdry_halfface
        return np.take_along_axis(
            self.T[hf // 4], TET_FACE_CORNERS[hf % 4], axis=-1)
