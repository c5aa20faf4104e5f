"""Cache-locality orders: Morton codes, recursive coordinate bisection and
whole-mesh reordering (counterpart of ``meshfem_tpu/mesh/reorder.py``:
``_morton_codes`` :16, ``rcb_order`` :33, ``reorder_mesh`` :64).

``RoutedEBE`` sorts elements along RCB leaves of their centroids and numbers
nodes by first touch (``routed_ebe.py:449-470``); the port keeps that
ordering integer for integer, so this is the reference's algorithm call for
call (the same ``argpartition`` and stable sorts on the same inputs).
"""

from __future__ import annotations

import numpy as np


def _morton_codes(points, bits: int = 21) -> np.ndarray:
    """Interleaved-bit Z-order codes (uint64) of [n, d] points, d in (2, 3),
    quantized on the points' bounding box."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-300)
    d = p.shape[1]
    nb = min(bits, 63 // d)
    q = np.minimum(((p - lo) / span * ((1 << nb) - 1)).astype(np.uint64),
                   (1 << nb) - 1)
    code = np.zeros(len(p), dtype=np.uint64)
    for b in range(nb):
        for axis in range(d):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) << \
                np.uint64(b * d + axis)
    return code


def rcb_order(points, leaf: int = 128) -> np.ndarray:
    """Split along the widest axis at the median until cells hold
    <= ``leaf`` points; return the depth-first leaf order."""
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            order[pos: pos + len(idx)] = idx
            pos += len(idx)
            continue
        p = pts[idx]
        axis = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        half = len(idx) // 2
        part = np.argpartition(p[:, axis], half)
        # push the right half first so the left half is processed next
        stack.append(idx[part[half:]])
        stack.append(idx[part[:half]])
    return order


def reorder_mesh(V, F, order: str = "morton"):
    """Elements sorted by the Morton code of their centroids (or in RCB
    leaf order with ``order="rcb"``), vertices renumbered by first touch
    in the new element order.  Returns (V2, F2, vperm, eperm): ``vperm``
    maps an old vertex id to its new one, ``eperm`` lists the old elements
    in their new order."""
    V = np.asarray(V)
    F = np.asarray(F)
    centroids = V[F].mean(axis=1)
    if order == "rcb":
        eperm = rcb_order(centroids)
    else:
        eperm = np.argsort(_morton_codes(centroids), kind="stable")
    F_sorted = F[eperm]
    uniq, first_pos = np.unique(F_sorted.ravel(), return_index=True)
    touched = uniq[np.argsort(first_pos)]
    vperm = np.empty(len(V), dtype=np.int64)
    vperm[touched] = np.arange(len(touched))
    unused = np.setdiff1d(np.arange(len(V)), touched)   # last, in order
    vperm[unused] = np.arange(len(touched), len(V))
    V2 = np.empty_like(V)
    V2[vperm] = V
    return V2, vperm[F_sorted], vperm, eperm
