"""Recursive coordinate bisection order (counterpart of
``meshfem_tpu/mesh/reorder.py::rcb_order`` :33).

``RoutedEBE`` sorts elements along RCB leaves of their centroids and numbers
nodes by first touch (``routed_ebe.py:449-470``); the port keeps that
ordering integer for integer, so this is the reference's algorithm call for
call (the same ``argpartition`` on the same inputs).
"""

from __future__ import annotations

import numpy as np


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
