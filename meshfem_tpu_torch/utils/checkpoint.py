"""Checkpoint and resume of solver state and results (counterpart of
``meshfem_tpu/utils/checkpoint.py``; the reference's persistence
primitives, SURVEY §5.4).

* ``save_solver_state`` / ``load_solver_state``: npz snapshots of iterates
  (tensors are read to the host; ``load`` puts them on a device);
* ``save_tree``: a nested dict / list / tuple of arrays in the reference's
  npz form (``leaf{i}`` arrays and a ``treedef`` record), since the
  reference's first choice, ``orbax``, checkpoints JAX arrays;
* ``dump_matrix`` / ``read_matrix``: the binary triplet format of
  ``TripletMatrix::dumpBinary`` (``SparseMatrices.hh:629``), byte for byte
  the reference's.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from .. import config


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_solver_state(path, state: dict) -> None:
    """Save a dict of arrays or tensors (CG x / r / p, eigenvector
    blocks, ...) to a compressed npz."""
    np.savez_compressed(path, **{k: _host(v) for k, v in state.items()})


def load_solver_state(path, device=None) -> dict:
    """The dict ``save_solver_state`` wrote, as tensors on ``device`` (the
    CUDA device unless the caller asks for another), bit for bit."""
    dev = config.resolve_device(device)
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k], device=dev) for k in data.files}


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` in JAX's order (dict keys sorted) and
    return its structure as JAX prints a treedef (``*`` for a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        items = [f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)]
        return "{" + ", ".join(items) + "}"
    if isinstance(tree, (list, tuple)):
        items = [_flatten(x, leaves) for x in tree]
        if isinstance(tree, list):
            return "[" + ", ".join(items) + "]"
        return "(" + ", ".join(items) + ("," if len(items) == 1 else "") + ")"
    leaves.append(_host(tree))
    return "*"


def save_tree(path, tree) -> None:
    """Checkpoint a nested dict / list / tuple of arrays or tensors to
    ``path + ".npz"`` as the reference's npz form does: ``leaf{i}`` in
    JAX's leaf order and ``treedef``, the structure as JAX prints it."""
    leaves: list = []
    treedef = f"PyTreeDef({_flatten(tree, leaves)})"
    np.savez_compressed(
        str(path) + ".npz",
        treedef=np.frombuffer(treedef.encode(), dtype=np.uint8),
        **{f"leaf{i}": leaf for i, leaf in enumerate(leaves)})


def load_tree(path, device=None):
    """Read back what ``save_tree`` wrote (the reader the tests hold
    ``save_tree`` to; the reference has none): leaves as tensors on
    ``device``, the CUDA device unless the caller asks for another."""
    dev = config.resolve_device(device)
    with np.load(str(path) + ".npz") as data:
        spec = bytes(data["treedef"]).decode()
        leaves = [torch.as_tensor(data[f"leaf{i}"], device=dev)
                  for i in range(len(data.files) - 1)]
    body = spec[len("PyTreeDef("):-1]
    # number the leaves: each * outside a quoted key becomes its index
    out, quote, i = [], None, 0
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "*":
            ch, i = str(i), i + 1
        out.append(ch)
    skeleton = ast.literal_eval("".join(out))

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(x) for x in node)
        return None if node is None else leaves[node]

    return fill(skeleton)


def dump_matrix(path, A) -> None:
    """Binary triplet dump of a scipy sparse matrix: the int64 shape and
    entry count, then int64 rows, int64 columns and float64 values."""
    A = A.tocoo()
    with open(path, "wb") as f:
        np.asarray([A.shape[0], A.shape[1], A.nnz],
                   dtype=np.int64).tofile(f)
        A.row.astype(np.int64).tofile(f)
        A.col.astype(np.int64).tofile(f)
        A.data.astype(np.float64).tofile(f)


def read_matrix(path):
    """Read a binary triplet dump back to scipy COO."""
    import scipy.sparse as sp

    with open(path, "rb") as f:
        m, n, nnz = np.fromfile(f, dtype=np.int64, count=3)
        row = np.fromfile(f, dtype=np.int64, count=nnz)
        col = np.fromfile(f, dtype=np.int64, count=nnz)
        data = np.fromfile(f, dtype=np.float64, count=nnz)
    return sp.coo_matrix((data, (row, col)), shape=(int(m), int(n)))
