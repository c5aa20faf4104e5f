"""Routed element-by-element operator: the fast float32 general-mesh SpMV.

Counterpart of ``meshfem_tpu/sparse/routed_ebe.py::RoutedEBE``.  An apply
``A u = scatter(Ke @ gather(u))`` runs as three launches:

1. kernel A, slot <- node, one int32 index per slot shared by all values
   of the node;
2. the element contraction: ``torch.bmm`` against the dense float32 ``Ke``
   (an XLA einsum in the reference, ``routed_ebe.py:690``), or kernel C
   (``qp_contract``) for the factored isotropic backend, which reads
   grad_lambda and the volume instead of Ke, or kernel D
   (``factored_contract``, the gradgrad-table form of the same product)
   when ``MESHFEM_FACTORED_TQ=1``, read as the reference reads it (:720);
3. kernel B, slots -> nodes in a fixed order.

Both backends run in NODE ROWS: slots are element-major (``ids_em``,
``s = e * n + a``), and kernel A's rows output ``[E*n, d*m]`` (value
``c * m + j``) is what the contraction reads and writes, and what kernel B
sums:

* dense: ``KeP`` keeps ``Ke``'s node-major dof order (``a * d + c``), so
  the rows ARE the ``bmm`` operand ``[E, n*d, m]`` and the ``bmm`` result
  is kernel B's rows input;
* factored: kernel C (or D) reads the rows and writes forces of the same
  shape, all m columns of a block in one launch, staging each block's
  elements through shared memory (``kernels/qp.py``).

``apply_block`` reads ``U [N, d, m]`` and writes ``[N, d, m]`` as they
lie; ``apply_planes`` reads and writes the CG's ``[d, N]`` planes through
kernel A's and B's strides.  No layout copy on any apply.  The
slot-major ``ids`` and ``plan`` (``s = a * E + e``) feed kernels A and B in
component planes, the composition the tests and ``chip_smoke.py`` hold the
factored applies against bit for bit; ``plan_em`` is ``plan`` with each
slot ``a * E + e`` renumbered ``e * n + a``, so both sum every node's
contributions in the same order.  The reference's chain buckets, windows, superblocks, 128-lane
padding and scatter ladder work around the TPU's lane-rigid gather and are
not carried over.

The internal reordering is the reference's exactly (``routed_ebe.py:449-470``):
elements along ``rcb_order`` of their centroids, nodes by first touch, so
``order`` and ``rank`` equal the reference's integer for integer.

``apply_block`` (reference :787-850) sends all m columns and d components
of a block through ONE gather and ONE segment sum as ``d * m`` values a
node (``c * m + j``).  Kernel A's one index stream already serves any
number of values, so no second plan set is built; ``block_rhs`` is only
recorded (``bm``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import config
from ..kernels import factored_contract, gather_rows, qp_contract
from ..mesh.reorder import rcb_order
from ..ops.element_matrices import gradgrad_table
from .scatter import ScatterPlan, _INT32_MAX


def _device_of(Ke, factor, device):
    if device is not None:
        return torch.device(device)
    for t in (Ke, None if factor is None else factor[0]):
        if isinstance(t, torch.Tensor):
            return t.device
    return config.default_device()


@dataclasses.dataclass
class RoutedEBE:
    """Symmetric routed EBE operator (float32) for scalar or vector dofs.

    Two contraction backends:

    * dense: ``KeP [E, n*d, n*d]`` float32 in ``Ke``'s node-major dof
      order (``a * d + c``), matching the node-row layout;
    * factored isotropic (``g``/``vol``/``lam``/``mu`` set, ``KeP`` None):
      ``vol Ke u`` from grad_lambda ``g [(K+1) d, E]`` and ``vol [E]``
      through kernel C (or D) — 13 floats per element at P2/3D instead
      of 900.
    """

    ids: torch.Tensor                # [n*E] int32 slot a*E + e -> node
    plan: ScatterPlan                # slots a*E + e -> internal nodes (CSR)
    ids_em: torch.Tensor             # [E*n] int32 slot e*n + a -> node
    plan_em: ScatterPlan             # plan over slots e*n + a, same order
    order: torch.Tensor | None       # [N] user dof held by internal slot i
    rank: torch.Tensor | None        # [N] internal slot of user dof
    num_dofs: int                    # nodes
    vector_dim: int
    num_elements: int
    nodes_per_elem: int
    KeP: torch.Tensor | None = None
    g: torch.Tensor | None = None
    vol: torch.Tensor | None = None
    lam: float = 0.0
    mu: float = 0.0
    deg: int = 2
    bm: int = 0                      # RHS count asked for at build

    @classmethod
    def build(cls, Ke, elem_dofs, num_dofs: int, vector_dim: int = 1,
              coords=None, factor=None, device=None,
              block_rhs: int | None = None) -> "RoutedEBE":
        """Ke: [E, nd, nd] (node-major dofs ``a * d + c``); elem_dofs:
        [E, n] node ids; num_dofs = number of NODES.

        ``factor``: ``(grad_lambda [E, K+1, dim], volume [E], lam, mu,
        deg)`` selects the factored isotropic contraction (Ke may be None).
        ``coords`` ([num_dofs, dim] positions): reorder internally
        (elements along RCB leaves, dofs by first touch); ``__call__`` then
        works in the INTERNAL ordering and callers convert once each way
        with :meth:`permute_in` / :meth:`permute_out`.  The device defaults
        to that of the tensors given, else the CUDA device.  ``block_rhs``
        is recorded as ``bm``: :meth:`apply_block` needs no plans of its
        own."""
        dev = _device_of(Ke, factor, device)
        elem_dofs = np.asarray(elem_dofs, dtype=np.int64)
        E, n = elem_dofs.shape
        d = vector_dim
        N = int(num_dofs)
        if N > _INT32_MAX or n * E > _INT32_MAX:
            raise ValueError("mesh too large for int32 index streams")
        eperm = None
        if coords is not None:
            cent = np.asarray(coords)[elem_dofs].mean(axis=1)
            eperm = rcb_order(cent)
            ed_sorted = elem_dofs[eperm]
            uniq, first_pos = np.unique(ed_sorted.ravel(), return_index=True)
            touched = uniq[np.argsort(first_pos)]
            untouched = np.setdiff1d(np.arange(N, dtype=np.int64), uniq)
            order_np = np.concatenate([touched, untouched])
            rank_np = np.empty(N, np.int64)
            rank_np[order_np] = np.arange(N)
            elem_dofs = rank_np[ed_sorted]
            order = torch.as_tensor(order_np, device=dev)
            rank = torch.as_tensor(rank_np, device=dev)
        else:
            order = rank = None
        slot_node = np.ascontiguousarray(elem_dofs.T).reshape(-1)  # a*E + e
        ids = torch.as_tensor(slot_node.astype(np.int32), device=dev)
        plan = ScatterPlan.build(slot_node, N, dev)
        ids_em = torch.as_tensor(elem_dofs.reshape(-1).astype(np.int32),
                                 device=dev)
        s = torch.arange(n * E, device=dev)
        plan_em = plan.renumbered(s % E * n + s // E)   # a*E + e -> e*n + a
        op = cls(ids=ids, plan=plan, ids_em=ids_em, plan_em=plan_em,
                 order=order, rank=rank, num_dofs=N, vector_dim=d,
                 num_elements=E, nodes_per_elem=n, bm=int(block_rhs or 0))
        ep = None if eperm is None else torch.as_tensor(eperm, device=dev)
        if factor is not None:
            gl, volume, lam, mu, deg = factor
            gl = torch.as_tensor(gl, device=dev).to(config.SOLVE)
            volume = torch.as_tensor(volume, device=dev).to(config.SOLVE)
            if ep is not None:
                gl, volume = gl[ep], volume[ep]
            K1 = gl.shape[1]
            op.g = gl.permute(1, 2, 0).reshape(K1 * d, E).contiguous()
            op.vol = volume.contiguous()
            op.lam, op.mu, op.deg = float(lam), float(mu), int(deg)
        else:
            Ke = torch.as_tensor(Ke, device=dev)
            if tuple(Ke.shape) != (E, n * d, n * d):
                raise ValueError(f"Ke must be {(E, n * d, n * d)}")
            Ke = Ke.to(config.SOLVE)
            op.KeP = (Ke if ep is None else Ke[ep]).contiguous()
        return op

    # ------------------------------------------------------------------
    def permute_in(self, u):
        """User-ordered [N] / [N, d] -> internal ordering (identity when
        built without coords)."""
        return u if self.order is None else u[self.order]

    def permute_out(self, y):
        """Internal ordering -> user ordering."""
        return y if self.rank is None else y[self.rank]

    def _contract(self, ue):
        """Factored backend: ue [E*n, d*m] element-major rows -> forces of
        the same shape (kernel C, or D under ``MESHFEM_FACTORED_TQ=1``), one
        launch for all m columns."""
        kernel = (factored_contract
                  if os.environ.get("MESHFEM_FACTORED_TQ") == "1"
                  else qp_contract)
        return kernel(self.g, self.vol, ue, self.lam, self.mu, rows=True)

    def _apply_rows(self, src, planes_in: bool, planes_out: bool):
        """Either backend on P = d*m values a node: kernel A (rows) -> the
        contraction (one ``bmm`` with the node-major ``KeP``, or kernel C
        or D) -> kernel B (rows).  src [N, P] node rows or [P, N] planes;
        returns the same choice of layout."""
        ue = gather_rows(src, self.ids_em, planes_in=planes_in)  # [E*n, P]
        if self.KeP is None:
            fe = self._contract(ue)
        else:
            E, nd = self.num_elements, self.nodes_per_elem * self.vector_dim
            m = ue.shape[1] // self.vector_dim
            fe = torch.bmm(self.KeP, ue.view(E, nd, m)).view(ue.shape)
        return self.plan_em.sum_rows(fe, planes_out)

    def apply_planes(self, src: torch.Tensor) -> torch.Tensor:
        """Plane-native apply: ``src [d, N] -> A src [d, N]`` (float32)."""
        return self._apply_rows(src.to(config.SOLVE).contiguous(),
                                planes_in=True, planes_out=True)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """u [N] (d = 1) or [N, d] -> A u in the same layout (float32)."""
        src = u.to(config.SOLVE).reshape(self.num_dofs, self.vector_dim)
        y = self._apply_rows(src.contiguous(), planes_in=False,
                             planes_out=False)
        return y.reshape(u.shape)

    def diagonal_planes(self) -> torch.Tensor:
        """Assembled operator diagonal (Jacobi) in plane layout [d, N]."""
        d, n, E = self.vector_dim, self.nodes_per_elem, self.num_elements
        if self.KeP is not None:
            de = torch.diagonal(self.KeP, dim1=1, dim2=2)       # [E, n*d]
            return self.plan_em.sum_rows(de.reshape(E * n, d),
                                         planes_out=True)
        # diag Ke[(a c)(a c)] = vol sum_kl T[klaa]
        #                       (mu g_k.g_l + (lam + mu) g_kc g_lc)
        K1 = self.g.shape[0] // d
        gl = self.g.reshape(K1, d, E)
        T = torch.as_tensor(gradgrad_table(K1 - 1, self.deg),
                            dtype=gl.dtype, device=gl.device)
        Taa = torch.einsum("klaa->kla", T)
        G2 = torch.einsum("kce,mce->kme", gl, gl)
        iso = self.mu * torch.einsum("kla,kle->ae", Taa, G2)
        dirn = (self.lam + self.mu) * torch.einsum(
            "kla,kce,lce->cae", Taa, gl, gl)
        de = self.vol * (iso[None] + dirn)                      # [d, n, E]
        return self.plan_em.sum_rows(de.permute(2, 1, 0).reshape(E * n, d),
                                     planes_out=True)

    def diagonal(self) -> torch.Tensor:
        """Operator diagonal in the user layout [N] / [N, d]."""
        dg = self.diagonal_planes()
        return dg[0] if self.vector_dim == 1 else dg.t()

    def apply_block(self, U: torch.Tensor) -> torch.Tensor:
        """Multi-RHS apply: ``U [N, d, m] -> A U`` (also ``[N, m]`` when
        d == 1), float32.  One gather and one segment sum serve all
        ``d * m`` values of a node: kernel A reads ``U``'s node rows as they
        lie and kernel B writes ``[N, d, m]``.  Between them the dense
        backend runs ONE ``torch.bmm`` of ``KeP`` with ``[E, n*d, m]``,
        reading the stiffness once for all columns (an XLA einsum in the
        reference, :840), and the factored one ONE launch of kernel C or D
        over all m columns (the reference runs its contraction per column,
        :844)."""
        N, d, m = self.num_dofs, self.vector_dim, U.shape[-1]
        y = self._apply_rows(U.to(config.SOLVE).reshape(N, d * m)
                             .contiguous(), planes_in=False, planes_out=False)
        return y.reshape(U.shape)
