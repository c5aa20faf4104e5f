"""Per-shard ROUTED operator for the domain-decomposed solve.

Counterpart of ``meshfem_tpu/parallel/routed_dd.py::RoutedShardSpMV``
(:93-157).  Each shard gets one float32 ``RoutedEBE``
(``sparse/routed_ebe.py``) over its interior and boundary elements together
and its ``Nl + H`` local rows (owned, then halo), as
``DomainDecomposition.build_routed`` hands them over (reference
``domain.py:179-193``).  An apply is three launches: kernel A in node rows
(the shard's local rows into its element slots), the dense ``bmm`` with
the shard's float32 ``Ke``, and kernel B in node rows, which also does the
reference's final-rung XLA scatter-add (:142-149).

The reference forces one plan STRUCTURE on every shard
(``copy_plan_structure``, :36-90) so that ``shard_map`` sees one SPMD
program; here each shard keeps its own plan.  On CUDA tensors the shard
operators launch the kernels or raise, as ``RoutedEBE`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..sparse.routed_ebe import RoutedEBE


@dataclasses.dataclass
class RoutedShardSpMV:
    """Per-shard routed operators, keyed by shard id."""

    ops: dict             # shard id -> RoutedEBE over NlH rows
    NlH: int
    d: int

    @classmethod
    def build(cls, Kes, locs, Nl: int, H: int, d: int,
              device=None) -> "RoutedShardSpMV":
        """Kes: shard id -> [E_s, nd, nd] element matrices (any float type;
        the operator keeps them in float32); locs: shard id -> [E_s, n]
        local rows in [0, Nl + H)."""
        NlH = Nl + H
        ops = {}
        for s, Ke in Kes.items():
            Ke = torch.as_tensor(Ke, device=device).to(config.SOLVE)
            ops[s] = RoutedEBE.build(Ke, np.asarray(locs[s]), NlH, d,
                                     device=Ke.device)
        return cls(ops, NlH, d)

    def local(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Shard ``s``'s apply: x [NlH, d] or [NlH, d, m] -> A_s x in the same
        shape, float32 (halo rows receive partial values; callers keep
        [:Nl])."""
        op = self.ops[s]
        y = op.apply_block(x.reshape(self.NlH, self.d, -1))
        return y.reshape(x.shape)
