"""Multi-device solves (counterpart of ``meshfem_tpu/parallel/``).

* ``comm``: the interface the shards talk through, :class:`LocalShards`
  (every shard in this process, on one device) and :class:`RankShards`
  (one shard a rank of a ``torch.distributed`` group: gloo on the CPU,
  NCCL on cards);
* ``launch.run_ranks``: spawn a process group from a ``FileStore``;
* ``domain``: domain decomposition with halo exchange,
  ``DomainDecomposition``, ``DDCoarse`` and ``dd_cg_solve``;
* ``routed_dd``: the per-shard float32 routed operator (kernels A and B);
* ``sharded``: replicated-vector, element-sharded operators and solves;
* ``dryrun.dryrun_multidevice``: the end-to-end check.
"""

from .comm import LocalShards, RankShards  # noqa: F401
from .domain import DDCoarse, DomainDecomposition, dd_cg_solve  # noqa: F401
from .launch import run_ranks  # noqa: F401
from .routed_dd import RoutedShardSpMV  # noqa: F401
from .sharded import (ShardedEBE, pad_elements,  # noqa: F401
                      sharded_cg_step, sharded_elasticity_solve,
                      sharded_elasticity_solve_multichip)
from .dryrun import dryrun_multidevice  # noqa: F401
