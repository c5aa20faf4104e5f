"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises), counting launches in
``<wrapper>.launches``.
"""

from .gather import gather_planes, gather_planes_plain  # noqa: F401
from .segment_sum import segment_sum_csr, segment_sum_csr_plain  # noqa: F401
from .qp import qp_contract, qp_contract_plain  # noqa: F401
from .factored import factored_contract, factored_contract_plain  # noqa: F401
from .element_stiffness import (element_stiffness,  # noqa: F401
                                element_stiffness_plain)

WRAPPERS = (gather_planes, segment_sum_csr, qp_contract, factored_contract,
            element_stiffness)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
