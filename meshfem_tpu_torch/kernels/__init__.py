"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises), counting launches in
``<wrapper>.launches``.  Kernels A and B have one wrapper per layout
(planes for the factored contractions, node rows for the dense ones), so
the counts show which layout a path ran; kernel B's wrappers and kernel A
in rows also count their float64 launches apart, in
``<wrapper>.launches_f64``.
"""

from .gather import (gather_planes, gather_planes_plain,  # noqa: F401
                     gather_rows, gather_rows_plain)
from .segment_sum import (segment_sum_csr,  # noqa: F401
                          segment_sum_csr_plain, segment_sum_rows,
                          segment_sum_rows_plain)
from .qp import qp_contract, qp_contract_plain  # noqa: F401
from .factored import factored_contract, factored_contract_plain  # noqa: F401
from .element_stiffness import (element_stiffness,  # noqa: F401
                                element_stiffness_plain)
from .route_window import route_window, route_window_plain  # noqa: F401

WRAPPERS = (gather_planes, gather_rows, segment_sum_csr, segment_sum_rows,
            qp_contract, factored_contract, element_stiffness, route_window)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
        if hasattr(w, "launches_f64"):
            w.launches_f64 = 0
