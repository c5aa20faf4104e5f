"""meshfem_tpu_torch — the PyTorch/CUDA port of meshfem_tpu for NVIDIA Hopper.

This slice carries the routed P2 elasticity solve: mesh and P2 nodes,
element geometry, element stiffness, the f64 EBE operator, the f32 routed
operator on three hand-written CUDA kernels (``kernels/``: gather,
segment-sum, quadrature-point contraction), Jacobi-preconditioned CG under
f64 iterative refinement, and the strain/stress/von Mises fields.  The JAX
package ``meshfem_tpu`` is the reference; this package imports nothing of
it and nothing of JAX.
"""

from . import config  # noqa: F401  (switches TF32 off on import)
from .config import default_device  # noqa: F401

__version__ = "0.1.0"
