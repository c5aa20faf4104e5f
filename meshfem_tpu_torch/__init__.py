"""meshfem_tpu_torch — the PyTorch/CUDA port of meshfem_tpu for NVIDIA Hopper.

It carries the routed P2 elasticity solve and periodic homogenization:
mesh and P2 nodes, element geometry, periodic node matching, element
stiffness (constant or per-element materials), the f64 EBE operator, the
f32 routed operator with its multi-RHS block apply on hand-written CUDA
kernels (``kernels/``: gather, segment-sum, the quadrature-point and the
gradgrad-table contractions, f32 stiffness assembly), Jacobi / block-Jacobi
/ Chebyshev preconditioned CG and block CG under f64 iterative refinement,
the strain/stress/von Mises fields, ``analysis.homogenization``, the
structured geometric multigrid that ``solve()`` takes on Kuhn grids
(``ops/structured*.py``: a block-stencil ``conv3d`` with a gather-form
boundary correction, P1 levels, a dense coarse inverse), and the
boundary-condition front end (``physics.parse_bc``,
``apply_boundary_conditions``), the rigid-motion projection and warm
starts on every other solve branch, with materials, their ``.material``
files and fits, and the ``ElasticityTensor`` class; and the scalar layer:
the discrete operators (``ops/operators.py``, ``ops/extra_operators.py``),
``physics.PoissonProblem``, geodesics in heat, mesh and field I/O
(``io/``) and the Poisson and Simulate command lines (``cli/``); and
multi-device solves (``parallel/``: domain decomposition with halo exchange,
routed shards, element sharding, over shards in one process or the ranks of
a ``torch.distributed`` group).  The JAX
package ``meshfem_tpu`` is the reference; this package imports nothing of
it and nothing of JAX.
"""

from . import config  # noqa: F401  (switches TF32 off on import)
from .config import default_device  # noqa: F401

__version__ = "0.1.0"
