"""The chip's published peaks and the least time of an operator apply.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
power limit (a card set below it runs slower under load; the traced run
prints the card's limit beside its numbers).

The bound of one apply ``y = K u`` of the isotropic P2 elasticity operator
on m columns counts what the function needs, once, whatever an
implementation reads again or stages in between:

* bytes: the connectivity (an int32 node id per element node), the
  per-element data of a constant isotropic material (the element's
  (K+1) x d barycentric gradients and its volume, float32) and the node
  values in and out (float32, d m a node);
* operations: the fewer of two known algorithms, the dense product with
  the element matrix (2 (n d)^2 a column an element) and the quadrature
  form (at each of Q points: the shape gradients, 2 n (K+1) d, once for
  all columns; per column the displacement gradient, 2 d^2 n, the strain
  and stress, d + 1 + 4 d^2 + 2 d, and the forces, 2 n d^2), at the
  float32 rate.

The bound is the larger of bytes over bandwidth and operations over the
rate; it is the same for the dense backend and for kernels C and D, so
no implementation of the apply can read above 100% of it.
"""

from __future__ import annotations

PEAKS = {
    # name as torch.cuda.get_device_name() gives it
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  f32_flop_per_s=67e12,
                                  f64_flop_per_s=34e12),
}
QUAD_POINTS_P2 = 4            # degree-2 products of P2 gradients in 3D


def apply_bound_s(m, elements, nodes, nodes_per_elem, dim, peaks,
                  quad_points=QUAD_POINTS_P2):
    """Least seconds of one apply on m columns (see the module)."""
    E, n, d, k1 = elements, nodes_per_elem, dim, dim + 1
    nbytes = (E * n * 4 + E * (k1 * d + 1) * 4 + 2 * nodes * d * m * 4)
    dense = 2 * (n * d) ** 2 * m
    quad = quad_points * (2 * n * k1 * d + m * (
        2 * d * d * n + d + 1 + 4 * d * d + 2 * d + 2 * n * d * d))
    flops = E * min(dense, quad)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flop_per_s"])
