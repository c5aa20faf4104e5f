"""CUDA events around each apply of the routed operator
(``RoutedEBE.apply_planes``, one column, and ``RoutedEBE.apply_block``,
m columns), with the operator's sizes: ``record["events"]["apply"]`` gets
(m, elements, nodes, nodes an element, components, start, end).  No
events on a CPU tensor."""

from __future__ import annotations

import torch

from fembench.probes import wrap_method


def install(record):
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    out = record["events"].setdefault("apply", [])

    def make(columns):
        def outer(fn):
            def timed(op, x, *args, **kw):
                if not x.is_cuda:
                    return fn(op, x, *args, **kw)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                y = fn(op, x, *args, **kw)
                e.record()
                out.append((columns(x), op.num_elements, op.num_dofs,
                            op.nodes_per_elem, op.vector_dim, s, e))
                return y
            return timed
        return outer

    undo = [wrap_method(RoutedEBE, "apply_planes", make(lambda x: 1)),
            wrap_method(RoutedEBE, "apply_block",
                        make(lambda x: int(x.shape[-1])))]
    return lambda: [u() for u in undo]
