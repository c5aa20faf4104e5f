"""CUDA events around each V-cycle of the structured multigrid
(``StructuredMG.precondition``): ``record["events"]["vcycle"]`` gets
(start, end)."""

from __future__ import annotations

import torch

from fembench.probes import wrap_method


def install(record):
    from meshfem_tpu_torch.ops.structured_mg import StructuredMG

    out = record["events"].setdefault("vcycle", [])

    def make(fn):
        def timed(mg, r, *args, **kw):
            if not r.is_cuda:
                return fn(mg, r, *args, **kw)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            y = fn(mg, r, *args, **kw)
            e.record()
            out.append((s, e))
            return y
        return timed

    return wrap_method(StructuredMG, "precondition", make)
