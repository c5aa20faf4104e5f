"""A synchronised host-clock span around each block CG
(``solvers.cg.cg_block``): ``record["spans"]["cg_block"]`` gets (job
number, seconds, iterations)."""

from __future__ import annotations

import time

import torch

from fembench.probes import wrap_method


def install(record):
    from meshfem_tpu_torch.solvers import cg as cg_mod

    out = record["spans"].setdefault("cg_block", [])

    def make(fn):
        def spanned(A, B, *args, **kw):
            sync = (torch.cuda.synchronize if B.is_cuda else lambda: None)
            sync()
            t0 = time.perf_counter()
            res = fn(A, B, *args, **kw)
            sync()
            out.append((record["info"]["job"], time.perf_counter() - t0,
                        int(res.iters)))
            return res
        return spanned

    return wrap_method(cg_mod, "cg_block", make)
