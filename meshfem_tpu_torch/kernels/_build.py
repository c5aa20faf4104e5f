"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into ONE shared library with a plain
C interface, loaded through ``ctypes``.  The library lands in ``build/`` at
the repository root under a name carrying the hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
The build runs at the first CUDA use of a kernel, never on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("gather_planes.cu", "segment_sum_csr.cu", "qp_contract.cu",
           "factored_contract.cu", "element_stiffness.cu",
           "route_window.cu")
HEADERS = ("stage_rows.cuh",)      # included by sources; hashed with them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the meshfem_tpu_torch kernels")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmeshfem_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if needed) and return the shared library's path.  The
    compiler's register/spill report goes to ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[str(obj) for _, obj, _ in procs], "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed\n" + link.stdout)
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set:
    ``c_void_p`` for every pointer and the stream, so no pointer is cut to
    32 bits."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_float)
        lib.gather_planes_f32.argtypes = [P, P, P, I, L, L, P]
        lib.gather_rows_f32.argtypes = [P, P, P, I, L, L, L, I, P]
        for fn in (lib.segment_sum_f32, lib.segment_sum_f64):
            fn.argtypes = [P, P, P, P, I, L, L, L, L, L, P]
        lib.qp_set_tables.argtypes = [I, P, I, P, I]
        lib.qp_contract_f32.argtypes = [I, P, P, P, P, F, F, L, I, L, L, L,
                                        L, P]
        lib.factored_contract_f32.argtypes = [I, P, P, P, P, P, F, F, L, I,
                                              L, L, L, L, P]
        lib.element_stiffness_f32.argtypes = [I, P, P, P, P, P, L, P]
        lib.route_window_f32.argtypes = [P, P, P, P, P, I, L, L, I, P]
        for fn in (lib.gather_planes_f32, lib.gather_rows_f32,
                   lib.segment_sum_f32, lib.segment_sum_f64,
                   lib.qp_set_tables, lib.qp_contract_f32,
                   lib.factored_contract_f32, lib.element_stiffness_f32,
                   lib.route_window_f32):
            fn.restype = I
        _lib = lib
        return _lib


def check_cuda_args(what: str, data, *index, dtypes) -> None:
    """Validate a kernel's tensors before their pointers are passed: all on
    the current CUDA device and contiguous, ``data`` 2-D of one of
    ``dtypes``, every index tensor 1-D int32."""
    import torch

    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if data.dtype not in dtypes or data.dim() != 2 \
            or not data.is_contiguous():
        raise ValueError(f"{what}: data must be a contiguous 2-D tensor of "
                         f"{dtypes}, got {data.dtype} {tuple(data.shape)}")
    for t in index:
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: index tensors must be contiguous 1-D "
                             f"int32 on {dev}, got {t.dtype} on {t.device}")


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
