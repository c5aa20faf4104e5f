"""The host core: C++ mesh preprocessing bound through ctypes, with numpy
fallbacks in the callers when it cannot be had (counterpart of
``meshfem_tpu/native/__init__.py``; ``hostcore.cpp`` is the reference's
source, unchanged).

Its five entry points: ``match_faces`` (mates of half-edges and half-faces,
``mesh/simplicial.py``), ``unique_edges`` (the P2 edge numbering,
``mesh/femmesh.py`` and ``simplicial._unique_edges``), ``build_scatter_plan``
(the reference TPU path's two-level gather ladder; no port path calls it,
since kernel B's CSR plan replaces it), ``morton_codes`` and
``triangulate_ruppert`` (the quality constrained Delaunay triangulation of
``mesh/triangulate.py``).

``g++ -O3 -march=native -shared -fPIC`` builds the library at first use
into ``build/`` at the repository root (never beside the source), under a
name carrying the hash of the source, the flags and what ``-march=native``
means on this host; it is written to a temporary file and moved into
place, so processes that build at once do not race.  Each entry point
returns ``None`` when the compiler or the library is missing, or when
``MESHFEM_TORCH_NO_NATIVE=1`` is set (read at every call); its callers
then take their numpy paths, which give the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failed = False


def disabled() -> bool:
    """True when ``MESHFEM_TORCH_NO_NATIVE=1`` switches the core off."""
    return os.environ.get("MESHFEM_TORCH_NO_NATIVE") == "1"


def library_path() -> Path:
    """Path of the library for this source, these flags and this host's
    ``-march=native`` (a library built on another CPU is not reused)."""
    target = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        capture_output=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(target)
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhostcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if needed) and return the library's path; raises if the
    compiler fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(lib):
    P, I64, I32, D = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_double)
    lib.match_faces.restype = ctypes.c_int
    lib.match_faces.argtypes = [P, I64, I32, P]
    lib.unique_edges.restype = I64
    lib.unique_edges.argtypes = [P, I64, P, P]
    lib.build_scatter_plan.restype = None
    lib.build_scatter_plan.argtypes = [P, I64, I64, I64, P, P, P]
    lib.morton_codes.restype = None
    lib.morton_codes.argtypes = [P, I64, I32, I32, P]
    lib.triangulate_ruppert.restype = ctypes.c_int
    lib.triangulate_ruppert.argtypes = [
        P, I64,                 # points
        P, I64,                 # segments
        P, I64,                 # hole seeds
        D, D,                   # min_angle, max_area
        P, I64, P,              # out points, capacity, count
        P, I64, P]              # out triangles, capacity, count
    return lib


def get_lib():
    """The loaded library (built on first call), or None."""
    global _lib, _failed
    if disabled():
        return None
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, subprocess.SubprocessError):
                _failed = True
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def match_faces(face_verts: np.ndarray):
    """[H, k] -> opp [H] (-1 = boundary); raises on non-manifold.
    Returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    fv = np.ascontiguousarray(face_verts, dtype=np.int64)
    H, k = fv.shape
    if k > 4:                          # the core keys faces in 4 slots
        raise ValueError(f"faces of {k} vertices")
    opp = np.empty(H, dtype=np.int64)
    if lib.match_faces(_ptr(fv), H, k, _ptr(opp)) != 0:
        raise ValueError("non-manifold: face shared by > 2 elements")
    return opp


def unique_edges(pairs: np.ndarray):
    """[M, 2] -> (edge_id [M], unique sorted pairs [nu, 2]) in the order of
    ``np.unique`` on the sorted pairs, or None."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pairs, dtype=np.int64)
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError(f"pairs of shape {p.shape}, not [M, 2]")
    M = len(p)
    edge_id = np.empty(M, dtype=np.int64)
    buf = np.empty((M, 2), dtype=np.int64)
    nu = lib.unique_edges(_ptr(p), M, _ptr(edge_id), _ptr(buf))
    return edge_id, buf[:nu].copy()


def build_scatter_plan(ids: np.ndarray, num_segments: int, g1: int = 8):
    """-> (gidx1 [P1] int32, gidx2 [N*g2] int32, g2) or None: the
    reference TPU path's two-level gather ladder of a segment sum."""
    lib = get_lib()
    if lib is None:
        return None
    ids64 = np.ascontiguousarray(ids, dtype=np.int64)
    sizes = np.zeros(3, dtype=np.int64)
    lib.build_scatter_plan(_ptr(ids64), len(ids64), num_segments, g1,
                           _ptr(sizes), None, None)
    P1, g2, _ = (int(x) for x in sizes)
    gidx1 = np.empty(P1, dtype=np.int32)
    gidx2 = np.empty(num_segments * g2, dtype=np.int32)
    lib.build_scatter_plan(_ptr(ids64), len(ids64), num_segments, g1,
                           _ptr(sizes), _ptr(gidx1), _ptr(gidx2))
    return gidx1, gidx2, g2


def morton_codes(q: np.ndarray, bits: int):
    """[n, d] non-negative quantized coordinates -> [n] uint64 Morton
    codes (bit b of axis a at bit b d + a), or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, dtype=np.uint64)
    n, d = q.shape
    if d * bits > 64:
        raise ValueError(f"{d} axes of {bits} bits exceed 64")
    out = np.empty(n, dtype=np.uint64)
    lib.morton_codes(_ptr(q), n, d, bits, _ptr(out))
    return out


def triangulate_ruppert(points, segments, holes=None,
                        min_angle: float = 20.0, max_area: float = 0.0):
    """Quality constrained Delaunay triangulation with Ruppert refinement
    (Triangle's quality/area modes, ``Triangulate.h:83``).  Returns
    (V [n, 2], F [m, 3]) or None if the library is unavailable.

    As in Triangle, enclosed regions are KEPT unless a seed point inside
    them is passed in ``holes`` (regions are flood fills bounded by the
    constrained segments, seeded from the exterior and the hole points).
    The output buffers start at 4096 points and 8192 triangles and grow
    to what the core reports, up to eight tries."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float64)[:, :2])
    segs = np.ascontiguousarray(segments, dtype=np.int64)
    hl = np.ascontiguousarray(
        holes if holes is not None and len(holes) else np.zeros((0, 2)),
        dtype=np.float64)
    cap_p, cap_t = 4096, 8192
    for _ in range(8):
        out_p = np.empty((cap_p, 2), dtype=np.float64)
        out_t = np.empty((cap_t, 3), dtype=np.int64)
        n_p = ctypes.c_int64()
        n_t = ctypes.c_int64()
        rc = lib.triangulate_ruppert(
            _ptr(pts), len(pts), _ptr(segs), len(segs), _ptr(hl), len(hl),
            float(min_angle), float(max_area),
            _ptr(out_p), cap_p, ctypes.byref(n_p),
            _ptr(out_t), cap_t, ctypes.byref(n_t))
        if rc == 0:
            return out_p[:n_p.value].copy(), out_t[:n_t.value].copy()
        cap_p = max(cap_p * 2, int(n_p.value) + 1)
        cap_t = max(cap_t * 2, int(n_t.value) + 1)
    raise RuntimeError("triangulate_ruppert: output capacity not converging")
