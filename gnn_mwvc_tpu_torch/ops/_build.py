"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``) into one shared library with a plain C interface under
``gnn_mwvc_tpu_torch/_build/``; ctypes binds it.  The library is rebuilt
when a source is newer, written to a temporary file and renamed so a process
that already mapped the old library keeps a valid file.  A failed build
raises: there is no fallback.

``launches`` counts kernel launches by wrapper name.  Each wrapper adds one
exactly where it launches its kernel, so a run can show that it went through
the kernel and not through the plain PyTorch version.
"""

from __future__ import annotations

import collections
import ctypes as ct
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libgnn_mwvc_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (register / smem report)

_P = ct.c_void_p
_SIGNATURES = {
    # (x, indptr, indices, mask, mask_kind, out, n, w, stream)
    "csr_aggregate_f32": [_P, _P, _P, _P, ct.c_int, _P, ct.c_int, ct.c_int, _P],
    # (adj, w, best_cost, best_set, batch, n, stream)
    "small_mwvc_mitm_i32": [_P, _P, _P, _P, ct.c_int, ct.c_int, _P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is up to date."""
    global build_log
    srcs = _sources()
    if os.path.exists(LIB_PATH):
        lib_mtime = os.path.getmtime(LIB_PATH)
        if all(os.path.getmtime(p) <= lib_mtime for p in srcs):
            return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    out = subprocess.run(cmd, capture_output=True, text=True)
    build_log = out.stdout + out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed ({out.returncode}):\n{build_log[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ct.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _LOCK:
        if _lib is None:
            handle = ct.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ct.c_int  # cudaError_t
            handle.gnn_mwvc_cuda_error_string.argtypes = [ct.c_int]
            handle.gnn_mwvc_cuda_error_string.restype = ct.c_char_p
            _lib = handle
    return _lib


def count(name: str) -> None:
    """One launch of ``name``.  Autograd runs each card's backward on a
    thread of its own, so the count takes a lock."""
    with _COUNT_LOCK:
        launches[name] += 1


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.gnn_mwvc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
