"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  ``build()``
starts one ``nvcc`` per source, all at once, and waits for them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/lib<name>.so
         csrc/<name>.cu

The libraries are keyed by a hash of the sources and the flags, built
into ``build/torch_kernels/`` at the repository root (listed in
.gitignore), and loaded with ctypes.  Every pointer and the stream cross
the boundary as ``ctypes.c_void_p``; each C function returns a
``cudaError_t`` that the wrappers turn into an exception.  Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["library", "build", "build_seconds", "BUILD_DIR", "check"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# The live signals' planes: the first signal plane and its baseline, the
# second ones (constraints mode on COO128: the row word; else null).
_SIG = [_P, _P, _P, _P]
# The split tail of the fused kernels: td, tb, rows, starts, the per-tile
# window masks, T, S, the dense-row chunk, the chunk partials, the outlier
# rows' main products, the tail's signal planes and baselines (the second
# plane null but in constraints mode on COO128), E.
_TAIL = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, *_SIG, _I]
# The Jacobi and lazy options of the fused kernels: M^-1, the rz
# partials, the x/r/p snapshot, the check interval, the snapshot's
# itr and rr/rz outputs.
_OPTS = [_P, _P, _P, _P, _P, _I, _P, _P]
# One launch per SpMV call (kernels A, C and E): the pw partials and
# signal flags (scratch), the 0-d pw and trigger.
_CALL = [_P, _P, _P, _P]
# source name -> {C function: argtypes}
_SIGNATURES = {
    "dia_spmv_detect": {
        "abft_dia_spmv_detect": [_P, _P, _I, _I, _P, _P, *_SIG, _I, _I,
                                 *_CALL, _I, _P],
        "abft_dia_spmv_detect_halo": [_P, _P, _I, _I, _P, _I, _P, *_SIG,
                                      _I, _I, *_CALL, _I, _P],
        "abft_dia_spmv_grid": [_I],
    },
    "fused_cg_dia": {
        # device, tail, Jacobi, lazy, signal planes, grid out
        "abft_fused_grid": [_I, _I, _I, _I, _I, _P],
        # ... the tail-free schedule (0 three-sync, 1 fold, 2 window), the
        # fold's second r and p buffers, the window plan, the tail-free
        # rows per block
        "abft_fused_cg_dia": [_P, _P, _I, _I, _P, _P, _P, _P, *_SIG, _I,
                              _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                              _F, *_TAIL, *_OPTS, _I, _P, _P, _P, _I, _I,
                              _P],
    },
    "ell_spmv_detect": {
        "abft_ell_spmv_detect": [_P, _P, _U, _P, _I, _I, _P, _P, *_SIG,
                                 _I, _I, *_CALL, _I, _I, _P],
        "abft_ell_spmv_detect_halo": [_P, _P, _U, _P, _I, _I, _P, _I, _I,
                                      _I, _P, *_SIG, _I, _I, *_CALL, _I,
                                      _I, _P],
        # device, halo form, signal planes, blocks per SM out, SMs out
        "abft_ell_spmv_occupancy": [_I, _I, _I, _P, _P],
        "abft_ell_spmv_tile": [],
        "abft_ell_spmv_slab": [],
        "abft_ell_spmv_stages": [],
    },
    "fused_cg_ell": {
        "abft_fused_ell_grid": [_I, _I, _I, _I, _I, _P],
        # ... the tail-free schedule: the window's halo rows, or -1 (l2)
        "abft_fused_cg_ell": [_P, _P, _U, _P, _I, _I, _P, _P, _P, _P,
                              *_SIG, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                              _P, _P, _I, _F, *_TAIL, *_OPTS, _I, _I, _P],
        # device, signal planes, dynamic shared memory, blocks per SM
        # out, SMs out
        "abft_fused_ell_occupancy": [_I, _I, _I, _P, _P],
    },
    "flat_spmv_detect": {
        "abft_flat_spmv_detect": [_P, _P, _U, _P, _P, _I, _P, _P, _I, _P,
                                  _P, *_SIG, _I, _I, *_CALL, _I, _P],
        "abft_flat_spmv_tile": [],
        "abft_flat_spmv_run_rows": [],
    },
}

_libs = {}
_build_seconds = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the cuda target "
            "compiles its kernels at first use")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _out_path(name: str) -> str:
    return os.path.join(BUILD_DIR, _digest(), f"lib{name}.so")


def build():
    """Compile every source whose library of this hash is missing, one
    ``nvcc`` per source, all started together; then load them all."""
    global _build_seconds
    if len(_libs) == len(_SIGNATURES):
        return
    t0 = time.perf_counter()
    procs = []
    for name in _SIGNATURES:
        out = _out_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(_CSRC, f"{name}.cu")
        procs.append((name, out, tmp, subprocess.Popen(
            [_nvcc(), *_FLAGS, "-o", tmp, src])))
    failed = []
    for name, out, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError(f"nvcc failed for csrc/{', '.join(failed)}.cu")
    for name, sigs in _SIGNATURES.items():
        lib = ctypes.CDLL(_out_path(name))
        for fn_name, argtypes in sigs.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    _build_seconds = time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (every library is built
    first if this source hash has not been built yet)."""
    build()
    return _libs[name]


def build_seconds():
    """Seconds the first ``build()`` of this process spent compiling and
    loading (None before that call)."""
    return _build_seconds


def check(rc: int, what: str):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")
