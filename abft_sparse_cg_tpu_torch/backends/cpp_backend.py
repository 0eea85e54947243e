"""The ``cpu`` target: the native C++/OpenMP library through ctypes.

Counterpart of ``abft_sparse_cg_tpu.backends.cpp_backend`` (:1-232), the
drop-in analogue of the reference's cpu context: ``native/abft_cg.cpp``
solves in float64 on the host's cores, independent of the torch plain
versions and of the CUDA kernels.

The library is built from ``native/abft_cg.cpp`` at first use, with the
flags of ``native/Makefile``::

    $CXX -O3 -march=native -fopenmp -fPIC -std=c++17 -Wall
         native/abft_cg.cpp -shared -fopenmp
         -o build/native_cpu/<hash>/libabft_cg.so

keyed by a hash of the flags, the source and the host CPU
(``-march=native`` bakes its instruction set in), under a file lock,
and published by an atomic rename, so concurrent processes never load a
half-written library nor race one compiler against another.  ``$CXX``
is tried first and ``g++`` after it (a ``$CXX`` whose installation
cannot link OpenMP, as on hosts whose ``CXX`` serves nvcc, is named on
stderr).  The JAX package's ``native/libabft_cg.so`` is never loaded.
``cpu-<mode>`` is registered for every mode where the source and a
compiler exist; nothing is built at import.  A build that fails with
every compiler, or a load that fails, raises with the compilers'
stderr.

Write-back semantics: the native kernels scrub the planes they are
given, which are copies (``_plane_args``), so the caller's matrix, its
exec layout and its checksums stay untouched.  Live only: with
``verbose=True`` the native loop prints the rr and correction lines
itself as it runs, and the result carries neither a trace nor a second
correction message; a check interval > 1 warns and runs live.  The
first solve of a process includes the OpenMP team's start-up, inside
the library's own ``solve_ms``, as the JAX target's does.  The refusals
(``devices`` > 1, ``solver="pipelined"``, a ``checkpoint``) carry the
JAX module's texts verbatim, so the CLI prints the same line as
``bin/cg-csr -t cpu``.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from ..device import target_device
from ..ecc.layout import OVERALL_PARITY_BIT
from ..formats.protected import ProtectedMatrix
from ..ops.spmv import ERR_DOUBLE, ERRCODES
from ..tracing import span
from . import registry
from .base import Backend, HostResult
from .torch_backend import jacobi_minv, warn_live_schedule

__all__ = ["CppBackend", "load_library", "library_path", "build_seconds",
           "BUILD_DIR", "SOURCE"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "abft_cg.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native_cpu")
# native/Makefile: $(CXX) $(CXXFLAGS) $< $(LDFLAGS) -o $@
_CXXFLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-Wall")
_LDFLAGS = ("-shared", "-fopenmp")


class _CgResult(ct.Structure):
    _fields_ = [
        ("errcode", ct.c_int),
        ("err_index", ct.c_int64),
        ("corrected_count", ct.c_int64),
        ("first_cor_index", ct.c_int64),
        ("first_cor_bit", ct.c_int),
        ("iterations", ct.c_int),
        ("rr", ct.c_double),
        ("solve_ms", ct.c_double),
    ]


def _compilers():
    """The compilers to try, in order: ``$CXX`` (as the Makefile's
    ``CXX ?= g++`` honours it), then ``g++``; those on this machine."""
    names = dict.fromkeys(filter(None, (os.environ.get("CXX"), "g++")))
    return [c for c in names if shutil.which(c)]


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), so a build directory copied to another machine is
    not loaded there."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(ln for ln in lines
                      if ln.startswith((b"model", b"cpu family", b"flags")))


def library_path() -> str:
    """Where the library of this source, these flags and this host CPU
    lives (whichever compiler built it)."""
    h = hashlib.sha256(" ".join((*_CXXFLAGS, *_LDFLAGS)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_host_cpu())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libabft_cg.so")


_LIB = None
_build_seconds = None


def _build(out: str):
    """Compile the library into ``out`` unless a process already has:
    the first process to take the lock compiles into a private name and
    renames it into place; the others wait, then find it.  Each compiler
    of ``_compilers()`` is tried in turn; one that fails is named on
    stderr when another then succeeds, and if none does, the error
    carries every compiler's stderr."""
    global _build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return
        t0 = time.perf_counter()
        tmp = f"{out}.{os.getpid()}.tmp"
        failures = []
        for cxx in _compilers() or ["g++"]:
            cmd = [cxx, *_CXXFLAGS, SOURCE, *_LDFLAGS, "-o", tmp]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=600)
                err = p.stderr if p.returncode else None
            except (OSError, subprocess.SubprocessError) as e:
                err = str(e)
            if err is None:
                break
            failures.append(f"({' '.join(cmd)}):\n{err}")
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError("building the cpu target's library failed "
                               + "\n".join(failures))
        os.replace(tmp, out)
        _build_seconds = time.perf_counter() - t0
        if failures:
            print("note: the cpu target's library was built by "
                  f"{cmd[0]} after {len(failures)} compiler(s) failed "
                  + "\n".join(failures), file=sys.stderr)


def load_library():
    """The loaded library (built first if this key has no build yet)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = library_path()
    if not os.path.exists(out):
        _build(out)
    lib = ct.CDLL(out)
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.abft_cg_solve.restype = ct.c_int
    lib.abft_cg_solve.argtypes = [
        ct.c_char_p, ct.c_char_p,
        u32p, u32p, u32p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_int64,
        f64p, ct.c_void_p, ct.c_void_p, f64p, ct.c_void_p,
        ct.c_int, ct.c_double, ct.c_int,
        ct.POINTER(_CgResult),
    ]
    lib.abft_spmv.restype = ct.c_int
    lib.abft_spmv.argtypes = [
        ct.c_char_p, ct.c_char_p,
        u32p, u32p, u32p, ct.c_void_p,
        ct.c_void_p, ct.c_int64, ct.c_int64,
        f64p, f64p,
        ct.POINTER(_CgResult),
    ]
    lib.abft_num_threads.restype = ct.c_int
    lib.abft_num_threads.argtypes = []
    _LIB = lib
    return lib


def build_seconds():
    """Seconds this process spent compiling the library (None if it
    found the library built)."""
    return _build_seconds


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ct.c_void_p)


def _plane_args(mat: ProtectedMatrix):
    """Planes in C-ABI order + row_ptr, as real copies: the native
    kernels write corrections back (the reference's scrub semantics),
    which must not change the caller's matrix behind its exec layout
    and checksums.  Returns (the three first planes, the fourth or None,
    row_ptr or None)."""
    planes = {k: v.copy() for k, v in mat.planes.items()}
    if mat.fmt == "csr":
        w = [planes["value_lo"], planes["value_hi"], planes["col"]]
        w3 = None
        row_ptr = np.ascontiguousarray(mat.row_ptr, dtype=np.int64)
    else:
        w = [planes["col"], planes["row"], planes["value_lo"]]
        w3 = planes["value_hi"]
        row_ptr = None
    return w, w3, row_ptr


def _msgs(mat, res):
    """The reference's event lines; the library reports canonical
    indices, so no slot mapping."""
    msgs = []
    opb = mat.layout.col_word * 32 + OVERALL_PARITY_BIT
    if res.first_cor_index >= 0:
        if res.first_cor_bit == opb:
            msgs.append("[ECC] corrected overall parity bit at index "
                        f"{res.first_cor_index}")
        else:
            msgs.append(f"[ECC] corrected bit {res.first_cor_bit} at index "
                        f"{res.first_cor_index}")
    if res.errcode != 0:
        t = ERRCODES[mat.fmt][res.errcode]
        msgs.append(t if res.errcode == ERR_DOUBLE
                    else t.format(index=res.err_index))
    return msgs


class CppBackend(Backend):
    target = "cpu"
    device = target_device("cpu")

    def __init__(self, mode: str):
        self.mode = mode
        self.lib = load_library()

    def solve(self, mat, b, max_itrs, conv_threshold, verbose=True,
              dtype="auto", reps=0, precond="none", check_interval=None,
              devices=0, solver="standard", want_scrubbed="auto",
              checkpoint=None, checkpoint_every=100,
              resume=False) -> HostResult:
        """One float64 solve in the library.  ``dtype`` and ``reps`` are
        accepted and ignored (the native loop is float64, and its host
        clock is exact in one run), and so is ``want_scrubbed``: the
        repaired planes are the library's copies, as in the JAX target,
        and ``HostResult.scrubbed`` stays None."""
        if checkpoint:
            # What the JAX module's signature, which has no checkpoint,
            # makes Python raise.
            raise TypeError(f"{type(self).__name__}.solve() got an "
                            "unexpected keyword argument 'checkpoint'")
        if devices and devices > 1:
            raise ValueError(
                "the native cpu target is single-node (OpenMP threads); "
                "use -t jnp for a mesh-sharded solve")
        if solver != "standard":
            raise ValueError(
                "the native cpu target implements the standard CG loop; "
                "use -t jnp/pallas for --solver pipelined")
        warn_live_schedule(self.target, check_interval)
        w, w3, row_ptr = _plane_args(mat)
        x = np.zeros(mat.N, dtype=np.float64)
        trace = np.full(max_itrs, np.nan)
        res = _CgResult()
        b = np.ascontiguousarray(b, dtype=np.float64)
        minv = jacobi_minv(mat, precond)
        if minv is not None:
            minv = np.ascontiguousarray(minv, dtype=np.float64)
        cks = (None if mat.flat_cksum is None
               else np.ascontiguousarray(mat.flat_cksum))
        if verbose:
            # The library writes its lines to fd 1 itself: what Python
            # printed before (the config echo, the injection banner)
            # must reach it first.
            sys.stdout.flush()
        t0 = time.perf_counter()
        with span("abft_cg_solve"):  # a span for --profile
            self.lib.abft_cg_solve(
                mat.fmt.encode(), self.mode.encode(), w[0], w[1], w[2],
                _ptr(w3), _ptr(row_ptr), mat.N, mat.nnz, b, _ptr(minv),
                _ptr(cks), x, _ptr(trace), max_itrs, conv_threshold,
                1 if verbose else 0, ct.byref(res))
        dt = time.perf_counter() - t0
        msgs = _msgs(mat, res)
        if verbose:
            # The live loop streamed the rr lines and the correction
            # event (the reference's byte order); only detection and
            # fail-stop lines remain for the CLI.
            msgs = [m for m in msgs if not m.startswith("[ECC] corrected")]
        return HostResult(
            x=x,
            iterations=res.iterations,
            rr=res.rr,
            errcode=res.errcode,
            err_index=res.err_index,
            corrected_count=res.corrected_count,
            corrected_index=res.first_cor_index,
            corrected_bit=res.first_cor_bit,
            messages=msgs,
            solve_seconds=res.solve_ms / 1e3 if res.solve_ms else dt,
            compile_seconds=0.0,
            rr_trace=None if verbose else trace,
        )

    def spmv_once(self, mat, x, dtype="auto"):
        w, w3, row_ptr = _plane_args(mat)
        y = np.zeros(mat.N, dtype=np.float64)
        res = _CgResult()
        x = np.ascontiguousarray(x, dtype=np.float64)
        with span("abft_spmv"):
            self.lib.abft_spmv(
                mat.fmt.encode(), self.mode.encode(), w[0], w[1], w[2],
                _ptr(w3), _ptr(row_ptr), mat.N, mat.nnz, x, y,
                ct.byref(res))
        return y, res.errcode, _msgs(mat, res)


def _register():
    from ..ecc.codec import MODES

    if not (os.path.exists(SOURCE) and _compilers()):
        return
    for mode in MODES:
        registry.register("cpu", mode, lambda m=mode: CppBackend(m))


_register()
