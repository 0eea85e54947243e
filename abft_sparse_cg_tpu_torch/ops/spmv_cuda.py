"""Kernels A (``dia_spmv_detect``), C (``ell_spmv_detect``) and E
(``flat_spmv_detect``) and the cuda target's SpmvImpl.

Counterpart of ``abft_sparse_cg_tpu.ops.spmv_pallas`` (DIA, banded ELL)
and ``ops.spmv_unstructured`` (flat): ``dia_fast(md, x, spec)``,
``ell_fast(md, x, spec)`` and ``flat_fast(md, x, spec)`` return ``(w,
trig, pw)`` — the product, the fused pw = x . w and the mode's live
trigger, in one launch (csrc/dia_spmv_detect.cu, csrc/ell_spmv_detect.cu,
csrc/flat_spmv_detect.cu).  ``dia_fast_plain``, ``ell_fast_plain`` and
``flat_fast_plain`` beside them are the same functions in plain
PyTorch: the CPU tests run them, and chip_smoke.py holds each kernel
against its plain version on the card.  ``dia_fast_halo`` and
``ell_fast_halo`` are the per-shard forms of kernels A and C that a
row-sharded solve runs (parallel.sharded_kernel; spmv_pallas.py's
``halo=`` and ``with_base=`` variants): x is the shard's x_ext, its rows
with the neighbour shards' H edge rows on each side, and ``halo=H`` (and
``base``, the shard's first row) in the plain versions give the same
functions.  ``make_cuda_product`` is the
detection-free product of the lazy ``--check-interval`` schedule's
unchecked iterations (spmv_pallas.py:202-235): the same kernels with no
signal plane, the gather masking of the true mode kept.

The wrapper launches the kernel for CUDA tensors and raises on anything
it cannot take; it takes the plain version only for tensors on the CPU.
The rare paths (classify, the ECC ``full`` oracle) stay the plain
ops.spmv implementation, as the reference keeps them in jnp
(spmv_pallas.py:53-55).  A split matrix is ``combine_impls`` of its
parts' impls, each with live detection (spmv_pallas.py:170-179).

Signal schedule of kernel E, a decided divergence: the TPU tier keeps
the flat signals as loop-invariant jnp folds that XLA hoists out of the
solve (spmv_unstructured.py:512-534); kernel E computes them on every
call, as kernels A and C do (ROADMAP.md queue 3).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ecc.codec import ECC_MODES, parity32, widen
from ..ecc.layout import ECC_COL_MASK
from .spmv import (
    ELL_SLAB,
    ELL_STAGES,
    ELL_TILE_ROWS,
    FLAT_RUN_ROWS,
    FLAT_TILE,
    MatrixDevice,
    SpmvImpl,
    SpmvStats,
    _fold_blocks,
    combine_impls,
    dia_product,
    ell_grid,
    ell_product,
    flat_product,
    make_constraints_check,
    make_spmv,
    window_positions,
)

__all__ = ["DiaSpec", "dia_spec", "dia_fast", "dia_fast_plain",
           "dia_fast_halo", "dia_launcher", "ell_launcher", "flat_launcher",
           "EllSpec", "ell_spec", "ell_fast", "ell_fast_plain",
           "ell_fast_halo",
           "FlatSpec", "flat_spec", "flat_fast", "flat_fast_plain",
           "make_cuda_spmv", "make_cuda_product", "product_spec",
           "stream_words", "use_fold"]


def stream_words(mode, layout, fmt) -> tuple:
    """Word-plane indices live detection covers (spmv_pallas.py:283):
    every word in the ECC modes, the index words in constraints mode,
    none in mode none."""
    names = layout.word_names
    if mode in ECC_MODES:
        return tuple(range(len(names)))
    if mode == "constraints":
        idx = {"col"} | ({"row"} if fmt == "coo" else set())
        return tuple(i for i, n in enumerate(names) if n in idx)
    return ()


def use_fold(mode) -> bool:
    """The ECC modes stream the ONE rotated-fold plane (ecc.fold) instead
    of every word plane (spmv_pallas.py:301); constraints never folds."""
    return mode in ECC_MODES


def _mode_signals(mode, mat):
    """(use_parity, use_cksum, streamed words) — spmv_pallas.py:313."""
    use_parity = mode in ("sed", "sec8", "secded")
    use_cksum = mode in ("sec7", "secded", "constraints")
    return use_parity, use_cksum, stream_words(mode, mat.layout, mat.fmt)


class DiaSpec(NamedTuple):
    """Static description of one DIA product with signals.

    ``plane``: None (no signals), "fold" (ECC modes) or the index of the
    first word plane scanned (constraints: the col word); ``plane2``: the
    index of the second one (constraints on COO128: the row word), else
    None.  ``detect`` is False for the detection-free product
    (``product_spec``)."""

    offsets: tuple
    use_parity: bool
    use_cksum: bool
    plane: object
    detect: bool = True
    plane2: object = None


def _signal_plane(mode, mat) -> dict:
    """The signal fields of a spec (use_parity, use_cksum, plane,
    plane2): the planes live detection streams, in codeword-word order —
    none, the fold, or the index words (constraints: col, and row on
    COO128, each against its own baseline; spmv_pallas.py:283-298)."""
    use_parity, use_cksum, sw = _mode_signals(mode, mat)
    planes = ()
    if use_parity or use_cksum:
        planes = ("fold",) if use_fold(mode) else sw
    if len(planes) > 2:
        raise ValueError(f"{mode}: {len(planes)} signal planes, the kernels "
                         "scan at most 2")
    planes = planes + (None,) * (2 - len(planes))
    return dict(use_parity=use_parity, use_cksum=use_cksum,
                plane=planes[0], plane2=planes[1])


def dia_spec(mat, mode) -> DiaSpec:
    if mat.exec_kind != "dia":
        raise ValueError(f"dia_spec: a {mat.exec_kind!r} matrix")
    return DiaSpec(tuple(mat.dia_offsets), **_signal_plane(mode, mat))


class EllSpec(NamedTuple):
    """Static description of one banded-ELL product with signals.

    ``K``: slots per row; ``gather``: "gidx" (an RCM permutation is
    active: the pre-derived exec-space plane) or the index of the word
    plane holding the gather index; ``mask_ecc``: mask the ECC byte off
    that word (the ECC modes, spmv_pallas.py:610-612); ``plane`` as in
    DiaSpec; ``rows``: the matrix's R, the row count of the gather rule
    (a shard's halo form gathers by the global rule from a window);
    ``band``: the exec-space bandwidth of the clean build (formats.
    protected band: every valid gather lies within it of its row), which
    sizes kernel D's window of p (solver.fused.ell_row_plan)."""

    K: int
    use_parity: bool
    use_cksum: bool
    plane: object
    gather: object
    mask_ecc: bool
    detect: bool = True
    rows: int = 0
    plane2: object = None
    band: int = 0


def _gather_source(mat, mode) -> dict:
    """Where an ELL or flat product reads its gather indices: the gidx
    plane under a permutation, else the gather word, ECC byte masked in
    the ECC modes (spmv_pallas.py:610-612)."""
    has_gidx = mat.perm is not None
    return dict(
        gather=("gidx" if has_gidx
                else mat.layout.word_names.index(mat.ell_gather_word)),
        mask_ecc=(not has_gidx and mat.ell_gather_word == "col"
                  and mode in ECC_MODES))


def ell_spec(mat, mode) -> EllSpec:
    if mat.exec_kind != "ell":
        raise ValueError(f"ell_spec: a {mat.exec_kind!r} matrix")
    return EllSpec(mat.K, **_signal_plane(mode, mat),
                   **_gather_source(mat, mode), rows=mat.R, band=mat.band)


class FlatSpec(NamedTuple):
    """Static description of one flat product with signals: ``gather``,
    ``mask_ecc``, ``plane`` and ``plane2`` as in EllSpec, over (E,)
    planes."""

    use_parity: bool
    use_cksum: bool
    plane: object
    gather: object
    mask_ecc: bool
    detect: bool = True
    plane2: object = None


def flat_spec(mat, mode) -> FlatSpec:
    if mat.exec_kind != "flat":
        raise ValueError(f"flat_spec: a {mat.exec_kind!r} matrix")
    return FlatSpec(**_signal_plane(mode, mat), **_gather_source(mat, mode))


def fast_spec(mat, mode):
    """The DiaSpec, EllSpec or FlatSpec of ``mat``'s layout."""
    if mat.exec_kind == "dia":
        return dia_spec(mat, mode)
    if mat.exec_kind == "ell":
        return ell_spec(mat, mode)
    if mat.exec_kind == "flat":
        return flat_spec(mat, mode)
    raise ValueError(f"fast_spec: a {mat.exec_kind!r} matrix")


def product_spec(mat, mode):
    """``fast_spec`` without signals (``_mode_signals(detect=False)``,
    spmv_pallas.py:313): no plane streamed, the gather source and ECC
    masking of the true mode kept."""
    return fast_spec(mat, mode)._replace(use_parity=False, use_cksum=False,
                                         plane=None, plane2=None,
                                         detect=False)


def _signal_planes(md: MatrixDevice, spec) -> tuple:
    """The (plane, baseline) pairs of ``spec``'s signals in codeword-word
    order — () without signals, else one or two pairs of a (D, R) (or
    (E,)) int32 plane and its (R/8,) int32 block checksums."""
    pairs = []
    for p in (spec.plane, spec.plane2):
        if p == "fold":
            pairs.append((md.fold, md.fold_ck[0]))
        elif p is not None:
            pairs.append((md.words[p], md.cksum[p]))
    return tuple(pairs)


def _plane_ptrs(pairs) -> tuple:
    """(plane, baseline, plane2, baseline2) addresses of the C interfaces
    (None where a plane is absent)."""
    pairs = tuple(pairs) + ((None, None),) * (2 - len(pairs))
    return tuple(_ptr(t) for pair in pairs for t in pair)


def signals_plain(md: MatrixDevice, spec) -> torch.Tensor:
    """The trigger of ``spec``'s signals, in plain PyTorch: parity of
    every element over its streamed words, and each plane's 8-row block
    XORs against its own baseline, ORed."""
    pairs = _signal_planes(md, spec)
    trig = torch.zeros((), dtype=torch.bool, device=md.values.device)
    if not pairs:
        return trig
    if spec.use_parity:
        acc = pairs[0][0]
        for plane, _ in pairs[1:]:
            acc = acc ^ plane
        trig = trig | torch.any(parity32(widen(acc)) != 0)
    if spec.use_cksum:
        for plane, base in pairs:
            trig = trig | torch.any(_fold_blocks(plane) != base)
    return trig


def _rows_of(x, halo, R):
    """The shard's own rows of an x_ext (x itself without a halo)."""
    return x if halo is None else x[halo:halo + R]


def dia_fast_plain(md: MatrixDevice, x: torch.Tensor, spec: DiaSpec,
                   halo: int = None):
    """Plain version of kernel A: (w, trig, pw).  ``halo`` H: its per-
    shard form, x = the shard's x_ext of R + 2H rows (ops.spmv.
    dia_product), pw over the shard's own rows."""
    w = dia_product(md.values, spec.offsets, x, halo)
    xs = _rows_of(x, halo, w.shape[0])
    return w, signals_plain(md, spec), torch.sum(xs * w)


def _check_tensor(what, name, t, dtype, shape, device):
    if (t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        got = ("None" if t is None else
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
        raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {device}, "
                         f"got {got}")


def _check_x(x: torch.Tensor, what) -> int:
    """Validate a product's x (a contiguous float32 CUDA vector of R rows,
    R % 32 == 0); returns R."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x on {x.device}, expected cpu or cuda")
    R = x.shape[0]
    if x.dim() != 1 or R % 32:
        raise ValueError(f"{what}: x must be 1-D with R % 32 == 0, got "
                         f"{tuple(x.shape)}")
    _check_tensor(what, "x", x, torch.float32, (R,), x.device)
    return R


def _check_planes(md: MatrixDevice, spec, R, dev, what):
    """Validate the planes of a DIA or ELL product over R rows on
    ``dev``; returns (D or K, the (signal plane, baseline) pairs, gather
    plane or None)."""
    D = len(spec.offsets) if isinstance(spec, DiaSpec) else spec.K
    _check_tensor(what, "values", md.values, torch.float32, (D, R), dev)
    gsrc = None
    if isinstance(spec, EllSpec):
        gsrc = md.gidx if spec.gather == "gidx" else md.words[spec.gather]
        _check_tensor(what, "gather plane", gsrc, torch.int32, (D, R), dev)
        _check_tensor(what, "ell_len", md.ell_len, torch.int32, (R,), dev)
    pairs = _signal_planes(md, spec)
    for plane, base in pairs:
        _check_tensor(what, "signal plane", plane, torch.int32, (D, R), dev)
        _check_tensor(what, "baseline", base, torch.int32, (R // 8,), dev)
    return D, pairs, gsrc


def _check_cuda_args(md: MatrixDevice, x: torch.Tensor, spec, what):
    """Validate x and the planes of a DIA or ELL product; returns (D or
    K, R, the (signal plane, baseline) pairs, gather plane or None)."""
    R = _check_x(x, what)
    D, pairs, gsrc = _check_planes(md, spec, R, x.device, what)
    return D, R, pairs, gsrc


_ELL_MAX_K = 512   # csrc/dia_common.cuh ABFT_MAX_K


def gather_mask(spec: EllSpec) -> int:
    """The AND-mask applied to the gather word before the clamp."""
    return int(ECC_COL_MASK) if spec.mask_ecc else 0xFFFFFFFF


def _offsets_arg(offsets):
    arr = (ctypes.c_int * len(offsets))(*offsets)
    return arr, ctypes.addressof(arr)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_check(x, R, dev, what):
    """A launcher's per-call check of x: a contiguous float32 vector of
    the R rows it was made for, on its device."""
    if (x.device != dev or x.dtype != torch.float32 or x.shape != (R,)
            or not x.is_contiguous()):
        raise ValueError(f"{what}: x must be a contiguous float32 tensor "
                         f"of shape ({R},) on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _call_outputs(x, rows=None):
    """A call's fresh outputs: w (of ``rows`` rows, default x's), the
    0-d bool trigger, the 0-d pw."""
    return (torch.empty_like(x) if rows is None else x.new_empty(rows),
            torch.empty((), dtype=torch.bool, device=x.device),
            torch.empty((), dtype=torch.float32, device=x.device))


def _scratch(grid, dev):
    """(tensor, pw partials pointer, flags pointer) of a launcher's
    scratch: ``grid`` floats and ``grid`` ints, reused by every call on
    its stream (the outputs are not)."""
    t = torch.empty(2 * grid, dtype=torch.int32, device=dev)
    return t, t.data_ptr(), t.data_ptr() + 4 * grid


def dia_launcher(md: MatrixDevice, spec: DiaSpec, dev: torch.device,
                 halo: int = None):
    """Kernel A for ``md`` and ``spec`` on CUDA device ``dev``: checks the
    planes and resolves the library, grid and scratch once; the returned
    function launches the kernel on x (one device launch, no host
    synchronisation) and returns ``(w, trig, pw)``.  Like the other
    launchers it holds ``md``: the kernel reads its planes by address.  ``halo`` H: the
    per-shard form (``dia_fast_halo``), x is the shard's x_ext of R + 2H
    rows."""
    from .._build import check, library

    what = "dia_fast" if halo is None else "dia_fast_halo"
    R = md.values.shape[-1] if md.values is not None else -1
    D, pairs, _ = _check_planes(md, spec, R, dev, what)
    for name, t in (("values", md.values),
                    *(("signal plane", p) for p, _ in pairs)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if halo is not None and max(map(abs, spec.offsets)) > halo:
        raise ValueError(f"{what}: halo {halo} under the offsets "
                         f"{spec.offsets}")
    lib = library("dia_spmv_detect")
    scratch, part, flags = _scratch(lib.abft_dia_spmv_grid(R), dev)
    offs, offs_ptr = _offsets_arg(spec.offsets)
    sig = (*_plane_ptrs(pairs), int(spec.use_parity), int(spec.use_cksum),
           part, flags)
    head = (md.values.data_ptr(), offs_ptr, D, R)
    if halo is None:
        fn, counter, rows, mid = lib.abft_dia_spmv_detect, dia_fast, R, ()
    else:
        fn, counter = lib.abft_dia_spmv_detect_halo, dia_fast_halo
        rows, mid = R + 2 * halo, (halo,)
    index, product, two = dev.index, not spec.detect, len(pairs) == 2

    def launch(x, _keep=(md, offs, scratch)):
        _launch_check(x, rows, dev, what)
        w, trig, pw = _call_outputs(x, R)
        check(fn(*head, x.data_ptr(), *mid, w.data_ptr(), *sig,
                 pw.data_ptr(), trig.data_ptr(), index,
                 torch.cuda.current_stream(dev).cuda_stream),
              f"{what} launch")
        _count_launch(counter, product, two)
        return w, trig, pw

    return launch


def dia_fast(md: MatrixDevice, x: torch.Tensor, spec: DiaSpec):
    """Kernel A: ``(w, trig, pw)`` for CUDA tensors; the plain version
    for CPU tensors.  ``trig`` is a 0-d bool tensor, ``pw`` a 0-d float
    tensor (no host synchronisation).  The solvers call ``dia_launcher``
    once per matrix instead (make_cuda_spmv)."""
    if x.device.type == "cpu":
        return dia_fast_plain(md, x, spec)
    return dia_launcher(md, spec, x.device)(x)


def _count_launch(counter, product, two):
    """One launch of a kernel A, C or E wrapper's kernel: ``product``, the
    detection-free product; ``two``, the two-plane instance (constraints
    mode on COO128)."""
    counter.launches += 1
    if product:
        counter.product_launches += 1
    if two:
        counter.two_plane_launches += 1


dia_fast.launches = 0
dia_fast.product_launches = 0   # the detection-free product's share
dia_fast.two_plane_launches = 0   # the two-plane instance's share


def dia_fast_halo(md: MatrixDevice, x: torch.Tensor, spec: DiaSpec,
                  halo: int):
    """Kernel A's per-shard form (the TPU kernel's ``halo=`` variant):
    ``md`` holds one shard's R rows, x is its x_ext of R + 2 * ``halo``
    rows; ``(w, trig, pw)`` as ``dia_fast``, pw over the shard's rows.
    The plain version for CPU tensors.  A sharded solve calls
    ``dia_launcher(md, spec, dev, halo)`` once per shard instead."""
    if x.device.type == "cpu":
        return dia_fast_plain(md, x, spec, halo)
    return dia_launcher(md, spec, x.device, halo)(x)


dia_fast_halo.launches = 0
dia_fast_halo.product_launches = 0
dia_fast_halo.two_plane_launches = 0


def ell_gather_plane(md: MatrixDevice, spec) -> torch.Tensor:
    """The gather indices kernel C (EllSpec) or E (FlatSpec) reads, before
    the clamp: the masked col word or the gidx plane."""
    g = md.gidx if spec.gather == "gidx" else md.words[spec.gather]
    return g & int(ECC_COL_MASK) if spec.mask_ecc else g


def ell_fast_plain(md: MatrixDevice, x: torch.Tensor, spec: EllSpec,
                   halo: int = None, base: int = 0):
    """Plain version of kernel C: (w, trig, pw).  ``halo`` H: its per-
    shard form, x = the shard's x_ext of R_loc + 2H rows, ``base`` the
    shard's first row; each global gather index reads the window
    (ops.spmv.window_positions), pw over the shard's own rows."""
    g = ell_gather_plane(md, spec)
    if halo is not None:
        g = window_positions(g, spec.rows, base, halo, x.shape[0])
    w = ell_product(md.values, g, md.ell_len, x)
    xs = _rows_of(x, halo, w.shape[0])
    return w, signals_plain(md, spec), torch.sum(xs * w)


def ell_launcher(md: MatrixDevice, spec: EllSpec, dev: torch.device,
                 halo: int = None, base: int = 0):
    """Kernel C for ``md`` and ``spec`` on CUDA device ``dev``: checks the
    planes and their alignment, K, R and the halo window once, and
    resolves the library, the grid (the card's resident blocks, ops.spmv.
    ell_grid) and the scratch once; the returned function launches the
    kernel on x (one device launch, no host synchronisation) and returns
    ``(w, trig, pw)``.  ``halo`` H: the per-shard form
    (``ell_fast_halo``), x is the shard's x_ext of R + 2H rows and
    ``base`` the shard's first global row."""
    from .._build import check, library

    what = "ell_fast" if halo is None else "ell_fast_halo"
    R = md.values.shape[-1] if md.values is not None else -1
    if R < 32 or R % 32:
        raise ValueError(f"{what}: R must be a positive multiple of 32, "
                         f"got {R}")
    K, pairs, gsrc = _check_planes(md, spec, R, dev, what)
    if not 1 <= K <= _ELL_MAX_K:
        raise ValueError(f"{what}: K {K} outside [1, {_ELL_MAX_K}]")
    for name, t in (("values", md.values), ("gather plane", gsrc),
                    *(("signal plane", p) for p, _ in pairs)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if halo is not None and (halo < 0 or not 0 < spec.rows < 2 ** 31
                             or not 0 <= base < spec.rows):
        raise ValueError(f"{what}: halo {halo}, base {base} outside the "
                         f"{spec.rows} rows of the matrix")
    lib = library("ell_spmv_detect")
    if (lib.abft_ell_spmv_tile(), lib.abft_ell_spmv_slab(),
            lib.abft_ell_spmv_stages()) != (ELL_TILE_ROWS, ELL_SLAB,
                                            ELL_STAGES):
        raise RuntimeError("ell_fast: the kernel's schedule differs from "
                           "ops.spmv's ELL_* constants")
    index = dev.index
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    check(lib.abft_ell_spmv_occupancy(
        index, int(halo is not None), max(len(pairs), 1),
        ctypes.addressof(per_sm), ctypes.addressof(sms)),
        f"{what} occupancy")
    grid = ell_grid(R, sms.value, per_sm.value)
    scratch, part, flags = _scratch(grid, dev)
    head = (md.values.data_ptr(), gsrc.data_ptr(), gather_mask(spec),
            md.ell_len.data_ptr(), K, R)
    sig = (*_plane_ptrs(pairs), int(spec.use_parity), int(spec.use_cksum),
           part, flags)
    if halo is None:
        fn, counter, rows, mid = lib.abft_ell_spmv_detect, ell_fast, R, ()
    else:
        fn, counter = lib.abft_ell_spmv_detect_halo, ell_fast_halo
        rows, mid = R + 2 * halo, (halo, spec.rows, base)
    product, two = not spec.detect, len(pairs) == 2

    def launch(x, _keep=(md, scratch)):
        _launch_check(x, rows, dev, what)
        w, trig, pw = _call_outputs(x, R)
        check(fn(*head, x.data_ptr(), *mid, w.data_ptr(), *sig,
                 pw.data_ptr(), trig.data_ptr(), grid, index,
                 torch.cuda.current_stream(dev).cuda_stream),
              f"{what} launch")
        _count_launch(counter, product, two)
        return w, trig, pw

    return launch


def ell_fast(md: MatrixDevice, x: torch.Tensor, spec: EllSpec):
    """Kernel C: ``(w, trig, pw)`` for CUDA tensors; the plain version
    for CPU tensors.  ``trig`` is a 0-d bool tensor, ``pw`` a 0-d float
    tensor (no host synchronisation).  The solvers call ``ell_launcher``
    once per matrix instead (make_cuda_spmv)."""
    if x.device.type == "cpu":
        return ell_fast_plain(md, x, spec)
    return ell_launcher(md, spec, x.device)(x)


ell_fast.launches = 0
ell_fast.product_launches = 0   # the detection-free product's share
ell_fast.two_plane_launches = 0   # the two-plane instance's share


def ell_fast_halo(md: MatrixDevice, x: torch.Tensor, spec: EllSpec,
                  halo: int, base: int):
    """Kernel C's per-shard form (the TPU kernel's ``halo=True,
    with_base=True`` variant): ``md`` holds one shard's R_loc rows of the
    planes as built (global gather indices), x is its x_ext of R_loc + 2
    * ``halo`` rows, ``base`` its first global row; ``(w, trig, pw)`` as
    ``ell_fast``.  The plain version for CPU tensors.  A sharded solve
    calls ``ell_launcher(md, spec, dev, halo, base)`` once per shard
    instead."""
    if x.device.type == "cpu":
        return ell_fast_plain(md, x, spec, halo, base)
    return ell_launcher(md, spec, x.device, halo, base)(x)


ell_fast_halo.launches = 0
ell_fast_halo.product_launches = 0
ell_fast_halo.two_plane_launches = 0


def flat_fast_plain(md: MatrixDevice, x: torch.Tensor, spec: FlatSpec):
    """Plain version of kernel E: (w, trig, pw); w in kernel E's
    summation order (ops.spmv.flat_product)."""
    w = flat_product(md.values, ell_gather_plane(md, spec), md.row_ptr, x)
    return w, signals_plain(md, spec), torch.sum(x * w)


def flat_launcher(md: MatrixDevice, spec: FlatSpec, dev: torch.device):
    """Kernel E for ``md`` and ``spec`` on CUDA device ``dev``: checks the
    planes and the row-block plan and resolves the library and scratch
    once; the returned function launches the kernel on x (one device
    launch, no host synchronisation) and returns ``(w, trig, pw)``."""
    from .._build import check, library

    what = "flat_fast"
    E = md.values.shape[0] if md.values is not None else -1
    if E < 8 or E % 8:
        raise ValueError(f"{what}: flat planes must hold a multiple of 8 "
                         f"slots, got {E}")
    R = md.row_ptr.shape[0] - 1 if md.row_ptr is not None else -1
    if R < 32 or R % 32:
        raise ValueError(f"{what}: R must be a positive multiple of 32, "
                         f"got {R}")
    _check_tensor(what, "values", md.values, torch.float32, (E,), dev)
    gsrc = md.gidx if spec.gather == "gidx" else md.words[spec.gather]
    _check_tensor(what, "gather plane", gsrc, torch.int32, (E,), dev)
    _check_tensor(what, "row_ptr", md.row_ptr, torch.int32, (R + 1,), dev)
    nblocks = md.flat_plan.shape[0] if md.flat_plan is not None else 0
    _check_tensor(what, "flat_plan", md.flat_plan, torch.int32,
                  (nblocks, 4), dev)
    _check_tensor(what, "flat_sync", md.flat_sync, torch.int32, (nblocks,),
                  dev)
    pairs = _signal_planes(md, spec)
    for plane, base in pairs:
        _check_tensor(what, "signal plane", plane, torch.int32, (E,), dev)
        _check_tensor(what, "baseline", base, torch.int32, (E // 8,), dev)
    lib = library("flat_spmv_detect")
    if (lib.abft_flat_spmv_tile(), lib.abft_flat_spmv_run_rows()) != (
            FLAT_TILE, FLAT_RUN_ROWS):
        raise RuntimeError("flat_fast: the kernel's tile differs from "
                           "ops.spmv.flat_row_blocks'")
    scratch, part, flags = _scratch(nblocks, dev)
    carry = torch.empty(32 * nblocks, dtype=torch.float32, device=dev)
    head = (md.values.data_ptr(), gsrc.data_ptr(), gather_mask(spec),
            md.row_ptr.data_ptr(), md.flat_plan.data_ptr(), nblocks,
            carry.data_ptr(), md.flat_sync.data_ptr(), R)
    sig = (*_plane_ptrs(pairs), int(spec.use_parity), int(spec.use_cksum),
           part, flags)
    fn, index, product = lib.abft_flat_spmv_detect, dev.index, not spec.detect
    two = len(pairs) == 2

    def launch(x, _keep=(md, scratch, carry)):
        _launch_check(x, R, dev, what)
        w, trig, pw = _call_outputs(x)
        check(fn(*head, x.data_ptr(), w.data_ptr(), *sig, pw.data_ptr(),
                 trig.data_ptr(), index,
                 torch.cuda.current_stream(dev).cuda_stream),
              "flat_spmv_detect launch")
        _count_launch(flat_fast, product, two)
        return w, trig, pw

    return launch


def flat_fast(md: MatrixDevice, x: torch.Tensor, spec: FlatSpec):
    """Kernel E: ``(w, trig, pw)`` for CUDA tensors; the plain version
    for CPU tensors.  ``trig`` is a 0-d bool tensor, ``pw`` a 0-d float
    tensor (no host synchronisation).  The solvers call
    ``flat_launcher`` once per matrix instead (make_cuda_spmv)."""
    if x.device.type == "cpu":
        return flat_fast_plain(md, x, spec)
    return flat_launcher(md, spec, x.device)(x)


flat_fast.launches = 0
flat_fast.product_launches = 0   # the detection-free product's share
flat_fast.two_plane_launches = 0   # the two-plane instance's share

_KERNELS = {DiaSpec: dia_fast, EllSpec: ell_fast, FlatSpec: flat_fast}
# Every kernel checks its planes and resolves its library, grid and
# scratch once per matrix device, so a call is its x check and one
# launch.  What bounds kernel C on the card is its bytes: ~421 MB per
# secded call at dense-radius-3d -b 10 (0.126 ms at 3.35 TB/s), staged
# through shared memory with cp.async so that the loads in flight do not
# depend on registers, on a grid of the card's resident blocks; its
# measured times against that bound are in PERF.md §6.
_LAUNCHERS = {DiaSpec: dia_launcher, EllSpec: ell_launcher,
              FlatSpec: flat_launcher}


def _kernel_impl(spec):
    """``(fast, fast_pw)`` of ``spec``'s kernel: on a CUDA tensor the
    kernel launches through a launcher made for the last ``md`` it was
    given (a repair hands it a new one); CPU tensors take the plain
    version."""
    kernel = _KERNELS[type(spec)]
    make = _LAUNCHERS[type(spec)]
    last = [None, None, None]     # md, device, launcher

    def fast_pw(md, x):
        if x.device.type == "cpu":
            return kernel(md, x, spec)
        if last[0] is not md or last[1] != x.device:
            last[:] = md, x.device, make(md, spec, x.device)
        return last[2](x)

    def fast(md, x):
        w, trig, _ = fast_pw(md, x)
        return w, trig

    return fast, fast_pw


def make_cuda_spmv(mat, dtype=torch.float32, mode: str = None) -> SpmvImpl:
    """The cuda target's SpmvImpl (counterpart of make_pallas_spmv,
    spmv_pallas.py:153-199): kernel A (DIA), C (ELL) or E (flat) as
    ``fast``/``fast_pw``, the plain ops.spmv paths for the rare ones; a
    split is ``combine_impls`` of its parts' impls (A or C for the main,
    E for the tail).  Its consumers are ``spmv_once`` (``full``) and the
    per-iteration tier of the solve (solver.cg)."""
    mode = mat.mode if mode is None else mode
    if mat.exec_kind == "split":
        return combine_impls(make_cuda_spmv(mat.main, dtype, mode),
                             make_cuda_spmv(mat.tail, dtype, mode),
                             mat.main.exec_size)
    fast, fast_pw = _kernel_impl(fast_spec(mat, mode))
    return _wrap_mode(mat, dtype, mode, fast, fast_pw)


def make_cuda_product(mat, dtype=torch.float32, mode: str = None
                      ) -> SpmvImpl:
    """The detection-free product of the lazy ``--check-interval``
    schedule's unchecked iterations (make_pallas_product, spmv_pallas.py:
    202-235): kernel A, C or E under ``product_spec``, the same
    arithmetic as the checked kernel and a constant-False trigger.  A
    split combines its parts' products.  Divergence: the JAX function
    keeps a split tail's checked impl, whose trigger only detects early;
    the unchecked iterations here read no trigger, so the tail runs its
    product too (the rollback lands on the same snapshot)."""
    mode = mat.mode if mode is None else mode
    if mat.exec_kind == "split":
        return combine_impls(make_cuda_product(mat.main, dtype, mode),
                             make_cuda_product(mat.tail, dtype, mode),
                             mat.main.exec_size)
    fast, fast_pw = _kernel_impl(product_spec(mat, mode))
    return SpmvImpl(full=None, fast=fast, fast_pw=fast_pw)


def _wrap_mode(mat, dtype, mode, fast, fast_pw):
    """SpmvImpl around a kernel's ``fast``/``fast_pw`` (spmv_pallas.py:
    238): the plain classify for the rare path, a mode-specific full()."""
    plain = make_spmv(mat, dtype, mode)
    if mode == "constraints":
        check = make_constraints_check(mat)

        def full_cons(md, x):
            w, _ = fast(md, x)
            return w, check(md)

        return SpmvImpl(full=full_cons, fast=fast, classify=plain.classify,
                        fast_pw=fast_pw)
    if mode == "none":
        def full_none(md, x):
            w, _ = fast(md, x)
            return w, SpmvStats.clean()

        return SpmvImpl(full=full_none, fast_pw=fast_pw)
    return SpmvImpl(full=plain.full, fast=fast, classify=plain.classify,
                    fast_pw=fast_pw)
