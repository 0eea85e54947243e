"""Whole-solve fused CG: kernels B (``fused_cg_dia``) and D
(``fused_cg_ell``) and their outer loop.

Counterpart of ``abft_sparse_cg_tpu.solver.fused`` for the DIA and
banded-ELL layouts and for bordered splits of either with a dense-plan
tail (``_plan_split``, fused.py:381-436), every mode, unpreconditioned
or Jacobi (``precond``), live or lazy detection (``check_interval``).
The fast loop runs inside one persistent cooperative CUDA kernel
(csrc/fused_cg_dia.cu, csrc/fused_cg_ell.cu) that exits on convergence,
``upto``, a trigger or a breakdown; a split runs the kernels' instance
with the split tail (span-window dense rows, mirrored AXPYs and the
tail's live signals, csrc/dia_common.cuh).  The Jacobi instances keep
M^-1 as one more vector; the lazy ones read the signal planes every
CI-th iteration, keep a verified snapshot and close the exit window
in-kernel (dia_common.cuh CgOpts).  One kernel family covers what the
TPU splits into a resident and a streaming kernel (fused.py:1263): the
H100 has no resident-vector envelope.  The rare classify/repair stays
the plain ops.spmv path in the outer loop, with the reference's
livelock guard (fused.py:2120-2148) and, under the lazy schedule,
solver.cg's rollback resolution (fused.py:2150-2164).

``fused_cg_dia`` / ``fused_cg_ell`` launch their kernel for CUDA tensors
and run ``fused_cg_dia_plain`` / ``fused_cg_ell_plain`` — a Python loop
with the same exit semantics — for CPU tensors.  All update x, r and p
in place; an iteration that triggers or breaks down changes none of
them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..ops.spmv import ERR_BREAKDOWN, SpmvStats, make_spmv
from ..ops.spmv_cuda import (
    DiaSpec,
    EllSpec,
    _check_cuda_args,
    _check_tensor,
    _offsets_arg,
    _plane_ptrs,
    _ptr,
    _signal_plane,
    _signal_planes,
    dia_fast_plain,
    ell_fast_plain,
    fast_spec,
    gather_mask,
    signals_plain,
)
from ..tracing import count, span
from .cg import (
    CGState,
    _baseline_changed,
    _lazy_exit_resolve,
    _phantom_guard,
    solver_of,
)

__all__ = ["supports_fused", "make_fused_continue", "make_fused_solver",
           "fused_cg_dia", "fused_cg_dia_plain", "fused_cg_ell",
           "fused_cg_ell_plain", "TailSpec", "tail_spec", "split_tail_plain",
           "tail_chunk", "tail_tiles", "Snapshot", "FusedOut", "SCHEDULES",
           "FOLD_MAX_HALO", "WINDOW_MAX", "WINDOW_MAX_SMEM", "WindowPlan",
           "dia_window_plan", "dia_schedule", "dia_block_rows",
           "ELL_SCHEDULES", "ELL_MAX_BLOCKS_PER_SM", "ell_ring_bytes",
           "ell_halo", "ell_window_rows", "ell_row_plan", "ell_plan"]

_MAX_K = 512        # csrc/dia_common.cuh ABFT_MAX_K
_MAX_T = 64         # csrc/dia_common.cuh ABFT_MAX_T
TILE_ROWS = 128     # the rows of one window-mask tile (dia_common.cuh)
# Kernel B's tail-free schedules (csrc/fused_cg_dia.cu): "fold" runs the
# update of each iteration in the next one's product pass (two grid
# barriers per iteration, halo rows of p recomputed), "window" and
# "three-sync" a pass of its own (three).  The fold stages max|offset|
# halo rows on either side of a tile in shared memory, at most
# FOLD_MAX_HALO (kFoldHalo); it was the faster schedule at every halo up
# to that cap (PERF.md §6).  Past the cap, "window" stages p in shared
# memory too, one window per cluster of offsets (dia_window_plan), where
# its two window sets fit WINDOW_MAX_SMEM (kWindowSmem), and "three-sync"
# gathers p from device memory where they do not.
SCHEDULES = ("fold", "three-sync", "window")
FOLD_MAX_HALO = 512
DIA_TILE = 1024                # kTile: the rows of one tile of kernel B
WINDOW_MAX = 8                 # kMaxWindows
WINDOW_MAX_SMEM = 48 * 1024    # kWindowSmem
_SCHEDULE_CODES = {"three-sync": 0, "fold": 1, "window": 2}
# Kernel D's tail-free schedules (csrc/fused_cg_ell.cu): in the modes with
# signals, the staged plane stream, gathering p from a band window in
# shared memory that each block stages after the barrier publishing p
# (its rows of ops.spmv.ell_block_rows and ell_halo(band) rows on either
# side: "window") or from device memory ("l2"), in blocks of 128 threads,
# at most ELL_MAX_BLOCKS_PER_SM per SM (kMaxRowBlocksPerSM), as many as
# their ring (ell_ring_bytes: kernel C's 4 stages of 4-slot slabs of the
# value, gather and signal planes) and window leave room for
# (ell_row_plan); in mode none, the first design's loop, one row per
# thread, grid-strided ("grid-stride": it was the faster there, PERF.md
# §6).
ELL_SCHEDULES = ("window", "l2", "grid-stride")
ELL_MAX_BLOCKS_PER_SM = 7
ELL_MAX_SMEM = 232448          # 227 KB: the most one block may take


def supports_fused(mat, dtype, precond=False, check_interval=1) -> bool:
    """The envelope of kernels B and D: a DIA matrix, an ELL matrix of at
    most 512 slots per row, or a bordered split of either whose flat
    tail has a dense plan with 128-aligned spans (fused.py:381-401);
    float32.  Flat matrices and band splits (no dense plan) take the
    per-iteration tier, as on the TPU.  ``precond`` and
    ``check_interval`` narrow nothing: every instance holds its vectors
    in device memory, where the TPU's budget of resident vectors
    (fused.py:257-277) has no counterpart."""
    if dtype != torch.float32 or mat.R % 32:
        return False
    if mat.exec_kind == "split":
        tp = mat.tail.dense_plan
        if tp is None or mat.tail.exec_kind != "flat":
            return False
        rows, starts, S = tp
        if S % 128 or any(st % 128 for st in starts) or len(rows) > _MAX_T:
            return False
        return supports_fused(mat.main, dtype, precond, check_interval)
    if mat.exec_kind == "dia":
        return len(mat.dia_offsets) > 0
    return mat.exec_kind == "ell" and mat.K <= _MAX_K


class WindowPlan(NamedTuple):
    """Kernel B's windows (csrc/fused_cg_dia.cu WindowPlan): window c
    holds the rows [lo + starts[c], hi + starts[c] + ext[c]) of a tile
    [lo, hi), each a multiple of 4; ``window[d]`` is the window that
    diagonal d (in the matrix's order) reads."""

    starts: tuple
    ext: tuple
    window: tuple

    @property
    def set_floats(self) -> int:
        """The floats of one window set (a whole tile's windows)."""
        return sum(DIA_TILE + e for e in self.ext)


def dia_window_plan(offsets):
    """The window schedule's plan for these diagonal offsets, or None
    where its two window sets pass WINDOW_MAX_SMEM or WINDOW_MAX windows.
    The sorted offsets split into clusters wherever two neighbours lie
    more than a tile apart (a new window stages a tile's rows; bridging
    the gap would stage the gap's); a cluster's window starts at its
    least offset rounded down to a multiple of 4 and reaches its greatest
    (ext rounded up to a multiple of 4)."""
    offs = sorted({int(o) for o in offsets})
    clusters = [[offs[0]]]
    for o in offs[1:]:
        if o - clusters[-1][-1] > DIA_TILE:
            clusters.append([o])
        else:
            clusters[-1].append(o)
    starts = tuple(c[0] // 4 * 4 for c in clusters)
    ext = tuple(-(-(c[-1] - st) // 4) * 4 for c, st in zip(clusters, starts))
    cluster_of = {o: i for i, c in enumerate(clusters) for o in c}
    plan = WindowPlan(starts, ext,
                      tuple(cluster_of[int(o)] for o in offsets))
    if (len(clusters) > WINDOW_MAX
            or 2 * 4 * plan.set_floats > WINDOW_MAX_SMEM):
        return None
    return plan


def dia_schedule(offsets) -> str:
    """Kernel B's tail-free schedule for a DIA matrix of these diagonal
    offsets, resolved once per matrix."""
    if max(abs(int(o)) for o in offsets) <= FOLD_MAX_HALO:
        return "fold"
    return "window" if dia_window_plan(offsets) is not None else "three-sync"


_dia_plans = {}


def _dia_plan(offsets, schedule=None):
    """(schedule, its window plan as the C interface's ``windows`` takes
    it, or None) of a tail-free launch over these offsets, ``schedule``
    forcing one; cached per offsets, so that a solve's launches pay a
    lookup."""
    key = (offsets, schedule)
    if key not in _dia_plans:
        sched = schedule or dia_schedule(offsets)
        halo = max(abs(int(o)) for o in offsets)
        if sched == "fold" and halo > FOLD_MAX_HALO:
            raise ValueError(f"fused_cg_dia: the fold schedule takes "
                             f"offsets up to {FOLD_MAX_HALO}")
        wins = None
        if sched == "window":
            plan = dia_window_plan(offsets)
            if plan is None:
                raise ValueError(f"fused_cg_dia: the windows of these "
                                 f"offsets pass {WINDOW_MAX_SMEM} bytes")
            vals = (len(plan.starts), *plan.starts, *plan.ext, *plan.window)
            wins = (ctypes.c_int * len(vals))(*vals)
        _dia_plans[key] = (sched, wins)
    return _dia_plans[key]


def ell_halo(band: int) -> int:
    """The rows kernel D's window holds on either side of a block's rows:
    the band rounded up to a multiple of 4 (16-byte copies)."""
    return -(-int(band) // 4) * 4


def ell_ring_bytes(planes: int = 1) -> int:
    """The shared-memory ring of kernel D's staged stream: 4 stages of
    4-slot slabs of 128 rows of the value and gather planes and each
    signal plane (csrc/fused_cg_ell.cu kRingBytes)."""
    return 4 * (2 + planes) * 4 * 128 * 4


def ell_window_rows(R: int, grid: int, band: int) -> int:
    """The rows of p the largest block of kernel D's tail-free grid
    stages under the window schedule: its rows of ops.spmv.ell_block_rows
    and ell_halo(band) on either side (csrc/fused_cg_ell.cu row_smem)."""
    return -(-(R // 32) // grid) * 32 + 2 * ell_halo(band)


def ell_row_plan(R: int, band: int, planes: int, sms: int, occupancy,
                 schedule=None):
    """(grid, schedule) of kernel D's staged stream for an ELL matrix of
    R rows and this exec-space band, streaming ``planes`` signal planes,
    on a card of ``sms`` SMs, where ``occupancy(smem)`` gives the resident
    blocks per SM of the instances at ``smem`` bytes of dynamic shared
    memory (abft_fused_ell_occupancy).  The window schedule takes the most blocks per SM (at
    most ELL_MAX_BLOCKS_PER_SM, at most one per warp of rows) at which
    the ring and the largest block's window fit; the l2 schedule those
    the ring alone allows.  Unforced, "window" wherever it reaches half
    the l2 schedule's blocks per SM, else "l2" (on dense-radius-3d -b 10
    the l2 gathers at 7 blocks per SM took 1.5-4.3% longer than the
    window at 5, scripts/torch_d_probe.py; the threshold itself is not
    probed).  The same for every instance of one matrix and plane
    count."""
    W = R // 32
    ring = ell_ring_bytes(planes)
    l2 = min(ELL_MAX_BLOCKS_PER_SM, occupancy(ring))
    for per_sm in range(ELL_MAX_BLOCKS_PER_SM, 0, -1):
        if schedule == "l2" or (schedule is None and 2 * per_sm < l2):
            break
        grid = max(1, min(sms * per_sm, W))
        smem = ring + 4 * ell_window_rows(R, grid, band)
        if smem <= ELL_MAX_SMEM and occupancy(smem) >= per_sm:
            return grid, "window"
    if schedule == "window":
        raise ValueError(f"fused_cg_ell: a band of {band} leaves no room "
                         f"for the window")
    return max(1, min(sms * l2, W)), "l2"


_plans = {}


def ell_plan(device_index: int, R: int, band: int, planes: int = 1,
             schedule=None):
    """``ell_row_plan`` on a card, with its occupancy query (cached per
    matrix shape, signal planes and card)."""
    key = (device_index, R, band, planes, schedule)
    if key not in _plans:
        from .._build import check, library

        lib = library("fused_cg_ell")
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)

        def occupancy(smem):
            check(lib.abft_fused_ell_occupancy(
                device_index, planes, smem, ctypes.addressof(per_sm),
                ctypes.addressof(sms)), "fused_cg_ell occupancy query")
            return per_sm.value

        occupancy(0)
        _plans[key] = ell_row_plan(R, band, planes, sms.value, occupancy,
                                   schedule)
    return _plans[key]


def dia_block_rows(R: int, grid: int) -> int:
    """Rows per block of kernel B's tail-free instances: block b owns
    rows [b nb, (b + 1) nb), nb = ceil(R / grid) rounded up to a multiple
    of 8 (so that an 8-row checksum block never straddles two blocks)."""
    nb = -(-R // grid)
    return -(-nb // 8) * 8


class TailSpec(NamedTuple):
    """Static description of a split's dense-plan tail: outlier exec
    rows, span starts, span width, and the tail's signals (``plane`` and
    ``plane2`` as in ops.spmv_cuda.DiaSpec, over the tail's (E,)
    planes)."""

    rows: tuple
    starts: tuple
    S: int
    use_parity: bool
    use_cksum: bool
    plane: object
    plane2: object = None


def tail_spec(mat, mode) -> TailSpec:
    rows, starts, S = mat.tail.dense_plan
    return TailSpec(tuple(rows), tuple(starts), S,
                    **_signal_plane(mode, mat.tail))


def split_tail_plain(mdt, ts: TailSpec, p, w):
    """The split tail of kernels B and D in plain PyTorch: ``w`` (the
    main product) plus, for each outlier t in turn, its dense row's dot
    product at o_t and its mirrored AXPY over its window — the kernels'
    order for every element; the dot products themselves are summed in
    another order than the kernels' chunks.  Returns (w, trig, pw)."""
    S = ts.S
    xs = torch.stack([p[st:st + S] for st in ts.starts])
    wa = torch.sum(mdt.dense_td * xs, dim=1)
    w = w.clone()
    for t, (o, st) in enumerate(zip(ts.rows, ts.starts)):
        w[o] = w[o] + wa[t]
        w[st:st + S] = w[st:st + S] + p[o] * mdt.dense_tb[t]
    return w, signals_plain(mdt, ts), torch.sum(p * w)


def tail_chunk(S: int, T: int, grid: int) -> int:
    """Length of the split tail's dense-row chunks (dia_common.cuh::
    tail_dense_chunk): the T rows of span S cut into at most ``grid``
    chunks in all, each a multiple of 128 slots, so that one round of the
    grid's blocks sums them, at most one chunk per block."""
    per = max(1, grid // T)          # chunks per dense row
    chunk = -(-S // per)
    return -(-chunk // TILE_ROWS) * TILE_ROWS


def tail_tiles(starts, S: int, R: int) -> np.ndarray:
    """The split tail's window table (dia_common.cuh::tail_axpy): one
    uint64 per 128-row tile of the R rows, bit t set where the tile lies
    inside window t, [starts[t], starts[t] + S) (starts and S are
    multiples of 128, so a tile is wholly inside or outside each)."""
    tiles = np.zeros(R // TILE_ROWS, np.uint64)
    for t, st in enumerate(starts):
        tiles[st // TILE_ROWS:(st + S) // TILE_ROWS] |= np.uint64(1 << t)
    return tiles


class Snapshot(NamedTuple):
    """The lazy instances' last verified state: itr, x, r, p, rr, rz."""

    itr: int
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rr: torch.Tensor
    rz: torch.Tensor


class FusedOut(NamedTuple):
    """What kernels B and D return: ints for itr/trig/err, 0-d tensors
    for rr/rz, and the Snapshot of a lazy run (None when live)."""

    itr: int
    rr: torch.Tensor
    rz: torch.Tensor
    trig: int
    err: int
    snap: object = None


def _lazy_ci(spec, ci: int) -> int:
    """The check interval a launch runs: mode none has no signals, so a
    lazy request runs live (fused.py:257)."""
    ci = int(ci)
    if ci < 1:
        raise ValueError(f"check interval {ci} < 1")
    return ci if spec.plane is not None else 1


def _cg_loop_plain(fast_plain, md, spec, x, r, p, rr, rz, itr, upto, conv,
                   trace, tail=None, minv=None, ci=1):
    """The fused kernels' loop in plain PyTorch around one product (and
    ``tail`` = (tail MatrixDevice, TailSpec) of a split), with the Jacobi
    recurrences when ``minv`` is given and the lazy schedule when ``ci``
    > 1 (the same snapshot and exit-window close as the kernels)."""
    ci = _lazy_ci(spec, ci)
    lazy = ci > 1
    conv_t = torch.tensor(conv, dtype=rr.dtype, device=rr.device)
    trig = err = 0
    snap = (Snapshot(itr, x.clone(), r.clone(), p.clone(), rr, rz)
            if lazy else None)

    def signals(t_main, t_tail):
        return bool(t_main) or (tail is not None and bool(t_tail))

    while itr < upto and bool(rr > conv_t):
        chk = not lazy or itr % ci == ci - 1
        w, t, pw = fast_plain(md, p, spec)
        tt = None
        if tail is not None:
            w, tt, pw = split_tail_plain(tail[0], tail[1], p, w)
        alpha = rz / pw
        r1 = r - alpha * w
        rr1 = torch.sum(r1 * r1)
        if minv is None:
            z1, rz1 = r1, rr1
        else:
            z1 = minv * r1
            rz1 = torch.sum(r1 * z1)
        if chk and signals(t, tt):
            trig = 1
            break
        if bool(pw <= 0) or not bool(torch.isfinite(rr1)):
            err = ERR_BREAKDOWN
            break
        x.copy_(x + alpha * p)
        r.copy_(r1)
        p.copy_(z1 + (rz1 / rz) * p)
        if itr < trace.shape[0]:
            trace[itr] = rr1
        itr, rr, rz = itr + 1, rr1, rz1
        if lazy and chk:
            snap = Snapshot(itr, x.clone(), r.clone(), p.clone(), rr, rz)
    if lazy and snap.itr != itr and not trig and not err:
        # the exit-window close: one signals-only pass
        tt = signals_plain(tail[0], tail[1]) if tail is not None else None
        trig = int(signals(signals_plain(md, spec), tt))
    return FusedOut(itr, rr, rz, trig, err, snap)


def fused_cg_dia_plain(md, spec: DiaSpec, x, r, p, rr, rz, itr: int,
                       upto: int, conv: float, trace, tail=None, minv=None,
                       ci: int = 1) -> "FusedOut":
    """Plain version of kernel B."""
    return _cg_loop_plain(dia_fast_plain, md, spec, x, r, p, rr, rz, itr,
                          upto, conv, trace, tail, minv, ci)


def fused_cg_ell_plain(md, spec: EllSpec, x, r, p, rr, rz, itr: int,
                       upto: int, conv: float, trace, tail=None, minv=None,
                       ci: int = 1) -> "FusedOut":
    """Plain version of kernel D."""
    return _cg_loop_plain(ell_fast_plain, md, spec, x, r, p, rr, rz, itr,
                          upto, conv, trace, tail, minv, ci)


_tail_tables = {}


def _tail_table(ts: TailSpec, R, device):
    """The device copies of a tail's rows, starts and window table, made
    once per tail and device."""
    key = (ts.rows, ts.starts, ts.S, R, str(device))
    if key not in _tail_tables:
        i32 = dict(dtype=torch.int32, device=device)
        _tail_tables[key] = (
            torch.tensor(ts.rows, **i32), torch.tensor(ts.starts, **i32),
            torch.from_numpy(tail_tiles(ts.starts, ts.S, R).view(np.int64))
            .to(device))
    return _tail_tables[key]


def _tail_args(what, tail, R, device, grid):
    """The split-tail arguments of the C interface (all null and T = 0
    without a tail), validated."""
    if tail is None:
        return dict(ptrs=(None, None, None, None, None, 0, 0, 0, None, None,
                          None, None, None, None, 0), keep=())
    mdt, ts = tail
    T, S = len(ts.rows), ts.S
    if (not 1 <= T <= _MAX_T or S % 128 or S > R
            or not all(0 <= o < R for o in ts.rows)
            or not all(0 <= st <= R - S for st in ts.starts)):
        raise ValueError(f"{what}: a tail of {T} rows of span {S} does "
                         f"not fit {R} rows")
    E = mdt.values.shape[0] if mdt.values is not None else 0
    for name, t in (("dense_td", mdt.dense_td), ("dense_tb", mdt.dense_tb)):
        _check_tensor(what, name, t, torch.float32, (T, S), device)
    pairs = _signal_planes(mdt, ts)
    for plane, base in pairs:
        _check_tensor(what, "tail signal plane", plane, torch.int32, (E,),
                      device)
        _check_tensor(what, "tail baseline", base, torch.int32, (E // 8,),
                      device)
    rows, starts, tiles = _tail_table(ts, R, device)
    chunk = tail_chunk(S, T, grid)
    part = torch.empty(T * -(-S // chunk), dtype=torch.float32,
                       device=device)
    tmain = torch.empty(T, dtype=torch.float32, device=device)
    return dict(ptrs=(mdt.dense_td.data_ptr(), mdt.dense_tb.data_ptr(),
                      rows.data_ptr(), starts.data_ptr(), tiles.data_ptr(),
                      T, S, chunk, part.data_ptr(), tmain.data_ptr(),
                      *_plane_ptrs(pairs), E),
                keep=(part, tmain))


def _opts_args(what, minv, ci, grid, x, r, p):
    """The Jacobi and lazy arguments of the C interface (null when
    unused): M^-1 and the rz partials, the snapshot buffers and outputs
    and the check interval."""
    f32 = dict(dtype=torch.float32, device=p.device)
    keep = {}
    if minv is not None:
        _check_tensor(what, "minv", minv, torch.float32, tuple(p.shape),
                      p.device)
        keep["part_rz"] = torch.empty(grid, **f32)
    if ci > 1:
        keep.update(xs=torch.empty_like(x), rs=torch.empty_like(r),
                    ps=torch.empty_like(p),
                    its=torch.empty(1, dtype=torch.int32, device=p.device),
                    fs=torch.empty(2, **f32))
    ptrs = (_ptr(minv), _ptr(keep.get("part_rz")), _ptr(keep.get("xs")),
            _ptr(keep.get("rs")), _ptr(keep.get("ps")), ci,
            _ptr(keep.get("its")), _ptr(keep.get("fs")))
    return dict(ptrs=ptrs, keep=keep)


def _launch_args(what, md, spec, x, r, p, rr, rz, itr, upto, trace,
                 tail=None, minv=None, ci=1, schedule=None):
    """Validated tensors and the scratch one cooperative launch needs;
    kernel D's tail-free instances take their grid and schedule from
    ``ell_plan`` (``schedule`` forces one)."""
    D, R, pairs, gsrc = _check_cuda_args(md, p, spec, what)
    for name, t in (("x", x), ("r", r), ("p", p), ("trace", trace)):
        if (t.dtype != torch.float32 or t.device != p.device
                or not t.is_contiguous() or t.dim() != 1):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"1-D float32 tensor on {p.device}")
    if x.shape[0] != R or r.shape[0] != R:
        raise ValueError(f"{what}: x, r, p must have R rows")
    dev = p.device.index if p.device.index is not None else 0
    layout = "ell" if isinstance(spec, EllSpec) else "dia"
    planes = max(len(pairs), 1)
    if tail is not None and len(_signal_planes(tail[0], tail[1])) not in (
            0, len(pairs)):
        raise ValueError(f"{what}: the tail streams another number of "
                         f"signal planes than the main part")
    # A lazy instance runs on its live counterpart's grid: the same
    # partition of the rows, so the same reduction order and, on a clean
    # solve, the live instance's x bit for bit.
    # Kernel D's tail-free instances: the staged stream in the modes with
    # signals (ell_plan's grid and schedule), the first design's loop in
    # mode none.
    stream = layout == "ell" and tail is None and bool(pairs)
    sched = None
    if layout == "ell" and tail is None:
        if schedule is not None and (schedule == "grid-stride") == stream:
            raise ValueError(f"{what}: the grid-stride schedule runs mode "
                             f"none, and only it")
        sched = "grid-stride"
    if stream:
        grid, sched = ell_plan(dev, R, spec.band, planes, schedule)
    else:
        grid = fused_grid(dev, layout, tail is not None, minv is not None,
                          planes=planes)
        if ci > 1 and fused_grid(dev, layout, tail is not None,
                                 minv is not None, True, planes) < grid:
            raise RuntimeError(f"{what}: the lazy instance does not fit the "
                               f"live instance's grid of {grid} blocks")
    f32 = dict(dtype=torch.float32, device=p.device)
    i32 = dict(dtype=torch.int32, device=p.device)
    return dict(
        D=D, R=R, sig=_plane_ptrs(pairs), planes=planes, gsrc=gsrc, dev=dev,
        grid=grid, schedule=sched,
        w=torch.empty(R, **f32),
        part_pw=torch.empty(grid, **f32), part_rr=torch.empty(grid, **f32),
        part_flag=torch.empty(grid, **i32),
        iscal_in=torch.tensor([itr, upto], **i32),
        fscal_in=torch.stack([rr.to(torch.float32), rz.to(torch.float32)]),
        iscal_out=torch.empty(3, **i32), fscal_out=torch.empty(2, **f32),
        stream=torch.cuda.current_stream(p.device).cuda_stream,
        tail=_tail_args(what, tail, R, p.device, grid),
        opts=_opts_args(what, minv, ci, grid, x, r, p))


def _launch_result(a):
    """The launch's outputs, read back once it has ended: the host
    waits here for the kernel."""
    with span("fused.read"):
        itr_out, trig, err = (int(v) for v in a["iscal_out"].tolist())
        count("solver.host_reads")
        snap = None
        o = a["opts"]["keep"]
        if "xs" in o:
            snap = Snapshot(int(o["its"][0]), o["xs"], o["rs"], o["ps"],
                            o["fs"][0], o["fs"][1])
            count("solver.host_reads")
    return FusedOut(itr_out, a["fscal_out"][0], a["fscal_out"][1], trig,
                    err, snap)


def _instance(tail, minv, ci, planes=1) -> str:
    """The name of a fused kernel's instance, for its launch counts (the
    two-plane instances of constraints mode on COO128 end in "two-plane")."""
    parts = (["split tail"] if tail is not None else []) + (
        ["lazy"] if ci > 1 else []) + (["Jacobi"] if minv is not None
                                       else [])
    name = " ".join(parts) or "live"
    return f"{name} two-plane" if planes == 2 else name


def _count(kernel, tail, minv, ci, planes=1):
    kernel.launches += 1
    if tail is not None:
        kernel.tail_launches += 1
    name = _instance(tail, minv, ci, planes)
    kernel.instances[name] = kernel.instances.get(name, 0) + 1


def fused_cg_dia(md, spec: DiaSpec, x, r, p, rr, rz, itr: int, upto: int,
                 conv: float, trace, tail=None, minv=None, ci: int = 1,
                 schedule=None) -> FusedOut:
    """Kernel B: run CG iterations ``itr .. upto`` in place on x, r, p.

    ``rr``/``rz`` are 0-d tensors, ``trace`` a float tensor whose slots
    [itr, itr_out) get the new residuals; ``tail`` = (tail MatrixDevice,
    TailSpec) runs the split-tail instance, ``minv`` (the (R,) Jacobi
    M^-1) the Jacobi one, ``ci`` > 1 the lazy one (in the modes with
    signals), which returns its Snapshot.  ``schedule`` forces a
    tail-free schedule of SCHEDULES (default: ``dia_schedule``; "fold"
    needs offsets up to FOLD_MAX_HALO, "window" windows that fit)."""
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"fused_cg_dia: schedule {schedule!r} is not one "
                         f"of {SCHEDULES}")
    if x.device.type == "cpu":
        return fused_cg_dia_plain(md, spec, x, r, p, rr, rz, itr, upto,
                                  conv, trace, tail, minv, ci)
    from .._build import check, library

    if tail is not None and schedule is not None:
        raise ValueError("fused_cg_dia: the split-tail instances have one "
                         "schedule")
    with span("fused.args"):
        ci = _lazy_ci(spec, ci)
        a = _launch_args("fused_cg_dia", md, spec, x, r, p, rr, rz, itr,
                         upto, trace, tail, minv, ci)
        sched, wins, buf2 = None, None, (None, None)
        if tail is None:
            sched, wins = _dia_plan(spec.offsets, schedule)
            if sched == "fold":
                buf2 = (torch.empty_like(r), torch.empty_like(p))
        offs, offs_ptr = _offsets_arg(spec.offsets)
    with span("fused.launch"):
        rc = library("fused_cg_dia").abft_fused_cg_dia(
            md.values.data_ptr(), offs_ptr, a["D"], a["R"], x.data_ptr(),
            r.data_ptr(), p.data_ptr(), a["w"].data_ptr(), *a["sig"],
            int(spec.use_parity), int(spec.use_cksum),
            a["part_pw"].data_ptr(), a["part_rr"].data_ptr(),
            a["part_flag"].data_ptr(), a["grid"], a["iscal_in"].data_ptr(),
            a["fscal_in"].data_ptr(), a["iscal_out"].data_ptr(),
            a["fscal_out"].data_ptr(), trace.data_ptr(), trace.shape[0],
            float(conv), *a["tail"]["ptrs"], *a["opts"]["ptrs"],
            _SCHEDULE_CODES.get(sched, 0), _ptr(buf2[0]), _ptr(buf2[1]),
            None if wins is None else ctypes.addressof(wins),
            dia_block_rows(a["R"], a["grid"]), a["dev"], a["stream"])
        del offs
        check(rc, "fused_cg_dia cooperative launch")
        _count(fused_cg_dia, tail, minv, ci, a["planes"])
        if sched is not None:
            fused_cg_dia.schedules[sched] += 1
    return _launch_result(a)


fused_cg_dia.launches = 0
fused_cg_dia.tail_launches = 0   # the split-tail instances' share
fused_cg_dia.instances = {}      # launches by instance (``_instance``)
fused_cg_dia.schedules = dict.fromkeys(SCHEDULES, 0)   # tail-free launches


def fused_cg_ell(md, spec: EllSpec, x, r, p, rr, rz, itr: int, upto: int,
                 conv: float, trace, tail=None, minv=None, ci: int = 1,
                 schedule=None) -> FusedOut:
    """Kernel D: kernel B's contract over a banded-ELL matrix.
    ``schedule`` forces a tail-free schedule of ELL_SCHEDULES (default:
    "grid-stride" in mode none, else ``ell_plan``'s for ``spec.band``);
    "window" needs a band that fits, and mode none runs "grid-stride"
    only."""
    if schedule is not None and schedule not in ELL_SCHEDULES:
        raise ValueError(f"fused_cg_ell: schedule {schedule!r} is not one "
                         f"of {ELL_SCHEDULES}")
    if x.device.type == "cpu":
        return fused_cg_ell_plain(md, spec, x, r, p, rr, rz, itr, upto,
                                  conv, trace, tail, minv, ci)
    from .._build import check, library

    if tail is not None and schedule is not None:
        raise ValueError("fused_cg_ell: the split-tail instances have one "
                         "schedule")
    with span("fused.args"):
        ci = _lazy_ci(spec, ci)
        a = _launch_args("fused_cg_ell", md, spec, x, r, p, rr, rz, itr,
                         upto, trace, tail, minv, ci, schedule)
        sched = a["schedule"]
        hb = ell_halo(spec.band) if sched == "window" else -1
    with span("fused.launch"):
        rc = library("fused_cg_ell").abft_fused_cg_ell(
            md.values.data_ptr(), a["gsrc"].data_ptr(), gather_mask(spec),
            md.ell_len.data_ptr(), a["D"], a["R"], x.data_ptr(),
            r.data_ptr(), p.data_ptr(), a["w"].data_ptr(), *a["sig"],
            int(spec.use_parity), int(spec.use_cksum),
            a["part_pw"].data_ptr(), a["part_rr"].data_ptr(),
            a["part_flag"].data_ptr(), a["grid"], a["iscal_in"].data_ptr(),
            a["fscal_in"].data_ptr(), a["iscal_out"].data_ptr(),
            a["fscal_out"].data_ptr(), trace.data_ptr(), trace.shape[0],
            float(conv), *a["tail"]["ptrs"], *a["opts"]["ptrs"], hb,
            a["dev"], a["stream"])
        check(rc, "fused_cg_ell cooperative launch")
        _count(fused_cg_ell, tail, minv, ci, a["planes"])
        if sched is not None:
            fused_cg_ell.schedules[sched] += 1
    return _launch_result(a)


fused_cg_ell.launches = 0
fused_cg_ell.tail_launches = 0
fused_cg_ell.instances = {}
fused_cg_ell.schedules = dict.fromkeys(ELL_SCHEDULES, 0)   # tail-free

_grids = {}


def fused_grid(device_index: int, layout: str, tail: bool = False,
               precond: bool = False, lazy: bool = False,
               planes: int = 1) -> int:
    """Co-resident grid of an instance of kernel B ("dia") or D ("ell"):
    tail-free or with the split tail, live or lazy, unpreconditioned or
    Jacobi, streaming one signal plane or two (constraints on COO128), on
    a device (SMs x blocks per SM).  Each split-tail instance has its
    own; every tail-free instance of kernel B has the same (kRowBlocksPerSM
    per SM); kernel D's tail-free grid is mode none's (the first design's
    loop): its staged stream launches on ``ell_plan``'s.  A lazy instance
    is launched with its live counterpart's grid (``_launch_args``), which
    its own must hold."""
    key = (device_index, layout, tail, precond, lazy, planes)
    if key not in _grids:
        from .._build import check, library

        out = ctypes.c_int(0)
        args = (device_index, int(tail), int(precond), int(lazy),
                int(planes), ctypes.addressof(out))
        if layout == "dia":
            rc = library("fused_cg_dia").abft_fused_grid(*args)
        else:
            rc = library("fused_cg_ell").abft_fused_ell_grid(*args)
        check(rc, f"fused_cg_{layout} occupancy query")
        _grids[key] = out.value
    return _grids[key]


def make_fused_continue(mat, mode, conv_threshold, precond=False,
                        check_interval=1, schedule=None):
    """``continue_(md, state, upto, minv=None) -> (CGState,
    MatrixDevice)`` with solver.cg's contract, the fast loop in kernel B
    or D (fused.py:1946).  A split's ``md`` is the (main, tail) pair.
    ``precond``: the Jacobi instance, ``minv`` required; a
    ``check_interval`` > 1 runs the lazy instance in the modes with
    signals, resolved by solver.cg's ``_lazy_exit_resolve`` with the
    phantom guard (fused.py:2150-2164; the kernel closes the exit window
    itself, so the resolve's verify is a no-op).  ``schedule`` forces
    the tail-free schedule of kernel B (SCHEDULES, ``fused_cg_dia``) or D
    (ELL_SCHEDULES, ``fused_cg_ell``)."""
    split = mat.exec_kind == "split"
    spec = fast_spec(mat.main if split else mat, mode)
    tspec = tail_spec(mat, mode) if split else None
    kernel = fused_cg_dia if isinstance(spec, DiaSpec) else fused_cg_ell
    classify = make_spmv(mat, torch.float32, mode).classify
    if classify is not None:
        classify = span("solver.classify")(classify)
    ci = _lazy_ci(spec, check_interval)
    kw = {} if schedule is None else {"schedule": schedule}

    def run_fast(md, s: CGState, upto: int, minv):
        ktrace = torch.full_like(s.trace, float("nan"))
        tail = None
        if split:
            md, tail = md[0], (md[1], tspec)
        out = kernel(md, spec, s.x, s.r, s.p, s.rr, s.rz, s.itr, upto,
                     conv_threshold, ktrace, tail, minv, ci, **kw)
        with span("fused.merge"):
            # Merge the kernel's trace: it wrote slots [s.itr, itr) only.
            tio = torch.arange(s.trace.shape[0], device=s.trace.device)
            trace = torch.where((tio >= s.itr) & (tio < out.itr), ktrace,
                                s.trace)
            s1 = s._replace(itr=out.itr, rr=out.rr, rz=out.rz, trace=trace)
            snap = None
            if out.snap is not None:
                snap = CGState(out.snap.itr, out.snap.x, out.snap.r,
                               out.snap.p, out.snap.rr, out.snap.rz,
                               s.stats, trace)
        return s1, snap, out.trig, out.err

    def continue_(md, state: CGState, upto, minv=None):
        if precond != (minv is not None):
            raise ValueError("preconditioned fused solver needs minv"
                             if precond else
                             "fused solver built unpreconditioned")
        upto = int(upto)
        # The kernel updates x, r, p in place: work on copies so the
        # caller's state stays as it was.
        with span("fused.args"):
            s = state._replace(x=state.x.clone(), r=state.r.clone(),
                               p=state.p.clone())
        if spec.plane is None and (tspec is None or tspec.plane is None):
            # Mode none: no detection, no repair — one launch runs the
            # loop to convergence, the limit or a breakdown.
            s, _snap, _trig, err = run_fast(md, s, upto, minv)
            return s._replace(stats=s.stats.merge_first(
                SpmvStats(errcode=err))), md
        stuck = 0
        while True:
            s1, snap, trig, err = run_fast(md, s, upto, minv)
            if ci > 1:
                # A rollback restores the snapshot's buffers, on which
                # the next launch runs in place.
                with span("solver.resolve"):
                    done, md, s, stuck = _lazy_exit_resolve(
                        md, s1, snap, bool(trig), err,
                        lambda md_, p_: False, classify, stuck)
                if done:
                    return s, md
                continue
            s = s1
            st1 = SpmvStats.clean()
            md_in = md
            if trig:
                st1, md = classify(md)
            with span("solver.guard"):
                st1, stuck = _phantom_guard(
                    bool(trig), st1, _baseline_changed(md_in, md), stuck)
            st = s.stats.merge_first(
                SpmvStats(errcode=err)).merge_first(st1)
            s = s._replace(stats=st)
            if not trig or st.errcode != 0:
                return s, md

    return continue_


def make_fused_solver(mat, mode, max_itrs: int, conv_threshold: float,
                      precond=False, check_interval=1, schedule=None):
    """``solve(md, b, minv=None) -> CGResult`` on kernel B or D;
    ``minv`` must match ``precond``; ``schedule`` as in
    ``make_fused_continue``."""
    return solver_of(make_fused_continue(mat, mode, conv_threshold,
                                         precond, check_interval, schedule),
                     max_itrs)
