#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Drives the port's paths through the CLI entry point, after holding each
CUDA kernel against its plain PyTorch version on the card:

  - the DIA path, ``cg-csr -b 10 -m <mode>`` (N = 819,200, the bundled
    tridiagonal stand-in, CSR96 codewords, float32, live detection):
    kernels A (dia_spmv_detect) and B (fused_cg_dia);
  - the banded-ELL path, ``cg-csr -f <dense-radius-3d.mtx> -b 4 -m
    <mode>`` (timed at -b 10: N = 219,520, nnz 33.0M, K = 175, band
    1627): kernels C (ell_spmv_detect) and D (fused_cg_ell);
  - the flat path, ``-f <powerlaw-graph.mtx> -b 10`` (N = 655,360, 3.2M
    entries, hub rows): kernel E (flat_spmv_detect) on the per-iteration
    tier;
  - the band split, ``-f <band+random-1pct.mtx> -b 10``: kernels C (ELL
    main) and E (flat tail) on the per-iteration tier;
  - the bordered split, ``-f <arrowhead.mtx> -b 10``: kernel B with the
    split tail (dense rows, mirrored AXPYs, tail signals), and A + E in
    ``spmv_once``;
  - wide-band ELL, stencil27-shuffled -b 10 (band 4681 under RCM):
    kernels C and D;
  - the solver options on these paths: -p jacobi and --check-interval K
    (the Jacobi and lazy instances of kernels B and D, the per-iteration
    tier's lazy loop over the detection-free products of C and E) and
    --refine 2;
  - cg-coo, ``main_coo`` (bin/cg-coo-torch): the same paths on COO128
    codewords, whose constraints mode streams two signal planes (the col
    and the row word, each against its own baseline) through every
    kernel's two-plane instance;
  - the row-sharded solve (parallel/: ``solve_sharded``,
    ``make_shardmap_spmv`` under solver.cg's loops) on a mesh of 4 shards
    on the one card, DIA -b 10, dense-radius-3d -b 10 (row_align 4096)
    and arrowhead -b 10: the halo forms of kernels A and C per shard,
    each shard's planes and vectors its own rows only, the code path of
    shards on distinct cards (the CLI's --devices N, like the JAX one,
    needs N cards), and parallel.dryrun.dryrun_multichip.

Phases:

  1. device and card (name, power limit);
  2. build the kernels from abft_sparse_cg_tpu_torch/csrc (one nvcc per
     source, all started together); kernel C's grid from the card's
     occupancy (at least 2 resident blocks per SM, both forms);
  3. kernel A vs its plain version, every mode, clean and with injected
     1- and 2-bit faults: w bit-exact, pw within 1e-5;
  4. kernel B vs its plain loop: a clean and a faulted secded solve on
     each tail-free schedule (fold, three-sync, window; solver/fused.py::
     SCHEDULES), the schedules' x equal bit for bit;
  5. the DIA main path: the four run_tests classes on -t cuda at -b 10
     --seed 11, through abft_sparse_cg_tpu_torch.cli.main_csr (what
     bin/cg-csr-torch runs), every launch count reset before and read
     after;
  6. the float32 rr trajectory against the port's float64 plain solve
     (the scripts/tpu_smoke.py bound);
  7. the DIA launch counts;
  8. DIA times: interleaved batches, median and spread, build excluded;
     kernel A (as the solvers call it: a launcher made once per matrix)
     against its plain version, the bare ``A @ x`` of a
     torch.sparse_csr_tensor (computes less: no checks) and its bound
     (phase 31 traces them);
  9. the ELL matrices, each mode built once: dense-radius-3d -b 4,
     blockdiag-random -b 2, and stencil27-shuffled -b 2 forced to ELL
     under its RCM permutation (the gidx plane); dense-radius-3d -b 10
     in every mode, R aligned to 4096 rows (1,664 zero rows past its
     219,520: four shards of 1024-row multiples), for the timed path
     and the sharded phases;
 10. kernel C vs its plain version on the three ELL shapes and the four
     edges of its schedule (R = 32, K = 1, K = 13, whole tiles of empty
     rows; built in phase 9), every mode, clean and with injected 1- and
     2-bit faults (and an index flip in none/constraints): w bit-exact,
     pw within 1e-5;
 11. kernel D vs its plain loop: a clean secded solve on dense-radius-3d
     -b 10 under each schedule of its staged stream (the band window,
     which the matrix's plan takes, and the l2 gathers) and a faulted
     one;
 12. the ELL main path: the four run_tests classes through main_csr with
     -t cuda -f <file> -b 4 --seed 11, the .mtx file written by the
     port's mmio into a temporary directory; launch counts reset before
     and read after, kernel D's by schedule (the window; mode none's
     runs the first design's grid-stride loop).  The CLI runs on the zoo
     files of this phase and of
     18 and 25 run in one worker process per file and run group
     (``--cli-worker LABEL``, CLI_JOBS), all started before phase 10
     (phases 10 and 11 check and time nothing) and awaited here: their
     time is the host builds, one per run, which take the host's cores
     side by side; each worker resets and reads its own counts, and the
     later phases print what theirs printed;
 13. the ELL float32 trajectory against the port's float64 plain solve;
 14. ELL times: solves, per-iteration slope and GB/s, kernel C and D
     against their plain versions, ``A @ x`` and their bounds, and the
     host build, upload and classify;
 15. the flat and split matrices: powerlaw-graph -b 10, stencil27-
     shuffled -b 1, dense-radius-k729 -b 10 and a row-lengths matrix
     (rows of 0, 1, 31-33, 64, 65, 1000, 2048, 2049 and 4100 slots: the
     edges of kernel E's row classes; forced flat, each mode), arrowhead
     and band+random-1pct -b 10 (split); the host builds of
     one matrix's modes run in parallel threads, here and in phases 8,
     9 and 20;
 16. kernel E vs its plain version on the five flat shapes (a tiny one:
     a plan of one entry), every
     mode, clean and faulted: w bit-exact, pw within 1e-5, the trigger
     each mode's signals must give;
 17. kernel B with the split tail vs its plain loop on arrowhead -b 10
     secded, clean and two faults (trace within 1e-3 above float32's
     noise floor);
 18. the flat and split main paths: the four run_tests classes through
     main_csr -t cuda -f <file> -b 10 --seed 11 on powerlaw-graph,
     band+random-1pct and arrowhead, launch counts reset before each
     file and read after;
 19. their float32 trajectories against the float64 plain solve (run
     on the card), to rr0 * 1e-8;
 20. wide-band ELL (stencil27-shuffled -b 10): kernel C vs plain, kernel
     D vs its plain loop, a secded CLI run (kernel D on its l2 schedule),
     solve times;
 21. flat and split times: per-iteration and split-tail solves with
     slope and GB/s, kernel E per call against its plain version,
     ``A @ x`` and its bound, the secded-over-none price of kernel E's
     per-call signals, kernel C at the band split's main part (K 11, R
     819,200: several tiles per block) held bit-exact to plain live and
     as the product, clean and with a 1-bit fault, and timed against
     plain, ``A @ x`` and its bound, the split tail against its plain
     loop;
 22. the lazy (CI 4) and Jacobi instances of kernels B and D (and of the
     split tail; kernel B's tail-free ones on each schedule) against
     their plain loops, secded, on DIA -b 10,
     dense-radius-3d -b 10 and arrowhead -b 10: clean (a lazy x equal
     to the live instance's bit for bit, the trace within 1e-3 above
     float32's noise floor), one fault corrected (through a rollback
     under the lazy schedule: x equal to the clean solve's), a sed
     fail-stop (DIA; ELL at -b 4); then B's Jacobi and lazy Jacobi
     instances on the DIA -b 10 matrix with its diagonal scaled row by
     row (the bundled one is constant, where M^-1 = I / d leaves CG's
     path unchanged), where the plain loop's Jacobi path must leave its
     unpreconditioned one by far more than the check's tolerance;
 23. kernel B at DIA -b 100, what the TPU routes to its streaming
     kernel: live, lazy CI 32 and Jacobi against the plain loop, on each
     tail-free schedule; then HPCG's 27-point stencil at 88^3 (built in
     the background from phase 4 on): three windows and two tiles per
     block on the card's grid, the window and three-sync schedules live
     against the plain loop (trace to 1e-4), and the window's live and
     lazy CI 32 runs against three-sync's bit for bit;
 24. the detection-free products of kernels A, C and E (no signal
     plane, the mode's gather masking kept) against their plain
     versions on the phase 3, 10 and 16 shapes (C's edges included),
     then a per-iteration
     lazy solve on powerlaw-graph -b 10 equal to the live one;
 25. the solver options on the main paths: the run_tests classes
     through main_csr -t cuda -b 10 --seed 11 with --check-interval 4,
     -p jacobi and both, a --refine 2 run, -b 100 with CI 32, and a
     secded -x run with each option on dense-radius-3d, arrowhead,
     powerlaw-graph and band+random-1pct, all -b 10; launch counts of
     each instance reset before each path and read after (the kernels
     line's counts come from these runs);
 26. solver-option times: secded over none at CI 1, 4 and 32 and
     Jacobi over unpreconditioned on DIA -b 10 and -b 100, dense-
     radius-3d -b 10 and powerlaw-graph -b 10 (slope, GB/s), each new
     instance against its plain loop and the products per call;
 27. the halo forms of kernels A and C on 4 shards of the card (DIA -b
     10: R_loc 204,800, H 128; dense-radius-3d -b 10 at row_align 4096:
     R_loc 55,296, H 1,664), every mode, clean and with a fault in a halo
     row (the last row of shard 1): w bit-exact to the plain versions
     and, concatenated, to the single-device kernels' w; the trigger on
     the faulted row's shard only;
 28. the sharded main path: ``solve_sharded`` and ``make_shardmap_spmv``
     under make_cg_solver / make_lazy_ci_solver on DIA -b 10 (clean, a
     halo-row fault, lazy CI 4, Jacobi on the scaled diagonal), dense-
     radius-3d -b 10 (live, lazy CI 4) and arrowhead -b 10 (clean,
     injected), each against the single-device cuda solve and the f64
     oracle's trajectory bound, a lazy x equal to the live one bit for
     bit; each shard's planes, x and returned planes its own rows only
     after the repaired solve; the halo kernels' launch counts reset
     before and read after;
 29. sharded times: per sharded SpMV (4 shards and the exchange) against
     the single-device kernels and ``A @ x``; one shard's halo kernel
     call against its plain version, the shard's ``A @ x_ext`` and its
     bound; sharded solves at DIA -b 10 and -b 100 against kernel B and
     the per-iteration tier;
 30. powerlaw-graph -b 100 (HBM-bound), if its host build takes under a
     minute and the run is early enough;
 31. torch.profiler windows, each group in a fresh worker process
     (``--profile-worker dia|ell|split|dia100|coo PICKLE``, the matrix
     handed over in a temporary pickle; one long process lost most
     device events of its later windows): kernels A and C per call, their
     products, ``A @ x``, the sharded SpMV, and solves of kernels B and
     D (live, lazy CI 4, Jacobi, lazy Jacobi) and the sharded tier; the
     split group, arrowhead -b 10 solves of kernel B's split-tail
     instances (live, lazy CI 4, Jacobi, lazy Jacobi); the dia100 group,
     kernel B's -b 100 secded solves, live and lazy CI 32 — device time
     per call by kernel, device operations per call, the busy share; the
     dia and ell groups also time their halo kernel on shard 1 of 4 alone;
 32. cg-coo: kernels A, C and E on COO128 planes (DIA -b 10, dense-
     radius-3d -b 1 at row_align 4096, powerlaw-graph -b 1) and the halo
     forms of A and C on 4 shards, every mode, clean and faulted: random
     1- and 2-bit faults, an INDEX flip, a row-word flip (constraints:
     only the second plane sees it) and, in none and constraints, the
     4-bit col/row fault whose rotated fold is zero
     (utils/coo_faults.py): w bit-exact, pw within 1e-5, the trigger
     each mode's signals must give; then C and E in constraints at the
     shapes phase 37 times, dense-radius-3d -b 10 (row_align 4096:
     several tiles per block of C's two-plane grid) and powerlaw-graph
     -b 10, clean and with each constraints fault;
 33. cg-coo: kernels B and D (live, lazy CI 4, Jacobi, lazy Jacobi) and
     B's split tail against their plain loops on COO128 (DIA -b 10,
     dense-radius-3d -b 1, arrowhead -b 1), secded and constraints:
     clean (a lazy x equal to the live one bit for bit), a corrected
     1-bit fault (secded), a row-word flip and the 4-bit col/row fault
     (constraints: the plain loop's fail-stop);
 34. the cg-coo main path: the four run_tests classes through main_coo
     -t cuda -b 10 --seed 11, and constraints -x INDEX and -x 4 INDEX,
     launch counts reset before and read after;
 35. cg-coo on the other layouts: a secded -x and a constraints -x INDEX
     run through main_coo on dense-radius-3d -b 1 (ELL),
     stencil27-shuffled -b 5 (ELL under RCM), powerlaw-graph -b 1
     (flat), band+random-1pct -b 1 (band split) and arrowhead -b 1
     (bordered split): the smallest -b at which each keeps its route,
     checked and printed (constraints never permutes), and the kernels
     each ran;
 36. a 4-shard COO constraints solve on the card (the two-plane halo
     form of kernel A) against the single-device solve;
 37. cg-coo times: COO against CSR solves, secded and constraints, at
     -b 10 and -b 100, interleaved (median, slope, share of the bound);
     kernels A and B on COO constraints (and B on COO secded) at -b 10,
     C at dense-radius-3d -b 10 and E at powerlaw-graph -b 10 per call
     beside their CSR constraints builds (the bound counts the gather
     word once: in constraints it is a signal plane); the device time of
     each -b 10
     solve in a fresh profiler worker (``--profile-worker coo``);
 38. the rest of the CLI on the card, in 8 worker processes (REST_JOBS,
     ``--cli-worker LABEL``, started after phase 37): --checkpoint P
     --checkpoint-every 3, and a partial -i 4 run resumed, each equal to
     the straight run (DIA -b 10 secded -x, also lazy CI 4 and Jacobi;
     dense-radius-3d -b 4; arrowhead -b 10; powerlaw-graph -b 10; cg-coo
     DIA -b 10 constraints -x INDEX), kernel B launched once per segment
     and once per repair; --solver pipelined to the run_tests contract
     (DIA -b 10 none, secded -x, sed -x; dense-radius-3d -b 4;
     powerlaw-graph -b 10 at -c 10), launching A, C or E, never B or D;
     --profile on DIA -b 10 secded, a trace that names kernel B; no
     kernel's plain version run on these paths; while the workers run,
     the pipelined float32 trajectories against the float64 plain
     pipelined solve on the card; then solve times, checkpointed against
     straight and pipelined against standard;
 39. the cpu target (the native C++/OpenMP library, float64, built from
     native/abft_cg.cpp at first use; its build seconds printed) as the
     cuda target's witness: --list shows torch-*, cpu-*, cuda-* in that
     order; bin/cg-csr-torch -b 10 --seed 11 secded, secded -x, sed -x,
     secded -x 2 and bin/cg-coo-torch -b 10 --seed 11 secded -x,
     constraints -x INDEX (WITNESS_RUNS), each on -t cpu and on -t cuda,
     a process per run, all started together: equal exit codes, config
     echo (less the implementation line), injection banner and [ECC]
     lines; a constraint line's index at most one element apart;
     iterations within one (float64 against float32); total error < 1 on
     both; each run's time taken beside the other's, labelled with the
     host CPU and its thread count and with the card; then the DIA -b 10
     secded solve of both targets in this process, warm;
 40. parallel.dryrun.dryrun_multichip(4, cuda:0): the ten
     configurations of the JAX function's dry run at 4 shards on the
     card (strict convergence, one correction, a corrected and a lazy x
     equal to the clean x bit for bit), one line each with the tier that
     ran it; on a host with two or more cards, dryrun_multichip(min(8,
     cards)) on distinct cards, else the line "distinct cards: not run
     (1 card)".

Any failed check raises, so the script exits non-zero.  The last three
lines are the card line from nvidia-smi, one JSON object describing the
kernels, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
and no module of the JAX package.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

import atexit
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
MATRIX = os.path.join(ROOT, "matrices", "shallow_water1", "shallow_water1.mtx")
MODES = ("none", "constraints", "sed", "sec7", "sec8", "secded")
ECC = ("sed", "sec7", "sec8", "secded")
HBM_BPS = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
CONV = 1e-3


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.perf_counter()


def phase(title):
    print(f"\n== {title} [at {time.perf_counter() - _T0:.0f} s]", flush=True)


def spread(vals):
    return (f"median {statistics.median(vals):.4f} ms "
            f"(min {min(vals):.4f}, max {max(vals):.4f}, n={len(vals)})")


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the card's peak rate."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def parallel_builds(asm, modes, fmt="csr", **kw):
    """Each mode's host build of ``asm`` ({mode: matrix}) in the codeword
    format ``fmt``, in threads: NumPy releases the GIL in its sorts and
    elementwise loops, so the builds overlap on the host's cores."""
    from concurrent.futures import ThreadPoolExecutor

    from abft_sparse_cg_tpu_torch.formats import build_protected

    with ThreadPoolExecutor(max_workers=len(modes)) as ex:
        futs = {mode: ex.submit(build_protected, fmt, asm, mode, **kw)
                for mode in modes}
        return {mode: f.result() for mode, f in futs.items()}


def hpcg_stencil(side, mode):
    """HPCG's 27-point stencil (26 on the diagonal, -1 off it) on a
    side^3 grid in its natural order, built in ``mode``: DIA, offsets to
    +-(side^2 + side + 1)."""
    import numpy as np

    from abft_sparse_cg_tpu_torch.formats import assemble, build_protected

    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                d = dz * side * side + dy * side + dx
                if d > 0:
                    continue
                iz = np.arange(max(0, -dz), side - max(0, dz))
                iy = np.arange(max(0, -dy), side - max(0, dy))
                ix = np.arange(max(0, -dx), side - max(0, dx))
                r = np.add.outer(np.add.outer(iz * side * side, iy * side),
                                 ix).ravel()
                rows.append(r)
                cols.append(r + d)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.where(rows == cols, 26.0, -1.0)
    return build_protected("csr", assemble(cols, rows, vals, side ** 3, 1),
                           mode)


def host_ms(fn, reps):
    """Host clock around ``reps`` calls ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def event_ms(fn, reps):
    """CUDA events around ``reps`` launches: device time per call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleave(fns, reps, batches=7, timer=host_ms):
    """Batches in turns (a, b, b, a, ...); per-call ms lists."""
    names = list(fns)
    for n in names:          # warm-up
        fns[n]()
    out = {n: [] for n in names}
    for k in range(batches):
        order = names if k % 2 == 0 else names[::-1]
        for n in order:
            out[n].append(timer(fns[n], reps))
    return out


def same_w(wk, wp):
    """Bit-exact up to NaN payloads: equal NaN positions, equal values
    (infinities included) elsewhere."""
    import torch

    nan = torch.isnan(wp)
    return (torch.equal(nan, torch.isnan(wk))
            and torch.equal(wk[~nan], wp[~nan]))


def pw_rel(pk, pp):
    pk, pp = float(pk), float(pp)
    if pk == pp or (math.isnan(pk) and math.isnan(pp)):
        return 0.0
    return abs(pk - pp) / abs(pp)


def _csr(values, cols, valid, ncols):
    """A (R, ncols) float32 torch.sparse_csr_tensor of the valid slots of
    a (D, R) value plane whose slot (d, r) sits in column cols[d, r]."""
    import torch

    R = values.shape[1]
    valid_t = valid.T
    crow = torch.zeros(R + 1, dtype=torch.int64, device=values.device)
    crow[1:] = torch.cumsum(valid_t.sum(dim=1), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta" notices
        a = torch.sparse_csr_tensor(crow, cols.T[valid_t],
                                    values.T[valid_t], size=(R, ncols))
    return a, int(crow[-1])


def _occupied(md):
    occupied = md.words[0] != 0
    for w in md.words[1:]:
        occupied = occupied | (w != 0)
    return occupied


def csr_yardstick(md, spec):
    """The same matrix as a torch.sparse_csr_tensor (float32, exec
    order): the bare ``A @ x`` yardstick.  It computes less than the
    kernels (no signals, no pw) and the port never calls it."""
    import torch

    values = md.values
    if values.dim() == 1:    # flat: the row pointer is the CSR one
        from abft_sparse_cg_tpu_torch.ops.spmv import take_clamped
        from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_gather_plane

        R = md.row_ptr.shape[0] - 1
        nnz = int(md.row_ptr[-1])
        g = ell_gather_plane(md, spec)[:nnz].to(torch.int64)
        cols = take_clamped(torch.arange(R, device=values.device), g)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(md.row_ptr.to(torch.int64), cols,
                                        values[:nnz], size=(R, R))
        return a, nnz
    D, R = values.shape
    slot = torch.arange(D, device=values.device)[:, None]
    if hasattr(spec, "offsets"):
        offs = torch.tensor(spec.offsets, device=values.device)[:, None]
        cols = torch.arange(R, device=values.device)[None, :] + offs
        valid = (cols >= 0) & (cols < R) & _occupied(md)
    else:
        from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_gather_plane

        cols = ell_gather_plane(md, spec).to(torch.int64)
        valid = slot < md.ell_len[None, :].to(torch.int64)
    return _csr(values, cols, valid, R)


def shard_yardstick(md, spec, halo, base):
    """One shard's rows as a (R_loc, R_loc + 2 * halo) torch.sparse_csr_
    tensor over its x_ext: the bare ``A @ x_ext`` beside a halo kernel's
    call (columns where the halo forms read, ops.spmv.window_positions)."""
    import torch

    from abft_sparse_cg_tpu_torch.ops.spmv import window_positions
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_gather_plane

    values = md.values
    D, R = values.shape
    if hasattr(spec, "offsets"):
        offs = torch.tensor(spec.offsets, device=values.device)[:, None]
        cols = torch.arange(R, device=values.device)[None, :] + offs + halo
        valid = _occupied(md)
    else:
        cols = window_positions(ell_gather_plane(md, spec), spec.rows, base,
                                halo, R + 2 * halo)
        slot = torch.arange(D, device=values.device)[:, None]
        valid = slot < md.ell_len[None, :].to(torch.int64)
    return _csr(values, cols, valid, R + 2 * halo)[0]


def call_profile(fn, label, card, reps=50):
    """A torch.profiler window over ``reps`` warm calls of ``fn``: the
    device time per call by kernel name, the device operations per call
    and the device's busy share of the window (the profiler's own host
    overhead stretches the window, so the share is a lower bound).
    Prints them and returns ``{"ms", "ops", "busy", "by_name"}`` (per
    call; None if nothing was traced)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    gpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    if not gpu:
        print(f"  profiler, {label}: no device events traced: device time "
              "not measured")
        return None
    by_name = {}
    for t0, t1, name in gpu:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / reps / 1e3
    busy, c0, c1 = 0.0, None, None
    for t0, t1, _ in gpu:
        if c1 is None or t0 > c1:
            busy += 0.0 if c1 is None else c1 - c0
            c0, c1 = t0, t1
        else:
            c1 = max(c1, t1)
    busy += c1 - c0
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    out = {"ms": sum(by_name.values()), "ops": len(gpu) / reps,
           "busy": busy / span, "by_name": by_name}
    print(f"  profiler, {label}: device {out['ms']:.4f} ms per call in "
          f"{out['ops']:.2f} device operations; busy "
          f"{out['busy'] * 100:.1f}% of the {span / 1e3:.3f} ms window "
          f"[{card}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        print(f"    {ms:.4f} ms/call  {name[:80]}")
    return out


def device_state(card):
    """The card's clocks, power and temperatures (nvidia-smi) and the
    memory this process holds on it, beside a timed phase."""
    import torch

    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,temperature.memory", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"device state: {q} (sm MHz, mem MHz, draw, gpu C, mem C); "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          f"[{card}]")


def run_cli(main_csr, args):
    """(exit code, stdout) of one in-process CLI run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main_csr(list(args))
    return code, buf.getvalue()


def total_error(out):
    for line in out.splitlines():
        if line.startswith("total error"):
            return float(line.split()[3])
    return float("inf")


def run_tests_classes(main_csr, base):
    """The four run_tests classes through the CLI; raises on a miss."""
    for mode in MODES:
        code, out = run_cli(main_csr, [*base, "-m", mode])
        te = total_error(out)
        require(code == 0 and te < 1.0,
                f"clean {mode}: exit {code}, total error {te}")
        print(f"passed clean {mode}: exit 0, total error {te:f}")
    code, out = run_cli(main_csr, [*base, "-m", "sed", "-x"])
    require(code == 1 and "error detected at index" in out, "sed -x")
    print("passed sed -x: 'error detected at index', exit 1")
    for mode in ("sec7", "sec8", "secded"):
        code, out = run_cli(main_csr, [*base, "-m", mode, "-x"])
        require(code == 0, f"{mode} -x: exit {code}")
        print(f"passed {mode} -x: exit 0 "
              f"({[ln for ln in out.splitlines() if '[ECC]' in ln]})")
    code, out = run_cli(main_csr, [*base, "-m", "secded", "-x", "2"])
    require(code == 1 and "double-bit error detected" in out,
            "secded -x 2")
    print("passed secded -x 2: 'double-bit error detected', exit 1")


def option_run(main_csr, base, flags):
    """One run of the run_tests class 3 with ``flags``: secded -x,
    corrected, exit 0 (phase 22 holds the fail-stops)."""
    code, out = run_cli(main_csr, [*base, *flags, "-m", "secded", "-x"])
    require(code == 0 and total_error(out) < 1.0
            and "[ECC] corrected" in out,
            f"{' '.join(flags)} secded -x: exit {code}")
    print(f"passed {' '.join(flags)} secded -x: corrected, exit 0, total "
          f"error {total_error(out):f}")


def reset_launches():
    """Every kernel wrapper's launch counts to 0."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast, dia_fast_halo, ell_fast, ell_fast_halo, flat_fast)
    from abft_sparse_cg_tpu_torch.solver.fused import (
        fused_cg_dia, fused_cg_ell)

    for fn in (dia_fast, fused_cg_dia, ell_fast, fused_cg_ell,
               flat_fast, dia_fast_halo, ell_fast_halo):
        fn.launches = 0
    for fn in (dia_fast, ell_fast, flat_fast, dia_fast_halo,
               ell_fast_halo):
        fn.product_launches = fn.two_plane_launches = 0
    fused_cg_dia.tail_launches = fused_cg_ell.tail_launches = 0
    fused_cg_dia.instances.clear()
    fused_cg_ell.instances.clear()
    for sched in (fused_cg_dia.schedules, fused_cg_ell.schedules):
        for k in sched:
            sched[k] = 0


def launch_counts():
    """({wrapper: launches}, {kernel B or D instance, kernel D's tail-free
    schedule ("fused_cg_ell [window]", "[l2]", "[grid-stride]"), or a
    detection-free product: launches}) since the last reset_launches."""
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast, ell_fast, flat_fast)
    from abft_sparse_cg_tpu_torch.solver.fused import (
        fused_cg_dia, fused_cg_ell)

    wrappers = {"dia_spmv_detect": dia_fast.launches,
                "ell_spmv_detect": ell_fast.launches,
                "flat_spmv_detect": flat_fast.launches,
                "fused_cg_dia (split tail)": fused_cg_dia.tail_launches,
                "fused_cg_ell": fused_cg_ell.launches}
    instances = {f"fused_cg_dia ({k})": v
                 for k, v in fused_cg_dia.instances.items()}
    instances.update({f"fused_cg_ell ({k})": v
                      for k, v in fused_cg_ell.instances.items()})
    # kernel D's tail-free launches by schedule (solver.fused.ell_plan)
    instances.update({f"fused_cg_ell [{k}]": v
                      for k, v in fused_cg_ell.schedules.items()})
    for fn, name in ((dia_fast, "dia_spmv_detect"),
                     (ell_fast, "ell_spmv_detect"),
                     (flat_fast, "flat_spmv_detect")):
        instances[f"{name} (detection-free product)"] = fn.product_launches
    return wrappers, instances


# The CLI runs of phases 12, 18 and 25 on the zoo files: {label: (zoo
# file, -b, the option flag sets of a secded -x run each, or None for the
# four run_tests classes)}.  Each runs in a worker process of its own,
# all started together (cli_pool_start): their time is the host builds,
# one per run, which then take the host's cores side by side.
OPTIONS = (["--check-interval", "4"], ["-p", "jacobi"],
           ["-p", "jacobi", "--check-interval", "4"])
CLI_JOBS = {
    "dense-radius-3d -b 4": ("dense-radius-3d", 4, None),
    "powerlaw-graph -b 10": ("powerlaw-graph", 10, None),
    "band+random-1pct -b 10": ("band+random-1pct", 10, None),
    "arrowhead -b 10": ("arrowhead", 10, None),
    "dense-radius-3d -b 10 options": ("dense-radius-3d", 10, OPTIONS),
    "arrowhead -b 10 options": ("arrowhead", 10, OPTIONS),
    "powerlaw-graph -b 10 options": ("powerlaw-graph", 10, OPTIONS[:1]),
    "band+random-1pct -b 10 options": ("band+random-1pct", 10,
                                       OPTIONS[:1]),
}


# Phase 38's CLI runs, the rest of the CLI on the card: {label: (zoo file
# or None for the bundled matrix, -b, codeword format, ((kind, flags),
# ...))}.  ``checkpoint``: a straight run, the same with --checkpoint P
# --checkpoint-every 3, and a partial run (-i 4 --checkpoint Q) resumed
# to the full limit, both held equal to the straight run;
# ``pipelined``: a --solver pipelined run held to the run_tests
# contract; ``profile``: --profile DIR, stdout equal to the run without
# it, a trace in DIR that names kernel B.  Run by cli_worker like
# CLI_JOBS, in a pool of their own.
REST_JOBS = {
    "DIA -b 10 checkpoint": (None, 10, "csr", (
        ("checkpoint", ["-m", "secded", "-x"]),
        ("checkpoint", ["-m", "secded", "-x", "--check-interval", "4"]),
        ("checkpoint", ["-m", "secded", "-x", "-p", "jacobi"]))),
    "DIA -b 10 pipelined, profile": (None, 10, "csr", (
        ("pipelined", ["-m", "none"]), ("pipelined", ["-m", "secded", "-x"]),
        ("pipelined", ["-m", "sed", "-x"]), ("profile", ["-m", "secded"]))),
    "dense-radius-3d -b 4 checkpoint": ("dense-radius-3d", 4, "csr", (
        ("checkpoint", ["-m", "secded", "-x"]),)),
    "dense-radius-3d -b 4 pipelined": ("dense-radius-3d", 4, "csr", (
        ("pipelined", ["-m", "secded", "-x"]),)),
    "arrowhead -b 10 checkpoint": ("arrowhead", 10, "csr", (
        ("checkpoint", ["-m", "secded", "-x"]),)),
    "powerlaw-graph -b 10 checkpoint": ("powerlaw-graph", 10, "csr", (
        ("checkpoint", ["-m", "secded", "-x"]),)),
    # float32 pipelined CG breaks down on powerlaw-graph (the alpha
    # denominator turns negative) once rr falls to ~1e-5 of rr0 at -b 10
    # (rr0 ~2.2e5; ~1e-7 at -b 1), long before -c 0.001; so does the JAX
    # package's in float32: the run stops at -c 10, 4.6e-5 of rr0.
    "powerlaw-graph -b 10 pipelined": ("powerlaw-graph", 10, "csr", (
        ("pipelined", ["-m", "secded", "-x", "-c", "10"]),)),
    "cg-coo DIA -b 10 checkpoint": (None, 10, "coo", (
        ("checkpoint", ["-m", "constraints", "-x", "INDEX"]),)),
}
# The kernel wrappers' plain versions: none may run on phase 38's paths.
PLAIN_VERSIONS = (("ops.spmv_cuda", "dia_fast_plain"),
                  ("ops.spmv_cuda", "ell_fast_plain"),
                  ("ops.spmv_cuda", "flat_fast_plain"),
                  ("solver.fused", "fused_cg_dia_plain"),
                  ("solver.fused", "fused_cg_ell_plain"),
                  ("solver.fused", "split_tail_plain"))


def count_plain_calls():
    """Wrap every kernel's plain version in the port's modules with a
    counter; returns the {name: calls} it fills."""
    import importlib

    calls = {}
    for mod_name, name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"abft_sparse_cg_tpu_torch.{mod_name}")
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(mod, name, counted)
    return calls


def contract_lines(out):
    """stdout less the two time lines."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("compile time", "time taken"))]


def iterations_of(out):
    for line in out.splitlines():
        if line.startswith("ran for"):
            return int(line.split()[2])
    return -1


def rest_run(main, base, kind, flags, tmp):
    """One (kind, flags) of REST_JOBS through ``main`` (see there);
    raises on a miss.  Returns {"flags", "kind", the launch counts of
    the checkpointed run or the pipelined one, its iterations and
    corrections}."""
    tag = f"{kind} {' '.join(flags)}"
    if kind == "pipelined":
        reset_launches()
        code, out = run_cli(main, [*base, "--solver", "pipelined", *flags])
        wrappers, instances = launch_counts()
        if "sed" in flags:
            require(code == 1 and "error detected at index" in out,
                    f"{tag}: exit {code}")
        elif "-x" in flags:     # run_tests class 3: exit 0
            require(code == 0 and "[ECC] corrected" in out,
                    f"{tag}: exit {code}")
        else:
            require(code == 0 and total_error(out) < 1.0,
                    f"{tag}: exit {code}, total error {total_error(out)}")
        print(f"passed {tag}: exit {code}, {iterations_of(out)} it, total "
              f"error {total_error(out):f}")
        return {"kind": kind, "flags": flags, "wrappers": wrappers,
                "instances": instances, "iterations": iterations_of(out)}
    code0, out0 = run_cli(main, [*base, *flags])
    require("iteration" in out0, f"{tag}: the straight run solved nothing "
            f"(exit {code0})")
    if kind == "profile":
        pdir = os.path.join(tmp, "profile", "new")
        code, out = run_cli(main, [*base, *flags, "--profile", pdir])
        require(code == code0 == 0
                and contract_lines(out) == contract_lines(out0),
                f"{tag}: exit {code}, stdout differs from the run without")
        with open(os.path.join(pdir, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        b_names = sorted(n for n in names if "fused_cg_dia" in n)
        require(b_names, f"{tag}: the trace names no kernel B launch")
        print(f"passed {tag}: exit 0, stdout equal, trace names {b_names}")
        return {"kind": kind, "flags": flags, "kernel_b": b_names}
    snap, part = os.path.join(tmp, "seg.npz"), os.path.join(tmp, "part.npz")
    reset_launches()
    code1, out1 = run_cli(main, [*base, *flags, "--checkpoint", snap,
                                 "--checkpoint-every", "3"])
    wrappers, instances = launch_counts()
    require(code1 == code0 and contract_lines(out1) == contract_lines(out0),
            f"{tag}: --checkpoint-every 3 stdout differs from the straight "
            "run")
    code2, _ = run_cli(main, [*base, *flags, "-i", "4", "--checkpoint",
                              part])
    code3, out3 = run_cli(main, [*base, *flags, "--checkpoint", part,
                                 "--resume"])
    require(code3 == code0 and contract_lines(out3) == contract_lines(out0),
            f"{tag}: -i 4 then --resume differs from the straight run "
            f"(exits {code2}, {code3})")
    its = iterations_of(out1)
    print(f"passed {tag}: exit {code0}, {its} it, segments of 3 and a "
          f"resumed -i 4 run equal to the straight run")
    return {"kind": kind, "flags": flags, "wrappers": wrappers,
            "instances": instances, "iterations": its,
            "corrections": int("[ECC] corrected" in out1)}


def cli_worker(label):
    """One CLI_JOBS or REST_JOBS entry in this fresh process: the zoo file
    written by the port's mmio into a temporary directory (or the
    bundled matrix), every launch count reset, the runs through main_csr
    or main_coo -t cuda --seed 11 (what bin/cg-csr-torch and
    bin/cg-coo-torch run), the counts read.  Prints the runs' lines,
    then one JSON line: the counts (REST_JOBS: per run, and the calls of
    the kernels' plain versions) and the seconds taken."""
    t0 = time.perf_counter()
    sys.path.insert(0, ROOT)
    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.cli import main_coo, main_csr
    from abft_sparse_cg_tpu_torch.utils.matgen import write_mm_triangle
    from abft_sparse_cg_tpu_torch.utils.matzoo import ZOO

    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        if label in REST_JOBS:
            name, blocks, fmt, runs = REST_JOBS[label]
            path = MATRIX
        else:
            name, blocks, flag_sets = CLI_JOBS[label]
            fmt = "csr"
        if name is not None:
            path = os.path.join(tmp, f"{name}.mtx")
            write_mm_triangle(path, *ZOO[name][0]())
        base = ["-f", path, "-b", str(blocks), "--seed", "11", "-t", "cuda"]
        if label in REST_JOBS:
            plain = count_plain_calls()
            main = main_coo if fmt == "coo" else main_csr
            out = {"runs": [rest_run(main, base, kind, flags, tmp)
                            for kind, flags in runs], "plain": plain}
        else:
            reset_launches()
            if flag_sets is None:
                run_tests_classes(main_csr, base)
            else:
                for flags in flag_sets:
                    option_run(main_csr, base, flags)
            wrappers, instances = launch_counts()
            out = {"wrappers": wrappers, "instances": instances}
    print(json.dumps(dict(out, seconds=time.perf_counter() - t0)))


def cli_pool_start(jobs=CLI_JOBS):
    """Start every entry of ``jobs`` (CLI_JOBS or REST_JOBS) in a worker
    process of its own (``--cli-worker LABEL``), all together, each on
    one host thread (the eight share the host's cores); returns what
    cli_pool_wait takes.  A worker still running when this process exits
    is killed."""
    tmp = tempfile.mkdtemp()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for i, label in enumerate(jobs):
        out = open(os.path.join(tmp, f"{i}.out"), "w+")
        err = open(os.path.join(tmp, f"{i}.err"), "w+")
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--cli-worker", label], stdout=out,
                             stderr=err, text=True, env=env)
        atexit.register(p.kill)
        procs[label] = (p, out, err)
    return tmp, procs, time.perf_counter()


def cli_pool_wait(pool):
    """Wait for cli_pool_start's workers; {label: (the lines it printed,
    its JSON)}.  Raises if a worker failed or outlived 600 s."""
    tmp, procs, t0 = pool
    out = {}
    for label, (p, f, e) in procs.items():
        try:
            code = p.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            code = "none in time"
        f.seek(0)
        e.seek(0)
        lines = f.read().strip().splitlines()
        require(code == 0 and lines, f"CLI worker {label}: exit {code}\n"
                f"{e.read()[-3000:]}")
        out[label] = (lines[:-1], json.loads(lines[-1]))
        f.close()
        e.close()
    shutil.rmtree(tmp)
    print(f"[{len(procs)} CLI workers: {time.perf_counter() - t0:.0f} s "
          "since they started]")
    return out


def trajectory(m, b, label, oracle_mat=None, oracle_dev="cpu", conv=1e-6,
               floor=1e-8, res=None, precond=False, solver="standard"):
    """The f32 cuda trajectory against the port's f64 plain solve (on
    ``oracle_mat``, the same matrix built in another mode, if given; on
    ``oracle_dev``: the plain version runs on the card too), both run to
    ``conv``: rr within 2e-2 down to rr0 * ``floor`` (the
    scripts/tpu_smoke.py bound, floor 1e-8) and, with that floor, the
    iteration counts within max(1, n / 20) (tests/test_zoo_parity.py's
    rule).  A higher floor marks a matrix on which float32 CG itself
    leaves the float64 trajectory there: the counts are then printed,
    not held.  ``res``: the f32 solve to hold (rr_trace, iterations,
    failed), else the cuda target's; ``precond``: both Jacobi PCG;
    ``solver="pipelined"``: both the pipelined solver.  Returns the
    deviation."""
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg_tpu_torch.solver.cg import make_cg_solver

    pre = "jacobi" if precond else "none"
    if res is None:
        res = CudaBackend(m.mode).solve(m, b, 500, conv, dtype="f32",
                                        reps=1, precond=pre, solver=solver)
    f64, odev = torch.float64, torch.device(oracle_dev)

    def exec_vec(v):
        out = torch.zeros(m.R, dtype=f64, device=odev)
        out[: m.N] = torch.tensor(m.to_exec_order(v), dtype=f64)
        return out

    minv = exec_vec(jacobi_minv(m, pre)) if precond else None
    om = m if oracle_mat is None else oracle_mat
    if solver == "pipelined":
        from abft_sparse_cg_tpu_torch.solver.pipelined import (
            make_pipelined_solver)

        oracle = make_pipelined_solver(make_spmv(om, f64, om.mode), 500,
                                       conv)
    else:
        oracle = make_cg_solver(make_spmv(om, f64, om.mode), 500, conv)
    ora = oracle(make_matrix_device(om, f64, odev), exec_vec(b), minv)
    require(not res.failed and ora.stats.errcode == 0
            and res.iterations < 500, "trajectory solves failed")
    if floor <= 1e-8:
        require(abs(res.iterations - ora.iterations)
                <= max(1, ora.iterations // 20),
                f"iterations {res.iterations} vs oracle {ora.iterations}")
    nc = min(res.iterations, ora.iterations)
    got, want = res.rr_trace[:nc], ora.rr_trace[:nc].cpu().numpy()
    # The iterations before the oracle's rr first falls below the floor
    # (CG's rr need not decrease monotonically).
    track = np.cumprod(want >= want[0] * floor).astype(bool)
    tdev = float(np.max(np.abs(got[track] - want[track]) / want[track]))
    require(tdev <= 2e-2, f"trajectory deviation {tdev:.2e} > 2e-2")
    print(f"{label}: f32 trajectory within {tdev:.2e} of the f64 oracle "
          f"over {int(track.sum())}/{ora.iterations} iterations down to rr0 "
          f"* {floor:g} ({res.iterations} vs {ora.iterations} iterations "
          f"to rr < {conv:g})")
    return tdev


def rest_of_cli(dia, ell, pl, card):
    """Phase 38 (see the module docstring): ``dia``, ``ell`` and ``pl``
    are {mode: matrix} of the bundled matrix at -b 10, dense-radius-3d
    and powerlaw-graph -b 10, secded and none at least."""
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.solver.checkpoint import CheckpointedSolve

    dev, f32 = torch.device("cuda", 0), torch.float32

    def bvec_of(mm):
        v = torch.zeros(mm.R, dtype=f32)
        v[: mm.N] = torch.tensor(mm.to_exec_order(
            np.random.default_rng(11).random(mm.N)), dtype=f32)
        return v.to(dev)

    rest_pool = cli_pool_start(REST_JOBS)
    # While the CLI workers run: the pipelined float32 trajectories
    # against the float64 plain pipelined solve on the card (phases 6, 13
    # and 19's bound) on the main process's matrices (powerlaw-graph to
    # rr0 * 1e-4: its float32 pipelined solve breaks down at ~1e-5, see
    # REST_JOBS; its rr is not monotone, and float32 CG, standard or
    # pipelined, leaves the float64 trajectory at ~1e-4 of rr0 on the CPU
    # at -b 1: held down to rr0 * 1e-3).
    for label, mm, om, conv_rel, floor in (
            ("pipelined DIA -b 10 secded (kernel A)", dia["secded"], None,
             1e-8, 1e-8),
            ("pipelined dense-radius-3d -b 10 secded (kernel C)",
             ell["secded"], ell["none"], 1e-8, 1e-8),
            ("pipelined powerlaw-graph -b 10 secded (kernel E)",
             pl["secded"], pl["none"], 1e-4, 1e-3)):
        bt = np.random.default_rng(11).random(mm.N)
        trajectory(mm, bt, label, om, oracle_dev=dev,
                   conv=conv_rel * float(bt @ bt), floor=floor,
                   solver="pipelined")
    rest = cli_pool_wait(rest_pool)
    ran = {}
    for label, (lines, res_) in rest.items():
        print(f"-- {label} ({res_['seconds']:.0f} s)")
        for line in lines:
            print(f"   {line}")
        require(not res_["plain"], f"{label}: plain versions ran on the "
                f"card's paths: {res_['plain']}")
        for r in res_["runs"]:
            ran[label, r["kind"], " ".join(r["flags"])] = r
    seg = ran["DIA -b 10 checkpoint", "checkpoint", "-m secded -x"]
    want_b = seg["iterations"] // 3 + 1 + seg["corrections"]
    got_b = seg["instances"].get("fused_cg_dia (live)", 0)
    print(f"checkpointed DIA -b 10 secded -x, live: {seg['iterations']} it "
          f"in segments of 3, kernel B launched {got_b} times (one per "
          f"segment, {seg['iterations'] // 3 + 1}, and one per repair, "
          f"{seg['corrections']})")
    require(got_b == want_b, f"kernel B: {got_b} launches, expected "
            f"{want_b}")
    for key, counts, name in (
            (("DIA -b 10 checkpoint", "checkpoint",
              "-m secded -x --check-interval 4"), "instances",
             "fused_cg_dia (lazy)"),
            (("DIA -b 10 checkpoint", "checkpoint", "-m secded -x -p jacobi"),
             "instances", "fused_cg_dia (Jacobi)"),
            (("dense-radius-3d -b 4 checkpoint", "checkpoint",
              "-m secded -x"), "wrappers", "fused_cg_ell"),
            (("arrowhead -b 10 checkpoint", "checkpoint", "-m secded -x"),
             "wrappers", "fused_cg_dia (split tail)"),
            (("powerlaw-graph -b 10 checkpoint", "checkpoint",
              "-m secded -x"), "wrappers", "flat_spmv_detect"),
            (("cg-coo DIA -b 10 checkpoint", "checkpoint",
              "-m constraints -x INDEX"), "instances",
             "fused_cg_dia (live two-plane)"),
            (("DIA -b 10 pipelined, profile", "pipelined", "-m secded -x"),
             "wrappers", "dia_spmv_detect"),
            (("dense-radius-3d -b 4 pipelined", "pipelined", "-m secded -x"),
             "wrappers", "ell_spmv_detect"),
            (("powerlaw-graph -b 10 pipelined", "pipelined",
              "-m secded -x -c 10"), "wrappers", "flat_spmv_detect")):
        n = ran[key][counts].get(name, 0)
        print(f"{key[1]} {key[0]} {key[2]}: {name} {n} launches")
        require(n > 0, f"{key}: {name} was not launched")
        if key[1] == "pipelined":
            whole = ran[key]["wrappers"]
            require(whole["fused_cg_ell"] == 0 and not any(
                v for k, v in ran[key]["instances"].items()
                if k.startswith("fused_cg_dia")),
                f"{key}: the pipelined solver launched kernel B or D")

    # solve times: checkpointed against straight (kernel B, DIA -b 10
    # secded), pipelined against standard (DIA -b 10: kernel A per
    # iteration against kernel B; powerlaw-graph -b 10 at -c 10, where
    # float32 pipelined CG stands: both on kernel E)
    tmp38 = tempfile.mkdtemp()
    fns38 = {}
    for label, mm, conv in (("DIA -b 10", dia["secded"], CONV),
                            ("powerlaw-graph -b 10 -c 10",
                             pl["secded"], 10.0)):
        be = CudaBackend("secded")
        md_ = make_matrix_device(mm, f32, dev)
        bb = bvec_of(mm)
        std = be._solver(mm, f32, 1000, conv)
        pip = be._solver(mm, f32, 1000, conv, solver="pipelined")
        print(f"{label}: standard {std(md_, bb).iterations} it, pipelined "
              f"{pip(md_, bb).iterations} it")
        fns38[f"{label} standard"] = lambda s=std, m_=md_, b_=bb: s(m_, b_)
        fns38[f"{label} pipelined"] = lambda s=pip, m_=md_, b_=bb: s(m_, b_)
        if label == "DIA -b 10":
            runner = CheckpointedSolve(
                None, CONV, 3, os.path.join(tmp38, "t.npz"),
                continue_fn=be._continue(mm, f32, CONV))
            fns38[f"{label} checkpoint every 3"] = (
                lambda r=runner, m_=md_, b_=bb: r.run(m_, b_, 1000))
    t38 = interleave(fns38, 3, 5)
    for n, v in t38.items():
        print(f"{n:36s} solve {spread(v)} [{card}]")
    shutil.rmtree(tmp38)


# Phase 39's pairs: bin/cg-csr-torch and bin/cg-coo-torch -f <bundled
# matrix> -b 10 --seed 11 with these flags, each run once on -t cpu (the
# native library, float64, on the host's cores) and once on -t cuda, every
# run a process of its own, all started together.
WITNESS_RUNS = (("csr", ["-m", "secded"]), ("csr", ["-m", "secded", "-x"]),
                ("csr", ["-m", "sed", "-x"]),
                ("csr", ["-m", "secded", "-x", "2"]),
                ("coo", ["-m", "secded", "-x"]),
                ("coo", ["-m", "constraints", "-x", "INDEX"]))
# stdout lines that a cpu and a cuda run of one case may print apart
_APART = ("implementation", "iteration", "... (", "ran for", "compile time",
          "time taken", "total error", "max error")
# A constraints mode's fail-stop line: the text and the element's index.
# The native loop reports the first element of a violated pair (the
# reference's CPU context), the device tiers the element their checks
# flag, which may be the pair's second (ROADMAP.md queue 3).
_VIOLATED = re.compile(r"^(.* violated .*?)(\d+)$")


def witness_lines(out):
    """What a cpu run and a cuda run of one case must print alike: the
    config echo less its implementation line, the injection banner, the
    [ECC] lines, and a constraint line less its index, in order; and the
    constraint lines' indices."""
    lines, indices = [], []
    for ln in out.splitlines():
        if not ln or ln.startswith(_APART):
            continue
        m = _VIOLATED.match(ln)
        if m:
            ln = m.group(1)
            indices.append(int(m.group(2)))
        lines.append(ln)
    return lines, indices


def time_taken(out):
    for line in out.splitlines():
        if line.startswith("time taken"):
            return float(line.split()[3])
    return None


def host_cpu():
    """The host CPU's model name from /proc/cpuinfo, with its family and
    model numbers where a virtual machine reports the name as unknown."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if "unknown" in name:
        name += (f" (x86 family {info.get('cpu family', '?')}, model "
                 f"{info.get('model', '?')})")
    return name


def cpu_witness(dia, card):
    """Phase 39 (see the module docstring): ``dia`` is {mode: matrix} of
    the bundled matrix at -b 10, secded among them."""
    import numpy as np

    from abft_sparse_cg_tpu_torch.backends import available, cpp_backend
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend

    t0 = time.perf_counter()
    lib = cpp_backend.load_library()
    built = cpp_backend.build_seconds()
    threads = lib.abft_num_threads()
    host = f"{host_cpu()}, {threads} OpenMP threads"
    print(f"cpu target's library: {cpp_backend.library_path()}, "
          + (f"built in {built:.2f} s" if built is not None
             else "found built")
          + f", loaded at {time.perf_counter() - t0:.2f} s [{host}]")
    targets = [t for t, _ in available()]
    require(list(dict.fromkeys(targets)) == ["torch", "cpu", "cuda"],
            f"registered targets {list(dict.fromkeys(targets))}, expected "
            "torch, cpu, cuda")

    tmp = tempfile.mkdtemp()
    procs = {}
    jobs = [("list", "csr", "-", ["--list"])] + [
        (f"{fmt} {' '.join(flags)}", fmt, target,
         ["-f", MATRIX, "-b", "10", "--seed", "11", "-t", target, *flags])
        for fmt, flags in WITNESS_RUNS for target in ("cpu", "cuda")]
    for i, (label, fmt, target, args) in enumerate(jobs):
        out = open(os.path.join(tmp, f"{i}.out"), "w+")
        err = open(os.path.join(tmp, f"{i}.err"), "w+")
        p = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "bin", f"cg-{fmt}-torch"),
             *args], stdout=out, stderr=err, text=True)
        atexit.register(p.kill)
        procs[label, target] = (p, out, err)
    res = {}
    for key, (p, out, err) in procs.items():
        try:
            code = p.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            code = "none in time"
        out.seek(0)
        err.seek(0)
        res[key] = (code, out.read(), err.read())
        out.close()
        err.close()
    shutil.rmtree(tmp)
    print(f"[{len(procs)} CLI processes: {time.perf_counter() - t0:.0f} s "
          "since the library's load began]")

    code, out, err = res["list", "-"]
    listed = re.findall(r"^\t(\S+?)-(\S+)$", out, re.M)
    order = list(dict.fromkeys(t for t, _ in listed))
    require(code == 0 and order == ["torch", "cpu", "cuda"]
            and len(listed) == 18, f"bin/cg-csr-torch --list: exit {code}, "
            f"targets {order}\n{err[-2000:]}")
    print("bin/cg-csr-torch --list: torch-*, cpu-*, cuda-* (6 modes each)")
    for fmt, flags in WITNESS_RUNS:
        label = f"{fmt} {' '.join(flags)}"
        (cc, co, ce), (gc, go, ge) = res[label, "cpu"], res[label, "cuda"]
        tag = f"cg-{fmt}-torch -b 10 --seed 11 {' '.join(flags)}"
        require(cc == gc and cc in (0, 1), f"{tag}: exit {cc} on cpu, {gc} "
                f"on cuda\n{ce[-2000:]}\n{ge[-2000:]}")
        (cl, ci), (gl, gi) = witness_lines(co), witness_lines(go)
        require(cl == gl and len(ci) == len(gi)
                and all(abs(i - j) <= 1 for i, j in zip(ci, gi)),
                f"{tag}: cpu and cuda print apart:\n{cl} {ci}\n{gl} {gi}")
        its = (iterations_of(co), iterations_of(go))
        if cc == 0:
            require(abs(its[0] - its[1]) <= 1 and min(its) > 0,
                    f"{tag}: {its[0]} iterations on cpu, {its[1]} on cuda")
            require(max(total_error(co), total_error(go)) < 1.0,
                    f"{tag}: total error {total_error(co)} on cpu, "
                    f"{total_error(go)} on cuda")
        events = [ln for ln in cl
                  if ln.startswith(("***", "[")) or " violated " in ln]
        if ci:
            events.append(f"indices {ci} on cpu, {gi} on cuda")
        print(f"passed {tag}: exit {cc} on both, "
              + (f"{its[0]} and {its[1]} iterations, total error "
                 f"{total_error(co):f} and {total_error(go):f}, "
                 if cc == 0 else "")
              + f"events {events}; time taken: cpu {time_taken(co)} ms "
              f"[{host}], cuda {time_taken(go)} ms [{card}]")

    # The same -b 10 secded solve in this process, warm: the cpu target's
    # first solve here (its OpenMP team's start-up) and three more, and
    # the cuda target's (kernel B) over three repeats.
    m = dia["secded"]
    b = np.random.default_rng(11).random(m.N)
    be = cpp_backend.CppBackend("secded")
    cpu_ms = [be.solve(m, b, 1000, CONV, verbose=False).solve_seconds * 1e3
              for _ in range(4)]
    gpu = CudaBackend("secded").solve(m, b, 1000, CONV, reps=3)
    cpu_its = be.solve(m, b, 1000, CONV, verbose=False).iterations
    require(abs(cpu_its - gpu.iterations) <= 1,
            f"in-process secded solve: {cpu_its} iterations on cpu, "
            f"{gpu.iterations} on cuda")
    print(f"DIA -b 10 secded solve in one process ({cpu_its} and "
          f"{gpu.iterations} iterations): cpu first {cpu_ms[0]:.3f} ms, "
          f"then {spread(cpu_ms[1:])} [{host}]; cuda "
          f"{gpu.solve_seconds * 1e3:.4f} ms per solve over 3 [{card}]")


def profile_worker(group, path):
    """Phase 31's torch.profiler windows of one group, in this fresh
    process, which does nothing else first: ``dia`` (the bundled matrix
    at -b 10), ``ell`` (dense-radius-3d -b 10, row_align 4096) or
    ``split`` (arrowhead -b 10), secded, the matrix the main process
    built, read from the pickle at ``path``; or ``dia100``, the bundled
    matrix at -b 100, which this worker builds itself.
    ``dia`` and ``ell``: windows of warm calls of the kernel (A or C) as
    the solvers call it, its detection-free product, ``A @ x``, the
    sharded SpMV on 4 shards of the card, the halo kernel and ``A @
    x_ext`` on shard 1, and warm solves: the whole-solve
    kernel (B or D) live, lazy CI 4, Jacobi and lazy Jacobi, and the
    sharded solve.  ``split``: warm solves of kernel B's split-tail
    instances, live, lazy CI 4, Jacobi and lazy Jacobi.  Prints one JSON
    line, per window call_profile's numbers and the three largest
    kernels.  (In one long process the later windows lost most device
    events: PERF.md §6.)"""
    import pickle

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_launcher, ell_launcher, fast_spec, make_cuda_product,
        make_cuda_spmv)
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded, default_mesh, make_sharded_solver)
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo, halo_exchange, make_shardmap_spmv)
    from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

    _build.build()
    dev, f32 = torch.device("cuda", 0), torch.float32
    if group == "coo":
        from abft_sparse_cg_tpu_torch.formats import (build_protected,
                                                      load_matrix)

        a10 = load_matrix(MATRIX, 10)
        b = np.random.default_rng(11).random(a10.N)
        windows = {}
        for mode in ("secded", "constraints"):
            for fmt in ("csr", "coo"):
                m = build_protected(fmt, a10, mode)
                md = make_matrix_device(m, f32, dev)
                bd = torch.zeros(m.R, dtype=f32)
                bd[: m.N] = torch.tensor(m.to_exec_order(b), dtype=f32)
                s = CudaBackend(mode)._solver(m, f32, 1000, CONV)
                windows[f"B {fmt.upper()} {mode} solve -b 10"] = (
                    lambda s=s, md=md, bd=bd.to(dev): s(md, bd), 10)
        print(json.dumps(profile_windows(windows)))
        return
    if group == "dia100":
        from abft_sparse_cg_tpu_torch.formats import (build_protected,
                                                      load_matrix)

        m = build_protected("csr", load_matrix(MATRIX, 100), "secded")
    else:
        with open(path, "rb") as f:
            m = pickle.load(f)
    b = np.random.default_rng(11).random(m.N)
    md = make_matrix_device(m, f32, dev)
    be = CudaBackend("secded")
    if group == "dia100":
        bd = torch.zeros(m.R, dtype=f32)
        bd[: m.N] = torch.tensor(m.to_exec_order(b), dtype=f32)
        bd = bd.to(dev)
        s_live = be._solver(m, f32, 1000, CONV)
        s_lazy = be._solver(m, f32, 1000, CONV, False, 32)
        print(json.dumps(profile_windows({
            "B secded solve -b 100": (lambda: s_live(md, bd), 10),
            "B lazy CI 32 solve -b 100": (lambda: s_lazy(md, bd), 10)})))
        return
    if group == "split":
        bd = torch.zeros(m.R, dtype=f32)
        bd[: m.N] = torch.tensor(m.to_exec_order(b), dtype=f32)
        minv = torch.zeros(m.R, dtype=f32)
        minv[: m.N] = torch.tensor(m.to_exec_order(
            jacobi_minv(m, "jacobi")), dtype=f32)
        bd, minv = bd.to(dev), minv.to(dev)
        solvers = {"": be._solver(m, f32, 1000, CONV),
                   " lazy CI 4": be._solver(m, f32, 1000, CONV, False, 4),
                   " Jacobi": be._solver(m, f32, 1000, CONV, True),
                   " lazy Jacobi": be._solver(m, f32, 1000, CONV, True, 4)}
        windows = {f"B split tail{k} secded solve": (
            (lambda s=s: s(md, bd, minv)) if "Jacobi" in k
            else (lambda s=s: s(md, bd)), 10) for k, s in solvers.items()}
        print(json.dumps(profile_windows(windows)))
        return
    spmv, solve = ("A", "B") if group == "dia" else ("C", "D")
    mesh = default_mesh(4, dev)
    smd, bsh, put = _device_put_sharded(m, b, mesh, f32)
    assert isinstance(bsh, ShardedVector)
    bd = bsh.gather(dev)                  # the single-device vectors
    minv = put(jacobi_minv(m, "jacobi")).gather(dev)
    live = make_cuda_spmv(m, f32, "secded").fast_pw
    prod = make_cuda_product(m, f32, "secded").fast_pw
    sharded = make_shardmap_spmv(m, mesh).fast_pw
    H = _halo(m)
    ext1 = halo_exchange(bsh, H)[1]
    spec = fast_spec(m, "secded")
    shard1 = (dia_launcher(smd.shards[1], spec, dev, H) if group == "dia"
              else ell_launcher(smd.shards[1], spec, dev, H, m.R // 4))
    a_csr, _ = csr_yardstick(md, spec)
    xcol = bd[:, None]
    s_csr = shard_yardstick(smd.shards[1], spec, H, m.R // 4)
    ecol = ext1[:, None]
    s_live = be._solver(m, f32, 1000, CONV)
    s_lazy = be._solver(m, f32, 1000, CONV, False, 4)
    s_jac = be._solver(m, f32, 1000, CONV, True)
    s_lazy_jac = be._solver(m, f32, 1000, CONV, True, 4)
    s_sh = make_sharded_solver(m, mesh, 1000, CONV, f32)
    windows = {
        f"{spmv} secded call": (lambda: live(md, bd), 50),
        f"{spmv} product call": (lambda: prod(md, bd), 50),
        "A @ x": (lambda: a_csr @ xcol, 50),
        "sharded SpMV, 4 shards": (lambda: sharded(smd, bsh), 50),
        f"{spmv} halo, shard 1 of 4": (lambda: shard1(ext1), 50),
        "A @ x_ext, shard 1 of 4": (lambda: s_csr @ ecol, 50),
        f"{solve} secded solve": (lambda: s_live(md, bd), 10),
        f"{solve} lazy CI 4 solve": (lambda: s_lazy(md, bd), 10),
        f"{solve} Jacobi solve": (lambda: s_jac(md, bd, minv), 10),
        f"{solve} lazy Jacobi solve": (lambda: s_lazy_jac(md, bd, minv), 10),
        "sharded solve, 4 shards": (lambda: s_sh(smd, bsh), 10),
    }
    print(json.dumps(profile_windows(windows)))


def profile_group(group, mm, card):
    """Phase 31's torch.profiler windows of one group in a fresh worker
    process (``--profile-worker group PICKLE``, the matrix ``mm`` handed
    over in a temporary pickle; None for a group that builds its own):
    prints each window's device time per call, device operations and busy
    share, and returns the windows."""
    import pickle

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{group}.pickle")
        with open(path, "wb") as f:
            pickle.dump(mm, f, protocol=pickle.HIGHEST_PROTOCOL)
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--profile-worker", group, path],
                           capture_output=True, text=True, timeout=400)
    require(p.returncode == 0, f"profile worker {group}: exit "
            f"{p.returncode}\n{p.stderr[-3000:]}")
    windows = json.loads(p.stdout.strip().splitlines()[-1])
    print(f"worker {group} ({time.perf_counter() - t0:.0f} s):")
    for label, w in windows.items():
        if w is None:
            print(f"  {label}: no device events traced: device time not "
                  "measured")
            continue
        print(f"  {label}: device {w['ms']:.4f} ms per call in "
              f"{w['ops']:.2f} device operations; busy "
              f"{w['busy'] * 100:.1f}% of the window [{card}]")
        for name, ms in w["by_name"].items():
            print(f"    {ms:.4f} ms/call  {name[:80]}")
    return windows


def profile_windows(windows):
    """call_profile over each {label: (fn, reps)}, its own output kept
    quiet; per window the numbers and the three largest kernels."""
    out = {}
    for label, (fn, reps) in windows.items():
        with contextlib.redirect_stdout(io.StringIO()):
            w = call_profile(fn, label, "", reps)
        if w is not None:
            top = sorted(w["by_name"].items(), key=lambda kv: -kv[1])[:3]
            w["by_name"] = dict(top)
        out[label] = w
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, ROOT)
    import numpy as np

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.cli import main_csr
    from abft_sparse_cg_tpu_torch.formats import build_protected, load_matrix
    from abft_sparse_cg_tpu_torch.inject import inject_bitflips
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        dia_fast, dia_fast_halo, dia_fast_plain, dia_launcher, dia_spec,
        ell_fast, ell_fast_halo, ell_fast_plain, ell_launcher, ell_spec,
        fast_spec, flat_fast, flat_fast_plain, flat_launcher, flat_spec,
        make_cuda_spmv)
    from abft_sparse_cg_tpu_torch.solver.cg import init_state, make_cg_solver
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.solver.fused import (
        DIA_TILE, SCHEDULES, dia_block_rows, dia_schedule, dia_window_plan,
        ell_plan, fused_cg_dia, fused_cg_dia_plain, fused_cg_ell,
        fused_cg_ell_plain, fused_grid, make_fused_solver, tail_spec)
    from abft_sparse_cg_tpu_torch.utils.ell_edges import (
        ROW_CUT, cut_rows, ell_edge_cases)

    def edge_cut(name):
        """Rows the card keeps of shape ``name`` (an edge case's cut), or
        None for all."""
        return ROW_CUT.get(name.removeprefix("ell-edge "))

    def edge_rows(name, m):
        return edge_cut(name) or m.R

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    t_start = time.perf_counter()

    # ---- 1. device and card ---------------------------------------------
    phase("1. device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {kind} ({count} visible)")
    print(f"card: {card}")

    # ---- 2. build ---------------------------------------------------------
    phase("2. build")
    _build.build()
    print(f"built and loaded csrc/*.cu in {_build.build_seconds():.2f} s "
          f"({_build.BUILD_DIR}); cooperative grids: kernel B "
          f"{fused_grid(0, 'dia')} blocks ({fused_grid(0, 'dia', True)} with "
          f"the split tail), kernel D {fused_grid(0, 'ell')} "
          f"({fused_grid(0, 'ell', True)}); two signal planes (constraints "
          f"on COO128): kernel B {fused_grid(0, 'dia', planes=2)} "
          f"({fused_grid(0, 'dia', True, planes=2)}), kernel D "
          f"{fused_grid(0, 'ell', planes=2)} "
          f"({fused_grid(0, 'ell', True, planes=2)})")
    print("every instance's own grid (a lazy one runs on its live "
          "counterpart's; kernel D's tail-free ones: mode none's, and its "
          "staged stream's largest, which ell_plan sizes per matrix): "
          + ", ".join(
              f"{lay} {'tail ' if tail else ''}{'Jacobi ' if pre else ''}"
              f"{'lazy' if lazy else 'live'} {fused_grid(0, lay, tail, pre, lazy)}"
              for lay in ("dia", "ell") for tail in (False, True)
              for pre in (False, True) for lazy in (False, True)))

    # Kernels C and E size their grids by the card (occupancy x SMs).
    from abft_sparse_cg_tpu_torch.ops.spmv import ell_grid

    occ = {}
    for halo in (0, 1):
        for planes in (1, 2):
            per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(_build.library(
                "ell_spmv_detect").abft_ell_spmv_occupancy(
                0, halo, planes, ctypes.addressof(per_sm),
                ctypes.addressof(sms)), "kernel C occupancy")
            occ[halo, planes] = (per_sm.value, sms.value)
            require(per_sm.value >= 2, f"kernel C (halo {halo}, {planes} "
                    f"planes): {per_sm.value} resident blocks per SM, "
                    "expected >= 2")
    print(f"kernel C: {occ[0, 1][0]} resident blocks per SM "
          f"({occ[1, 1][0]} in the halo form; {occ[0, 2][0]} and "
          f"{occ[1, 2][0]} streaming two signal planes) on {occ[0, 1][1]} "
          f"SMs: {ell_grid(221184, occ[0, 1][1], occ[0, 1][0])} blocks for "
          f"R 221,184, {ell_grid(55296, occ[1, 1][1], occ[1, 1][0])} for a "
          "shard of 55,296 rows")

    if not os.path.exists(MATRIX):
        subprocess.run([sys.executable,
                        os.path.join(ROOT, "matrices", "make_matrix.py")],
                       check=True)
    a10 = load_matrix(MATRIX, 10)

    # ---- 3. kernel A vs plain ---------------------------------------------
    phase("3. kernel A (dia_spmv_detect) vs plain, -b 10, every mode")
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random(a10.N), dtype=f32)
    mats = {}
    a_errs = []
    for mode in MODES:
        m = build_protected("csr", a10, mode)
        require(m.exec_kind == "dia" and m.dia_offsets == (-1, 0, 1),
                f"{mode}: DIA layout with offsets (-1, 0, 1)")
        mats[mode] = m
        spec = dia_spec(m, mode)
        xd = torch.zeros(m.R, dtype=f32, device=dev)
        xd[: m.N] = x.to(dev)

        def compare(mm, label):
            md = make_matrix_device(mm, f32, dev)
            wk, tk, pk = dia_fast(md, xd, spec)
            wp, tp, pp = dia_fast_plain(md, xd, spec)
            torch.cuda.synchronize()
            # A flipped exponent bit may make entries non-finite: those
            # must match in place, the rest bit for bit.
            fin = torch.isfinite(wp)
            require(same_w(wk, wp), f"{label}: w not bit-exact")
            err = float((wk - wp)[fin].abs().max())
            rel = err / float(wp[fin].abs().max())
            prel = pw_rel(pk, pp)
            require(prel <= 1e-5, f"{label}: pw rel err {prel:.3e} > 1e-5")
            require(bool(tk) == bool(tp), f"{label}: trig {bool(tk)} vs "
                    f"plain {bool(tp)}")
            print(f"{label:28s} w max|err| {err:.3e} (rel {rel:.1e}), pw "
                  f"rel {prel:.1e}, trig {bool(tk)} (plain {bool(tp)})")
            a_errs.append(err)
            return bool(tk)

        trig = compare(m, f"{mode} clean")
        require(not trig, f"{mode}: clean matrix triggered")
        if mode in ECC:
            m1 = inject_bitflips(m, "ANY", 1, np.random.default_rng(21),
                                 echo=lambda s: None)
            trig = compare(m1, f"{mode} 1-bit flip")
            require(trig, f"{mode}: 1-bit flip missed")
            m2 = inject_bitflips(m, "ANY", 2, np.random.default_rng(22),
                                 echo=lambda s: None)
            trig = compare(m2, f"{mode} 2-bit flip")
            # Two flips in one element have even weight: parity (sed,
            # sec8) cannot see them by design; the checksum arm can.
            require(trig == (mode in ("sec7", "secded")),
                    f"{mode}: 2-bit flip trigger {trig}")
        if mode == "constraints":
            m1 = inject_bitflips(m, "INDEX", 1, np.random.default_rng(23),
                                 echo=lambda s: None)
            trig = compare(m1, f"{mode} index flip")
            require(trig, "constraints: index flip missed")

    # ---- 4. kernel B vs plain loop ----------------------------------------
    phase("4. kernel B (fused_cg_dia) vs plain loop, -b 10 secded")
    from concurrent.futures import ThreadPoolExecutor

    # phase 23's HPCG stencil, built meanwhile
    hpcg_pool = ThreadPoolExecutor(max_workers=1)
    hpcg88 = hpcg_pool.submit(hpcg_stencil, 88, "secded")
    m = mats["secded"]
    spec = dia_spec(m, "secded")
    b = np.random.default_rng(11).random(m.N)
    bd = torch.zeros(m.R, dtype=f32, device=dev)
    bd[: m.N] = torch.tensor(b, dtype=f32)
    md = make_matrix_device(m, f32, dev)

    def run_loop(fn, md_, spec_, bvec, upto=1000, tail=None, minv=None,
                 ci=1, schedule=None):
        """One launch of ``fn`` from init_state; ``schedule`` forces kernel
        B's or D's tail-free schedule (the plain loops have none)."""
        s = init_state(bvec, upto, minv)
        x_, r_, p_ = s.x.clone(), s.r.clone(), s.p.clone()
        tr = torch.full_like(s.trace, float("nan"))
        kw = {} if schedule is None or fn not in (fused_cg_dia,
                                                  fused_cg_ell) else {
            "schedule": schedule}
        out = fn(md_, spec_, x_, r_, p_, s.rr, s.rz, 0, upto, CONV, tr, tail,
                 minv, ci, **kw)
        torch.cuda.synchronize()
        return out, x_, tr

    def check_loops(kernel, plain, md_, spec_, bvec, label, tail=None,
                    schedule=None, tol=1e-5):
        """Kernel against plain loop: iterations equal, the trace to ``tol``
        (a split tail's to 1e-3 above float32's noise floor, rr0 * 1e-5:
        its dot products are summed in another order), x beside.  Returns
        (iterations, max |x err|, the kernel's x)."""
        (ik, _, _, tk, ek, _), xk, trk = run_loop(kernel, md_, spec_, bvec,
                                                  tail=tail,
                                                  schedule=schedule)
        (ip, _, _, tp, ep, _), xp, trp = run_loop(plain, md_, spec_, bvec,
                                                  tail=tail)
        require(ik == ip and tk == tp == 0 and ek == ep == 0,
                f"{label}: kernel {ik} it (trig {tk}, err {ek}), plain "
                f"{ip} it (trig {tp}, err {ep})")
        err = float((xk - xp).abs().max())
        rel = (trk[:ik] - trp[:ip]).abs() / trp[:ip].abs()
        if tail is not None:
            rel, tol = rel[trp[:ip] > trp[0] * 1e-5], 1e-3
        dev_tr = float(rel.max())
        print(f"{label}: kernel {ik} iterations, plain {ip}; trace max rel "
              f"dev {dev_tr:.2e}; x max|err| {err:.3e}; trig/err {tk}/{ek}")
        require(dev_tr <= tol, f"{label} trace dev {dev_tr:.2e} > {tol}")
        return ik, err, xk

    def check_faulted(m1, mode, label, schedule=None):
        solve = make_fused_solver(m1, mode, 1000, CONV, schedule=schedule)
        bb = torch.zeros(m1.R, dtype=f32)
        bb[: m1.N] = torch.tensor(m1.to_exec_order(
            np.random.default_rng(11).random(m1.N)), dtype=f32)
        rk = solve(make_matrix_device(m1, f32, dev), bb.to(dev))
        rp = solve(make_matrix_device(m1, f32, torch.device("cpu")), bb)
        require(rk.iterations == rp.iterations,
                f"{label}: {rk.iterations} vs {rp.iterations} iterations")
        tp_ = rp.rr_trace[: rp.iterations]
        rel = (rk.rr_trace[: rk.iterations].cpu() - tp_).abs() / tp_.abs()
        tol = 1e-5
        if m1.exec_kind == "split":   # the noise-floor rule of check_loops
            rel, tol = rel[tp_ > tp_[0] * 1e-5], 1e-3
        dev_tr = float(rel.max())
        print(f"{label}: kernel {rk.iterations} it, stats "
              f"{tuple(rk.stats)}; plain {rp.iterations} it, stats "
              f"{tuple(rp.stats)}; trace dev {dev_tr:.2e}")
        require(tuple(rk.stats) == tuple(rp.stats), f"{label} events")
        require(rk.stats.corrected_count == 1 and rk.stats.errcode == 0,
                f"{label}: one correction, no error")
        require(dev_tr <= tol, f"{label} trace dev {dev_tr:.2e}")

    # Kernel B's tail-free instances have three schedules (the update
    # folded into the next product pass, or a pass of its own with p read
    # from shared-memory windows or from device memory): each against the
    # plain loop, and against each other bit for bit (one partition, one
    # reduction order).
    print(f"the matrix's schedule: {dia_schedule(spec.offsets)}")
    b_err, xs_sched = 0.0, {}
    for sched in SCHEDULES:
        ik, err_s, xs_sched[sched] = check_loops(
            fused_cg_dia, fused_cg_dia_plain, md, spec, bd,
            f"clean [{sched}]", schedule=sched)
        b_err = max(b_err, err_s)
        check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(12),
                                      echo=lambda s: None), "secded",
                      f"1-bit flip [{sched}]", sched)
    xs_first, *xs_rest = xs_sched.values()
    require(all(torch.equal(xs_first, v) for v in xs_rest),
            "kernel B: the schedules' x differ")

    # ---- 5. DIA main path: the four run_tests classes ----------------------
    phase("5. DIA main path: run_tests classes, cg-csr -t cuda -b 10 "
          "--seed 11")
    reset_launches()
    run_tests_classes(main_csr, ["-b", "10", "--seed", "11", "-t", "cuda"])
    launches = {"dia_spmv_detect": dia_fast.launches,
                "fused_cg_dia": fused_cg_dia.launches}
    b_schedules = dict(fused_cg_dia.schedules)

    # ---- 6. trajectory ----------------------------------------------------
    phase("6. float32 cuda trajectory vs float64 plain oracle, -b 10")
    trajectory(m, b, "DIA -b 10 secded")

    # ---- 7. launch counts -------------------------------------------------
    phase("7. launch counts during phase 5")
    for name, n in launches.items():
        print(f"{name}: {n} launches")
        require(n > 0, f"{name} was not launched on the main path")
    print(f"fused_cg_dia launches by schedule: {b_schedules}")
    require(b_schedules[dia_schedule(m.dia_offsets)] == launches[
        "fused_cg_dia"], "kernel B's main-path launches did not all run "
        "the matrix's schedule")

    # ---- 8. times ---------------------------------------------------------
    phase(f"8. DIA times on {card} (warm, build excluded)")
    device_state(card)

    def solver_fn(mm, mode, upto=1000):
        # the tier the cuda target picks: whole-solve or per-iteration
        solve = CudaBackend(mode)._solver(mm, f32, upto, CONV)
        mdd = make_matrix_device(mm, f32, dev)
        bb = torch.zeros(mm.R, dtype=f32, device=dev)
        bb[: mm.N] = torch.tensor(mm.to_exec_order(
            np.random.default_rng(11).random(mm.N)), dtype=f32)
        it = solve(mdd, bb).iterations
        return (lambda: solve(mdd, bb)), it

    def dia_iter_bytes(mode, mm):
        """Bytes one DIA iteration must move: D value planes, D fold
        planes (ECC modes), and 8 vector streams (p read, w write + read,
        r read + write, x read + write, p write)."""
        D, R = len(mm.dia_offsets), mm.R
        return (4 * D + (4 * D if mode in ECC else 0) + 8 * 4) * R

    def ell_iter_bytes(mode, mm):
        """Bytes one ELL iteration must move: the values and gather words
        of the nnz valid slots, the K x R signal plane (detecting modes,
        padding included), ell_len, the baseline, and the 8 vector
        streams."""
        K, R = mm.K, mm.R
        sig = 4 * K * R + R // 2 if mode != "none" else 0
        return 8 * mm.nnz + sig + 4 * R + 8 * 4 * R

    def solve_table(label, mats_, batches, reps, iter_bytes):
        """Interleaved full and 2-iteration solves of none and secded:
        medians, spread, the per-iteration slope and its bandwidth."""
        fns, its = {}, {}
        for mode in ("none", "secded"):
            fns[mode], its[mode] = solver_fn(mats_[mode], mode)
            fns[mode + "@2"], its[mode + "@2"] = solver_fn(mats_[mode],
                                                           mode, 2)
        t = interleave(fns, reps, batches)
        med = {n: statistics.median(v) for n, v in t.items()}
        for mode in ("none", "secded"):
            slope = ((med[mode] - med[mode + "@2"])
                     / (its[mode] - its[mode + "@2"]))
            nbytes = iter_bytes(mode, mats_[mode])
            gbs = nbytes / (slope * 1e-3) / 1e9
            print(f"cuda-{mode:6s} solve {label}: {spread(t[mode])}, "
                  f"{its[mode]} it; 2-it solve {med[mode + '@2']:.4f} ms; "
                  f"slope {slope:.4f} ms/it = {gbs:.0f} GB/s "
                  f"({gbs / 3350 * 100:.1f}% of 3.35 TB/s; "
                  f"{nbytes / 1e6:.1f} MB/it) [{card}]")
        print(f"secded overhead vs none {label}: "
              f"{(med['secded'] / med['none'] - 1) * 100:+.1f}% [{card}]")
        return med, its

    solve_table("-b 10", mats, 5, 10, dia_iter_bytes)

    def layer_times(mm, a_, label, reps=3):
        """Host build, upload and (plain) classify of a faulted copy."""
        tl = {"host build": [], "upload": [], "classify": []}
        m1 = inject_bitflips(mm, "ANY", 1, np.random.default_rng(12),
                             echo=lambda s: None)
        plain_classify = make_spmv(m1, f32, "secded").classify
        for _ in range(reps):
            t0 = time.perf_counter()
            build_protected("csr", a_, "secded")
            tl["host build"].append((time.perf_counter() - t0) * 1e3)
            tl["upload"].append(host_ms(
                lambda: make_matrix_device(m1, f32, dev), 1))
            mdf = make_matrix_device(m1, f32, dev)
            tl["classify"].append(host_ms(lambda: plain_classify(mdf), 1))
        for name, v in tl.items():
            print(f"layer {name:10s} {label} secded: {spread(v)} [{card}]")

    layer_times(mats["secded"], a10, "-b 10")

    a100 = load_matrix(MATRIX, 100)
    mats100 = parallel_builds(a100, ("none", "secded"))
    solve_table(f"-b 100 (N={mats100['none'].N})", mats100, 3, 3,
                dia_iter_bytes)
    del a100   # mats100 serves phases 23, 26, 29 and 37 too

    launchers = {dia_fast: dia_launcher, ell_fast: ell_launcher,
                 flat_fast: flat_launcher}

    def kernel_times(kernel, plain, md_, spec_, xd_, label, nbytes, flops):
        """Per-call device time (CUDA events, interleaved) of a kernel as
        the solvers call it (through a launcher made once per matrix),
        its plain version and the bare A @ x, beside the
        bound (phase 31 traces them in fresh processes)."""
        a_csr, nnz = csr_yardstick(md_, spec_)
        xcol = xd_[:, None]
        if kernel in launchers:
            launch = launchers[kernel](md_, spec_, xd_.device)
            call = (lambda: launch(xd_))
        else:
            call = (lambda: kernel(md_, xd_, spec_))
        t = interleave({"plain": lambda: plain(md_, xd_, spec_),
                        "kernel": call,
                        "A @ x": lambda: a_csr @ xcol}, 20,
                       batches=5, timer=event_ms)
        med = {n: statistics.median(v) for n, v in t.items()}
        bms, by = bound(nbytes, flops)
        print(f"{label}, per call (CUDA events): kernel "
              f"{spread(t['kernel'])}; plain {spread(t['plain'])}; A @ x "
              f"(torch.sparse_csr_tensor, nnz {nnz}, no checks) "
              f"{spread(t['A @ x'])}; bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP) = "
              f"{bms / med['kernel'] * 100:.1f}% of the bound [{card}]")
        return med, bms, by

    m = mats["secded"]
    R = m.R
    md = make_matrix_device(m, f32, dev)
    spec = dia_spec(m, "secded")
    xd = torch.zeros(R, dtype=f32, device=dev)
    xd[: m.N] = x.to(dev)
    D = len(m.dia_offsets)
    med_a, *bound_a = kernel_times(
        dia_fast, dia_fast_plain, md, spec, xd, "kernel A secded -b 10",
        4 * (2 * D * R + 2 * R + R // 8), 2 * D * R)

    def loop_fn(fn, md_, spec_, bvec, tail=None, minv=None, ci=1):
        def go():
            s = init_state(bvec, 1000, minv)
            fn(md_, spec_, s.x.clone(), s.r.clone(), s.p.clone(), s.rr,
               s.rz, 0, 1000, CONV, torch.full_like(s.trace, float("nan")),
               tail, minv, ci)
        return go

    tb = interleave({"plain": loop_fn(fused_cg_dia_plain, md, spec, bd),
                     "kernel": loop_fn(fused_cg_dia, md, spec, bd)}, 5)
    ms_b, plain_b = (statistics.median(tb["kernel"]),
                     statistics.median(tb["plain"]))
    bound_b = bound(ik * dia_iter_bytes("secded", m),
                    ik * (2 * D * R + 10 * R))
    print(f"kernel B clean secded solve -b 10 ({ik} it): kernel "
          f"{spread(tb['kernel'])}; plain loop {spread(tb['plain'])}; "
          f"bound {bound_b[0]:.4f} ms ({bound_b[1]}; the -b 10 working set "
          f"of {dia_iter_bytes('secded', m) / 1e6:.1f} MB fits the 50 MB "
          f"L2, so HBM need not be touched) [{card}]")
    kernels = [
        {"name": "dia_spmv_detect", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/dia_spmv_detect.cu",
         "replaces": "abft_sparse_cg_tpu/ops/spmv_pallas.py:519",
         "launches": launches["dia_spmv_detect"],
         "max_abs_err": max(a_errs), "ms": med_a["kernel"],
         "plain_ms": med_a["plain"], "bound_ms": bound_a[0],
         "bound_by": bound_a[1], "library_ms": med_a["A @ x"]},
        {"name": f"fused_cg_dia [{dia_schedule(spec.offsets)}]",
         "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/fused_cg_dia.cu",
         "replaces": "abft_sparse_cg_tpu/solver/fused.py:1248",
         "launches": launches["fused_cg_dia"], "max_abs_err": b_err,
         "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": None},
    ]
    del md
    print(f"[DIA phases done at {time.perf_counter() - t_start:.0f} s]")

    # ---- 9. the ELL matrices ----------------------------------------------
    phase("9. ELL matrices, each mode built once, the modes in parallel "
          "(dense-radius-3d -b 4 for the checks, -b 10 for the timed path)")
    from abft_sparse_cg_tpu_torch.utils.matgen import write_mm_triangle
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    shapes = {}
    for name, blocks, force in (("dense-radius-3d", 4, None),
                                ("blockdiag-random", 2, None),
                                ("stencil27-shuffled", 2, "ell")):
        t0 = time.perf_counter()
        asm = zoo_assembled(name, blocks)
        per = parallel_builds(asm, MODES, force_exec=force)
        for mode in MODES:
            require(per[mode].exec_kind == "ell", f"{name} {mode}: ELL")
        mm = per["secded"]
        shapes[name] = (asm, per)
        print(f"{name} -b {blocks}: N {mm.N}, nnz {mm.nnz}, K {mm.K}, R "
              f"{mm.R}, band {mm.band}, permuted "
              f"{mm.perm is not None}; 6 builds in "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for case, (asm, kw) in ell_edge_cases().items():
        name = f"ell-edge {case}"
        per = parallel_builds(asm, MODES, force_exec="ell", **kw)
        mm = per["secded"]
        shapes[name] = (asm, per)
        print(f"{name}: K {mm.K}, R {edge_rows(name, mm)}, N {mm.N}, "
              f"empty rows {int(np.sum(np.asarray(mm.ell_len) == 0))}")
    print(f"kernel C's edge shapes: 4 x 6 builds in "
          f"{time.perf_counter() - t0:.1f} s")
    # The timed ELL path: dense-radius-3d -b 10, every mode, built with
    # R aligned to 4096 rows (4 shards of 1024-row multiples: the sharded
    # kernel tier of phases 27-29; 1,664 zero rows past the 219,520).
    t0 = time.perf_counter()
    a_ell = zoo_assembled("dense-radius-3d", 10)
    ell = parallel_builds(a_ell, MODES, row_align=4096)
    print(f"dense-radius-3d -b 10 (row_align 4096, R {ell['none'].R}): 6 "
          f"builds in {time.perf_counter() - t0:.1f} s")
    require(ell["secded"].K == 175 and ell["secded"].perm is None
            and ell["secded"].band == 1627,
            "dense-radius-3d -b 10: K 175, band 1627, no permutation")
    require(shapes["stencil27-shuffled"][1]["secded"].perm is not None,
            "stencil27-shuffled: RCM permutation active")

    # ---- 10. kernel C vs plain --------------------------------------------
    # The CLI runs of phases 12, 18 and 25 on the zoo files start here and
    # run beside phases 10 and 11, which check and time nothing.
    cli_pool = cli_pool_start()

    phase("10. kernel C (ell_spmv_detect) vs plain, three shapes and the "
          "schedule's edges, every mode")
    c_errs = []
    for name, (_, per) in shapes.items():
        for mode in MODES:
            m = per[mode]
            spec = ell_spec(m, mode)
            xc = torch.zeros(edge_rows(name, m), dtype=f32, device=dev)
            xc[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                     dtype=f32)
            variants = [("clean", m)]
            for flips, seed in ((1, 21), (2, 22)):
                variants.append((f"{flips}-bit", inject_bitflips(
                    m, "ANY", flips, np.random.default_rng(seed),
                    echo=lambda s: None)))
            if mode in ("none", "constraints"):
                variants.append(("index", inject_bitflips(
                    m, "INDEX", 1, np.random.default_rng(23),
                    echo=lambda s: None)))
            for label, mm in variants:
                mdc = cut_rows(make_matrix_device(mm, f32, dev),
                               edge_cut(name))
                wk, tk, pk = ell_fast(mdc, xc, spec)
                wp, tp, pp = ell_fast_plain(mdc, xc, spec)
                torch.cuda.synchronize()
                tag = f"{name} {mode} {label}"
                require(same_w(wk, wp), f"{tag}: w not bit-exact")
                fin = torch.isfinite(wp)
                err = float((wk - wp)[fin].abs().max())
                prel = pw_rel(pk, pp)
                require(prel <= 1e-5, f"{tag}: pw rel err {prel:.2e}")
                require(bool(tk) == bool(tp), f"{tag}: trig {bool(tk)} vs "
                        f"plain {bool(tp)}")
                # What the mode's signals must see: any change in the
                # ECC modes with a checksum arm, odd-weight changes in
                # the parity-only ones, col-word changes in constraints.
                changed = [not np.array_equal(mm.ell[n], m.ell[n])
                           for n in m.layout.word_names]
                want = {"none": False, "constraints": changed[2],
                        "sed": label != "2-bit" and any(changed),
                        "sec8": label != "2-bit" and any(changed)
                        }.get(mode, any(changed))
                require(bool(tk) == want, f"{tag}: trigger {bool(tk)}, "
                        f"expected {want}")
                c_errs.append(err)
                print(f"{tag:44s} w bit-exact (max|err| {err:.1e}), pw rel "
                      f"{prel:.1e}, trig {bool(tk)}")
                del mdc

    # ---- 11. kernel D vs plain loop ---------------------------------------
    phase("11. kernel D (fused_cg_ell) vs plain loop, dense-radius-3d -b 10 "
          "secded")
    m = ell["secded"]
    spec = ell_spec(m, "secded")
    b_ell = np.random.default_rng(11).random(m.N)
    bde = torch.zeros(m.R, dtype=f32, device=dev)
    bde[: m.N] = torch.tensor(b_ell, dtype=f32)
    mde = make_matrix_device(m, f32, dev)
    # Kernel D's stream in its two schedules (p gathered from a band
    # window in shared memory, or from device memory), both against the
    # plain loop (each on its own plan's grid: 5 and 7 blocks per SM here,
    # so their sums' order differs).
    d_grid, d_sched = ell_plan(dev.index, m.R, spec.band)
    print(f"the matrix's schedule: {d_sched} (band {spec.band}), grid "
          f"{d_grid} blocks")
    require(d_sched == "window", f"dense-radius-3d -b 10: kernel D's "
            f"schedule {d_sched}, expected window")
    d_err = 0.0
    for sched in ("window", "l2"):
        ik_d, err_s, _ = check_loops(
            fused_cg_ell, fused_cg_ell_plain, mde, spec, bde,
            f"clean [{sched}]", schedule=sched)
        d_err = max(d_err, err_s)
    check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(12),
                                  echo=lambda s: None), "secded",
                  "1-bit flip")

    # ---- 12. ELL main path ------------------------------------------------
    phase("12. ELL main path: run_tests classes, cg-csr -t cuda -f "
          "dense-radius-3d.mtx -b 4 --seed 11 (-b 10 is timed in 14); with "
          "it the CLI runs of phases 18 and 25 on the zoo files, each file "
          "and run group in a worker process, all started in phase 10")
    cli_runs = cli_pool_wait(cli_pool)

    def cli_job(label):
        """The lines a CLI_JOBS worker printed, shown here; its counts."""
        lines, got = cli_runs[label]
        print("\n".join(lines))
        return got

    job = cli_job("dense-radius-3d -b 4")
    got = job["wrappers"]
    ell_launches = {k: got[k] for k in ("ell_spmv_detect", "fused_cg_ell")}
    for name, n in ell_launches.items():
        print(f"{name}: {n} launches")
        require(n > 0, f"{name} was not launched on the ELL path")
    d_by = {k: v for k, v in job["instances"].items()
            if k.startswith("fused_cg_ell [")}
    print(f"fused_cg_ell launches by schedule: {d_by}")
    n_window = d_by.get("fused_cg_ell [window]", 0)
    n_none = d_by.get("fused_cg_ell [grid-stride]", 0)
    require(n_window > 0 and n_window + n_none == ell_launches[
        "fused_cg_ell"], "kernel D's main-path launches did not all take "
            "the window (mode none: the grid-stride loop)")

    # ---- 13. ELL trajectory -----------------------------------------------
    phase("13. float32 cuda trajectory vs float64 plain oracle, "
          "dense-radius-3d -b 10")
    # The oracle solves the mode-none build of the same matrix: the same
    # values and structure, without the per-iteration signal scans that
    # make a float64 CPU solve of 38M slots slow.
    trajectory(ell["secded"], b_ell, "ELL -b 10 secded", ell["none"])

    # ---- 14. ELL times ----------------------------------------------------
    phase(f"14. ELL times on {card} (warm, build excluded)")
    device_state(card)
    solve_table("dense-radius-3d -b 10", ell, 5, 10, ell_iter_bytes)
    layer_times(ell["secded"], a_ell, "dense-radius-3d -b 10", reps=1)
    m = ell["secded"]
    R, K = m.R, m.K
    xe = torch.zeros(R, dtype=f32, device=dev)
    xe[: m.N] = x[: m.N].to(dev)
    med_c = {}
    for mode in ("none", "secded"):
        mm = ell[mode]
        mdc = make_matrix_device(mm, f32, dev)
        sig = (4 * K * R + R // 2) if mode != "none" else 0
        med, bms, by = kernel_times(
            ell_fast, ell_fast_plain, mdc, ell_spec(mm, mode), xe,
            f"kernel C {mode} dense-radius-3d -b 10",
            8 * mm.nnz + sig + 4 * R + 8 * R, 2 * mm.nnz)
        med_c[mode] = (med, bms, by)
        del mdc
    td = interleave({"plain": loop_fn(fused_cg_ell_plain, mde, spec, bde),
                     "kernel": loop_fn(fused_cg_ell, mde, spec, bde)}, 3,
                    batches=5)
    ms_d, plain_d = (statistics.median(td["kernel"]),
                     statistics.median(td["plain"]))
    bound_d = bound(ik_d * ell_iter_bytes("secded", m),
                    ik_d * (2 * m.nnz + 10 * R))
    print(f"kernel D clean secded solve dense-radius-3d -b 10 ({ik_d} it): "
          f"kernel {spread(td['kernel'])}; plain loop {spread(td['plain'])};"
          f" bound {bound_d[0]:.4f} ms ({bound_d[1]}) = "
          f"{bound_d[0] / ms_d * 100:.1f}% of the bound [{card}]")
    med, bms, by = med_c["secded"]
    kernels += [
        {"name": "ell_spmv_detect", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/ell_spmv_detect.cu",
         "replaces": "abft_sparse_cg_tpu/ops/spmv_pallas.py:846",
         "launches": ell_launches["ell_spmv_detect"],
         "max_abs_err": max(c_errs), "ms": med["kernel"],
         "plain_ms": med["plain"], "bound_ms": bms, "bound_by": by,
         "library_ms": med["A @ x"]},
        {"name": "fused_cg_ell", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/fused_cg_ell.cu",
         "replaces": "abft_sparse_cg_tpu/solver/fused.py:1248",
         "launches": ell_launches["fused_cg_ell"], "max_abs_err": d_err,
         "ms": ms_d, "plain_ms": plain_d, "bound_ms": bound_d[0],
         "bound_by": bound_d[1], "library_ms": None},
    ]
    del mde

    # ---- 15. the flat and split matrices ----------------------------------
    phase("15. flat and split matrices (zoo families), each mode built "
          "once, the modes in parallel")
    from abft_sparse_cg_tpu_torch.utils.matgen import (
        ROW_LENGTH_EDGES, row_lengths_assembled)
    from abft_sparse_cg_tpu_torch.utils.matzoo import ZOO

    def build_modes(asm, modes, want, name):
        """Each mode's build and the layout each routes to; a mode that
        routes elsewhere than ``want`` is reported and built with that
        layout forced (kernel checks)."""
        per = parallel_builds(asm, modes)
        routes = {mode: m.exec_kind for mode, m in per.items()}
        for mode in modes:
            if routes[mode] != want:
                print(f"  {name} {mode}: routes {routes[mode]}; the check "
                      f"below forces {want}")
                per[mode] = build_protected("csr", asm, mode,
                                            force_exec=want)
        return per, routes

    flat = {}
    for name, blocks in (("powerlaw-graph", 10), ("stencil27-shuffled", 1),
                         ("dense-radius-k729", 10)):
        t0 = time.perf_counter()
        asm = zoo_assembled(name, blocks)
        per, routes = build_modes(asm, MODES, "flat", name)
        mm = per["secded"]
        require(routes["secded"] == "flat",
                f"{name} -b {blocks} secded routes flat")
        flat[name] = (asm, per)
        print(f"{name} -b {blocks}: N {mm.N}, nnz {mm.nnz}, longest row "
              f"{mm.K}, E {mm.exec_size}, permuted {mm.perm is not None}, "
              f"Benes plan attaches (JAX routing) {mm.unstr_attached}; 6 "
              f"builds in {time.perf_counter() - t0:.1f} s")
    # Kernel E's row classes at their edges (a thread's, a warp's, a
    # tile's rows): products only, the matrix is not SPD.
    t0 = time.perf_counter()
    per = parallel_builds(row_lengths_assembled(), MODES, force_exec="flat")
    flat["row-lengths"] = (None, per)
    mm = per["secded"]
    print(f"row-lengths (rows of {', '.join(map(str, ROW_LENGTH_EDGES))} "
          f"slots, then 0-39): N {mm.N}, nnz {mm.nnz}, E {mm.exec_size}, "
          f"permuted {mm.perm is not None}; 6 builds in "
          f"{time.perf_counter() - t0:.1f} s")
    # Kernel E on a plan of one entry: a tridiagonal of 200 rows.
    from abft_sparse_cg_tpu_torch.formats import assemble
    from abft_sparse_cg_tpu_torch.utils.matgen import spd_tridiagonal

    flat["tiny"] = (None, parallel_builds(
        assemble(*(lambda r, c, v, n: (c, r, v, n, 1))(*spd_tridiagonal(200))),
        MODES, force_exec="flat"))
    splits = {}
    for name, main_kind, dense in (("arrowhead", "dia", True),
                                   ("band+random-1pct", "ell", False)):
        t0 = time.perf_counter()
        asm = zoo_assembled(name, 10)
        per = parallel_builds(asm, ("none", "secded"))
        mm = per["secded"]
        require(mm.exec_kind == "split" and mm.main.exec_kind == main_kind
                and (mm.tail.dense_plan is not None) == dense,
                f"{name} -b 10: split, {main_kind} main, dense plan {dense}")
        splits[name] = (asm, per)
        tp = mm.tail.dense_plan
        print(f"{name} -b 10: N {mm.N}, nnz {mm.nnz}; main {main_kind} "
              f"(K {mm.main.K}, band {mm.main.band}, nnz {mm.main.nnz}); "
              f"flat tail of {mm.tail.nnz} entries, dense plan "
              f"{'T %d, S %d' % (len(tp[0]), tp[2]) if tp else None}; 2 "
              f"builds in {time.perf_counter() - t0:.1f} s")

    # ---- 16. kernel E vs plain --------------------------------------------
    phase("16. kernel E (flat_spmv_detect) vs plain, five flat shapes, "
          "every mode")
    e_errs = []
    for name, (_, per) in flat.items():
        for mode in MODES:
            m = per[mode]
            spec = flat_spec(m, mode)
            xf = torch.zeros(m.R, dtype=f32, device=dev)
            xf[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                     dtype=f32)
            variants = [("clean", m)]
            for flips, seed in ((1, 21), (2, 22)):
                variants.append((f"{flips}-bit", inject_bitflips(
                    m, "ANY", flips, np.random.default_rng(seed),
                    echo=lambda s: None)))
            if mode in ("none", "constraints"):
                variants.append(("index", inject_bitflips(
                    m, "INDEX", 1, np.random.default_rng(23),
                    echo=lambda s: None)))
            for label, mm in variants:
                mdf = make_matrix_device(mm, f32, dev)
                wk, tk, pk = flat_fast(mdf, xf, spec)
                wp, tp, pp = flat_fast_plain(mdf, xf, spec)
                torch.cuda.synchronize()
                tag = f"{name} {mode} {label}"
                require(same_w(wk, wp), f"{tag}: w not bit-exact")
                fin = torch.isfinite(wp)
                err = float((wk - wp)[fin].abs().max())
                prel = pw_rel(pk, pp)
                require(prel <= 1e-5, f"{tag}: pw rel err {prel:.2e}")
                require(bool(tk) == bool(tp), f"{tag}: trig {bool(tk)} vs "
                        f"plain {bool(tp)}")
                changed = [not np.array_equal(mm.ell[n], m.ell[n])
                           for n in m.layout.word_names]
                want = {"none": False, "constraints": changed[2],
                        "sed": label != "2-bit" and any(changed),
                        "sec8": label != "2-bit" and any(changed)
                        }.get(mode, any(changed))
                require(bool(tk) == want, f"{tag}: trigger {bool(tk)}, "
                        f"expected {want}")
                e_errs.append(err)
                print(f"{tag:44s} w bit-exact (max|err| {err:.1e}), pw rel "
                      f"{prel:.1e}, trig {bool(tk)}")
                del mdf

    # ---- 17. the split tail of kernel B vs its plain loop ------------------
    phase("17. kernel B with the split tail vs plain loop, arrowhead -b 10 "
          "secded")
    m = splits["arrowhead"][1]["secded"]
    b_arr = np.random.default_rng(11).random(m.N)
    bda = torch.zeros(m.R, dtype=f32, device=dev)
    bda[: m.N] = torch.tensor(m.to_exec_order(b_arr), dtype=f32)
    mda = make_matrix_device(m, f32, dev)
    spec_a, tail_a = dia_spec(m.main, "secded"), (mda[1],
                                                   tail_spec(m, "secded"))
    ik_t, t_err, _ = check_loops(fused_cg_dia, fused_cg_dia_plain, mda[0],
                              spec_a, bda, "clean", tail=tail_a)
    for seed in (12, 14):
        check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(
            seed), echo=lambda s: None), "secded", f"1-bit flip (seed {seed})")

    # ---- 18. the flat and split main paths ---------------------------------
    phase("18. flat and split main paths: run_tests classes, cg-csr -t cuda "
          "-f <file> -b 10 --seed 11 (run in phase 12's workers)")
    path_launches = {}
    for name, need in (("powerlaw-graph", ("flat_spmv_detect",)),
                       ("band+random-1pct", ("ell_spmv_detect",
                                             "flat_spmv_detect")),
                       ("arrowhead", ("fused_cg_dia (split tail)",
                                      "flat_spmv_detect"))):
        job = cli_job(f"{name} -b 10")
        got = path_launches[name] = job["wrappers"]
        print(f"{name}: launches {got} ({job['seconds']:.0f} s in its "
              "worker)")
        for k in need:
            require(got[k] > 0, f"{k} was not launched on the {name} path")

    # ---- 19. trajectories --------------------------------------------------
    phase("19. float32 cuda trajectories vs float64 plain oracle (on the "
          "card), to rr0 * 1e-8")
    # An absolute 1e-6 is ~5e-12 of these systems' rr0 (~N / 3): past
    # what a float32 residual resolves on 655k-820k rows; both solves
    # stop at the scripts/tpu_smoke.py floor, rr0 * 1e-8, instead.  On
    # powerlaw-graph (hub rows: a wide spectrum) float32 CG itself leaves
    # the float64 trajectory once rr falls below ~rr0 * 1e-4, whatever
    # computes the products: there the trace is held down to rr0 * 1e-4.
    for label, per, n_b, floor in (
            ("powerlaw-graph -b 10 secded (per-iteration tier)",
             flat["powerlaw-graph"][1], flat["powerlaw-graph"][0].N, 1e-4),
            ("arrowhead -b 10 secded (kernel B, split tail)",
             splits["arrowhead"][1], splits["arrowhead"][0].N, 1e-8),
            ("band+random-1pct -b 10 secded (per-iteration tier)",
             splits["band+random-1pct"][1],
             splits["band+random-1pct"][0].N, 1e-8)):
        bt = np.random.default_rng(11).random(n_b)
        trajectory(per["secded"], bt, label, per["none"], oracle_dev=dev,
                   conv=1e-8 * float(bt @ bt), floor=floor)

    # ---- 20. wide-band ELL -------------------------------------------------
    phase("20. wide-band ELL: stencil27-shuffled -b 10, kernels C and D")
    t0 = time.perf_counter()
    a_st = zoo_assembled("stencil27-shuffled", 10)
    wide = parallel_builds(a_st, ("none", "secded"))
    mw = wide["secded"]
    require(mw.exec_kind == "ell" and 1920 < mw.band <= 16256
            and mw.perm is not None,
            f"stencil27-shuffled -b 10: ELL band {mw.band} under RCM")
    print(f"stencil27-shuffled -b 10: N {mw.N}, nnz {mw.nnz}, K {mw.K}, "
          f"band {mw.band}, permuted; 2 builds in "
          f"{time.perf_counter() - t0:.1f} s")
    for mode, mm in wide.items():
        spec = ell_spec(mm, mode)
        xw = torch.zeros(mm.R, dtype=f32, device=dev)
        xw[: mm.N] = torch.tensor(np.random.default_rng(3).random(mm.N),
                                  dtype=f32)
        for label, m1 in (("clean", mm), ("1-bit", inject_bitflips(
                mm, "ANY", 1, np.random.default_rng(21),
                echo=lambda s: None))):
            mdw = make_matrix_device(m1, f32, dev)
            wk, tk, pk = ell_fast(mdw, xw, spec)
            wp, tp, pp = ell_fast_plain(mdw, xw, spec)
            torch.cuda.synchronize()
            tag = f"wide-band {mode} {label}"
            require(same_w(wk, wp) and bool(tk) == bool(tp)
                    and pw_rel(pk, pp) <= 1e-5, f"{tag}: kernel C vs plain")
            require(bool(tk) == (mode != "none" and label != "clean"),
                    f"{tag}: trigger {bool(tk)}")
            print(f"{tag}: kernel C w bit-exact, pw rel "
                  f"{pw_rel(pk, pp):.1e}, trig {bool(tk)}")
    mdw = make_matrix_device(mw, f32, dev)
    bw_ = torch.zeros(mw.R, dtype=f32, device=dev)
    bw_[: mw.N] = torch.tensor(mw.to_exec_order(
        np.random.default_rng(11).random(mw.N)), dtype=f32)
    ik_w, _, _ = check_loops(fused_cg_ell, fused_cg_ell_plain, mdw,
                          ell_spec(mw, "secded"), bw_, "kernel D clean")
    del mdw
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stencil27-shuffled.mtx")
        write_mm_triangle(path, *ZOO["stencil27-shuffled"][0]())
        reset_launches()
        code, out = run_cli(main_csr, ["-f", path, "-b", "10", "--seed",
                                       "11", "-t", "cuda", "-m", "secded"])
        te = total_error(out)
        require(code == 0 and te < 1.0 and fused_cg_ell.launches > 0
                and fused_cg_ell.schedules["l2"] == fused_cg_ell.launches,
                f"wide-band CLI secded: exit {code}, total error {te}, "
                f"kernel D launches {fused_cg_ell.launches} by schedule "
                f"{fused_cg_ell.schedules}")
        print(f"cg-csr -t cuda -m secded -f stencil27-shuffled.mtx -b 10: "
              f"exit 0, total error {te:f}, kernel D launches "
              f"{fused_cg_ell.launches} by schedule "
              f"{fused_cg_ell.schedules} (band {mw.band})")
    solve_table("wide-band ELL stencil27-shuffled -b 10", wide, 3, 5,
                ell_iter_bytes)
    del wide, a_st

    # ---- 21. times of the flat and split paths -----------------------------
    phase(f"21. flat and split times on {card} (warm, build excluded)")

    def flat_call_bytes(mode, mm):
        """Bytes one kernel E call must move: value and gather word of the
        nnz valid slots, the (E,) signal plane and its baseline
        (detecting modes), the row pointer, x read, w written."""
        E, R = mm.exec_size, mm.R
        sig = 4 * E + E // 2 if mode != "none" else 0
        return 8 * mm.nnz + sig + 4 * (R + 1) + 8 * R

    def flat_iter_bytes(mode, mm):
        """One per-iteration-tier iteration: kernel E's bytes and the 8
        vector streams of the CG update (solver.cg, eager)."""
        return flat_call_bytes(mode, mm) - 8 * mm.R + 8 * 4 * mm.R

    def split_iter_bytes(mode, mm):
        """A split iteration: the main part's planes, the tail's (a dense
        plan's td and tb, or kernel E's), and the 8 vector streams."""
        main, tail = mm.main, mm.tail
        if main.exec_kind == "dia":
            mb = dia_iter_bytes(mode, main) - 8 * 4 * main.R
        else:
            mb = ell_iter_bytes(mode, main) - 8 * 4 * main.R
        if tail.dense_plan is not None:
            T, S = len(tail.dense_plan[0]), tail.dense_plan[2]
            E = tail.exec_size
            tb = 8 * T * S + (4 * E + E // 2 if mode != "none" else 0)
        else:
            tb = flat_call_bytes(mode, tail) - 8 * tail.R
        return mb + tb + 8 * 4 * mm.R

    pl = flat["powerlaw-graph"][1]
    solve_table("powerlaw-graph -b 10 (per-iteration tier)", pl, 5, 3,
                flat_iter_bytes)
    layer_times(pl["secded"], flat["powerlaw-graph"][0],
                "powerlaw-graph -b 10", reps=1)
    solve_table("band+random-1pct -b 10 (per-iteration tier)",
                splits["band+random-1pct"][1], 3, 3, split_iter_bytes)
    solve_table("arrowhead -b 10 (kernel B, split tail)",
                splits["arrowhead"][1], 3, 5, split_iter_bytes)
    med_e = {}
    for name in ("powerlaw-graph", "dense-radius-k729"):
        for mode in ("none", "secded"):
            mm = flat[name][1][mode]
            mdf = make_matrix_device(mm, f32, dev)
            xf = torch.zeros(mm.R, dtype=f32, device=dev)
            xf[: mm.N] = torch.tensor(np.random.default_rng(3).random(mm.N),
                                      dtype=f32)
            med_e[name, mode] = kernel_times(
                flat_fast, flat_fast_plain, mdf, flat_spec(mm, mode), xf,
                f"kernel E {mode} {name} -b 10", flat_call_bytes(mode, mm),
                2 * mm.nnz)
            del mdf
    for name in ("powerlaw-graph", "dense-radius-k729"):
        print(f"kernel E secded over none, {name} -b 10 (the price of "
              f"computing the flat signals on every call): "
              f"{(med_e[name, 'secded'][0]['kernel'] / med_e[name, 'none'][0]['kernel'] - 1) * 100:+.1f}% [{card}]")
    # Kernel C at the band split's main part, the shape the per-iteration
    # tier launches live on band+random-1pct -b 10 (K 11, R 819,200): the
    # main path's one shape where a block walks several tiles (25,600
    # warps of rows over the resident blocks), so the ring runs on across
    # tiles.  Held to the plain version live and as the product, clean and
    # with a 1-bit fault, through the launcher the solver resolves.
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import product_spec

    mm = splits["band+random-1pct"][1]["secded"].main
    xb = torch.zeros(mm.R, dtype=f32, device=dev)
    xb[: mm.N] = torch.tensor(np.random.default_rng(3).random(mm.N),
                              dtype=f32)
    cb_errs = []
    for label, m1 in (("clean", mm), ("1-bit", inject_bitflips(
            mm, "ANY", 1, np.random.default_rng(21), echo=lambda s: None))):
        changed = any(not np.array_equal(m1.ell[n], mm.ell[n])
                      for n in mm.layout.word_names)
        mdb = make_matrix_device(m1, f32, dev)
        for spec_b in (ell_spec(m1, "secded"), product_spec(m1, "secded")):
            wk, tk, pk = ell_launcher(mdb, spec_b, dev)(xb)
            wp, tp, pp = ell_fast_plain(mdb, xb, spec_b)
            torch.cuda.synchronize()
            tag = (f"band+random-1pct main secded {label} "
                   f"{'live' if spec_b.detect else 'product'}")
            prel = pw_rel(pk, pp)
            require(same_w(wk, wp), f"{tag}: w not bit-exact")
            require(prel <= 1e-5, f"{tag}: pw rel err {prel:.2e}")
            require(bool(tk) == bool(tp) == (spec_b.detect and changed),
                    f"{tag}: trig {bool(tk)}, plain {bool(tp)}, changed "
                    f"{changed}")
            err = float((wk - wp)[torch.isfinite(wp)].abs().max())
            cb_errs.append(err)
            print(f"{tag}: kernel C w bit-exact (max|err| {err:.1e}), pw "
                  f"rel {prel:.1e}, trig {bool(tk)}")
        del mdb
    mdb = make_matrix_device(mm, f32, dev)
    med_cb = kernel_times(
        ell_fast, ell_fast_plain, mdb, ell_spec(mm, "secded"), xb,
        f"kernel C secded band+random-1pct -b 10 main part (K {mm.K}, R "
        f"{mm.R})", 8 * mm.nnz + 4 * mm.K * mm.R + mm.R // 2 + 12 * mm.R,
        2 * mm.nnz)
    del mdb, xb
    ta = interleave({"plain": loop_fn(fused_cg_dia_plain, mda[0], spec_a,
                                      bda, tail_a),
                     "kernel": loop_fn(fused_cg_dia, mda[0], spec_a, bda,
                                       tail_a)}, 3, batches=5)
    ms_t, plain_t = (statistics.median(ta["kernel"]),
                     statistics.median(ta["plain"]))
    ma = splits["arrowhead"][1]["secded"]
    T_a, S_a = len(ma.tail.dense_plan[0]), ma.tail.dense_plan[2]
    bound_t = bound(ik_t * split_iter_bytes("secded", ma),
                    ik_t * (2 * len(ma.dia_offsets) * ma.R + 10 * ma.R
                            + 4 * T_a * S_a))
    print(f"kernel B with the split tail, clean secded solve arrowhead -b 10 "
          f"({ik_t} it): kernel {spread(ta['kernel'])}; plain loop "
          f"{spread(ta['plain'])}; bound {bound_t[0]:.4f} ms ({bound_t[1]}; "
          f"{split_iter_bytes('secded', ma) / 1e6:.1f} MB/it) = "
          f"{bound_t[0] / ms_t * 100:.1f}% of the bound [{card}]")
    del mda
    med, bms, by = med_e["powerlaw-graph", "secded"]
    kernels += [
        {"name": "flat_spmv_detect", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/flat_spmv_detect.cu",
         "replaces": "abft_sparse_cg_tpu/ops/spmv_unstructured.py:447",
         "launches": path_launches["powerlaw-graph"]["flat_spmv_detect"],
         "max_abs_err": max(e_errs), "ms": med["kernel"],
         "plain_ms": med["plain"], "bound_ms": bms, "bound_by": by,
         "library_ms": med["A @ x"]},
        {"name": "ell_spmv_detect (band+random-1pct main)", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/ell_spmv_detect.cu",
         "replaces": "abft_sparse_cg_tpu/ops/spmv_pallas.py:846",
         "launches": path_launches["band+random-1pct"]["ell_spmv_detect"],
         "max_abs_err": max(cb_errs), "ms": med_cb[0]["kernel"],
         "plain_ms": med_cb[0]["plain"], "bound_ms": med_cb[1],
         "bound_by": med_cb[2], "library_ms": med_cb[0]["A @ x"]},
        {"name": "fused_cg_dia (split tail)", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/dia_common.cuh",
         "replaces": "abft_sparse_cg_tpu/solver/fused.py:977",
         "launches": path_launches["arrowhead"]["fused_cg_dia (split tail)"],
         "max_abs_err": t_err, "ms": ms_t, "plain_ms": plain_t,
         "bound_ms": bound_t[0], "bound_by": bound_t[1],
         "library_ms": None},
    ]

    # ---- 22. the lazy and Jacobi instances of kernels B and D -------------
    phase("22. kernels B and D, lazy (CI 4) and Jacobi instances vs their "
          "plain loops, secded: DIA -b 10, dense-radius-3d -b 10, arrowhead "
          "-b 10")
    from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
    from abft_sparse_cg_tpu_torch.ops.spmv import ERR_SED

    minvs = {}

    def minv_of(mm, device=dev, like=None):
        """The exec-order Jacobi M^-1 of ``mm`` (or, for a faulted or
        other-mode copy, of the matrix ``like`` it was built from: the
        ECC-corrected diagonal is the same), computed once per matrix."""
        key = (id(like if like is not None else mm), str(device))
        if key not in minvs:
            src = like if like is not None else mm
            v = torch.zeros(src.R, dtype=f32)
            v[: src.N] = torch.tensor(src.to_exec_order(
                jacobi_minv(src, "jacobi")), dtype=f32)
            minvs[key] = v.to(device)
        return minvs[key]

    def bvec_of(mm, device=dev):
        v = torch.zeros(mm.R, dtype=f32)
        v[: mm.N] = torch.tensor(mm.to_exec_order(
            np.random.default_rng(11).random(mm.N)), dtype=f32)
        return v.to(device)

    VARIANTS = (("lazy", False, 4), ("Jacobi", True, 1),
                ("lazy Jacobi", True, 4))
    opt = {}    # (matrix, instance) -> {"err": max|x err|, "its": iters}

    def merge_opt(label, name, tag):
        """Kernel B's row of an instance over its schedules: the largest
        x error, the iterations (the same on both)."""
        cur, prev = opt[tag, name], opt.get((label, name))
        opt[label, name] = cur if prev is None else {
            "err": max(prev["err"], cur["err"]), "its": cur["its"]}

    def check_variant(kernel, plain, md_, spec_, bvec, name, label, minv,
                      ci, tail=None, schedule=None):
        """One instance against its plain loop on the card: iterations
        equal, no trigger or error, the trace within 1e-3 above float32's
        noise floor (rr0 * 1e-5), and a lazy run's x equal to the live
        instance's (on the same schedule) bit for bit."""
        ok, xk, trk = run_loop(kernel, md_, spec_, bvec, tail=tail,
                               minv=minv, ci=ci, schedule=schedule)
        op, xp, trp = run_loop(plain, md_, spec_, bvec, tail=tail,
                               minv=minv, ci=ci)
        require(ok.itr == op.itr and ok.trig == op.trig == 0
                and ok.err == op.err == 0,
                f"{label} {name}: kernel {ok.itr} it (trig {ok.trig}, err "
                f"{ok.err}), plain {op.itr} it (trig {op.trig}, err "
                f"{op.err})")
        it = ok.itr
        keep = trp[:it] > trp[0] * 1e-5
        dev_tr = float(((trk[:it] - trp[:it]).abs() / trp[:it].abs())[keep]
                       .max())
        err = float((xk - xp).abs().max())
        require(dev_tr <= 1e-3, f"{label} {name}: trace dev {dev_tr:.2e}")
        same = "-"
        if ci > 1:
            live, xl, _ = run_loop(kernel, md_, spec_, bvec, tail=tail,
                                   minv=minv, ci=1, schedule=schedule)
            same = torch.equal(xk, xl) and live.itr == it
            require(same, f"{label} {name}: lazy x differs from live")
        print(f"{label} {name}: kernel {it} it, plain {op.itr}; trace max rel"
              f" dev {dev_tr:.2e}; x max|err| {err:.3e}; lazy x == live x: "
              f"{same}")
        opt[label, name] = {"err": err, "its": it}
        return xk

    def check_faulted_variant(m1, mode, name, label, precond, ci, clean_x,
                              plain_too, clean, schedule=None):
        """One corrected fault (a rollback under the lazy schedule): one
        correction, no error, x equal to the clean solve's bit for bit;
        with ``plain_too``, the events and iterations of the plain loop
        (CPU tensors) too."""
        solve = make_fused_solver(m1, mode, 1000, CONV, precond=precond,
                                  check_interval=ci, schedule=schedule)
        args = (minv_of(m1, like=clean),) if precond else ()
        rk = solve(make_matrix_device(m1, f32, dev), bvec_of(m1), *args)
        require(rk.stats.corrected_count == 1 and rk.stats.errcode == 0,
                f"{label} {name} 1-bit: stats {tuple(rk.stats)}")
        require(torch.equal(rk.x, clean_x),
                f"{label} {name} 1-bit: x differs from the clean solve")
        msg = ""
        if plain_too:
            cargs = (minv_of(m1, "cpu", like=clean),) if precond else ()
            rp = solve(make_matrix_device(m1, f32, torch.device("cpu")),
                       bvec_of(m1, "cpu"), *cargs)
            require(rp.iterations == rk.iterations
                    and tuple(rp.stats) == tuple(rk.stats),
                    f"{label} {name} 1-bit: plain {rp.iterations} it "
                    f"{tuple(rp.stats)} vs kernel {rk.iterations} it")
            msg = f"; plain loop {rp.iterations} it, the same events"
        print(f"{label} {name} 1-bit flip: {rk.iterations} it, stats "
              f"{tuple(rk.stats)}, x equal to the clean solve{msg}")

    def check_sed(msed, name, label, precond, ci, schedule=None):
        m1 = inject_bitflips(msed, "ANY", 1, np.random.default_rng(5),
                             echo=lambda s: None)
        solve = make_fused_solver(m1, "sed", 1000, CONV, precond=precond,
                                  check_interval=ci, schedule=schedule)
        args = (minv_of(m1, like=msed),) if precond else ()
        rk = solve(make_matrix_device(m1, f32, dev), bvec_of(m1), *args)
        require(rk.stats.errcode == ERR_SED and rk.iterations == 0,
                f"{label} {name} sed: {rk.iterations} it, stats "
                f"{tuple(rk.stats)}")
        print(f"{label} {name} sed 1-bit flip: fail-stop, errcode "
              f"{rk.stats.errcode}, iterations 0")

    ell_sed = shapes["dense-radius-3d"][1]["sed"]
    for label, mm, kernel, plain, tail_of, msed, plain_too in (
            ("DIA -b 10", mats["secded"], fused_cg_dia, fused_cg_dia_plain,
             None, mats["sed"], True),
            ("dense-radius-3d -b 10", ell["secded"], fused_cg_ell,
             fused_cg_ell_plain, None, ell_sed, False),
            ("arrowhead -b 10", splits["arrowhead"][1]["secded"],
             fused_cg_dia, fused_cg_dia_plain, "tail", None, True)):
        split = tail_of is not None
        mdv = make_matrix_device(mm, f32, dev)
        tl = None
        if split:
            mdv, tl = mdv[0], (mdv[1], tail_spec(mm, "secded"))
        spec_v = (dia_spec(mm.main, "secded") if split
                  else (dia_spec if mm.exec_kind == "dia" else ell_spec)(
                      mm, "secded"))
        bv = bvec_of(mm)
        mi = minv_of(mm)
        m1 = inject_bitflips(mm, "ANY", 1, np.random.default_rng(12),
                             echo=lambda s: None)
        # kernel B's tail-free instances on each schedule
        scheds = SCHEDULES if kernel is fused_cg_dia and not split else (
            None,)
        for sched, (vname, precond, ci) in (
                (sc, v) for sc in scheds for v in VARIANTS):
            name = ("split tail " if split else "") + vname
            tag = label + (f" [{sched}]" if sched else "")
            xk = check_variant(kernel, plain, mdv, spec_v, bv, name, tag,
                               mi if precond else None, ci, tl, sched)
            if sched is not None:
                merge_opt(label, name, tag)
            # The plain loop of a faulted solve runs on CPU tensors: once
            # per matrix (phases 4 and 17 hold the live instances).
            check_faulted_variant(m1, "secded", name, tag, precond, ci,
                                  xk, plain_too and vname == "lazy Jacobi"
                                  and sched in (None, scheds[0]), mm, sched)
            if msed is not None:
                check_sed(msed, name, tag, precond, ci, sched)
        del mdv

    # The bundled matrix's diagonal is constant: there M^-1 = I / d and
    # Jacobi PCG takes plain CG's path, so a kernel B that ignored or
    # misindexed M^-1 would still match.  Scaled row by row by up to 10x,
    # the diagonal tells the two apart.
    on_diag = a10.rows == a10.cols
    vals = a10.values.copy()
    vals[on_diag] *= 1.0 + 9.0 * np.random.default_rng(2).random(
        int(on_diag.sum()))
    mv = build_protected("csr", dataclasses.replace(a10, values=vals), "secded")
    require(mv.exec_kind == "dia", "scaled-diagonal -b 10: DIA layout")
    mdv, spec_v, bv, mi = (make_matrix_device(mv, f32, dev),
                           dia_spec(mv, "secded"), bvec_of(mv), minv_of(mv))
    m1 = inject_bitflips(mv, "ANY", 1, np.random.default_rng(12),
                         echo=lambda s: None)
    for sched, (vname, ci) in ((sc, v) for sc in SCHEDULES for v in (
            ("Jacobi", 1), ("lazy Jacobi", 4))):
        label = f"DIA -b 10 scaled diagonal [{sched}]"
        xk = check_variant(fused_cg_dia, fused_cg_dia_plain, mdv, spec_v, bv,
                           vname, label, mi, ci, schedule=sched)
        check_faulted_variant(m1, "secded", vname, label, True, ci, xk,
                              False, mv, sched)
        (ij, *_), _, trj = run_loop(fused_cg_dia_plain, mdv, spec_v, bv,
                                    minv=mi, ci=ci)
        (iu, *_), _, tru = run_loop(fused_cg_dia_plain, mdv, spec_v, bv,
                                    ci=ci)
        k = min(ij, iu)
        apart = (float(((trj[:k] - tru[:k]).abs() / tru[:k].abs()).max())
                 if k else 0.0)
        print(f"{label} {vname}: the plain loop takes {ij} it with M^-1, "
              f"{iu} without; traces apart by {apart:.2e} (rel)")
        require(ij != iu or apart > 1e-2,
                f"{label} {vname}: Jacobi indistinguishable from plain CG")
    del mdv

    # ---- 23. kernel B at -b 100: the streaming kernel's counterpart -------
    phase("23. kernel B at DIA -b 100 (what the TPU routes to "
          "_make_streaming_kernel): live, lazy CI 32 and Jacobi vs plain")
    m = mats100["secded"]
    md100 = make_matrix_device(m, f32, dev)
    spec100 = dia_spec(m, "secded")
    b100, mi100 = bvec_of(m), minv_of(m)
    for sched in SCHEDULES:
        check_loops(fused_cg_dia, fused_cg_dia_plain, md100, spec100, b100,
                    f"-b 100 live [{sched}]", schedule=sched)
        for vname, precond, ci in (("lazy", False, 32), ("Jacobi", True, 1)):
            check_variant(fused_cg_dia, fused_cg_dia_plain, md100, spec100,
                          b100, f"{vname}, -b 100", f"DIA -b 100 [{sched}]",
                          mi100 if precond else None, ci, schedule=sched)
            merge_opt("DIA -b 100", f"{vname}, -b 100",
                      f"DIA -b 100 [{sched}]")

    # HPCG's stencil at 88^3 (681,472 rows, offsets to +-7,833): three
    # windows, and two tiles per block on the card's grid, so that the
    # window schedule stages the second tile's windows into the other set
    # behind the first tile's stencil.  Window and three-sync against the
    # plain loop, and against each other bit for bit (one partition, one
    # reduction order).  The trace to 1e-4: ~100 iterations of float32 dot
    # products over 681,472 rows, each summed in another order than
    # torch.sum's (~sqrt(R) 2^-24 = 5e-5 relative apiece); the first run
    # on the card read 2.1e-5.
    mh = hpcg88.result()
    hpcg_pool.shutdown()
    mdh, spech, bh = make_matrix_device(mh, f32, dev), dia_spec(mh,
                                                                "secded"), \
        bvec_of(mh)
    plan_h = dia_window_plan(spech.offsets)
    nb_h = dia_block_rows(mh.R, fused_grid(0, "dia"))
    print(f"HPCG 88^3: R {mh.R}, max|offset| "
          f"{max(abs(o) for o in spech.offsets)}, schedule "
          f"{dia_schedule(spech.offsets)}, windows {plan_h}, {nb_h} rows "
          f"per block")
    require(dia_schedule(spech.offsets) == "window"
            and len(plan_h.starts) == 3 and nb_h > DIA_TILE,
            "HPCG 88^3: not three windows and two tiles per block")
    for sched in ("three-sync", "window"):
        check_loops(fused_cg_dia, fused_cg_dia_plain, mdh, spech, bh,
                    f"HPCG 88^3 live [{sched}]", schedule=sched, tol=1e-4)
    for vname, ci in (("live", 1), ("lazy CI 32", 32)):
        (ow, xw, trw), (o3, x3, tr3) = (
            run_loop(fused_cg_dia, mdh, spech, bh, ci=ci, schedule=sched)
            for sched in ("window", "three-sync"))
        same = ((ow.itr, ow.trig, ow.err) == (o3.itr, o3.trig, o3.err)
                and torch.equal(ow.rr, o3.rr) and torch.equal(xw, x3)
                and torch.equal(trw[: ow.itr], tr3[: o3.itr]))
        print(f"HPCG 88^3 {vname}: window {ow.itr} it, three-sync "
              f"{o3.itr} it; rr, x and trace bit for bit: {same}")
        require(same, f"HPCG 88^3 {vname}: window differs from three-sync")
    del mh, mdh

    # ---- 24. the detection-free products of kernels A, C and E -------------
    phase("24. the detection-free products of kernels A, C and E vs plain "
          "(no signal plane, the mode's gather masking kept), then a lazy "
          "per-iteration solve on powerlaw-graph -b 10")
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import product_spec

    prod_errs = {"dia_spmv_detect": [], "ell_spmv_detect": [],
                 "flat_spmv_detect": []}
    prod_shapes = [("DIA -b 10", mats, dia_fast, dia_fast_plain,
                    "dia_spmv_detect")]
    prod_shapes += [(name, per, ell_fast, ell_fast_plain, "ell_spmv_detect")
                    for name, (_, per) in shapes.items()]
    prod_shapes += [(name, per, flat_fast, flat_fast_plain,
                     "flat_spmv_detect") for name, (_, per) in flat.items()]
    for name, per, kern, plain, key in prod_shapes:
        for mode in ("constraints", "sec8", "secded"):
            m = per[mode]
            spec = product_spec(m, mode)
            xp_ = torch.zeros(edge_rows(name, m), dtype=f32, device=dev)
            xp_[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                      dtype=f32)
            for label, mm in (("clean", m), ("1-bit", inject_bitflips(
                    m, "ANY", 1, np.random.default_rng(21),
                    echo=lambda s: None))):
                mdp = cut_rows(make_matrix_device(mm, f32, dev),
                               edge_cut(name))
                before = kern.product_launches
                wk, tk, pk = kern(mdp, xp_, spec)
                wp, tp, pp = plain(mdp, xp_, spec)
                torch.cuda.synchronize()
                tag = f"{name} {mode} {label} product"
                require(kern.product_launches == before + 1,
                        f"{tag}: not counted")
                fin = torch.isfinite(wp)
                err = float((wk - wp)[fin].abs().max())
                require(same_w(wk, wp), f"{tag}: w not bit-exact")
                require(pw_rel(pk, pp) <= 1e-5 and not bool(tk)
                        and not bool(tp), f"{tag}: pw or trigger")
                prod_errs[key].append(err)
                print(f"{tag:52s} w max|err| {err:.1e}, pw rel "
                      f"{pw_rel(pk, pp):.1e}, trig {bool(tk)}")
                del mdp
    mpl = flat["powerlaw-graph"][1]["secded"]
    bpl = bvec_of(mpl)
    mdpl = make_matrix_device(mpl, f32, dev)
    live_pl = CudaBackend("secded")._solver(mpl, f32, 1000, CONV)(mdpl, bpl)
    for ci in (4, 32):
        lz = CudaBackend("secded")._solver(mpl, f32, 1000, CONV, False, ci)(
            mdpl, bpl)
        require(lz.iterations == live_pl.iterations
                and torch.equal(lz.x, live_pl.x),
                f"powerlaw lazy CI {ci}: {lz.iterations} it vs live "
                f"{live_pl.iterations}, x equal {torch.equal(lz.x, live_pl.x)}")
        print(f"powerlaw-graph -b 10 secded, per-iteration lazy CI {ci}: "
              f"{lz.iterations} it, x equal to the live solve's bit for bit")
    del mdpl

    # ---- 25. the solver options on the main paths --------------------------
    phase("25. solver options on the main paths: run_tests classes through "
          "main_csr -t cuda -b 10 --seed 11 with --check-interval 4, -p "
          "jacobi and both, a --refine 2 run; the other layouts' paths")
    base10 = ["-b", "10", "--seed", "11", "-t", "cuda"]
    path_counts = {}   # path label -> {instance: launches}

    def check_path(label, got, seconds, need):
        """Each instance in ``need`` must have launched on the path."""
        print(f"{label}: launches {got} ({seconds:.0f} s)")
        for k in need:
            require(got.get(k, 0) > 0, f"{k} was not launched on {label}")
        path_counts[label] = got

    def drive(label, runs, need):
        """Counts reset, the runs, counts read."""
        t0 = time.perf_counter()
        reset_launches()
        runs()
        check_path(label, launch_counts()[1], time.perf_counter() - t0,
                   need)

    for flags, need in ((["--check-interval", "4"], ["fused_cg_dia (lazy)"]),
                        (["-p", "jacobi"], ["fused_cg_dia (Jacobi)"]),
                        (["-p", "jacobi", "--check-interval", "4"],
                         ["fused_cg_dia (lazy Jacobi)"])):
        drive(f"DIA -b 10 {' '.join(flags)}",
              lambda f=flags: run_tests_classes(main_csr, [*base10, *f]),
              need)

    def refine_run():
        code, out = run_cli(main_csr, [*base10, "-m", "secded", "-x",
                                       "--refine", "2"])
        require(code == 0 and total_error(out) < 1.0,
                f"--refine 2: exit {code}")
        print(f"passed --refine 2 secded -x: exit 0, total error "
              f"{total_error(out):f}")

    drive("DIA -b 10 --refine 2", refine_run, ["fused_cg_dia (live)"])

    def b100_run():
        code, out = run_cli(main_csr, ["-b", "100", "--seed", "11", "-t",
                                       "cuda", "-m", "secded",
                                       "--check-interval", "32"])
        require(code == 0 and total_error(out) < 1.0,
                f"-b 100 --check-interval 32: exit {code}")
        print(f"passed -b 100 secded --check-interval 32: total error "
              f"{total_error(out):f}")

    drive("DIA -b 100", b100_run, ["fused_cg_dia (lazy)"])
    # the other layouts' paths, run in phase 12's workers
    for name, need in (
            ("dense-radius-3d", ["fused_cg_ell (lazy)",
                                 "fused_cg_ell (Jacobi)",
                                 "fused_cg_ell (lazy Jacobi)"]),
            ("arrowhead", ["fused_cg_dia (split tail lazy)",
                           "fused_cg_dia (split tail Jacobi)",
                           "fused_cg_dia (split tail lazy Jacobi)"]),
            ("powerlaw-graph", ["flat_spmv_detect (detection-free "
                                "product)"]),
            ("band+random-1pct", ["ell_spmv_detect (detection-free "
                                  "product)",
                                  "flat_spmv_detect (detection-free "
                                  "product)"])):
        job = cli_job(f"{name} -b 10 options")
        check_path(f"{name} -b 10", job["instances"], job["seconds"], need)

    # ---- 26. times of the solver options -----------------------------------
    phase(f"26. solver-option times on {card} (warm, build excluded): "
          "secded over none at CI 1 / 4 / 32, Jacobi over unpreconditioned")
    device_state(card)

    def options_table(label, mats_, batches, reps, none_bytes, sig_bytes):
        """Interleaved full and 2-iteration solves of each configuration:
        medians, spread, slope and its bandwidth (the bytes an average
        iteration must move: the signal plane every CI-th iteration, M^-1
        twice with Jacobi), each over none at CI 1."""
        configs = {"none": ("none", False, 1),
                   "secded CI 1": ("secded", False, 1),
                   "secded CI 4": ("secded", False, 4),
                   "secded CI 32": ("secded", False, 32),
                   "none Jacobi": ("none", True, 1),
                   "secded Jacobi": ("secded", True, 1)}
        fns, its = {}, {}
        for cname, (mode, precond, ci) in configs.items():
            mm = mats_[mode]
            mdd = make_matrix_device(mm, f32, dev)
            bb = bvec_of(mm)
            args = (minv_of(mm, like=mats_["secded"]),) if precond else ()
            for upto, suffix in ((1000, ""), (2, "@2")):
                solve = CudaBackend(mode)._solver(mm, f32, upto, CONV,
                                                  precond, ci)
                its[cname + suffix] = solve(mdd, bb, *args).iterations
                fns[cname + suffix] = (
                    lambda s=solve, m_=mdd, b_=bb, a_=args: s(m_, b_, *a_))
        t = interleave(fns, reps, batches)
        med = {n: statistics.median(v) for n, v in t.items()}
        R = mats_["none"].R
        out = {}
        for cname, (mode, precond, ci) in configs.items():
            slope = ((med[cname] - med[cname + "@2"])
                     / max(1, its[cname] - its[cname + "@2"]))
            nb = (none_bytes + (sig_bytes / ci if mode != "none" else 0)
                  + (8 * R if precond else 0))
            gbs = nb / (slope * 1e-3) / 1e9 if slope > 0 else float("nan")
            out[cname] = (med[cname], its[cname], slope)
            print(f"{label} {cname:14s}: {spread(t[cname])}, {its[cname]} it;"
                  f" slope {slope:.4f} ms/it = {gbs:.0f} GB/s "
                  f"({gbs / 3350 * 100:.1f}% of 3.35 TB/s; {nb / 1e6:.1f} "
                  f"MB/it); over none {(med[cname] / med['none'] - 1) * 100:+.1f}%"
                  f" [{card}]")
        print(f"{label} Jacobi over unpreconditioned: none "
              f"{(med['none Jacobi'] / med['none'] - 1) * 100:+.1f}%, secded "
              f"{(med['secded Jacobi'] / med['secded CI 1'] - 1) * 100:+.1f}% "
              f"(iterations {its['none Jacobi']} vs {its['none']}) [{card}]")
        return out

    def dia_sig(mm):
        return 4 * len(mm.dia_offsets) * mm.R

    def ell_sig(mm):
        return 4 * mm.K * mm.R + mm.R // 2

    def flat_sig(mm):
        return 4 * mm.exec_size + mm.exec_size // 2

    opt_times = {}
    for label, mats_, batches, reps, nb_fn, sig_fn in (
            ("DIA -b 10", mats, 3, 10, dia_iter_bytes, dia_sig),
            ("DIA -b 100", mats100, 3, 3, dia_iter_bytes, dia_sig),
            ("dense-radius-3d -b 10", ell, 3, 3, ell_iter_bytes, ell_sig),
            ("powerlaw-graph -b 10", flat["powerlaw-graph"][1], 3, 2,
             flat_iter_bytes, flat_sig)):
        opt_times[label] = options_table(
            label, mats_, batches, reps, nb_fn("none", mats_["none"]),
            sig_fn(mats_["secded"]))

    def lazy_bytes(k, ci, none_b, sig_b, R, precond):
        """Bytes a lazy solve of k iterations must move: k iterations
        without signals, the signal plane on the checked ones and in the
        exit pass, the snapshot (seeded from the entry state, refreshed
        on every checked iteration), M^-1 twice per Jacobi iteration."""
        checked = [i for i in range(k) if i % ci == ci - 1]
        exit_pass = bool(k) and (not checked or checked[-1] + 1 != k)
        nbytes = (k * none_b + (len(checked) + exit_pass) * sig_b
                  + 4 * R * (6 + 3 * len(checked)))
        return nbytes + (8 * R * k if precond else 0)

    def instance_row(label, name, source, replaces, kernel, plain, mm, spec_,
                     mdv, bv, mi, ci, none_b, sig_b, flops_it, launches,
                     tail=None, reps=3, batches=5):
        """An instance's kernels-line row; kernel B's tail-free rows name
        the schedule the matrix runs."""
        tt = interleave({"plain": loop_fn(plain, mdv, spec_, bv, tail, mi,
                                          ci),
                         "kernel": loop_fn(kernel, mdv, spec_, bv, tail, mi,
                                           ci)}, reps, batches=batches)
        ms_, plain_ = (statistics.median(tt["kernel"]),
                       statistics.median(tt["plain"]))
        k = opt[label, name]["its"]
        nbytes = (lazy_bytes(k, ci, none_b, sig_b, mm.R, mi is not None)
                  if ci > 1 else k * (none_b + sig_b)
                  + (8 * mm.R * k if mi is not None else 0))
        bms, by = bound(nbytes, k * flops_it)
        print(f"{kernel.__name__} ({name}), {label} secded ({k} it): kernel "
              f"{spread(tt['kernel'])}; plain loop "
              f"{spread(tt['plain'])}; bound {bms:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB) = {bms / ms_ * 100:.1f}% of the bound"
              f" [{card}]")
        sched = (f" [{dia_schedule(spec_.offsets)}]"
                 if kernel is fused_cg_dia and tail is None else "")
        return {"name": f"{kernel.__name__} ({name}){sched}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": opt[label, name]["err"], "ms": ms_,
                "plain_ms": plain_, "bound_ms": bms, "bound_by": by,
                "library_ms": None}

    m = mats["secded"]
    mdv = make_matrix_device(m, f32, dev)
    D, R = len(m.dia_offsets), m.R
    none_b = dia_iter_bytes("none", m)
    for (name, precond, ci), path in zip(VARIANTS, (
            "--check-interval 4", "-p jacobi",
            "-p jacobi --check-interval 4")):
        kernels.append(instance_row(
            "DIA -b 10", name,
            "abft_sparse_cg_tpu_torch/csrc/fused_cg_dia.cu",
            "abft_sparse_cg_tpu/solver/fused.py:1248", fused_cg_dia,
            fused_cg_dia_plain, m, dia_spec(m, "secded"), mdv, bvec_of(m),
            minv_of(m) if precond else None, ci, none_b, dia_sig(m),
            2 * D * R + 10 * R,
            path_counts[f"DIA -b 10 {path}"][f"fused_cg_dia ({name})"]))
    del mdv
    m = mats100["secded"]
    for name, precond, ci in (("lazy, -b 100", False, 32),):
        kernels.append(instance_row(
            "DIA -b 100", name,
            "abft_sparse_cg_tpu_torch/csrc/fused_cg_dia.cu",
            "abft_sparse_cg_tpu/solver/fused.py:1931", fused_cg_dia,
            fused_cg_dia_plain, m, spec100, md100, b100,
            mi100 if precond else None, ci, dia_iter_bytes("none", m),
            dia_sig(m), 2 * 3 * m.R + 10 * m.R,
            path_counts["DIA -b 100"][
                f"fused_cg_dia ({name.split(',')[0]})"]))
    del md100
    m = ell["secded"]
    mdv = make_matrix_device(m, f32, dev)
    for name, precond, ci in VARIANTS:
        kernels.append(instance_row(
            "dense-radius-3d -b 10", name,
            "abft_sparse_cg_tpu_torch/csrc/fused_cg_ell.cu",
            "abft_sparse_cg_tpu/solver/fused.py:1248", fused_cg_ell,
            fused_cg_ell_plain, m, ell_spec(m, "secded"), mdv, bvec_of(m),
            minv_of(m) if precond else None, ci, ell_iter_bytes("none", m),
            ell_sig(m), 2 * m.nnz + 10 * m.R,
            path_counts["dense-radius-3d -b 10"][f"fused_cg_ell ({name})"],
            reps=1, batches=3))
    del mdv
    m = splits["arrowhead"][1]["secded"]
    mda = make_matrix_device(m, f32, dev)
    tl = (mda[1], tail_spec(m, "secded"))
    T_a, S_a = len(m.tail.dense_plan[0]), m.tail.dense_plan[2]
    for name, precond, ci in VARIANTS:
        kernels.append(instance_row(
            "arrowhead -b 10", f"split tail {name}",
            "abft_sparse_cg_tpu_torch/csrc/dia_common.cuh",
            "abft_sparse_cg_tpu/solver/fused.py:977", fused_cg_dia,
            fused_cg_dia_plain, m, dia_spec(m.main, "secded"), mda[0],
            bvec_of(m), minv_of(m) if precond else None, ci,
            split_iter_bytes("none", m),
            split_iter_bytes("secded", m) - split_iter_bytes("none", m),
            2 * len(m.dia_offsets) * m.R + 10 * m.R + 4 * T_a * S_a,
            path_counts["arrowhead -b 10"][
                f"fused_cg_dia (split tail {name})"], tail=tl))
    del mda
    # The detection-free products, per call against plain and A @ x.
    # Kernel A's is on no main path (DIA matrices take kernel B, and the
    # zoo's splits have ELL mains or dense-plan tails): printed, not
    # listed.
    for key, label, mm, kern, plain, nbytes, flops, replaces in (
            ("dia_spmv_detect", "DIA -b 10 secded", mats["secded"], dia_fast,
             dia_fast_plain, 4 * (len(mats["secded"].dia_offsets) + 2)
             * mats["secded"].R, 2 * 3 * mats["secded"].R,
             "abft_sparse_cg_tpu/ops/spmv_pallas.py:519"),
            ("ell_spmv_detect", "dense-radius-3d -b 10 secded", ell["secded"],
             ell_fast, ell_fast_plain, 8 * ell["secded"].nnz
             + 12 * ell["secded"].R, 2 * ell["secded"].nnz,
             "abft_sparse_cg_tpu/ops/spmv_pallas.py:846"),
            ("flat_spmv_detect", "powerlaw-graph -b 10 secded",
             flat["powerlaw-graph"][1]["secded"], flat_fast, flat_fast_plain,
             flat_call_bytes("none", flat["powerlaw-graph"][1]["secded"]),
             2 * flat["powerlaw-graph"][1]["secded"].nnz,
             "abft_sparse_cg_tpu/ops/spmv_unstructured.py:447")):
        mdp = make_matrix_device(mm, f32, dev)
        xq = torch.zeros(mm.R, dtype=f32, device=dev)
        xq[: mm.N] = torch.tensor(np.random.default_rng(3).random(mm.N),
                                  dtype=f32)
        med, bms, by = kernel_times(kern, plain, mdp, product_spec(mm,
                                                                   "secded"),
                                    xq, f"{key} detection-free product, "
                                    f"{label}", nbytes, flops)
        del mdp
        if key == "dia_spmv_detect":
            continue
        kernels.append(
            {"name": f"{key} (detection-free product)", "route": "cuda",
             "source": f"abft_sparse_cg_tpu_torch/csrc/{key}.cu",
             "replaces": replaces,
             "launches": sum(c.get(f"{key} (detection-free product)", 0)
                             for c in path_counts.values()),
             "max_abs_err": max(prod_errs[key]), "ms": med["kernel"],
             "plain_ms": med["plain"], "bound_ms": bms, "bound_by": by,
             "library_ms": med["A @ x"]})
    # ---- 27. kernels A and C per shard: the halo forms ----------------------
    phase("27. kernels A and C per shard (halo forms) vs their plain "
          "versions and the single-device kernels: 4 shards on one card, "
          "DIA -b 10 and dense-radius-3d -b 10 (row_align 4096), every "
          "mode, clean and a fault in a halo row")
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded, default_mesh, make_sharded_solver, shard_rows,
        solve_sharded)
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo, halo_exchange, make_shardmap_spmv, supports_shardmap)
    from abft_sparse_cg_tpu_torch.parallel.vector import ShardedVector

    NS = 4
    mesh = default_mesh(NS, dev)
    halo_errs = {"dia": [], "ell": []}
    halo_of = {}

    def halo_row_fault(mm, word="col"):
        """``mm`` with bit 2 of ``word`` flipped in the last row of shard
        1, the first row of shard 2's left halo (every detecting mode
        covers the col word, constraints on COO128 the row word too; in
        the ECC modes the gather masks the col word)."""
        row = 2 * (mm.R // NS) - 1
        slot = int(np.flatnonzero(mm.ell_slot % mm.R == row)[0])
        planes = {k: v.copy() for k, v in mm.planes.items()}
        planes[word][slot] ^= np.uint32(1 << 2)
        return mm.with_planes(planes)

    def halo_case(layout, m0, mode, word, errs):
        """The halo form of kernel A or C on 4 shards of ``m0``, clean and
        with ``halo_row_fault(m0, word)``: w bit-exact to the plain
        versions and, concatenated, to the single-device kernel's; the
        trigger on the faulted row's shard only."""
        require(supports_shardmap(m0, f32, NS),
                f"{layout} {mode}: in the kernel tier's envelope")
        H, R_loc = _halo(m0), m0.R // NS
        halo_of[layout] = (H, R_loc)
        spec = (dia_spec if layout == "dia" else ell_spec)(m0, mode)
        single = dia_fast if layout == "dia" else ell_fast
        kern = dia_fast_halo if layout == "dia" else ell_fast_halo
        plain = dia_fast_plain if layout == "dia" else ell_fast_plain
        xs = torch.tensor(np.random.default_rng(3).standard_normal(m0.R),
                          dtype=f32, device=dev)
        ext = halo_exchange(ShardedVector.scatter(xs, mesh.devices), H)
        variants = [("clean", m0)]
        if mode != "none":
            variants.append(("halo-row fault", halo_row_fault(m0, word)))
        for label, mm in variants:
            mdh = make_matrix_device(mm, f32, dev)
            shards = shard_rows(mdh, mesh)
            ws, fired = [], []
            for s in range(NS):
                args = (H,) if layout == "dia" else (H, s * R_loc)
                wk, tk, pk = kern(shards[s], ext[s], spec, *args)
                wp, tp, pp = plain(shards[s], ext[s], spec, *args)
                torch.cuda.synchronize()
                tag = f"{layout} {mode} {label} shard {s}"
                require(same_w(wk, wp), f"{tag}: w not bit-exact")
                require(bool(tk) == bool(tp), f"{tag}: trig {bool(tk)} "
                        f"vs plain {bool(tp)}")
                prel = pw_rel(pk, pp)
                require(prel <= 1e-5, f"{tag}: pw rel err {prel:.2e}")
                fin = torch.isfinite(wp)
                errs.append(float((wk - wp)[fin].abs().max()))
                ws.append(wk)
                fired.append(bool(tk))
            w1, t1, _ = single(mdh, xs, spec)
            torch.cuda.synchronize()
            require(same_w(torch.cat(ws), w1),
                    f"{layout} {mode} {label}: the shards' w differs "
                    "from the single-device kernel's")
            want = ([False] * NS if label == "clean"
                    else [False, True, False, False])
            require(fired == want and bool(t1) == any(want),
                    f"{layout} {mode} {label}: shard triggers {fired}, "
                    f"single-device {bool(t1)}")
            print(f"{layout} {m0.fmt} {mode:11s} {label:14s} (H {H}, "
                  f"R_loc {R_loc}): 4 shards bit-exact to plain and, "
                  f"concatenated, to the single-device kernel; "
                  f"triggers {fired}")
            del mdh, shards

    for layout, per in (("dia", mats), ("ell", ell)):
        for mode in MODES:
            halo_case(layout, per[mode], mode, "col", halo_errs[layout])

    # ---- 28. the sharded main path ---------------------------------------
    phase("28. the sharded main path on a 4-shard mesh of one card: "
          "solve_sharded, and make_shardmap_spmv under make_cg_solver / "
          "make_lazy_ci_solver, vs the single-device cuda solve and the "
          "f64 oracle; launch counts reset before and read after")

    def cg_host(res):
        """A sharded CGResult as trajectory() reads a HostResult."""
        return types.SimpleNamespace(rr_trace=res.rr_trace.cpu().numpy(),
                                     iterations=res.iterations,
                                     failed=res.stats.errcode != 0)

    def sharded_case(label, mm, b_, conv=1e-6, ci=1, precond=False,
                     oracle=None):
        """One sharded solve of ``mm`` through the kernel tier against the
        single-device cuda solve (iterations within max(1, n / 20), x
        within 1e-4 relative) and the f64 oracle's trajectory bound."""
        require(supports_shardmap(mm, f32, NS), f"{label}: envelope")
        mdsh, bsh, put = _device_put_sharded(mm, b_, mesh, f32)
        minv = put(jacobi_minv(mm, "jacobi")) if precond else None
        if ci == 1 and not precond:
            res = solve_sharded(mm, b_, 500, conv, mesh=mesh)
        else:
            res = make_sharded_solver(mm, mesh, 500, conv, f32,
                                      check_interval=ci)(mdsh, bsh, minv)
        one = CudaBackend(mm.mode).solve(
            mm, b_, 500, conv, dtype="f32", reps=1,
            precond="jacobi" if precond else "none")
        require(res.stats.errcode == 0 and not one.failed,
                f"{label}: sharded stats {tuple(res.stats)}, single "
                f"errcode {one.errcode}")
        require(abs(res.iterations - one.iterations)
                <= max(1, one.iterations // 20),
                f"{label}: {res.iterations} vs {one.iterations} iterations")
        xs_ = mm.from_exec_order(res.x.cpu().numpy()[: mm.N])
        xrel = float(np.abs(xs_ - one.x).max() / np.abs(one.x).max())
        require(xrel <= 1e-4, f"{label}: x {xrel:.2e} from the single-"
                "device solve")
        print(f"{label}: sharded {res.iterations} it, stats "
              f"{tuple(res.stats)}; single-device {one.iterations} it; x "
              f"within {xrel:.2e} (rel)")
        if res.stats.corrected_count == 0 and oracle is not False:
            trajectory(mm, b_, f"{label} (sharded)", oracle_mat=oracle,
                       oracle_dev=dev, conv=conv, res=cg_host(res),
                       precond=precond)
        return res

    for fn in (dia_fast_halo, ell_fast_halo):
        fn.launches = fn.product_launches = 0
    mdia, mell = mats["secded"], ell["secded"]
    marrow = splits["arrowhead"][1]["secded"]
    b_dia = np.random.default_rng(11).random(mdia.N)
    b_ell = np.random.default_rng(11).random(mell.N)
    b_arr = np.random.default_rng(11).random(marrow.N)
    live_dia = sharded_case("DIA -b 10 secded", mdia, b_dia)
    fixed = sharded_case("DIA -b 10 secded, a fault in a halo row",
                         halo_row_fault(mdia), b_dia)
    require(fixed.stats.corrected_count == 1
            and torch.equal(fixed.x, live_dia.x),
            "DIA halo-row fault: corrected once, x equal to the clean solve")
    r_loc = mdia.R // NS
    require(isinstance(fixed.x, ShardedVector)
            and [tuple(p.shape) for p in fixed.x.parts] == [(r_loc,)] * NS
            and all(t.shape[-1] in (r_loc, r_loc // 8)
                    for sh in fixed.md.shards
                    for t in (*sh.words, sh.cksum, sh.values, sh.fold,
                              sh.fold_ck)),
            "DIA halo-row fault: x and the repaired planes are per-shard "
            f"tensors of {r_loc} rows")
    print(f"after the repair: x and every plane of the returned matrix "
          f"are per-shard tensors of {r_loc} rows (checksums {r_loc // 8})")
    lazy = sharded_case("DIA -b 10 secded, lazy CI 4", mdia, b_dia, ci=4)
    require(torch.equal(lazy.x, live_dia.x),
            "DIA lazy CI 4: x differs from the live sharded solve")
    sharded_case("DIA -b 10 scaled diagonal secded, Jacobi", mv,
                 np.random.default_rng(11).random(mv.N), precond=True)
    live_ell = sharded_case("dense-radius-3d -b 10 secded", mell, b_ell,
                            oracle=ell["none"])
    lazy = sharded_case("dense-radius-3d -b 10 secded, lazy CI 4", mell,
                        b_ell, ci=4, oracle=False)
    require(torch.equal(lazy.x, live_ell.x),
            "ELL lazy CI 4: x differs from the live sharded solve")
    sharded_case("arrowhead -b 10 secded", marrow, b_arr)
    arr_fault = inject_bitflips(marrow, "ANY", 1, np.random.default_rng(12),
                                echo=lambda s: None)
    r_arr = sharded_case("arrowhead -b 10 secded, injected", arr_fault,
                         b_arr)
    require(r_arr.stats.corrected_count == 1,
            "arrowhead injected: one correction")
    halo_launches = {"dia_spmv_detect (halo)": dia_fast_halo.launches,
                     "ell_spmv_detect (halo)": ell_fast_halo.launches}
    for name, n in halo_launches.items():
        print(f"{name}: {n} launches")
        require(n > 0, f"{name} was not launched on the sharded path")

    # ---- 29. sharded times -------------------------------------------------
    phase(f"29. sharded times on {card}: per sharded SpMV (4 shards and "
          "the exchange) and per shard call against the single-device "
          "kernels and A @ x; sharded solves against kernel B and the "
          "per-iteration tier")
    device_state(card)
    halo_rows = []
    for layout, mm in (("dia", mdia), ("ell", mell)):
        H, R_loc = halo_of[layout]
        spec = (dia_spec if layout == "dia" else ell_spec)(mm, "secded")
        mdsh, xsh, _ = _device_put_sharded(
            mm, np.random.default_rng(3).random(mm.N), mesh, f32)
        # the single-device kernel's and A @ x's operands, whole
        md_one, x_one = make_matrix_device(mm, f32, dev), xsh.gather(dev)
        sh = make_shardmap_spmv(mm, mesh).fast_pw
        one = make_cuda_spmv(mm, f32, "secded").fast_pw
        a_csr, _ = csr_yardstick(md_one, spec)
        xcol = x_one[:, None]
        t = interleave({"sharded": lambda: sh(mdsh, xsh),
                        "single": lambda: one(md_one, x_one),
                        "A @ x": lambda: a_csr @ xcol}, 20, batches=5,
                       timer=event_ms)
        med = {n: statistics.median(v) for n, v in t.items()}
        print(f"{layout} secded -b 10, per SpMV (CUDA events): sharded "
              f"{spread(t['sharded'])}; single-device kernel "
              f"{spread(t['single'])}; A @ x {spread(t['A @ x'])} [{card}]")
        # One shard's call (shard 1: halos on both sides).
        md1 = mdsh.shards[1]
        ext1 = halo_exchange(xsh, H)[1]
        args = (H,) if layout == "dia" else (H, R_loc)
        if layout == "dia":
            call = dia_launcher(md1, spec, dev, H)
            kern = (lambda: call(ext1))
            plainf = (lambda: dia_fast_plain(md1, ext1, spec, H))
            D = len(mm.dia_offsets)
            nbytes = 4 * (2 * D * R_loc + 2 * R_loc + R_loc // 8) + 8 * H
            flops = 2 * D * R_loc
        else:
            call = ell_launcher(md1, spec, dev, H, R_loc)
            kern = (lambda: call(ext1))
            plainf = (lambda: ell_fast_plain(md1, ext1, spec, H, R_loc))
            nnz1 = int(md1.ell_len.sum())
            nbytes = (8 * nnz1 + 4 * mm.K * R_loc + R_loc // 2 + 4 * R_loc
                      + 8 * R_loc + 8 * H)
            flops = 2 * nnz1
        s_csr = shard_yardstick(md1, spec, H, R_loc)
        ecol = ext1[:, None]
        ts = interleave({"kernel": kern, "plain": plainf,
                         "A @ x": lambda: s_csr @ ecol}, 20, batches=5,
                        timer=event_ms)
        meds = {n: statistics.median(v) for n, v in ts.items()}
        bms, by = bound(nbytes, flops)
        print(f"{layout} halo kernel, shard 1 of 4 (R_loc {R_loc}, H {H}), "
              f"per call: kernel {spread(ts['kernel'])}; plain "
              f"{spread(ts['plain'])}; the shard's A @ x_ext "
              f"{spread(ts['A @ x'])}; bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.2f} MB) = {bms / meds['kernel'] * 100:.1f}% "
              f"of the bound [{card}]")
        name = f"{'dia' if layout == 'dia' else 'ell'}_spmv_detect (halo)"
        halo_rows.append(
            {"name": name, "route": "cuda",
             "source": f"abft_sparse_cg_tpu_torch/csrc/"
                       f"{'dia' if layout == 'dia' else 'ell'}"
                       f"_spmv_detect.cu",
             "replaces": ("abft_sparse_cg_tpu/ops/spmv_pallas.py:519"
                          if layout == "dia" else
                          "abft_sparse_cg_tpu/ops/spmv_pallas.py:846"),
             "launches": halo_launches[name],
             "max_abs_err": max(halo_errs[layout]), "ms": meds["kernel"],
             "plain_ms": meds["plain"], "bound_ms": bms, "bound_by": by,
             "library_ms": meds["A @ x"]})
        del mdsh, sh, a_csr, md_one, x_one
    kernels += halo_rows

    def solve_fns(mm):
        """Warm solves of ``mm`` secded: the sharded kernel tier (4
        shards), the cuda target's single-device tier (kernel B) and the
        per-iteration tier over kernel A."""
        b_ = np.random.default_rng(11).random(mm.N)
        mdsh, bsh, _ = _device_put_sharded(mm, b_, mesh, f32)
        md_one, b_one = make_matrix_device(mm, f32, dev), bsh.gather(dev)
        sh = make_sharded_solver(mm, mesh, 1000, CONV, f32)
        whole = CudaBackend("secded")._solver(mm, f32, 1000, CONV)
        per_it = make_cg_solver(make_cuda_spmv(mm, f32, "secded"), 1000,
                                CONV)
        its = {"sharded": sh(mdsh, bsh).iterations,
               "kernel B": whole(md_one, b_one).iterations,
               "per-iteration": per_it(md_one, b_one).iterations}
        return ({"sharded": lambda: sh(mdsh, bsh),
                 "kernel B": lambda: whole(md_one, b_one),
                 "per-iteration": lambda: per_it(md_one, b_one)}, its)

    for label, mm, reps, batches in (("DIA -b 10", mdia, 5, 5),
                                     ("DIA -b 100", mats100["secded"], 2,
                                      3)):
        fns, its = solve_fns(mm)
        t = interleave(fns, reps, batches)
        print(f"{label} secded solves (host clock, iterations "
              f"{its}): " + "; ".join(f"{n} {spread(v)}"
                                      for n, v in t.items())
              + f" [{card}]")
        del fns

    # ---- 30. powerlaw-graph -b 100 (HBM-bound), if its build is quick ------
    phase("30. powerlaw-graph -b 100, none and secded")
    if time.perf_counter() - t_start > 540:
        print("skipped: the run is past 540 s (the 1200 s limit)")
    else:
        t0 = time.perf_counter()
        a100 = zoo_assembled("powerlaw-graph", 100)
        p100 = {"none": build_protected("csr", a100, "none")}
        t_build = time.perf_counter() - t0
        print(f"host build -b 100 none: {t_build:.1f} s (N {a100.N}, nnz "
              f"{a100.nnz}, {p100['none'].exec_kind})")
        if t_build < 60 and p100["none"].exec_kind == "flat":
            p100["secded"] = build_protected("csr", a100, "secded")
            solve_table(f"powerlaw-graph -b 100 (N={a100.N})", p100, 3, 2,
                        flat_iter_bytes)
        else:
            print("timings skipped: the build takes a minute or more, or "
                  "does not route flat")
        del a100, p100

    # ---- 31. profile (last: the profiler may disturb later timings) --------
    phase(f"31. torch.profiler windows over warm calls and solves on {card}, "
          "each group in a fresh worker process")
    device_state(card)
    # dia100 builds the bundled matrix at -b 100 itself (its planes would
    # make a pickle of several hundred MB)
    for group, mm in (("dia", mats["secded"]), ("ell", ell["secded"]),
                      ("split", splits["arrowhead"][1]["secded"]),
                      ("dia100", None)):
        profile_group(group, mm, card)
    # ---- 32. cg-coo: kernels A, C and E on COO128 planes --------------------
    phase("32. cg-coo: kernels A, C and E and the halo forms of A and C vs "
          "their plain versions on COO128 planes, every mode")
    from abft_sparse_cg_tpu_torch.cli import main_coo
    from abft_sparse_cg_tpu_torch.utils.coo_faults import (
        col_row_fault, row_word_flip)

    t0 = time.perf_counter()
    coo = parallel_builds(a10, MODES, fmt="coo")
    coo_ell = parallel_builds(zoo_assembled("dense-radius-3d", 1), MODES,
                              fmt="coo", row_align=4096)
    coo_flat = parallel_builds(zoo_assembled("powerlaw-graph", 1), MODES,
                               fmt="coo")
    for name, per, want in (("DIA -b 10", coo, "dia"),
                            ("dense-radius-3d -b 1", coo_ell, "ell"),
                            ("powerlaw-graph -b 1", coo_flat, "flat")):
        for mode in MODES:
            mm = per[mode]
            require(mm.fmt == "coo" and mm.exec_kind == want,
                    f"COO {name} {mode}: routes {mm.exec_kind}, not {want}")
        sp = fast_spec(per["constraints"], "constraints")
        names = per["constraints"].layout.word_names
        require((names[sp.plane], names[sp.plane2]) == ("col", "row"),
                f"COO {name} constraints: streams {sp.plane}, {sp.plane2}")
    print(f"COO128 builds, every mode: DIA -b 10 (R {coo['none'].R}), "
          f"dense-radius-3d -b 1 (ELL, K {coo_ell['none'].K}, R "
          f"{coo_ell['none'].R} at row_align 4096), powerlaw-graph -b 1 "
          f"(flat, E {coo_flat['none'].exec_size}) in "
          f"{time.perf_counter() - t0:.1f} s; constraints streams the col "
          "and the row word, each against its own baseline")

    def coo_variants(m, mode):
        """(label, faulted copy) of a COO matrix: random 1- and 2-bit
        faults (ECC modes) or an INDEX flip, a row-word flip (only the
        second plane sees it in constraints) and, in none and
        constraints, the 4-bit col/row fault (utils/coo_faults.py: its
        rotated fold is zero, so the ECC modes' fold cannot see it)."""
        out = [("clean", m)]
        quiet = dict(echo=lambda s: None)
        if mode in ECC:
            out += [(f"{k}-bit", inject_bitflips(
                m, "ANY", k, np.random.default_rng(20 + k), **quiet))
                for k in (1, 2)]
        else:
            out.append(("index", inject_bitflips(
                m, "INDEX", 1, np.random.default_rng(23), **quiet)))
            out.append(("4-bit col/row", col_row_fault(m, m.nnz // 3)))
        out.append(("row word", row_word_flip(m, m.nnz // 3 + 1)))
        return out

    def coo_want(mode, label, m, mm):
        """The trigger the mode's signals must give: any change with a
        checksum arm, odd-weight changes for parity alone, a change of
        either index word in constraints."""
        changed = {n: not np.array_equal(mm.ell[n], m.ell[n])
                   for n in m.layout.word_names}
        if mode == "none":
            return False
        if mode == "constraints":
            return changed["col"] or changed["row"]
        if mode in ("sed", "sec8"):
            return label not in ("2-bit", "4-bit col/row") and any(
                changed.values())
        return any(changed.values())

    def coo_kernel_case(kernel, plain, md_, x_, spec_, tag, want, errs):
        wk, tk, pk = kernel(md_, x_, spec_)
        wp, tp, pp = plain(md_, x_, spec_)
        torch.cuda.synchronize()
        require(same_w(wk, wp), f"{tag}: w not bit-exact")
        prel = pw_rel(pk, pp)
        require(prel <= 1e-5, f"{tag}: pw rel err {prel:.2e} > 1e-5")
        require(bool(tk) == bool(tp) == want, f"{tag}: trig {bool(tk)}, "
                f"plain {bool(tp)}, expected {want}")
        fin = torch.isfinite(wp)
        err = float((wk - wp)[fin].abs().max())
        errs.append(err)
        print(f"{tag:48s} w bit-exact (max|err| {err:.1e}), pw rel "
              f"{prel:.1e}, trig {bool(tk)}")

    coo_errs = {"A": [], "C": [], "E": [], "halo": []}
    for key, per, kernel, plain, spec_of in (
            ("A", coo, dia_fast, dia_fast_plain, dia_spec),
            ("C", coo_ell, ell_fast, ell_fast_plain, ell_spec),
            ("E", coo_flat, flat_fast, flat_fast_plain, flat_spec)):
        for mode in MODES:
            m = per[mode]
            spec = spec_of(m, mode)
            xk = torch.zeros(m.R, dtype=f32, device=dev)
            xk[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                     dtype=f32)
            for label, mm in coo_variants(m, mode):
                mdk = make_matrix_device(mm, f32, dev)
                coo_kernel_case(kernel, plain, mdk, xk, spec,
                                f"{key} COO {mode} {label}",
                                coo_want(mode, label, m, mm), coo_errs[key])
                del mdk
    # Kernels C and E on COO constraints at the shapes phase 37 times:
    # dense-radius-3d -b 10 (row_align 4096, as phase 9's CSR build: on
    # the two-plane grid each block walks several 128-row tiles) and
    # powerlaw-graph -b 10.
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        f_c = ex.submit(build_protected, "coo", a_ell, "constraints",
                        row_align=4096)
        f_e = ex.submit(build_protected, "coo", flat["powerlaw-graph"][0],
                        "constraints")
        coo_c10, coo_e10 = f_c.result(), f_e.result()
    per_block = coo_c10.R / ell_grid(coo_c10.R, occ[0, 2][1], occ[0, 2][0])
    require(coo_c10.exec_kind == "ell" and coo_e10.exec_kind == "flat"
            and per_block > 2 * 128,
            f"COO dense-radius-3d -b 10: {coo_c10.exec_kind}, "
            f"{per_block:.0f} rows per block; powerlaw-graph -b 10: "
            f"{coo_e10.exec_kind}")
    print(f"COO128 constraints builds at -b 10 in "
          f"{time.perf_counter() - t0:.1f} s: dense-radius-3d (K "
          f"{coo_c10.K}, R {coo_c10.R}: {per_block:.0f} rows per block of "
          f"kernel C's two-plane grid, tiles of 128), powerlaw-graph (E "
          f"{coo_e10.exec_size})")
    for key, m, kernel, plain, spec_of, name in (
            ("C -b 10", coo_c10, ell_fast, ell_fast_plain, ell_spec,
             "dense-radius-3d"),
            ("E -b 10", coo_e10, flat_fast, flat_fast_plain, flat_spec,
             "powerlaw-graph")):
        coo_errs[key] = []
        spec = spec_of(m, "constraints")
        xk = torch.zeros(m.R, dtype=f32, device=dev)
        xk[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                 dtype=f32)
        for label, mm in coo_variants(m, "constraints"):
            mdk = make_matrix_device(mm, f32, dev)
            coo_kernel_case(kernel, plain, mdk, xk, spec,
                            f"{key[0]} COO constraints {name} -b 10 {label}",
                            coo_want("constraints", label, m, mm),
                            coo_errs[key])
            del mdk

    # The halo forms on 4 shards of the card: a row-word fault in the last
    # row of shard 1 (the first row of shard 2's left halo).
    for layout, per in (("dia", coo), ("ell", coo_ell)):
        for mode in MODES:
            halo_case(layout, per[mode], mode, "row", coo_errs["halo"])

    # ---- 33. cg-coo: kernels B and D on COO128 ------------------------------
    phase("33. cg-coo: kernels B and D (live, lazy CI 4, Jacobi) and B's "
          "split tail vs their plain loops on COO128, secded and "
          "constraints, clean and faulted")
    coo_arrow = parallel_builds(zoo_assembled("arrowhead", 1),
                                ("secded", "constraints"), fmt="coo")
    require(all(mm.exec_kind == "split" and mm.main.exec_kind == "dia"
                and mm.tail.dense_plan is not None
                for mm in coo_arrow.values()),
            "COO arrowhead -b 1: a bordered split with a dense plan")

    def check_failstop(m1, mode, name, label, precond, ci, clean):
        """A constraints fault through kernel B or D (the solver's classify
        after the trigger): the same fail-stop, iterations and events as
        the plain loop on CPU tensors."""
        solve = make_fused_solver(m1, mode, 1000, CONV, precond=precond,
                                  check_interval=ci)
        args = (minv_of(m1, like=clean),) if precond else ()
        rk = solve(make_matrix_device(m1, f32, dev), bvec_of(m1), *args)
        cargs = (minv_of(m1, "cpu", like=clean),) if precond else ()
        rp = solve(make_matrix_device(m1, f32, torch.device("cpu")),
                   bvec_of(m1, "cpu"), *cargs)
        require(rk.stats.errcode != 0 and rk.iterations == rp.iterations
                and tuple(rk.stats) == tuple(rp.stats),
                f"{label} {name}: kernel {rk.iterations} it "
                f"{tuple(rk.stats)}, plain {rp.iterations} it "
                f"{tuple(rp.stats)}")
        print(f"{label} {name}: fail-stop after {rk.iterations} it, stats "
              f"{tuple(rk.stats)}, the plain loop's")

    coo_solve_err = {}
    for label, per, kernel, plain in (
            ("COO DIA -b 10", coo, fused_cg_dia, fused_cg_dia_plain),
            ("COO dense-radius-3d -b 1", coo_ell, fused_cg_ell,
             fused_cg_ell_plain),
            ("COO arrowhead -b 1", coo_arrow, fused_cg_dia,
             fused_cg_dia_plain)):
        for mode in ("secded", "constraints"):
            mm = per[mode]
            split = mm.exec_kind == "split"
            mdv = make_matrix_device(mm, f32, dev)
            tl = None
            if split:
                mdv, tl = mdv[0], (mdv[1], tail_spec(mm, mode))
            spec_v = fast_spec(mm.main if split else mm, mode)
            bv, mi = bvec_of(mm), minv_of(mm)
            faults = ([("1-bit", inject_bitflips(
                mm, "ANY", 1, np.random.default_rng(12),
                echo=lambda s: None))] if mode == "secded" else
                [("row word", row_word_flip(mm, mm.nnz // 3 + 1)),
                 ("4-bit col/row", col_row_fault(mm, mm.nnz // 3))])
            for vname, precond, ci in (("live", False, 1), *VARIANTS):
                name = ("split tail " if split else "") + f"{mode} {vname}"
                xk = check_variant(kernel, plain, mdv, spec_v, bv, name,
                                   label, mi if precond else None, ci, tl)
                coo_solve_err[label, mode] = max(
                    coo_solve_err.get((label, mode), 0.0),
                    opt[label, name]["err"])
                for fname, m1 in faults:
                    if mode == "secded":
                        check_faulted_variant(m1, mode, name, label,
                                              precond, ci, xk,
                                              vname == "lazy Jacobi", mm)
                    else:
                        check_failstop(m1, mode, f"{name} {fname}", label,
                                       precond, ci, mm)
            del mdv

    # ---- 34. cg-coo: the main path -----------------------------------------
    phase("34. cg-coo main path: run_tests classes, cg-coo -t cuda -b 10 "
          "--seed 11 (main_coo: what bin/cg-coo-torch runs)")
    reset_launches()
    coo_base = ["-b", "10", "--seed", "11", "-t", "cuda"]
    run_tests_classes(main_coo, coo_base)
    for flags in (["-x", "INDEX"], ["-x", "4", "INDEX"]):
        code, out = run_cli(main_coo, [*coo_base, "-m", "constraints",
                                       *flags])
        require(code == 1 and "violated" in out,
                f"constraints {' '.join(flags)}: exit {code}")
        print(f"passed constraints {' '.join(flags)}: exit 1 "
              f"({[ln for ln in out.splitlines() if 'violated' in ln]})")
    coo_launches = {
        "dia_spmv_detect": dia_fast.launches,
        "dia_spmv_detect (two planes)": dia_fast.two_plane_launches,
        "fused_cg_dia": fused_cg_dia.launches,
        "fused_cg_dia (two planes)": fused_cg_dia.instances.get(
            "live two-plane", 0)}
    print(f"cg-coo -b 10 launches: {coo_launches}; kernel B by instance "
          f"{dict(fused_cg_dia.instances)}")
    for name, n in coo_launches.items():
        require(n > 0, f"{name} was not launched on the cg-coo main path")

    # ---- 35. cg-coo: one run per other layout ------------------------------
    phase("35. cg-coo on the other layouts: a secded -x and a constraints "
          "-x INDEX run each, -t cuda --seed 11, at the smallest -b that "
          "keeps the zoo file's route")
    from abft_sparse_cg_tpu_torch import formats as fmts

    def route(mm):
        if mm.exec_kind == "split":
            return (f"split {mm.main.exec_kind}+{mm.tail.exec_kind}"
                    + (" (dense plan)" if mm.tail.dense_plan is not None
                       else ""))
        return mm.exec_kind + (" (RCM)" if mm.perm is not None else "")

    # The route each CLI run built, read off its own build (cli._main
    # imports build_protected from formats at call time): no second build
    # of each file.
    built, build0 = [], fmts.build_protected

    def recording_build(*a, **k):
        built.append(build0(*a, **k))
        return built[-1]

    fmts.build_protected = recording_build
    coo_paths = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        st.callback(setattr, fmts, "build_protected", build0)
        for name, blocks, want, need in (
                ("dense-radius-3d", 1, "ell", ("fused_cg_ell",)),
                ("stencil27-shuffled", 5, "ell (RCM)", ("fused_cg_ell",)),
                ("powerlaw-graph", 1, "flat", ("flat_spmv_detect",)),
                ("band+random-1pct", 1, "split ell+flat",
                 ("ell_spmv_detect", "flat_spmv_detect")),
                ("arrowhead", 1, "split dia+flat (dense plan)",
                 ("fused_cg_dia (split tail)",))):
            path = os.path.join(tmp, f"{name}.mtx")
            write_mm_triangle(path, *ZOO[name][0]())
            t0 = time.perf_counter()
            got, routes = {}, {}
            for flags, ok_code in ((["-m", "secded", "-x"], 0),
                                   (["-m", "constraints", "-x", "INDEX"],
                                    1)):
                reset_launches()
                code, out = run_cli(main_coo, ["-f", path, "-b",
                                               str(blocks), "--seed", "11",
                                               "-t", "cuda", *flags])
                tag = " ".join(flags[1:])
                mode = flags[1]
                require(len(built) > 0 and built[-1].fmt == "coo",
                        f"{name} {tag}: no COO build recorded")
                routes[mode] = route(built[-1])
                built.clear()
                require(code == ok_code, f"{name} {tag}: exit {code}")
                require(("[ECC] corrected" in out) if ok_code == 0
                        else ("violated" in out), f"{name} {tag}: output")
                got[mode] = {
                    "dia_spmv_detect": dia_fast.launches,
                    "ell_spmv_detect": ell_fast.launches,
                    "flat_spmv_detect": flat_fast.launches,
                    "fused_cg_dia (split tail)": fused_cg_dia.tail_launches,
                    "fused_cg_ell": fused_cg_ell.launches,
                    "two-plane": (dia_fast.two_plane_launches
                                  + ell_fast.two_plane_launches
                                  + flat_fast.two_plane_launches
                                  + sum(n for k, n in
                                        (*fused_cg_dia.instances.items(),
                                         *fused_cg_ell.instances.items())
                                        if k.endswith("two-plane")))}
                print(f"  {tag}: exit {code}, launches {got[mode]}")
            print(f"  routes {routes}")
            require(routes["secded"] == want,
                    f"{name} -b {blocks} secded routes {routes['secded']}, "
                    f"not {want}")
            for k in need:
                require(got["secded"][k] > 0, f"{k} was not launched on "
                        f"the COO {name} secded path")
            require(got["constraints"]["two-plane"] > 0,
                    f"COO {name} constraints: no two-plane launch")
            coo_paths[name] = got
            print(f"  ({time.perf_counter() - t0:.0f} s)")

    # ---- 36. cg-coo: the sharded solve ------------------------------------
    phase("36. cg-coo: a 4-shard COO constraints solve on the card (halo "
          "forms of kernel A) vs the single-device solve")
    for fn in (dia_fast_halo, ell_fast_halo):
        fn.launches = fn.product_launches = fn.two_plane_launches = 0
    mcc = coo["constraints"]
    sharded_case("COO DIA -b 10 constraints", mcc,
                 np.random.default_rng(11).random(mcc.N))
    print(f"halo launches: kernel A {dia_fast_halo.launches} "
          f"({dia_fast_halo.two_plane_launches} two-plane)")
    require(dia_fast_halo.two_plane_launches > 0,
            "the sharded COO constraints solve ran no two-plane halo form")

    # ---- 37. cg-coo times -------------------------------------------------
    phase(f"37. cg-coo times on {card}: COO against CSR solves at -b 10 and "
          "-b 100 (secded, constraints), interleaved; kernels A, B, C, E on "
          "COO constraints per call")
    device_state(card)

    def sig_planes(mm, mode):
        """Signal planes one iteration streams: the fold (ECC modes), the
        col word (CSR constraints), col and row (COO constraints)."""
        spec_ = fast_spec(mm, mode)
        return sum(p is not None for p in (spec_.plane, spec_.plane2))

    def dia_coo_bytes(mode, mm):
        """Bytes of one DIA iteration: the value planes, the signal
        planes and the 8 vector streams (dia_iter_bytes, constraints
        included)."""
        D, R = len(mm.dia_offsets), mm.R
        return (4 * D * (1 + sig_planes(mm, mode)) + 8 * 4) * R

    def b_launch(mm, mode, upto):
        """One launch of kernel B from the initial state to ``upto``
        iterations (or convergence), and its iterations."""
        md_, spec_ = make_matrix_device(mm, f32, dev), dia_spec(mm, mode)
        s0 = init_state(bvec_of(mm), upto)
        tr = torch.full_like(s0.trace, float("nan"))

        def go():
            return fused_cg_dia(md_, spec_, s0.x.clone(), s0.r.clone(),
                                s0.p.clone(), s0.rr, s0.rz, 0, upto, CONV,
                                tr, None, None, 1)

        return go, go().itr

    def coo_table(label, table):
        """Interleaved solves of {name: (matrix, mode)}: the cuda target's
        whole solve on the host clock (median, spread), and kernel B's
        launch by CUDA events, full and to 2 iterations: the slope, its
        bytes and share of the bound; returns {name: (host median ms,
        iterations, slope, bytes per it)}."""
        fns, its, kfns, kits = {}, {}, {}, {}
        for name, (mm, mode) in table.items():
            fns[name], its[name] = solver_fn(mm, mode)
            kfns[name], kits[name] = b_launch(mm, mode, 1000)
            kfns[name + "@2"], _ = b_launch(mm, mode, 2)
        t = interleave(fns, 5, 5)
        tk = interleave(kfns, 5, 5, timer=event_ms)
        med = {n: statistics.median(v) for n, v in t.items()}
        kmed = {n: statistics.median(v) for n, v in tk.items()}
        out = {}
        for name, (mm, mode) in table.items():
            slope = (kmed[name] - kmed[name + "@2"]) / (kits[name] - 2)
            nbytes = dia_coo_bytes(mode, mm)
            bms = nbytes / HBM_BPS * 1e3
            print(f"{name:18s} solve {label}: {spread(t[name])}, "
                  f"{its[name]} it; kernel B {kmed[name]:.4f} ms (events), "
                  f"slope {slope:.4f} ms/it, {nbytes / 1e6:.1f} MB/it, "
                  f"bound {bms:.4f} ms/it = {bms / slope * 100:.1f}% of "
                  f"the bound [{card}]")
            out[name] = (med[name], its[name], slope, nbytes)
        return out

    coo_t10 = coo_table("-b 10", {
        "CSR secded": (mats["secded"], "secded"),
        "COO secded": (coo["secded"], "secded"),
        "CSR constraints": (mats["constraints"], "constraints"),
        "COO constraints": (coo["constraints"], "constraints")})
    a100 = load_matrix(MATRIX, 100)
    coo100 = parallel_builds(a100, ("secded", "constraints"), fmt="coo")
    csr100c = build_protected("csr", a100, "constraints")
    del a100
    coo_t100 = coo_table("-b 100", {
        "CSR secded": (mats100["secded"], "secded"),
        "COO secded": (coo100["secded"], "secded"),
        "CSR constraints": (csr100c, "constraints"),
        "COO constraints": (coo100["constraints"], "constraints")})
    del coo100, csr100c, mats100

    # per call: kernel A and B (COO constraints -b 10 and COO secded -b 10),
    # C (dense-radius-3d -b 10) and E (powerlaw-graph -b 10), each beside
    # the same kernel on the CSR build of the matrix
    coo_rows = []
    mcc = coo["constraints"]
    D, R = len(mcc.dia_offsets), mcc.R
    mdk = make_matrix_device(mcc, f32, dev)
    xk = torch.zeros(R, dtype=f32, device=dev)
    xk[: mcc.N] = x.to(dev)
    med_ac, *bound_ac = kernel_times(
        dia_fast, dia_fast_plain, mdk, dia_spec(mcc, "constraints"), xk,
        "kernel A COO constraints -b 10",
        4 * (3 * D * R + 2 * R + 2 * (R // 8)), 2 * D * R)
    del mdk
    coo_rows.append(
        {"name": "dia_spmv_detect (COO constraints)", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/dia_spmv_detect.cu",
         "replaces": "abft_sparse_cg_tpu/ops/spmv_pallas.py:519",
         "launches": coo_launches["dia_spmv_detect (two planes)"],
         "max_abs_err": max(coo_errs["A"]), "ms": med_ac["kernel"],
         "plain_ms": med_ac["plain"], "bound_ms": bound_ac[0],
         "bound_by": bound_ac[1], "library_ms": med_ac["A @ x"]})
    for mode, launches_b in (
            ("constraints", coo_launches["fused_cg_dia (two planes)"]),
            ("secded", coo_launches["fused_cg_dia"]
             - coo_launches["fused_cg_dia (two planes)"])):
        mm = coo[mode]
        mdk = make_matrix_device(mm, f32, dev)
        spec_k = dia_spec(mm, mode)
        bk = bvec_of(mm)
        tb_ = interleave({"plain": loop_fn(fused_cg_dia_plain, mdk, spec_k,
                                           bk),
                          "kernel": loop_fn(fused_cg_dia, mdk, spec_k, bk)},
                         5, batches=5)
        ms_k, plain_k = (statistics.median(tb_["kernel"]),
                         statistics.median(tb_["plain"]))
        ik_k = coo_t10[f"COO {mode}"][1]   # the cuda target's iterations
        bound_k = bound(ik_k * dia_coo_bytes(mode, mm),
                        ik_k * (2 * D * R + 10 * R))
        print(f"kernel B COO {mode} solve -b 10 ({ik_k} it): kernel "
              f"{spread(tb_['kernel'])}; plain loop {spread(tb_['plain'])}; "
              f"bound {bound_k[0]:.4f} ms ({bound_k[1]}) [{card}]")
        coo_rows.append(
            {"name": f"fused_cg_dia [{dia_schedule(mm.dia_offsets)}] (COO "
                     f"{mode})", "route": "cuda",
             "source": "abft_sparse_cg_tpu_torch/csrc/fused_cg_dia.cu",
             "replaces": "abft_sparse_cg_tpu/solver/fused.py:1248",
             "launches": launches_b,
             "max_abs_err": coo_solve_err["COO DIA -b 10", mode],
             "ms": ms_k, "plain_ms": plain_k, "bound_ms": bound_k[0],
             "bound_by": bound_k[1], "library_ms": None})
        del mdk

    def constraints_call_bytes(mm, spec_):
        """Bytes one kernel C or E call in constraints mode must move: the
        values of the nnz valid slots, each signal plane once (padding
        included) with its baseline (the gather word is one of them: the
        col word, on COO128 the row word), C's ell_len or E's row
        pointer, x read and w written."""
        require(spec_.gather in (spec_.plane, spec_.plane2),
                "constraints: the gather word is a signal plane")
        if mm.exec_kind == "ell":   # K x R slots, a word per 8 rows
            slots, base, index = mm.K * mm.R, mm.R // 8, mm.R
        else:                       # E slots, a word per 8 slots
            slots, base, index = mm.exec_size, mm.exec_size // 8, mm.R + 1
        return (4 * mm.nnz + sig_planes(mm, "constraints") * 4
                * (slots + base) + 4 * index + 8 * mm.R)

    t0 = time.perf_counter()
    timed = {}
    for key, kernel, plain, spec_of, name, pair, gm in (
            ("C", ell_fast, ell_fast_plain, ell_spec, "dense-radius-3d",
             (ell["constraints"], coo_c10), "ell_spmv_detect.cu"),
            ("E", flat_fast, flat_fast_plain, flat_spec, "powerlaw-graph",
             (flat["powerlaw-graph"][1]["constraints"], coo_e10),
             "flat_spmv_detect.cu")):
        for fmt_, mm in zip(("CSR", "COO"), pair):
            xk = torch.zeros(mm.R, dtype=f32, device=dev)
            xk[: mm.N] = torch.tensor(
                np.random.default_rng(3).random(mm.N), dtype=f32)
            mdk = make_matrix_device(mm, f32, dev)
            spec_k = spec_of(mm, "constraints")
            shape = (f"K {mm.K}, R {mm.R}" if key == "C"
                     else f"E {mm.exec_size}")
            timed[key, fmt_] = kernel_times(
                kernel, plain, mdk, spec_k, xk,
                f"kernel {key} {fmt_} constraints {name} -b 10 ({shape})",
                constraints_call_bytes(mm, spec_k), 2 * mm.nnz)
            del mdk
        med, bms, by = timed[key, "COO"]
        wrapper = gm.removesuffix(".cu")
        coo_rows.append(
            {"name": f"{wrapper} (COO constraints)", "route": "cuda",
             "source": f"abft_sparse_cg_tpu_torch/csrc/{gm}",
             "replaces": ("abft_sparse_cg_tpu/ops/spmv_pallas.py:846"
                          if key == "C" else
                          "abft_sparse_cg_tpu/ops/spmv_unstructured.py:447"),
             "launches": sum(coo_paths[n]["constraints"][wrapper]
                             for n in coo_paths),
             "max_abs_err": max(coo_errs[f"{key} -b 10"]),
             "ms": med["kernel"], "plain_ms": med["plain"],
             "bound_ms": bms, "bound_by": by, "library_ms": med["A @ x"]})
    print(f"[kernel C and E per call: {time.perf_counter() - t0:.0f} s]")
    # the device time of each solve, in a fresh profiler worker (phase 31's
    # way): COO against CSR at -b 10, secded and constraints
    profile_group("coo", None, card)
    kernels += coo_rows

    # ---- 38. the rest of the CLI on the card --------------------------------
    phase("38. the rest of the CLI on the card: --checkpoint/--resume over "
          "kernels B, D, E, the split tail and two-plane B; --solver "
          "pipelined over kernels A, C and E; --profile")
    rest_of_cli(mats, ell, flat["powerlaw-graph"][1], card)

    # ---- 39. the cpu target as the cuda target's witness -------------------
    phase("39. the cpu target on the card host as the cuda target's "
          "witness: cg-csr-torch and cg-coo-torch -b 10 on -t cpu and "
          "-t cuda, a process per run")
    cpu_witness(mats, card)

    # ---- 40. the multi-device dry run ---------------------------------------
    phase("40. dryrun_multichip: the JAX dry run's ten configurations at 4 "
          "shards on the card, and on distinct cards where the host has "
          "them")
    from abft_sparse_cg_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    runs = dryrun_multichip(4, dev)
    require(len(runs) == 10, f"dryrun_multichip(4): {len(runs)} lines")
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs = dryrun_multichip(min(8, cards))
        require(len(runs) == 10, f"dryrun_multichip on {cards} cards: "
                f"{len(runs)} lines")
        print(f"distinct cards: ran on {min(8, cards)} cards")
    else:
        print(f"distinct cards: not run ({cards} card)")
    print(f"[all phases done at {time.perf_counter() - t_start:.0f} s]")

    print()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile-worker"]:
        profile_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--cli-worker"]:
        cli_worker(sys.argv[2])
    else:
        main()
