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
    kernels C and D.

Phases:

  1. device and card (name, power limit);
  2. build the kernels from abft_sparse_cg_tpu_torch/csrc (one nvcc per
     source, all started together);
  3. kernel A vs its plain version, every mode, clean and with injected
     1- and 2-bit faults;
  4. kernel B vs its plain loop: a clean and a faulted secded solve;
  5. the DIA main path: the four run_tests classes on -t cuda at -b 10
     --seed 11, through abft_sparse_cg_tpu_torch.cli.main_csr (what
     bin/cg-csr-torch runs), every launch count reset before and read
     after;
  6. the float32 rr trajectory against the port's float64 plain solve
     (the scripts/tpu_smoke.py bound);
  7. the DIA launch counts;
  8. DIA times: interleaved batches, median and spread, build excluded;
     kernel A against its plain version, the bare ``A @ x`` of a
     torch.sparse_csr_tensor (computes less: no checks) and its bound;
  9. the ELL matrices, each mode built once: dense-radius-3d -b 4,
     blockdiag-random -b 2, and stencil27-shuffled -b 2 forced to ELL
     under its RCM permutation (the gidx plane); dense-radius-3d -b 10
     in modes none and secded for the timed path;
 10. kernel C vs its plain version on the three ELL shapes, every mode,
     clean and with injected 1- and 2-bit faults (and an index flip in
     none/constraints): w bit-exact, pw within 1e-5;
 11. kernel D vs its plain loop: a clean and a faulted secded solve on
     dense-radius-3d -b 10;
 12. the ELL main path: the four run_tests classes through main_csr with
     -t cuda -f <file> -b 4 --seed 11, the .mtx file written by the
     port's mmio into a temporary directory; launch counts reset before
     and read after;
 13. the ELL float32 trajectory against the port's float64 plain solve;
 14. ELL times: solves, per-iteration slope and GB/s, kernel C and D
     against their plain versions, ``A @ x`` and their bounds, and the
     host build, upload and classify;
 15. the flat and split matrices: powerlaw-graph -b 10, stencil27-
     shuffled -b 1 and dense-radius-k729 -b 10 (flat, each mode),
     arrowhead and band+random-1pct -b 10 (split); the host builds of
     one matrix's modes run in parallel threads, here and in phases 8,
     9 and 20;
 16. kernel E vs its plain version on the three flat shapes, every
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
     D vs its plain loop, a secded CLI run, solve times;
 21. flat and split times: per-iteration and split-tail solves with
     slope and GB/s, kernel E per call against its plain version,
     ``A @ x`` and its bound, the secded-over-none price of kernel E's
     per-call signals, the split tail against its plain loop;
 22. powerlaw-graph -b 100 (HBM-bound), if its host build takes under a
     minute and the run is early enough;
 23. torch.profiler windows over warm -b 10 solves (DIA, ELL, flat,
     split): device time per solve by kernel and the device's idle
     share.

Any failed check raises, so the script exits non-zero.  The last three
lines are the card line from nvidia-smi, one JSON object describing the
kernels, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
and no module of the JAX package.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero and prints no
result.
"""

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
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


def phase(title):
    print(f"\n== {title}", flush=True)


def spread(vals):
    return (f"median {statistics.median(vals):.4f} ms "
            f"(min {min(vals):.4f}, max {max(vals):.4f}, n={len(vals)})")


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the card's peak rate."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def parallel_builds(asm, modes, **kw):
    """Each mode's host build of ``asm`` ({mode: matrix}), in threads:
    NumPy releases the GIL in its sorts and elementwise loops, so the
    builds overlap on the host's cores."""
    from concurrent.futures import ThreadPoolExecutor

    from abft_sparse_cg_tpu_torch.formats import build_protected

    with ThreadPoolExecutor(max_workers=len(modes)) as ex:
        futs = {mode: ex.submit(build_protected, "csr", asm, mode, **kw)
                for mode in modes}
        return {mode: f.result() for mode, f in futs.items()}


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
        occupied = md.words[0] != 0
        for w in md.words[1:]:
            occupied = occupied | (w != 0)
        valid = (cols >= 0) & (cols < R) & occupied
    else:
        from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_gather_plane

        cols = ell_gather_plane(md, spec).to(torch.int64)
        valid = slot < md.ell_len[None, :].to(torch.int64)
    valid_t = valid.T
    counts = valid_t.sum(dim=1)
    crow = torch.zeros(R + 1, dtype=torch.int64, device=values.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta" notices
        a = torch.sparse_csr_tensor(crow, cols.T[valid_t],
                                    values.T[valid_t], size=(R, R))
    return a, int(crow[-1])


def profile_solves(mats, dev, card, label, solves=10):
    """A torch.profiler window over ``solves`` warm solves per mode, on
    the tier the cuda target picks (whole-solve kernel or per-iteration
    loop): device time per solve by kernel, the device's busy and idle
    shares of the window (the profiler's own host overhead stretches the
    window, so the idle share is an upper bound)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device

    for mode in ("none", "secded"):
        m = mats[mode]
        solve = CudaBackend(mode)._solver(m, torch.float32, 1000, CONV)
        md = make_matrix_device(m, torch.float32, dev)
        b = torch.zeros(m.R, dtype=torch.float32, device=dev)
        b[: m.N] = torch.tensor(np.random.default_rng(11).random(m.N),
                                dtype=torch.float32)
        its = solve(md, b).iterations
        for _ in range(3):
            solve(md, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(solves):
                solve(md, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / solves
        events = list(prof.events())
        gpu = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.device_type == DeviceType.CUDA)
        print(f"{label} {mode} ({its} it), {solves} solves under the "
              f"profiler: {wall:.4f} ms per solve (host clock) [{card}]")
        if not gpu:
            print("  no device events traced: device times not measured")
            continue
        by_name = {}
        for t0_, t1_, name in gpu:
            by_name[name] = by_name.get(name, 0.0) + (t1_ - t0_)
        busy, cur0, cur1 = 0.0, None, None
        for t0_, t1_, _ in gpu:
            if cur1 is None or t0_ > cur1:
                busy += 0.0 if cur1 is None else cur1 - cur0
                cur0, cur1 = t0_, t1_
            else:
                cur1 = max(cur1, t1_)
        busy += cur1 - cur0
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {us / solves / 1e3:.4f} ms/solve  {name[:90]}")
        print(f"  device busy {busy / solves / 1e3:.4f} ms/solve; idle "
              f"{(1 - busy / span) * 100:.1f}% of the {span / 1e3:.3f} ms "
              f"window [{card}]")


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


def trajectory(m, b, label, oracle_mat=None, oracle_dev="cpu", conv=1e-6,
               floor=1e-8):
    """The f32 cuda trajectory against the port's f64 plain solve (on
    ``oracle_mat``, the same matrix built in another mode, if given; on
    ``oracle_dev``: the plain version runs on the card too), both run to
    ``conv``: rr within 2e-2 down to rr0 * ``floor`` (the
    scripts/tpu_smoke.py bound, floor 1e-8) and, with that floor, the
    iteration counts within max(1, n / 20) (tests/test_zoo_parity.py's
    rule).  A higher floor marks a matrix on which float32 CG itself
    leaves the float64 trajectory there: the counts are then printed,
    not held."""
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device, make_spmv
    from abft_sparse_cg_tpu_torch.solver.cg import make_cg_solver

    res = CudaBackend(m.mode).solve(m, b, 500, conv, dtype="f32", reps=1)
    f64, odev = torch.float64, torch.device(oracle_dev)
    bexec = torch.zeros(m.R, dtype=f64, device=odev)
    bexec[: m.N] = torch.tensor(m.to_exec_order(b), dtype=f64)
    om = m if oracle_mat is None else oracle_mat
    ora = make_cg_solver(make_spmv(om, f64, om.mode), 500, conv)(
        make_matrix_device(om, f64, odev), bexec)
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
        dia_fast, dia_fast_plain, dia_spec, ell_fast, ell_fast_plain,
        ell_spec, flat_fast, flat_fast_plain, flat_spec)
    from abft_sparse_cg_tpu_torch.solver.cg import init_state
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.solver.fused import (
        fused_cg_dia, fused_cg_dia_plain, fused_cg_ell, fused_cg_ell_plain,
        fused_grid, make_fused_solver, tail_spec)

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    t_start = time.perf_counter()

    def reset_launches():
        for fn in (dia_fast, fused_cg_dia, ell_fast, fused_cg_ell,
                   flat_fast):
            fn.launches = 0
        fused_cg_dia.tail_launches = fused_cg_ell.tail_launches = 0

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
          f"({fused_grid(0, 'ell', True)})")

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
            # must match in place; the rest is compared numerically.
            fin = torch.isfinite(wp)
            require(torch.equal(fin, torch.isfinite(wk)),
                    f"{label}: non-finite entries differ")
            err = float((wk - wp)[fin].abs().max())
            rel = err / float(wp[fin].abs().max())
            prel = pw_rel(pk, pp)
            require(rel <= 1e-6, f"{label}: w rel err {rel:.3e} > 1e-6")
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
    m = mats["secded"]
    spec = dia_spec(m, "secded")
    b = np.random.default_rng(11).random(m.N)
    bd = torch.zeros(m.R, dtype=f32, device=dev)
    bd[: m.N] = torch.tensor(b, dtype=f32)
    md = make_matrix_device(m, f32, dev)

    def run_loop(fn, md_, spec_, bvec, upto=1000, tail=None):
        s = init_state(bvec, upto)
        x_, r_, p_ = s.x.clone(), s.r.clone(), s.p.clone()
        tr = torch.full_like(s.trace, float("nan"))
        out = fn(md_, spec_, x_, r_, p_, s.rr, s.rz, 0, upto, CONV, tr, tail)
        torch.cuda.synchronize()
        return out, x_, tr

    def check_loops(kernel, plain, md_, spec_, bvec, label, tail=None):
        """Kernel against plain loop: iterations equal, the trace to 1e-5
        (a split tail's to 1e-3 above float32's noise floor, rr0 * 1e-5:
        its dot products are summed in another order), x beside."""
        (ik, _, _, tk, ek), xk, trk = run_loop(kernel, md_, spec_, bvec,
                                               tail=tail)
        (ip, _, _, tp, ep), xp, trp = run_loop(plain, md_, spec_, bvec,
                                               tail=tail)
        require(ik == ip and tk == tp == 0 and ek == ep == 0,
                f"{label}: kernel {ik} it (trig {tk}, err {ek}), plain "
                f"{ip} it (trig {tp}, err {ep})")
        err = float((xk - xp).abs().max())
        rel = (trk[:ik] - trp[:ip]).abs() / trp[:ip].abs()
        tol = 1e-5
        if tail is not None:
            rel, tol = rel[trp[:ip] > trp[0] * 1e-5], 1e-3
        dev_tr = float(rel.max())
        print(f"{label}: kernel {ik} iterations, plain {ip}; trace max rel "
              f"dev {dev_tr:.2e}; x max|err| {err:.3e}; trig/err {tk}/{ek}")
        require(dev_tr <= tol, f"{label} trace dev {dev_tr:.2e} > {tol}")
        return ik, err

    def check_faulted(m1, mode, label):
        solve = make_fused_solver(m1, mode, 1000, CONV)
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

    ik, b_err = check_loops(fused_cg_dia, fused_cg_dia_plain, md, spec, bd,
                            "clean")
    check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(12),
                                  echo=lambda s: None), "secded",
                  "1-bit flip")

    # ---- 5. DIA main path: the four run_tests classes ----------------------
    phase("5. DIA main path: run_tests classes, cg-csr -t cuda -b 10 "
          "--seed 11")
    reset_launches()
    run_tests_classes(main_csr, ["-b", "10", "--seed", "11", "-t", "cuda"])
    launches = {"dia_spmv_detect": dia_fast.launches,
                "fused_cg_dia": fused_cg_dia.launches}

    # ---- 6. trajectory ----------------------------------------------------
    phase("6. float32 cuda trajectory vs float64 plain oracle, -b 10")
    trajectory(m, b, "DIA -b 10 secded")

    # ---- 7. launch counts -------------------------------------------------
    phase("7. launch counts during phase 5")
    for name, n in launches.items():
        print(f"{name}: {n} launches")
        require(n > 0, f"{name} was not launched on the main path")

    # ---- 8. times ---------------------------------------------------------
    phase(f"8. DIA times on {card} (warm, build excluded)")

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

    solve_table("-b 10", mats, 7, 10, dia_iter_bytes)

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
    del mats100, a100

    def kernel_times(kernel, plain, md_, spec_, xd_, label, nbytes, flops):
        """Per-call device time (CUDA events, interleaved) of a kernel,
        its plain version and the bare A @ x, beside the bound."""
        a_csr, nnz = csr_yardstick(md_, spec_)
        xcol = xd_[:, None]
        t = interleave({"plain": lambda: plain(md_, xd_, spec_),
                        "kernel": lambda: kernel(md_, xd_, spec_),
                        "A @ x": lambda: a_csr @ xcol}, 20,
                       timer=event_ms)
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

    def loop_fn(fn, md_, spec_, bvec, tail=None):
        def go():
            s = init_state(bvec, 1000)
            fn(md_, spec_, s.x.clone(), s.r.clone(), s.p.clone(), s.rr,
               s.rz, 0, 1000, CONV, torch.full_like(s.trace, float("nan")),
               tail)
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
        {"name": "fused_cg_dia", "route": "cuda",
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
    from abft_sparse_cg_tpu_torch.utils.matzoo import (
        dense_radius_3d, zoo_assembled)

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
    # The timed ELL path: dense-radius-3d -b 10 in modes none and secded.
    t0 = time.perf_counter()
    a_ell = zoo_assembled("dense-radius-3d", 10)
    ell = parallel_builds(a_ell, ("none", "secded"))
    print(f"dense-radius-3d -b 10: 2 builds in "
          f"{time.perf_counter() - t0:.1f} s")
    require(ell["secded"].K == 175 and ell["secded"].perm is None
            and ell["secded"].band == 1627,
            "dense-radius-3d -b 10: K 175, band 1627, no permutation")
    require(shapes["stencil27-shuffled"][1]["secded"].perm is not None,
            "stencil27-shuffled: RCM permutation active")

    # ---- 10. kernel C vs plain --------------------------------------------
    phase("10. kernel C (ell_spmv_detect) vs plain, three shapes, every "
          "mode")
    c_errs = []
    for name, (_, per) in shapes.items():
        for mode in MODES:
            m = per[mode]
            spec = ell_spec(m, mode)
            xc = torch.zeros(m.R, dtype=f32, device=dev)
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
                mdc = make_matrix_device(mm, f32, dev)
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
    ik_d, d_err = check_loops(fused_cg_ell, fused_cg_ell_plain, mde, spec,
                              bde, "clean")
    check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(12),
                                  echo=lambda s: None), "secded",
                  "1-bit flip")

    # ---- 12. ELL main path ------------------------------------------------
    phase("12. ELL main path: run_tests classes, cg-csr -t cuda -f "
          "dense-radius-3d.mtx -b 4 --seed 11 (-b 10 is timed in 14)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dense-radius-3d.mtx")
        write_mm_triangle(path, *dense_radius_3d())
        reset_launches()
        run_tests_classes(main_csr, ["-f", path, "-b", "4", "--seed", "11",
                                     "-t", "cuda"])
        ell_launches = {"ell_spmv_detect": ell_fast.launches,
                        "fused_cg_ell": fused_cg_ell.launches}
    for name, n in ell_launches.items():
        print(f"{name}: {n} launches")
        require(n > 0, f"{name} was not launched on the ELL path")

    # ---- 13. ELL trajectory -----------------------------------------------
    phase("13. float32 cuda trajectory vs float64 plain oracle, "
          "dense-radius-3d -b 10")
    # The oracle solves the mode-none build of the same matrix: the same
    # values and structure, without the per-iteration signal scans that
    # make a float64 CPU solve of 38M slots slow.
    trajectory(ell["secded"], b_ell, "ELL -b 10 secded", ell["none"])

    # ---- 14. ELL times ----------------------------------------------------
    phase(f"14. ELL times on {card} (warm, build excluded)")
    solve_table("dense-radius-3d -b 10", ell, 7, 10, ell_iter_bytes)
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
    phase("16. kernel E (flat_spmv_detect) vs plain, three flat shapes, "
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
    ik_t, t_err = check_loops(fused_cg_dia, fused_cg_dia_plain, mda[0],
                              spec_a, bda, "clean", tail=tail_a)
    for seed in (12, 14):
        check_faulted(inject_bitflips(m, "ANY", 1, np.random.default_rng(
            seed), echo=lambda s: None), "secded", f"1-bit flip (seed {seed})")

    # ---- 18. the flat and split main paths ---------------------------------
    phase("18. flat and split main paths: run_tests classes, cg-csr -t cuda "
          "-f <file> -b 10 --seed 11")
    path_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, need in (("powerlaw-graph", ("flat_spmv_detect",)),
                           ("band+random-1pct", ("ell_spmv_detect",
                                                 "flat_spmv_detect")),
                           ("arrowhead", ("fused_cg_dia (split tail)",
                                          "flat_spmv_detect"))):
            path = os.path.join(tmp, f"{name}.mtx")
            write_mm_triangle(path, *ZOO[name][0]())
            t0 = time.perf_counter()
            reset_launches()
            run_tests_classes(main_csr, ["-f", path, "-b", "10", "--seed",
                                         "11", "-t", "cuda"])
            got = {"dia_spmv_detect": dia_fast.launches,
                   "ell_spmv_detect": ell_fast.launches,
                   "flat_spmv_detect": flat_fast.launches,
                   "fused_cg_dia (split tail)": fused_cg_dia.tail_launches,
                   "fused_cg_ell": fused_cg_ell.launches}
            path_launches[name] = got
            print(f"{name}: launches {got} ({time.perf_counter() - t0:.0f} "
                  "s)")
            for k in need:
                require(got[k] > 0, f"{k} was not launched on the {name} "
                        "path")

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
    ik_w, _ = check_loops(fused_cg_ell, fused_cg_ell_plain, mdw,
                          ell_spec(mw, "secded"), bw_, "kernel D clean")
    del mdw
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stencil27-shuffled.mtx")
        write_mm_triangle(path, *ZOO["stencil27-shuffled"][0]())
        reset_launches()
        code, out = run_cli(main_csr, ["-f", path, "-b", "10", "--seed",
                                       "11", "-t", "cuda", "-m", "secded"])
        te = total_error(out)
        require(code == 0 and te < 1.0 and fused_cg_ell.launches > 0,
                f"wide-band CLI secded: exit {code}, total error {te}, "
                f"kernel D launches {fused_cg_ell.launches}")
        print(f"cg-csr -t cuda -m secded -f stencil27-shuffled.mtx -b 10: "
              f"exit 0, total error {te:f}, kernel D launches "
              f"{fused_cg_ell.launches}")
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
                splits["band+random-1pct"][1], 5, 3, split_iter_bytes)
    solve_table("arrowhead -b 10 (kernel B, split tail)",
                splits["arrowhead"][1], 5, 5, split_iter_bytes)
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
        {"name": "fused_cg_dia (split tail)", "route": "cuda",
         "source": "abft_sparse_cg_tpu_torch/csrc/dia_common.cuh",
         "replaces": "abft_sparse_cg_tpu/solver/fused.py:977",
         "launches": path_launches["arrowhead"]["fused_cg_dia (split tail)"],
         "max_abs_err": t_err, "ms": ms_t, "plain_ms": plain_t,
         "bound_ms": bound_t[0], "bound_by": bound_t[1],
         "library_ms": None},
    ]

    # ---- 22. powerlaw-graph -b 100 (HBM-bound), if its build is quick ------
    phase("22. powerlaw-graph -b 100, none and secded")
    if time.perf_counter() - t_start > 660:
        print("skipped: the run is past 660 s (the 1200 s limit)")
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

    # ---- 23. profile (last: the profiler may disturb later timings) --------
    phase(f"23. torch.profiler over warm -b 10 solves on {card}")
    profile_solves(mats, dev, card, "DIA -b 10")
    profile_solves(ell, dev, card, "ELL dense-radius-3d -b 10")
    profile_solves(pl, dev, card, "flat powerlaw-graph -b 10", solves=5)
    profile_solves(splits["arrowhead"][1], dev, card,
                   "split arrowhead -b 10")
    print(f"[all phases done at {time.perf_counter() - t_start:.0f} s]")

    print()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
