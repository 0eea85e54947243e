#!/usr/bin/env python3
"""Kernel B and D solves of two checkouts of the PyTorch/CUDA port, in
turns on one card.

    python3 scripts/torch_live_ab.py A_DIR B_DIR [--rounds 1] [--only ell]

Compares the whole-solve kernels' solves of two trees, e.g. a parent
commit unpacked with ``git archive`` and the change on top of it.  Each turn is one
worker process started in one checkout, with that checkout's package and
kernels (built from its own csrc/ into its own build directory, excluded
from the times); the turns run A, B, B, A per round, so that a drift of
the card or host over the run falls on both.  A worker builds the bundled
matrix at -b 10 and -b 100 (DIA: kernel B), the zoo's arrowhead at -b 10
(a bordered split: kernel B's split-tail instances) and dense-radius-3d
at -b 10 (banded ELL, band 1,627: kernel D) in modes none and secded, and
stencil27-shuffled at -b 10 in secded (ELL under RCM, band 4,681: kernel
D past its window), and solves each configuration of CONFIGS through
``CudaBackend(mode)._solver`` (the tier the cuda target picks): live, and
in secded also lazy CI 4, Jacobi and lazy Jacobi (and, at DIA -b 100,
lazy CI 32).  ``--only`` keeps the configurations of the layouts it names
("dia", "split", "ell"; both trees' turns run the same ones).  Per
configuration, full and 2-iteration solves:

  - by host clock around synchronised calls, in interleaved batches;
  - the kernel's own device time per solve: CUDA events recorded right
    around each cooperative launch (the worker wraps the tree's kernel B
    and D libraries), summed over the solve's launches; the slope per
    iteration from full minus 2-iteration solves, beside the bytes an
    iteration must move over 3.35 TB/s (its bound);
  - on the configurations of PROFILED, a torch.profiler window of 10
    warm full solves (chip_smoke.py's call_profile): device time and
    device operations per solve, and the device's busy share of the
    window.

Prints, per configuration, each tree's medians over its turns, B over A,
the split tail's share of the secded slope (arrowhead's minus DIA -b
10's), and the card's name and power limit as ``nvidia-smi`` gives them.
The worker uses only what both trees have.  Needs one CUDA card; exits
non-zero without.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

# (label, matrix, blocks, mode, Jacobi, check interval)
ELL_CONFIGS = [
    ("dense-radius-3d -b 10", "dense-radius-3d", 10, "none", False, 1),
    ("dense-radius-3d -b 10", "dense-radius-3d", 10, "secded", False, 1),
    ("dense-radius-3d -b 10 lazy CI 4", "dense-radius-3d", 10, "secded",
     False, 4),
    ("dense-radius-3d -b 10 Jacobi", "dense-radius-3d", 10, "secded", True,
     1),
    ("dense-radius-3d -b 10 lazy Jacobi", "dense-radius-3d", 10, "secded",
     True, 4),
    ("stencil27-shuffled -b 10", "stencil27-shuffled", 10, "secded", False,
     1)]
CONFIGS = [("-b 10", "dia", 10, "none", False, 1),
           ("-b 10", "dia", 10, "secded", False, 1),
           ("-b 10 lazy CI 4", "dia", 10, "secded", False, 4),
           ("-b 10 Jacobi", "dia", 10, "secded", True, 1),
           ("-b 10 lazy Jacobi", "dia", 10, "secded", True, 4),
           ("-b 100", "dia", 100, "none", False, 1),
           ("-b 100", "dia", 100, "secded", False, 1),
           ("-b 100 lazy CI 4", "dia", 100, "secded", False, 4),
           ("-b 100 Jacobi", "dia", 100, "secded", True, 1),
           ("-b 100 lazy Jacobi", "dia", 100, "secded", True, 4),
           ("-b 100 lazy CI 32", "dia", 100, "secded", False, 32),
           ("arrowhead -b 10", "arrowhead", 10, "none", False, 1),
           ("arrowhead -b 10", "arrowhead", 10, "secded", False, 1),
           ("arrowhead -b 10 lazy CI 4", "arrowhead", 10, "secded", False,
            4),
           ("arrowhead -b 10 Jacobi", "arrowhead", 10, "secded", True, 1),
           ("arrowhead -b 10 lazy Jacobi", "arrowhead", 10, "secded", True,
            4)] + ELL_CONFIGS
LAYOUTS = {"dia": ("dia",), "split": ("arrowhead",),
           "ell": ("dense-radius-3d", "stencil27-shuffled")}
PROFILED = ("-b 10 secded", "-b 10 lazy CI 4 secded", "-b 10 Jacobi secded",
            "-b 10 lazy Jacobi secded", "-b 100 secded",
            "-b 100 lazy CI 32 secded", "arrowhead -b 10 secded",
            "arrowhead -b 10 lazy CI 4 secded",
            "arrowhead -b 10 Jacobi secded",
            "arrowhead -b 10 lazy Jacobi secded",
            "dense-radius-3d -b 10 none", "dense-radius-3d -b 10 secded",
            "dense-radius-3d -b 10 lazy CI 4 secded",
            "dense-radius-3d -b 10 Jacobi secded",
            "dense-radius-3d -b 10 lazy Jacobi secded",
            "stencil27-shuffled -b 10 secded")


def selected(only):
    """The CONFIGS of the layouts named in ``only`` (all when None)."""
    if only is None:
        return CONFIGS
    keep = {m for lay in only.split(",") for m in LAYOUTS[lay]}
    return [c for c in CONFIGS if c[1] in keep]
CONV = 1e-3
HBM_BPS = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet


def smoke_helpers():
    """This tree's chip_smoke.py, loaded by path (its module level
    imports only the standard library): ``call_profile`` traces both
    trees."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def iter_bytes(m, mode, precond, ci):
    """Bytes one iteration must move: the DIA value planes (and fold
    planes in the ECC modes), or the ELL value and gather words of the
    valid slots, ell_len and (detecting modes) the K x R signal plane and
    its baseline; a split's td and tb and its tail signal plane with its
    baseline (detecting modes); 8 vector streams (M^-1 twice more with
    Jacobi); a lazy schedule reads the signal planes on one iteration in
    ``ci``."""
    ecc = mode in ("sed", "sec7", "sec8", "secded")
    if m.exec_kind == "ell":
        K, R = m.K, m.R
        sig = 4 * K * R + R // 2 if mode != "none" else 0
        return (8 * m.nnz + 4 * R + sig / ci
                + (32 + (8 if precond else 0)) * R)
    main = m.main if m.exec_kind == "split" else m
    D, R = len(main.dia_offsets), m.R
    planes, sig = 4 * D * R, (4 * D * R if ecc else 0)
    if m.exec_kind == "split":
        T, S = len(m.tail.dense_plan[0]), m.tail.dense_plan[2]
        E = m.tail.exec_size
        planes += 8 * T * S
        sig += 4 * E + E // 2 if mode != "none" else 0
    return planes + sig / ci + (32 + (8 if precond else 0)) * R


def worker(root, batches, reps, only):
    """One turn in checkout ``root``: JSON of per-call ms lists."""
    sys.path.insert(0, root)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
    from abft_sparse_cg_tpu_torch.formats import build_protected, load_matrix
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_live_ab: no CUDA device")
    _build.build()
    events = []

    class Timed:
        """Kernel B's or D's library, its launch entry bracketed by
        events."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            fn = getattr(self.lib, name)
            if name not in ("abft_fused_cg_dia", "abft_fused_cg_ell"):
                return fn

            def call(*args):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                rc = fn(*args)
                e.record()
                events.append((s, e))
                return rc
            return call

    for lib in ("fused_cg_dia", "fused_cg_ell"):
        _build._libs[lib] = Timed(_build._libs[lib])
    dev, f32 = torch.device("cuda", 0), torch.float32
    configs = selected(only)
    asm = {}
    for name, b in sorted({(c[1], c[2]) for c in configs}):
        if name == "dia":
            path = os.path.join(root, "matrices", "shallow_water1",
                                "shallow_water1.mtx")
            if not os.path.exists(path):
                subprocess.run([sys.executable, os.path.join(
                    root, "matrices", "make_matrix.py")], check=True,
                    stdout=subprocess.DEVNULL)
            asm[name, b] = load_matrix(path, b)
        else:
            asm[name, b] = zoo_assembled(name, b)
    keys = sorted({(name, b, mode) for _, name, b, mode, _, _ in configs})
    with ThreadPoolExecutor(max_workers=len(keys)) as ex:
        futs = {k: ex.submit(build_protected, "csr", asm[k[:2]], k[2])
                for k in keys}
        mats = {k: f.result() for k, f in futs.items()}

    fns, its, nbytes = {}, {}, {}
    for label, name, b, mode, precond, ci in configs:
        m = mats[name, b, mode]
        md = make_matrix_device(m, f32, dev)
        bb = torch.zeros(m.R, dtype=f32, device=dev)
        bb[: m.N] = torch.tensor(m.to_exec_order(
            np.random.default_rng(11).random(m.N)), dtype=f32)
        args = (md, bb)
        if precond:
            minv = torch.zeros(m.R, dtype=f32)
            minv[: m.N] = torch.tensor(m.to_exec_order(
                jacobi_minv(m, "jacobi")), dtype=f32)
            args += (minv.to(dev),)
        cfg = f"{label} {mode}"
        nbytes[cfg] = iter_bytes(m, mode, precond, ci)
        for upto, suffix in ((1000, ""), (2, " @2")):
            solve = CudaBackend(mode)._solver(m, f32, upto, CONV, precond,
                                              ci)
            its[cfg + suffix] = solve(*args).iterations   # also a warm-up
            fns[cfg + suffix] = (lambda s=solve, a=args: s(*a))

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def kernel_ms(fn):
        del events[:]
        fn()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events)

    names = list(fns)
    out = {n: [] for n in names}
    kern = {n: [] for n in names}
    for k in range(batches):
        for n in (names if k % 2 == 0 else names[::-1]):
            out[n].append(host_ms(fns[n]))
            kern[n].append(kernel_ms(fns[n]))
    sm = smoke_helpers()
    prof = {}
    for n in (n for n in PROFILED if n in fns):
        with contextlib.redirect_stdout(io.StringIO()):
            w = sm.call_profile(fns[n], n, "", reps=10)
        prof[n] = None if w is None else {k: w[k] for k in ("ms", "ops",
                                                             "busy")}
    print(json.dumps({"ms": out, "kernel": kern, "its": its,
                      "bytes": nbytes, "profile": prof}))


def med_over(turns, key, name):
    return statistics.median(v for t in turns for v in t[key][name])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--batches", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", help="the layouts to run, comma-separated "
                    "of " + ", ".join(LAYOUTS) + " (default: all)")
    ap.add_argument("--worker", action="store_true",
                    help="run one turn in A_DIR and print its JSON")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.a_dir), args.batches, args.reps,
               args.only)
        return
    dirs = {"A": os.path.abspath(args.a_dir),
            "B": os.path.abspath(args.b_dir)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    runs = {"A": [], "B": []}
    for _ in range(args.rounds):
        for tree in ("A", "B", "B", "A"):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), dirs[tree],
                 "--worker", "--batches", str(args.batches), "--reps",
                 str(args.reps)] + (["--only", args.only] if args.only
                                    else []), cwd=dirs[tree],
                capture_output=True, text=True)
            if res.returncode:
                sys.stderr.write(res.stderr)
                raise SystemExit(f"torch_live_ab: the turn in {dirs[tree]} "
                                 f"failed ({res.returncode})")
            runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(f"turn {tree} ({dirs[tree]}): "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    configs = selected(args.only)
    med, slope = {}, {}
    for tree, turns in runs.items():
        for label, _, _, mode, _, _ in configs:
            name = f"{label} {mode}"
            full = [v for t in turns for v in t["ms"][name]]
            per_turn = [statistics.median(t["ms"][name]) for t in turns]
            m_full = statistics.median(full)
            m_two = med_over(turns, "ms", name + " @2")
            k_full = med_over(turns, "kernel", name)
            k_two = med_over(turns, "kernel", name + " @2")
            it, it2 = turns[0]["its"][name], turns[0]["its"][name + " @2"]
            med[tree, name] = m_full
            slope[tree, name] = (k_full - k_two) / max(1, it - it2)
            bound = turns[0]["bytes"][name] / HBM_BPS * 1e3
            print(f"{tree} {name:34s}: median {m_full:.4f} ms (min "
                  f"{min(full):.4f}, max {max(full):.4f}, n={len(full)}; "
                  f"turn medians {', '.join(f'{v:.4f}' for v in per_turn)})"
                  f", {it} it; 2-it solve {m_two:.4f} ms; kernel (events) "
                  f"{k_full:.4f} ms per solve, {k_two:.4f} at 2 it; slope "
                  f"{slope[tree, name]:.4f} ms/it against a bound of "
                  f"{bound:.4f} ({turns[0]['bytes'][name] / 1e6:.1f} MB/it)"
                  f" = {bound / slope[tree, name] * 100:.1f}% [{card}]")
        for name in (n for n in PROFILED if n in turns[0]["profile"]):
            ws = [t["profile"][name] for t in turns
                  if t["profile"][name] is not None]
            if not ws:
                print(f"{tree} {name}: profiler: no device events traced: "
                      "device time not measured")
                continue
            turn_ms = ", ".join(f"{w['ms']:.4f}" for w in ws)
            print(f"{tree} {name:34s}: profiler device "
                  f"{statistics.median(w['ms'] for w in ws):.4f} ms per "
                  f"solve in {statistics.median(w['ops'] for w in ws):.2f} "
                  f"device operations, busy "
                  f"{statistics.median(w['busy'] for w in ws) * 100:.1f}% "
                  f"(turns {turn_ms}) [{card}]")
        if (tree, "arrowhead -b 10 secded") in slope and (
                tree, "-b 10 secded") in slope:
            tail = (slope[tree, "arrowhead -b 10 secded"]
                    - slope[tree, "-b 10 secded"])
            print(f"{tree} split tail's share of the secded slope: "
                  f"{tail:.4f} ms/it (arrowhead -b 10 minus DIA -b 10, "
                  f"kernel events) = "
                  f"{tail / slope[tree, 'arrowhead -b 10 secded'] * 100:.1f}"
                  f"% [{card}]")
    for label, _, _, mode, _, _ in configs:
        name = f"{label} {mode}"
        # turn k of A and turn k of B ran next to each other (A B, B A)
        faster = sum(statistics.median(b["ms"][name])
                     < statistics.median(a["ms"][name])
                     for a, b in zip(runs["A"], runs["B"]))
        print(f"B over A, {name}: host "
              f"{(med['B', name] / med['A', name] - 1) * 100:+.1f}% (B "
              f"faster in {faster} of {len(runs['A'])} adjacent turn pairs);"
              f" slope {(slope['B', name] / slope['A', name] - 1) * 100:+.1f}"
              f"% [{card}]")
    print(card)


if __name__ == "__main__":
    main()
