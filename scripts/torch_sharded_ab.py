#!/usr/bin/env python3
"""The row-sharded tier's times in one or two checkouts of the
PyTorch/CUDA port, in turns on one card: 4 shards on the card.

    python3 scripts/torch_sharded_ab.py A_DIR [B_DIR] [--rounds 1]

Each turn is one worker process started in one checkout, with that
checkout's package and kernels (built from its own csrc/ into its own
build directory, excluded from the times).  With two checkouts the turns
run A, B, B, A per round, so that a drift of the card or host falls on
both; with one, A once per round.

A worker builds, in mode secded, the bundled matrix at -b 10 and -b 100
(DIA: kernel A's halo form, H 128) and dense-radius-3d -b 10 with R
aligned to 4096 rows (ELL: kernel C's halo form, H 1,664), uploads each
onto a 4-shard mesh of the card (``_device_put_sharded``) and times:

  - the sharded SpMV as the solver calls it (``make_shardmap_spmv(m,
    mesh).fast_pw``: the halo exchange, 4 halo launches, the trigger's OR
    and pw's sum over the shards) per call by CUDA events, 20 back-to-back
    calls per batch, and under a torch.profiler window of 50 warm calls:
    the device time per call, the device operations per call and the
    device's busy share of the window;
  - the sharded solve (``make_sharded_solver``, solver.cg's live loop
    over it) by host clock, batches of 3 solves, and its iterations.

Prints each number per tree (medians over its turns), B over A, and the
card's name and power limit as ``nvidia-smi`` gives them.  The worker
uses only what both trees have.  Needs one CUDA card; exits non-zero
without.
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

CONV = 1e-3
CASES = ("DIA -b 10", "DIA -b 100", "dense-radius-3d -b 10")


def smoke_helpers():
    """This checkout's chip_smoke.py, loaded by path (its module level
    imports only the standard library): ``call_profile``, ``event_ms``
    and ``host_ms`` time both trees."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root, batches):
    """One turn in checkout ``root``: JSON of its measurements."""
    sys.path.insert(0, root)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.formats import build_protected, load_matrix
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded, default_mesh, make_sharded_solver)
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        make_shardmap_spmv, supports_shardmap)
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_ab: no CUDA device")
    sm = smoke_helpers()
    _build.build()
    dev, f32 = torch.device("cuda", 0), torch.float32
    path = os.path.join(root, "matrices", "shallow_water1",
                        "shallow_water1.mtx")
    if not os.path.exists(path):
        subprocess.run([sys.executable, os.path.join(
            root, "matrices", "make_matrix.py")], check=True,
            stdout=subprocess.DEVNULL)
    asm = {"DIA -b 10": (lambda: load_matrix(path, 10), None),
           "DIA -b 100": (lambda: load_matrix(path, 100), None),
           "dense-radius-3d -b 10": (
               lambda: zoo_assembled("dense-radius-3d", 10), 4096)}
    with ThreadPoolExecutor(max_workers=len(asm)) as ex:
        futs = {k: ex.submit(lambda f=f, a=a: build_protected(
                    "csr", f(), "secded", row_align=a))
                for k, (f, a) in asm.items()}
        mats = {k: f.result() for k, f in futs.items()}
    mesh = default_mesh(4, dev)
    spmv, solves, its = {}, {}, {}
    for k in CASES:
        m = mats[k]
        assert supports_shardmap(m, f32, 4), k
        smd, xs, _ = _device_put_sharded(
            m, np.random.default_rng(3).random(m.N), mesh, f32)
        f = make_shardmap_spmv(m, mesh).fast_pw
        spmv[k] = (lambda f=f, a=smd, b=xs: f(a, b))
        smd, bsh, _ = _device_put_sharded(
            m, np.random.default_rng(11).random(m.N), mesh, f32)
        s = make_sharded_solver(m, mesh, 1000, CONV, f32)
        its[k] = s(smd, bsh).iterations
        solves[k] = (lambda s=s, a=smd, b=bsh: s(a, b))
    for f in spmv.values():
        f()
    ev = {k: [] for k in CASES}
    sv = {k: [] for k in CASES}
    for b in range(batches):
        for k in (CASES if b % 2 == 0 else CASES[::-1]):
            ev[k].append(sm.event_ms(spmv[k], 20))
            sv[k].append(sm.host_ms(solves[k], 3))
    with contextlib.redirect_stdout(io.StringIO()):   # JSON only
        prof = {k: sm.call_profile(spmv[k], k, "") for k in CASES}
    print(json.dumps({"events": ev, "profile": prof, "solves": sv,
                      "its": its}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--worker", action="store_true",
                    help="run one turn in A_DIR and print its JSON")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.a_dir), args.batches)
        return
    dirs = {"A": os.path.abspath(args.a_dir)}
    order = ("A",)
    if args.b_dir:
        dirs["B"] = os.path.abspath(args.b_dir)
        order = ("A", "B", "B", "A")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    runs = {t: [] for t in dirs}
    for _ in range(args.rounds):
        for tree in order:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), dirs[tree],
                 "--worker", "--batches", str(args.batches)],
                cwd=dirs[tree], capture_output=True, text=True)
            if res.returncode:
                sys.stderr.write(res.stderr)
                raise SystemExit(f"torch_sharded_ab: the turn in "
                                 f"{dirs[tree]} failed ({res.returncode})")
            runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(f"turn {tree} ({dirs[tree]}): "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    med = {}
    for tree, turns in runs.items():
        for k in CASES:
            ev = [v for t in turns for v in t["events"][k]]
            sv = [v for t in turns for v in t["solves"][k]]
            med[tree, k, "spmv"] = statistics.median(ev)
            med[tree, k, "solve"] = statistics.median(sv)
            profs = [t["profile"][k] for t in turns if t["profile"][k]]
            if profs:
                pm = {q: statistics.median(p[q] for p in profs)
                      for q in ("ms", "ops", "busy")}
                prof = (f"device {pm['ms']:.4f} ms in {pm['ops']:.2f} "
                        f"operations, busy {pm['busy'] * 100:.1f}%")
            else:
                prof = "device time not measured (no events traced)"
            print(f"{tree} {k}, sharded SpMV: events "
                  f"{med[tree, k, 'spmv']:.4f} ms per call (min "
                  f"{min(ev):.4f}, max {max(ev):.4f}, n={len(ev)}); "
                  f"profiler: {prof} [{card}]")
            print(f"{tree} {k}, sharded secded solve: "
                  f"{med[tree, k, 'solve']:.4f} ms (min {min(sv):.4f}, max "
                  f"{max(sv):.4f}, n={len(sv)}), {turns[0]['its'][k]} it "
                  f"[{card}]")
    if "B" in runs:
        for k in CASES:
            for what in ("spmv", "solve"):
                ratio = med["B", k, what] / med["A", k, what] - 1
                print(f"B over A, {k} {what}: {ratio * 100:+.1f}% [{card}]")
    print(card)


if __name__ == "__main__":
    main()
