#!/usr/bin/env python3
"""Live kernel B solves of two checkouts of the PyTorch/CUDA port, in turns
on one card.

    python3 scripts/torch_live_ab.py A_DIR B_DIR [--rounds 1]

Compares the live (unpreconditioned, check interval 1) DIA solves of two
trees, e.g. a parent commit unpacked with ``git archive`` and the change
on top of it.  Each turn is one worker process started in one checkout,
with that checkout's package and kernels (built from its own csrc/ into
its own build directory, excluded from the times); the turns run A, B,
B, A per round, so that a drift of the card or host over the run falls
on both.  A worker builds the bundled matrix at -b 10 and -b 100 in
modes none and secded, solves each through ``CudaBackend(mode)._solver``
(the tier the cuda target picks: kernel B), and times full and
2-iteration solves in interleaved batches with the host clock around
synchronised calls.  The worker uses only what both trees have.

Prints, per configuration, the median solve, its spread, the slope per
iteration and the 2-iteration solve (the fixed part) of each tree over
all its turns, B over A, and the card's name and power limit as
``nvidia-smi`` gives them.  Needs one CUDA card; exits non-zero without.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CONFIGS = [("-b 10", 10, "none"), ("-b 10", 10, "secded"),
           ("-b 100", 100, "none"), ("-b 100", 100, "secded")]
CONV = 1e-3


def worker(root, batches, reps):
    """One turn in checkout ``root``: JSON of per-call ms lists."""
    sys.path.insert(0, root)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.formats import build_protected, load_matrix
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device

    if not torch.cuda.is_available():
        raise SystemExit("torch_live_ab: no CUDA device")
    _build.build()
    dev, f32 = torch.device("cuda", 0), torch.float32
    path = os.path.join(root, "matrices", "shallow_water1",
                        "shallow_water1.mtx")
    if not os.path.exists(path):
        subprocess.run([sys.executable, os.path.join(
            root, "matrices", "make_matrix.py")], check=True,
            stdout=subprocess.DEVNULL)
    asm = {b: load_matrix(path, b) for b in (10, 100)}
    with ThreadPoolExecutor(max_workers=len(CONFIGS)) as ex:
        futs = {(b, mode): ex.submit(build_protected, "csr", asm[b], mode)
                for _, b, mode in CONFIGS}
        mats = {k: f.result() for k, f in futs.items()}

    fns, its = {}, {}
    for label, b, mode in CONFIGS:
        m = mats[b, mode]
        md = make_matrix_device(m, f32, dev)
        bb = torch.zeros(m.R, dtype=f32, device=dev)
        bb[: m.N] = torch.tensor(m.to_exec_order(
            np.random.default_rng(11).random(m.N)), dtype=f32)
        for upto, suffix in ((1000, ""), (2, " @2")):
            solve = CudaBackend(mode)._solver(m, f32, upto, CONV)
            name = f"{label} {mode}{suffix}"
            its[name] = solve(md, bb).iterations      # also the warm-up
            fns[name] = (lambda s=solve, m_=md, b_=bb: s(m_, b_))

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    names = list(fns)
    out = {n: [] for n in names}
    for k in range(batches):
        for n in (names if k % 2 == 0 else names[::-1]):
            out[n].append(host_ms(fns[n]))
    print(json.dumps({"ms": out, "its": its}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--batches", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", action="store_true",
                    help="run one turn in A_DIR and print its JSON")
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.a_dir), args.batches, args.reps)
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
                 str(args.reps)], cwd=dirs[tree], capture_output=True,
                text=True)
            if res.returncode:
                sys.stderr.write(res.stderr)
                raise SystemExit(f"torch_live_ab: the turn in {dirs[tree]} "
                                 f"failed ({res.returncode})")
            runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(f"turn {tree} ({dirs[tree]}): "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    med = {}
    for tree, turns in runs.items():
        for label, _, mode in CONFIGS:
            name = f"{label} {mode}"
            full = [v for t in turns for v in t["ms"][name]]
            two = [v for t in turns for v in t["ms"][name + " @2"]]
            it, it2 = turns[0]["its"][name], turns[0]["its"][name + " @2"]
            per_turn = [statistics.median(t["ms"][name]) for t in turns]
            per_turn2 = [statistics.median(t["ms"][name + " @2"])
                         for t in turns]
            m_full, m_two = statistics.median(full), statistics.median(two)
            med[tree, name] = m_full
            print(f"{tree} {name:16s}: median {m_full:.4f} ms (min "
                  f"{min(full):.4f}, max {max(full):.4f}, n={len(full)}; "
                  f"turn medians {', '.join(f'{v:.4f}' for v in per_turn)})"
                  f", {it} it; 2-it solve {m_two:.4f} ms (turn medians "
                  f"{', '.join(f'{v:.4f}' for v in per_turn2)}); slope "
                  f"{(m_full - m_two) / max(1, it - it2):.4f} ms/it [{card}]")
    for label, _, mode in CONFIGS:
        name = f"{label} {mode}"
        # turn k of A and turn k of B ran next to each other (A B, B A)
        faster = sum(statistics.median(b["ms"][name])
                     < statistics.median(a["ms"][name])
                     for a, b in zip(runs["A"], runs["B"]))
        print(f"B over A, {name}: "
              f"{(med['B', name] / med['A', name] - 1) * 100:+.1f}%; B "
              f"faster in {faster} of {len(runs['A'])} adjacent turn pairs "
              f"[{card}]")
    print(card)


if __name__ == "__main__":
    main()
