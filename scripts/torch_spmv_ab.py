#!/usr/bin/env python3
"""Per-call times of kernels A, C and E (and their detection-free products
and C's halo form) in one or two checkouts of the PyTorch/CUDA port, in
turns on one card.

    python3 scripts/torch_spmv_ab.py A_DIR [B_DIR] [--rounds 1]

Each turn is one worker process started in one checkout, with that
checkout's package and kernels (built from its own csrc/ into its own
build directory, excluded from the times).  With two checkouts the turns
run A, B, B, A per round, so that a drift of the card or host falls on
both; with one, A once per round.

A worker builds the bundled matrix at -b 10 (DIA: kernel A), the zoo's
powerlaw-graph -b 10 (flat: kernel E) and dense-radius-3d -b 10 (ELL:
kernel C, R aligned to 4096 rows as the sharded tier needs) in mode
secded, and times what the solvers call: ``make_cuda_spmv(m).fast_pw``
(live detection) and ``make_cuda_product(m).fast_pw`` (the lazy
schedule's product), beside the bare ``A @ x`` of a
torch.sparse_csr_tensor of the same matrix (w only, no checks; the port
never calls it); on band+random-1pct -b 10 secded, kernel C on the band
split's ELL main part (live and the detection-free product) and kernel E
on its flat tail, and the split's whole product; on dense-radius-3d, kernel C's halo form on shard 1 of 4
(through ``ell_launcher`` where the tree has it, else ``ell_fast_halo``)
beside that shard's ``A @ x_ext``, and the 4-shard sharded SpMV:

  - per call by CUDA events, 20 back-to-back calls per batch, batches in
    turns (host gaps between launches count);
  - per call under a torch.profiler window of 50 warm calls: the device
    time by kernel name, the device operations per call, and the device's
    busy share of the window (the profiler's host overhead stretches the
    window, so the share is a lower bound);
  - the flat path's solves (powerlaw-graph and band+random-1pct -b 10,
    none and secded, the per-iteration tier) and the sharded dense-
    radius-3d -b 10 secded solve (4 shards of the card), by host clock,
    batches of 3 solves in turns.

Prints each number per tree (medians over its turns), B over A, and the
card's name and power limit as ``nvidia-smi`` gives them.  The worker
uses only what both trees have.  Needs one CUDA card; exits non-zero
without.
"""

import argparse
import contextlib
import inspect
import io
import json
import os
import statistics
import subprocess
import sys
import time

CONV = 1e-3
SOLVES = ("powerlaw-graph none", "powerlaw-graph secded",
          "band+random-1pct none", "band+random-1pct secded",
          "dense-radius-3d sharded secded")


def smoke_helpers():
    """This tree's chip_smoke.py, loaded by path (its module level
    imports only the standard library): ``csr_yardstick``,
    ``call_profile``, ``event_ms`` and ``host_ms`` time both trees."""
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
    from abft_sparse_cg_tpu_torch.backends.cuda_backend import CudaBackend
    from abft_sparse_cg_tpu_torch.formats import build_protected, load_matrix
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.ops import spmv_cuda
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import (
        fast_spec, make_cuda_product, make_cuda_spmv)
    from abft_sparse_cg_tpu_torch.parallel.sharded import (
        _device_put_sharded, default_mesh, make_sharded_solver)
    from abft_sparse_cg_tpu_torch.parallel.sharded_kernel import (
        _halo, halo_exchange, make_shardmap_spmv)
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_spmv_ab: no CUDA device")
    sm = smoke_helpers()
    _build.build()
    dev, f32 = torch.device("cuda", 0), torch.float32
    path = os.path.join(root, "matrices", "shallow_water1",
                        "shallow_water1.mtx")
    if not os.path.exists(path):
        subprocess.run([sys.executable, os.path.join(
            root, "matrices", "make_matrix.py")], check=True,
            stdout=subprocess.DEVNULL)
    asm = {"dia": load_matrix(path, 10),
           "powerlaw-graph": zoo_assembled("powerlaw-graph", 10),
           "band+random-1pct": zoo_assembled("band+random-1pct", 10),
           "dense-radius-3d": zoo_assembled("dense-radius-3d", 10)}
    want = [("dia", "secded"), ("dense-radius-3d", "secded")] + [
        (n, mode) for n in ("powerlaw-graph", "band+random-1pct")
        for mode in ("none", "secded")]
    with ThreadPoolExecutor(max_workers=len(want)) as ex:
        futs = {k: ex.submit(build_protected, "csr", asm[k[0]], k[1],
                             row_align=(4096 if k[0] == "dense-radius-3d"
                                        else None))
                for k in want}
        mats = {k: f.result() for k, f in futs.items()}

    def xvec(m):
        x = torch.zeros(m.R, dtype=f32, device=dev)
        x[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                                dtype=f32)
        return x

    fns, yard = {}, {}
    for key, layout in (("A", "dia"), ("C", "dense-radius-3d"),
                        ("E", "powerlaw-graph")):
        m = mats[layout, "secded"]
        md, x = make_matrix_device(m, f32, dev), xvec(m)
        live = make_cuda_spmv(m, f32, "secded").fast_pw
        prod = make_cuda_product(m, f32, "secded").fast_pw
        fns[f"{key} secded"] = (lambda f=live, a=md, b=x: f(a, b))
        fns[f"{key} product"] = (lambda f=prod, a=md, b=x: f(a, b))
        a_csr, _ = sm.csr_yardstick(md, fast_spec(m, "secded"))
        xcol = x[:, None]
        yard[f"{key} A @ x"] = (lambda a=a_csr, b=xcol: a @ b)
    # The band split's flat tail (kernel E, 76,600 entries over 819,200
    # rows) and the split's whole product (kernel C on the main, E on the
    # tail), as the per-iteration tier calls them.
    m = mats["band+random-1pct", "secded"]
    md, x = make_matrix_device(m, f32, dev), xvec(m)
    tail = make_cuda_spmv(m.tail, f32, "secded").fast_pw
    split = make_cuda_spmv(m, f32, "secded").fast_pw
    main = make_cuda_spmv(m.main, f32, "secded").fast_pw
    fns["E tail secded"] = (lambda f=tail, a=md[1], b=x: f(a, b))
    main_p = make_cuda_product(m.main, f32, "secded").fast_pw
    fns["C main secded"] = (lambda f=main, a=md[0], b=x: f(a, b))
    fns["C main product"] = (lambda f=main_p, a=md[0], b=x: f(a, b))
    fns["C+E split secded"] = (lambda f=split, a=md, b=x: f(a, b))
    a_csr, _ = sm.csr_yardstick(md[0], fast_spec(m.main, "secded"))
    yard["C main A @ x"] = (lambda a=a_csr, b=x[:, None]: a @ b)
    # Kernel C's halo form on shard 1 of 4, and the sharded SpMV.
    m = mats["dense-radius-3d", "secded"]
    mesh = default_mesh(4, dev)
    smd, xs, _ = _device_put_sharded(
        m, np.random.default_rng(3).random(m.N), mesh, f32)
    H, R_loc = _halo(m), m.R // 4
    spec = fast_spec(m, "secded")
    if "out" in inspect.signature(halo_exchange).parameters:
        ext1 = halo_exchange(xs, H)[1]          # xs: a ShardedVector
    else:
        ext1 = halo_exchange(xs, mesh, H)[1]    # trees before per-shard x
    md1 = smd.shards[1]
    if hasattr(spmv_cuda, "ell_launcher"):
        one = spmv_cuda.ell_launcher(md1, spec, dev, H, R_loc)
        fns["C halo shard 1"] = (lambda f=one, e=ext1: f(e))
    else:
        fns["C halo shard 1"] = (lambda e=ext1: spmv_cuda.ell_fast_halo(
            md1, e, spec, H, R_loc))
    s_csr = sm.shard_yardstick(md1, spec, H, R_loc)
    yard["C halo A @ x_ext"] = (lambda a=s_csr, b=ext1[:, None]: a @ b)
    sh = make_shardmap_spmv(m, mesh).fast_pw
    fns["ELL sharded SpMV"] = (lambda f=sh, a=smd, b=xs: f(a, b))

    timed = {**fns, **yard}
    names = list(timed)
    for n in names:
        timed[n]()
    ev = {n: [] for n in names}
    for k in range(batches):
        for n in (names if k % 2 == 0 else names[::-1]):
            ev[n].append(sm.event_ms(timed[n], 20))
    with contextlib.redirect_stdout(io.StringIO()):   # JSON only
        prof = {n: sm.call_profile(timed[n], n, "") for n in names}

    solves, its = {}, {}
    m = mats["dense-radius-3d", "secded"]
    bb = np.random.default_rng(11).random(m.N)
    smd, bsh, _ = _device_put_sharded(m, bb, mesh, f32)
    s_sh = make_sharded_solver(m, mesh, 1000, CONV, f32)
    its["dense-radius-3d sharded secded"] = s_sh(smd, bsh).iterations
    solves["dense-radius-3d sharded secded"] = (
        lambda s=s_sh, a=smd, b=bsh: s(a, b))
    for label in SOLVES[:4]:
        name, mode = label.rsplit(" ", 1)
        m = mats[name, mode]
        md = make_matrix_device(m, f32, dev)
        bb = torch.zeros(m.R, dtype=f32, device=dev)
        bb[: m.N] = torch.tensor(m.to_exec_order(
            np.random.default_rng(11).random(m.N)), dtype=f32)
        solve = CudaBackend(mode)._solver(m, f32, 1000, CONV)
        its[label] = solve(md, bb).iterations
        solves[label] = (lambda s=solve, a=md, b=bb: s(a, b))
    sv = {n: [] for n in SOLVES}
    for k in range(batches):
        for n in (SOLVES if k % 2 == 0 else SOLVES[::-1]):
            sv[n].append(sm.host_ms(solves[n], 3))
    print(json.dumps({"events": ev, "profile": prof, "solves": sv,
                      "its": its}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--batches", type=int, default=7)
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
                raise SystemExit(f"torch_spmv_ab: the turn in {dirs[tree]} "
                                 f"failed ({res.returncode})")
            runs[tree].append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(f"turn {tree} ({dirs[tree]}): "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    med = {}
    for tree, turns in runs.items():
        for name in turns[0]["events"]:
            ev = [v for t in turns for v in t["events"][name]]
            med[tree, name] = statistics.median(ev)
            profs = [t["profile"][name] for t in turns if t["profile"][name]]
            per_name = {}
            for pr in profs:
                for k, ms in pr["by_name"].items():
                    per_name.setdefault(k, []).append(ms)
            ops = statistics.median(pr["ops"] for pr in profs) if profs else 0
            busy = (statistics.median(pr["busy"] for pr in profs)
                    if profs else 0)
            dev_ms = (statistics.median(pr["ms"] for pr in profs)
                      if profs else float("nan"))
            print(f"{tree} {name:12s}: events {med[tree, name]:.4f} ms per "
                  f"call (min {min(ev):.4f}, max {max(ev):.4f}, n={len(ev)});"
                  f" profiler: device {dev_ms:.4f} ms per call in "
                  f"{ops:.2f} device operations, busy {busy * 100:.1f}% of "
                  f"the window [{card}]")
            for k, v in sorted(per_name.items(),
                               key=lambda kv: -statistics.median(kv[1])):
                print(f"    {statistics.median(v):.4f} ms  {k[:70]}")
        for name in SOLVES:
            sv = [v for t in turns for v in t["solves"][name]]
            med[tree, name] = statistics.median(sv)
            print(f"{tree} {name:24s}: solve {med[tree, name]:.4f} ms "
                  f"(min {min(sv):.4f}, max {max(sv):.4f}, n={len(sv)}), "
                  f"{turns[0]['its'][name]} it [{card}]")
    if "B" in runs:
        for name in [*runs["A"][0]["events"], *SOLVES]:
            print(f"B over A, {name}: "
                  f"{(med['B', name] / med['A', name] - 1) * 100:+.1f}% "
                  f"[{card}]")
    print(card)


if __name__ == "__main__":
    main()
