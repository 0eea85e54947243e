#!/usr/bin/env python3
"""Where kernel B's time goes: its tail-free instances at DIA -b 10 and
-b 100, whole and with one phase of an iteration cut at a time, on one
card.

    python3 scripts/torch_b_probe.py [--batches 3] [--only SUB[,SUB]]
        [--schedules fold,three-sync] [--threshold]

Builds the bundled matrix at -b 10 and -b 100 (the tridiagonal stand-in,
DIA) in modes none and secded and times kernel B (csrc/fused_cg_dia.cu)
by CUDA events recorded right around its cooperative launch, at 2 and at
8 iterations: the difference over the 6 iterations between is the device
time of one iteration.  Configurations (CONFIGS): the live instance in
none and secded, the lazy CI 4, Jacobi and lazy Jacobi instances in
secded, at both sizes, and lazy CI 32 at -b 100.

Every library but "as built" is a copy of csrc/fused_cg_dia.cu (and the
dia_common.cuh it includes) that runs every launch to its limit: the
convergence test and the breakdown exit are cut (RUN_TO_LIMIT), so that
a copy with a phase cut, whose numbers are wrong, still runs its
iterations.  "run to limit" is that copy whole; each other variant cuts
one more phase (VARIANTS: the product pass with its signals, the
signals alone, the r1 pass, the update pass, each grid sync or barrier,
each grid reduction, the fold's halo rows) or changes the grid.  The
variants of the tree's design run (``design``: three passes per
iteration for every instance, or the tail-free row loop with its two
schedules).  The tail-free schedule the tree's launcher picks for the
matrix runs; --schedules times each configuration under each schedule
named (trees that have the choice).  --threshold times only the as-built
kernel, under both schedules, on 2-D Laplacians of growing side (offsets
+-1 and +-side; SWEEP) at about the -b 10 row count: where the fold
stops paying for its halo.

Every copy is compiled by nvcc into build/torch_b_probe/; the as-built
sources of kernels B and D are compiled once more with -Xptxas -v and
each instance's registers, stack frame and spills are printed.  Prints
the card's name and power limit as nvidia-smi gives them.  Needs one
CUDA card; exits non-zero without.
"""

import argparse
import inspect
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "abft_sparse_cg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "torch_b_probe")
UPTO = (2, 8)

# (label, blocks, mode, Jacobi, check interval)
CONFIGS = [("-b 10 live", 10, "none", False, 1),
           ("-b 10 live", 10, "secded", False, 1),
           ("-b 10 lazy CI 4", 10, "secded", False, 4),
           ("-b 10 Jacobi", 10, "secded", True, 1),
           ("-b 10 lazy Jacobi", 10, "secded", True, 4),
           ("-b 100 live", 100, "none", False, 1),
           ("-b 100 live", 100, "secded", False, 1),
           ("-b 100 lazy CI 4", 100, "secded", False, 4),
           ("-b 100 Jacobi", 100, "secded", True, 1),
           ("-b 100 lazy Jacobi", 100, "secded", True, 4),
           ("-b 100 lazy CI 32", 100, "secded", False, 32)]

# Applied (everywhere in the two files) to every copy: no convergence
# exit, no breakdown exit.
RUN_TO_LIMIT = [
    ("  while (itr < upto && rr > a.conv) {", "  while (itr < upto) {"),
    ("    if (pw <= 0.0f || !isfinite(rr1)) {\n"
     "      err = ABFT_ERR_BREAKDOWN;\n      break;\n    }\n", ""),
]

# The design a tree holds: "rows" (the tail-free loop row_loop: four
# rows per thread, the fold) or "3-pass" (one row per thread for every
# instance).
def design(src):
    return "rows" if "row_loop" in src else "3-pass"


# variant -> source replacements on top of RUN_TO_LIMIT, in csrc/
# fused_cg_dia.cu or dia_common.cuh; a variant runs on the trees of the
# design its name starts with ("run to limit" on both).
_PRODUCT = ("    for (int lo = lo0; lo < hi0; lo += kTile) {\n"
            "      const int hi = min(lo + kTile, hi0);\n"
            "      const int r = lo + t4;\n      float4 pk")
_B3 = ("      grid_reduce<false, false, false>(Sums{0.0f, 0.0f, 0}, nullptr,\n"
       "                                       nullptr, nullptr, &g_sync, gen, "
       "fbuf,\n                                       ibuf);\n")
VARIANTS = {
    "run to limit": [],
    # the three-pass design (one row per thread, grid-strided)
    "3-pass: no product pass (stencil, pw, signals)": [
        ("    for (int i = tid; i < R; i += stride) {\n"
         "      const float wr = dia_row<true>",
         "    for (int i = tid; i < 0; i += stride) {\n"
         "      const float wr = dia_row<true>")],
    "3-pass: no stencil (pw, signals kept)": [
        ("const float wr = dia_row<true>(a.vals, offs, R, a.p, i);",
         "const float wr = __ldcg(a.p + i);")],
    "3-pass: no signals": [
        ("      if (a.sig.plane != nullptr && chk)\n"
         "        bad |= dia_row_signals(a.sig, offs.n, R, i);\n    }\n"
         "    if constexpr (kTail) {",
         "    }\n    if constexpr (kTail) {")],
    "3-pass: no r1 pass": [
        ("    for (int i = tid; i < R; i += stride) {\n"
         "      const float r1 =\n",
         "    for (int i = tid; i < 0; i += stride) {\n"
         "      const float r1 =\n")],
    "3-pass: no update pass": [
        ("    for (int i = tid; i < R; i += stride) {\n"
         "      const float pv = __ldcg(a.p + i);",
         "    for (int i = tid; i < 0; i += stride) {\n"
         "      const float pv = __ldcg(a.p + i);")],
    "3-pass: no sync 1 (after the product)": [
        ("    grid.sync();\n    // 2-3. reduce", "    // 2-3. reduce")],
    "3-pass: no sync 2 (after the r1 pass)": [
        ("    grid.sync();\n    const float rr1 = grid_total",
         "    const float rr1 = grid_total")],
    "3-pass: no sync 3 (after the update)": [
        ("    grid.sync();\n  }\n  if constexpr (kLazy) {",
         "  }\n  if constexpr (kLazy) {")],
    "3-pass: no pw reduction": [
        ("      pw = grid_total(a.part_pw, fbuf);\n"
         "      if (grid_any(a.part_flag, ibuf)) {",
         "      pw = __ldcg(a.part_pw + blockIdx.x);\n"
         "      if (grid_any(a.part_flag, ibuf)) {")],
    "3-pass: no flag reduction": [
        ("      pw = grid_total(a.part_pw, fbuf);\n"
         "      if (grid_any(a.part_flag, ibuf)) {",
         "      pw = grid_total(a.part_pw, fbuf);\n"
         "      if (__ldcg(a.part_flag + blockIdx.x) < 0) {")],
    "3-pass: no rr (and rz) reduction": [
        ("    const float rr1 = grid_total(a.part_rr, fbuf);",
         "    const float rr1 = __ldcg(a.part_rr + blockIdx.x);"),
        ("    if constexpr (kPrecond) rz1 = grid_total(o.part_rz, fbuf);",
         "    if constexpr (kPrecond) rz1 = __ldcg(o.part_rz + blockIdx.x);")],
    "3-pass: no grid reductions": [
        ("      pw = grid_total(a.part_pw, fbuf);\n"
         "      if (grid_any(a.part_flag, ibuf)) {",
         "      pw = __ldcg(a.part_pw + blockIdx.x);\n"
         "      if (__ldcg(a.part_flag + blockIdx.x) < 0) {"),
        ("    const float rr1 = grid_total(a.part_rr, fbuf);",
         "    const float rr1 = __ldcg(a.part_rr + blockIdx.x);"),
        ("    if constexpr (kPrecond) rz1 = grid_total(o.part_rz, fbuf);",
         "    if constexpr (kPrecond) rz1 = __ldcg(o.part_rz + blockIdx.x);")],
    # the tail-free row loop (either schedule; the fold's stage and halo
    # are part of its product pass)
    "rows: no product pass (stage, stencil, pw, signals)": [
        (_PRODUCT, _PRODUCT.replace("lo < hi0", "lo < lo0"))],
    "rows: no stencil, no signals (stage, pw kept)": [
        ("        for (int d = 0; d < offs.n; ++d) {\n"
         "          const float4 v = ld4(a.vals",
         "        for (int d = 0; d < 0; ++d) {\n"
         "          const float4 v = ld4(a.vals")],
    "rows: no halo rows (fold)": [
        ("        for (int h = threadIdx.x; h < 2 * a.halo; h += kBlock) {",
         "        for (int h = threadIdx.x; h < 0; h += kBlock) {")],
    "rows: no signals": [
        ("      const bool sig = a.sig.plane != nullptr && chk;",
         "      const bool sig = false;")],
    "rows: no r1 pass": [
        ("    for (int r = lo0 + t4; r < hi0; r += 2 * kTile) {",
         "    for (int r = lo0 + t4; r < lo0; r += 2 * kTile) {")],
    "rows: no update pass (three-sync)": [
        ("      for (int r = lo0 + t4; r < hi0; r += kTile) {\n"
         "        const float4 pv = ld4cg(a.p + r), r1",
         "      for (int r = lo0 + t4; r < lo0; r += kTile) {\n"
         "        const float4 pv = ld4cg(a.p + r), r1")],
    "rows: no barrier 1 (pw, trigger)": [
        ("    const Sums s1 = grid_reduce<true, false, true>(\n"
         "        Sums{pw_l, 0.0f, bad}, a.part_pw, nullptr, a.part_flag, "
         "&g_sync, gen,\n        fbuf, ibuf);",
         # the signals stay live through pw; no trigger
         "    const Sums s1{__fadd_rn(pw_l, (float)bad), 0.0f, 0};")],
    "rows: no barrier 2 (rr, rz)": [
        ("    const Sums s2 = grid_reduce<true, kPrecond, false>(\n"
         "        Sums{rr_l, rz_l, 0}, a.part_rr, o.part_rz, nullptr, "
         "&g_sync, gen,\n        fbuf, ibuf);",
         "    const Sums s2{rr_l, rz_l, 0};")],
    "rows: no barrier 3 (three-sync)": [(_B3, "")],
    "rows: 8 blocks per SM": [
        ("constexpr int kRowBlocksPerSM = 4;",
         "constexpr int kRowBlocksPerSM = 8;")],
    "rows: 6 blocks per SM": [
        ("constexpr int kRowBlocksPerSM = 4;",
         "constexpr int kRowBlocksPerSM = 6;")],
    "rows: 3 blocks per SM": [
        ("constexpr int kRowBlocksPerSM = 4;",
         "constexpr int kRowBlocksPerSM = 3;")],
    "rows: 2 blocks per SM": [
        ("constexpr int kRowBlocksPerSM = 4;",
         "constexpr int kRowBlocksPerSM = 2;")],
}

# The threshold sweep (--threshold): 2-D Laplacians (offsets 0, +-1,
# +-side), replicated to about the -b 10 row count, secded live, both
# schedules: (side, blocks).
SWEEP = [(32, 800), (64, 200), (128, 50), (256, 13), (384, 6), (512, 3)]


def nvcc_cmd(src, out, verbose=False):
    from abft_sparse_cg_tpu_torch import _build

    return [_build._nvcc(), *_build._FLAGS, *(["-Xptxas", "-v"] if verbose
                                              else []), "-I", CSRC, "-o",
            out, src]


def ptxas_report(name):
    """-Xptxas -v of csrc/<name>.cu, per kernel instance (the tail
    probe's report)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_tail_probe

    torch_tail_probe.OUT = OUT
    torch_tail_probe.CSRC = CSRC
    torch_tail_probe.ptxas_report(name)


def apply(texts, cuts, strict):
    """``texts`` with each (old, new) of ``cuts`` replaced once in the
    file that holds it; None if a strict cut is missing."""
    texts = dict(texts)
    for old, new in cuts:
        where = [n for n, s in texts.items() if old in s]
        if not where:
            if strict:
                return None
            continue
        texts[where[0]] = texts[where[0]].replace(old, new, 1)
    return texts


def build_variants():
    """{variant: .so path}: the as-built library and each copy whose
    cuts all apply to this tree's sources."""
    from abft_sparse_cg_tpu_torch import _build

    _build.build()
    srcs = {n: open(os.path.join(CSRC, n)).read()
            for n in ("fused_cg_dia.cu", "dia_common.cuh")}
    base = {n: t for n, t in srcs.items()}
    for old, new in RUN_TO_LIMIT:
        base = {n: t.replace(old, new) for n, t in base.items()}
    tree = design(srcs["fused_cg_dia.cu"])
    jobs = {}
    for variant, cuts in VARIANTS.items():
        if variant != "run to limit" and not variant.startswith(tree + ":"):
            continue
        texts = apply(base, cuts, strict=True)
        if texts is None:
            print(f"  variant {variant!r}: text not found, skipped")
            continue
        d = os.path.join(OUT, re.sub(r"\W+", "_", variant))
        os.makedirs(d, exist_ok=True)
        for n, s in texts.items():
            with open(os.path.join(d, n), "w") as f:
                f.write(s)
        jobs[variant] = (os.path.join(d, "fused_cg_dia.cu"),
                         os.path.join(d, "libfused_cg_dia.so"))
    print("variants: " + ", ".join(jobs))
    with ThreadPoolExecutor(max_workers=len(jobs) + 2) as ex:
        futs = [ex.submit(subprocess.run, nvcc_cmd(src, so), check=True)
                for src, so in jobs.values()]
        reports = [ex.submit(ptxas_report, n) for n in ("fused_cg_dia",
                                                          "fused_cg_ell")]
        for f in futs + reports:
            f.result()
    out = {"as built": _build._out_path("fused_cg_dia")}
    out.update({v: so for v, (_, so) in jobs.items()})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="time only the variants whose name holds one of "
                         "these comma-separated strings")
    ap.add_argument("--schedules", default="",
                    help="comma-separated tail-free schedules to time each "
                         "configuration with (trees that have the choice; "
                         "default: the one the launcher picks)")
    ap.add_argument("--threshold", action="store_true",
                    help="time the as-built kernel on SWEEP's Laplacians "
                         "under both schedules instead")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.backends.torch_backend import jacobi_minv
    from abft_sparse_cg_tpu_torch.formats import (assemble, build_protected,
                                                  load_matrix)
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import dia_spec
    from abft_sparse_cg_tpu_torch.solver import fused as F
    from abft_sparse_cg_tpu_torch.solver.cg import init_state
    from abft_sparse_cg_tpu_torch.utils.matgen import spd_laplacian_2d
    from torch_tail_probe import Timed

    if not torch.cuda.is_available():
        raise SystemExit("torch_b_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    scheds = [None]
    if args.schedules or args.threshold:
        if "schedule" not in inspect.signature(F.fused_cg_dia).parameters:
            raise SystemExit("torch_b_probe: this tree has one schedule")
        scheds = (args.schedules.split(",") if args.schedules
                  else list(F.SCHEDULES))
    if args.threshold:
        _build.build()
        libs = {"as built": Timed(_build._out_path("fused_cg_dia"))}
    else:
        print("ptxas -v of the as-built kernels B and D:")
        only = args.only.split(",")
        libs = {v: Timed(p) for v, p in build_variants().items()
                if v == "as built" or any(o in v for o in only)}

    path = os.path.join(ROOT, "matrices", "shallow_water1",
                        "shallow_water1.mtx")
    if not os.path.exists(path):
        subprocess.run([sys.executable, os.path.join(
            ROOT, "matrices", "make_matrix.py")], check=True,
            stdout=subprocess.DEVNULL)
    dev, f32 = torch.device("cuda", 0), torch.float32
    cases = {}

    def add_case(key, a, mode):
        m = build_protected("csr", a, mode)
        md = make_matrix_device(m, f32, dev)
        bb = torch.zeros(m.R, dtype=f32)
        bb[: m.N] = torch.tensor(m.to_exec_order(
            np.random.default_rng(11).random(m.N)), dtype=f32)
        minv = torch.zeros(m.R, dtype=f32)
        minv[: m.N] = torch.tensor(m.to_exec_order(
            jacobi_minv(m, "jacobi")), dtype=f32)
        cases[key] = (m, md, dia_spec(m, mode), bb.to(dev), minv.to(dev))
        return m

    if args.threshold:
        configs = []
        for side, blocks in SWEEP:
            rows, cols, vals, n = spd_laplacian_2d(side)
            m = add_case((side, "secded"), assemble(cols, rows, vals, n,
                                                    blocks), "secded")
            print(f"Laplacian side {side} x {blocks} blocks: R {m.R}, "
                  f"{m.exec_kind}, offsets {m.dia_offsets}")
            configs.append((f"Laplacian side {side}", side, "secded",
                            False, 1))
    else:
        configs = CONFIGS
        for b in (10, 100):
            a = load_matrix(path, b)
            for mode in ("none", "secded"):
                m = add_case((b, mode), a, mode)
            print(f"-b {b}: R {m.R}, offsets {m.dia_offsets}")
    print(f"cooperative grid (blocks): live {F.fused_grid(0, 'dia')}, "
          f"Jacobi {F.fused_grid(0, 'dia', False, True)}")

    def launch(variant, cfg, sched, upto):
        _, b, mode, precond, ci = cfg
        m, md, spec, bb, minv = cases[b, mode]
        lib = libs[variant]
        _build._libs["fused_cg_dia"] = lib
        F._grids.clear()     # each copy's own occupancy
        mi = minv if precond else None
        s = init_state(bb, upto, mi)
        x, r, p = s.x.clone(), s.r.clone(), s.p.clone()
        conv = 1e-3 if variant == "as built" else 0.0
        kw = {} if sched is None else {"schedule": sched}
        out = F.fused_cg_dia(md, spec, x, r, p, s.rr, s.rz, 0, upto, conv,
                             torch.full_like(s.trace, float("nan")), None,
                             mi, ci, **kw)
        its[variant, cfg, sched, upto] = out.itr
        return lib.events[-1]

    names = list(libs)
    its = {}
    times = {}
    for cfg in configs:
        for sched in scheds:
            for v in names:                  # warm-up
                launch(v, cfg, sched, 2)
            for k in range(args.batches):
                for v in (names if k % 2 == 0 else names[::-1]):
                    for u in UPTO:
                        evs = [launch(v, cfg, sched, u) for _ in range(3)]
                        torch.cuda.synchronize()
                        times.setdefault((v, cfg, sched, u), []).extend(
                            s.elapsed_time(e) for s, e in evs)
    for cfg in configs:
        for sched in scheds:
            label = f"{cfg[0]} {cfg[2]}" + (f" [{sched}]" if sched else "")
            base = None
            for v in names:
                lo, hi = (its[v, cfg, sched, u] for u in UPTO)
                t_lo, t_hi = (statistics.median(times[v, cfg, sched, u])
                              for u in UPTO)
                slope = (t_hi - t_lo) / max(1, hi - lo)
                if v == "run to limit":
                    base = slope
                rel = ("" if base is None or v == "as built"
                       else f" ({(slope - base) * 1e3:+.2f} against run to "
                            f"limit)")
                print(f"{label:36s} {v:52s}: {lo} it {t_lo:.4f} ms, {hi} it "
                      f"{t_hi:.4f} ms (n={len(times[v, cfg, sched, UPTO[1]])}"
                      f"); {slope * 1e3:.2f} us per iteration{rel} [{card}]")
    print(card)


if __name__ == "__main__":
    main()
