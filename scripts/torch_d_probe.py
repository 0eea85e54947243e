#!/usr/bin/env python3
"""Kernel D's tail-free loop under other blocks per SM, register limits
and schedules, on one card.

    python3 scripts/torch_d_probe.py [--batches 3] [--only SUB[,SUB]]

Builds dense-radius-3d at -b 10 (banded ELL, K 175, band 1,627: the
"window" schedule) and stencil27-shuffled at -b 10 (band 4,681: the "l2"
schedule) in secded, and times kernel D's staged stream
(csrc/fused_cg_ell.cu) by CUDA events recorded right around its
cooperative launch, at 2 and at 9 iterations with the convergence test
off (conv 0): the difference over the 7 iterations between is the device
time of one iteration.  Configurations (CONFIGS): dense-radius-3d live
and lazy CI 4, stencil27-shuffled live.

Each variant (VARIANTS) is the as-built library or a copy of
csrc/fused_cg_ell.cu with kStages or kMaxRowBlocksPerSM (the launch
bounds: 65,536 / (128 x it) registers a thread) rewritten, or with the
window's gathers made in each slab's own step (waiting for that slab
alone, one slab more in flight) instead of one slab ahead, or with a
lazy instance's unchecked passes in slabs that fill each ring stage with
value and gather slots (6 slots, 8 with two planes) instead of kSlab
slots and the stage's signal part unused, run with the
plan (solver.fused.ell_row_plan) held to at most so many blocks per SM
(ELL_MAX_BLOCKS_PER_SM) and a schedule forced or not.  Copies are
compiled by nvcc into build/torch_d_probe/, each with -Xptxas -v (each
instance's spills printed; the as-built source's registers, stack frame
and spills too).  Prints the card's name and power limit
as nvidia-smi gives them.  Needs one CUDA card; exits non-zero without.
"""

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "abft_sparse_cg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "torch_d_probe")
UPTO = (2, 9)

# (label, matrix, mode, check interval)
CONFIGS = [("dense-radius-3d -b 10 live", "dense-radius-3d", "secded", 1),
           ("dense-radius-3d -b 10 lazy CI 4", "dense-radius-3d", "secded",
            4),
           ("stencil27-shuffled -b 10 live", "stencil27-shuffled", "secded",
            1)]

# the window's gathers in the slab's own step, waiting for that slab
# alone (one slab more in flight)
IN_STEP = {
    "      cp_wait<kStages - 3>();   // this thread's copies of slabs s, s + 1":
    "      if (gat.n > 0) cp_wait<kStages - 2>(); else cp_wait<kStages - 3>();",
    "      if (s == 0) gather_slab(xc, st, gat, cnt);\n      if (s + 1 < nval)":
    "      if (gat.n > 0) gather_slab(xc, st, gat, cnt);\n"
    "      if (gat.n == 0 && s == 0) gather_slab(xc, st, gat, cnt);\n"
    "      if (gat.n == 0 && s + 1 < nval)",
    "      for (int j = 0; j < kSlab; ++j) xc[j] = xn[j];":
    "      for (int j = 0; j < kSlab; ++j) if (gat.n == 0) xc[j] = xn[j];"}

# a lazy instance's unchecked passes in slabs of S = 6 slots (8 with two
# planes) that fill each stage with value and gather slots, the signal
# part of the stage unused otherwise
WIDE = {
    "      cp16(st + kSlabWords + dst, m.gsrc + src);":
    "      cp16(st + S * kRows + dst, m.gsrc + src);",
    "                                           int r0, int nrows, int s,\n"
    "                                           bool vals, bool sig) {\n"
    "  const int k0 = s * kSlab;\n  const int q4 = nrows >> 2;\n"
    "  const int chunks = min(kSlab, m.K - k0) * q4;":
    "                                           int r0, int nrows, int s,\n"
    "                                           bool vals, bool sig, "
    "int S = kSlab) {\n"
    "  const int k0 = s * S;\n  const int q4 = nrows >> 2;\n"
    "  const int chunks = min(S, m.K - k0) * q4;",
    "__device__ __forceinline__ void gather_slab(float* xv, const uint32_t* "
    "st,\n                                            const Window& gat, "
    "int cnt) {\n#pragma unroll\n  for (int jj = 0; jj < kSlab; ++jj)\n"
    "    if (jj < cnt) xv[jj] = gat(st[kSlabWords + jj * kRows + "
    "threadIdx.x]);":
    "template <int kW>\n__device__ __forceinline__ void gather_slab(float* xv,"
    " const uint32_t* st,\n    const Window& gat, int cnt, int S) {\n"
    "#pragma unroll\n  for (int jj = 0; jj < kW; ++jj)\n"
    "    if (jj < cnt) xv[jj] = gat(st[S * kRows + jj * kRows + "
    "threadIdx.x]);",
    "  const int nsig = sig ? (m.K + kSlab - 1) / kSlab : 0;\n":
    "  const int nsig = sig ? (m.K + kSlab - 1) / kSlab : 0;\n"
    "  constexpr int kW = kSlab * (2 + kPlanes) / 2;\n"
    "  const int S = nsig ? kSlab : kW;\n",
    "    const int nval = (top + kSlab - 1) / kSlab;":
    "    const int nval = (top + S - 1) / S;",
    "r0, nrows, s, s < nval, s < nsig);": "r0, nrows, s, s < nval, s < nsig, S);",
    "sn < nsig);\n      cp_commit();\n      if (!live) continue;":
    "sn < nsig, S);\n      cp_commit();\n      if (!live) continue;",
    "    float xc[kSlab], xn[kSlab];": "    float xc[kW], xn[kW];",
    "      const int k0 = s * kSlab;\n      const int cnt = min(kSlab, n - k0);":
    "      const int k0 = s * S;\n      const int cnt = min(S, n - k0);",
    "      if (s == 0) gather_slab(xc, st, gat, cnt);\n      if (s + 1 < nval)\n"
    "        gather_slab(xn, ring + ((s + 1) % kStages) * kStageWords, gat,\n"
    "                    min(kSlab, n - k0 - kSlab));":
    "      if (s == 0) gather_slab<kW>(xc, st, gat, cnt, S);\n"
    "      if (s + 1 < nval)\n"
    "        gather_slab<kW>(xn, ring + ((s + 1) % kStages) * kStageWords, "
    "gat,\n                    min(S, n - k0 - S), S);",
    "      for (int j = 0; j < kSlab; ++j)\n        if (j < cnt)":
    "      for (int j = 0; j < kW; ++j)\n        if (j < cnt)",
    "      for (int j = 0; j < kSlab; ++j) xc[j] = xn[j];":
    "      for (int j = 0; j < kW; ++j) xc[j] = xn[j];"}

# variant -> (constants rewritten in the copy, and other text replaced,
# or None for the as-built library; the plan's most blocks per SM, or
# None; schedule forced or None)
VARIANTS = {"unchecked slabs filling the stage": (WIDE, None, None),
            "window gathered in the slab's step": (IN_STEP, None, None),
            "as built, l2": (None, None, "l2"),
            "at most 8 blocks per SM, 64 registers": (
                {"kMaxRowBlocksPerSM": 8}, 8, None),
            "at most 6 blocks per SM, 80 registers": (
                {"kMaxRowBlocksPerSM": 6}, 6, None),
            "at most 5 blocks per SM, 96 registers": (
                {"kMaxRowBlocksPerSM": 5}, 5, None),
            "stages 3": ({"kStages": 3}, None, None),
            "stages 5": ({"kStages": 5}, None, None)}


def variant_source(src, consts):
    """csrc/fused_cg_ell.cu with the named constants rewritten ({name:
    value}) and other text replaced ({old: new}), each found once."""
    for name, value in consts.items():
        if name.startswith("k"):
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
        else:
            n = src.count(name)
            src = src.replace(name, value)
        if n != 1:
            raise SystemExit(f"torch_d_probe: {name!r} not found once")
    return src


class Timed:
    """A kernel D library whose launch entry records CUDA events right
    around the cooperative launch."""

    def __init__(self, path):
        from abft_sparse_cg_tpu_torch import _build

        self.lib = ctypes.CDLL(path)
        for fn, argtypes in _build._SIGNATURES["fused_cg_ell"].items():
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = ctypes.c_int
        self.events = []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name != "abft_fused_cg_ell":
            return fn
        import torch

        def call(*args):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            rc = fn(*args)
            e.record()
            self.events.append((s, e))
            return rc
        return call


def build_variants(names):
    """{variant: (.so path, the plan's most blocks per SM, forced
    schedule, ring stages)}; prints each copy's -Xptxas -v."""
    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.solver import fused as F

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_tail_probe

    _build.build()
    src = open(os.path.join(CSRC, "fused_cg_ell.cu")).read()
    out = {"as built": (_build._out_path("fused_cg_ell"),
                        F.ELL_MAX_BLOCKS_PER_SM, None, 4)}
    jobs = {}
    for v in names:
        consts, per_sm, sched = VARIANTS[v]
        per_sm = per_sm or F.ELL_MAX_BLOCKS_PER_SM
        if consts is None:
            out[v] = (out["as built"][0], per_sm, sched, 4)
            continue
        d = os.path.join(OUT, re.sub(r"\W+", "_", v))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "fused_cg_ell.cu"), "w") as f:
            f.write(variant_source(src, consts))
        jobs[v] = d
        out[v] = (os.path.join(d, "libfused_cg_ell.so"), per_sm, sched,
                  consts.get("kStages", 4))

    def one(v):
        d = jobs[v]
        p = subprocess.run([_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v",
                            "-I", CSRC, "-o", os.path.join(
                                d, "libfused_cg_ell.so"),
                            os.path.join(d, "fused_cg_ell.cu")],
                           capture_output=True, text=True, check=True)
        lines, entry = [], None
        for line in (p.stdout + p.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry and "rows" in entry:
                lines.append(f"  {v}: {torch_tail_probe.demangle(entry)[:70]}"
                             f": spill stores {m.group(1)} B")
        return lines

    torch_tail_probe.OUT = OUT
    torch_tail_probe.CSRC = CSRC
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as ex:
        futs = [ex.submit(one, v) for v in jobs]
        rep = ex.submit(torch_tail_probe.ptxas_report, "fused_cg_ell")
        for f in futs:
            print("\n".join(f.result()))
        rep.result()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="time only the variants whose name holds one of "
                         "these comma-separated strings (and as built)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.formats import build_protected
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import ell_spec
    from abft_sparse_cg_tpu_torch.solver import fused as F
    from abft_sparse_cg_tpu_torch.solver.cg import init_state
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_d_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    only = [o for o in args.only.split(",") if o]
    names = [v for v in VARIANTS if not only or any(o in v for o in only)]
    print("ptxas -v of the as-built kernel D:")
    built = build_variants(names)
    libs = {v: Timed(p) for v, (p, _, _, _) in built.items()}
    ring_bytes = F.ell_ring_bytes

    dev, f32 = torch.device("cuda", 0), torch.float32
    keys = sorted({(c[1], c[2]) for c in CONFIGS})
    asm = {n: zoo_assembled(n, 10) for n in {k[0] for k in keys}}
    with ThreadPoolExecutor(max_workers=len(keys)) as ex:
        futs = {k: ex.submit(build_protected, "csr", asm[k[0]], k[1])
                for k in keys}
        mats = {k: f.result() for k, f in futs.items()}
    cases = {}
    for k, m in mats.items():
        bb = torch.zeros(m.R, dtype=f32)
        bb[: m.N] = torch.tensor(m.to_exec_order(
            np.random.default_rng(11).random(m.N)), dtype=f32)
        cases[k] = (m, make_matrix_device(m, f32, dev), ell_spec(m, k[1]),
                    bb.to(dev))
        print(f"{k[0]} -b 10 {k[1]}: R {m.R}, K {m.K}, band {m.band}")

    its, times = {}, {}

    def use(v):
        _build._libs["fused_cg_ell"] = libs[v]
        F._grids.clear()          # each copy's own occupancy
        F._plans.clear()
        F.ELL_MAX_BLOCKS_PER_SM = built[v][1]
        stages = built[v][3]      # the plan sizes the copy's own ring
        F.ell_ring_bytes = (lambda planes=1, k=stages:
                            ring_bytes(planes) * k // 4)

    def launch(v, cfg, upto):
        _, name, mode, ci = cfg
        m, md, spec, bb = cases[name, mode]
        use(v)
        sched = built[v][2]
        s = init_state(bb, upto)
        out = F.fused_cg_ell(md, spec, s.x.clone(), s.r.clone(),
                             s.p.clone(), s.rr, s.rz, 0, upto, 0.0,
                             torch.full_like(s.trace, float("nan")), None,
                             None, ci, schedule=sched)
        its[v, cfg, upto] = out.itr
        return libs[v].events[-1]

    order = list(libs)
    for v in order:
        use(v)
        for cfg in CONFIGS:
            m, _, spec, _ = cases[cfg[1], cfg[2]]
            try:
                plan = F.ell_plan(0, m.R, spec.band, 1, built[v][2])
            except ValueError as e:
                plan = str(e)
            print(f"{v}: {cfg[1]} {cfg[2]}: grid, schedule {plan}")
    for cfg in CONFIGS:
        for v in order:             # warm-up
            launch(v, cfg, 2)
        for k in range(args.batches):
            for v in (order if k % 2 == 0 else order[::-1]):
                for u in UPTO:
                    evs = [launch(v, cfg, u) for _ in range(3)]
                    torch.cuda.synchronize()
                    times.setdefault((v, cfg, u), []).extend(
                        s.elapsed_time(e) for s, e in evs)
    for cfg in CONFIGS:
        label = f"{cfg[0]} {cfg[2]}"
        base = None
        for v in order:
            lo, hi = (its[v, cfg, u] for u in UPTO)
            t_lo, t_hi = (statistics.median(times[v, cfg, u]) for u in UPTO)
            slope = (t_hi - t_lo) / max(1, hi - lo)
            base = slope if base is None else base
            print(f"{label:40s} {v:28s}: {lo} it {t_lo:.4f} ms, {hi} it "
                  f"{t_hi:.4f} ms (n={len(times[v, cfg, UPTO[1]])}); "
                  f"{slope * 1e3:.2f} us per iteration "
                  f"({(slope / base - 1) * 100:+.1f}% against as built) "
                  f"[{card}]")
    print(card)


if __name__ == "__main__":
    main()
