#!/usr/bin/env python3
"""Where the split tail's time goes: kernel B's tail instance on arrowhead
-b 10, whole and with one tail phase cut at a time, on one card.

    python3 scripts/torch_tail_probe.py [--batches 5]

Builds the zoo's arrowhead at -b 10 (a tridiagonal DIA main part and a
dense-plan tail of T = 30 rows of span S = 81,920) in mode secded and
times kernel B's split-tail instance (csrc/fused_cg_dia.cu) by CUDA
events recorded right around its cooperative launch, at 2 and at 6
iterations (convergence threshold 0, so every launch runs to its limit;
a cut copy whose CG breaks down earlier is timed to where it stopped):
the difference over the iterations between is the device time of one
iteration.  Variants:

  - as built, and the tail-free instance on the main part alone (T = 0:
    what the tail adds is the difference);
  - copies of csrc/fused_cg_dia.cu with one tail phase cut (the dense
    rows' partials, the tail signals, the work after the first grid
    sync, ...): each variant's source replacements are listed in
    VARIANTS, and a variant whose text this tree does not hold is
    skipped.  w and pw of a cut copy are wrong; only its time counts.

Every copy is compiled by nvcc into build/torch_tail_probe/; the as-built
sources of kernels B and D are compiled once more with -Xptxas -v and
each instance's registers, stack frame and spills are printed
(scripts/torch_sass_diff.py compares the SASS of two trees' kernels).
Prints the card's name and power limit as nvidia-smi gives them.  Needs
one CUDA card; exits non-zero without.
"""

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "abft_sparse_cg_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "torch_tail_probe")
UPTO = (2, 6)

# variant -> source replacements in csrc/fused_cg_dia.cu (and the
# dia_common.cuh it includes, copied beside it).  Two designs: the
# second R-wide pass after the trigger test (a fourth grid sync), and the
# one-pass tail (AXPY terms beside the main product, outlier rows
# finished after the first sync), in the loop of its own, tail_loop
# (older trees, whose loop also served the tail-free instances, indent it
# one level deeper and are not cut).
_PW = "pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wr));"
_PW_ALWAYS = ("      if constexpr (!kTail)\n        " + _PW, "      " + _PW)
VARIANTS = {
    # the design with the second pass
    "no dense partials": [
        ("      tail_dense_partials(t, a.p, fbuf);\n",
         "      if (blockIdx.x == 0)\n"
         "        for (int c = threadIdx.x; c < t.T * t.nch; c += "
         "blockDim.x)\n"
         "          t.part[c] = 0.0f;\n")],
    "no tail signals": [
        ("      if (chk) bad |= tail_signals(t, tid, stride);\n", "")],
    "second pass, no window scan": [
        ("tail_row(t, a.p, i, __ldcg(a.w + i))", "__ldcg(a.w + i)")],
    "no second pass, sync kept": [
        _PW_ALWAYS,
        ("      // the tail terms, then pw over the complete product\n"
         "      pw_l = 0.0f;\n"
         "      for (int i = tid; i < R; i += stride) {\n"
         "        const float wr = tail_row(t, a.p, i, __ldcg(a.w + i));\n"
         "        a.w[i] = wr;\n"
         "        pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wr));\n"
         "      }\n"
         "      const float bpw2 = block_sum(pw_l, fbuf);\n"
         "      if (threadIdx.x == 0) a.part_pw[blockIdx.x] = bpw2;\n", "")],
    "no second pass, no fourth sync": [
        _PW_ALWAYS,
        ("      // the tail terms, then pw over the complete product\n"
         "      pw_l = 0.0f;\n"
         "      for (int i = tid; i < R; i += stride) {\n"
         "        const float wr = tail_row(t, a.p, i, __ldcg(a.w + i));\n"
         "        a.w[i] = wr;\n"
         "        pw_l = __fadd_rn(pw_l, __fmul_rn(__ldcg(a.p + i), wr));\n"
         "      }\n"
         "      const float bpw2 = block_sum(pw_l, fbuf);\n"
         "      if (threadIdx.x == 0) a.part_pw[blockIdx.x] = bpw2;\n"
         "      grid.sync();\n", "")],
    # the one-pass tail
    "one-pass: no dense chunks": [
        ("    tail_dense_chunk(tp, tsh, a.p, fbuf);\n",
         "    if (blockIdx.x == 0)\n"
         "      for (int c = threadIdx.x; c < tp.T * tp.nch; c += "
         "blockDim.x)\n"
         "        tp.part[c] = 0.0f;\n")],
    "one-pass: no tail signals": [
        ("    if (chk) bad |= tail_signals(tp, tid, stride);\n", "")],
    "one-pass: no AXPY terms": [
        ("tail_axpy(tp, tsh, i, wr)", "wr")],
    "one-pass: no outlier finish": [
        ("    const float pw = __fadd_rn(pw_rows, tail_finish(tp, tsh, a.w, "
         "own));",
         "    const float pw = pw_rows;\n"
         "    for (int t = 0; t < tp.T; ++t)\n"
         "      if ((own >> t) & 1ull) a.w[tsh.rows[t]] = "
         "__ldcg(tp.tmain + t);")],
    "8 blocks per SM": [
        ("__global__ void __launch_bounds__(kBlock)\n"
         "fused_cg_dia_tail_kernel(",
         "__global__ void __launch_bounds__(kBlock, kLazyBlocksPerSM)\n"
         "fused_cg_dia_tail_kernel(")],
    "one-pass: AXPY loads one at a time": [
        ("  while (m) {\n"
         "    float v[ABFT_TAIL_BATCH];\n"
         "    int ts[ABFT_TAIL_BATCH];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < ABFT_TAIL_BATCH; ++j) {\n",
         "  while (m) {\n"
         "    float v[1];\n"
         "    int ts[1];\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < 1; ++j) {\n"),
        ("#pragma unroll\n"
         "    for (int j = 0; j < ABFT_TAIL_BATCH; ++j)\n"
         "      if (ts[j] >= 0)",
         "#pragma unroll\n"
         "    for (int j = 0; j < 1; ++j)\n"
         "      if (ts[j] >= 0)")],
}


def nvcc_cmd(src, out, verbose=False):
    from abft_sparse_cg_tpu_torch import _build

    return [_build._nvcc(), *_build._FLAGS, *(["-Xptxas", "-v"] if verbose
                                              else []), "-I", CSRC, "-o",
            out, src]


def demangle(text):
    from abft_sparse_cg_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        return text
    return re.sub(r"_Z\w+", lambda m: subprocess.run(
        [tool, m.group(0)], capture_output=True, text=True).stdout.strip()
        or m.group(0), text)


def ptxas_report(name):
    """-Xptxas -v of csrc/<name>.cu: per kernel, registers, stack frame,
    spill stores and loads."""
    out = os.path.join(OUT, f"verbose_{name}.so")
    p = subprocess.run(nvcc_cmd(os.path.join(CSRC, f"{name}.cu"), out, True),
                       capture_output=True, text=True, check=True)
    entry, stack = None, ("?", "?", "?")
    for line in (p.stdout + p.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            stack = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"  {name}: {entry[:96]}: {m.group(1)} registers, stack "
                  f"{stack[0]} B, spills {stack[1]}/{stack[2]} B, smem "
                  f"{smem.group(1) if smem else 0} B")
            entry = None


def build_variants():
    """{variant: .so path}: the as-built library and each cut copy whose
    replacements all apply to this tree's sources."""
    from abft_sparse_cg_tpu_torch import _build

    _build.build()
    srcs = {n: open(os.path.join(CSRC, n)).read()
            for n in ("fused_cg_dia.cu", "dia_common.cuh")}
    jobs = {}
    for variant, cuts in VARIANTS.items():
        texts = dict(srcs)
        ok = True
        for old, new in cuts:
            where = [n for n, s in texts.items() if old in s]
            if not where:
                ok = False
                break
            texts[where[0]] = texts[where[0]].replace(old, new, 1)
        if not ok:
            print(f"  variant {variant!r}: not in this tree, skipped")
            continue
        d = os.path.join(OUT, re.sub(r"\W+", "_", variant))
        os.makedirs(d, exist_ok=True)
        for n, s in texts.items():
            with open(os.path.join(d, n), "w") as f:
                f.write(s)
        jobs[variant] = (os.path.join(d, "fused_cg_dia.cu"),
                         os.path.join(d, "libfused_cg_dia.so"))
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


class Timed:
    """A kernel B library whose launch entry records CUDA events right
    around the cooperative launch."""

    def __init__(self, path):
        from abft_sparse_cg_tpu_torch import _build

        self.lib = ctypes.CDLL(path)
        for fn, argtypes in _build._SIGNATURES["fused_cg_dia"].items():
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = ctypes.c_int
        self.events = []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name != "abft_fused_cg_dia":
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.formats import build_protected
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.ops.spmv_cuda import dia_spec
    from abft_sparse_cg_tpu_torch.solver import fused as F
    from abft_sparse_cg_tpu_torch.solver.cg import init_state
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_tail_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    print("ptxas -v of the as-built kernels B and D:")
    libs = {v: Timed(p) for v, p in build_variants().items()}

    dev, f32 = torch.device("cuda", 0), torch.float32
    m = build_protected("csr", zoo_assembled("arrowhead", 10), "secded")
    T, S = len(m.tail.dense_plan[0]), m.tail.dense_plan[2]
    print(f"arrowhead -b 10 secded: R {m.R}, main DIA offsets "
          f"{m.main.dia_offsets}, tail T {T}, S {S}, E {m.tail.exec_size}")
    print(f"cooperative grids (blocks): tail {F.fused_grid(0, 'dia', True)}"
          f", tail-free {F.fused_grid(0, 'dia')}")
    md = make_matrix_device(m, f32, dev)
    spec = dia_spec(m.main, "secded")
    tail = (md[1], F.tail_spec(m, "secded"))
    b = torch.zeros(m.R, dtype=f32)
    b[: m.N] = torch.tensor(m.to_exec_order(
        np.random.default_rng(11).random(m.N)), dtype=f32)
    s0 = init_state(b.to(dev), UPTO[1])

    runs = {v: tail for v in libs}
    runs["tail-free, main part only"] = None
    libs["tail-free, main part only"] = libs["as built"]

    def launch(variant, upto):
        lib = libs[variant]
        _build._libs["fused_cg_dia"] = lib
        F._grids.clear()     # each copy's own occupancy
        x, r, p = s0.x.clone(), s0.r.clone(), s0.p.clone()
        out = F.fused_cg_dia(md[0], spec, x, r, p, s0.rr, s0.rz, 0, upto,
                             0.0, torch.full_like(s0.trace, float("nan")),
                             runs[variant])
        if out.itr < 2 or out.trig:
            raise SystemExit(f"torch_tail_probe: {variant} at {upto}: itr "
                             f"{out.itr}, trig {out.trig}, err {out.err}")
        its[variant, upto] = out.itr
        return lib.events[-1]

    names = list(libs)
    its = {}
    times = {(v, u): [] for v in names for u in UPTO}
    for v in names:                      # warm-up
        launch(v, 2)
    for k in range(args.batches):
        for v in (names if k % 2 == 0 else names[::-1]):
            for u in UPTO:
                evs = [launch(v, u) for _ in range(3)]
                torch.cuda.synchronize()
                times[v, u] += [s.elapsed_time(e) for s, e in evs]
    base = None
    for v in names:
        lo, hi = (its[v, u] for u in UPTO)
        t_lo, t_hi = (statistics.median(times[v, u]) for u in UPTO)
        slope = (t_hi - t_lo) / (hi - lo)
        base = slope if base is None else base
        print(f"{v:34s}: {lo} it {t_lo:.4f} ms, {hi} it {t_hi:.4f} ms "
              f"(min {min(times[v, UPTO[1]]):.4f}, max "
              f"{max(times[v, UPTO[1]]):.4f}, n={len(times[v, UPTO[1]])}"
              f"{'' if (lo, hi) == UPTO else ', broke down'}); "
              f"{slope * 1e3:.2f} us per iteration "
              f"({(slope - base) * 1e3:+.2f} against as built) [{card}]")
    print(card)


if __name__ == "__main__":
    main()
