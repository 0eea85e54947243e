#!/usr/bin/env python3
"""Where kernel E's time goes: its device time per call on powerlaw-graph
-b 10 secded, whole and in parts, on one card.

    python3 scripts/torch_flat_probe.py

Builds the zoo's powerlaw-graph at -b 10 in mode secded and times kernel
E (csrc/flat_spmv_detect.cu) by CUDA events over back-to-back launches,
live (the fold plane's signals) and as the detection-free product:

  - the whole row-block plan (ops/spmv.py::flat_row_blocks), with w
    checked bit for bit against flat_product;
  - the plan's runs alone and its long-row chunks alone (w then covers
    only those rows; the signals only those blocks' slots);
  - the whole plan through a copy of the kernel whose blocks skip the
    one-launch epilogue (each block's thread 0 stores its own pw; pw and
    the trigger are then wrong): the epilogue's share.

The copy is compiled by nvcc into build/torch_flat_probe/.  Prints the
card's name and power limit as nvidia-smi gives them.  Needs one CUDA
card; exits non-zero without.
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from abft_sparse_cg_tpu_torch import _build
    from abft_sparse_cg_tpu_torch.formats import build_protected
    from abft_sparse_cg_tpu_torch.ops import spmv_cuda as sc
    from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
    from abft_sparse_cg_tpu_torch.utils.matzoo import zoo_assembled

    if not torch.cuda.is_available():
        raise SystemExit("torch_flat_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    csrc = os.path.join(ROOT, "abft_sparse_cg_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "flat_spmv_detect.cu")).read()
    cut = src.replace(
        "  finish_call(pw, bad, out, &g_arrive, fbuf, ibuf);",
        "  if (threadIdx.x == 0) {\n"
        "    out.part[blockIdx.x] = pw;\n"
        "    out.flags[blockIdx.x] = bad;\n  }")
    if cut == src:
        raise SystemExit("torch_flat_probe: the kernel's epilogue call "
                         "moved; update the replacement")
    out = os.path.join(ROOT, "build", "torch_flat_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "no_epilogue.cu"), "w") as f:
        f.write(cut)
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", csrc, "-o",
                    os.path.join(out, "libno_epilogue.so"),
                    os.path.join(out, "no_epilogue.cu")], check=True)
    fns = {"as built": _build.library("flat_spmv_detect")
           .abft_flat_spmv_detect,
           "no epilogue": ctypes.CDLL(os.path.join(
               out, "libno_epilogue.so")).abft_flat_spmv_detect}
    fns["no epilogue"].argtypes = _build._SIGNATURES["flat_spmv_detect"][
        "abft_flat_spmv_detect"]
    fns["no epilogue"].restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    m = build_protected("csr", zoo_assembled("powerlaw-graph", 10), "secded")
    md = make_matrix_device(m, torch.float32, dev)
    x = torch.zeros(m.R, device=dev)
    x[: m.N] = torch.tensor(np.random.default_rng(3).random(m.N),
                            dtype=torch.float32)
    plan = md.flat_plan
    chunk = plan[:, 1] < 0
    print(f"powerlaw-graph -b 10 secded: R {m.R}, nnz {m.nnz}, "
          f"{plan.shape[0]} blocks ({int(chunk.sum())} long-row chunks)")
    for label, spec in (("live", sc.flat_spec(m, "secded")),
                        ("product", sc.product_spec(m, "secded"))):
        sig = sc._plane_ptrs(sc._signal_planes(md, spec))
        gsrc = md.gidx if spec.gather == "gidx" else md.words[spec.gather]
        want = sc.flat_fast_plain(md, x, spec)[0]
        for variant, part, pl in (
                ("as built", "whole plan", plan),
                ("as built", "runs only", plan[~chunk]),
                ("as built", "chunks only", plan[chunk]),
                ("no epilogue", "whole plan", plan)):
            nb = pl.shape[0]
            scratch = torch.empty(2 * nb, dtype=torch.int32, device=dev)
            carry = torch.empty(32 * nb, device=dev)
            sync = torch.zeros(nb, dtype=torch.int32, device=dev)
            w = torch.empty_like(x)
            pw = torch.empty((), device=dev)
            trig = torch.empty((), dtype=torch.bool, device=dev)

            def call(fn=fns[variant]):
                rc = fn(md.values.data_ptr(), gsrc.data_ptr(),
                        sc.gather_mask(spec), md.row_ptr.data_ptr(),
                        pl.data_ptr(), nb, carry.data_ptr(),
                        sync.data_ptr(), m.R, x.data_ptr(), w.data_ptr(),
                        *sig, int(spec.use_parity),
                        int(spec.use_cksum), scratch.data_ptr(),
                        scratch.data_ptr() + 4 * nb, pw.data_ptr(),
                        trig.data_ptr(), 0,
                        torch.cuda.current_stream(dev).cuda_stream)
                _build.check(rc, "flat_spmv_detect launch")

            call()
            torch.cuda.synchronize()
            exact = (f", w bit-exact {torch.equal(w, want)}"
                     if part == "whole plan" else "")
            times = []
            for _ in range(7):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(50):
                    call()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b) / 50)
            print(f"{label:7s} {variant:11s} {part:11s} ({nb:4d} blocks): "
                  f"median {statistics.median(times):.4f} ms per call (min "
                  f"{min(times):.4f}, max {max(times):.4f}, n=7){exact} "
                  f"[{card}]")
    print(card)


if __name__ == "__main__":
    main()
