"""The harness finds what later changes add as files alone; its process
loads nothing of JAX; without a card it prints no result."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from bench_port import harness, trace
from .conftest import ROOT, small_config

NEW_CELL = textwrap.dedent('''
    import json, sys, time
    sys.path[:0] = [{tmp!r}, {root!r}]
    import torch
    from bench_port import harness
    cell = harness.find_cell({tmp!r}, "band5-b1-sec8.steady")
    out = harness.run_cell(cell, 7, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    print(json.dumps(out.result))
''')


def test_new_cell_config_mix_metric_and_family_are_files_alone(tmp_path):
    """A later change adds a matrix family, a configuration, a traffic
    mix, an end-to-end metric and a cell as new files and entries; the
    harness, copied unchanged, runs the new cell."""
    tmp = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    os.path.join(tmp, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bp = os.path.join(tmp, "bench_port")
    with open(os.path.join(bp, "matrices", "band5.py"), "w") as f:
        f.write(textwrap.dedent('''
            import numpy as np

            def triangle(n=512):
                i = np.arange(n)
                rows = np.concatenate([i] + [i[d:] for d in (1, 2)])
                cols = np.concatenate([i] + [i[:-d] for d in (1, 2)])
                vals = np.where(rows == cols, 6.0, -1.0)
                return rows, cols, vals, n
        '''))
    cfg = small_config(os.path.join(ROOT, "bench_port", "configs",
                                    "hpcg-104-secded.json"))
    cfg.update(name="band5-b1-sec8", mode="sec8", num_blocks=1,
               max_itrs=1000, conv=1e-3,
               matrix={"family": "band5", "params": {"n": 1024}})
    with open(os.path.join(bp, "configs", "band5-b1-sec8.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bp, "traffic", "steady.json"), "w") as f:
        json.dump({"check_interval": 4, "warmup_solves": 1, "sample": 3,
                   "trace_solves": 2, "traced_window_s": 1}, f)
    with open(os.path.join(bp, "metrics", "solves_per_s.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return len(ctx.window.latencies) / ctx.window.wall_s\n")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "band5-b1-sec8", "source": "x",
                             "file": "bench_port/configs/band5-b1-sec8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "band5-b1-sec8.steady",
                               "config": "band5-b1-sec8",
                               "traffic": "steady", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "solves_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = subprocess.run([sys.executable, "-c",
                          NEW_CELL.format(tmp=tmp, root=ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert set(r["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s",
                                 "solves_per_s"}


NO_JAX = textwrap.dedent('''
    import json, sys, time
    sys.path.insert(0, {root!r})
    import torch
    from bench_port import control, harness
    cell = harness.find_cell({tiny!r}, "hpcg-104-secded.lazy32")
    harness.run_cell(cell, 3, 0.1, True, torch.device("cpu"),
                     time.perf_counter())
    print(json.dumps([harness.forbidden_modules(),
                      sorted({{m.split(".")[0] for m in sys.modules}})]))
''')


def test_the_benchmark_process_loads_nothing_of_jax(tiny_root):
    out = subprocess.run([sys.executable, "-c",
                          NO_JAX.format(root=ROOT, tiny=tiny_root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    forbidden, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert "abft_sparse_cg_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "abft_sparse_cg_tpu"} & set(tops)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "abft_sparse_cg_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "abft_sparse_cg_tpu.cli", sys)
    assert harness.forbidden_modules() == ["abft_sparse_cg_tpu", "jax"]


def test_without_a_card_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "hpcg-104-secded.stream", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_trace_reduction():
    cpu = [(0, 100, trace.WINDOW), (0, 40, trace.REQUEST),
           (45, 100, trace.REQUEST), (26, 49, "cudaStreamSynchronize"),
           (40, 45, "aten::copy_")]
    gpu = [(5, 20, "void fused_cg_dia_rows<...>"), (15, 25, "memcpy"),
           (50, 90, "void fused_cg_dia_rows<...>"), (95, 120, "late")]
    t = trace.reduce_events(cpu, gpu, (0, 100), [9, 9],
                            {"fused_cg_dia": 2})
    assert t.complete
    assert t.busy_s == pytest.approx((20 + 40 + 5) * 1e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.by_name["void fused_cg_dia_rows<...>"] == pytest.approx(55e-6)
    # Idle 0-5 and 90-95 inside a request; 25-50 is labelled by the
    # innermost host span at its middle, the synchronize.
    assert t.gaps == pytest.approx({trace.REQUEST: 10e-6,
                                    "cudaStreamSynchronize": 25e-6})
    assert trace.reduce_events(cpu, gpu, (0, 100), [9, 9],
                               {"fused_cg_dia": 3}).complete is False
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["void fused_cg_dia_rows<...>",
                                  pytest.approx(55e-6)]
    assert len(b["idle_gaps"]) <= 10


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each cell on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("hpcg-104-secded.stream", "hpcg-104-secded.lazy32"):
        out = subprocess.run([sys.executable, "bench_port/run.py",
                              "--workload", cell, "--seed", "2147483650",
                              "--seconds", "2", "--trace", "1"], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] and r["failed"] == 0
        assert {"kernels.hbm_pct", "device.idle_pct"} <= set(r["metrics"])
