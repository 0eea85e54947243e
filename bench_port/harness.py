"""One run of one cell: set-up, the traced window, the timed window, the
judgement and the result line.

``find_cell`` reads BENCHMARK.json and finds the cell's configuration,
traffic mix, matrix family and metric readers by name; ``run_cell`` runs
it on a device through an entry (``entry.py`` unless a test or
``control.py`` gives another).  ``run.py`` is the command around them.

The timed window is a closed loop with one client, a solver user who
waits for each solve before sending the next (as in time stepping).
Each request gets a new right-hand side b ~ U[0, 1), made on the device
from the seed and the request's index before its clock starts; its clock
stops when the host holds the solve's iteration count, r.r and ABFT
status.  x stays on the device; the answers of a sample drawn from the
seed are kept for the comparison with the reference once the window has
closed.  A traced run's window lasts the mix's ``traced_window_s`` at
most: it reports the traced solves' metrics and needs the window only
for the sample it judges.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

import torch

from . import compare, reference, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "abft_sparse_cg_tpu")
# Indices of the right-hand sides outside the timed window: warm-up
# solves count down from -1, traced solves up from TRACE_BASE.
TRACE_BASE = 1 << 40


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # BENCHMARK.json's entries; a reader that finds
    per_layer: list      # nothing to read in a cell returns None
    bench_dir: str


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, its configuration
    file and its traffic mix (``bench_dir``/traffic/<mix>.json)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic, bench["end_to_end"],
                bench["per_layer"], bench_dir)


def triangle(cell: Cell):
    """The stored triangle of the cell's matrix, from its family."""
    m = cell.config["matrix"]
    fam = _load(os.path.join(cell.bench_dir, "matrices", m["family"] + ".py"),
                f"bench_port_matrix_{m['family']}")
    return fam.triangle(**m.get("params", {}))


def reader(cell: Cell, metric: str):
    return _load(os.path.join(cell.bench_dir, "metrics", metric + ".py"),
                 "bench_port_metric_" + metric.replace(".", "_"))


class Rhs:
    """b ~ U[0, 1) float32 of the request ``index``, made on the device
    from the seed: the same seed and index give the same b."""

    def __init__(self, seed: int, n: int, device):
        self.seed, self.n, self.device = int(seed), n, device
        self.gen = torch.Generator(device=device)

    def __call__(self, index: int) -> torch.Tensor:
        h = hashlib.blake2b(f"{self.seed}:{index}".encode(), digest_size=8)
        self.gen.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
        return torch.rand(self.n, generator=self.gen, device=self.device,
                          dtype=torch.float32)


class Window(NamedTuple):
    latencies: list      # seconds of each request
    wall_s: float        # window open to the last answer
    iterations: list
    bad_status: int
    kept: list           # (index, Answer) of the sample


def closed_loop(solve, md, rhs, seconds, sample, seed, sync) -> Window:
    """Requests one after another until ``seconds`` have passed; a
    reservoir sample of ``sample`` answers, drawn from the seed, is
    kept."""
    rng = random.Random(f"sample:{seed}")
    kept, lat, its, bad = [], [], [], 0
    sync()
    t_open = time.perf_counter()
    t_last = t_open
    i = 0
    while time.perf_counter() - t_open < seconds:
        b = rhs(i)
        sync()
        t0 = time.perf_counter()
        ans = solve(md, b)
        t_last = time.perf_counter()
        lat.append(t_last - t0)
        its.append(ans.iterations)
        bad += not compare.status_ok(ans)
        if len(kept) < sample:
            kept.append((i, ans))
        else:
            j = rng.randrange(i + 1)
            if j < sample:
                kept[j] = (i, ans)
        i += 1
    return Window(lat, t_last - t_open, its, bad, kept)


def judge(cell: Cell, tri, rhs, kept, device):
    """(readings, sampled answers beyond a limit) against the reference,
    which runs on ``device`` after the program's state is freed."""
    cfg = cell.config
    a = reference.assemble(tri, cfg["num_blocks"], device)
    readings, beyond = [], 0
    for index, ans in kept:
        sol = reference.cg(a, rhs(index).to(torch.float64), cfg["max_itrs"],
                           cfg["conv"])
        r = compare.reading(ans, sol)
        readings.append(r)
        beyond += not compare.within(r, cfg["limits"])
    return readings, beyond


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: the port's name begins with the latter)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _number(v):
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


class Outcome(NamedTuple):
    result: dict         # the result line
    check_lines: list    # each compared number beside its limit


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, entry=None) -> Outcome:
    """One run of ``cell``; ``t_start`` is the process's start on the
    host clock (set-up runs from it to the first timed request)."""
    ent = entry or importlib.import_module("bench_port.entry")
    cfg, mix = cell.config, cell.traffic

    def sync():
        ent.sync(device)

    tri = triangle(cell)
    t0 = time.perf_counter()
    mat = ent.build(tri, cfg)
    t1 = time.perf_counter()
    md = ent.upload(mat, cfg, device)
    t2 = time.perf_counter()
    spans = {"formats.build": t1 - t0, "ops.upload": t2 - t1}
    solve = ent.prepare(mat, cfg, mix, device)
    del mat
    n = tri[3] * cfg["num_blocks"]
    rhs = Rhs(seed, n, device)
    for j in range(mix["warmup_solves"]):
        solve(md, rhs(-1 - j))
    sync()
    setup_s = time.perf_counter() - t_start

    tsum, bad_traced = None, 0
    if traced:
        traced_answers = []

        def run_one(j):
            ans = solve(md, rhs(TRACE_BASE + j))
            traced_answers.append(compare.status_ok(ans))
            return ans.iterations

        tsum = trace.traced_solves(run_one, mix["trace_solves"],
                                   ent.launch_counts, sync)
        bad_traced = traced_answers.count(False)

    if traced:
        seconds = min(seconds, mix["traced_window_s"])
    win = closed_loop(solve, md, rhs, seconds, mix["sample"], seed, sync)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del md, solve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings, beyond = judge(cell, tri, rhs, win.kept, device)
    bad = win.bad_status + bad_traced
    correct, checks = compare.judge(readings, bad, cfg["limits"])
    attempted = len(win.latencies) + (mix["trace_solves"] if traced else 0)
    failed = min(attempted, bad + beyond)

    ctx = SimpleNamespace(cell=cell.name, config=cfg, traffic=mix,
                          setup_s=setup_s, spans=spans, window=win,
                          trace=tsum, shape=roofline.shape(
                              tri, cfg["num_blocks"]))
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(cell, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and tsum is not None:
        dev["busy_s"] = tsum.busy_s
        dev["window_s"] = tsum.window_s
        result["breakdown"] = trace.breakdown(tsum)
    result["checks"] = {k: {"value": _number(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return Outcome(result, lines)
