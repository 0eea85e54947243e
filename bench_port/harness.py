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

Each answer carries the device matrix its solve ended on, and the next
request gets that one: after a repair the scrubbed copy, never the
matrix that was handed in.  A mix with ``fault_every`` also carries
fault traffic (``Faults``): before timed request i with i % fault_every
== fault_every - 1 (traced solve j by the same rule on j, and before the
last warm-up solve, so that the first repair's cold costs fall in
set-up), ``fault_flips`` bits of one stored element are flipped in the
resident matrix, the element and the bits drawn from the seed and the
request's index, outside the request's clock.  Such a request is judged
by the configuration's guarantee (``compare.sound``): the flip corrected
where it was made.  Half of the sample is then drawn from the faulted
requests and half from the others, each by a reservoir of its own, and
at the window's close every resident plane is compared, bit for bit,
with a device copy taken before the first fault.  A mix without those
keys draws and injects nothing, and hands the same matrix object from
request to request.
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

import numpy as np
import torch

from . import compare, reference, roofline, spans, trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "abft_sparse_cg_tpu")
# Indices of the right-hand sides outside the timed window: warm-up
# solves count down from -1, traced solves up from TRACE_BASE.
TRACE_BASE = 1 << 40
# inject.py::bitflip_region's bit ranges of a CSR96 codeword, by kind.
CSR_REGIONS = {"ANY": (0, 96), "VALUE": (0, 64), "INDEX": (64, 96)}


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


def _hashed(key: str) -> int:
    h = hashlib.blake2b(key.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


class Rhs:
    """b ~ U[0, 1) float32 of the request ``index``, made on the device
    from the seed: the same seed and index give the same b."""

    def __init__(self, seed: int, n: int, device):
        self.seed, self.n, self.device = int(seed), n, device
        self.gen = torch.Generator(device=device)

    def __call__(self, index: int) -> torch.Tensor:
        self.gen.manual_seed(_hashed(f"{self.seed}:{index}"))
        return torch.rand(self.n, generator=self.gen, device=self.device,
                          dtype=torch.float32)


def stored_entries(tri, num_blocks: int) -> int:
    """Entries of the whole matrix: the stored triangle mirrored off the
    diagonal, the block repeated ``num_blocks`` times."""
    rows, cols = np.asarray(tri[0]), np.asarray(tri[1])
    return (len(rows) + int(np.count_nonzero(rows != cols))) * num_blocks


class Faults:
    """The mix's fault traffic on one run.  ``before(md, index, pos)``
    flips, when ``pos`` is due, ``fault_flips`` bits in the region
    ``fault_kind`` of one stored element of ``md``, drawn from the seed
    and ``index`` in ``inject.py::inject_bitflips``'s order (the element
    in [0, nnz), then each bit), through the entry's ``inject``; it
    returns the matrix and what the answer must report: (exec slot, bit),
    or None where no fault was made.  ``make`` makes one whatever the
    position."""

    def __init__(self, mix: dict, seed: int, nnz: int, inject):
        self.every = int(mix["fault_every"])
        self.flips = int(mix["fault_flips"])
        if self.flips != 1:
            raise ValueError("only single flips are judged: secded "
                             "corrects them where they are made")
        if inject.nnz != nnz:
            raise ValueError(f"the program stores {inject.nnz} entries, "
                             f"the triangle makes {nnz}")
        self.region = CSR_REGIONS[mix["fault_kind"]]
        self.seed, self.nnz, self.inject = int(seed), nnz, inject
        self.count = 0

    def due(self, pos: int) -> bool:
        return pos % self.every == self.every - 1

    def draw(self, index: int):
        """(element, bits) of the fault before request ``index``."""
        rng = np.random.default_rng(_hashed(f"{self.seed}:fault:{index}"))
        element = int(rng.integers(0, self.nnz))
        bits = [int(rng.integers(*self.region)) for _ in range(self.flips)]
        return element, bits

    def make(self, md, index: int):
        element, bits = self.draw(index)
        md = self.inject(md, element, bits)
        self.count += 1
        return md, (self.inject.slot(element), bits[0])

    def before(self, md, index: int, pos: int):
        return self.make(md, index) if self.due(pos) else (md, None)


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``tag``."""

    def __init__(self, size: int, tag: str):
        self.size, self.rng = size, random.Random(tag)
        self.seen, self.kept = 0, []

    def offer(self, item):
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


class Window(NamedTuple):
    latencies: list      # seconds of each request
    wall_s: float        # window open to the last answer
    iterations: list
    bad_status: int      # answers that break the guarantee (compare.sound)
    kept: list           # (index, Answer without its matrix) of the sample
    faulted: list        # whether each request was preceded by a fault


def closed_loop(solve, md, rhs, seconds, sample, seed, sync, faults=None):
    """Requests one after another until ``seconds`` have passed, each
    handed the matrix the one before ended on; a reservoir sample of
    ``sample`` answers, drawn from the seed, is kept (with ``faults``,
    half of it from the faulted requests).  Returns the Window and the
    matrix the last request ended on."""
    if faults is None:
        pools = {False: Reservoir(sample, f"sample:{seed}")}
    else:
        pools = {False: Reservoir(sample - sample // 2,
                                  f"sample:{seed}:clean"),
                 True: Reservoir(sample // 2, f"sample:{seed}:faulted")}
    lat, its, hit, bad = [], [], [], 0
    sync()
    t_open = time.perf_counter()
    t_last = t_open
    i = 0
    while time.perf_counter() - t_open < seconds:
        b = rhs(i)
        expect = None
        if faults is not None:
            md, expect = faults.before(md, i, i)
        sync()
        t0 = time.perf_counter()
        ans = solve(md, b)
        t_last = time.perf_counter()
        md = ans.md
        lat.append(t_last - t0)
        its.append(ans.iterations)
        hit.append(expect is not None)
        bad += not compare.sound(ans, expect)
        pools[hit[-1]].offer((i, ans._replace(md=None)))
        i += 1
    kept = [k for pool in pools.values() for k in pool.kept]
    return Window(lat, t_last - t_open, its, bad, kept, hit), md


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
    host_spans = {"formats.build": t1 - t0, "ops.upload": t2 - t1}
    solve = ent.prepare(mat, cfg, mix, device)
    faults = pristine = None
    if "fault_every" in mix:
        faults = Faults(mix, seed, stored_entries(tri, cfg["num_blocks"]),
                        ent.Injector(mat, cfg))
        pristine = {k: p.clone() for k, p in ent.planes(md).items()}
    del mat
    n = tri[3] * cfg["num_blocks"]
    rhs = Rhs(seed, n, device)
    warm = mix["warmup_solves"]
    for j in range(warm):
        if faults is not None and j == warm - 1:
            md, _ = faults.make(md, -1 - j)
        md = solve(md, rhs(-1 - j)).md
    sync()
    setup_s = time.perf_counter() - t_start

    tsum, bad_traced = None, 0
    if traced:
        traced_answers = []
        held = [md]

        def run_one(j):
            m, expect = held[0], None
            if faults is not None:
                m, expect = faults.before(m, TRACE_BASE + j, j)
            ans = solve(m, rhs(TRACE_BASE + j))
            held[0] = ans.md
            traced_answers.append(compare.sound(ans, expect))
            return ans.iterations

        tsum = trace.traced_solves(run_one, mix["trace_solves"],
                                   ent.launch_counts, sync)
        md = held.pop()
        bad_traced = traced_answers.count(False)

    if traced:
        seconds = min(seconds, mix["traced_window_s"])
    table_at_open = spans.snapshot()
    win, md = closed_loop(solve, md, rhs, seconds, mix["sample"], seed,
                          sync, faults)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    unrepaired = None
    if pristine is not None:
        now = ent.planes(md)
        unrepaired = sum(k not in now or not torch.equal(p, now[k])
                         for k, p in pristine.items())
        unrepaired += len(now.keys() - pristine.keys())
        del now, pristine
    del md, solve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings, beyond = judge(cell, tri, rhs, win.kept, device)
    bad = win.bad_status + bad_traced
    correct, checks = compare.judge(readings, bad, cfg["limits"], unrepaired)
    attempted = len(win.latencies) + (mix["trace_solves"] if traced else 0)
    failed = min(attempted, bad + beyond)

    ctx = SimpleNamespace(cell=cell.name, config=cfg, traffic=mix,
                          setup_s=setup_s, spans=host_spans, window=win,
                          trace=tsum, shape=roofline.shape(
                              tri, cfg["num_blocks"]),
                          faults=None if faults is None else faults.count,
                          table_at_open=table_at_open)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
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
