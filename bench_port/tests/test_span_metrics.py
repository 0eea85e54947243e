"""The metrics read from the program's own span table
(``abft_sparse_cg_tpu_torch/tracing.py``, through ``bench_port/spans.py``):
their values on a fake table, None where their span is missing or the
program has no table, the spans' place in the traced window's
reduction, and a traced run on the CPU."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from bench_port import harness, spans, trace
from bench_port.tests.conftest import ROOT

from abft_sparse_cg_tpu_torch import tracing

CELL = "hpcg-104-secded.stream"
# The program's spans: those the new metrics read, and those that name
# the traced window's idle gaps.
SPANS = ["formats.assemble", "formats.encode", "formats.layout",
         "formats.scatter", "formats.checksums", "formats.build",
         "ops.upload", "solver.solve", "solver.init", "fused.args",
         "fused.launch", "fused.read", "fused.merge", "solver.guard",
         "solver.classify", "solver.resolve"]
S = 10**9   # ns per s

# (name, profiling) -> [count, total ns, self ns], as tracing keeps it.
FAKE = {
    ("formats.assemble", False): [1, 3 * S, 3 * S],
    ("formats.encode", False): [1, 2 * S, 2 * S],
    ("formats.layout", False): [1, 5 * S, 5 * S],
    ("formats.scatter", False): [2, 4 * S, 4 * S],
    ("formats.checksums", False): [2, S // 2, S // 2],
    ("formats.build", False): [1, 12 * S, S // 2],
    ("solver.solve", False): [400, 4 * S, S // 10],
    ("fused.read", False): [400, 3_800_000_000, 3_800_000_000],
    ("solver.host_reads", False): [800, 0, 0],
    # the traced window's: left out of the solve metrics
    ("solver.solve", True): [50, S, S // 10],
    ("fused.read", True): [50, S // 2, S // 2],
    ("solver.host_reads", True): [150, 0, 0],
}
# metric -> (value on FAKE, the entries it cannot do without)
METRICS = {
    "formats.assemble_s": (3.0, ["formats.assemble"]),
    "formats.encode_s": (2.0, ["formats.encode"]),
    "formats.layout_s": (5.0, ["formats.layout"]),
    "formats.scatter_s": (4.0, ["formats.scatter"]),
    "formats.checksums_s": (0.5, ["formats.checksums"]),
    "solver.host_ms": (0.5, ["solver.solve", "fused.read"]),
    "solver.host_reads": (2.0, ["solver.solve", "solver.host_reads"]),
}


def read(metric):
    cell = harness.find_cell(ROOT, CELL)
    return harness.reader(cell, metric).read(SimpleNamespace())


@pytest.fixture
def fake(monkeypatch):
    table = {k: list(v) for k, v in FAKE.items()}
    monkeypatch.setattr(tracing, "_table", table)
    return table


def test_the_new_metrics_are_in_the_benchmark():
    cell = harness.find_cell(ROOT, CELL)
    names = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(names)
    first = names.index(next(iter(METRICS)))
    assert names[first:first + len(METRICS)] == list(METRICS)


@pytest.mark.parametrize("metric", list(METRICS))
def test_a_metric_on_a_fake_table(fake, metric):
    value, needs = METRICS[metric]
    assert read(metric) == pytest.approx(value)
    for name in needs:
        for prof in (False, True):
            fake.pop((name, prof), None)
        assert read(metric) is None, name


def test_the_solve_metrics_read_only_the_untraced_solves(fake):
    for prof in (False, True):
        fake.pop(("solver.solve", prof))
    fake[("solver.solve", True)] = [50, S, S]
    assert read("solver.host_ms") is None
    assert read("solver.host_reads") is None


@pytest.mark.parametrize("metric", list(METRICS))
def test_a_program_without_the_table_gives_none(fake, monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "abft_sparse_cg_tpu_torch.tracing", None)
    assert read(metric) is None


def test_the_spans_are_host_events_that_name_idle_gaps():
    """In a profile the program's spans are CPU events (traced_solves
    puts them with the host spans, never with the device operations):
    reduce_events counts none of them as device work, and names an idle
    gap by the innermost of them."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function(trace.REQUEST):
                for name in SPANS:
                    with tracing.span(name):
                        pass
    tracing.reset()
    cpu, window, spans_at = [], None, {}
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.name in SPANS:
            assert e.device_type == DeviceType.CPU, e.name
            spans_at[e.name] = span
        if e.device_type == DeviceType.CPU:
            cpu.append(span)
        if e.name == trace.WINDOW:
            window = span[:2]
    assert set(spans_at) == set(SPANS)
    # Device operations over the whole window but the middle of one span.
    a, b, _ = spans_at["fused.merge"]
    mid = 0.5 * (a + b)
    gpu = [(window[0], mid - 0.1, "kernel"), (mid + 0.1, window[1], "copy")]
    t = trace.reduce_events(cpu, gpu, window, [50], {})
    assert set(t.by_name) == {"kernel", "copy"}
    assert set(t.gaps) == {"fused.merge"}


def test_a_traced_cpu_run_reads_the_build_phases(tiny_root):
    """The harness on the CPU (kernel B's plain loop: no ``fused.read``,
    so no ``solver.host_ms``): the five phase metrics, which with
    ``formats.build``'s self time make up ``formats.build_s``."""
    tracing.reset()
    c = harness.find_cell(tiny_root, CELL)
    r = harness.run_cell(c, 2**31 + 9, 0.2, True, torch.device("cpu"),
                         time.perf_counter()).result
    build = spans.entry(tracing.snapshot(), "formats.build")
    tracing.reset()
    m = {k: v["value"] for k, v in r["metrics"].items()}
    phases = [k for k in METRICS if k.startswith("formats.")]
    assert set(phases) <= set(m)
    assert "solver.host_ms" not in m
    inside = sum(m[k] for k in phases) + build["self_s"]
    assert inside <= m["formats.build_s"]
    assert inside == pytest.approx(m["formats.build_s"], rel=0.02)
