"""The port's span and count table (``abft_sparse_cg_tpu_torch.tracing``):
nesting and self time, counts, the profiler flag in the key, no
``record_function`` off the profiler, the spans inside a torch.profiler
trace, and the spans the host build and a CPU solve record."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from abft_sparse_cg_tpu_torch import tracing
from abft_sparse_cg_tpu_torch.backends.torch_backend import TorchBackend
from abft_sparse_cg_tpu_torch.formats import assemble, build_protected
from abft_sparse_cg_tpu_torch.ops.spmv import make_matrix_device
from abft_sparse_cg_tpu_torch.solver.fused import make_fused_solver
from abft_sparse_cg_tpu_torch.utils.matgen import spd_laplacian_2d

PHASES = ("formats.encode", "formats.layout", "formats.scatter",
          "formats.checksums")


@pytest.fixture(autouse=True)
def empty_table():
    tracing.reset()
    yield
    tracing.reset()


def table():
    """The snapshot without the profiler flag (no profiler records in
    these tests but where they say so)."""
    snap = tracing.snapshot()
    assert all(not prof for _, prof in snap)
    return {name: e for (name, _), e in snap.items()}


@pytest.fixture
def clock(monkeypatch):
    """A clock that advances 10 ns at each read."""
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: next(ticks))


@pytest.mark.parametrize("inner", ["b", "a"])
def test_self_time_is_total_less_children(clock, inner):
    # reads: a opens 0, inner opens 10 and closes 20; inner opens 30 and
    # closes 40; a closes 50
    with tracing.span("a"):
        with tracing.span(inner):
            pass
        with tracing.span(inner):
            pass
    t = table()
    if inner == "b":
        assert t["a"] == pytest.approx({"count": 1, "total_s": 50e-9,
                                        "self_s": 30e-9})
        assert t["b"] == pytest.approx({"count": 2, "total_s": 20e-9,
                                        "self_s": 20e-9})
    else:
        # A span nested in one of its own name: the totals of every
        # call, the outer one's self time less the inner ones.
        assert t["a"] == pytest.approx({"count": 3, "total_s": 70e-9,
                                        "self_s": 50e-9})


def test_a_decorated_function_is_a_span_per_call(clock):
    @tracing.span("f")
    def f(n):
        return f(n - 1) + 1 if n else 0

    assert f(2) == 2
    assert f.__name__ == "f"
    t = table()["f"]
    assert t["count"] == 3
    assert t["total_s"] > t["self_s"] > 0


def test_a_span_records_when_its_block_raises():
    with pytest.raises(KeyError):
        with tracing.span("a"):
            with tracing.span("b"):
                raise KeyError
    assert table()["b"]["count"] == table()["a"]["count"] == 1
    with tracing.span("c"):
        pass
    assert table()["c"]["self_s"] == table()["c"]["total_s"]


def test_counts_are_keyed_by_the_profiler_flag():
    tracing.count("reads")
    tracing.count("reads", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("reads", 2)
        with tracing.span("s"):
            pass
    snap = tracing.snapshot()
    assert snap[("reads", False)] == {"count": 4, "total_s": 0.0,
                                      "self_s": 0.0}
    assert snap[("reads", True)]["count"] == 2
    assert snap[("s", True)]["count"] == 1
    assert ("s", False) not in snap


def test_off_the_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(tracing, "record_function", refuse)
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    assert table()["b"]["count"] == 1


def test_under_the_profiler_the_spans_nest_in_its_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with tracing.span("a"):
                with tracing.span("b"):
                    torch.ones(4).sum()
    events = {e.name: e for e in prof.events()}
    assert events["b"].cpu_parent.name == "a"
    assert events["a"].cpu_parent.name == "outer"
    for name in ("a", "b"):
        assert tracing.snapshot()[(name, True)]["count"] == 1


def test_reset_empties_the_table():
    with tracing.span("a"):
        tracing.count("c")
    assert len(tracing.snapshot()) == 2
    tracing.reset()
    assert tracing.snapshot() == {}


def laplacian(n=24):
    rows, cols, vals, n = spd_laplacian_2d(n)
    return assemble(cols, rows, vals, n, 1)


@pytest.mark.parametrize("force_exec,kind", [(None, "dia"), ("ell", "ell"),
                                             ("flat", "flat")])
def test_the_host_build_records_each_phase(force_exec, kind):
    asm = laplacian()
    m = build_protected("csr", asm, "secded", force_exec=force_exec)
    assert m.exec_kind == kind
    t = table()
    assert t["formats.assemble"]["count"] == 1
    assert t["formats.build"]["count"] == 1
    for name in PHASES:
        assert t[name]["count"] >= 1 and t[name]["total_s"] > 0, name
    # The phases are children of the build and never of one another.
    phases = sum(t[name]["total_s"] for name in PHASES)
    assert phases <= t["formats.build"]["total_s"]
    assert phases + t["formats.build"]["self_s"] == pytest.approx(
        t["formats.build"]["total_s"])
    assert all(t[name]["self_s"] == pytest.approx(t[name]["total_s"])
               for name in PHASES)


def solver_of(kind, m):
    if kind == "fused":
        return make_fused_solver(m, "secded", 40, 1e-12), torch.float32
    return (TorchBackend("secded")._solver(m, torch.float64, 40, 1e-12,
                                           solver=kind), torch.float64)


@pytest.mark.parametrize("kind", ["standard", "pipelined", "fused"])
def test_one_cpu_solve_records_one_solve_and_one_init(kind):
    m = build_protected("csr", laplacian(), "secded")
    solve, dtype = solver_of(kind, m)
    md = make_matrix_device(m, dtype, torch.device("cpu"))
    b = torch.zeros(m.R, dtype=dtype)
    b[: m.N] = torch.from_numpy(np.random.default_rng(3).random(m.N))
    tracing.reset()
    res = solve(md, b)
    assert res.iterations > 0 and res.stats.errcode == 0
    t = table()
    assert t["solver.solve"]["count"] == 1
    assert t["solver.init"]["count"] == 1
    assert t["solver.init"]["total_s"] < t["solver.solve"]["total_s"]
