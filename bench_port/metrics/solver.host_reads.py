"""Blocking device-to-host reads per solve: the program's count
``solver.host_reads`` (the whole-solve path's reads of a launch's
outputs, of the lazy snapshot's iteration and of the repair check's
baseline compare) over its spans ``solver.solve``, both made while no
profiler recorded: the warm-up solves and a traced run's timed window.
Read at the end of a traced run."""

from bench_port import spans


def read(ctx):
    t = spans.snapshot()
    solve = spans.entry(t, "solver.solve", False)
    reads = spans.entry(t, "solver.host_reads", False)
    if solve is None or reads is None or not solve["count"]:
        return None
    return reads["count"] / solve["count"]
