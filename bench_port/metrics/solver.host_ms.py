"""Host time per solve, in ms: the program's span ``solver.solve`` less
its ``fused.read`` (the wait for kernel B's outputs), over the solves
made while no profiler recorded.  Those are the warm-up solves and a
traced run's timed window (3 s, some 330 solves), not the 50 traced
solves, whose spans the profiler stretches.  The first warm-up solve
starts cold (kernel modules loaded, buffers allocated: 34 ms of host
time on one H100 host against ~1.1 ms later), which adds ~0.1 ms to the
mean.  Read at the end of a traced run; None where the program records
no ``fused.read`` (no whole-solve kernel ran)."""

from bench_port import spans


def read(ctx):
    t = spans.snapshot()
    solve = spans.entry(t, "solver.solve", False)
    wait = spans.entry(t, "fused.read", False)
    if solve is None or wait is None or not solve["count"]:
        return None
    return (solve["total_s"] - wait["total_s"]) / solve["count"] * 1e3
