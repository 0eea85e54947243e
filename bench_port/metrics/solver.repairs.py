"""Calls of the program's span ``solver.classify`` per fault injected,
over the whole run (warm-up, traced solves and window).  One flip wants
one repair: a reading above 1 means a repair was repeated (a matrix not
carried forward, or a guard that retried) or a trigger fired with no
fault."""

from bench_port import spans


def read(ctx):
    e = spans.entry(spans.snapshot(), "solver.classify")
    if not ctx.faults or e is None:
        return None
    return e["count"] / ctx.faults
