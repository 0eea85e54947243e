"""The program's own span and count table (``abft_sparse_cg_tpu_torch/
tracing.py``), for the metrics measured inside the program.

The readers read it at the end of a run.  The table is keyed by
``(name, profiling)``: ``profiling`` is true for what was recorded while
a torch.profiler recorded, here the traced window's 50 solves.  A
program without the table (one older than its tracing module) gives
None, and so does a span or count it never recorded: the metric is then
left out of the result line.
"""


def snapshot():
    """The table, or None where the program has none."""
    try:
        import abft_sparse_cg_tpu_torch.tracing as tracing
    except ImportError:
        return None
    return tracing.snapshot()


def entry(table, name, profiling=None):
    """``{"count", "total_s", "self_s"}`` of ``name``, recorded with
    ``profiling`` as given, or summed over both; None where absent."""
    if table is None:
        return None
    found = [e for (n, p), e in table.items()
             if n == name and (profiling is None or p == profiling)]
    if not found:
        return None
    return {k: sum(e[k] for e in found) for k in found[0]}


def total_s(name):
    """Seconds of every span ``name`` of the run."""
    e = entry(snapshot(), name)
    return None if e is None else e["total_s"]
