"""Host time per repair, in ms: the program's span ``solver.classify``
(ops/spmv.py::make_spmv's classify: check_and_correct over the widened
word planes, the scrub's re-derived planes and checksums, its host
reads) over the calls made in the timed window, while no profiler
recorded.  The warm-up's repair, the first and cold one, and the traced
solves' are left out.  The span ends at classify's return: device work
it launched after its last host read ends inside the next span."""

from bench_port import spans


def read(ctx):
    now = spans.entry(spans.snapshot(), "solver.classify", False)
    before = spans.entry(ctx.table_at_open, "solver.classify", False)
    if now is None:
        return None
    count, total = now["count"], now["total_s"]
    if before is not None:
        count, total = count - before["count"], total - before["total_s"]
    return total / count * 1e3 if count > 0 else None
