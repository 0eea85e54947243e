"""The port's spans and counts: one in-memory table, on the profiler's
clock when a profiler records.

``span(name)`` times a block and ``count(name, n)`` adds to a count, both
into one table keyed by ``(name, profiling)``, where ``profiling`` says
whether a ``torch.profiler`` was recording when the span opened (or the
count was made): a traced window's numbers never mix with the untraced
ones.  Each entry holds the count, the total seconds and the self
seconds (the total less the time of the spans opened inside it, kept on
a stack; a count's times stay 0).  ``snapshot()`` returns the table,
``reset()`` empties it.

While a profiler records, a span also opens ``record_function(name)``,
so it lies in the same trace as the CUDA kernels, nested under its
caller's spans; ``--profile DIR`` writes that trace.  Off the profiler
it does not: ``record_function`` costs ~14 us per span even with no
profiler running, the flag read under 0.1 us (torch 2.13, an x86
host).  There is no exporter and no switch: the table's readers read it
in the process.

The spans, from the entry point down (the ``formats.*`` ones in the host
build, ``ops.upload`` around the upload, ``solver.*`` and ``fused.*``
around each solve), and ``solver.host_reads``, the blocking device->host
reads of the whole-solve path, are listed with their readers in
PERF.md §3.  The launch counters of the kernels are kept apart, as
attributes of their launch functions: ``solver.fused.fused_cg_dia`` and
``fused_cg_ell`` (``launches``, ``tail_launches``, ``instances``,
``schedules``) and ``ops.spmv_cuda``'s ``dia_fast``, ``dia_fast_halo``,
``ell_fast``, ``ell_fast_halo`` and ``flat_fast`` (``launches``,
``product_launches``, ``two_plane_launches``).

The table is one per process and the solve path is single-threaded: a
span opened on another thread would nest under whatever span is open.
"""

from __future__ import annotations

import functools
from time import perf_counter_ns

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span", "count", "snapshot", "reset"]

# (name, profiling) -> [count, total ns, self ns]
_table = {}
# the child time (ns) of each open span, innermost last
_stack = []


def _entry(key):
    e = _table.get(key)
    if e is None:
        e = _table[key] = [0, 0, 0]
    return e


class span:
    """``with span(name):`` adds the block to ``name``'s entry;
    ``@span(name)`` on a function makes each call a span of its own."""

    __slots__ = ("name", "prof", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        self.prof = _profiler._is_profiler_enabled
        self.rf = None
        if self.prof:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        _stack.append(0)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self.t0
        child = _stack.pop()
        if _stack:
            _stack[-1] += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        e = _entry((self.name, self.prof))
        e[0] += 1
        e[1] += dt
        e[2] += dt - child
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the count of ``name``."""
    _entry((name, _profiler._is_profiler_enabled))[0] += n


def snapshot() -> dict:
    """``{(name, profiling): {"count", "total_s", "self_s"}}``."""
    return {k: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
            for k, (c, t, s) in _table.items()}


def reset():
    _table.clear()
