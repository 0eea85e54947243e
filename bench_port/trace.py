"""The traced window: a torch.profiler window over a fixed number of
solves, reduced to device busy time, time by device operation and the
idle gaps by what the host was doing.

The union of device intervals is a frozen copy of
``chip_smoke.py::call_profile``'s busy arithmetic.  The profiler's own
host overhead stretches the window, so the busy share it gives is a
lower bound.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

WINDOW = "bench.window"
REQUEST = "bench.request"
_TOP = 10


class TraceSummary(NamedTuple):
    busy_s: float            # union of device activity inside the window
    window_s: float          # the traced window's length
    by_name: dict            # device seconds by operation name
    gaps: dict               # idle seconds by the host's innermost span
    iterations: list         # of each traced solve
    complete: bool           # every launch the program counted was traced


def _union(intervals):
    """Total length covered by (start, end) intervals."""
    busy, c0, c1 = 0.0, None, None
    for t0, t1 in sorted(intervals):
        if c1 is None or t0 > c1:
            busy += 0.0 if c1 is None else c1 - c0
            c0, c1 = t0, t1
        else:
            c1 = max(c1, t1)
    return busy + (0.0 if c1 is None else c1 - c0)


def reduce_events(cpu, gpu, window, iterations, launches):
    """``cpu``/``gpu``: (start_us, end_us, name) of host spans and device
    operations; ``window``: (start_us, end_us) of the traced loop;
    ``launches``: {kernel name part: launches the program counted}."""
    w0, w1 = window
    gpu = [(max(a, w0), min(b, w1), n) for a, b, n in gpu if b > w0 and a < w1]
    by_name = {}
    for a, b, n in gpu:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in gpu]) * 1e-6
    # Idle gaps: between device operations, and at the window's ends.
    edges = sorted((a, b) for a, b, _ in gpu)
    gaps, t = [], w0
    for a, b in edges:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    starts = np.array([c[0] for c in cpu], dtype=np.float64)
    ends = np.array([c[1] for c in cpu], dtype=np.float64)
    by_gap = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        if inside.size:
            # The innermost: the latest start, then the earliest end.
            i = min(inside, key=lambda k: (-starts[k], ends[k]))
            name = cpu[i][2]
        else:
            name = "(no host span)"
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) * 1e-6
    complete = bool(gpu) and all(
        sum(1 for _, _, n in gpu if part in n) == count
        for part, count in launches.items())
    return TraceSummary(busy, (w1 - w0) * 1e-6, by_name, by_gap,
                        list(iterations), complete)


def traced_solves(run_one, count, launch_counts, sync):
    """Profile ``count`` calls of ``run_one(j) -> iterations``; the
    program's launch counters before and after say how many launches of
    each kernel the trace must hold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    before = launch_counts()
    its = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for j in range(count):
                with record_function(REQUEST):
                    its.append(run_one(j))
            sync()
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    events = list(prof.events())
    cpu, gpu, window = [], [], None
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            # record_function's spans are mirrored on the device's
            # timeline as annotations: they are no device work.
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in (WINDOW, REQUEST)):
                gpu.append(span)
        else:
            cpu.append(span)
            if e.name == WINDOW:
                window = span[:2]
    if window is None:
        return None
    return reduce_events(cpu, gpu, window, its, launches)


def breakdown(t: TraceSummary):
    """The result line's ``breakdown``: the device operations that took
    most time and the idle gaps by the host's span, at most ten each."""
    def top(d):
        return [[n[:200], v] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]

    return {"device_ops": top(t.by_name), "idle_gaps": top(t.gaps)}
