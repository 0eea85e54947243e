"""What a fault adds to its request, in ms by the host clock: the median
latency of the window's faulted requests less that of its other
requests.  It holds the trigger, classify, the scrub, the guard and the
relaunch of the whole-solve kernel."""

import statistics


def read(ctx):
    w = ctx.window
    hit = [t for t, f in zip(w.latencies, w.faulted) if f]
    clean = [t for t, f in zip(w.latencies, w.faulted) if not f]
    if not hit or not clean:
        return None
    return (statistics.median(hit) - statistics.median(clean)) * 1e3
