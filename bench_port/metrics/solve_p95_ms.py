"""The 95th percentile of the latency of every request in the window,
in ms (linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
