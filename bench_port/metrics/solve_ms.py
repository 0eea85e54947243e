"""The window's wall time over the solves completed in it, in ms."""


def read(ctx):
    w = ctx.window
    return w.wall_s / len(w.latencies) * 1e3 if w.latencies else None
