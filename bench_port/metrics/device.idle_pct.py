"""1 - the union of device activity over the traced window, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.complete or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
