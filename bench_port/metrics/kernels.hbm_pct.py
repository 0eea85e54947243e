"""The bytes the traced solves must move (roofline.py) over the device
time of every operation they launched, as a share of 3.35 TB/s."""

from bench_port import roofline


def read(ctx):
    t = ctx.trace
    if t is None or not t.complete or t.busy_s <= 0:
        return None
    ci = ctx.traffic["check_interval"]
    per = [roofline.solve_bytes(ctx.shape, ctx.config["mode"], k, ci)
           for k in t.iterations]
    if any(b is None for b in per):
        return None
    return 100.0 * sum(per) / t.busy_s / roofline.HBM_BPS
