"""Mean iterations per solve in the window, from the solves' own
results."""


def read(ctx):
    its = ctx.window.iterations
    return sum(its) / len(its) if its else None
