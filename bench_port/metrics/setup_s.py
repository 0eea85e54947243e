"""Process start to the first timed request: imports, the matrix, the
host build, the upload, loading (or building) the kernels, warm-up."""


def read(ctx):
    return ctx.setup_s
