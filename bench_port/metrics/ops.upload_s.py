"""The upload (ops/spmv.py::make_matrix_device), by the benchmark's span
ended by a synchronize."""


def read(ctx):
    return ctx.spans.get("ops.upload")
