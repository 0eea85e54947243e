"""The program's host build (formats/loader.py::assemble and
formats/protected.py::build_protected), by the benchmark's span."""


def read(ctx):
    return ctx.spans.get("formats.build")
