"""Seconds of the program's span ``formats.scatter`` in the run's host
build (formats/protected.py::_scatter_exec and the flat scatter: the
codeword planes laid into the exec planes), over all its calls.  With
the other phases and ``formats.build``'s self time it makes up
``formats.build_s``."""

from bench_port import spans


def read(ctx):
    return spans.total_s("formats.scatter")
