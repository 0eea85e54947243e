"""Seconds of the program's span ``formats.assemble`` in the run's host
build (formats/loader.py::assemble: the reference loader's mirroring,
(row, col) sort and block replication of the stored triangle), over all
its calls.  With the other phases and ``formats.build``'s self time it
makes up ``formats.build_s``."""

from bench_port import spans


def read(ctx):
    return spans.total_s("formats.assemble")
