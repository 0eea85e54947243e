"""Seconds of the program's span ``formats.checksums`` in the run's host
build (formats/protected.py::compute_exec_checksums and flat_checksums:
the XOR checksums of the exec and flat planes), over all its calls.
With the other phases and ``formats.build``'s self time it makes up
``formats.build_s``."""

from bench_port import spans


def read(ctx):
    return spans.total_s("formats.checksums")
