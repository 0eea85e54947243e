"""Seconds of the program's span ``formats.encode`` in the run's host build
(formats/protected.py::_encode_planes: the flat codeword planes and
their ECC bits), over all its calls.  With the other phases and
``formats.build``'s self time it makes up ``formats.build_s``."""

from bench_port import spans


def read(ctx):
    return spans.total_s("formats.encode")
