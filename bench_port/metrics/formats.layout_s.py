"""Seconds of the program's span ``formats.layout`` in the run's host build
(formats/protected.py::build_protected's layout decision: the exec
indices, the DIA check's two np.unique passes, the RCM attempt and the
group structure), over all its calls.  With the other phases and
``formats.build``'s self time it makes up ``formats.build_s``."""

from bench_port import spans


def read(ctx):
    return spans.total_s("formats.layout")
