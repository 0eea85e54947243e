"""Metric readers: ``<metric>.py`` defines ``read(ctx)``, the metric's
value from a run's context, or None where the run has nothing to read
(the metric is then left out of the result line).  ``ctx`` holds the
cell, its configuration and traffic, ``setup_s``, the set-up ``spans``,
the timed ``window`` (harness.Window), the traced window's ``trace``
(trace.TraceSummary, or None) and the matrix's ``shape``
(roofline.Shape)."""
