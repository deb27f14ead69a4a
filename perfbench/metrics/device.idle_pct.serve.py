"""Share of the traced sub-window in which no operation ran on the
device (``harness/trace.py::idle_pct``)."""

from perfbench.harness.trace import idle_pct as read  # noqa: F401
