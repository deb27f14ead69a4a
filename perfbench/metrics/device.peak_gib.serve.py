"""The run's peak of device memory allocated, in GiB
(``harness/trace.py::peak_gib``)."""

from perfbench.harness.trace import peak_gib as read  # noqa: F401
