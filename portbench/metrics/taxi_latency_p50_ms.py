"""Median latency of every request due in the window of the taxi cell,
read as ``latency_p50_ms`` reads it (due time to last byte read on the
client), under a name of its own for the cell."""

from portbench.metrics.latency_p50_ms import read  # noqa: F401
