"""Median over the taxi cell's probes of the least time the card could
take for a probe (its least bytes, ``datasets/taxi.least_bytes``: every
dense row its answer depends on, once) at the card's published HBM rate,
as a share (%) of the device time the profiler attributes to the probe.
Read as ``probe_roofline_share`` reads it; the probes' device work is
the counting kernels (``bank_row_counts``, ``bank_row_counts_masked``,
``bsi_plane_counts``, ``mega_interpret``) and the copies around them."""

from portbench.metrics.probe_roofline_share import read  # noqa: F401
