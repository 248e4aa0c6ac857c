"""The memory-bandwidth roofline of the card the port runs on: only
``resolve_roofline`` of the JAX package's ``utils/benchenv.py``, with a
table of CUDA cards in place of its TPU table.

The figures are the public peak HBM bandwidth of each card, by the name
``torch.cuda.get_device_name`` gives. ``utils/roofline.py`` prices each
megakernel launch's bytes against it. An unknown card and the CPU get
``ROOFLINE_GBPS_DEFAULT`` and are labelled estimate-only; no card is
priced at a TPU figure.
"""

from __future__ import annotations

from typing import Any, Tuple

# (probe, GB/s): the first probe found in the lower-cased device name
# wins, so a longer name precedes any name it contains ("h100 nvl" and
# "h100 pcie" before "h100").
ROOFLINE_GBPS_BY_KIND = (
    ("h200", 4800.0),            # H200 SXM, 141 GB HBM3e
    ("h100 nvl", 3900.0),        # H100 NVL, 94 GB HBM3
    ("h100 pcie", 2000.0),       # H100 PCIe, 80 GB HBM2e
    ("h100 80gb hbm3", 3350.0),  # H100 SXM5, 80 GB HBM3
    ("h100", 3350.0),            # H100 SXM5 under another name
    ("a100-sxm4-80gb", 2039.0),  # A100 SXM4, 80 GB HBM2e
    ("a100 80gb pcie", 1935.0),  # A100 PCIe, 80 GB HBM2e
    ("a100-pcie-40gb", 1555.0),  # A100 PCIe, 40 GB HBM2
    ("a100-sxm4-40gb", 1555.0),  # A100 SXM4, 40 GB HBM2
    ("a100", 1555.0),            # A100 40 GB under another name
)
# Unknown cards and the CPU: a number to divide by, never a measurement.
ROOFLINE_GBPS_DEFAULT = 1000.0


def resolve_roofline(device: Any) -> Tuple[float, str, bool]:
    """``(gbps, kind, estimated)`` for a torch device (or its name). A
    CUDA device is looked up by ``torch.cuda.get_device_name``; a card
    the table lacks, and any other device, get the default and
    ``estimated=True``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return ROOFLINE_GBPS_DEFAULT, dev.type, True
    kind = torch.cuda.get_device_name(dev)
    return resolve_kind(kind)


def resolve_kind(kind: str) -> Tuple[float, str, bool]:
    """``(gbps, kind, estimated)`` for a card's name."""
    low = (kind or "").lower()
    for probe, gbps in ROOFLINE_GBPS_BY_KIND:
        if probe in low:
            return gbps, kind, False
    return ROOFLINE_GBPS_DEFAULT, kind or "unknown", True
