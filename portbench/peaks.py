"""Published peaks of the cards the benchmark knows, by device name.

NVIDIA's H100 data sheet: 3.35 TB/s of HBM3 on the SXM part ("NVIDIA
H100 80GB HBM3"), 2.0 TB/s on the PCIe part, both at the card's full
power limit. A card the table does not know has no roofline.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    for key, rate in HBM_BYTES_PER_S:
        if key in device_name:
            return rate
    return None
