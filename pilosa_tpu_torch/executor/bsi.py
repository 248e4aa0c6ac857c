"""Bit-sliced-index plane scans on torch tensors.

``planes`` is shaped ``[bit_depth + 1, S, W]``: bit planes LSB-first, then
the not-null plane. Comparison values are base values (offset-encoded by
the field's BSIGroup) held as Python ints on the host, so each plane's
predicate bit is a host decision and any depth up to 63 is exact.
Per-plane counts go through the ``bsi_plane_counts`` kernel, whole-row
counts through ``bank_row_counts``; Sum's two launches each open an
``Executor.launch`` span (``kernel=``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.utils.tracing import span


def not_null(planes: torch.Tensor) -> torch.Tensor:
    return planes[-1]


def _bit(value: int, i: int) -> bool:
    return bool((int(value) >> i) & 1)


def eq(planes: torch.Tensor, value: int) -> torch.Tensor:
    """Columns whose value == ``value``."""
    m = planes[-1]
    for i in range(planes.shape[0] - 1):
        plane = planes[i]
        m = torch.bitwise_and(m, plane if _bit(value, i)
                              else torch.bitwise_not(plane))
    return m


def neq(planes: torch.Tensor, value: int) -> torch.Tensor:
    return torch.bitwise_and(planes[-1], torch.bitwise_not(eq(planes, value)))


def lt(planes: torch.Tensor, value: int, allow_eq: bool = False
       ) -> torch.Tensor:
    """Columns with value < (or <=) ``value``: an MSB-first scan keeping
    an equality-prefix mask."""
    matched = torch.zeros_like(planes[-1])
    eq_prefix = planes[-1]
    for i in reversed(range(planes.shape[0] - 1)):
        bit = planes[i]
        if _bit(value, i):
            matched = torch.bitwise_or(
                matched, torch.bitwise_and(eq_prefix, torch.bitwise_not(bit)))
            eq_prefix = torch.bitwise_and(eq_prefix, bit)
        else:
            eq_prefix = torch.bitwise_and(eq_prefix, torch.bitwise_not(bit))
    if allow_eq:
        matched = torch.bitwise_or(matched, eq_prefix)
    return matched


def gt(planes: torch.Tensor, value: int, allow_eq: bool = False
       ) -> torch.Tensor:
    """Columns with value > (or >=) ``value``."""
    matched = torch.zeros_like(planes[-1])
    eq_prefix = planes[-1]
    for i in reversed(range(planes.shape[0] - 1)):
        bit = planes[i]
        if _bit(value, i):
            eq_prefix = torch.bitwise_and(eq_prefix, bit)
        else:
            matched = torch.bitwise_or(matched,
                                       torch.bitwise_and(eq_prefix, bit))
            eq_prefix = torch.bitwise_and(eq_prefix, torch.bitwise_not(bit))
    if allow_eq:
        matched = torch.bitwise_or(matched, eq_prefix)
    return matched


def between(planes: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """low <= value <= high."""
    return torch.bitwise_and(gt(planes, low, allow_eq=True),
                             lt(planes, high, allow_eq=True))


def _masked_not_null(planes: torch.Tensor,
                     filter_mask: Optional[torch.Tensor]) -> torch.Tensor:
    m = planes[-1]
    if filter_mask is not None:
        m = torch.bitwise_and(m, filter_mask)
    return m


def sum_count(planes: torch.Tensor,
              filter_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-plane counts int64[depth], count int64[1]) over not-null (∧
    filter) columns. The caller weights plane i by 2^i in Python ints
    and adds min*count."""
    m = _masked_not_null(planes, filter_mask).contiguous()
    with span("Executor.launch", kernel="bsi_plane_counts"):
        counts = kernels.bsi_plane_counts(planes[:-1], m)
    with span("Executor.launch", kernel="bank_row_counts"):
        cnt = kernels.bank_row_counts(m.unsqueeze(0))
    return counts, cnt


def _descend(planes: torch.Tensor, filter_mask: Optional[torch.Tensor],
             want_one: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    cand = _masked_not_null(planes, filter_mask)
    chosen: List[torch.Tensor] = []
    for i in reversed(range(planes.shape[0] - 1)):
        plane = planes[i] if want_one else torch.bitwise_not(planes[i])
        hit = torch.bitwise_and(cand, plane)
        has = torch.any(hit != 0)
        cand = torch.where(has, hit, cand)
        chosen.append(has if want_one else torch.logical_not(has))
    if not chosen:
        return torch.zeros(0, dtype=torch.int32, device=planes.device), cand
    bits = torch.stack(chosen[::-1]).to(torch.int32)  # LSB-first
    return bits, cand


def min_mask(planes: torch.Tensor,
             filter_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits of the minimum base value LSB-first, int32[depth]; mask of
    the columns holding it): a greedy MSB-first descent."""
    return _descend(planes, filter_mask, want_one=False)


def max_mask(planes: torch.Tensor,
             filter_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum counterpart of ``min_mask``."""
    return _descend(planes, filter_mask, want_one=True)
