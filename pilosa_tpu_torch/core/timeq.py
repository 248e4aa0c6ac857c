"""Time quantum views: this package's copy of the JAX package's
``core/timeq.py``.

A time field stores each bit in one view per enabled time unit
(reference viewsByTime, time.go:91; view name formats time.go:70-88). A
range query unions the minimal set of views covering [start, end)
(viewsByTimeRange, time.go:104-177): walk up from the finest unit until
aligned on the next coarser unit, emit coarse views while they fit, then
walk back down.
"""

from __future__ import annotations

import functools
from datetime import datetime, timedelta
from typing import List

VALID_UNITS = "YMDH"


def validate_quantum(q: str) -> None:
    if q and (any(u not in VALID_UNITS for u in q)
              or [u for u in VALID_UNITS if u in q] != list(q)):
        raise ValueError(f"invalid time quantum: {q!r}")


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    return ""


def views_by_time(name: str, t: datetime, quantum: str) -> List[str]:
    """All views one timestamped bit lands in: one per enabled unit."""
    return [v for u in quantum if (v := view_by_time_unit(name, t, u))]


def _next_hour(t: datetime) -> datetime:
    return t + timedelta(hours=1)


def _next_day(t: datetime) -> datetime:
    return t + timedelta(days=1)


def _add_month(t: datetime) -> datetime:
    # Clamp to day 1 for day > 28, so that Jan 31 + 1 month is not
    # Mar 2 (reference addMonth, time.go:182-192).
    if t.day > 28:
        t = t.replace(day=1)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _next_year(t: datetime) -> datetime:
    return t.replace(year=t.year + 1)


def views_by_time_range(name: str, start: datetime, end: datetime,
                        quantum: str) -> List[str]:
    """Minimal view cover of [start, end)."""
    has = {u: u in quantum for u in VALID_UNITS}
    t = start
    results: List[str] = []

    def year_fits(t):
        nxt = _next_year(t)
        return nxt.year == end.year or end > nxt

    def month_fits(t):
        nxt = t.replace(day=1)
        nxt = _next_year(nxt.replace(month=1)) if t.month == 12 \
            else nxt.replace(month=t.month + 1)
        return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt

    def day_fits(t):
        nxt = _next_day(t.replace(hour=0, minute=0, second=0, microsecond=0))
        return nxt.date() == end.date() or end > nxt

    # Walk up: emit fine views until aligned on the next coarser unit.
    if has["H"] or has["D"] or has["M"]:
        while t < end:
            if has["H"]:
                if not day_fits(t):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = _next_hour(t)
                    continue
            if has["D"]:
                if not month_fits(t):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = _next_day(t)
                    continue
            if has["M"]:
                if not year_fits(t):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk down: the largest unit that still fits, repeatedly.
    while t < end:
        if has["Y"] and year_fits(t):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _next_year(t)
        elif has["M"] and month_fits(t):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has["D"] and day_fits(t):
            results.append(view_by_time_unit(name, t, "D"))
            t = _next_day(t)
        elif has["H"]:
            results.append(view_by_time_unit(name, t, "H"))
            t = _next_hour(t)
        else:
            break

    return results


def view_time_part(v: str) -> str:
    """Time suffix of a view name: "standard_201901" -> "201901"
    (reference viewTimePart, time.go:330)."""
    return v.rsplit("_", 1)[1] if "_" in v else ""


def min_max_views(views: List[str], quantum: str) -> tuple:
    """(min, max) views among ``views`` at the quantum's coarsest unit
    (reference minMaxViews, time.go:240: the first unit of YMDH in the
    quantum picks the suffix length; views sort chronologically because
    the suffix is zero-padded)."""
    chars = 0
    for unit, n in (("Y", 4), ("M", 6), ("D", 8), ("H", 10)):
        if unit in quantum:
            chars = n
            break
    lo = hi = ""
    for v in sorted(views):
        if len(view_time_part(v)) == chars:
            if not lo:
                lo = v
            hi = v
    return lo, hi


def time_of_view(v: str, adj: bool) -> datetime:
    """Start time of a view name; with ``adj=True`` its exclusive end
    (reference timeOfView, time.go:279)."""
    part = view_time_part(v)
    fmt = {4: "%Y", 6: "%Y%m", 8: "%Y%m%d", 10: "%Y%m%d%H"}.get(len(part))
    if fmt is None:
        raise ValueError(f"invalid time format on view: {v}")
    t = datetime.strptime(part, fmt)
    if adj:
        t = {4: _next_year, 6: _add_month, 8: _next_day,
             10: _next_hour}[len(part)](t)
    return t


@functools.lru_cache(maxsize=4096)
def parse_timestamp(s: str) -> datetime:
    """PQL timestamp formats (reference pql.peg timestampfmt). Cached:
    dashboards send the same literal range bounds with every query, and
    a datetime is immutable, so the parse can be shared."""
    for fmt in ("%Y-%m-%dT%H:%M", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M",
                "%Y-%m-%d"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"cannot parse timestamp {s!r}")
