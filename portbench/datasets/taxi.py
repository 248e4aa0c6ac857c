"""The NYC-taxi configurations: rides from the seed, the index built
through the port's bulk import, and the least bytes a query needs.

Ride r is column r. Each field's value is drawn from the configuration's
``distributions`` (``assumed`` states them in words): a calendar day
uniform over the configured years gives ``pickup_year``,
``pickup_month`` and ``pickup_mday``; the cab type by the day's green
share; passengers by their shares; the distance lognormal; the fare
from it plus a tip; the pickup's half-hour from a two-peaked day; the
drop's from the pickup and the distance; each grid cell Zipf over a
ranking of the cells drawn from the seed.

The set-up ends with ``warm``: a run's device peak must not follow the
draws of its few requests, so before the window every bank the mix can
read is built and its deepest GroupBys have met their most ragged
frontiers.
"""

from __future__ import annotations

import datetime
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from portbench.gen import load_mix
from portbench.pql import Call

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"
_LEAF = re.compile(r"Row\((\w+)=\{(\w+)\}\)")  # Row(field={param})

SHARD_COLUMNS = 1 << 20  # Pilosa's shard width
ROW_WORDS = SHARD_COLUMNS // 32  # 32-bit words of one row in one shard


def shards(cfg: dict) -> int:
    return -(-int(cfg["rides"]) // SHARD_COLUMNS)


def _calendar(cfg: dict):
    """(year, month, mday) int arrays, one entry a day of the years of
    ``pickup_year``'s rows."""
    lo, hi = cfg["fields"]["pickup_year"]["rows"]
    day = datetime.date(lo, 1, 1)
    out = []
    while day.year <= hi:
        out.append((day.year, day.month, day.day))
        day += datetime.timedelta(days=1)
    return np.array(out, dtype=np.int64).T


def _diurnal(d: dict) -> np.ndarray:
    """Shares of the 48 half-hour buckets."""
    t = (np.arange(48) + 0.5) / 2
    w = np.full(48, float(d["diurnal_floor"]))
    for p in d["diurnal_peaks"]:
        w += p["height"] * np.exp(-0.5 * ((t - p["hour"])
                                          / p["width_hours"]) ** 2)
    return w / w.sum()


def _cdf(shares, torch, device):
    c = np.cumsum(np.asarray(shares, np.float64))
    return torch.tensor(c / c[-1], dtype=torch.float64, device=device)


def generate(cfg: dict, seed: int, device: str) -> Dict[str, np.ndarray]:
    """One int16 array a field, ``rides`` long, made on ``device`` from
    ``seed`` a chunk of ``load_chunk`` rides at a time."""
    import torch
    n, chunk = int(cfg["rides"]), int(cfg["load_chunk"])
    d = cfg["distributions"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    cal = torch.tensor(_calendar(cfg), device=device)
    green = torch.tensor([float(d["green_share_by_year"][str(int(y))])
                          for y in cal[0].tolist()], dtype=torch.float64,
                         device=device)
    pax = d["passenger_share"]
    pax_vals = torch.tensor([int(k) for k in pax], device=device)
    pax_cdf = _cdf(list(pax.values()), torch, device)
    time_cdf = _cdf(_diurnal(d), torch, device)
    cells = int(d["grid_cells"])
    rank = torch.randperm(cells, generator=g, device=device)
    zipf_cdf = _cdf(1.0 / np.arange(1, cells + 1) ** float(d["grid_zipf_s"]),
                    torch, device)
    top_mile = cfg["fields"]["dist_miles"]["rows"][1]
    top_amount = cfg["fields"]["total_amount_dollars"]["max"]
    tip_lo, tip_hi = d["tip_share_range"]
    out = {f: np.empty(n, np.int16) for f in cfg["fields"]}

    def draw(cdf, m):
        u = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        return torch.searchsorted(cdf, u, right=True).clamp(
            max=len(cdf) - 1)

    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)

        def u():
            return torch.rand(m, generator=g, device=device,
                              dtype=torch.float64)

        day = torch.randint(0, cal.shape[1], (m,), generator=g,
                            device=device)
        cols = {"pickup_year": cal[0][day], "pickup_month": cal[1][day],
                "pickup_mday": cal[2][day]}
        cols["cab_type"] = (u() >= green[day]).long()
        cols["passenger_count"] = pax_vals[draw(pax_cdf, m)]
        miles = float(d["dist_median_miles"]) * torch.exp(
            float(d["dist_sigma"]) * torch.randn(
                m, generator=g, device=device, dtype=torch.float64))
        cols["dist_miles"] = miles.round().clamp(max=top_mile).long()
        tip = torch.where(u() < float(d["no_tip_share"]),
                          torch.zeros((), dtype=torch.float64,
                                      device=device),
                          tip_lo + (tip_hi - tip_lo) * u())
        fare = float(d["fare_base_dollars"]) \
            + float(d["fare_per_mile_dollars"]) * miles
        cols["total_amount_dollars"] = (fare * (1 + tip)).round().clamp(
            0, top_amount).long()
        bucket = draw(time_cdf, m)
        cols["pickup_time"] = bucket
        minute = bucket * 30 + u() * 30 + miles / float(d["speed_mph"]) * 60
        cols["drop_time"] = (minute // 30).long() % 48
        cols["pickup_grid_id"] = rank[draw(zipf_cdf, m)]
        cols["drop_grid_id"] = rank[draw(zipf_cdf, m)]
        for f, col in cols.items():
            out[f][c0:c0 + m] = col.to(torch.int16).cpu().numpy()
    return out


def load(cfg: dict, data: Dict[str, np.ndarray], device: str):
    """The index in a new in-memory port Holder, existence tracked,
    through ``Field.import_bits`` (set fields) and
    ``Field.import_values`` (the int field), ``load_chunk`` rides a
    call, then ``warm`` where the configuration asks for it. Returns
    the holder."""
    from pilosa_tpu_torch import FieldOptions, Holder
    n, chunk = int(cfg["rides"]), int(cfg["load_chunk"])
    holder = Holder(device=device)
    idx = holder.create_index(cfg["index"], track_existence=True)
    fields = {}
    for f, spec in cfg["fields"].items():
        opts = FieldOptions(type="int", min=spec["min"], max=spec["max"]) \
            if spec["type"] == "int" else FieldOptions()
        fields[f] = (idx.create_field(f, opts), spec["type"])
    for c0 in range(0, n, chunk):
        cols = np.arange(c0, min(n, c0 + chunk), dtype=np.uint64)
        for f, (field, kind) in fields.items():
            vals = data[f][c0:c0 + chunk]
            if kind == "int":
                field.import_values(cols, vals.astype(np.int64))
            else:
                field.import_bits(vals.astype(np.uint64), cols)
        idx.add_existence(cols)
    if cfg.get("warm"):
        warm(holder, cfg, data)
    return holder


def _ranges(template: dict) -> Dict[str, range]:
    """Every value of each parameter of a call template."""
    out = {}
    for name, spec in template.get("params", {}).items():
        lo, hi = spec["int"]
        if not (isinstance(lo, int) and isinstance(hi, int)):
            raise ValueError(f"{template['pql']}: {name}: only integer "
                             "bounds are enumerated")
        out[name] = range(lo, hi)
    return out


def _covering(pql: str, ranges: Dict[str, range]) -> List[str]:
    """Texts of a template that give each parameter every value of its
    range, all parameters stepping together."""
    n = max((len(r) for r in ranges.values()), default=1)
    return [pql.format(**{p: r[i % len(r)] for p, r in ranges.items()})
            for i in range(n)]


def _sparsest(pql: str, ranges: Dict[str, range], data, rides: int,
              k: int) -> List[str]:
    """The ``k`` draws of a template whose filter holds the fewest rides
    (each parameter fills a ``Row(field={param})`` leaf of it)."""
    fields = {p: f for f, p in _LEAF.findall(pql)}
    key = np.zeros(rides, np.int64)
    inside = np.ones(rides, bool)
    for p, r in ranges.items():
        col = data[fields[p]].astype(np.int64) - r.start
        inside &= (col >= 0) & (col < len(r))
        key = key * len(r) + col
    combos = int(np.prod([len(r) for r in ranges.values()]))
    counts = np.bincount(key[inside], minlength=combos)
    out = []
    for d in np.argsort(counts, kind="stable")[:k]:
        values, d = {}, int(d)
        for p, r in reversed(list(ranges.items())):
            d, i = divmod(d, len(r))
            values[p] = r[i]
        out.append(pql.format(**values))
    return out


def warm(holder, cfg: dict, data) -> None:
    """Serve, through an executor of the holder's own, what a node
    taking the mix ``cfg["warm"]["mix"]`` holds on the card before its
    first request, so that the window's draws cannot raise the device
    peak:

    - every template over every value of its parameters (a GroupBy as
      the Count of its filter, its last argument): each bank a Row leaf
      of the mix can read is built;
    - each GroupBy template under its ``sparsest`` draws, the filters
      with the fewest rides: its children's banks are built, and its
      frontier meets the most empty groups, where the survivors of a
      chunk are copied out of it.

    The executor is dropped after; the banks stay with the views."""
    from pilosa_tpu_torch import Executor
    spec = cfg["warm"]
    mix = load_mix(str(TRAFFIC_DIR / f"{spec['mix']}.json"))
    ex = Executor(holder, device=holder.device)
    templates = [(t["pql"], _ranges(t)) for t in mix["calls"]]
    for pql, ranges in templates:
        if pql.startswith("GroupBy("):
            if "filter=" not in pql:
                continue
            pql = "Count(" + pql[pql.index("filter=") + len("filter="):]
        for text in _covering(pql, ranges):
            ex.execute(mix["index"], text)
    for pql, ranges in templates:
        if pql.startswith("GroupBy("):
            for text in _sparsest(pql, ranges, data, int(cfg["rides"]),
                                  int(spec["sparsest"])):
                ex.execute(mix["index"], text)


def _leaves(c: Call, out: set) -> set:
    """The (field, row) of every Row leaf of a row-call tree."""
    if c.name == "Row":
        (f, r), = c.kwargs.items()
        out.add((f, int(r)))
    for a in c.args:
        _leaves(a, out)
    return out


def _rows_of(data: dict, f: str) -> int:
    """How many distinct rows field ``f`` holds."""
    seen = data.setdefault("_rows", {})
    if f not in seen:
        seen[f] = len(np.unique(data[f]))
    return seen[f]


def least_bytes(calls: List[Call], cfg: dict, data) -> int:
    """Every dense row a call's answer depends on, counted once a call,
    ``S x W x 4`` bytes each (S shards of W 32-bit words): for GroupBy
    the filter's rows and every row of each child; for Sum the filter's
    rows, the field's bit planes and its not-null row; for Count the
    rows of its tree. An algorithm that reads less (a sparse row, a
    frontier that skips empty words) would need this count redone."""
    row = shards(cfg) * ROW_WORDS * 4
    total = 0
    for c in calls:
        leaves: set = set()
        rows = 0
        if c.name == "GroupBy":
            if isinstance(c.kwargs.get("filter"), Call):
                _leaves(c.kwargs["filter"], leaves)
            rows = sum(_rows_of(data, a.names[0]) for a in c.args)
        elif c.name == "Sum":
            for a in c.args:
                _leaves(a, leaves)
            spec = cfg["fields"][c.kwargs["field"]]
            rows = max(1, (spec["max"] - spec["min"]).bit_length()) + 1
        elif c.name == "Count":
            for a in c.args:
                _leaves(a, leaves)
        else:
            raise ValueError(f"no least-bytes rule for {c.name}")
        total += (len(leaves) + rows) * row
    return total

