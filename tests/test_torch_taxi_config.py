"""The NYC-taxi configuration of the port's benchmark
(``portbench/configs/nyc-taxi-100m.json``, cell ``taxi-groupby``) on the
CPU at a small size: each of the mix's five call templates, for several
seeds, answered by ``Executor.execute`` exactly as the plain reference
(``portbench/reference/taxi.py``) answers it, and once the whole cell
served (``harness.run_cell``); the generator's shares against the
distributions the configuration states; the control reference off on
Q2 and Q4; the bank a Row leaf reads over many shards of few rows; and
the set-up's warm, after which the window's requests build no bank."""

import json
import math

import numpy as np
import pytest

from pilosa_tpu_torch import Executor, Holder
from pilosa_tpu_torch.executor.results import result_to_json
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from portbench import harness
from portbench.datasets import taxi
from portbench.gen import Traffic, load_mix
from portbench.reference.taxi import Reference

CELL = "taxi-groupby"
SEEDS = (2**31 + 101, -7, 12345)
# Queries run at 20k rides: one shard, one container's width. On the CPU
# a masked count over dist_miles' 128-row bank grows with the width and
# a Q4 launches one a (passengers, year) prefix, so at 300k rides a Q4
# alone takes 15-25 s.
SMALL = {"rides": 20_000, "load_chunk": 8_192}
# The shares are checked on 300k rides: the generator alone is fast.
SHARE_RIDES = 300_000
MIX = load_mix(str(harness.BENCH_DIR / "traffic" / f"{CELL}.json"))
TEMPLATES = ("Q1", "Q2", "Q3", "Q4", "tile")


def config(**over) -> dict:
    with open(harness.BENCH_DIR / "configs" / "nyc-taxi-100m.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def drawn(template: int, seed: int, n: int):
    """The first ``n`` texts of one template of the mix for ``seed``."""
    traffic = Traffic(dict(MIX, calls=[MIX["calls"][template]]), {}, seed)
    return [traffic.request("window", 0, s)[0] for s in range(n)]


@pytest.fixture(scope="module")
def indexes():
    built = {}

    def get(seed):
        if seed not in built:
            cfg = config(**SMALL)
            data = taxi.generate(cfg, seed, "cpu")
            ex = Executor(taxi.load(cfg, data, "cpu"), device="cpu")
            ex.result_cache.enabled = False
            built[seed] = (ex, Reference(cfg, data, "cpu"))
        return built[seed]
    return get


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("template", range(len(TEMPLATES)),
                         ids=TEMPLATES)
def test_template_matches_reference(indexes, template, seed):
    ex, ref = indexes(seed)
    for pql in drawn(template, seed, 1 if TEMPLATES[template] == "Q4"
                     else 3):
        got = [result_to_json(r) for r in ex.execute("taxi", pql)]
        assert got == ref.answer(pql), pql
        if pql.startswith("GroupBy"):  # a few dozen rides or more a filter
            assert got[0], pql


def test_cell_served_matches_reference(monkeypatch):
    """The cell as ``portbench/run.py`` runs it, at the small size, with
    a warm-up of four requests."""
    monkeypatch.setattr(harness, "WARM_CLIENTS", 2)
    monkeypatch.setattr(harness, "WARM_REQUESTS", 2)
    out = harness.run_cell(CELL, SEEDS[0], 1.5, False, device="cpu",
                           overrides=SMALL, log=lambda m: None)
    json.dumps(out)
    assert out["correct"] is True
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checked"]["compared"]["value"] == out["attempted"]
    assert out["checked"]["mismatched"]["value"] == 0


@pytest.fixture(scope="module")
def shares():
    cfg = config(rides=SHARE_RIDES, load_chunk=100_000)
    return cfg, taxi.generate(cfg, SEEDS[0], "cpu")


def near(observed: float, p: float, n: int) -> bool:
    """Within five standard errors of a share p over n draws (and one
    draw): the tolerance of sampling alone, which a wrong share of a
    few points passes by far at these counts."""
    return abs(observed - p) <= 5 * math.sqrt(p * (1 - p) / n) + 1 / n


def test_generator_shares_match_the_stated_distributions(shares):
    cfg, data = shares
    d = cfg["distributions"]
    n = SHARE_RIDES
    for v, p in d["passenger_share"].items():
        assert near(np.mean(data["passenger_count"] == int(v)), p, n), v
    years, months, mdays = taxi._calendar(cfg)
    for y, g in d["green_share_by_year"].items():
        ride = data["pickup_year"] == int(y)
        n_y = int(ride.sum())
        assert near(n_y / n, np.mean(years == int(y)), n), y
        assert near(np.mean(data["cab_type"][ride] == 0), g, n_y), y
    for m in range(1, 13):
        assert near(np.mean(data["pickup_month"] == m),
                    np.mean(months == m), n), m
    assert near(np.mean(data["pickup_mday"] == 31), np.mean(mdays == 31), n)
    # round(miles) <= 1 is miles < 1.5 of the lognormal.
    z = math.log(1.5 / d["dist_median_miles"]) / d["dist_sigma"]
    assert near(np.mean(data["dist_miles"] <= 1),
                0.5 * (1 + math.erf(z / math.sqrt(2))), n)
    for h, p in enumerate(taxi._diurnal(d)):
        assert near(np.mean(data["pickup_time"] == h), p, n), h
    # E[fare] (1 + E[tip]): the lognormal's mean is its median times
    # exp(sigma^2 / 2); the tip is 0 or uniform over its range.
    miles = d["dist_median_miles"] * math.exp(d["dist_sigma"] ** 2 / 2)
    tip = (1 - d["no_tip_share"]) * sum(d["tip_share_range"]) / 2
    mean = (d["fare_base_dollars"] + d["fare_per_mile_dollars"] * miles) \
        * (1 + tip)
    assert abs(data["total_amount_dollars"].mean() - mean) < 0.1
    # Zipf: the top cell of the seed's ranking takes 1 / H(cells, s).
    top = 1 / np.sum(1.0 / np.arange(1, d["grid_cells"] + 1)
                     ** d["grid_zipf_s"])
    for f in ("pickup_grid_id", "drop_grid_id"):
        counts = np.bincount(data[f], minlength=d["grid_cells"])
        assert near(counts.max() / n, top, n), f
    assert np.argmax(np.bincount(data["pickup_grid_id"])) == \
        np.argmax(np.bincount(data["drop_grid_id"]))
    # A drop is never before its pickup's half-hour, past midnight
    # wrapping, and most rides end within an hour of it.
    later = (data["drop_time"].astype(int) - data["pickup_time"]) % 48
    assert np.mean(later <= 2) > 0.95


def test_control_differs_on_q2_and_q4(shares):
    """The control's Sum keeps 8 bit planes and its GroupBy caps
    dist_miles at row 50: a Q2 over a ride of $256 or more and a Q4 over
    a ride of more than 50 miles differ; Q1, Q3 and the tile do not."""
    cfg, data = shares
    ref = Reference(cfg, data, "cpu")
    ctl = Reference(cfg, data, "cpu", control=True)
    pax = data["passenger_count"]
    i = np.flatnonzero((data["total_amount_dollars"] >= 256)
                       & (pax >= 1) & (pax <= 6))[0]
    j = np.flatnonzero(data["dist_miles"] > 50)[0]
    q2 = MIX["calls"][1]["pql"].format(
        p=pax[i], y=data["pickup_year"][i], m=data["pickup_month"][i])
    q4 = MIX["calls"][3]["pql"].format(
        m=data["pickup_month"][j], h=data["pickup_time"][j])
    assert ref.answer(q2) != ctl.answer(q2)
    assert ref.answer(q4) != ctl.answer(q4)
    for t in (0, 2, 4):
        for pql in drawn(t, SEEDS[0], 2):
            assert ref.answer(pql) == ctl.answer(pql)


def test_many_shards_of_few_rows_serve_leaves_from_the_full_bank():
    """The fragments' summed row counts bound a view's rows; over many
    shards they overstate a view of few rows as many times (96 at the
    configuration's size), so the rows' union decides whether its full
    bank passes ``BANK_MAX_BYTES``: two shards of three rows fit a limit
    that six would pass, and a Row leaf reads the full bank; ten rows
    pass it, and the leaf gets a bank of its row."""
    rng = np.random.default_rng(3)
    holder = Holder(device="cpu")
    idx = holder.create_index("i", track_existence=False)
    cols = np.concatenate([np.arange(2000), SHARD_WIDTH
                           + np.arange(2000)]).astype(np.uint64)
    for name, n in (("few", 3), ("many", 10)):
        idx.create_field(name).import_bits(
            rng.integers(0, n, len(cols)).astype(np.uint64), cols)
    ex = Executor(holder, device="cpu")
    ex.result_cache.enabled = False
    row_bytes = 2 * 2048 * 4  # two shards of one container's words
    ex.BANK_MAX_BYTES = 6 * row_bytes  # 4 slots fit, 8 or 16 do not
    for name, full in (("few", True), ("many", False)):
        got = ex.execute("i", f"Count(Row({name}=1))")[0]
        bits = holder.index("i").field(name).view("standard")
        assert got == sum(f.row_count(1) for f in bits.fragments.values())
        keys = list(bits._bank_cache)
        assert keys and all((len(k) == 2) == full for k in keys), keys


def _bank_keys(holder) -> set:
    return {(f.name, v.name, key)
            for f in holder.index("taxi").fields.values()
            for v in f.views.values() for key in v._bank_cache}


@pytest.mark.parametrize("bank_max", [None, 1], ids=["full", "rows"])
def test_warm_builds_every_bank_the_window_reads(monkeypatch, bank_max):
    """After ``load``'s warm, a served executor answering the mix's
    drawn requests finds every bank cached: with full banks, and where
    each Row leaf reads a bank of its one row (a ``BANK_MAX_BYTES`` no
    view fits, as 96 shards' summed row counts once did), so the peak
    cannot follow which rows the draws reach."""
    if bank_max is not None:
        monkeypatch.setattr(Executor, "BANK_MAX_BYTES", bank_max)
    cfg = config(**SMALL)
    data = taxi.generate(cfg, SEEDS[1], "cpu")
    holder = taxi.load(cfg, data, "cpu")
    warmed = _bank_keys(holder)
    assert {f for f, _, _ in warmed} >= {
        "cab_type", "passenger_count", "dist_miles", "pickup_year",
        "pickup_month", "pickup_mday", "pickup_time",
        "total_amount_dollars"}
    if bank_max is not None:
        assert sum(f == "pickup_time" for f, _, _ in warmed) == 48
    ex = Executor(holder, device="cpu")
    traffic = Traffic(MIX, {}, SEEDS[2])
    for s in range(120):
        ex.execute("taxi", traffic.request("window", 0, s)[0])
    assert _bank_keys(holder) == warmed
