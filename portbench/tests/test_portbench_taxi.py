"""The taxi kind's generator, reference, least bytes and control: the
rides repeat for one seed and differ for another; the reference answers
a hand-made handful of rides as counted by hand; the least bytes count
each row a call depends on once; the control comes out not correct; the
warm's draws cover every value and find the sparsest filters."""

import json

import numpy as np
import pytest

from portbench import control, harness
from portbench.datasets import taxi
from portbench.pql import parse
from portbench.reference.taxi import Reference

ROW = 1 << 17  # one dense row of one shard: 32,768 words of 4 bytes


def _cfg(**over):
    with open(harness.BENCH_DIR / "configs" / "nyc-taxi-100m.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def test_rides_repeat_for_a_seed_and_differ_for_another():
    cfg = _cfg(rides=5_000, load_chunk=2_000)
    a = taxi.generate(cfg, 2**31 + 5, "cpu")
    b = taxi.generate(cfg, 2**31 + 5, "cpu")
    c = taxi.generate(cfg, 2**31 + 6, "cpu")
    assert set(a) == set(b) == set(c) == set(cfg["fields"])
    for f, spec in cfg["fields"].items():
        assert np.array_equal(a[f], b[f]) and len(a[f]) == 5_000
        lo, hi = spec["rows"] if "rows" in spec else (spec["min"],
                                                      spec["max"])
        assert lo <= a[f].min() and a[f].max() <= hi, f
    assert any(not np.array_equal(a[f], c[f]) for f in a)


def hand_made():
    """Six rides, every field given; the grids and drops are not read."""
    cols = {"cab_type": [1, 1, 0, 1, 1, 0],
            "passenger_count": [1, 2, 1, 1, 2, 1],
            "dist_miles": [3, 3, 60, 1, 3, 2],
            "total_amount_dollars": [10, 20, 300, 7, 11, 9],
            "pickup_year": [2014, 2014, 2014, 2015, 2014, 2014],
            "pickup_month": [5, 5, 5, 5, 6, 5],
            "pickup_mday": [1, 1, 2, 1, 1, 1],
            "pickup_time": [16, 16, 16, 16, 16, 17]}
    cfg = _cfg(rides=6)
    data = {f: np.array(cols.get(f, [0] * 6), np.int16)
            for f in cfg["fields"]}
    return cfg, data


def test_reference_answers_hand_made_rides():
    cfg, data = hand_made()
    ref = Reference(cfg, data, "cpu")
    assert ref.answer(
        "GroupBy(Rows(cab_type), filter=Intersect(Row(pickup_year=2014), "
        "Row(pickup_month=5)))") == [[
            {"group": [{"field": "cab_type", "rowID": 0}], "count": 2},
            {"group": [{"field": "cab_type", "rowID": 1}], "count": 2}]]
    assert ref.answer(
        "Sum(Intersect(Row(passenger_count=1), Row(pickup_year=2014), "
        "Row(pickup_month=5)), field=total_amount_dollars)") == [
            {"value": 319, "count": 3}]
    q4 = ("GroupBy(Rows(passenger_count), Rows(pickup_year), "
          "Rows(dist_miles), filter=Intersect(Row(pickup_month=5), "
          "Row(pickup_time=16)))")

    def g(p, y, m, n):
        return {"group": [{"field": "passenger_count", "rowID": p},
                          {"field": "pickup_year", "rowID": y},
                          {"field": "dist_miles", "rowID": m}], "count": n}
    assert ref.answer(q4) == [[g(1, 2014, 3, 1), g(1, 2014, 60, 1),
                               g(1, 2015, 1, 1), g(2, 2014, 3, 1)]]
    assert ref.answer(
        "Count(Intersect(Row(cab_type=1), Row(pickup_year=2014), "
        "Row(pickup_month=5), Row(pickup_mday=1)))") == [2]
    assert ref.answer("Count(Intersect(Row(cab_type=0), "
                      "Row(pickup_year=2009)))") == [0]
    ctl = Reference(cfg, data, "cpu", control=True)
    assert ctl.answer(q4) == [[g(1, 2014, 3, 1), g(1, 2014, 50, 1),
                               g(1, 2015, 1, 1), g(2, 2014, 3, 1)]]
    assert ctl.answer("Sum(Row(cab_type=0), field=total_amount_dollars)") \
        == [{"value": 300 % 256 + 9, "count": 2}]


def test_least_bytes_counts_each_row_once_a_call():
    cfg, data = hand_made()
    cfg = dict(cfg, rides=96 << 20)  # 96 shards
    row = 96 * ROW
    q1 = parse("GroupBy(Rows(cab_type), filter=Intersect("
               "Row(pickup_year=2014), Row(pickup_month=5)))")
    assert taxi.least_bytes(q1, cfg, data) == (2 + 2) * row
    q4 = parse("GroupBy(Rows(passenger_count), Rows(pickup_year), "
               "Rows(dist_miles), filter=Intersect(Row(pickup_month=5), "
               "Row(pickup_time=16)))")
    # 2 passenger counts, 2 years and 4 distances hold rides here.
    assert taxi.least_bytes(q4, cfg, data) == (2 + 2 + 2 + 4) * row
    q2 = parse("Sum(Intersect(Row(passenger_count=1), Row(pickup_year=2014),"
               " Row(pickup_month=5)), field=total_amount_dollars)")
    # 10 bit planes of 0..1000 and the not-null row.
    assert taxi.least_bytes(q2, cfg, data) == (3 + 11) * row
    tile = parse("Count(Intersect(Row(cab_type=1), Row(cab_type=1), "
                 "Row(pickup_mday=1)))")
    assert taxi.least_bytes(tile, cfg, data) == 2 * row
    assert taxi.least_bytes(q1 + tile, cfg, data) == 6 * row
    with pytest.raises(ValueError):
        taxi.least_bytes(parse("TopN(cab_type, n=2)"), cfg, data)


def test_control_is_not_correct():
    """At 2M rides a Q4's filter holds about 3,500 rides, so a ride past
    50 miles (1.8e-4 of them) falls in most Q4s: 100 requests carry
    about a dozen."""
    got = control.readings("taxi-groupby", 2**31 + 3, 100, "cpu",
                           {"rides": 2_000_000, "load_chunk": 1 << 20})
    assert got["correct"] is False
    assert got["checked"]["mismatched"]["value"] > 0
    assert got["checked"]["compared"]["value"] == 100


def test_warm_draws_cover_every_value_and_find_the_sparsest_filters():
    cfg = _cfg(rides=30_000, load_chunk=10_000)
    data = taxi.generate(cfg, 2**31 + 9, "cpu")
    mix = taxi.load_mix(str(taxi.TRAFFIC_DIR / "taxi-groupby.json"))
    tile, q4 = mix["calls"][4], mix["calls"][3]
    ranges = taxi._ranges(tile)
    texts = taxi._covering(tile["pql"], ranges)
    assert len(texts) == 28
    leaves = set().union(*(taxi._leaves(parse(t)[0], set()) for t in texts))
    assert leaves == {("cab_type", c) for c in (0, 1)} \
        | {("pickup_year", y) for y in range(2009, 2016)} \
        | {("pickup_month", m) for m in range(1, 13)} \
        | {("pickup_mday", d) for d in range(1, 29)}

    def rides(m, h):
        return int(np.sum((data["pickup_month"] == m)
                          & (data["pickup_time"] == h)))
    counts = sorted(rides(m, h) for m in range(1, 13) for h in range(48))
    got = taxi._sparsest(q4["pql"], taxi._ranges(q4), data, 30_000, 5)
    assert len(set(got)) == 5
    drawn = [dict(taxi._leaves(parse(t)[0].kwargs["filter"], set()))
             for t in got]
    assert [rides(d["pickup_month"], d["pickup_time"])
            for d in drawn] == counts[:5]
