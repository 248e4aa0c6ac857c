"""``BENCHMARK.json`` and the files it names agree: every configuration,
mix and metric has its file, a mix holds only what a source of traffic
states, and the window's arrivals are one schedule for every seed."""

import json

import numpy as np
import pytest

from portbench import harness, loadgen
from portbench.gen import load_mix

BENCH = harness.load_bench()
MIX_KEYS = {"index", "rate_per_s", "pick", "calls"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(cell):
    conf = harness._named(BENCH["configs"], cell["config"], "configuration")
    with open(harness.ROOT / conf["file"]) as f:
        cfg = json.load(f)
    assert set(conf["reduced"]) == set(cfg["reduced"])
    mix = load_mix(str(harness.BENCH_DIR / "traffic"
                       / f"{cell['traffic']}.json"))
    assert set(mix) == MIX_KEYS
    for group in ("end_to_end", "per_layer"):
        for m in harness.cell_metrics(BENCH, cell["name"],
                                      group == "per_layer"):
            assert hasattr(harness.metric_reader(m["name"]), "read")


def test_arrivals_are_one_schedule_for_every_seed():
    a = loadgen.arrivals(2.5, 45.0)
    assert len(a) == 112
    assert np.array_equal(a, loadgen.arrivals(2.5, 45.0))
    assert (np.diff(a) > 0).all() and 0 < a[0] and a[-1] < 45.0


def test_requests_per_batch_counts_lone_flushes_as_batches_of_one():
    reader = harness.metric_reader("requests_per_batch")

    class Ctx:
        # 10 flushes, 2 of them of 3 and 4 requests: 8 alone.
        snaps = {"requests_per_batch": ((5, 1, 2), (15, 3, 9))}

    assert reader.read(Ctx) == pytest.approx((7 + 8) / 10)
