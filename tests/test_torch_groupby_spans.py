"""GroupBy's and BSI Sum's spans and counters: the ``Executor.groupBy``
span with its attributes, an ``Executor.launch`` span (``kernel=``)
around each counting kernel it launches, ``groupby_calls`` and
``groupby_launches`` on the executor and through the stats client, a
frontier forced to host memory (``spilled``, ``groupby_spill_events``)
with the same answer, and Sum's two launches."""

import numpy as np
import pytest

from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.executor.results import result_to_json
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import MemStatsClient
from pilosa_tpu_torch.utils.tracing import RecordingTracer

COLUMNS = 3000  # a shard's first columns, on each of two shards
ROWS = {"a": 3, "b": 4, "c": 5}
Q3 = "GroupBy(Rows(a), Rows(b), Rows(c), filter=Row(a=1))"
SUM = "Sum(Row(b=2), field=v)"


def small_holder(seed: int = 5) -> Holder:
    rng = np.random.default_rng(seed)
    holder = Holder(device="cpu")
    idx = holder.create_index("i", track_existence=False)
    cols = np.concatenate([np.arange(COLUMNS), SHARD_WIDTH
                           + np.arange(COLUMNS)]).astype(np.uint64)
    for name, n in ROWS.items():
        idx.create_field(name).import_bits(
            rng.integers(0, n, len(cols)).astype(np.uint64), cols)
    idx.create_field("v", FieldOptions(type="int", min=0, max=1000)) \
        .import_values(cols, rng.integers(0, 1001, len(cols)))
    return holder


def run(ex, tracer, pql):
    with tracer.span("test") as root:
        got = [result_to_json(r) for r in ex.execute("i", pql)]
    return got, root


def walk(span):
    yield span
    for c in span.children:
        yield from walk(c)


def named(root, name):
    return [s for s in walk(root) if s.name == name]


@pytest.fixture
def ex():
    ex = Executor(small_holder(), device="cpu")
    ex.result_cache.enabled = False
    ex.stats = MemStatsClient()
    return ex


def test_group_by_span_tree_and_counters(ex):
    tracer = RecordingTracer()
    got, root = run(ex, tracer, Q3)
    assert got[0]  # some groups
    (gb,) = named(root, "Executor.groupBy")
    a = gb.attrs
    assert a["children"] == 3 and a["spilled"] is False
    n_prefixes = len({tuple(g["rowID"] for g in grp["group"][:2])
                      for grp in got[0]})
    # Depth 0 expands the filter; the last depth every surviving
    # (a, b) prefix, a masked count each.
    assert a["prefixes"][0] == 1 and len(a["prefixes"]) == 3
    assert a["prefixes"][2] >= n_prefixes
    launches = named(gb, "Executor.launch")
    assert a["launches"] == len(launches)
    masked = [s for s in launches
              if s.attrs["kernel"] == "bank_row_counts_masked"]
    assert len(masked) == a["prefixes"][2]
    assert {s.attrs["kernel"] for s in launches} == {
        "bank_row_counts", "bank_row_counts_masked"}
    assert a["frontier_bytes"] > 0
    assert ex.groupby_calls == 1
    assert ex.groupby_launches == a["launches"]
    assert ex.groupby_spill_events == 0
    counters = ex.stats.counters
    assert counters["executor.groupby_calls"] == 1
    assert counters["executor.groupby_launches"] == a["launches"]
    # A second call adds to both.
    run(ex, tracer, "GroupBy(Rows(c))")
    assert ex.groupby_calls == 2
    assert ex.groupby_launches == a["launches"] + 1
    assert counters["executor.groupby_calls"] == 2


def test_forced_spill_sets_spilled_and_counts_it(ex):
    tracer = RecordingTracer()
    want, _ = run(ex, tracer, Q3)
    # Two rows of two shards' 2,048 words: the four (a=1, b) prefixes
    # pass it and leave the device.
    ex.GROUPBY_CHUNK_BYTES = 2 * 2 * 2048 * 4
    got, root = run(ex, tracer, Q3)
    assert got == want
    (gb,) = named(root, "Executor.groupBy")
    assert gb.attrs["spilled"] is True
    assert ex.groupby_spill_events == 1
    assert ex.stats.counters["executor.groupby_spill_events"] == 1
    assert gb.attrs["launches"] == len(named(gb, "Executor.launch"))


def test_sum_launches_are_spans(ex):
    tracer = RecordingTracer()
    got, root = run(ex, tracer, SUM)
    assert got[0]["count"] > 0
    kernels = [s.attrs["kernel"] for s in named(root, "Executor.launch")]
    assert kernels == ["bsi_plane_counts", "bank_row_counts"]
    assert ex.groupby_calls == 0


def test_no_span_open_records_nothing_and_still_counts(ex):
    got = ex.execute("i", Q3)
    assert got[0]
    assert ex.groupby_calls == 1 and ex.groupby_launches > 0
