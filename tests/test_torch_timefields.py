"""Differential tests of time, mutex and bool fields: the same seeded
writes (imports with timestamps, mutex imports with duplicate and
conflicting columns, PQL Sets, Clears, ClearRows and Stores) go into a
JAX holder and a port holder (``device="cpu"``); their views, bits and
answers through ``execute`` and ``execute_batch`` must be equal, and so
must the TopN cache tiers' counters after mutex writes. Also the time
cover against the JAX package's ``views_by_time_range`` and the error
messages of both."""

from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu.core import timeq as jax_timeq
from pilosa_tpu.core.cache import RANK_CACHE as JAX_RANK_CACHE
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import executor as jax_executor_mod
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.executor import executor as executor_mod
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import parse_string
from test_torch_groupby import counters, run, run_batch

QUANTA = ["Y", "M", "D", "H", "YM", "YMD", "YMDH", "MD", "MDH", "DH"]
BASE = datetime(2018, 12, 20)

# Field name -> options keywords (both packages' FieldOptions names).
FIELDS = {
    "t": {"type": "time", "time_quantum": "YMD"},
    "tn": {"type": "time", "time_quantum": "YMD", "no_standard_view": True},
    "th": {"type": "time", "time_quantum": "YMDH"},
    "m": {"type": "mutex"},
    "mr": {"type": "mutex", "cache_type": "none"},
    "b": {"type": "bool"},
    "c": {},
    "v": {"type": "int", "min": 0, "max": 1000},
}


def data(seed):
    """Seeded pairs: columns over three shards, rows, timestamps over
    60 days from BASE (one in twenty None), mutex rows with duplicate
    and conflicting columns, bool rows, set rows and int values."""
    rng = np.random.default_rng(seed)
    n = 2400
    cols = (rng.integers(0, 3, n) * SHARD_WIDTH
            + rng.integers(0, 40000, n)).astype(np.uint64)
    ts = [None if rng.random() < 0.05 else
          BASE + timedelta(days=int(d), hours=int(h))
          for d, h in zip(rng.integers(0, 60, n), rng.integers(0, 24, n))]
    m_cols = np.concatenate([cols, cols[rng.integers(0, n, 600)]])
    return {
        "cols": cols, "ts": ts,
        "t_rows": rng.integers(0, 4, n).astype(np.uint64),
        "m_cols": m_cols,
        "m_rows": rng.integers(1, 7, len(m_cols)).astype(np.uint64),
        "fix_rows": rng.integers(1, 7, 500).astype(np.uint64),
        "fix_cols": m_cols[rng.integers(0, len(m_cols), 500)],
        "b_rows": (rng.random(n) < 0.1).astype(np.uint64),
        "c_rows": rng.integers(0, 3, n).astype(np.uint64),
        "values": rng.integers(0, 1001, n),
    }


def load(holder, d, jax):
    """Create FIELDS on index "i" of ``holder`` and write ``d`` through
    the package's own Field API."""
    opts = JaxFieldOptions if jax else FieldOptions
    idx = holder.create_index("i")
    f = {name: idx.create_field(name, opts(**kw))
         for name, kw in FIELDS.items()}
    cols, ts = d["cols"], d["ts"]
    f["t"].import_bits(d["t_rows"], cols, timestamps=ts)
    f["tn"].import_bits(d["t_rows"], cols, timestamps=ts)
    f["th"].import_bits(d["t_rows"][:200], cols[:200], timestamps=ts[:200])
    for name in ("m", "mr"):
        f[name].import_bits(d["m_rows"], d["m_cols"])
        f[name].import_bits(d["fix_rows"], d["fix_cols"])
    f["b"].import_bits(d["b_rows"], cols)
    f["c"].import_bits(d["c_rows"], cols)
    uniq = np.unique(cols)
    f["v"].import_values(uniq, d["values"][:len(uniq)])
    idx.add_existence(cols)
    return idx


def build(path, seed=3):
    """(JAX holder, JAX executor, port executor) over the same writes."""
    JAX_RANK_CACHE.clear()
    d = data(seed)
    jh = JaxHolder(str(path))
    jh.open()
    load(jh, d, jax=True)
    th = Holder(device="cpu")
    load(th, d, jax=False)
    jex = JaxExecutor(jh)
    jex.result_cache.enabled = False
    tex = Executor(th, device="cpu")
    tex.result_cache.enabled = False
    return jh, jex, tex


def bits_of(field):
    """{view: {shard: {row: sorted in-shard offsets}}} of either
    package's field."""
    out = {}
    for vname, view in field.views.items():
        shards = out[vname] = {}
        for s, frag in view.fragments.items():
            rows = {}
            for r in frag.row_ids():
                words = np.asarray(frag.row_dense(r)).view(np.uint32)
                offs = np.flatnonzero(np.unpackbits(
                    words.view(np.uint8), bitorder="little"))
                if len(offs):
                    rows[int(r)] = offs.tolist()
            shards[s] = rows
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh, jex, tex = build(tmp_path_factory.mktemp("jax"))
    yield jex, tex
    jh.close()
    JAX_RANK_CACHE.clear()


# ------------------------------------------------------------------ cover


@pytest.mark.parametrize("quantum", QUANTA)
def test_cover_matches_jax(quantum):
    """views_by_time_range for fixed ranges (a month-end clamp, year
    and day edges) and seeded random ones, and views_by_time,
    min_max_views and time_of_view on what they give."""
    rng = np.random.default_rng(len(quantum) * 31 + ord(quantum[0]))
    ranges = [(datetime(2019, 1, 31), datetime(2019, 4, 2)),
              (datetime(2018, 12, 31, 22), datetime(2020, 3, 1, 5)),
              (datetime(1999, 12, 31), datetime(2002, 1, 1, 3)),
              (datetime(2019, 1, 3), datetime(2019, 1, 11)),
              (datetime(2019, 1, 5), datetime(2019, 1, 5))]
    for _ in range(40):
        a = datetime(2017, 1, 1) + timedelta(hours=int(rng.integers(0, 40000)))
        ranges.append((a, a + timedelta(hours=int(rng.integers(0, 9000)))))
    for start, end in ranges:
        got = timeq.views_by_time_range("standard", start, end, quantum)
        assert got == jax_timeq.views_by_time_range("standard", start, end,
                                                    quantum)
        assert timeq.views_by_time("standard", start, quantum) == \
            jax_timeq.views_by_time("standard", start, quantum)
        assert timeq.min_max_views(got, quantum) == \
            jax_timeq.min_max_views(got, quantum)
        for v in got[:3]:
            for adj in (False, True):
                assert timeq.time_of_view(v, adj) == \
                    jax_timeq.time_of_view(v, adj)
    assert len(timeq.views_by_time_range(
        "standard", datetime(2019, 1, 3), datetime(2019, 1, 11), "YMD")) == 8


@pytest.mark.parametrize("quantum", QUANTA)
def test_time_clear_quantums_match_jax(tmp_path, quantum):
    """The reference's RowsTimeEmpty and Time_Clear_Quantums scripts on
    both packages, through execute and execute_batch."""
    jh = JaxHolder(str(tmp_path))
    jh.open()
    jidx = jh.create_index("i")
    jidx.create_field("f", JaxFieldOptions(type="time",
                                           time_quantum=quantum))
    th = Holder(device="cpu")
    th.create_index("i").create_field("f", FieldOptions(
        type="time", time_quantum=quantum))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    # No data yet: a ranged Rows is empty (test_rows_time_empty).
    empty = "Rows(f, from=1999-12-31T00:00, to=2002-01-01T03:00)"
    assert run(tex, empty) == run(jex, empty) == [("rows", [])]
    script = """Set(2, f=1, 1999-12-31T00:00) Set(3, f=1, 2000-01-01T00:00)
        Set(4, f=1, 2000-01-02T00:00) Set(5, f=1, 2000-02-01T00:00)
        Set(6, f=1, 2001-01-01T00:00) Set(7, f=1, 2002-01-01T02:00)
        Set(2, f=1, 1999-12-30T00:00) Set(2, f=1, 2002-02-01T00:00)
        Set(2, f=10, 2001-01-01T00:00)"""
    assert run(tex, script) == run(jex, script)
    assert run(tex, "Clear(2, f=1)") == run(jex, "Clear(2, f=1)")
    assert sorted(th.index("i").field("f").views) == \
        sorted(jidx.field("f").views)
    reads = ["Row(f=1, from=1999-12-31T00:00, to=2002-01-01T03:00)",
             "Count(Row(f=10, from=2000-06-01T00:00, to=2001-02-01T00:00))",
             "Rows(f, from=2000-01-01T00:00, to=2002-01-01T00:00)"]
    want = [run(jex, q) for q in reads]
    assert [run(tex, q) for q in reads] == want
    assert run_batch(tex, reads) == want
    jh.close()


# ---------------------------------------------------------------- writes


def test_imports_land_in_the_same_views_and_bits(pair):
    """Timestamped, no-standard-view, hourly, mutex (duplicates and
    conflicts) and bool imports: identical view names and bits, and the
    same mutex_vector for every written column."""
    jex, tex = pair
    jidx, tidx = jex.holder.index("i"), tex.holder.index("i")
    for name in FIELDS:
        jf, tf = jidx.field(name), tidx.field(name)
        assert sorted(tf.views) == sorted(jf.views), name
        assert bits_of(tf) == bits_of(jf), name
    assert "standard" not in tidx.field("tn").views
    assert len(tidx.field("th").views) > 150
    d = data(3)
    for name in ("m", "b"):
        jv, tv = jidx.field(name).view(), tidx.field(name).view()
        for col in np.unique(d["m_cols"])[::7].tolist():
            s = col // SHARD_WIDTH
            assert tv.fragment(s).mutex_vector(col) == \
                jv.fragment(s).mutex_vector(col), (name, col)
    # Mutex: one row a column.
    tf = tidx.field("m").view()
    for frag in tf.fragments.values():
        total = sum(frag.row_count(r) for r in frag.row_ids())
        cols = np.concatenate([np.asarray(o) for o in bits_of(
            tidx.field("m"))["standard"][frag.shard].values()])
        assert total == len(np.unique(cols))


@pytest.mark.parametrize("seed", range(4))
def test_mutex_import_matches_jax_on_random_batches(tmp_path, seed):
    """Fragment.bulk_import_mutex against the JAX package's on random
    batches with duplicate and conflicting columns over a populated
    fragment: the same bits, row counts and count caches."""
    from pilosa_tpu.core.fragment import Fragment as JaxFragment
    from pilosa_tpu_torch.core.fragment import Fragment
    rng = np.random.default_rng([41, seed])
    jf = JaxFragment(str(tmp_path / "frag"), "i", "m", "standard", 1)
    jf.open()
    tf = Fragment(1)
    for _ in range(3):
        n = int(rng.integers(1, 400))
        cols = SHARD_WIDTH + rng.integers(0, 300, n).astype(np.uint64)
        rows = rng.integers(0, 5, n).astype(np.uint64)
        jf.bulk_import_mutex(rows, cols)
        tf.bulk_import_mutex(rows, cols)
        assert tf.row_ids() == tuple(jf.row_ids())
        for r in tf.row_ids():
            assert tf.row_count(r) == jf.row_count(r)
            np.testing.assert_array_equal(
                tf.row_dense(r), np.asarray(jf.row_dense(r)).view(np.uint32))
        assert dict(tf.cache.counts) == dict(jf.cache.counts)
    jf.close()


WRITE_SCRIPT = [
    "Count(Row(t=1, from='2019-01-29', to='2019-02-01'))",
    "Set(5, t=1, 2019-01-30T08:00)",
    "Count(Row(t=1, from='2019-01-29', to='2019-02-01'))",
    "Set(6, t=1, 2019-03-01T08:00)",
    "Row(t=1, from='2019-02-15', to='2019-03-02')",
    f"Set({SHARD_WIDTH + 7}, c=1, 2019-01-01T00:00)",
    "Set(9, m=3)", "Set(9, m=4)", "Row(m=3)", "Row(m=4)", "TopN(m)",
    "Set(9, b=true)", "Set(9, b=false)", "Row(b=true)", "Row(b=false)",
    "Set(9, m=4, 2019-01-01T00:00)", "Clear(9, m=4)", "Row(m=4)",
    "ClearRow(m=2)", "Rows(m)", "ClearRow(b=false)", "Rows(b)",
    "ClearRow(t=1)", "Rows(t, from='2018-12-01', to='2019-04-01')",
    "Store(Row(t=2, from='2019-01-05', to='2019-01-12'), t=3)",
    "Row(t=3)", "Count(Row(t=3, from='2019-01-05', to='2019-01-12'))",
    "Set(11, tn=1)", "Set(11, tn=1, 2019-01-04T00:00)", "Rows(tn)",
    "Rows(tn, from='2019-01-04', to='2019-01-05')",
    "Set(12, v=5, 2019-01-01T00:00)", "Sum(field=v)",
    "Store(Row(c=1), m=1)", "ClearRow(v=1)",
    "Count(Row(t=0, from='2019-01-01', to='2019-02-01'))",
]

PROBES = ["Rows(t)", "Rows(m)", "Rows(b)", "TopN(m)", "TopN(b)",
          "Count(Row(m=4))", "Count(Row(t=2, from='2019-01-03', "
          "to='2019-01-11'))"]


def test_write_script_matches_jax(tmp_path):
    """Timestamped, mutex and bool Sets, Clear, ClearRow on time, mutex
    and bool fields, Store into a time field, and the refusals among
    them: each answer, and the probes after it, equal to the JAX
    package's; then every field's views and bits."""
    jh, jex, tex = build(tmp_path, seed=5)
    for pql in WRITE_SCRIPT:
        assert run(tex, pql) == run(jex, pql), pql
        for probe in PROBES:
            assert run(tex, probe) == run(jex, probe), (pql, probe)
    for name in FIELDS:
        assert bits_of(tex.holder.index("i").field(name)) == \
            bits_of(jex.holder.index("i").field(name)), name
    jh.close()


# ----------------------------------------------------------------- reads


READS = [
    "Row(t=1, from='2019-01-03', to='2019-01-11')",
    "Count(Row(t=1, from='2019-01-05', to='2019-01-12'))",
    "Count(Row(t=1, from='2019-01-02', to='2019-01-20'))",
    "Row(t=2, from='2019-01-01', to='2019-02-01')",
    "Count(Row(t=3, from='2018-12-25', to='2019-02-03'))",
    "Row(t=1, from='2020-01-01', to='2020-02-01')",
    "Count(Row(t=0, from='2018-01-01', to='2020-01-01'))",
    "Count(Row(t=1, to='2019-01-10'))", "Row(t=1, from='2019-01-10')",
    "Row(t=1)", "Count(Row(t=9, from='2019-01-01', to='2019-02-01'))",
    "Range(t=1, from='2019-01-03', to='2019-01-11')",
    "Count(Range(t=2, from='2019-01-02', to='2019-01-20'))",
    "Count(Intersect(Row(t=1, from='2019-01-05', to='2019-01-12'), "
    "Row(c=1)))",
    "Union(Row(t=0, from='2019-01-05', to='2019-01-06'), "
    "Row(t=3, from='2018-12-30', to='2019-01-20'))",
    "Count(Not(Range(t=1, from='2019-01-01', to='2019-02-01')))",
    "Count(Difference(Row(c=0), Row(t=2, from='2019-01-02', "
    "to='2019-01-20')))",
    "TopN(c, Row(t=1, from='2019-01-05', to='2019-01-12'), n=2)",
    "TopN(c, Row(t=1, from='2019-01-02', to='2019-01-20'))",
    "TopN(t)", "TopN(t, n=2)", "TopN(m)", "TopN(m, n=3)", "TopN(b)",
    "Sum(Row(t=0, from='2019-01-05', to='2019-01-12'), field=v)",
    "Sum(Row(t=0, from='2019-01-02', to='2019-01-20'), field=v)",
    "Rows(t, from='2019-01-05', to='2019-01-12')", "Rows(t)",
    "Rows(t, from='2030-01-01')", "Rows(t, to='2000-01-01')",
    "Rows(tn)", "Rows(tn, from='2019-01-10', to='2019-01-11')",
    f"Rows(t, column={SHARD_WIDTH + 12}, from='2019-01-01')",
    "Rows(th, from='2019-01-05T03:00', to='2019-01-06T05:00')",
    "Rows(m)", "Rows(b)", "Rows(m, previous=2, limit=2)",
    "Row(m=3)", "Count(Row(m=5))", "Row(b=true)", "Count(Row(b=false))",
    "Count(Row(b=1))", "Row(tn=1, from='2019-01-03', to='2019-01-11')",
    "Row(tn=1)", "Count(Row(th=2, from='2019-01-05T03:00', "
    "to='2019-01-09T05:00'))",
    "GroupBy(Rows(t, from='2019-01-05', to='2019-01-12'), Rows(c))",
    "GroupBy(Rows(m), Rows(b))", "GroupBy(Rows(b), Rows(c), Rows(m))",
    "GroupBy(Rows(m), filter=Row(t=1, from='2019-01-01', to='2019-02-01'))",
    "Row(c=1, from='2019-01-01')", "Rows(c, to='2019-01-01')",
    "Row(t=1, from='bad')", "Count(Range(c=2, from='2019-01-01', "
    "to='2019-02-01'))",
]

# The reads above that both packages refuse.
REFUSED = {
    "Row(t=1, from='2019-01-10')", "Row(c=1, from='2019-01-01')",
    "Rows(c, to='2019-01-01')", "Row(t=1, from='bad')",
    "Count(Range(c=2, from='2019-01-01', to='2019-02-01'))",
}


@pytest.mark.parametrize("pql", READS)
def test_reads_match_jax(pair, pql):
    jex, tex = pair
    want = run(jex, pql)
    assert run(tex, pql) == want
    assert (want[0] == "error") == (pql in REFUSED), want


def test_reads_in_one_batch_match_jax(pair, monkeypatch):
    """Every read in one execute_batch, megakernel on in both packages:
    equal to the JAX package's batch and to execute one by one."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
    jex, tex = pair
    got = run_batch(tex, READS)
    assert got == run_batch(jex, READS)
    assert got == [run(tex, q) for q in READS]


@pytest.mark.parametrize("to,n_views,lowers", [
    ("2019-01-06", 1, True), ("2019-01-12", 7, True),
    ("2019-01-13", 8, True), ("2019-01-14", 9, False),
    ("2019-02-01", 27, False)])
def test_range_lowers_to_an_or_fold(pair, monkeypatch, to, n_views, lowers):
    """A range over at most eight existing views stages one slot a view
    and an OR fold, and a burst holding it takes one megakernel launch;
    a wider one is an eager union the batch counts as unlowered. The
    answer equals execute's and the JAX package's."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    jex, tex = pair
    pql = f"Count(Row(t=1, from='2019-01-05', to='{to}'))"
    idx = tex.holder.index("i")
    staged = tex._stage_tree(idx, parse_string(pql).calls[0].children[0],
                             idx.available_shards(), "count")
    if lowers:
        assert staged.ir is not None
        assert staged.ir[-1] == ("fold", "or", n_views)
        assert sum(node[0] == "slot" for node in staged.ir) == n_views
    else:
        assert staged.ir is None
    before = (tex.mega_launches, tex.mega_unlowered, tex.mega_fallbacks)
    got = run_batch(tex, [pql, "Count(Row(m=2))", "Count(Row(b=true))"])
    assert got == [run(jex, q) for q in (pql, "Count(Row(m=2))",
                                         "Count(Row(b=true))")]
    assert (tex.mega_launches - before[0], tex.mega_unlowered - before[1],
            tex.mega_fallbacks - before[2]) == \
        ((1, 0, 0) if lowers else (1, 1, 0))


@pytest.mark.parametrize("batch", [False, True])
def test_wide_range_builds_one_row_banks(tmp_path, monkeypatch, batch):
    """A cover of more than eight views reads a bank of the one row in
    each view, never a view's full bank of every row, through execute
    and through execute_batch; the answers equal the JAX package's."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    jh, jex, tex = build(tmp_path, seed=5)
    reqs = [f"Count(Row(t={r}, from='2019-01-05', to='2019-02-01'))"
            for r in (1, 2)]
    got = run_batch(tex, reqs) if batch else [run(tex, q) for q in reqs]
    assert got == [run(jex, q) for q in reqs]
    field = tex.holder.index("i").field("t")
    cover = [v for v in field.views_for_range(datetime(2019, 1, 5),
                                              datetime(2019, 2, 1))
             if field.view(v) is not None]
    assert len(cover) > executor_mod.MAX_STATIC_RANGE_VIEWS
    for v in cover:
        keys = list(field.view(v)._bank_cache)
        assert sorted(k[2] for k in keys) == [(1,), (2,)], (v, keys)
        for k in keys:
            assert field.view(v)._bank_cache[k].array.shape[0] == 2
    jh.close()


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("pql", [
    "Count(Row(t=1, from='2019-01-05', to='2019-02-01'))",
    "Count(Shift(Row(c=1), n=3))"])
def test_lone_unlowered_eval_is_counted(pair, monkeypatch, enabled, pql):
    """A batch whose only eval has no IR (a range over more than eight
    views, a Shift) counts it once in mega_unlowered, with the
    megakernel on or off, and answers as execute does."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", enabled)
    jex, tex = pair
    before = (tex.mega_unlowered, tex.mega_launches)
    assert run_batch(tex, [pql]) == [run(jex, pql)]
    assert (tex.mega_unlowered - before[0],
            tex.mega_launches - before[1]) == (1, 0)


def test_new_day_view_changes_the_batch_cover(tmp_path, monkeypatch):
    """A Set that makes a new day view inside a range changes the
    cover: the next batch (same shape of request, a plan signature
    verified before) counts it."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    jh, jex, tex = build(tmp_path, seed=6)
    reqs = ["Count(Row(t=1, from='2019-03-01', to='2019-03-08'))",
            "Count(Row(t=1, from='2019-01-05', to='2019-01-12'))",
            "Count(Row(m=3))"]
    first = run_batch(tex, reqs)
    assert first == run_batch(jex, reqs) and first[0] == [0]
    for ex in (jex, tex):
        ex.execute("i", "Set(77, t=1, 2019-03-03T10:00) "
                        "Set(78, t=1, 2019-01-07T10:00)")
    second = run_batch(tex, reqs)
    assert second == run_batch(jex, reqs)
    assert second[0] == [1] and second[1] == [first[1][0] + 1]
    jh.close()


def test_burst_past_the_slot_cap_launches_once(pair, monkeypatch):
    """A burst whose ranges gather more than 256 slot registers (the
    kernel's shared-memory slot cap) still takes one launch; past the
    register limit the budget fallback answers per group. Both exact."""
    from pilosa_tpu_torch.ops import megakernel as mk
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    jex, tex = pair
    reqs = [f"Count(Row({f}={r}, "
            f"from='{BASE + timedelta(days=d):%Y-%m-%d}', "
            f"to='{BASE + timedelta(days=d + 8):%Y-%m-%d}'))"
            for f in ("t", "tn") for r in range(4) for d in range(0, 64, 4)]
    want = [run(jex, q) for q in reqs]
    n_slots = []
    real = mk.run_program
    monkeypatch.setattr(mk, "run_program", lambda plan, *a: (
        n_slots.append(plan.n_slots), real(plan, *a))[1])
    before = (tex.mega_launches, tex.mega_budget_fallbacks)
    assert run_batch(tex, reqs) == want
    assert tex.mega_launches == before[0] + 1 and n_slots[0] > 256
    monkeypatch.setattr(kernels, "MEGA_MAX_REGS", 128)
    before = (tex.mega_launches, tex.mega_budget_fallbacks)
    assert run_batch(tex, reqs) == want
    assert tex.mega_launches == before[0]
    assert tex.mega_budget_fallbacks > before[1]


# ----------------------------------------------------------- cache tiers


RANK_SCRIPT = [
    "TopN(m, n=3)", "TopN(m, n=3)", "TopN(mr, n=3)", "TopN(mr, n=3)",
    "Set(3, m=6)", "Set(3, mr=6)", "TopN(m, n=3)", "TopN(mr, n=3)",
    f"Set({SHARD_WIDTH + 5}, m=1)", f"Set({SHARD_WIDTH + 5}, mr=1)",
    "TopN(m)", "TopN(mr)", "import", "TopN(m, n=4)", "TopN(mr, n=4)",
    "TopN(m, n=4)", "Set(3, b=true)", "TopN(b)", "TopN(b)",
    "ClearRow(mr=2)", "TopN(mr)", "Clear(3, mr=6)", "TopN(mr, n=2)",
    "Set(3, b=false)", "TopN(b)",
]


@pytest.mark.parametrize("every", [256, 2])
def test_rank_tiers_after_mutex_writes_follow_jax(tmp_path, monkeypatch,
                                                  every):
    """The warm count caches (m, b) and the device rank vector (mr, no
    count cache) through mutex Sets that move columns between rows, a
    mutex import with conflicts and ClearRow: answers and every counter
    equal to the JAX executor's at each step."""
    monkeypatch.setattr(executor_mod, "TOPN_SELFCHECK_EVERY", every)
    monkeypatch.setattr(jax_executor_mod, "TOPN_SELFCHECK_EVERY", every)
    jh, jex, tex = build(tmp_path, seed=7)
    rng = np.random.default_rng(71)
    cols = (rng.integers(0, 3, 300) * SHARD_WIDTH
            + rng.integers(0, 40000, 300)).astype(np.uint64)
    rows = rng.integers(1, 7, 300).astype(np.uint64)
    for pql in RANK_SCRIPT:
        if pql == "import":
            for ex in (jex, tex):
                for name in ("m", "mr"):
                    ex.holder.index("i").field(name).import_bits(rows, cols)
            continue
        assert run(tex, pql) == run(jex, pql), pql
        assert counters(tex) == counters(jex), pql
    hits, checks, rhits, patches, rebuilds = counters(tex)
    assert hits > checks > 0 and rhits > 0 and patches > 0 and rebuilds > 0
    assert tex.topn_selfcheck_mismatches == 0
    jh.close()
    JAX_RANK_CACHE.clear()


# ---------------------------------------------------------------- errors


@pytest.mark.parametrize("kw", [
    {"type": "time"}, {"type": "time", "time_quantum": "DY"},
    {"type": "time", "time_quantum": "YMX"}, {"type": "bogus"}])
def test_field_option_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxFieldOptions(**kw).validate()
    with pytest.raises(ValueError) as got:
        FieldOptions(**kw).validate()
    assert str(got.value) == str(want.value)


def test_timestamp_errors_match_jax(pair):
    """A timestamp on a set, mutex or bool field, in PQL and in an
    import: the JAX package's messages."""
    jex, tex = pair
    for pql in ("Set(1, c=1, 2019-01-01T00:00)",
                "Set(1, m=1, 2019-01-01T00:00)",
                "Set(1, b=true, 2019-01-01T00:00)",
                "Row(c=1, from='2019-01-01', to='2019-01-02')"):
        assert run(tex, pql) == run(jex, pql)
        assert run(tex, pql)[0] == "error"
    assert "cannot set timestamp on set field" in \
        run(tex, "Set(1, c=1, 2019-01-01T00:00)")[1]
    assert "from/to on non-time field c" in \
        run(tex, "Row(c=1, from='2019-01-01', to='2019-01-02')")[1]
    msgs = []
    for ex in (jex, tex):
        with pytest.raises(ValueError) as e:
            ex.holder.index("i").field("c").import_bits(
                [1], [1], timestamps=[datetime(2019, 1, 1)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "timestamps on non-time field"


def test_schema_matches_jax(pair):
    jex, tex = pair
    assert tex.holder.schema() == jex.holder.schema()


def test_cpu_path_launches_no_kernel(pair):
    _, tex = pair
    before = dict(kernels.LAUNCHES)
    run(tex, "Count(Row(t=1, from='2019-01-02', to='2019-01-20')) "
             "TopN(c, Row(t=1, from='2019-01-05', to='2019-01-12'))")
    assert kernels.LAUNCHES == before


# ----------------------------------------------------- values and row_time


def test_field_value_matches_jax(pair, tmp_path):
    """``Field.value`` on every imported column and on columns with no
    value (in and out of an existing shard) as the JAX package answers,
    then after sets on a fresh int field with a negative minimum;
    fields of other types raise alike."""
    jex, tex = pair
    jf, tf = (ex.holder.index("i").field("v") for ex in (jex, tex))
    cols = [int(c) for c in np.unique(data(3)["cols"])]
    cols += [SHARD_WIDTH + 40001, 7 * SHARD_WIDTH + 3, 0]
    got = [tf.value(c) for c in cols]
    assert got == [jf.value(c) for c in cols]
    assert any(ok for _, ok in got) and (0, False) in got
    for name in ("c", "t", "m", "b"):
        for ex in (jex, tex):
            with pytest.raises(ValueError, match="not an int field"):
                ex.holder.index("i").field(name).value(cols[1])
    jh = JaxHolder(str(tmp_path))
    jh.open()
    fields = [h.create_index("w").create_field("n", o(
        type="int", min=-50, max=70)) for h, o in (
            (jh, JaxFieldOptions), (Holder(device="cpu"), FieldOptions))]
    probe = [3, 4, SHARD_WIDTH + 9]
    assert [fields[1].value(c) for c in probe] == [(0, False)] * 3
    for c, v in ((3, -50), (4, 70), (SHARD_WIDTH + 9, 0), (3, -7)):
        for f in fields:
            f.set_value(c, v)
        assert fields[1].value(c) == fields[0].value(c) == (v, True)
    assert [fields[1].value(c) for c in probe + [5]] == \
        [fields[0].value(c) for c in probe + [5]]
    jh.close()


@pytest.mark.parametrize("quantum", ["Y", "M", "D", "H"])
def test_row_time_picks_the_jax_view(pair, quantum):
    """``Field.row_time`` returns the view of the time's unit (None when
    there is none) that the JAX package's returns, with the same bits."""
    jex, tex = pair
    for name in ("t", "th"):
        jf, tf = (ex.holder.index("i").field(name) for ex in (jex, tex))
        for t in (BASE + timedelta(days=3, hours=5), BASE,
                  BASE + timedelta(days=400)):
            jv, tv = jf.row_time(1, t, quantum), tf.row_time(1, t, quantum)
            assert (tv is None) == (jv is None), (name, t, quantum)
            if tv is not None:
                assert tv.name == jv.name
                assert bits_of_view(tv) == bits_of_view(jv)


def bits_of_view(view):
    return {s: {int(r): int(f.row_count(r)) for r in f.row_ids()}
            for s, f in view.fragments.items()}
