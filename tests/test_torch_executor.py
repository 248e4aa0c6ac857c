"""Differential tests of the whole slice: the same index (a set field, int
fields and existence, built from a numpy seed in the JAX package) is
carried to pilosa_tpu_torch with load_state, and a fixed list of PQL
queries is replayed through both Executors. Results must be equal.
Also: the port imports neither jax nor pilosa_tpu, and its entry points
refuse to run without CUDA unless told device="cpu"."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor.results import PairsResult as JaxPairs
from pilosa_tpu.executor.results import RowIdentifiers as JaxRowIds
from pilosa_tpu.executor.results import RowResult as JaxRow
from pilosa_tpu.executor.results import ValCount as JaxValCount
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch import Executor, FieldOptions, Holder, load_state
from pilosa_tpu_torch.core.field import bit_depth_for_range
from pilosa_tpu_torch.executor.executor import ExecutionError
from pilosa_tpu_torch.ops import kernels

BIG_MAX = 1 << 40


def state_from_jax(holder):
    """Port interchange dict from a JAX Holder, through its public API:
    every view's bits, the keyed stores' (key, id) entries and the row
    and column attributes."""
    state = {}
    for iname, idx in holder.indexes.items():
        fields = state[iname] = {}
        fields["@index"] = {
            "options": {"keys": idx.keys},
            "keys": idx.column_translator.entries() if idx.keys else [],
            "column_attrs": dict(idx.column_attr_store.attrs)}
        for fname, field in idx.fields.items():
            views = {}
            for vname, view in field.views.items():
                shards = views[vname] = {}
                for shard, frag in view.fragments.items():
                    base = np.uint64(shard * SHARD_WIDTH)
                    shards[shard] = {r: frag.row_columns(r) - base
                                     for r in frag.row_ids()}
            fields[fname] = {
                "options": dataclasses.asdict(field.options),
                "views": views,
                "keys": field.row_translator.entries()
                if field.options.keys else [],
                "row_attrs": dict(field.row_attr_store.attrs)}
    return state


def build_jax_index(path, seed=11):
    """Three shards; rows of f and g at different column spans (so banks
    trim to different widths); int fields v (depth 11) and big (depth
    41); existence over every written column plus extra columns."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index("i")
    spans = {0: 70000, 1: 3000, 2: 200000}
    f_rows, f_cols, g_rows, g_cols = [], [], [], []
    for shard, span in spans.items():
        base = shard * SHARD_WIDTH
        for r in range(8):
            k = int(rng.integers(20, 400))
            f_rows += [r] * k
            f_cols += (base + rng.integers(0, span, k)).tolist()
        for r in (1, 2, 3):
            k = int(rng.integers(50, 300))
            g_rows += [r] * k
            g_cols += (base + rng.integers(0, span // 2, k)).tolist()
    f = idx.create_field("f")
    f.import_bits(np.array(f_rows, np.uint64), np.array(f_cols, np.uint64))
    g = idx.create_field("g")
    g.import_bits(np.array(g_rows, np.uint64), np.array(g_cols, np.uint64))
    cols = np.unique(np.array(f_cols + g_cols, np.uint64))
    v_cols = cols[rng.random(len(cols)) < 0.6]
    v = idx.create_field("v", JaxFieldOptions(type="int", min=-10, max=1000))
    v.import_values(v_cols, rng.integers(-10, 1001, len(v_cols)))
    b_cols = cols[rng.random(len(cols)) < 0.4]
    big = idx.create_field("big", JaxFieldOptions(type="int", min=0,
                                                  max=BIG_MAX))
    big_vals = rng.integers(0, BIG_MAX + 1, len(b_cols), dtype=np.int64)
    big_vals[:3] = [0, BIG_MAX, BIG_MAX - 1]
    big.import_values(b_cols, big_vals)
    extra = np.array([5, SHARD_WIDTH + 77, 2 * SHARD_WIDTH + 199999],
                     np.uint64)
    idx.add_existence(np.concatenate([cols, extra]))
    return h


def same(jax_res, port_res):
    if isinstance(jax_res, JaxRow):
        np.testing.assert_array_equal(port_res.columns(), jax_res.columns())
        assert port_res.count() == jax_res.count()
    elif isinstance(jax_res, JaxPairs):
        assert port_res.pairs == jax_res.pairs
    elif isinstance(jax_res, JaxValCount):
        assert (port_res.value, port_res.count) == \
            (jax_res.value, jax_res.count)
    elif isinstance(jax_res, JaxRowIds):
        assert port_res.rows == jax_res.rows
    elif isinstance(jax_res, list):
        assert [g.to_json() for g in port_res] == \
            [g.to_json() for g in jax_res]
    else:
        assert port_res == jax_res


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh = build_jax_index(tmp_path_factory.mktemp("jax"))
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    yield JaxExecutor(jh), Executor(th, device="cpu")
    jh.close()


READ_QUERIES = [
    "Row(f=1)", "Row(g=2)", "Row(f=99)", "Row(f=true)",
    "Count(Row(f=1))", "Count(Row(f=99))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Intersect(Row(f=1), Row(f=2), Row(g=1)))",
    "Count(Intersect(Row(g=1), Row(v > 500)))",
    "Intersect(Row(f=0), Row(f=5))",
    "Count(Union(Row(f=1), Row(g=3)))", "Union(Row(f=6), Row(g=1), Row(f=7))",
    "Count(Difference(Row(f=1), Row(g=2)))", "Difference(Row(g=3), Row(f=3))",
    "Count(Xor(Row(f=3), Row(g=1)))", "Xor(Row(f=4), Row(f=5))",
    "Not(Row(f=1))", "Count(Not(Union(Row(f=1), Row(g=1))))",
    "Not(Not(Row(g=2)))",
    "Shift(Row(f=2), n=1)", "Shift(Row(g=1), n=70000)",
    "Count(Shift(Row(f=4), n=33))", "Shift(Row(f=0))",
    "Shift(Shift(Row(g=3), n=31), n=2)",
    "Row(v < 100)", "Row(v <= 100)", "Row(v > -5)", "Row(v >= 1000)",
    "Row(v == 7)", "Row(v != 7)", "Row(v >< [-3, 250])", "Row(v < -100)",
    "Row(v > 5000)", "Row(v == 5000)", "Row(v != 5000)", "Row(v < 5000)",
    "Row(v >= -100)", "Row(-5 < v < 50)", "Row(v >< [300, 20])",
    "Count(Row(big > 1099511627000))", "Row(big >< [5, 549755813888])",
    "Count(Row(big == 1099511627776))", "Count(Row(big < 4294967296))",
    "TopN(f, n=3)", "TopN(f)", "TopN(f, Row(g=1), n=4)",
    "TopN(f, ids=[1,3,5], n=2)", "TopN(f, threshold=500)",
    "TopN(f, Row(g=2), tanimotoThreshold=10)",
    "TopN(f, Row(f=4), tanimotoThreshold=10)",
    "TopN(f, Row(f=4), tanimotoThreshold=100)",
    "TopN(f, Union(Row(f=4), Row(f=5)), tanimotoThreshold=45, n=5)",
    "TopN(g, Not(Row(f=1)), n=2)", "TopN(v, n=2)",
    "TopN(f, Row(v > 990), n=3)",
    "Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)",
    "Max(field=v)", "Min(Row(f=1), field=v)", "Max(Row(g=3), field=v)",
    "Min(Row(f=99), field=v)", "Max(Row(f=99), field=v)",
    "Sum(Row(f=99), field=v)", "Sum(field=big)", "Max(field=big)",
    "Min(field=big)", "Min(Intersect(Row(f=1), Row(v > 500)), field=big)",
    "Count(Row(f=1)) Count(Row(g=1)) TopN(g, n=1)",
]


@pytest.mark.parametrize("pql", READ_QUERIES)
def test_read_queries_match_jax(pair, pql):
    jex, tex = pair
    want = jex.execute("i", pql)
    got = tex.execute("i", pql)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        same(w, g)


WRITE_SCRIPT = [
    "Set(5, f=1)", "Set(5, f=1)", "Count(Row(f=1))", "Clear(5, f=1)",
    "Clear(5, f=1)", "Set(3000000, f=2)", "Row(f=2)", "Set(7, v=42)",
    "Set(7, v=42)", "Set(7, v=-3)", "Row(v == -3)", "Clear(7, v=0)",
    "Row(v == -3)", "Set(9, big=1099511627775)",
    "Count(Row(big > 1099511627774))", "Not(Row(f=1))", "TopN(f, n=3)",
    "Sum(field=v)", "Set(4194304, g=1)", "Not(Row(g=1))",
    "Store(Intersect(Row(f=1), Row(g=2)), f=50)", "Row(f=50)",
    "Count(Row(f=50))", "TopN(f, n=4)", "Rows(f)",
    "GroupBy(Rows(f, previous=40), Rows(g))", "ClearRow(f=50)",
    "ClearRow(f=50)", "Row(f=50)", "Rows(f)", "TopN(f, n=4)",
    "Store(Row(g=1), fresh=3)", "Row(fresh=3)", "Rows(fresh)",
    "Count(Row(fresh=3))", "Store(Not(Row(f=2)), f=2)", "Count(Row(f=2))",
    "ClearRow(f=1)", "Count(Row(f=1))", "TopN(f)", "ClearRow(f=99)",
    "Store(Row(f=99), g=3)", "Rows(g)", "GroupBy(Rows(f), Rows(g))",
    "Set(5, f=1) ClearRow(f=1) Count(Row(f=1))",
    "Store(Row(g=1), f=3)", "Row(f=3)", "TopN(f, n=5)",
]


def test_write_script_matches_jax(tmp_path):
    jh = build_jax_index(tmp_path, seed=5)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    for pql in WRITE_SCRIPT:
        want, got = jex.execute("i", pql), tex.execute("i", pql)
        assert len(got) == len(want), pql
        for w, g in zip(want, got):
            same(w, g)
    jh.close()


@pytest.mark.parametrize("pql", [
    "ClearRow(v=1)", "ClearRow(nope=1)", "Store(Row(f=1), v=2)",
    "Store(Row(f=1), Row(g=1), f=3)", "ClearRow(f='a')",
    "Store(Row(f=1), f='a')", "Set(3, f='a')",
])
def test_write_errors_match_jax(tmp_path, pql):
    jh = build_jax_index(tmp_path, seed=5)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    with pytest.raises(Exception) as want:
        jex.execute("i", pql)
    with pytest.raises(ExecutionError) as got:
        tex.execute("i", pql)
    assert str(got.value) == str(want.value)
    for q in ("Rows(f)", "Rows(g)", "Count(Row(f=1))"):
        same(jex.execute("i", q)[0], tex.execute("i", q)[0])
    jh.close()


def both_ways(tex, pql):
    """``pql`` through execute and as a one-request execute_batch: the
    two results (or the two errors)."""
    try:
        direct = tex.execute("i", pql)
    except ExecutionError as e:
        direct = e
    (batched,) = tex.execute_batch([("i", pql, None)])
    if not isinstance(batched, Exception):
        batched = batched[0]
    return direct, batched


@pytest.mark.parametrize("pql", [
    "Shift(Row(f=1), n=-1)", "Count(Shift(Row(f=1), n=-3))",
    "Row(v >< [5, 6, 7])", "Count(Row(v >< [-3, 250, 900]))",
    "Row(f='a')", "Count(Intersect(Row(f=1), Row(g='b')))",
])
def test_queue_c_faults_answer_like_jax(pair, pql):
    """Negative Shift, a range of three values and a string row on a
    field without keys: the JAX package's answer or message, through
    execute and through execute_batch."""
    jex, tex = pair
    try:
        want = jex.execute("i", pql)
    except Exception as e:  # noqa: BLE001 — the reference's error
        want = e
    for got in both_ways(tex, pql):
        if isinstance(want, Exception):
            assert isinstance(got, ExecutionError), (pql, got)
            assert str(got) == str(want)
        else:
            for w, g in zip(want, got):
                same(w, g)


def test_one_value_range_is_a_recorded_divergence(pair):
    """``Row(v >< [5])``: the reference fails with an internal IndexError
    (a 500 over HTTP), the port refuses it as a bad query (a 400)."""
    jex, tex = pair
    with pytest.raises(IndexError):
        jex.execute("i", "Row(v >< [5])")
    for got in both_ways(tex, "Row(v >< [5])"):
        assert isinstance(got, ExecutionError)
        assert "two values" in str(got)


@pytest.mark.parametrize("pql", [
    "Set(2, f=-1)", "Clear(2, f=-1)", "ClearRow(f=-1)",
    "Store(Row(g=1), f=-2)", f"Set(2, f={1 << 64})",
])
def test_row_ids_outside_u64_are_refused_before_writing(tmp_path, pql):
    """A write naming a row outside [0, 2^64) is refused before anything
    changes (port only: the reference stores the bit and then fails),
    and TopN keeps answering."""
    jh = build_jax_index(tmp_path, seed=5)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    tex = Executor(th, device="cpu")
    before = tex.execute("i", "TopN(f) Rows(f) Count(Row(g=1))")
    for got in both_ways(tex, pql):
        assert isinstance(got, ExecutionError), got
        assert "out of range" in str(got)
    after = tex.execute("i", "TopN(f) Rows(f) Count(Row(g=1))")
    assert after[0].pairs == before[0].pairs
    assert after[1].rows == before[1].rows and after[2] == before[2]
    jh.close()


def test_load_state_reproduces_contents(pair):
    jex, tex = pair
    jidx, tidx = jex.holder.index("i"), tex.holder.index("i")
    assert sorted(tidx.fields) == sorted(jidx.fields)
    assert tidx.available_shards() == jidx.available_shards()
    for name in ("f", "g"):
        jv, tv = jidx.field(name).view(), tidx.field(name).view()
        assert tv.trimmed_words() == jv.trimmed_words()
        for s, jf in jv.fragments.items():
            assert tv.fragment(s).row_ids() == jf.row_ids()
    assert tidx.field("big").bsi_groups["big"].bit_depth == \
        bit_depth_for_range(0, BIG_MAX) == 41


def test_cpu_path_launches_no_kernel(pair):
    _, tex = pair
    before = dict(kernels.LAUNCHES)
    tex.execute("i", "Count(Intersect(Row(f=1), Row(g=2))) Sum(field=v) "
                     "TopN(f, Row(g=1), n=2)")
    assert kernels.LAUNCHES == before


def test_field_options_carry_over():
    jopts = JaxFieldOptions(type="int", min=-4, max=99, max_columns=4096)
    assert dataclasses.asdict(FieldOptions(**dataclasses.asdict(jopts))) \
        == dataclasses.asdict(jopts)


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError):
        Holder()
    with pytest.raises(RuntimeError):
        Executor(Holder(device="cpu"))
    with pytest.raises(RuntimeError):
        Holder(device="cuda")


def test_executor_device_must_match_holder():
    with pytest.raises(ValueError):
        Executor(Holder(device="cpu"), device="meta")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pilosa_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'pilosa_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'pilosa_tpu' or "
        "m.startswith('pilosa_tpu.')]\n"
        "assert len(mods) >= 15, mods\n"
        "need = ['pilosa_tpu_torch.utils.' + n for n in ('locks', "
        "'stats', 'tracing', 'timeline', 'profile', 'roofline', "
        "'benchenv', 'diagnostics', 'logger', 'sched')] + "
        "['pilosa_tpu_torch.parallel.' + n for n in "
        "('mesh', 'multihost')]\n"
        "assert not set(need) - set(mods), set(need) - set(mods)\n"
        "assert not bad, bad\n"
        "import numpy as np\n"
        "from pilosa_tpu_torch.storage import roaring\n"
        "roaring.import_build(np.zeros(5000, np.uint64), "
        "np.arange(5000, dtype=np.uint64), 20)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libpilosa_codec' in maps\n"
        "assert 'libpilosa_native' not in maps\n"
        "print(len(mods))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
