"""Differential tests of Rows, GroupBy and the TopN cache tiers: the same
seeded index (``test_torch_executor.build_jax_index`` plus a field ``h``
on two of its three shards and fields with each cache type) goes through
the JAX package and the port, through ``execute`` and ``execute_batch``;
answers must be equal, and so must the warm-shortcut and rank-vector
counters over one write/read script."""

import dataclasses

import numpy as np
import pytest

from pilosa_tpu.core.cache import RANK_CACHE as JAX_RANK_CACHE
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import executor as jax_executor_mod
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch import Executor, Holder, load_state
from pilosa_tpu_torch.executor import executor as executor_mod
from pilosa_tpu_torch.executor.executor import ExecutionError
from pilosa_tpu_torch.ops import kernels
from test_torch_executor import build_jax_index, state_from_jax


def build_pair(path, seed=11):
    """(JAX executor, port executor) over build_jax_index plus:
    ``h`` (rows 0-3, shards 1 and 2 only), ``rn`` (cacheType none),
    ``rl`` (lru), ``rs`` (ranked, cacheSize 2: saturates) and ``rt``
    (lru, cacheSize 3: evicts), each rows 0-7 over all three shards."""
    JAX_RANK_CACHE.clear()
    jh = build_jax_index(path, seed=seed)
    idx = jh.index("i")
    rng = np.random.default_rng(seed + 100)
    rows = rng.integers(0, 4, 900).astype(np.uint64)
    cols = (rng.integers(1, 3, 900) * SHARD_WIDTH
            + rng.integers(0, 60000, 900)).astype(np.uint64)
    idx.create_field("h").import_bits(rows, cols)
    for name, ctype, size in (("rn", "none", 0), ("rl", "lru", 50000),
                              ("rs", "ranked", 2), ("rt", "lru", 3)):
        rows = rng.integers(0, 8, 1500).astype(np.uint64)
        cols = (rng.integers(0, 3, 1500) * SHARD_WIDTH
                + rng.integers(0, 90000, 1500)).astype(np.uint64)
        idx.create_field(name, JaxFieldOptions(
            cache_type=ctype, cache_size=size)).import_bits(rows, cols)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex = JaxExecutor(jh)
    jex.result_cache.enabled = False
    tex = Executor(th, device="cpu")
    tex.result_cache.enabled = False
    return jh, jex, tex


def answer(res):
    """A comparable form of one result of either package."""
    if isinstance(res, Exception):
        return ("error", str(res))
    if isinstance(res, list):
        return ("groups", [g.to_json() for g in res])
    if hasattr(res, "rows"):
        return ("rows", [int(r) for r in res.rows])
    if hasattr(res, "pairs"):
        return ("pairs", [tuple(p) for p in res.pairs])
    if hasattr(res, "columns"):
        return ("columns", np.asarray(res.columns(), np.uint64).tolist())
    if hasattr(res, "value"):
        return ("valcount", res.value, res.count)
    return res


def run(ex, pql):
    try:
        return [answer(r) for r in ex.execute("i", pql)]
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", str(e))


def run_batch(ex, pqls):
    out = []
    for item in ex.execute_batch([("i", q, None) for q in pqls]):
        out.append(("error", str(item)) if isinstance(item, Exception)
                   else [answer(r) for r in item[0]])
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh, jex, tex = build_pair(tmp_path_factory.mktemp("jax"))
    yield jex, tex
    jh.close()
    JAX_RANK_CACHE.clear()


ROWS = [
    "Rows(f)", "Rows(g)", "Rows(h)", "Rows(f, previous=2)",
    "Rows(f, limit=3)", "Rows(f, previous=1, limit=2)",
    "Rows(f, previous=7)", "Rows(f, limit=0)", "Rows(f, column=5)",
    f"Rows(f, column={SHARD_WIDTH + 77})", f"Rows(h, column={7})",
    f"Rows(g, column={2 * SHARD_WIDTH + 11}, limit=1)", "Rows(v)",
    "Rows(nope)", "Rows(f, from='2020-01-01T00:00')",
    "Rows(f, to='2020-01-01T00:00')", "Rows(f, previous='a')",
    "Rows(f, column='a')", "Options(Rows(g), shards=[1])",
]

GROUPBYS = [
    "GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(g), Rows(f))",
    "GroupBy(Rows(f))", "GroupBy(Rows(g), Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(f))", "GroupBy(Rows(f), Rows(h))",
    "GroupBy(Rows(h), Rows(g), Rows(f))",
    "GroupBy(Rows(f), Rows(g), filter=Row(v > 500))",
    "GroupBy(Rows(f), filter=Row(g=1))",
    "GroupBy(Rows(g), Rows(f), Rows(g), filter=Not(Row(f=1)))",
    "GroupBy(Rows(f), Rows(g), limit=5)",
    "GroupBy(Rows(f), Rows(g), previous=[3, 1])",
    "GroupBy(Rows(f), Rows(g), limit=4, previous=[2, 2])",
    "GroupBy(Rows(g), Rows(f), Rows(g), limit=7, previous=[1, 4, 2])",
    "GroupBy(Rows(f, limit=3), Rows(g, previous=1))",
    "GroupBy(Rows(f, column=5), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=99))",
    "GroupBy(Rows(f), Rows(nope))", "GroupBy(Row(f=1))", "GroupBy()",
    "GroupBy(Rows(f), Rows(g), previous=[1])",
    "GroupBy(Rows(f), Rows(g), previous=5)",
    "GroupBy(Rows(f), Rows(g), previous=['a', 1])",
    "Options(GroupBy(Rows(f), Rows(g)), shards=[0, 2])",
    "Count(Row(f=1)) GroupBy(Rows(g), Rows(h)) Rows(h)",
]


# The queries above that both packages refuse.
REFUSED = {
    "Rows(nope)", "Rows(f, from='2020-01-01T00:00')",
    "Rows(f, to='2020-01-01T00:00')", "Rows(f, previous='a')",
    "Rows(f, column='a')", "GroupBy(Rows(f), Rows(nope))",
    "GroupBy(Row(f=1))", "GroupBy()",
    "GroupBy(Rows(f), Rows(g), previous=[1])",
    "GroupBy(Rows(f), Rows(g), previous=5)",
    "GroupBy(Rows(f), Rows(g), previous=['a', 1])",
}


@pytest.mark.parametrize("pql", ROWS + GROUPBYS)
def test_rows_and_groupby_match_jax(pair, pql):
    jex, tex = pair
    want = run(jex, pql)
    assert run(tex, pql) == want
    assert (want[0] == "error") == (pql in REFUSED)


def test_rows_and_groupby_batch_match_jax(pair, monkeypatch):
    """The same calls in one execute_batch (megakernel on in both), among
    staged Counts: equal to the JAX package's batch and to execute."""
    from pilosa_tpu.executor import megakernel as jmegamod
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
    jex, tex = pair
    pqls = ["Count(Row(f=1))", "Count(Intersect(Row(f=2), Row(g=1)))"] \
        + ROWS + GROUPBYS
    got = run_batch(tex, pqls)
    assert got == run_batch(jex, pqls)
    assert got == [run(tex, q) for q in pqls]


def test_groupby_counts_come_from_the_sweep_kernels(pair, monkeypatch):
    """The GroupBy counts go through the two sweep wrappers (their plain
    versions here): depth 0 and intermediate depths through
    bank_row_counts, the last depth one bank_row_counts_masked call a
    prefix."""
    _, tex = pair
    calls = {"bank_row_counts": 0, "bank_row_counts_masked": 0}
    for name in calls:
        real = getattr(kernels, name)

        def wrapped(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(kernels, name, wrapped)
    (groups,) = tex.execute("i", "GroupBy(Rows(g), Rows(f), Rows(g))")
    # Every surviving (g, f) prefix has a group (g, f, g).
    prefixes = {(gc.group[0].row_id, gc.group[1].row_id) for gc in groups}
    assert calls == {"bank_row_counts": 2,
                     "bank_row_counts_masked": len(prefixes)}


def test_groupby_spill_matches_jax(tmp_path):
    """A GROUPBY_CHUNK_BYTES of three prefixes' rows forces the frontier
    to host memory at the intermediate depth in both packages: equal
    answers, and the spill counter rises in each."""
    jh, jex, tex = build_pair(tmp_path, seed=4)
    row_bytes = 3 * tex.holder.index("i").field("f").view() \
        .trimmed_words() * 4
    for ex in (jex, tex):
        ex.GROUPBY_CHUNK_BYTES = 3 * row_bytes
    for pql in ("GroupBy(Rows(f), Rows(g), Rows(f))",
                "GroupBy(Rows(g), Rows(f), Rows(h), limit=40)",
                "GroupBy(Rows(f), Rows(f), Rows(g), previous=[3, 5, 1])"):
        assert run(tex, pql) == run(jex, pql), pql
    assert tex.groupby_spill_events > 0
    assert tex.groupby_spill_events == jex.groupby_spill_events
    big = Executor(tex.holder, device="cpu")
    assert run(big, "GroupBy(Rows(f), Rows(g), Rows(f))") == \
        run(tex, "GroupBy(Rows(f), Rows(g), Rows(f))")
    assert big.groupby_spill_events == 0
    jh.close()


def counters(ex):
    return (ex.topn_cache_hits, ex.topn_selfchecks, ex.rank_cache_hits,
            ex.rank_cache_patches, ex.rank_cache_rebuilds)


# Reads and writes over every cache type; after each step both
# executors' counters must be equal.
RANK_SCRIPT = [
    "TopN(rn, n=3)", "TopN(rn, n=3)", "TopN(rn)", "TopN(rn, ids=[1, 2], n=2)",
    "TopN(rn, threshold=150, n=5)", "Set(5, rn=1)", "TopN(rn, n=3)",
    "TopN(rn, n=3)", f"Set({SHARD_WIDTH + 3}, rn=40)", "TopN(rn, n=3)",
    "TopN(rn, n=3)", "Clear(5, rn=1)", "TopN(rn, n=2)", "ClearRow(rn=2)",
    "TopN(rn, n=4)", "Store(Row(f=1), rn=3)", "TopN(rn, n=3)",
    "ClearRow(rn=40)", "TopN(rn)", "TopN(rn, n=3)",
    "TopN(f, n=3)", "TopN(f, n=3)", "Set(5, f=1)", "TopN(f, n=3)",
    "TopN(f)", "TopN(f, Row(g=1), n=2)", "TopN(f, n=3)",
    "TopN(rl, n=3)", "Set(9, rl=2)", "TopN(rl, n=3)", "ClearRow(rl=3)",
    "TopN(rl)", "TopN(rs, n=3)", "TopN(rs, n=3)", "Set(9, rs=2)",
    "TopN(rs, n=3)", "TopN(rt, n=3)", "TopN(rt, n=3)", "Set(11, rt=0)",
    "TopN(rt, n=3)", "Store(Row(g=2), rs=0)", "TopN(rs)",
    "TopN(h, n=2)", "TopN(h, n=2)",
]


@pytest.mark.parametrize("every", [256, 2])
def test_rank_tiers_follow_jax(tmp_path, monkeypatch, every):
    """Warm-shortcut hits and self-checks and rank-vector hits, patches
    and rebuilds step with the JAX executor's over RANK_SCRIPT, at the
    default self-check rate and at one hit in two."""
    monkeypatch.setattr(executor_mod, "TOPN_SELFCHECK_EVERY", every)
    monkeypatch.setattr(jax_executor_mod, "TOPN_SELFCHECK_EVERY", every)
    jh, jex, tex = build_pair(tmp_path, seed=6)
    seen = set()
    for pql in RANK_SCRIPT:
        assert run(tex, pql) == run(jex, pql), pql
        assert counters(tex) == counters(jex), pql
        seen.add(counters(tex))
    hits, checks, rhits, patches, rebuilds = counters(tex)
    assert hits > checks > 0 and rhits > 0 and patches > 0 and rebuilds > 0
    assert tex.topn_selfcheck_mismatches == 0
    jh.close()
    JAX_RANK_CACHE.clear()


def test_rank_tiers_in_batches_follow_jax(tmp_path):
    """The rank script's reads as execute_batch requests between its
    writes: the same answers and counters as the JAX package's batches."""
    jh, jex, tex = build_pair(tmp_path, seed=8)
    reads, steps = [], []
    for pql in RANK_SCRIPT:
        if pql.startswith(("Set", "Clear", "Store")):
            steps += [reads, [pql]]
            reads = []
        else:
            reads.append(pql)
    for reqs in steps + [reads]:
        assert run_batch(tex, reqs) == run_batch(jex, reqs), reqs
        assert counters(tex) == counters(jex), reqs
    jh.close()
    JAX_RANK_CACHE.clear()


def test_warm_rank_hit_launches_no_sweep(pair, monkeypatch):
    """A warm device-rank hit answers from the cached vector: no
    bank_row_counts call."""
    _, tex = pair
    tex.execute("i", "TopN(rn, n=3)")
    calls = []
    real = kernels.bank_row_counts
    monkeypatch.setattr(kernels, "bank_row_counts",
                        lambda *a: calls.append(1) or real(*a))
    hits = tex.rank_cache_hits
    (res,) = tex.execute("i", "TopN(rn, n=3)")
    assert tex.rank_cache_hits == hits + 1 and not calls
    assert res.pairs


def test_selfcheck_repairs_a_stale_cache(tmp_path, monkeypatch):
    """A count cache made stale behind the executor's back: the sampled
    self-check answers from the sweep, counts the mismatch and repairs
    the caches, so the next warm hit is exact again."""
    monkeypatch.setattr(executor_mod, "TOPN_SELFCHECK_EVERY", 1)
    jh, jex, tex = build_pair(tmp_path, seed=2)
    want = run(jex, "TopN(f, n=4)")
    frag = tex.holder.index("i").field("f").view().fragment(0)
    frag.cache.counts = {r: 10 ** 6 + r for r in frag.cache.counts}
    assert run(tex, "TopN(f, n=4)") == want
    assert tex.topn_selfcheck_mismatches == 1
    monkeypatch.setattr(executor_mod, "TOPN_SELFCHECK_EVERY", 0)
    assert run(tex, "TopN(f, n=4)") == want
    jh.close()


def test_count_cache_saturation_and_types(pair):
    """Ranked caches latch saturation past 1.1 x cacheSize (and a load
    that passes it latches before recounting); lru caches evict; none
    keeps nothing. Each matches the JAX fragment's cache."""
    jex, tex = pair
    for name in ("f", "rn", "rl", "rs", "rt"):
        for s in (0, 1, 2):
            jf = jex.holder.index("i").field(name).view().fragment(s)
            tf = tex.holder.index("i").field(name).view().fragment(s)
            assert type(tf.cache).__name__ == type(jf.cache).__name__
            assert getattr(tf.cache, "saturated", None) == \
                getattr(jf.cache, "saturated", None)
            assert dict(tf.cache.counts if name != "rn" else {}) == \
                dict(jf.cache.counts if name != "rn" else {})
    rs = tex.holder.index("i").field("rs").view().fragment(0).cache
    assert rs.saturated
    assert len(tex.holder.index("i").field("rt").view().fragment(0)
               .cache) == 3


def test_deleting_a_field_drops_its_rank_vectors(tmp_path):
    jh, jex, tex = build_pair(tmp_path, seed=9)
    tex.execute("i", "TopN(rn, n=2) TopN(rs, n=2)")
    store = tex.holder.rank_cache
    assert len(store) == 2
    tex.holder.index("i").delete_field("rn")
    assert len(store) == 1
    tex.holder.delete_index("i")
    assert len(store) == 0
    jh.close()
    JAX_RANK_CACHE.clear()


def test_invalid_cache_type_is_refused():
    from pilosa_tpu_torch import FieldOptions
    h = Holder(device="cpu")
    with pytest.raises(ValueError, match="invalid cache type: bogus"):
        h.create_index("i").create_field("f", FieldOptions(
            cache_type="bogus"))
    assert dataclasses.asdict(FieldOptions(cache_type="lru"))[
        "cache_type"] == "lru"


def test_groupby_filter_runs_eagerly_under_the_collector(pair, monkeypatch):
    """Under execute_batch's collector a GroupBy filter evaluates to words
    at once (it never stages), so GroupBy answers inside the batch."""
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    _, tex = pair
    pql = "GroupBy(Rows(f), Rows(g), filter=Intersect(Row(v > 100), " \
          "Not(Row(f=2))))"
    (out,) = tex.execute_batch([("i", pql, None)])
    assert not isinstance(out, Exception)
    assert [answer(r) for r in out[0]] == run(tex, pql)
    with pytest.raises(ExecutionError):
        tex.execute("i", "GroupBy(Rows(f), Rows(g), filter=Row(nope=1))")
