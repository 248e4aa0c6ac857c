"""The port's result cache and rank cache against the JAX package's, on the
CPU (``executor/result_cache.py``, ``core/cache.py``): every case runs one
script through both packages over the same seeded data and compares the
answers and the counters (per-tier hits, misses and evictions, the rank
cache's hits, patches and rebuilds) exactly. The cases are those of the
JAX package's ``tests/test_result_cache.py``, apart from its two-node
cluster case (the placement change it checks runs in
``tests/test_torch_resize.py``)."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.core import cache as jcache
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor.result_cache import ResultCache as JaxResultCache
from pilosa_tpu.utils.memledger import LEDGER as JAX_LEDGER
from pilosa_tpu.utils.stats import MemStatsClient as JaxStats
from pilosa_tpu.utils.stats import prometheus_text as jax_prometheus_text

from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.core import cache as pcache
from pilosa_tpu_torch.executor.result_cache import ResultCache
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.utils.memledger import LEDGER
from pilosa_tpu_torch.utils.stats import MemStatsClient, prometheus_text


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag this
    file's sampled fences raise must not reach a later test's sentinel
    (its ``roofline.drift`` alert)."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


KERNEL_NAMES = ("bank_row_counts", "bank_row_counts_masked",
                "bsi_plane_counts", "mega_interpret",
                "pbank_membership_counts", "expand_positions")


@pytest.fixture(autouse=True)
def _reset_rank_cache():
    """The JAX rank store is process-wide: every case starts empty."""
    jcache.RANK_CACHE.clear()
    jcache.RANK_CACHE.configure(enabled=True, max_entries=64)
    yield
    jcache.RANK_CACHE.clear()
    jcache.RANK_CACHE.configure(enabled=True, max_entries=64)


def _seed(h, opts):
    idx = h.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 8, 4000).astype(np.uint64)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 4000).astype(np.uint64)
    f.import_bits(rows, cols)
    g.import_bits(rows[::2], cols[::2])
    idx.create_field("v", opts(type="int", min=0, max=10000))
    vcols = rng.integers(0, 2 * SHARD_WIDTH, 500).astype(np.uint64)
    idx.field("v").import_values(
        vcols, rng.integers(0, 10000, 500).astype(np.int64))
    idx.add_existence(cols)
    return idx


class Pair:
    """A JAX and a port executor over the same seeded index."""

    def __init__(self, tmp_path, name="d"):
        self.jh = JaxHolder(str(tmp_path / name))
        self.jh.open()
        _seed(self.jh, JaxFieldOptions)
        self.th = Holder(device="cpu")
        _seed(self.th, FieldOptions)
        self.jex = JaxExecutor(self.jh)
        self.tex = Executor(self.th, device="cpu")

    def both(self, fn):
        """``fn(executor)`` on both; the port's answer, held equal."""
        want, got = fn(self.jex), fn(self.tex)
        assert got == want
        return got

    def execute(self, q, **kw):
        return self.both(lambda e: _plain(e.execute("i", q, **kw)))

    def execute_full(self, q, **kw):
        return self.both(lambda e: e.execute_full("i", q, **kw))

    def counters(self):
        """Per-tier hits and misses, evictions, and entries: equal."""
        def of(rc):
            return (dict(rc.hits), dict(rc.misses), rc.evictions,
                    len(rc))
        got, want = of(self.tex.result_cache), of(self.jex.result_cache)
        assert got == want
        return got

    def close(self):
        self.jh.close()


def _plain(results):
    """Results as comparable values: a Row result by its columns."""
    out = []
    for r in results:
        cols = getattr(r, "columns", None)
        out.append(cols().tolist() if cols is not None else
                   (r.pairs if hasattr(r, "pairs") else r))
    return out


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def count_kernels(monkeypatch):
    """Calls into ops/kernels.py (wrappers and plain versions)."""
    calls = []
    for name in KERNEL_NAMES + tuple(n + "_ref" for n in KERNEL_NAMES):
        real = getattr(kernels, name, None)
        if real is None:
            continue
        monkeypatch.setattr(
            kernels, name,
            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


def count_jax_dispatches(monkeypatch):
    calls = []
    orig = JaxExecutor._call_program

    def stub(self, fn, *args):
        calls.append(fn)
        return orig(self, fn, *args)

    monkeypatch.setattr(JaxExecutor, "_call_program", stub)
    return calls


# ------------------------------------------------- core/cache.py units


def _both_caches(make):
    return make(jcache), make(pcache)


def test_ranked_cache_add_top_and_zero_removal():
    for c in _both_caches(lambda m: m.RankedCache(size=4)):
        for r, n in [(1, 10), (2, 20), (3, 5)]:
            c.add(r, n)
        assert c.top() == [(2, 20), (1, 10), (3, 5)]
        c.add(3, 0)
        assert c.top() == [(2, 20), (1, 10)] and len(c) == 2


def test_ranked_cache_recalculate_prunes_to_size_and_saturates():
    out = []
    for c in _both_caches(lambda m: m.RankedCache(size=4)):
        for r in range(10):
            c.add(r, r + 1)
        c.add(50, 100)
        top, sat, has50 = c.top(), c.saturated, 50 in c.counts
        c.invalidate()
        empty = (len(c), c.saturated)
        c.add(50, 1)
        out.append((top, sat, has50, empty, dict(c.counts)))
    assert out[0] == out[1]
    assert out[1][:4] == ([(4, 5), (3, 4), (2, 3), (1, 2)], True, False,
                          (0, False))


def test_ranked_cache_invalidate_rebinds_not_clears():
    for c in _both_caches(lambda m: m.RankedCache(size=8)):
        c.add(1, 5)
        before = c.counts
        c.invalidate()
        assert before == {1: 5}
        assert c.counts == {} and c.counts is not before


def test_ranked_cache_concurrent_adds_and_invalidates():
    for c in _both_caches(lambda m: m.RankedCache(size=64)):
        errs = []

        def worker(base, c=c, errs=errs):
            try:
                for i in range(500):
                    c.add(base + (i % 80), i + 1)
                    if i % 97 == 0:
                        c.invalidate()
                    c.top()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(b,))
              for b in (0, 100, 200, 300)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not errs, errs


def test_lru_cache_recency_and_eviction():
    out = []
    for c in _both_caches(lambda m: m.LRUCache(size=3)):
        for r in (1, 2, 3):
            c.add(r, r * 10)
        got = [c.get(1)]
        c.add(4, 40)
        got += [c.get(2), c.ids(), c.top()]
        c.invalidate()
        got.append(len(c))
        out.append(got)
    assert out[0] == out[1] == [10, 0, [1, 3, 4],
                                [(4, 40), (3, 30), (1, 10)], 0]


def test_nop_cache_stores_nothing():
    for c in _both_caches(lambda m: m.NopCache()):
        c.add(1, 10)
        assert c.top() == [] and len(c) == 0


# ------------------------------------------- ResultCache (store) units


def _store_script(rc):
    rc.fill("k", gen=(1,), value="v", nbytes=100)
    out = [rc.lookup("k", (1,)), rc.lookup("k", (2,)), len(rc),
           rc.lookup("k", (2,))]
    return out, rc.snapshot()


def test_result_cache_hit_miss_and_generation_drop():
    want = _store_script(JaxResultCache(max_bytes=1 << 20))
    got = _store_script(ResultCache(max_bytes=1 << 20))
    assert got == want
    assert got[0] == ["v", None, 0, None]
    assert got[1]["tiers"]["eval"] == {"hits": 1, "misses": 2}
    assert got[1]["invalidations"] == 1


def test_result_cache_lru_byte_budget_and_oversized_refusal():
    def script(rc):
        for i in range(3):
            rc.fill(i, (0,), i, nbytes=100)
        out = [len(rc), rc.bytes, rc.evictions, rc.lookup(0, (0,))]
        rc.fill("big", (0,), "x", nbytes=10_000)
        out += [len(rc), rc.lookup("big", (0,))]
        rc.clear()
        out += [rc.bytes, len(rc)]
        return out
    want = script(JaxResultCache(max_bytes=250))
    got = script(ResultCache(max_bytes=250))
    assert got == want == [2, 200, 1, None, 2, None, 0, 0]


def test_result_cache_configure_shrink_updates_ledger():
    def script(rc, ledger):
        try:
            rc.fill("a", 1, "va", 40)
            rc.fill("b", 1, "vb", 40)
            before = rc.bytes
            rc.configure(max_bytes=50)
            ent = [e for e in ledger.entries("result_cache")
                   if e.get("entries") is not None
                   and e["bytes"] == rc.bytes]
            return before, rc.bytes, rc.evictions, bool(ent)
        finally:
            rc.clear()
    want = script(JaxResultCache(max_bytes=100), JAX_LEDGER)
    got = script(ResultCache(max_bytes=100), LEDGER)
    assert got == want == (80, 40, 1, True)


def test_result_cache_request_tier_validator():
    def script(rc):
        rc.fill("rk", gen={"dep": 1}, value={"results": [1]}, nbytes=50,
                tier="request")
        out = [rc.lookup_request("rk", lambda d: d["dep"] == 1),
               rc.hits["request"],
               rc.lookup_request("rk", lambda d: False),
               rc.invalidations, len(rc)]
        return out, rc.snapshot()
    want = script(JaxResultCache(max_bytes=1 << 20))
    got = script(ResultCache(max_bytes=1 << 20))
    assert got == want
    assert got[0] == [{"results": [1]}, 1, None, 1, 0]


def test_result_cache_env_kill_switch(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_RESULT_CACHE", "0")
    for rc in (JaxResultCache(), ResultCache()):
        assert not rc.enabled
        rc.configure(enabled=True)
        assert not rc.enabled
        rc.fill("k", (1,), "v", 10)
        assert rc.lookup("k", (1,)) is None


def test_rank_cache_env_kill_switch(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_RANK_CACHE", "0")
    for store in (jcache.RankCacheStore(), pcache.RankCacheStore()):
        assert not store.enabled
        store.configure(enabled=True)
        assert not store.enabled


# --------------------------------------------------- eval-tier caching


def test_eval_tier_repeat_serves_without_dispatch(pair, monkeypatch):
    direct = [pair.execute(f"Count(Row(f={r}))") for r in range(4)]
    jcalls = count_jax_dispatches(monkeypatch)
    pcalls = count_kernels(monkeypatch)
    again = [pair.execute(f"Count(Row(f={r}))") for r in range(4)]
    assert again == direct
    assert jcalls == [] and pcalls == []
    assert pair.counters()[0]["eval"] == 4


def test_eval_tier_row_results_bit_identical(pair, monkeypatch):
    direct = pair.execute("Row(f=3)")
    jcalls = count_jax_dispatches(monkeypatch)
    pcalls = count_kernels(monkeypatch)
    jcached = pair.jex.execute("i", "Row(f=3)")[0]
    cached = pair.tex.execute("i", "Row(f=3)")[0]
    assert cached.columns().tolist() == jcached.columns().tolist() \
        == direct[0]
    # A hit is a Row result over host words: nothing goes to a device.
    assert cached.cached and cached.words.device.type == "cpu"
    assert jcalls == [] and pcalls == []
    assert cached.count() == jcached.count() == len(direct[0])
    pair.counters()


def test_eval_tier_row_hit_words_cannot_change_later_hits(pair):
    """Every hit of an entry shares its host words: they are read-only,
    and a hit's ``words`` tensor is a copy, so a caller writing either
    leaves later answers equal to the JAX package's."""
    direct = pair.execute("Row(f=3)")
    pair.jex.execute("i", "Row(f=3)")
    hit = pair.tex.execute("i", "Row(f=3)")[0]
    assert hit.cached
    with pytest.raises(ValueError):
        hit._host[0, 0] = 0xFFFFFFFF
    hit.words.fill_(-1)
    assert pair.execute("Row(f=3)") == direct
    assert pair.counters()[0]["eval"] == 2


def test_staged_eval_walks_its_tree_once(pair, monkeypatch):
    """A staged eval's plan walk is its eval identity's: a batch of
    misses walks each tree once (a hit walks it once too), and answers
    as the JAX package does."""
    from pilosa_tpu_torch.executor.executor import Executor as PortExecutor
    walks = []
    real = PortExecutor._plan_call

    def counted(self, idx, call, plan):
        if call.name == "Intersect":
            walks.append(call.name)
        return real(self, idx, call, plan)
    monkeypatch.setattr(PortExecutor, "_plan_call", counted)
    reqs = [("i", "Count(Intersect(Row(f=1), Row(g=2)))", None),
            ("i", "Intersect(Row(f=3), Row(g=3))", None)]

    def batch(e):
        return [_plain(res) for res, _opts in e.execute_batch(reqs)]
    assert pair.both(batch) == pair.both(batch)
    assert walks == ["Intersect"] * 4
    pair.counters()


def test_version_maps_follow_every_write(pair):
    """The views' version maps are memoised between fragment writes: a
    write, a new fragment and a write between two hits each show in the
    eval generation, so no hit outlives a write."""
    q = "Count(Row(f=5))"
    answers = [pair.execute(q)]
    for pql in ("Set(7, f=5)", f"Set({3 * SHARD_WIDTH + 1}, f=5)",
                "Clear(7, f=5)"):
        pair.execute(pql)
        answers.append(pair.execute(q))
        answers.append(pair.execute(q))
    base = answers[0][0]
    assert [a[0] for a in answers] == [base, base + 1, base + 1,
                                       base + 2, base + 2, base + 1,
                                       base + 1]
    hits, misses = pair.counters()[:2]
    assert (hits["eval"], misses["eval"]) == (3, 4)


def test_eval_tier_whitespace_variant_hits(pair):
    pair.execute("Count(Row(f=1))")
    h0 = pair.counters()[0]["eval"]
    pair.execute("Count( Row( f = 1 ) )")
    assert pair.counters()[0]["eval"] == h0 + 1


def test_read_write_read_generation_invalidation(pair, tmp_path):
    c0 = pair.execute("Count(Row(f=5))")[0]
    free_col = 2 * SHARD_WIDTH - 7
    m0 = pair.counters()[1]["eval"]
    pair.execute(f"Set({free_col}, f=5)")
    c1 = pair.execute("Count(Row(f=5))")[0]
    assert pair.counters()[1]["eval"] == m0 + 1
    assert pair.tex.result_cache.invalidations >= 1
    assert c1 == c0 + 1


def test_read_write_read_through_fusion_under_lock_check(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LOCK_CHECK", "1")
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.utils.locks import lock_order_violations, \
        reset_lock_order
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    reset_lock_order()
    p = Pair(tmp_path, "lc")
    try:
        c0 = p.execute("Count(Row(f=5))")[0]
        assert p.counters()[0]["eval"] == 0
        free_col = 2 * SHARD_WIDTH - 11
        reqs = [("i", "Count(Row(f=5))", None),
                ("i", f"Set({free_col}, f=5)", None),
                ("i", "Count(Row(f=5))", None)]
        out = p.both(lambda e: [r[0] for r in e.execute_batch(reqs)])
        assert out == [[c0], [True], [c0 + 1]]
        assert p.counters()[0]["eval"] == 1
        assert p.execute("Count(Row(f=5))") == [c0 + 1]
        assert p.counters()[0]["eval"] == 2
        assert lock_order_violations() == []
    finally:
        p.close()
        reset_lock_order()


@pytest.mark.parametrize("megakernel", [False, True])
def test_fully_hitting_group_never_launches(pair, monkeypatch, megakernel):
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", megakernel)
    queries = [f"Count(Row(f={r}))" for r in range(6)] + ["Row(g=2)"]
    direct = [pair.execute(q)[0] for q in queries]
    jcalls = count_jax_dispatches(monkeypatch)
    pcalls = count_kernels(monkeypatch)
    fd0, ml0 = pair.jex.fused_dispatches, pair.tex.mega_launches
    out = pair.both(lambda e: [_plain(r[0])[0] for r in e.execute_batch(
        [("i", q, None) for q in queries])])
    assert out == direct
    assert jcalls == [] and pcalls == []
    assert pair.jex.fused_dispatches == fd0
    assert pair.tex.mega_launches == ml0
    assert pair.counters()[0]["eval"] == len(queries)


def test_partly_hitting_batch_lowers_only_its_misses(pair, monkeypatch):
    """A batch of two hits and three misses: one launch of the misses
    (in the port's megakernel), the hits answered from the cache."""
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    for q in ("Count(Row(f=1))", "Row(g=1)"):
        pair.execute(q)
    queries = ["Count(Row(f=1))", "Count(Row(f=2))", "Row(g=1)",
               "Count(Intersect(Row(f=3), Row(g=3)))", "Row(f=4)"]
    q0, e0 = pair.tex.mega_queries, pair.tex.mega_launches
    pair.both(lambda e: [_plain(r[0]) for r in e.execute_batch(
        [("i", q, None) for q in queries])])
    assert pair.tex.mega_launches == e0 + 1
    assert pair.tex.mega_queries == q0 + 3
    assert pair.counters()[0]["eval"] == 2
    # The misses filled: the whole batch now hits.
    pair.both(lambda e: [_plain(r[0]) for r in e.execute_batch(
        [("i", q, None) for q in queries])])
    assert pair.tex.mega_launches == e0 + 1
    assert pair.counters()[0]["eval"] == 7


def test_eval_tier_same_named_fields_across_indexes_coexist(pair):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 8, 4000).astype(np.uint64)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 4000).astype(np.uint64)
    for h in (pair.jh, pair.th):
        idx2 = h.create_index("j")
        idx2.create_field("f").import_bits(rows, cols)
        idx2.add_existence(cols)
    a0 = pair.execute("Count(Row(f=1))")
    b0 = pair.both(lambda e: e.execute("j", "Count(Row(f=1))"))
    inv0 = pair.tex.result_cache.invalidations
    h0 = pair.counters()[0]["eval"]
    for _ in range(2):
        assert pair.execute("Count(Row(f=1))") == a0
        assert pair.both(lambda e: e.execute("j", "Count(Row(f=1))")) \
            == b0
    assert pair.counters()[0]["eval"] == h0 + 4
    assert pair.tex.result_cache.invalidations == inv0 == \
        pair.jex.result_cache.invalidations


def test_eval_tier_shard_restriction_is_part_of_the_key(pair):
    full = pair.execute("Count(Row(f=2))")
    only0 = pair.execute("Count(Row(f=2))", shards=[0])
    assert only0 != full
    assert pair.execute("Count(Row(f=2))") == full
    assert pair.execute("Count(Row(f=2))", shards=[0]) == only0
    assert pair.counters()[0]["eval"] == 2


# ------------------------------------------------ request-tier caching


def test_request_tier_execute_full_hits_and_write_invalidates(
        pair, monkeypatch):
    r0 = pair.execute_full("Count(Row(f=1))")
    pcalls = count_kernels(monkeypatch)
    assert pair.execute_full("Count(Row(f=1))") == r0
    assert pair.counters()[0]["request"] == 1
    assert pcalls == []
    free_col = 2 * SHARD_WIDTH - 13
    pair.execute(f"Set({free_col}, f=1)")
    r1 = pair.execute_full("Count(Row(f=1))")
    assert r1["results"][0] == r0["results"][0] + 1
    assert pair.counters()[0]["request"] == 1


def test_request_tier_row_attr_mutation_invalidates(pair):
    pair.execute('SetRowAttrs(f, 1, cat="x")')
    r0 = pair.execute_full("Row(f=1)")
    assert r0["results"][0]["attrs"] == {"cat": "x"}
    assert pair.execute_full("Row(f=1)") == r0
    h0 = pair.counters()[0]["request"]
    pair.execute('SetRowAttrs(f, 1, cat="y")')
    r1 = pair.execute_full("Row(f=1)")
    assert r1["results"][0]["attrs"] == {"cat": "y"}
    assert pair.counters()[0]["request"] == h0


@pytest.mark.parametrize("q", ["TopN(f, n=2)", 'Min(field="v")',
                               'Sum(field="v")'])
def test_request_tier_excludes_non_staged_calls(pair, q):
    r0 = pair.execute_full(q)
    assert pair.execute_full(q) == r0
    assert pair.counters()[0]["request"] == 0


def test_forced_profile_bypasses_lookup_but_still_fills(pair):
    from pilosa_tpu.utils.profile import QueryProfile as JaxProfile
    from pilosa_tpu_torch.utils.profile import QueryProfile
    pair.execute_full("Count(Row(f=4))")
    profs = {}

    def run(e):
        prof = (JaxProfile if e is pair.jex else QueryProfile)(
            "i", "Count(Row(f=4))")
        prof.forced = True
        profs[e is pair.jex] = prof
        return e.execute_full("i", "Count(Row(f=4))", profile=prof)

    r = pair.both(run)
    assert pair.counters()[0]["request"] == 0
    for prof in profs.values():
        evals = [n for op in prof.ops for n in op.children
                 if n.name.startswith("eval:")]
        assert evals and "cacheHit" not in evals[0].attrs
    assert r["results"] == pair.execute("Count(Row(f=4))")


def test_sampled_profile_hit_gets_cache_attribution(pair):
    from pilosa_tpu.utils.profile import QueryProfile as JaxProfile
    from pilosa_tpu_torch.utils.profile import QueryProfile
    pair.execute_full("Count(Row(f=6))")
    profs = {}

    def run(e):
        prof = (JaxProfile if e is pair.jex else QueryProfile)(
            "i", "Count(Row(f=6))")
        profs[e is pair.jex] = prof
        return e.execute_full("i", "Count(Row(f=6))", profile=prof)

    pair.both(run)
    assert pair.counters()[0]["request"] == 1
    for prof in profs.values():
        ops = [op for op in prof.ops if op.name == "cache"]
        assert ops and ops[0].attrs["cacheHit"] is True


def test_request_fill_racing_write_cannot_validate_stale(pair, monkeypatch):
    """Stamp, then read: a write landing after the stamps and before the
    bank read leaves the stored stamp stale, so the repeat misses and
    sees the write."""
    col = np.asarray([2 * SHARD_WIDTH - 23], np.uint64)
    jorig, porig = JaxExecutor._get_bank, Executor._get_bank_for
    fired = []

    def jracing(self, idx, key, shards, rows_needed=None):
        bank = jorig(self, idx, key, shards, rows_needed=rows_needed)
        if "j" not in fired:
            fired.append("j")
            pair.jh.index("i").field("f").import_bits(
                np.asarray([1], np.uint64), col)
        return bank

    def pracing(self, field, view_name, shards, rows_needed=None):
        bank = porig(self, field, view_name, shards,
                     rows_needed=rows_needed)
        if "p" not in fired:
            fired.append("p")
            pair.th.index("i").field("f").import_bits(
                np.asarray([1], np.uint64), col)
        return bank

    monkeypatch.setattr(JaxExecutor, "_get_bank", jracing)
    monkeypatch.setattr(Executor, "_get_bank_for", pracing)
    r0 = pair.execute_full("Count(Row(f=1))")
    monkeypatch.setattr(JaxExecutor, "_get_bank", jorig)
    monkeypatch.setattr(Executor, "_get_bank_for", porig)
    r1 = pair.execute_full("Count(Row(f=1))")
    assert pair.counters()[0]["request"] == 0
    assert r1["results"][0] == r0["results"][0] + 1


# ------------------------------------------------- device rank cache


class TopnPair:
    def __init__(self, tmp_path, monkeypatch, build, name="t"):
        self.jh = JaxHolder(str(tmp_path / name))
        self.jh.open()
        self.th = Holder(device="cpu")
        for h in (self.jh, self.th):
            build(h)
        for cls in (JaxExecutor, Executor):
            monkeypatch.setattr(cls, "_topn_cached_counts",
                                lambda self, view, shards: None)
        self.jex = JaxExecutor(self.jh)
        self.tex = Executor(self.th, device="cpu")
        self.stores = (jcache.RANK_CACHE, self.th.rank_cache)

    def topn(self, index, q, **kw):
        want = self.jex.execute(index, q, **kw)[0].pairs
        got = self.tex.execute(index, q, **kw)[0].pairs
        assert got == want
        return got

    def write(self, index, q):
        assert self.tex.execute(index, q) == self.jex.execute(index, q)

    def configure(self, **kw):
        for s in self.stores:
            s.configure(**kw)

    def counters(self):
        def of(e):
            return (e.rank_cache_hits, e.rank_cache_patches,
                    e.rank_cache_rebuilds)
        assert of(self.tex) == of(self.jex)
        return of(self.tex)


def _build_topn(h):
    idx = h.create_index("t")
    f = idx.create_field("tf")
    rows, cols = [], []
    for r in range(8):
        for c in range(20 - 2 * r):
            rows.append(r)
            cols.append(c * 3 + (SHARD_WIDTH if c % 2 else 0))
    f.import_bits(np.asarray(rows, np.uint64), np.asarray(cols, np.uint64))
    idx.add_existence(np.asarray(cols, np.uint64))


@pytest.fixture
def topn(tmp_path, monkeypatch):
    p = TopnPair(tmp_path, monkeypatch, _build_topn)
    yield p
    p.jh.close()


def test_rank_cache_rebuild_then_hit_bit_identical(topn):
    topn.configure(enabled=False)
    base = topn.topn("t", "TopN(tf, n=3)")
    base_all = topn.topn("t", "TopN(tf)")
    topn.configure(enabled=True)
    assert topn.topn("t", "TopN(tf, n=3)") == base
    assert topn.counters()[2] == 1
    assert topn.topn("t", "TopN(tf, n=3)") == base
    assert topn.topn("t", "TopN(tf)") == base_all
    assert topn.counters()[0] == 2
    assert [len(s) for s in topn.stores] == [1, 1]


def test_rank_cache_patch_after_small_write(topn):
    assert topn.topn("t", "TopN(tf, n=3)")
    topn.write("t", "Set(299, tf=7)")
    topn.configure(enabled=False)
    expect = topn.topn("t", "TopN(tf, n=8)")
    topn.configure(enabled=True)
    got = topn.topn("t", "TopN(tf, n=8)")
    assert got == expect and (7, 7) in got
    assert topn.counters() == (0, 1, 1)


def test_rank_cache_threshold_and_filter_paths(topn):
    topn.configure(enabled=False)
    thr = topn.topn("t", "TopN(tf, n=8, threshold=15)")
    filt = topn.topn("t", "TopN(tf, Row(tf=0), n=2)")
    topn.configure(enabled=True)
    assert topn.topn("t", "TopN(tf, n=8, threshold=15)") == thr
    assert thr and all(c >= 15 for _, c in thr)
    consults0 = sum(topn.counters())
    assert topn.topn("t", "TopN(tf, Row(tf=0), n=2)") == filt
    assert sum(topn.counters()) == consults0


def test_rank_cache_lru_eviction_and_ledger_accounting(topn):
    # The port's ledger is process-wide and its rank stores per holder:
    # count this holder's rows as the change from the start.
    ledgers = (JAX_LEDGER, LEDGER)
    base = [ledger.entries("rank_cache") for ledger in ledgers]
    topn.topn("t", "TopN(tf, n=3)")
    for ledger, b in zip(ledgers, base):
        ents = ledger.entries("rank_cache")
        assert len(ents) == len(b) + 1
        assert sum(e["bytes"] for e in ents) > sum(e["bytes"] for e in b)
        assert ledger.snapshot()["categories"]["rank_cache"]["bytes"] \
            == sum(e["bytes"] for e in ents)
    topn.configure(max_entries=1)
    topn.topn("t", "TopN(tf, n=3)", shards=[0])
    for s, ledger, b in zip(topn.stores, ledgers, base):
        assert len(s) == 1 and s.evictions == 1
        assert len(ledger.entries("rank_cache")) == len(b) + 1
    for s in topn.stores:
        s.clear()
    for ledger, b in zip(ledgers, base):
        assert len(ledger.entries("rank_cache")) == len(b)


def _build_grown(h):
    idx = h.create_index("ag")
    f = idx.create_field("af")
    rows, cols = [], []
    for r, n_cols in ((0, 5), (5, 4), (10, 3)):
        for c in range(n_cols):
            rows.append(r)
            cols.append(c * 2)
    f.import_bits(np.asarray(rows, np.uint64), np.asarray(cols, np.uint64))
    idx.add_existence(np.asarray(cols, np.uint64))


def test_rank_cache_append_grown_bank_stays_exact(tmp_path, monkeypatch):
    p = TopnPair(tmp_path, monkeypatch, _build_grown, "ag")
    try:
        assert p.topn("ag", "TopN(af)") == [(0, 5), (5, 4), (10, 3)]
        p.write("ag", "Set(100, af=7)")
        p.configure(enabled=False)
        expect = p.topn("ag", "TopN(af, n=4)")
        p.configure(enabled=True)
        assert expect == [(0, 5), (5, 4), (10, 3), (7, 1)]
        assert p.topn("ag", "TopN(af, n=4)") == expect
        assert p.topn("ag", "TopN(af, n=4)") == expect
        assert p.counters()[1] == 0
    finally:
        p.jh.close()


def test_rank_cache_fragment_recreation_forces_rebuild(topn):
    """A fragment that did not exist when the rank vector was built has
    no write record the vector can be patched from: the next TopN
    rebuilds, never patches. (The JAX package's case recreates a
    fragment in place, as a resize pull does: that is
    ``test_rank_cache_fragment_replaced_in_place``.)"""
    shards = [0, 1, 2]
    assert topn.topn("t", "TopN(tf, n=8)", shards=shards)
    topn.write("t", "Set(299, tf=7)")
    topn.write("t", f"Set({2 * SHARD_WIDTH + 1}, tf=0)")
    topn.configure(enabled=False)
    expect = topn.topn("t", "TopN(tf, n=8)", shards=shards)
    topn.configure(enabled=True)
    got = topn.topn("t", "TopN(tf, n=8)", shards=shards)
    assert got == expect and (7, 7) in got and (0, 21) in got
    assert topn.counters()[1] == 0


def test_rank_cache_fragment_replaced_in_place(topn):
    """The JAX package's case: a fragment recreated in place under a
    built rank vector, as the resize pull recreates it
    (``replace_with_bytes``, which drops a whole row and adds bits):
    the next TopN answers as with the rank cache off, and both packages
    patch or rebuild alike."""
    from pilosa_tpu_torch.core.fragment import Fragment
    assert topn.topn("t", "TopN(tf, n=8)")
    topn.write("t", "Set(299, tf=7)")
    copy = Fragment(0)
    copy.import_roaring(
        topn.th.index("t").field("tf").view().fragment(0).write_bytes())
    copy.clear_row(3)
    copy.import_bits(np.array([6, 6, 2], np.uint64),
                     np.array([500, 501, 502], np.uint64))
    data = copy.write_bytes()
    for h in (topn.jh, topn.th):
        h.index("t").field("tf").view().fragment(0).replace_with_bytes(data)
    topn.configure(enabled=False)
    expect = topn.topn("t", "TopN(tf, n=8)")
    topn.configure(enabled=True)
    got = topn.topn("t", "TopN(tf, n=8)")
    assert got == expect
    topn.counters()


def test_rank_cache_disabled_sweeps_identically(topn):
    warm = topn.topn("t", "TopN(tf, n=4)")
    assert topn.counters()[2] == 1
    topn.configure(enabled=False)
    assert topn.topn("t", "TopN(tf, n=4)") == warm
    hits, _, rebuilds = topn.counters()
    assert hits + rebuilds == 1


# ------------------------------------------------------ HTTP surfaces


def test_http_surfaces_metrics_hotspots_health_memory(tmp_path):
    from pilosa_tpu.server import API as JaxAPI
    from pilosa_tpu.server import serve as jax_serve
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.server.http import serve
    jh = JaxHolder(str(tmp_path / "s"))
    jh.open()
    _seed(jh, JaxFieldOptions)
    th = Holder(device="cpu")
    _seed(th, FieldOptions)
    apis = (JaxAPI(jh, stats=JaxStats()), API(th, stats=MemStatsClient()))
    srvs = [jax_serve(apis[0], "localhost", 0, background=True),
            serve(apis[1], "localhost", 0, background=True)]
    bases = [f"http://localhost:{s.server_address[1]}" for s in srvs]

    def get(base, path):
        return json.loads(urllib.request.urlopen(base + path,
                                                 timeout=30).read())

    try:
        for base in bases:
            for _ in range(4):
                for r in range(4):
                    urllib.request.urlopen(
                        base + "/index/i/query",
                        data=f"Count(Row(f={r}))".encode()).read()
        tiers = [a.executor.result_cache.snapshot()["tiers"] for a in apis]
        assert tiers[1] == tiers[0]
        rc = apis[1].executor.result_cache
        assert rc.hits["request"] + rc.hits["eval"] >= 12
        text = urllib.request.urlopen(bases[1] + "/metrics").read().decode()
        for fam in ("pilosa_result_cache_hits_total",
                    "pilosa_result_cache_misses_total",
                    "pilosa_result_cache_bytes",
                    "pilosa_rank_cache_entries"):
            assert fam in text
        docs = [get(b, "/debug/hotspots") for b in bases]
        for d in docs:
            assert d["resultCache"]["hits"] >= 12
            assert d["resultCache"]["hitRatio"] > 0.5
            obs = d["opportunity"]["observed"]
            assert obs["hits"] == d["resultCache"]["hits"]
            assert "predictedTotalEstSavedS" in obs and "rankCache" in d
        assert docs[1]["resultCache"]["tiers"] == \
            docs[0]["resultCache"]["tiers"]
        assert set(docs[1]) == set(docs[0])
        health = [get(b, "/internal/health") for b in bases]
        assert set(health[1]) == set(health[0])
        assert health[1]["resultCache"]["enabled"]
        assert health[1]["resultCache"]["tiers"] == \
            health[0]["resultCache"]["tiers"]
        assert {"hits", "patches", "rebuilds"} <= \
            set(health[1]["rankCache"])
        mem = get(bases[1], "/debug/memory")
        assert mem["totalBytes"] == sum(
            c["bytes"] for c in mem["categories"].values())
        assert rc.bytes > 0
        assert mem["categories"]["result_cache"]["bytes"] >= rc.bytes
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()
        jh.close()


def test_prometheus_counter_names(pair):
    stats = (JaxStats(), MemStatsClient())
    for e, st in zip((pair.jex, pair.tex), stats):
        e.result_cache.stats = st
    pair.execute("Count(Row(f=1))")
    pair.execute("Count(Row(f=1))")
    texts = []
    for e, st, prom in zip((pair.jex, pair.tex), stats,
                           (jax_prometheus_text, prometheus_text)):
        e.result_cache.publish(st)
        texts.append(prom(st))
    for line in ("pilosa_result_cache_hits_total 1",
                 "pilosa_result_cache_eval_hits_total 1",
                 "pilosa_result_cache_hit_ratio"):
        assert line in texts[0] and line in texts[1]
    # The same series; their values too, but for the bytes gauge: the
    # port's eval tier keeps a count as an int, the JAX package's as its
    # per-shard count array.
    fams = [{ln.rsplit(" ", 1)[0] if "_bytes " in ln else ln
             for ln in t.splitlines() if ln.startswith("pilosa_result")}
            for t in texts]
    assert fams[1] == fams[0]


def test_timeline_cache_lane_slice_on_hit(pair):
    from pilosa_tpu.utils.profile import QueryProfile as JaxProfile
    from pilosa_tpu.utils.timeline import TIMELINE as JAX_TIMELINE
    from pilosa_tpu_torch.utils.profile import QueryProfile
    from pilosa_tpu_torch.utils.timeline import TIMELINE
    names = []
    for e, tlmod, profcls in ((pair.jex, JAX_TIMELINE, JaxProfile),
                              (pair.tex, TIMELINE, QueryProfile)):
        tlmod.configure(enabled=True, sample_every=1)
        try:
            e.execute_full("i", "Count(Row(f=2))")
            tl = tlmod.begin(None, "i")
            prof = profcls("i", "Count(Row(f=2))")
            prof.timeline = tl
            e.execute_full("i", "Count(Row(f=2))", profile=prof)
            tlmod.finish(tl)
            (req,) = tlmod.requests(last=1)
            names.append(sorted({ev[0] for ev in req.events}))
        finally:
            tlmod.reset()
    assert "cache" in names[1] and names[1] == names[0]
