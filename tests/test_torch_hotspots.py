"""The port's workload recorder (``utils/hotspots.py``) and
``/debug/hotspots`` against the JAX package's, on the CPU. The recorder's
own cases run one script through both recorders under one injected clock
and compare the ``snapshot()`` documents exactly (save a range of 10**12
row ids, which the port's alone records: the JAX package copies every
id before it keeps 64); the executor and server cases run the same
queries through both packages and compare the documents' counts
(reads, writes, touches, signature hits and generation runs, the
repeat windows). The cases are those of the JAX
package's ``tests/test_hotspots.py``.

By design two fields differ between the packages' executor documents: a
signature's ``fingerprint`` and ``sig`` (the port keys an eval by its
tree, rows, predicate values and shard count; the JAX package's
signature also names its bank shapes, which the generation covers), and
a fragment's ``generation`` (each package numbers its own writes)."""

import json
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest

from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.server.coalescer import QueryCoalescer as JaxCoalescer
from pilosa_tpu.utils import hotspots as jhot
from pilosa_tpu.utils.stats import MemStatsClient as JaxStats

from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.coalescer import QueryCoalescer
from pilosa_tpu_torch.server.http import serve
from pilosa_tpu_torch.utils import hotspots as phot
from pilosa_tpu_torch.utils.stats import MemStatsClient, prometheus_text

MODS = (jhot, phot)


@pytest.fixture(autouse=True)
def _reset_workload():
    """Both recorders are process-wide: every case starts clean."""
    for m in MODS:
        m.WORKLOAD.reset()
        m.WORKLOAD.configure(enabled=True, half_life_s=600.0,
                             window_s=300.0, top_k=10, max_fragments=4096,
                             max_rows=4096, max_signatures=1024)
        m.WORKLOAD.stats = None
    yield
    for m in MODS:
        m.WORKLOAD.reset()
        m.WORKLOAD.stats = None


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _seed(holder):
    idx = holder.create_index("ws")
    cols = np.array([1, 2, SHARD_WIDTH + 3], np.uint64)
    for name in ("f", "g"):
        idx.create_field(name).import_bits(np.full(3, 1, np.uint64), cols)
    idx.add_existence(cols)
    return idx


def _recorders(**kw):
    clock = FakeClock()
    return clock, [m.WorkloadRecorder(clock=clock, **kw) for m in MODS]


def _same_snapshots(recs, **kw):
    docs = [r.snapshot(**kw) for r in recs]
    assert docs[1] == docs[0]
    return docs[1]


# ------------------------------------------------------------- decay math


def test_ewma_half_life_under_injected_clock():
    clock, recs = _recorders(half_life_s=10.0)
    for r in recs:
        for _ in range(100):
            r.record_read("i", "f", "standard", [0])
    ent = _same_snapshots(recs)["fragments"][0]
    assert ent["reads"] == 100
    assert ent["readRate"] == pytest.approx(100.0, rel=1e-6)
    clock.advance(10.0)
    assert _same_snapshots(recs)["fragments"][0]["readRate"] == \
        pytest.approx(50.0, rel=1e-6)
    clock.advance(20.0)
    assert _same_snapshots(recs)["fragments"][0]["readRate"] == \
        pytest.approx(12.5, rel=1e-6)
    for r in recs:
        r.record_read("i", "f", "standard", [0])
    ent = _same_snapshots(recs)["fragments"][0]
    assert ent["readRate"] == pytest.approx(13.5, rel=1e-6)
    assert ent["reads"] == 101


def test_window_prunes_by_age_and_caps_events():
    out = []
    for m in MODS:
        clock = FakeClock()
        w = m._Window(window_s=30.0, max_events=4)
        got = [w.add("a", clock()), w.add("a", clock())]
        clock.advance(31.0)
        got.append(w.add("a", clock()))
        for k in ("b", "c", "d", "e"):
            got.append(w.add(k, clock()))
        got.append(w.snapshot(clock()))
        out.append(got)
    assert out[1] == out[0]
    assert out[1][:3] == [False, True, False]
    assert (out[1][-1]["seen"], out[1][-1]["seenTotal"],
            out[1][-1]["repeatsTotal"]) == (4, 7, 1)


# ---------------------------------------------------------- LRU + totals


def test_fragment_lru_bound_and_provable_totals():
    _, recs = _recorders(max_fragments=8)
    for r in recs:
        for s in range(32):
            r.record_read("i", "f", "standard", [s])
            r.record_write("i", "f", "standard", s, generation=s)
    snap = _same_snapshots(recs, top_k=100)
    assert len(snap["fragments"]) == 8
    for k in ("fragmentReads", "fragmentWrites"):
        assert snap["totals"][k] == 32 == \
            snap["tracked"][k] + snap["evicted"][k]
    assert snap["evicted"]["fragmentReads"] == 24
    _, recs2 = _recorders(max_fragments=4)
    for r in recs2:
        for s in range(4):
            r.record_read("i", "f", "standard", [s])
        r.record_read("i", "f", "standard", [0])
        r.record_read("i", "f", "standard", [99])
    shards = {f["shard"] for f in
              _same_snapshots(recs2, top_k=100)["fragments"]}
    assert 0 in shards and 1 not in shards


def test_row_and_signature_lru_bounds():
    _, recs = _recorders(max_rows=4, max_signatures=4)
    for r in recs:
        r.record_read("i", "f", "standard", [0], rows=range(16))
    snap = _same_snapshots(recs, top_k=100)
    assert len(snap["rows"]) == 4 and snap["totals"]["rowTouches"] == 16
    for r in recs:
        for i in range(9):
            r.record_query(("sig", i), ("g",), index="i", mode="count",
                           n_shards=1)
    snap = _same_snapshots(recs, top_k=100)
    assert len(snap["signatures"]) == 4
    assert snap["totals"]["queries"] == 9 == \
        snap["tracked"]["queries"] + snap["evicted"]["queries"]


def test_row_cap_per_call_records_scan_aggregate():
    assert phot.ROW_CAP_PER_CALL == jhot.ROW_CAP_PER_CALL
    _, recs = _recorders()
    for r in recs:
        r.record_read("i", "f", "standard", [0],
                      rows=range(phot.ROW_CAP_PER_CALL + 100))
    snap = _same_snapshots(recs, top_k=1000)
    assert len(snap["rows"]) == phot.ROW_CAP_PER_CALL
    assert snap["totals"]["rowsScanned"] == 100


def test_row_cap_reads_only_the_capped_ids():
    """The cap reads ROW_CAP_PER_CALL ids and no more: a range of 10**12
    ids, which no walk could finish, records within a second."""
    cap = phot.ROW_CAP_PER_CALL
    rec = phot.WorkloadRecorder(clock=FakeClock())
    t0 = time.perf_counter()
    rec.record_read("i", "f", "standard", [0], rows=range(10 ** 12))
    assert time.perf_counter() - t0 < 1.0
    snap = rec.snapshot(top_k=1000)
    assert sorted(r["row"] for r in snap["rows"]) == list(range(cap))
    assert snap["totals"]["rowTouches"] == cap
    assert snap["totals"]["rowsScanned"] == 10 ** 12 - cap
    assert snap["fragments"][0]["rowsScanned"] == 10 ** 12 - cap


_UNSORTED_IDS = [(i * 7919) % 100_003 for i in range(1000)]


@pytest.mark.parametrize("rows", [
    tuple(sorted(_UNSORTED_IDS)), _UNSORTED_IDS, range(5, 5005, 5),
    [9, 4, 4, 1]], ids=["tuple", "list", "range", "short_list"])
def test_row_cap_snapshot_matches_reference(rows):
    """Whatever sequence the executor passes, the port records the same
    first ids, touches, scans and fragment stats as the JAX package."""
    cap = phot.ROW_CAP_PER_CALL
    _, recs = _recorders()
    for r in recs:
        r.record_read("i", "f", "standard", [0, 1], rows=rows)
        r.record_read("i", "f", "standard", [1], rows=rows, rows_scanned=3)
    snap = _same_snapshots(recs, top_k=1000)
    head = list(rows)[:cap]
    over = max(0, len(rows) - cap)
    assert sorted((r["row"], r["touches"]) for r in snap["rows"]) == \
        sorted((row, 2 * n) for row, n in Counter(head).items())
    assert snap["totals"]["rowTouches"] == 2 * len(head)
    assert snap["totals"]["rowsScanned"] == 2 * over + 3
    assert {f["shard"]: (f["reads"], f["rowsScanned"])
            for f in snap["fragments"]} == {0: (1, over),
                                            1: (2, over + 3)}


def test_kill_switch_skips_all_recording():
    _, recs = _recorders()
    for r in recs:
        r.enabled = False
        r.record_read("i", "f", "standard", [0], rows=[1])
        r.record_write("i", "f", "standard", 0)
        r.record_query("fp", "g", index="i", mode="count", n_shards=1)
        assert r.record_request("k") is False
    snap = _same_snapshots(recs)
    assert snap["totals"]["fragmentReads"] == snap["totals"]["queries"] \
        == snap["queriesWindow"]["seen"] == 0


# ------------------------------------------------- executor wiring


def _counts(snap):
    """The deterministic counts of a /debug/hotspots document."""
    frag = sorted((f["index"], f["field"], f["view"], f["shard"],
                   f["reads"], f["writes"], f["rowsScanned"],
                   f["bankInvalidations"]) for f in snap["fragments"])
    rows = sorted((r["index"], r["field"], r["row"], r["touches"])
                  for r in snap["rows"])
    sigs = sorted((s["index"], s["mode"], s["shards"], s["hits"],
                   s["genHits"]) for s in snap["signatures"])
    win = {k: {x: snap[k][x] for x in ("seen", "repeats", "seenTotal",
                                        "repeatsTotal")}
           for k in ("queriesWindow", "requestsWindow")}
    return (snap["totals"], snap["tracked"], snap["evicted"], frag, rows,
            sigs, win)


class Apis:
    """A JAX and a port API over the same seeded index."""

    def __init__(self, tmp_path, cache=True):
        from pilosa_tpu.core.holder import Holder as JaxHolder
        self.jh = JaxHolder(str(tmp_path / "j"))
        self.jh.open()
        self.th = Holder(device="cpu")
        for h in (self.jh, self.th):
            _seed(h)
        self.apis = (JaxAPI(self.jh, stats=JaxStats()),
                     API(self.th, stats=MemStatsClient()))
        for a in self.apis:
            a.executor.result_cache.enabled = cache

    def query(self, q):
        out = [a.query("ws", q) for a in self.apis]
        assert out[1] == out[0]
        return out[1]

    def reset(self):
        for m in MODS:
            m.WORKLOAD.reset()

    def hotspots(self, **kw):
        docs = [a.debug_hotspots(**kw) for a in self.apis]
        assert _counts(docs[1]) == _counts(docs[0])
        assert set(docs[1]) == set(docs[0])
        return docs

    def close(self):
        self.jh.close()


@pytest.fixture
def apis(tmp_path):
    a = Apis(tmp_path)
    yield a
    a.close()


@pytest.fixture
def apis_nocache(tmp_path):
    # The recorder under test prices repeats that run: with the result
    # cache on, hits skip the evaluation by design (both packages).
    a = Apis(tmp_path, cache=False)
    yield a
    a.close()


def test_zero_fences_on_recording_path(apis_nocache, monkeypatch):
    import pilosa_tpu_torch.executor.executor as ex_mod
    fences = []
    real = ex_mod._fence_device
    monkeypatch.setattr(ex_mod, "_fence_device",
                        lambda s: fences.append(1) or real(s))
    for i in range(8):
        apis_nocache.query(f"Count(Row(f={i % 2}))")
    assert fences == []
    assert phot.WORKLOAD.summary()["fragmentReads"] > 0
    assert phot.WORKLOAD.summary()["queries"] == \
        jhot.WORKLOAD.summary()["queries"] == 8


def test_reads_writes_and_generation_recorded(apis):
    apis.reset()
    apis.query("Count(Row(f=1))")
    docs = apis.hotspots()
    frags = {(f["field"], f["shard"]): f for f in docs[1]["fragments"]}
    assert frags[("f", 0)]["reads"] == frags[("f", 1)]["reads"] == 1
    assert docs[1]["rows"][0]["row"] == 1
    apis.query("Set(5, f=1)")
    docs = apis.hotspots()
    f0 = next(f for f in docs[1]["fragments"]
              if f["field"] == "f" and f["shard"] == 0 and f["writes"])
    assert f0["generation"] == \
        apis.th.index("ws").field("f").view().fragment(0).version
    apis.query("Count(Row(f=1))")
    docs = apis.hotspots()
    f0 = next(f for f in docs[1]["fragments"]
              if f["field"] == "f" and f["shard"] == 0)
    assert f0["bankInvalidations"] >= 1


def test_topn_and_groupby_record_reads(apis):
    apis.reset()
    apis.query("TopN(f, n=2)")
    docs = apis.hotspots()
    assert any(f["field"] == "f" and f["reads"] for f in docs[1]["fragments"])
    assert any(r["field"] == "f" and r["row"] == 1 for r in docs[1]["rows"])
    apis.reset()
    apis.query("GroupBy(Rows(f), Rows(g))")
    docs = apis.hotspots()
    assert {"f", "g"} <= {f["field"] for f in docs[1]["fragments"]
                          if f["reads"]}


def test_synthetic_repeat_structure_and_saved_seconds(apis_nocache):
    apis_nocache.reset()
    for i in range(64):
        apis_nocache.query(f"Count(Row(f={i % 4}))")
    docs = apis_nocache.hotspots()
    snap = docs[1]
    assert (snap["queriesWindow"]["seen"],
            snap["queriesWindow"]["repeats"]) == (64, 60)
    assert len(snap["signatures"]) == 4
    for s in snap["signatures"]:
        assert (s["hits"], s["genHits"]) == (16, 16)
    # The API's queries are profiled (the profiler's default), so each
    # eval's seconds feed its signature in both packages.
    for s in snap["signatures"]:
        assert s["avgEvalS"] is not None and s["avgEvalS"] > 0
        assert s["estSavedS"] == pytest.approx(15 * s["avgEvalS"])
    opp = snap["opportunity"]["signatures"]
    assert len(opp) == 4
    assert opp == sorted(opp, key=lambda s: -s["estSavedS"])
    total = snap["opportunity"]["totalEstSavedS"]
    assert total == pytest.approx(sum(s["estSavedS"] for s in opp))
    narrow = apis_nocache.apis[1].debug_hotspots(top_k=1)["opportunity"]
    assert len(narrow["signatures"]) == 1
    assert narrow["totalEstSavedS"] == pytest.approx(total)
    fps = sorted(s["fingerprint"] for s in snap["signatures"])
    assert all(len(f) == 16 and int(f, 16) >= 0 for f in fps)
    assert fps == sorted(s["fingerprint"] for s in
                         apis_nocache.apis[1].debug_hotspots()["signatures"])


def test_generation_bump_resets_cacheable_run(apis_nocache):
    apis_nocache.reset()
    for _ in range(4):
        apis_nocache.query("Count(Row(f=1))")
    apis_nocache.query("Set(7, f=1)")
    apis_nocache.query("Count(Row(f=1))")
    docs = apis_nocache.hotspots()
    sig = next(s for s in docs[1]["signatures"]
               if s["mode"] == "count" and s["hits"] >= 5)
    assert (sig["hits"], sig["genHits"]) == (5, 1)


def test_bank_quadrants_join_ledger_and_access(apis):
    apis.reset()
    apis.query("Count(Row(f=1))")
    # The port's ledger is process-wide: other tests' banks rank too.
    banks = apis.apis[1].debug_hotspots(top_k=100000)["opportunity"][
        "banks"]
    assert banks
    by_field = {b["field"]: b for b in banks if b["index"] == "ws"}
    assert by_field["f"]["quadrant"].endswith("-hot")
    assert by_field["f"]["readRate"] > 0
    for b in banks:
        assert 0.0 <= b["density"] <= 1.0
        assert b["quadrant"] in ("dense-hot", "dense-cold", "sparse-hot",
                                 "sparse-cold")
        assert b["demotionScore"] >= 0.0
    scores = [b["demotionScore"] for b in banks]
    assert scores == sorted(scores, reverse=True)
    jbanks = apis.apis[0].debug_hotspots()["opportunity"]["banks"]
    assert set(banks[0]) == set(jbanks[0])


# -------------------------------------------------- coalescer + surfaces


class Servers:
    """A JAX and a port server, each with a coalescer."""

    def __init__(self, tmp_path):
        from pilosa_tpu.core.holder import Holder as JaxHolder
        self.jh = JaxHolder(str(tmp_path / "srv"))
        self.jh.open()
        self.th = Holder(device="cpu")
        for h in (self.jh, self.th):
            _seed(h)
        self.apis = (JaxAPI(self.jh, stats=JaxStats()),
                     API(self.th, stats=MemStatsClient()))
        self.apis[0].coalescer = JaxCoalescer(
            self.apis[0].executor, window_s=0.0005,
            stats=self.apis[0].stats, tracer=self.apis[0].tracer)
        self.apis[1].coalescer = QueryCoalescer(
            self.apis[1].executor, window_s=0.0005,
            stats=self.apis[1].stats, tracer=self.apis[1].tracer)
        self.srvs = []
        for a, fn in zip(self.apis, (jax_serve, serve)):
            a.coalescer.start()
            self.srvs.append(fn(a, "localhost", 0, background=True))
        self.bases = [f"http://localhost:{s.server_address[1]}"
                      for s in self.srvs]

    def close(self):
        for s, a in zip(self.srvs, self.apis):
            s.shutdown()
            s.server_close()
            a.coalescer.stop()
        self.jh.close()


@pytest.fixture
def servers(tmp_path):
    s = Servers(tmp_path)
    yield s
    s.close()


def _post(base, q):
    return urllib.request.urlopen(base + "/index/ws/query",
                                  data=q.encode()).read()


def test_cross_request_repeats_through_coalescer(servers):
    for m in MODS:
        m.WORKLOAD.reset()
    wins = []
    for base, m in zip(servers.bases, MODS):
        for _ in range(6):
            _post(base, "Count(Row(f=1))")
        w1 = m.WORKLOAD.requests_window.snapshot(m.WORKLOAD.clock())
        threads = [threading.Thread(target=_post,
                                    args=(base, f"Count(Row(f={i % 2}))"))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        w2 = m.WORKLOAD.requests_window.snapshot(m.WORKLOAD.clock())
        wins.append(((w1["seen"], w1["repeats"]),
                     (w2["seen"], w2["repeats"])))
    assert wins[1] == wins[0] == ((6, 5), (14, 12))
    assert servers.apis[1].coalescer.counters.get("window_repeat") == 12


def test_debug_hotspots_http_surface_and_metrics(servers):
    for m, a in zip(MODS, servers.apis):
        m.WORKLOAD.reset()
        m.WORKLOAD.stats = a.stats
    docs = []
    for base in servers.bases:
        for i in range(8):
            _post(base, f"Count(Row(f={i % 2}))")
        docs.append(json.loads(urllib.request.urlopen(
            base + "/debug/hotspots").read()))
    assert set(docs[1]) == set(docs[0])
    doc = docs[1]
    assert doc["enabled"] is True and doc["totals"]["fragmentReads"] > 0
    assert doc["totals"] == docs[0]["totals"]
    assert doc["totals"]["fragmentReads"] == \
        doc["tracked"]["fragmentReads"] + doc["evicted"]["fragmentReads"]
    assert doc["fragments"] and doc["signatures"]
    doc1 = json.loads(urllib.request.urlopen(
        servers.bases[1] + "/debug/hotspots?topk=1").read())
    assert len(doc1["fragments"]) == 1
    base = servers.bases[1]
    met = urllib.request.urlopen(base + "/metrics").read().decode()
    assert "# TYPE pilosa_fragment_reads_total counter" in met
    assert "# TYPE pilosa_query_repeat_ratio gauge" in met
    _post(base, "Set(9, f=1)")
    met = urllib.request.urlopen(base + "/metrics").read().decode()
    assert "pilosa_fragment_writes_total" in met


def test_slow_ring_hot_fragments_annotation(apis_nocache):
    for a in apis_nocache.apis:
        a.long_query_time = 1e-9
    apis_nocache.reset()
    for _ in range(3):
        apis_nocache.query("Count(Row(f=1))")
    recs = [a.profiler.slow_queries() for a in apis_nocache.apis]
    hot = [r[0]["hotFragments"] for r in recs]
    strip = [[{k: v for k, v in h.items() if k != "readRate"} for h in x]
             for x in hot]
    assert strip[1] == strip[0]
    assert hot[1][0]["index"] == "ws" and hot[1][0]["field"] == "f"
    assert hot[1][0]["reads"] >= 1 and all(h["field"] == "f"
                                           for h in hot[1])


def test_health_stanza_and_publish(apis):
    apis.reset()
    apis.query("Count(Row(f=1))")
    docs = [a.node_health() for a in apis.apis]
    wl = docs[1]["workload"]
    for k in ("enabled", "fragmentReads", "fragmentWrites", "queries",
              "trackedFragments", "trackedRows", "trackedSignatures"):
        assert wl[k] == docs[0]["workload"][k], k
    assert (wl["fragmentReads"], wl["queries"],
            wl["trackedSignatures"]) == (2, 1, 1)
    apis.apis[1].refresh_memory_gauges()
    out = prometheus_text(apis.apis[1].stats)
    assert "pilosa_query_repeat_ratio" in out
    assert "pilosa_workload_tracked_fragments" in out


def test_tanimoto_topn_over_positions_bank_caps_row_touches(tmp_path,
                                                           monkeypatch):
    """A Tanimoto TopN served over the positions bank, as at 10M
    molecules on the card, names every row of the view: each request
    touches ROW_CAP_PER_CALL of them (and its filter's one row) and
    counts the rest as scanned, as the JAX package records."""
    from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
    from pilosa_tpu.core.holder import Holder as JaxHolder
    from pilosa_tpu.executor import Executor as JaxExecutor
    molecules, cap = 600, phot.ROW_CAP_PER_CALL
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(molecules, dtype=np.uint64), 48)
    cols = rng.integers(0, 4096, len(rows)).astype(np.uint64)
    jh = JaxHolder(str(tmp_path / "j"))
    jh.open()
    th = Holder(device="cpu")
    for h, opts in ((jh, JaxFieldOptions), (th, FieldOptions)):
        h.create_index("mole", track_existence=False).create_field(
            "fp", opts(max_columns=4096)).import_bits(rows, cols)
    monkeypatch.setattr(ex_mod, "TOPN_MAX_BANK_BYTES", 0)
    served = []
    real = ex_mod.Executor._topn_positions
    monkeypatch.setattr(ex_mod.Executor, "_topn_positions",
                        lambda self, *a: served.append(1) or real(self, *a))
    executors = (JaxExecutor(jh), Executor(th, device="cpu"))
    try:
        for i, q in enumerate((3, 250, 599)):
            pql = f"TopN(fp, Row(fp={q}), n=50, tanimotoThreshold=30)"
            before = phot.WORKLOAD.snapshot()["totals"]
            answers = [ex.execute("mole", pql)[0].pairs for ex in executors]
            assert answers[1] == answers[0]
            assert len(served) == i + 1
            after = phot.WORKLOAD.snapshot()["totals"]
            assert after["rowTouches"] - before["rowTouches"] == cap + 1
            assert after["rowsScanned"] - before["rowsScanned"] == \
                molecules - cap
        docs = [m.WORKLOAD.snapshot(top_k=1000) for m in MODS]
        assert _counts(docs[1]) == _counts(docs[0])
    finally:
        jh.close()
