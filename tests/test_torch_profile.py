"""The port's query profiler (``pilosa_tpu_torch/utils/profile.py`` and
its executor hooks) against the JAX package's: the same queries and
batches on the same seeded data give profile trees of the same op and
eval structure with the same launch attributes (``megaBatch``,
``megaIndex``, ``planEntries``, ``planBytes``, ``launchBytes``,
``opcodeHist``, ``planEntriesBefore/After``), the megakernel on in both
packages. Then the port's sampling policy (no fence unsampled, 1 in N,
forced), its stats feed, the slow-query ring and the coalescer's
handling of forced profiles. Timings are not compared."""

import threading
from collections import OrderedDict

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.ops import plan_opt as jplan_opt
from pilosa_tpu.utils.profile import QueryProfile as JaxQueryProfile
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.ops import plan_opt
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.server.coalescer import QueryCoalescer
from pilosa_tpu_torch.utils.profile import Profiler, QueryProfile
from pilosa_tpu_torch.utils.roofline import ROOFLINE
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


# The launch attributes an eval node carries, compared exactly.
DATA = ("megaBatch", "megaIndex", "planEntries", "planBytes",
        "launchBytes", "opcodeHist", "planEntriesBefore",
        "planEntriesAfter")


def _seed(idx, field_options):
    rng = np.random.default_rng(31)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 6000).astype(np.uint64)
    idx.create_field("f").import_bits(
        rng.integers(0, 6, 6000).astype(np.uint64), cols)
    idx.create_field("g").import_bits(
        rng.integers(0, 6, 3000).astype(np.uint64), cols[::2])
    idx.create_field("h")
    idx.create_field("v", field_options(type="int", min=0, max=1000))
    idx.field("v").import_values(
        cols[:2000], rng.integers(0, 1001, 2000).astype(np.int64))
    idx.add_existence(cols)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """(JAX executor, port executor) over the same seeded data, the
    megakernel on in both, densities at their defaults in both."""
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    for mod in (jplan_opt, plan_opt):
        monkeypatch.setattr(mod, "_density", OrderedDict())
        monkeypatch.setattr(mod, "note_bank_density", lambda *a: None)
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    _seed(jh.create_index("p"), JaxFieldOptions)
    ph = Holder(device="cpu")
    _seed(ph.create_index("p"), FieldOptions)
    jex = JaxExecutor(jh)
    jex.result_cache.enabled = False
    pex = Executor(ph, device="cpu")
    pex.result_cache.enabled = False
    yield jex, pex
    jh.close()


def structure(profile):
    """(op name, [(eval name, {launch attrs})]) of each op."""
    out = []
    for op in profile.to_json()["ops"]:
        evals = []
        stack = list(op.get("children", []))
        while stack:
            node = stack.pop(0)
            if node["name"].startswith("eval:"):
                evals.append((node["name"],
                              {k: node[k] for k in DATA if k in node}))
            stack.extend(node.get("children", []))
        out.append((op["name"], evals))
    return out


QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Row(f=2)",
    "Count(Not(Row(f=2)))",
    "Count(Row(v > 500))",
    "TopN(f, Row(g=1), n=3)",
    "TopN(f, n=2)",
    "Sum(Row(f=1), field=v)",
    "Max(Row(g=3), field=v)",
    "GroupBy(Rows(f), filter=Row(g=1))",
    "Rows(g)",
    "Row(f=1) Count(Union(Row(f=2), Row(g=3))) Count(Xor(Row(f=4), "
    "Row(g=4)))",
    "Store(Intersect(Row(f=1), Row(g=2)), h=5)",
    "Set(7, f=1) Count(Row(f=1))",
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_profile_tree_matches_jax(pair, i):
    jex, pex = pair
    q = QUERIES[i]
    jp = JaxQueryProfile("p", q, sample_device=True, forced=True)
    pp = QueryProfile("p", q, sample_device=True, forced=True)
    want = jex.execute("p", q, profile=jp)
    got = pex.execute("p", q, profile=pp)
    assert len(got) == len(want)
    assert structure(pp) == structure(jp)
    for op in pp.to_json()["ops"]:
        assert op["dispatchS"] >= 0 and "materializeS" in op
        for ev in op.get("children", []):
            assert ev["deviceS"] >= 0 and ev["jit"] == "hit"


BATCHES = {
    "mixed": (["Count(Row(f=1))", "Count(Row(f=2))", "Row(g=4)",
               "Count(Intersect(Row(f=3), Row(g=5)))",
               "Count(Row(v >= 100))"]),
    "groups": (["Count(Row(f=1))", "Count(Row(f=2))", "Count(Row(f=3))",
                "Row(g=1)", "Row(g=2)",
                "Count(Union(Row(f=0), Row(g=0), Row(f=5)))"]),
    "write_fence": (["Count(Row(f=1))", "Row(g=2)", "Set(9, f=1)",
                     "Count(Row(f=1))", "Count(Not(Row(g=2)))"]),
    "multi_call": (["Count(Row(f=1)) Row(g=1)",
                    "Count(Intersect(Row(f=1), Row(g=2))) TopN(f, n=1)",
                    "Count(Row(v < 20))"]),
    "solo_group": (["Count(Row(f=1))", "Count(Row(f=2))"]),
}


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("sampled", [False, True])
def test_batch_profile_trees_match_jax(pair, name, sampled):
    jex, pex = pair
    qs = BATCHES[name]
    jps = [JaxQueryProfile("p", q, sample_device=sampled) for q in qs]
    pps = [QueryProfile("p", q, sample_device=sampled) for q in qs]
    jex.execute_batch([("p", q, None) for q in qs], profiles=jps)
    out = pex.execute_batch([("p", q, None) for q in qs], profiles=pps)
    assert not any(isinstance(o, Exception) for o in out), out
    assert [structure(p) for p in pps] == [structure(p) for p in jps]
    assert [p.fused_batch for p in pps if p.fused_batch] == \
        [p.fused_batch for p in jps if p.fused_batch and any(
            "megaBatch" in n.attrs for op in p.ops for n in op.children)]
    for p in pps:
        for op in p.to_json()["ops"]:
            for ev in op.get("children", []):
                assert ("deviceS" in ev) is sampled


# ------------------------------------------------------ the port's policy


def _api():
    api = API(Holder(device="cpu"), stats=MemStatsClient())
    # Repeats must run (and fence) as in the JAX package's profile tests,
    # which switch its result cache off too.
    api.executor.result_cache.enabled = False
    idx = api.holder.create_index("p")
    cols = np.array([1, 2, SHARD_WIDTH + 3], np.uint64)
    idx.create_field("f").import_bits(np.full(3, 1, np.uint64), cols)
    idx.create_field("g").import_bits(np.full(3, 1, np.uint64), cols)
    idx.add_existence(cols)
    return api


@pytest.fixture
def fences(monkeypatch):
    calls = []
    real = ex_mod._fence_device
    monkeypatch.setattr(ex_mod, "_fence_device",
                        lambda s: calls.append(1) or real(s))
    return calls


def test_profile_tree_count_intersect_two_shards():
    api = _api()
    resp = api.query("p", "Count(Intersect(Row(f=1), Row(g=1)))",
                     profile=True)
    assert resp["results"] == [3]
    p = resp["profile"]
    assert p["deviceSampled"] is True and p["durS"] > 0
    assert p["jit"] == {"hits": 1, "misses": 0}
    (op,) = p["ops"]
    (ev,) = op["children"]
    assert ev["name"] == "eval:count" and ev["shards"] == 2
    assert ev["sig"] == "count|r0r1I2|S2"
    assert ev["deviceS"] > 0 and ev["planS"] >= 0
    assert p["totals"]["deviceS"] == ev["deviceS"]


def test_no_fence_unsampled_and_one_in_n(fences):
    api = _api()
    api.query("p", "Count(Row(f=1))")
    assert fences == []
    api.query("p", "Count(Row(f=1))", profile=True)
    assert len(fences) == 1
    api.profiler.configure(sample_every=3)
    assert ROOFLINE.sample_every == 3
    for _ in range(6):
        api.query("p", "Count(Row(f=1))")
    assert len(fences) == 3  # queries 3 and 6
    api.profiler.configure(sample_every=0)


def test_device_seconds_carries_sampled_label_and_series():
    api = _api()
    api.profiler.configure(sample_every=2)
    try:
        for _ in range(4):
            api.query("p", "Count(Row(f=1))")
    finally:
        api.profiler.configure(sample_every=0)
    prom = prometheus_text(api.stats)
    line = next(ln for ln in prom.splitlines()
                if ln.startswith("pilosa_executor_device_seconds{"))
    assert 'sampled="true"' in line
    assert "pilosa_executor_device_sample_every 2" in prom
    for fam in ("pilosa_executor_plan_seconds",
                "pilosa_executor_dispatch_seconds",
                "pilosa_executor_materialize_seconds",
                "pilosa_executor_jit_hit_total", "pilosa_query_total",
                "pilosa_query_direct_seconds"):
        assert f"# TYPE {fam} " in prom, fam


def test_slow_query_ring_and_errors():
    api = _api()
    api.long_query_time = 1e-9
    api.query("p", "Count(Row(f=1))")
    rec = api.profiler.slow_queries()[0]
    assert (rec["index"], rec["query"], rec["kind"]) == \
        ("p", "Count(Row(f=1))", "query")
    assert rec["profile"]["ops"][0]["name"] == "Count"
    api.profiler.configure(ring_size=2)
    for i in range(4):
        api.query("p", f"Count(Row(f={i}))")
    recs = api.profiler.slow_queries()
    assert len(recs) == 2 and recs[0]["query"] == "Count(Row(f=3))"
    with pytest.raises(Exception):
        api.query("p", "Count(Row(nope=1))")
    assert "error" in api.profiler.slow_queries()[0]
    out = api.query_batch([{"index": "p", "query": "Count(Row(f=1))"}])
    assert out[0]["results"] == [3]
    assert api.profiler.slow_queries()[0]["kind"] == "batch"
    assert api.stats.snapshot()["counters"]["executor.slow_query"] >= 3


def test_batch_profiles_forced_and_sampled(fences):
    api = _api()
    items = [{"index": "p", "query": "Count(Row(f=1))"},
             {"index": "p", "query": "Row(g=1)"}]
    out = api.query_batch(items, profile=True)
    assert [o["results"] for o in out] == [[3], [{"columns": [
        1, 2, SHARD_WIDTH + 3]}]]
    assert all(o["profile"]["deviceSampled"] for o in out)
    n = len(fences)
    assert n >= 1
    api.profiler.configure(sample_every=1)
    try:
        out = api.query_batch(items)
    finally:
        api.profiler.configure(sample_every=0)
    assert all("profile" not in o for o in out) and len(fences) > n
    out = api.query_batch(items)
    assert len(fences) > n


def test_coalesced_dedup_skips_forced_profiles():
    api = _api()
    coal = QueryCoalescer(api.executor, window_s=0.02, stats=api.stats)
    coal.start()
    api.coalescer = coal
    try:
        results = []

        def go():
            results.append(api.query_coalesced("p", "Count(Row(f=1))",
                                               profile=True))

        threads = [threading.Thread(target=go) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(r["results"] == [3] for r in results)
        assert all(r["profile"]["ops"] for r in results)
        assert all("coalesced" in r["profile"] for r in results)
        assert coal.counters.get("deduped", 0) == 0
    finally:
        coal.stop()


def test_profile_reused_across_executes_keeps_per_op_attribution():
    api = _api()
    prof = api.profiler.begin("p", "reused", force=True)
    api.executor.execute("p", "Row(f=1)", profile=prof)
    api.executor.execute("p", "Count(Row(f=1))", profile=prof)
    assert [op.name for op in prof.ops] == ["Row", "Count"]
    for op in prof.ops:
        assert "materializeS" in op.attrs, op.to_json()
    assert prof.ops[0].attrs["d2hBytes"] > 0  # the Row's words


def test_profiler_observe_never_raises_without_sinks():
    prof = Profiler()
    p = prof.begin("i", "Count(Row(f=1))")
    prof.observe("i", "Count(Row(f=1))", 0.5, profile=p,
                 long_query_time=0.1, logger=None)
    assert prof.slow_queries()[0]["durS"] == 0.5
    q = QueryProfile("i", "x", forced=True)
    q.add_node_fragment("node-a", {"ops": []})
    assert set(q.to_json()["nodes"]) == {"node-a"}


def test_cli_reads_the_measurement_environment():
    """``cli server`` takes the profiler's rate, the slow ring and the
    roofline from the JAX package's environment names (through
    ``utils/config.load_config``)."""
    from pilosa_tpu_torch.cli.main import configure_planes
    from pilosa_tpu_torch.utils.config import Config, load_config
    from pilosa_tpu_torch.utils.timeline import TIMELINE
    env = {"PILOSA_TPU_PROFILE_SAMPLE_EVERY": "4",
           "PILOSA_TPU_PROFILE_SLOW_RING": "16",
           "PILOSA_TPU_LONG_QUERY_TIME": "0.5",
           "PILOSA_TPU_ROOFLINE_ENABLED": "false",
           "PILOSA_TPU_ROOFLINE_GBPS": "3350",
           "PILOSA_TPU_TIMELINE_SAMPLE_EVERY": "2"}
    got = load_config(environ=env)
    assert load_config(environ={}) == Config()
    assert (got.profile_sample_every, got.profile_slow_ring,
            got.long_query_time, got.roofline_enabled,
            got.roofline_gbps, got.timeline_sample_every) == \
        (4, 16, 0.5, False, 3350.0, 2)
    api = _api()
    try:
        configure_planes(api, got)
        assert api.profiler.sample_every == 4
        assert api.long_query_time == 0.5
        assert ROOFLINE.enabled is False
        assert ROOFLINE.roofline_gbps() == (3350.0, "config", False)
        assert TIMELINE.sample_every == 2
    finally:
        configure_planes(api, Config())
    assert ROOFLINE.enabled and ROOFLINE.gbps_configured == 0.0
    assert TIMELINE.sample_every == 1


def test_drain_telemetry_dumps_once():
    """The server's shutdown writes the slow ring, the timelines, the
    roofline and the spans to its log, once."""
    from pilosa_tpu_torch.cli.main import drain_telemetry
    from pilosa_tpu_torch.utils.tracing import RecordingTracer
    api = _api()
    api.tracer = RecordingTracer()
    api.long_query_time = 1e-9
    lines = []

    class Log:
        def printf(self, fmt, *a):
            lines.append(fmt % a if a else fmt)

    api.logger = Log()
    with api.tracer.span("s"):
        pass
    api.query("p", "Count(Row(f=1))")
    n = len(lines)
    drain_telemetry(api)
    assert any(ln.startswith("profiler:") for ln in lines[n:])
    assert any(ln.startswith("tracer:") for ln in lines[n:])
    m = len(lines)
    drain_telemetry(api)
    assert len(lines) == m
