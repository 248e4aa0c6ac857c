"""The port's SLO sentinel (``utils/sentinel.py``) and its server wiring
against the JAX package's, on the CPU. The recorder's cases run one
script through both recorders (each fed by its own package's stats
client) on an injected clock and compare the ``history`` and
``slo_snapshot`` documents and the alert fire/clear events exactly. The
server cases drive both packages' APIs and HTTP servers the same way.
The cases are those of the JAX package's ``tests/test_sentinel.py``; its
two-node 5xx case runs here on one node through the ``api.query``
failpoint (the cluster is not ported)."""

import importlib.util
import json
import pathlib
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.utils import memledger as jledger
from pilosa_tpu.utils import sentinel as jsent
from pilosa_tpu.utils import stats as jstats
from pilosa_tpu.utils.failpoints import FAILPOINTS as JAX_FAILPOINTS

from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import serve
from pilosa_tpu_torch.utils import memledger as pledger
from pilosa_tpu_torch.utils import sentinel as psent
from pilosa_tpu_torch.utils import stats as pstats
from pilosa_tpu_torch.utils.failpoints import FAILPOINTS


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


SLO_BUCKETS = tuple(2.0 ** e for e in range(-14, 4))
MODS = ((jsent, jstats), (psent, pstats))


def _reset():
    for sent, _ in MODS:
        sent.SENTINEL.reset()
        sent.SENTINEL.configure(enabled=True, ring=720, decimate=10,
                                alert_ring=256, objectives={},
                                watermark_bytes=0)
        sent.SENTINEL.clock = time.time


@pytest.fixture(autouse=True)
def _reset_sentinel():
    """Both recorders are process-wide: every case starts clean."""
    _reset()
    yield
    _reset()


class Twin:
    """One recorder and one stats client per package, driven alike."""

    def __init__(self, objectives=None, **kw):
        self.parts = []
        for sent, st in MODS:
            s = sent.SentinelRecorder()
            s.configure(enabled=True, ring=kw.get("ring", 720),
                        decimate=kw.get("decimate", 10),
                        alert_ring=kw.get("alert_ring", 64),
                        objectives=objectives or {})
            self.parts.append((s, st.MemStatsClient(), st))

    def observe(self, seconds, n=1, status=200):
        for _, stats, _ in self.parts:
            red = stats.with_tags("endpoint:/index/{index}/query",
                                  f"status:{status}")
            for _ in range(n):
                red.histogram("http_request_seconds", seconds,
                              buckets=SLO_BUCKETS)

    def sample(self, gauges, t, histos=True):
        for s, stats, _ in self.parts:
            s.sample(gauges, stats.snapshot()["histograms"]
                     if histos else None, now=t)

    def same(self, fn):
        got = [fn(s) for s, _, _ in self.parts]
        assert got[1] == got[0]
        return got[1]

    def slo(self):
        return self.same(lambda s: s.slo_snapshot())

    @property
    def port(self):
        return self.parts[1][0]


# ------------------------------------------------------ objective parsing


def test_parse_objective():
    for text in ("99.9% < 25ms", " 95 % < 2 s ", "99% < 500us"):
        assert psent.parse_objective(text) == jsent.parse_objective(text)
    assert psent.parse_objective("99.9% < 25ms") == \
        (pytest.approx(0.999), pytest.approx(0.025))
    for bad in ("99.9%", "< 25ms", "99.9 < 25ms", "99.9% < 25",
                "99.9% < 25m", "101% < 1s", "0% < 1s", "99% < 0ms"):
        for mod in (jsent, psent):
            with pytest.raises(ValueError):
                mod.parse_objective(bad)


def test_quantile_from_deltas_interpolation():
    bounds = (0.001, 0.01, 0.1)
    for deltas, q in (((0, 10, 0, 0), 0.50), ((0, 0, 0, 5), 0.99),
                      ((0, 0, 0, 0), 0.99)):
        assert psent.quantile_from_deltas(bounds, deltas, q) == \
            jsent.quantile_from_deltas(bounds, deltas, q)
    assert 0.001 < psent.quantile_from_deltas(bounds, (0, 10, 0, 0),
                                              0.5) <= 0.01
    assert psent.quantile_from_deltas(bounds, (0, 0, 0, 5), 0.99) == 0.1


# -------------------------------------------------- windowed quantiles


def test_windowed_quantiles_see_step_change():
    tw = Twin({"query": "99% < 25ms"})
    t = 1000.0
    tw.sample({}, t)
    for _ in range(20):
        tw.observe(0.005, n=10)
        t += 30.0
        tw.sample({}, t)
    assert tw.slo()["endpoints"][0]["rates"]["p95"] < 0.01
    tw.observe(0.200, n=10)
    t += 30.0
    tw.sample({}, t)
    rates = tw.slo()["endpoints"][0]["rates"]
    assert rates["p50"] > 0.1 and rates["p95"] > 0.1
    assert rates["qps"] == pytest.approx(10 / 30.0)
    hist = tw.same(lambda s: s.history(series=["endpoint.query.p95"]))
    pts = hist["series"]["endpoint.query.p95"]["points"]
    assert pts[-1][1] > 0.1 and pts[0][1] < 0.01


# ------------------------------------------------- burn-rate state machine


def test_burn_alert_fires_sticky_and_clears_with_hysteresis():
    tw = Twin({"query": "99.9% < 25ms"})
    assert psent.BURN_WINDOWS == jsent.BURN_WINDOWS
    assert psent.CLEAR_FACTOR == jsent.CLEAR_FACTOR == 0.5
    t = 1000.0
    tw.sample({}, t)
    tw.observe(0.005, n=32)
    t += 30.0
    tw.sample({}, t)
    assert tw.same(lambda s: s.active_alerts()) == []
    tw.observe(0.005, n=32, status=500)
    t += 30.0
    tw.sample({}, t)
    keys = {a["key"] for a in tw.same(lambda s: s.active_alerts())}
    assert keys == {"slo-burn:query:300s", "slo-burn:query:1800s"}
    ep = tw.slo()["endpoints"][0]
    assert len(ep["burn"]) == 2 and all(b["active"] for b in ep["burn"])
    assert ep["budgetConsumed"] > 1.0 and ep["budgetRemaining"] == 0.0
    tw.observe(0.005, n=32)
    t += 60.0
    tw.sample({}, t)
    assert {a["key"] for a in tw.same(lambda s: s.active_alerts())} == keys
    assert tw.slo()["alerts"]["fired"] == 2
    t += 22000.0
    tw.observe(0.005, n=32)
    tw.sample({}, t)
    assert tw.same(lambda s: s.active_alerts()) == []
    snap = tw.slo()
    assert snap["alerts"]["cleared"] == 2
    events = [(e["event"], e["key"]) for e in snap["alerts"]["ring"]]
    assert events.count(("fire", "slo-burn:query:300s")) == 1
    assert events.count(("clear", "slo-burn:query:300s")) == 1


def test_latency_violations_burn_budget_without_5xx():
    tw = Twin({"query": "99% < 25ms"})
    tw.observe(0.005, n=2)
    tw.sample({}, 0.0)
    tw.observe(0.200, n=10)
    tw.sample({}, 30.0)
    ep = tw.slo()["endpoints"][0]
    assert ep["bad"] == 10 and ep["budgetConsumed"] > 1.0
    assert ep["thresholdBucket"] == pytest.approx(0.03125)


def test_note_condition_edge_triggered():
    tw = Twin()
    for s, _, _ in tw.parts:
        s.note_condition("hbm.pressure", True, "over watermark",
                         kind="memory", now=1.0)
        s.note_condition("hbm.pressure", True, "over watermark", now=2.0)
    snap = tw.slo()
    assert snap["alerts"]["fired"] == 1 and len(snap["alerts"]["ring"]) == 1
    for s, _, _ in tw.parts:
        s.note_condition("hbm.pressure", False, now=3.0)
        s.note_condition("hbm.pressure", False, now=4.0)
    assert tw.slo()["alerts"]["cleared"] == 1
    assert tw.same(lambda s: s.active_alerts()) == []


# ------------------------------------------------------ history ring


def test_history_ring_bounded_with_decimated_tier():
    tw = Twin(ring=16, decimate=4)
    for i in range(100):
        tw.sample({"device_idle_ratio": i / 100.0}, float(i), histos=False)
    s = tw.same(lambda r: r.history())["series"]["device_idle_ratio"]
    assert len(s["points"]) == 16 and s["points"][-1] == [99.0, 0.99]
    assert len(s["decimated"]) == 16 and s["decimate"] == 4
    assert s["decimated"][0][0] < s["points"][0][0]
    assert tw.same(lambda r: r.history(series=["nope"]))["series"] == {}
    doc = tw.same(lambda r: r.history(series=["device_idle_ratio"],
                                      last=3))
    evs = doc["traceEvents"]
    assert len(evs) == 3 and all(
        e["ph"] == "C" and e["name"] == "history:device_idle_ratio"
        for e in evs)
    assert evs[-1]["args"]["value"] == 0.99


def test_ring_nbytes_ledgered():
    tw = Twin({"query": "99% < 25ms"})
    tw.observe(0.005, n=8)
    for i in range(12):
        tw.sample({"device_idle_ratio": 0.5}, float(i))
    out = []
    for (s, _, _), led_mod in zip(tw.parts, (jledger, pledger)):
        led = led_mod.MemoryLedger()
        s.register_memory(led)
        n = s.ring_nbytes()
        snap = led.snapshot()
        out.append((n, led.totals()["telemetry"]["bytes"],
                    any(e.get("kind") == "sentinel"
                        for e in led.entries("telemetry")),
                    snap["totalBytes"] == sum(
                        c["bytes"] for c in snap["categories"].values())))
    assert out[1] == out[0]
    assert out[1][0] > 512 and out[1][0] == out[1][1] and out[1][2:] == \
        (True, True)


def test_disabled_sentinel_is_inert():
    tw = Twin()
    for s, _, _ in tw.parts:
        s.configure(enabled=False)
        s.sample({"device_idle_ratio": 0.5}, None, now=1.0)
        s.note_condition("x", True, now=2.0)
    snap = tw.slo()
    assert snap["samples"] == 0 and snap["alerts"]["fired"] == 0


# ------------------------------------------------------ /metrics + HELP


def test_publish_gauges_and_help_lines():
    tw = Twin({"query": "99.9% < 25ms"})
    tw.observe(0.005, n=4)
    tw.sample({}, 0.0)
    tw.observe(0.005, n=32, status=500)
    tw.sample({}, 30.0)
    proms = []
    for s, stats, st in tw.parts:
        s.publish(stats)
        proms.append(st.prometheus_text(stats))
    assert proms[1] == proms[0]
    prom = proms[1]
    assert 'pilosa_slo_burn_rate{endpoint="query",window="300s"}' in prom
    assert 'pilosa_slo_error_budget_remaining{endpoint="query"} 0' in prom
    assert "pilosa_sentinel_alerts_active 2" in prom
    lines = prom.splitlines()
    assert len([ln for ln in lines if ln.startswith("# HELP")]) == \
        len([ln for ln in lines if ln.startswith("# TYPE")]) > 0
    assert "# HELP pilosa_slo_burn_rate " in prom


# ------------------------------------------------------ server wiring


def _seed(h):
    import numpy as np
    idx = h.create_index("ws")
    cols = np.array([1, 2, (1 << 20) + 3], np.uint64)
    idx.create_field("f").import_bits(np.full(3, 1, np.uint64), cols)
    idx.add_existence(cols)


class Servers:
    def __init__(self, tmp_path):
        from pilosa_tpu.core.holder import Holder as JaxHolder
        self.jh = JaxHolder(str(tmp_path / "srv"))
        self.jh.open()
        self.th = Holder(device="cpu")
        for h in (self.jh, self.th):
            _seed(h)
        self.apis = (JaxAPI(self.jh, stats=jstats.MemStatsClient()),
                     API(self.th, stats=pstats.MemStatsClient()))
        self.srvs = [jax_serve(self.apis[0], "localhost", 0,
                               background=True),
                     serve(self.apis[1], "localhost", 0, background=True)]
        self.bases = [f"http://localhost:{s.server_address[1]}"
                      for s in self.srvs]

    def close(self):
        for s in self.srvs:
            s.shutdown()
            s.server_close()
        self.jh.close()


@pytest.fixture
def servers(tmp_path):
    s = Servers(tmp_path)
    yield s
    s.close()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def test_debug_history_and_slo_routes(servers):
    clock = [5000.0]
    for (sent, _), api in zip(MODS, servers.apis):
        sent.SENTINEL.configure(objectives={"query": "99.9% < 25ms"},
                                clock=lambda: clock[0])
    for _ in range(3):
        for a in servers.apis:
            a.sample_sentinel()
        clock[0] += 30.0
    docs = [_get(b, "/debug/history") for b in servers.bases]
    assert set(docs[1]["series"]) == set(docs[0]["series"])
    doc = docs[1]
    assert doc["samples"] == 3 and "node" in doc
    assert {"device_idle_ratio", "hbm_live_bytes",
            "result_cache_hit_ratio"} <= set(doc["series"])
    for name in ("result_cache_hit_ratio", "rank_cache_hit_ratio",
                 "mesh_collective_bytes", "coalescer_queue_depth"):
        assert doc["series"][name]["points"] == \
            docs[0]["series"][name]["points"]
    doc = _get(servers.bases[1],
               "/debug/history?series=device_idle_ratio&last=2")
    assert set(doc["series"]) == {"device_idle_ratio"}
    assert len(doc["series"]["device_idle_ratio"]["points"]) == 2
    for base in servers.bases:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/debug/history?bogus=1")
        assert ei.value.code == 400
    slos = [_get(b, "/debug/slo") for b in servers.bases]
    for d in slos:
        d.pop("node")
    assert slos[1] == slos[0]
    assert slos[1]["enabled"] and slos[1]["samples"] == 3
    assert slos[1]["objectives"]["query"]["thresholdS"] == 0.025
    health = [_get(b, "/internal/health") for b in servers.bases]
    assert health[1]["slo"] == health[0]["slo"]
    assert health[1]["slo"]["objectives"] == 1
    with urllib.request.urlopen(servers.bases[1] + "/metrics",
                                timeout=30) as r:
        met = r.read().decode()
    assert "pilosa_process_uptime_seconds" in met
    assert "pilosa_build_info{" in met and "pilosa_sentinel_series" in met


def test_sentinel_sampling_adds_no_device_fences(servers, monkeypatch):
    import pilosa_tpu_torch.executor.executor as exmod
    psent.SENTINEL.configure(objectives={"query": "99.9% < 25ms"},
                             clock=lambda: 1.0)
    fences = []
    real = exmod._fence_device
    monkeypatch.setattr(exmod, "_fence_device",
                        lambda s: fences.append(1) or real(s))
    api = servers.apis[1]
    api.sample_sentinel()
    api.debug_history()
    api.debug_slo()
    api.refresh_memory_gauges()
    assert fences == []


def test_client_5xx_burst_fires_and_clears_across_surfaces(servers):
    """An ``api.query`` failpoint burst of 5xx answers fires the burn
    alert in /debug/slo, /metrics and /internal/health of both servers;
    recovery past the slow window clears it. Injected clock."""
    clock = [1000.0]
    for sent, _ in MODS:
        sent.SENTINEL.configure(objectives={"query": "99.9% < 100s"},
                                clock=lambda: clock[0])
    fps = (JAX_FAILPOINTS, FAILPOINTS)

    def settle(api, sent):
        def landed():
            return sum(h["count"] for k, h in
                       api.stats.snapshot()["histograms"].items()
                       if k.startswith("http_request_seconds")
                       and "/index/{index}/query" in k)
        deadline = time.time() + 10.0
        while landed() < sent and time.time() < deadline:
            time.sleep(0.005)
        assert landed() >= sent

    sent_n = [0, 0]

    def burst(expect_5xx=False, n=32):
        for i, (base, api) in enumerate(zip(servers.bases, servers.apis)):
            bad = 0
            for _ in range(n):
                sent_n[i] += 1
                try:
                    urllib.request.urlopen(base + "/index/ws/query",
                                           data=b"Count(Row(f=1))").read()
                except urllib.error.HTTPError as e:
                    assert e.code >= 500
                    bad += 1
            assert (bad > 0) == expect_5xx
            settle(api, sent_n[i])
        clock[0] += 30.0
        for api in servers.apis:
            api.sample_sentinel()

    try:
        # Traffic before the baseline sample, so the endpoint's
        # histogram exists when the sentinel first reads it.
        for i, (base, api) in enumerate(zip(servers.bases, servers.apis)):
            for _ in range(8):
                sent_n[i] += 1
                urllib.request.urlopen(base + "/index/ws/query",
                                       data=b"Count(Row(f=1))").read()
            settle(api, sent_n[i])
        for api in servers.apis:
            api.sample_sentinel()
        clock[0] += 30.0
        burst()
        docs = [_get(b, "/debug/slo") for b in servers.bases]
        for d in docs:
            assert d["alerts"]["active"] == []
            ep = next(e for e in d["endpoints"] if "target" in e)
            assert ep["total"] >= 32 and ep["bad"] == 0
            assert ep["thresholdBucket"] == "+Inf"
        for fp in fps:
            fp.arm("api.query", "error")
        burst(expect_5xx=True)
        for fp in fps:
            fp.disarm_all()
        for base in servers.bases:
            d = _get(base, "/debug/slo")
            assert {a["key"] for a in d["alerts"]["active"]} == {
                "slo-burn:query:300s", "slo-burn:query:1800s"}
            met = urllib.request.urlopen(base + "/metrics").read().decode()
            assert "pilosa_sentinel_alerts_active 2" in met
            health = _get(base, "/internal/health")
            assert health["slo"]["alertsActive"] == 2
            assert health["slo"]["worstBurn"] > 14.4
        clock[0] += 22000.0
        burst()
        for base in servers.bases:
            d = _get(base, "/debug/slo")
            assert d["alerts"]["active"] == [] and \
                d["alerts"]["cleared"] == 2
    finally:
        for fp in fps:
            fp.disarm_all()


# ------------------------------------------------------------- drain


def test_drain_telemetry_order_once_and_reentrant():
    from pilosa_tpu_torch.cli.main import drain_telemetry
    api = API(Holder(device="cpu"), stats=pstats.MemStatsClient())
    psent.SENTINEL.configure(objectives={"query": "99% < 25ms"},
                             clock=lambda: 1.0)
    api.profiler.record_slow("i", "Count(Row(f=1))", 2.5)
    api.sample_sentinel()
    psent.SENTINEL.note_condition("roofline.drift", True, "synthetic",
                                  now=2.0)

    class Tracer:
        stops = 0

        def stop(self):
            self.stops += 1

    class Log:
        def __init__(self):
            self.lines = []

        def printf(self, fmt, *a):
            self.lines.append(fmt % a if a else fmt)

    api.tracer = Tracer()
    api.logger = log = Log()
    drain_telemetry(api)
    sent_lines = [ln for ln in log.lines if ln.startswith("sentinel:")]
    assert any("1 samples" in ln for ln in sent_lines)
    assert any("alert fire roofline.drift" in ln for ln in sent_lines)
    first_sent = next(i for i, ln in enumerate(log.lines)
                      if ln.startswith("sentinel:"))
    slow = next(i for i, ln in enumerate(log.lines)
                if "Count(Row(f=1))" in ln)
    workload = next(i for i, ln in enumerate(log.lines)
                    if ln.startswith("workload:"))
    assert slow < workload < first_sent
    assert api.tracer.stops == 1
    n = len(log.lines)
    drain_telemetry(api)
    assert len(log.lines) == n and api.tracer.stops == 1


# ------------------------------------------------------------- doctor


def _load_doctor():
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" \
        / "doctor.py"
    spec = importlib.util.spec_from_file_location("_doctor", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_doctor_bundle_diff_and_baseline(servers, tmp_path):
    """The operator's doctor tool reads the port's server as it reads
    the JAX one: every surface answers (``/cluster/health`` too), the
    healthy bundle judges with no failure, and an active alert fails
    it."""
    doctor = _load_doctor()
    for sent, _ in MODS:
        sent.SENTINEL.configure(objectives={"query": "99.9% < 25ms"},
                                clock=lambda: 7000.0)
    for api in servers.apis:
        api.sample_sentinel()
    bundles = [doctor.snapshot_bundle(b) for b in servers.bases]
    errs = [{k for k, s in b["surfaces"].items() if "error" in s}
            for b in bundles]
    # Every surface answers on both, the cluster's (ported) too.
    assert errs[0] == set() and errs[1] == set()
    p1 = tmp_path / "a.json"
    p1.write_text(json.dumps(bundles[1]))
    assert doctor.main(["diff", str(p1), str(p1)]) == 0
    verdicts = doctor.judge_bundle(bundles[1], baseline={"published": {}})
    bad = [(c, s) for c, s, _ in verdicts if s in ("FAIL", "REGRESSED")]
    assert bad == []
    assert ("memory.sentinel-ledgered", "PASS") in \
        [(c, s) for c, s, _ in verdicts]
    psent.SENTINEL.note_condition("hbm.pressure", True, "synthetic",
                                  now=7100.0)
    verdicts = doctor.judge_bundle(doctor.snapshot_bundle(servers.bases[1]))
    assert any(c == "slo.no-active-alerts" and s == "FAIL"
               for c, s, _ in verdicts)


def test_doctor_records_unreachable_surface():
    doctor = _load_doctor()
    bundle = doctor.snapshot_bundle("http://localhost:1")
    assert all("error" in s for s in bundle["surfaces"].values())
    assert any(c == "surface:slo" and s == "FAIL"
               for c, s, _ in doctor.judge_bundle(bundle))


# ------------------------------------------------------------- config


def test_config_slo_and_sentinel_tables(tmp_path, monkeypatch):
    from pilosa_tpu.utils.config import Config as JaxConfig
    from pilosa_tpu.utils.config import load_config as jax_load
    from pilosa_tpu_torch.utils.config import Config, load_config
    cfg_path = tmp_path / "c.toml"
    cfg_path.write_text('[slo]\nquery = "99.9% < 25ms"\n'
                        '"/batch/query" = "99% < 100ms"\n'
                        '[sentinel]\nring = 360\ndecimate = 5\n')

    def keys(c):
        return (c.slo, c.sentinel_ring, c.sentinel_decimate,
                c.sentinel_enabled)

    assert keys(load_config(str(cfg_path))) == \
        keys(jax_load(str(cfg_path))) == (
            {"query": "99.9% < 25ms", "/batch/query": "99% < 100ms"},
            360, 5, True)
    monkeypatch.setenv("PILOSA_TPU_SLO", "query=99% < 50ms")
    assert keys(load_config(str(cfg_path))) == \
        keys(jax_load(str(cfg_path)))
    assert load_config(str(cfg_path)).slo["query"] == "99% < 50ms"
    for cls in (JaxConfig, Config):
        bad = cls()
        bad.slo = {"query": "fast please"}
        with pytest.raises(ValueError, match="objective"):
            bad.validate()
        bad = cls()
        bad.sentinel_ring = 1
        with pytest.raises(ValueError, match="sentinel ring"):
            bad.validate()
