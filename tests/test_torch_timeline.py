"""The port's request-timeline plane (``pilosa_tpu_torch/utils/
timeline.py``) against the JAX package's: the same recorder operations
give the same dispatch-gap summaries, rings and trace-event documents;
the endpoint labels equal the JAX server's; and the live wiring: a port
query records its stage slices, a profiled one its device slice, the
unsampled path fences nothing, ``/debug/timeline`` over HTTP."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.server.http import endpoint_label as jax_endpoint_label
from pilosa_tpu.utils import timeline as jax_timeline
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.server import API, serve
from pilosa_tpu_torch.server.http import endpoint_label
from pilosa_tpu_torch.utils import timeline as port_timeline
from pilosa_tpu_torch.utils.timeline import (
    LANE_DEVICE, LANE_DISPATCH, LANE_NAMES, LANE_PLAN, TIMELINE,
    TimelineRecorder,
)


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


@pytest.fixture(autouse=True)
def _reset_timeline():
    TIMELINE.reset()
    TIMELINE.configure(enabled=True, ring=256, sample_every=1,
                       gap_window_s=60.0)
    yield
    TIMELINE.reset()
    TIMELINE.configure(enabled=True, ring=256, sample_every=1,
                       gap_window_s=60.0)


def _script(mod):
    """One fixed sequence of recorder operations; returns what a reader
    sees, wall-clock stamps left out."""
    rec = mod.TimelineRecorder(ring=3, sample_every=2, gap_window_s=100.0)
    for s, d in ((0.0, 1.0), (2.0, 1.0), (2.5, 2.0), (7.0, 0.5)):
        rec.note_dispatch(s, d)
    handles = [rec.begin(f"{i:032x}", index="i") for i in range(8)]
    for h in handles:
        if h is not None:
            rec.event(h, "plan", mod.LANE_PLAN, h.t0_pc, 0.002, jit="hit")
            for k in range(rec.MAX_EVENTS_PER_REQUEST + 3):
                rec.event(h, "dispatch", mod.LANE_DISPATCH, h.t0_pc, 0.001)
            rec.finish(h, error=ValueError("x") if h.seq == 4 else None)
    rec.note_bandwidth(2.5e9, 0.75)
    doc = rec.snapshot(last=2, node_id="n")
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in doc["traceEvents"]]
    for e in events:
        if e["ph"] == "X" and e["name"] == "request":
            e.pop("dur")
    summary = dict(doc["summary"])
    summary.pop("stageMedianS")
    return {"gap": rec.gap_summary(now_pc=8.0),
            "idle": rec.idle_ratio(now_pc=8.0),
            "skipped": rec.requests_skipped,
            "recorded": rec.requests_recorded,
            "dropped": [h.dropped for h in handles if h is not None],
            "ring": rec.ring_count(), "nbytes": rec.ring_nbytes(),
            "events": events, "summary": summary}


def test_recorder_matches_jax():
    assert _script(port_timeline) == _script(jax_timeline)


PATHS = ["/", "/metrics", "/debug/timeline", "/debug/roofline",
         "/index/taxi/query", "/index/i/field/f/import",
         "/index/i/field/f/import-roaring/7", "/index/i/field/f",
         "/index/i/field", "/index/i", "/cluster/timeline/abc",
         "/internal/nodes", "/internal/nope", "/random/path", "/batch/query"]


@pytest.mark.parametrize("path", PATHS)
def test_endpoint_label_matches_jax(path):
    assert endpoint_label(path) == jax_endpoint_label(path)


def test_idle_ratio_exact_math_and_merge():
    rec = TimelineRecorder(gap_window_s=100.0)
    for s in (0.0, 2.0, 4.0):
        rec.note_dispatch(s, 1.0)
    gap = rec.gap_summary(now_pc=5.0)
    assert gap["busyS"] == pytest.approx(3.0)
    assert gap["idleRatio"] == pytest.approx(0.4)
    assert gap["largestGapS"] == pytest.approx(1.0)
    rec = TimelineRecorder(gap_window_s=100.0)
    rec.note_dispatch(0.0, 2.0)
    rec.note_dispatch(1.0, 2.0)
    rec.note_dispatch(5.0, 1.0)
    assert rec.gap_summary(now_pc=6.0)["busyS"] == pytest.approx(4.0)
    rec = TimelineRecorder(gap_window_s=10.0)
    assert rec.idle_ratio(now_pc=0.0) == 0.0
    rec.note_dispatch(0.0, 0.5)
    assert rec.idle_ratio(now_pc=1.0) == 0.0
    assert rec.gap_summary(now_pc=100.0)["dispatches"] == 0


def test_disabled_recorder_and_serialize_handle():
    rec = TimelineRecorder()
    rec.enabled = False
    rec.note_dispatch(0.0, 1.0)
    assert rec.dispatches_total == 0 and rec.begin("t" * 32) is None
    rec = TimelineRecorder(sample_every=2)
    assert rec.begin("0" * 32) is None
    a = rec.begin("a" * 32)
    rec.finish(a)
    assert rec.begin("b" * 32) is None
    rec.note_serialize(0.0, 1.0)
    assert all(name != "serialize" for name, *_ in a.events)


def test_snapshot_chrome_trace_event_shape():
    rec = TimelineRecorder()
    req = rec.begin("c" * 32, index="i1")
    rec.event(req, "dispatch", LANE_DISPATCH, req.t0_pc + 0.003, 0.004,
              shards=2)
    rec.finish(req)
    evs = rec.snapshot(node_id="node-a")["traceEvents"]
    for ev in evs:
        assert all(k in ev for k in ("name", "ph", "ts", "dur", "pid",
                                     "tid")), ev
    disp = next(e for e in evs if e["name"] == "dispatch")
    assert disp["dur"] == pytest.approx(4000.0)
    assert abs(disp["ts"] / 1e6 - req.t0_wall) < 1.0
    assert {e["args"]["name"] for e in evs
            if e["name"] == "thread_name"} == set(LANE_NAMES.values())


def test_wall_anchor_immune_to_clock_step(monkeypatch):
    rec = TimelineRecorder()
    wall = [time.time()]
    monkeypatch.setattr(time, "time", lambda: wall[0])
    req = rec.begin("d" * 32)
    rec.event(req, "plan", LANE_PLAN, req.t0_pc + 0.010, 0.005)
    wall[0] += 3600.0
    rec.event(req, "dispatch", LANE_DISPATCH, req.t0_pc + 0.020, 0.005)
    rec.finish(req)
    xs = {e["name"]: e for e in rec.snapshot()["traceEvents"]
          if e["ph"] == "X"}
    assert xs["dispatch"]["ts"] - xs["plan"]["ts"] == \
        pytest.approx(10_000, abs=1)
    assert xs["request"]["dur"] < 1e6


# ------------------------------------------------------- live wiring


def _api(**kw):
    from pilosa_tpu_torch.utils.stats import MemStatsClient
    from pilosa_tpu_torch.utils.tracing import RecordingTracer
    api = API(Holder(device="cpu"), stats=MemStatsClient(),
              tracer=RecordingTracer(), **kw)
    idx = api.holder.create_index("tl")
    cols = np.array([1, 2, SHARD_WIDTH + 3], np.uint64)
    idx.create_field("f").import_bits(np.full(3, 1, np.uint64), cols)
    idx.create_field("g").import_bits(np.full(2, 1, np.uint64), cols[:2])
    idx.add_existence(cols)
    return api


def _names(req):
    return [name for name, *_ in req.events]


def test_query_records_stage_slices():
    api = _api()
    assert api.query("tl", "Count(Row(f=1))")["results"] == [3]
    (req,) = TIMELINE.requests()
    names = _names(req)
    for stage in ("plan", "dispatch", "materialize", "request"):
        assert stage in names, names
    assert "device" not in names
    assert TIMELINE.gap_summary()["dispatchesTotal"] >= 1


def test_profiled_query_gains_device_slice():
    api = _api()
    api.query("tl", "Count(Intersect(Row(f=1), Row(g=1)))", profile=True)
    (req,) = TIMELINE.requests()
    dev = [e for e in req.events if e[0] == "device"]
    assert len(dev) == 1 and dev[0][1] == LANE_DEVICE


def test_zero_new_fences_on_unsampled_path(monkeypatch):
    api = _api()
    calls = []
    real = ex_mod._fence_device
    monkeypatch.setattr(ex_mod, "_fence_device",
                        lambda s: calls.append(1) or real(s))
    for _ in range(3):
        api.query("tl", "Count(Row(f=1)) Row(g=1)")
    api.query_batch([{"index": "tl", "query": "Count(Row(f=1))"},
                     {"index": "tl", "query": "Row(g=1)"}])
    assert calls == []
    api.query("tl", "Count(Row(f=1))", profile=True)
    assert len(calls) == 1


def test_timeline_disabled_and_distinct_trace_ids():
    api = _api()
    api.query("tl", "Count(Row(f=1))")
    api.query("tl", "Count(Row(f=1))")
    a, b = TIMELINE.requests()
    assert a.trace_id != b.trace_id
    TIMELINE.configure(enabled=False)
    api.query("tl", "Count(Row(f=1))")
    assert len(TIMELINE.requests()) == 2


def test_debug_timeline_http_surface():
    api = _api()
    srv = serve(api, "localhost", 0, background=True)
    base = f"http://localhost:{srv.server_address[1]}"
    try:
        tid = "ab" * 16
        req = urllib.request.Request(
            base + "/index/tl/query?profile=true",
            data=b"Count(Row(f=1))", method="POST",
            headers={"traceparent": f"00-{tid}-{'cd' * 8}-01"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["results"] == [3]
            assert resp.headers["traceparent"].split("-")[1] == tid
        with urllib.request.urlopen(
                base + f"/debug/timeline?trace={tid}", timeout=30) as resp:
            doc = json.loads(resp.read())
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert {"request", "device", "serialize"} <= {e["name"] for e in xs}
        assert all(e["args"]["trace"] == tid for e in xs)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/debug/timeline?x=1", timeout=30)
        assert err.value.code == 400  # an unknown arg is refused
    finally:
        srv.shutdown()
        srv.server_close()
