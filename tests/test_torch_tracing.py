"""The port's tracing facade (``pilosa_tpu_torch/utils/tracing.py``)
against the JAX package's: the same ``traceparent`` headers parse to the
same trace ids, malformed ones are refused alike, junk ``X-Trace-Id``
values hash to the same id, head sampling decides alike; the OTLP/HTTP
JSON export, the ring, and a live port query's spans reaching a local
exporter."""

import http.server
import json
import threading

import numpy as np
import pytest

from pilosa_tpu.utils import tracing as jax_tracing
from pilosa_tpu_torch.utils import tracing as port_tracing
from pilosa_tpu_torch.utils.memledger import MemoryLedger
from pilosa_tpu_torch.utils.tracing import (
    ExportingTracer, NopTracer, RecordingTracer, format_traceparent,
    parse_traceparent, spans_to_otlp,
)

HEADERS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "cd" * 8 + "-00",
    " 00-" + "12" * 16 + "-" + "34" * 8 + "-01 ",
    "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",
    "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-1",
    "garbage", "", "0-1-2-3",
]


@pytest.mark.parametrize("i", range(len(HEADERS)))
def test_parse_traceparent_matches_jax(i):
    h = HEADERS[i]
    assert parse_traceparent(h) == jax_tracing.parse_traceparent(h)


def test_format_and_sanitize_match_jax():
    for tid, sid in (("ab" * 16, "cd" * 8), ("abc", "d"),
                     ("ef" * 20, "12" * 10)):
        assert format_traceparent(tid, sid) == \
            jax_tracing.format_traceparent(tid, sid)
    for raw in ("req-abc!!", "AB" * 16, "ab" * 16, "x"):
        assert port_tracing._sanitize_trace_id(raw) == \
            jax_tracing._sanitize_trace_id(raw)


def test_extract_prefers_traceparent_then_legacy_like_jax():
    cases = [{"traceparent": HEADERS[0], "X-Trace-Id": "ef" * 16},
             {"traceparent": "garbage", "X-Trace-Id": "ef" * 16},
             {"X-Trace-Id": "req-abc!!"}, {}]
    for headers in cases:
        p, j = RecordingTracer(), jax_tracing.RecordingTracer()
        p.extract(headers)
        j.extract(headers)
        assert p.current_trace_id() == j.current_trace_id()


def test_probabilistic_sampler_decides_like_jax():
    p = ExportingTracer("http://127.0.0.1:9/x", sampler_type="probabilistic",
                        sampler_param=0.3)
    j = jax_tracing.ExportingTracer("http://127.0.0.1:9/x",
                                    sampler_type="probabilistic",
                                    sampler_param=0.3)
    for k in range(64):
        tid = f"{k:032x}"
        ps = port_tracing.Span("s", tid, {})
        js = jax_tracing.Span("s", tid, {})
        assert p._sampled(ps) == j._sampled(js)


class _Capture(http.server.BaseHTTPRequestHandler):
    captured = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).captured.append(
            (self.path, dict(self.headers), json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture
def capture_server():
    _Capture.captured = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/v1/traces", \
        _Capture.captured
    srv.shutdown()
    srv.server_close()


def _spans(captured):
    return [s for _, _, doc in captured
            for s in doc["resourceSpans"][0]["scopeSpans"][0]["spans"]]


def test_spans_to_otlp_wire_shape():
    tr = RecordingTracer()
    with tr.span("API.Query", index="i") as root:
        with tr.span("executor.Execute"):
            pass
    doc = spans_to_otlp(tr.finished, "svc")
    (rs,) = doc["resourceSpans"]
    assert rs["resource"]["attributes"] == [
        {"key": "service.name", "value": {"stringValue": "svc"}}]
    parent, child = rs["scopeSpans"][0]["spans"]
    assert (parent["name"], child["name"]) == ("API.Query",
                                               "executor.Execute")
    assert len(parent["traceId"]) == 32 and len(parent["spanId"]) == 16
    assert child["parentSpanId"] == parent["spanId"] == root.span_id
    assert child["traceId"] == parent["traceId"]
    assert "parentSpanId" not in parent
    for s in (parent, child):
        assert int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
    assert parent["attributes"] == [{"key": "index",
                                     "value": {"stringValue": "i"}}]


def test_exporting_tracer_batches_and_failed_spans(capture_server):
    endpoint, captured = capture_server
    tr = ExportingTracer(endpoint, service_name="t", batch_size=8,
                         flush_interval=3600)
    with tr.span("a"):
        pass
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("query failed")
    assert not captured
    tr.flush()
    path, headers, _ = captured[0]
    assert path == "/v1/traces"
    assert headers["Content-Type"] == "application/json"
    assert [s["name"] for s in _spans(captured)] == ["a", "boom"]
    assert ExportingTracer("http://127.0.0.1:9/v1/traces").flush() is True


def test_sampler_const_zero_and_unknown_type(capture_server):
    endpoint, captured = capture_server
    tr = ExportingTracer(endpoint, sampler_type="const", sampler_param=0,
                         batch_size=1, flush_interval=3600)
    with tr.span("dropped"):
        pass
    tr.flush()
    assert not captured
    assert len(tr.finished) == 1  # still recorded in process
    with pytest.raises(ValueError):
        ExportingTracer(endpoint, sampler_type="nope")


def test_inject_adopt_and_stale_ids():
    tr = RecordingTracer()
    headers = {}
    with tr.span("root") as root:
        with tr.span("child") as child:
            tr.inject(headers)
    assert headers["traceparent"] == format_traceparent(root.trace_id,
                                                        child.span_id)
    assert headers["X-Trace-Id"] == root.trace_id
    headers = {}
    tr.inject(headers)
    assert "traceparent" not in headers
    tr.adopt("cd" * 16)
    tr.inject(headers)
    assert parse_traceparent(headers["traceparent"]) == "cd" * 16
    tr.extract({})
    assert tr.current_trace_id() is None
    tid = tr.ensure_trace_id()
    assert len(tid) == 32 and tr.current_trace_id() == tid


def test_ring_bound_ledger_and_dump():
    """The ring keeps the newest roots within its byte budget, evicting
    the oldest first, and counts what it let go."""
    one = port_tracing.Span("s0", "ab" * 16, {}).nbytes()
    tr = RecordingTracer(ring_bytes=3 * one)
    for k in range(5):
        with tr.span(f"s{k}"):
            pass
    assert [s.name for s in tr.finished] == ["s2", "s3", "s4"]
    assert (tr.roots_closed, tr.roots_evicted) == (5, 2)
    assert tr.ring_nbytes() == sum(s.nbytes() for s in tr.finished)
    ledger = MemoryLedger()
    tr.register_memory(ledger)
    assert ledger.totals()["telemetry"]["bytes"] == tr.ring_nbytes()

    class Log:
        lines = []

        def printf(self, fmt, *a):
            self.lines.append(fmt % a)

    assert tr.dump(Log(), last=2) == 2 and len(Log.lines) == 3
    with tr.span("big", pad="x" * (4 * one)):
        pass
    assert [s.name for s in tr.finished] == ["big"]  # the newest stays
    assert tr.ring_nbytes() == tr.finished[0].nbytes()
    nop = NopTracer()
    with nop.span("x") as s:
        assert s is None


def test_live_query_spans_reach_exporter(capture_server):
    """A port API query's spans land in the OTLP payload."""
    from pilosa_tpu_torch import Holder
    from pilosa_tpu_torch.server.api import API

    endpoint, captured = capture_server
    tr = ExportingTracer(endpoint, batch_size=1, flush_interval=3600)
    api = API(Holder(device="cpu"), tracer=tr)
    api.create_index("ti")
    api.create_field("ti", "f")
    api.import_bits("ti", "f", rows=np.array([1, 1], np.uint64),
                    columns=np.array([3, 9], np.uint64))
    assert api.query("ti", "Count(Row(f=1))")["results"] == [2]
    tr.flush()
    by_name = {s["name"]: s for s in _spans(captured)}
    attrs = {a["key"]: a["value"]["stringValue"]
             for a in by_name["API.Query"]["attributes"]}
    assert attrs["index"] == "ti"
    assert "profile.planS" in attrs
