"""The port's spans: the tree of a TopN served over HTTP (the handler's
root, the request's queue wait, the dispatcher's flush root and the
executor's layers beneath it), the queue wait of lone and batched
flushes, an import's spans reaching the server's tracer, the spans as
``record_function`` ranges of a running ``torch.profiler`` (and no
range at all without one), and the byte-bounded ring under threads."""

import http.client
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu_torch import FieldOptions, Holder
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.memledger import MemoryLedger
from pilosa_tpu_torch.utils.stats import MemStatsClient
from pilosa_tpu_torch.utils.tracing import RecordingTracer

MOLECULES, BITS, DRAWS = 2000, 4096, 48
TOPN = "TopN(fp, Row(fp={q}), n=5, tanimotoThreshold=30)"


def fingerprint_holder() -> Holder:
    """A small fingerprint index on the CPU: one row a molecule, DRAWS
    random bits of BITS each, one shard."""
    rng = np.random.default_rng(7)
    holder = Holder(device="cpu")
    idx = holder.create_index("mole", track_existence=False)
    field = idx.create_field("fp", FieldOptions(max_columns=BITS))
    rows = np.repeat(np.arange(MOLECULES, dtype=np.uint64), DRAWS)
    cols = rng.integers(0, BITS, MOLECULES * DRAWS).astype(np.uint64)
    field.import_bits(rows, cols)
    return holder


def walk(span, depth=0):
    yield span, depth
    for c in span.children:
        yield from walk(c, depth + 1)


def named(root, name):
    return [s for s, _ in walk(root) if s.name == name]


def child_names(span):
    return [c.name for c in span.children]


def wait_for(pred, timeout=10.0):
    """The roots close after the response's last byte: poll for them."""
    t = time.monotonic() + timeout
    while time.monotonic() < t:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError("spans never arrived")


class Served:
    """The port's server as ``cli server`` builds it over ``holder``."""

    def __init__(self, holder):
        from pilosa_tpu_torch.cli.main import build_server
        from pilosa_tpu_torch.utils.config import load_config
        cfg = load_config(None, {"bind": "127.0.0.1:0"}, environ={})
        self.api, self.http, self.watchdog = build_server(cfg, holder)
        self.thread = threading.Thread(target=self.http.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.http.server_address[1]

    def query(self, pql):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        try:
            conn.request("POST", "/index/mole/query", body=pql.encode())
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200, body
            return resp.getheader("traceparent")
        finally:
            conn.close()

    def stop(self):
        from pilosa_tpu_torch.cli.main import stop_server
        self.http.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        stop_server(self.api, self.http, self.watchdog)


@pytest.fixture
def positions_bank(monkeypatch):
    """TopN over the positions bank, as at 10M molecules on the card."""
    monkeypatch.setattr(ex_mod, "TOPN_MAX_BANK_BYTES", 0)


def request_trees(tracer, trace_id):
    def find():
        roots = [r for r in tracer.finished if r.trace_id == trace_id]
        names = {r.name for r in roots}
        if {"HTTP.request", "Coalescer.flush"} <= names:
            return {r.name: r for r in roots}
        return None
    return wait_for(find)


def test_topn_over_http_gives_the_span_tree(positions_bank):
    server = Served(fingerprint_holder())
    try:
        tracer = server.api.tracer
        trees = []
        for q in (3, 11):
            header = server.query(TOPN.format(q=q))
            trees.append(request_trees(tracer,
                                       tracing.parse_traceparent(header)))
    finally:
        server.stop()
    for i, roots in enumerate(trees):
        req, flush = roots["HTTP.request"], roots["Coalescer.flush"]
        assert req.attrs["endpoint"] == "/index/{index}/query"
        (api_span,) = [c for c in req.children
                       if c.name == "API.QueryCoalesced"]
        (queue,) = named(api_span, "Coalescer.queue")
        assert queue.attrs["batch"] == 1
        assert api_span.start <= queue.start <= queue.end <= api_span.end
        assert {"HTTP.encode", "API.observe"} <= set(child_names(req))
        assert flush.attrs["n"] == 1
        assert {"PQL.parse", "Executor.shape"} <= set(child_names(flush))
        (call,) = [s for s in named(flush, "Executor.call")
                   if s.attrs["call"] == "TopN"]
        assert {"Executor.rows", "Workload.record", "Executor.eval",
                "Executor.fetch", "Executor.launch"} <= \
            set(child_names(call))
        (rows,) = named(call, "Executor.rows")
        assert rows.attrs["rows"] == MOLECULES
        builds = named(flush, "Bank.build")
        if i == 0:
            kinds = {b.attrs["kind"] for b in builds}
            assert "positions_bank" in kinds
            (pb,) = [b for b in builds if b.attrs["kind"] == "positions_bank"]
            assert pb.attrs["rows"] == MOLECULES and pb.attrs["bytes"] > 0
            assert pb.attrs["patched"] is False
            assert {"Fragment.rowsPositions", "Bank.upload"} <= \
                set(child_names(pb))
        else:
            assert builds == []  # the banks are cached
        # Every span lies inside its parent, on one wall clock.
        for root in (req, flush):
            for s, _ in walk(root):
                for c in s.children:
                    assert s.start - 1e-6 <= c.start <= c.end <= \
                        s.end + 1e-6, (s.name, c.name)


def _coalescer(holder, tracer, stats, window_s):
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    coal = QueryCoalescer(Executor(holder, device="cpu"), window_s=window_s,
                          stats=stats, tracer=tracer, pipeline=False)
    coal.start()
    return coal


def _submit_under_span(coal, tracer, pql, out):
    with tracer.span("request") as root:
        out.append((root, coal.submit("mole", pql)))


@pytest.mark.parametrize("n", [1, 4])
def test_lone_and_batched_flushes_record_the_queue_wait(n):
    holder = fingerprint_holder()
    tracer, stats = RecordingTracer(), MemStatsClient()
    coal = _coalescer(holder, tracer, stats, window_s=0.0 if n == 1
                      else 0.5)
    out = []
    try:
        threads = [threading.Thread(target=_submit_under_span, args=(
            coal, tracer, f"Count(Row(fp={q}))", out)) for q in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        coal.stop()
    assert len(out) == n
    waits = []
    for root, resp in out:
        assert "results" in resp
        (queue,) = named(root, "Coalescer.queue")
        assert queue.attrs["batch"] == n
        assert root.start <= queue.start <= queue.end <= root.end
        waits.append(queue.pc_end - queue.pc_start)
    # One wait feeds the span and the stats timing.
    assert sorted(stats.timings["coalescer.queue_wait"]) == sorted(waits)
    flushes = [r for r in tracer.finished if r.name == "Coalescer.flush"]
    assert sum(f.attrs["n"] for f in flushes) == n
    if n == 1:
        assert flushes[0].trace_id == out[0][0].trace_id
    else:
        (flush,) = flushes
        assert set(flush.attrs["traces"].split(",")) == \
            {root.trace_id for root, _ in out}


def test_import_before_the_server_lands_in_its_tracer():
    holder = fingerprint_holder()
    server = Served(holder)
    try:
        assert server.api.tracer is holder.tracer
        (imp,) = [r for r in server.api.tracer.finished
                  if r.name == "Field.import"]
    finally:
        server.stop()
    assert imp.attrs["pairs"] == MOLECULES * DRAWS
    (frag,) = named(imp, "Fragment.import")
    assert {"Bitmap.importBatch", "Fragment.touchRows",
            "Fragment.cacheUpdate"} <= set(child_names(frag))


def test_a_tracer_given_to_the_holder_is_the_nodes():
    """A holder's tracer reaches its fields, and the API adopts it."""
    from pilosa_tpu_torch.server.api import API
    tracer = RecordingTracer()
    holder = Holder(device="cpu", tracer=tracer)
    field = holder.create_index("mole", track_existence=False) \
        .create_field("fp")
    field.import_bits(np.array([1], np.uint64), np.array([5], np.uint64))
    assert [r.name for r in tracer.finished] == ["Field.import"]
    api = API(holder)
    assert api.tracer is tracer
    assert api.query("mole", "Count(Row(fp=1))")["results"][0] == 1
    assert [r.name for r in tracer.finished][-1] == "API.Query"


def _annotations(prof):
    return [(e.name(), e.start_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("API.", "Executor.", "PQL.",
                                    "Workload.", "Bank.", "Fragment."))]


def test_spans_are_profiler_ranges_on_the_same_clock(positions_bank):
    from torch.profiler import ProfilerActivity, profile
    from pilosa_tpu_torch.server.api import API
    api = API(fingerprint_holder())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.query("mole", TOPN.format(q=5))
    (root,) = [r for r in api.tracer.finished if r.name == "API.Query"]
    spans = [s for s, _ in walk(root)]
    assert {"Executor.call", "Executor.launch", "Bank.build"} <= \
        {s.name for s in spans}
    notes = _annotations(prof)
    for s in spans:
        near = [abs(t - s.start * 1e9) for name, t in notes
                if name == s.name]
        assert near and min(near) < 1e6, s.name


def test_no_profiler_enters_no_range(monkeypatch, positions_bank):
    from pilosa_tpu_torch.server.api import API

    def refuse(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    api = API(fingerprint_holder())
    assert api.query("mole", TOPN.format(q=5))["results"]
    assert any(r.name == "API.Query" for r in api.tracer.finished)


def test_tree_bytes_follow_the_spans_and_their_annotations():
    """The ring sizes a root by the bytes its tree kept as it grew,
    which equal a walk of the finished tree."""
    tr = RecordingTracer()
    with tr.span("root", a=1) as root:
        with tracing.span("child", rows=5) as child:
            child.set("rows", 10_000_000)
            child.set("bytes", 7)
        t = time.perf_counter()
        root.add_closed("queue", t, t, batch=3)
        root.set("a", "a longer value")
    assert root.tree[0] == root.nbytes() == tr.ring_nbytes()
    assert child.tree is root.tree


def test_ring_stays_within_bytes_and_matches_the_ledger_under_threads():
    """16 threads close roots into one ring of a few roots' bytes."""
    probe = RecordingTracer()
    with probe.span("t"):
        with probe.span("c", k=0):
            pass
    tr = RecordingTracer(ring_bytes=8 * probe.finished[0].nbytes())
    threads_n, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for k in range(per):
                with tr.span("t"):
                    with tr.span("c", k=k % 10):
                        pass
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert tr.roots_closed == threads_n * per
    assert tr.roots_closed - tr.roots_evicted == len(tr.finished) <= 8
    assert tr.ring_nbytes() == sum(s.nbytes() for s in tr.finished) \
        <= tr.ring_bytes
    ledger = MemoryLedger()
    tr.register_memory(ledger)
    assert ledger.totals()["telemetry"]["bytes"] == tr.ring_nbytes()
    assert tracing.current() is None
