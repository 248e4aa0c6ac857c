"""The port's query coalescer (``pilosa_tpu_torch/server/coalescer.py``):
the cases of ``tests/test_coalescer.py`` with a stub executor whose
answers name their request, plus one burst through the real port
executor with the megakernel on, and the API's direct-path fallback."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.server import API, serve
from pilosa_tpu_torch.server.coalescer import CoalescerOverload, \
    CoalescerStopped, DeadlineExceeded, QueryCoalescer


def call(base, method, path, body):
    """(status, content type, body bytes); 4xx/5xx captured."""
    r = urllib.request.Request(base + path, data=body.encode(),
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def answer(index, query):
    return {"results": [f"{index}:{query}"]}


class StubExecutor:
    """Answers ``{"results": ["index:query"]}``; a query starting with
    ``Row(bad`` fails with ValueError. Records every request it runs.
    ``gate`` (when set) blocks every run until released."""

    def __init__(self):
        self.ran = []
        self.batches = []
        self.lock = threading.Lock()
        self.gate = None
        self.started = threading.Event()

    def _run(self, index, query):
        with self.lock:
            self.ran.append(query)
        if query.startswith("Row(bad"):
            return ValueError(f"bad query {query}")
        return answer(index, query)

    def _wait_gate(self):
        self.started.set()
        if self.gate is not None:
            assert self.gate.wait(30), "gate never released"

    def execute_full(self, index, query, shards=None):
        self._wait_gate()
        res = self._run(index, query)
        if isinstance(res, Exception):
            raise res
        return res

    def execute_batch_begin(self, reqs):
        self._wait_gate()
        with self.lock:
            self.batches.append([q for _, q, _ in reqs])
        return [self._run(i, q) for i, q, _ in reqs]

    def execute_batch_shaped_finish(self, flight):
        return list(flight)

    def execute_batch_shaped(self, reqs):
        return self.execute_batch_shaped_finish(
            self.execute_batch_begin(reqs))


def burst(co, queries, timeout=60):
    """Submit every query from its own thread, released together:
    ({i: result}, {i: exception})."""
    results, errors = {}, {}
    barrier = threading.Barrier(len(queries))

    def worker(i, q):
        try:
            barrier.wait(timeout=30)
            results[i] = co.submit("c", q)
        except Exception as e:  # noqa: BLE001 — the subject under test
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i, q))
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a submitter wedged"
    return results, errors


QUERIES = [f"Count(Row(f={r}))" for r in range(12)]


@pytest.fixture
def stub():
    ex = StubExecutor()
    co = QueryCoalescer(ex, window_s=0.05, max_batch=8)
    co.start()
    yield ex, co
    if ex.gate is not None:
        ex.gate.set()
    co.stop()


@pytest.mark.parametrize("max_batch", [5, 64])
def test_concurrent_requests_share_batches(max_batch):
    ex = StubExecutor()
    co = QueryCoalescer(ex, window_s=0.05, max_batch=max_batch)
    co.start()
    try:
        results, errors = burst(co, QUERIES)
        assert not errors, errors
        assert results == {i: answer("c", q) for i, q in enumerate(QUERIES)}
        assert co.counters.get("batches", 0) >= 1
        assert max(len(b) for b in ex.batches) > 1
        assert all(len(b) <= max_batch for b in ex.batches)
        assert co.counters["pipelined"] == len(ex.batches)
    finally:
        co.stop()


def test_error_isolation_across_batchmates(stub):
    ex, co = stub
    queries = [f"Row(bad{i})" if i % 2 else f"Row(f={i})"
               for i in range(10)]
    results, errors = burst(co, queries)
    assert sorted(errors) == [i for i in range(10) if i % 2]
    for i, e in errors.items():
        assert isinstance(e, ValueError) and f"Row(bad{i})" in str(e)
    assert results == {i: answer("c", queries[i]) for i in results}


def test_identical_reads_run_once(stub):
    ex, co = stub
    co.window_s = 0.25  # one window holds the whole burst
    results, errors = burst(co, ["Count(Row(f=5))"] * 12)
    assert not errors
    assert all(r == answer("c", "Count(Row(f=5))") for r in results.values())
    assert ex.ran.count("Count(Row(f=5))") < 12
    assert co.counters.get("deduped", 0) > 0


def test_writes_flush_at_once_and_never_dedup(stub):
    """Three identical reads wait in a long window; a write ends it at
    once, and in a batch with a write nothing is deduped."""
    ex, co = stub
    co.window_s = 5.0
    got = []
    readers = [threading.Thread(target=lambda: got.append(
        co.submit("c", "Count(Row(f=1))"))) for _ in range(3)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + 5
    while co.queue_depth() < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    t0 = time.monotonic()
    assert co.submit("c", "Set(1, f=1)") == answer("c", "Set(1, f=1)")
    assert time.monotonic() - t0 < 2.5
    for t in readers:
        t.join(10)
    assert got == [answer("c", "Count(Row(f=1))")] * 3
    assert co.counters.get("flush.write", 0) >= 1
    assert ex.ran.count("Count(Row(f=1))") == 3


def test_overload_429_and_deadline_408():
    """A gated executor pins the dispatcher: the queue fills, the next
    submit answers 429 with Retry-After, and the queued requests pass
    their deadline and answer 408 without running."""
    ex = StubExecutor()
    ex.gate = threading.Event()
    api = API(Holder(device="cpu"))
    api.coalescer = QueryCoalescer(ex, window_s=0.0005, max_batch=8,
                                   max_queue=2, deadline_s=0.5)
    api.coalescer.start()
    srv = serve(api, "localhost", 0, background=True)
    base = f"http://localhost:{srv.server_address[1]}"
    results = {}

    def bg(name):
        t = threading.Thread(target=lambda: results.__setitem__(
            name, call(base, "POST", "/index/c/query", "Count(Row(f=1))")))
        t.start()
        return t

    try:
        t1 = bg("inflight")
        assert ex.started.wait(10)
        t2, t3 = bg("q1"), bg("q2")
        deadline = time.monotonic() + 5
        while api.coalescer.queue_depth() < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        r = api.coalescer
        with pytest.raises(CoalescerOverload) as e:
            r.submit("c", "Count(Row(f=1))")
        assert e.value.status == 429 and "Retry-After" in e.value.headers
        st, _, raw = call(base, "POST", "/index/c/query", "Count(Row(f=1))")
        assert st == 429 and b"capacity" in raw
        t2.join(10)
        t3.join(10)
        assert results["q1"][0] == 408 and results["q2"][0] == 408
        assert r.counters["deadline_ejected"] >= 2
        assert r.counters["rejected"] >= 2
        ex.gate.set()
        t1.join(10)
        assert results["inflight"][0] == 200
        assert json.loads(results["inflight"][2]) == \
            answer("c", "Count(Row(f=1))")
        assert ex.ran == ["Count(Row(f=1))"]
    finally:
        ex.gate.set()
        srv.shutdown()
        srv.server_close()
        api.coalescer.stop()


def test_deadline_ejects_a_queued_item_directly():
    ex = StubExecutor()
    ex.gate = threading.Event()
    co = QueryCoalescer(ex, window_s=0.0005, deadline_s=0.1)
    co.start()
    try:
        t = threading.Thread(target=lambda: co.submit("c", "Row(f=1)"))
        t.start()
        assert ex.started.wait(10)
        with pytest.raises(DeadlineExceeded) as e:
            co.submit("c", "Row(f=2)")
        assert e.value.status == 408
    finally:
        ex.gate.set()
        t.join(10)
        co.stop()
    assert "Row(f=2)" not in ex.ran


def test_stop_drains_admitted_requests_then_degrades():
    ex = StubExecutor()
    ex.gate = threading.Event()
    co = QueryCoalescer(ex, window_s=0.0005)
    co.start()
    got = {}
    threads = [threading.Thread(target=lambda q=q: got.__setitem__(
        q, co.submit("c", q))) for q in QUERIES[:4]]
    threads[0].start()
    assert ex.started.wait(10)
    for t in threads[1:]:
        t.start()
    while co.queue_depth() < 3:
        time.sleep(0.005)
    stopper = threading.Thread(target=co.stop)
    stopper.start()
    time.sleep(0.05)
    ex.gate.set()
    stopper.join(30)
    for t in threads:
        t.join(10)
    assert not stopper.is_alive()
    assert got == {q: answer("c", q) for q in QUERIES[:4]}
    assert not co.running
    with pytest.raises(CoalescerStopped):
        co.submit("c", "Row(f=1)")


def test_finalizer_exception_propagates_and_recovers(stub):
    ex, co = stub
    orig = ex.execute_batch_shaped_finish
    state = {"boom": True}

    def failing_finish(flight):
        if state["boom"]:
            state["boom"] = False
            raise RuntimeError("injected drain failure")
        return orig(flight)

    ex.execute_batch_shaped_finish = failing_finish
    results, errors = burst(co, QUERIES)
    assert errors and all("injected drain failure" in str(e)
                          for e in errors.values())
    assert all(r == answer("c", QUERIES[i]) for i, r in results.items())
    with co._pl_cond:
        assert co._pl_pending is None
    results, errors = burst(co, QUERIES)
    assert not errors
    assert results == {i: answer("c", q) for i, q in enumerate(QUERIES)}
    assert co.counters["pipelined"] >= 2


def test_drain_failure_respects_batch_boundaries():
    """Batch K's drain fails while batch K+1 has already begun: the
    error stays on K's requests, K+1 answers."""
    ex = StubExecutor()
    second_begin = threading.Event()
    flights = []
    orig_begin, orig_finish = ex.execute_batch_begin, \
        ex.execute_batch_shaped_finish

    def tagged_begin(reqs):
        flight = orig_begin(reqs)
        flights.append(flight)
        if len(flights) == 2:
            second_begin.set()
        return flight

    def gated_finish(flight):
        if flight is flights[0]:
            second_begin.wait(30)
            raise RuntimeError("injected drain failure")
        return orig_finish(flight)

    ex.execute_batch_begin = tagged_begin
    ex.execute_batch_shaped_finish = gated_finish
    co = QueryCoalescer(ex, window_s=0.05, max_batch=4)
    co.start()
    try:
        results, errors = burst(co, QUERIES)
        assert second_begin.is_set()
        assert errors and all("injected drain failure" in str(e)
                              for e in errors.values())
        assert len(errors) <= 4
        assert all(r == answer("c", QUERIES[i])
                   for i, r in results.items())
    finally:
        co.stop()


# The injected exit ends the finalizer thread, which pytest reports.
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_finalizer_interrupt_strands_nobody(stub):
    """A non-Exception out of the drain ends the finalizer, resolves its
    batch with CoalescerStopped, and later batches run serially."""
    ex, co = stub
    orig = ex.execute_batch_shaped_finish
    state = {"boom": True}

    def failing_finish(flight):
        if state["boom"]:
            state["boom"] = False
            raise SystemExit("injected exit")
        return orig(flight)

    ex.execute_batch_shaped_finish = failing_finish
    results, errors = burst(co, QUERIES)
    assert errors and all(isinstance(e, CoalescerStopped)
                          for e in errors.values())
    results, errors = burst(co, QUERIES[:6])
    assert not errors
    assert results == {i: answer("c", q) for i, q in enumerate(QUERIES[:6])}


def test_api_reruns_only_after_coalescer_stopped():
    """The API answers on the direct path when the coalescer stopped
    under a request, and passes any other error to the client."""
    api = API(Holder(device="cpu"))
    api.create_index("c")
    api.create_field("c", "f")
    api.import_bits("c", "f", rows=[1, 1], columns=[3, 9])

    class Failing:
        running = True

        def __init__(self, exc):
            self.exc = exc

        def submit(self, index, query, shards=None):
            raise self.exc

    api.coalescer = Failing(CoalescerStopped("stopped under the request"))
    assert api.query_coalesced("c", "Count(Row(f=1))") == {"results": [2]}
    api.coalescer = Failing(RuntimeError("device failure"))
    with pytest.raises(RuntimeError, match="device failure"):
        api.query_coalesced("c", "Count(Row(f=1))")


def test_burst_through_the_port_executor_takes_the_megakernel(monkeypatch):
    """Concurrent reads through a real port executor (CPU, megakernel
    forced on) answer as the direct path does, in megakernel launches
    with no fallback."""
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    h = Holder(device="cpu")
    idx = h.create_index("c")
    rng = np.random.default_rng(9)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 5000).astype(np.uint64)
    idx.create_field("f").import_bits(
        rng.integers(0, 6, 5000).astype(np.uint64), cols)
    idx.add_existence(cols)
    api = API(h)
    ex = api.executor
    queries = [f"Count(Intersect(Row(f={r}), Row(f={(r + 1) % 6})))"
               for r in range(6)] + [f"Row(f={r})" for r in range(6)] \
        + [f"Count(Not(Row(f={r})))" for r in range(6)]
    want = {q: ex.execute_full("c", q) for q in queries}
    co = QueryCoalescer(ex, window_s=0.05, max_batch=64)
    co.start()
    try:
        before = (ex.mega_launches, ex.mega_fallbacks)
        results, errors = burst(co, queries)
    finally:
        co.stop()
    assert not errors, errors
    assert {queries[i]: r for i, r in results.items()} == want
    assert ex.mega_launches > before[0] and ex.mega_fallbacks == before[1]
    assert co.counters["batches"] >= 1
