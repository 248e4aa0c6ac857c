"""The readers of the port's spans on hand-made spans and device
intervals, their refusal to read a window their ring no longer reaches,
and a traced run on the CPU that reports them."""

import types

import pytest

from portbench import harness, spans

T0 = 1_700_000_000.0  # the window's open, Unix seconds
US = 1e-3  # a microsecond in ms: what a Unix time in a double resolves


class S:
    """A finished span as the port's tracer keeps it."""

    def __init__(self, name, start, end, *children, **attrs):
        self.name, self.start, self.end = name, T0 + start, T0 + end
        self.children = list(children)
        self.attrs = attrs


def marks(before, during, evicted_open=0, evicted_close=0, seconds=10.0):
    """(open mark, close mark) of a ring that held ``before`` at the open
    and ``during`` closed after it."""
    closed0 = evicted_open + len(before)
    ring = (before + during)[evicted_close - evicted_open:]
    return ((T0, closed0, evicted_open, before),
            (T0 + seconds, closed0 + len(during), evicted_close, ring))


def reader(name):
    return harness.metric_reader(name)


def ctx_of(name, snap, **kw):
    return types.SimpleNamespace(snaps={name: snap}, **kw)


def request(start, wait):
    """An HTTP request root whose queue wait is ``wait`` seconds."""
    q = S("Coalescer.queue", start + 0.001, start + 0.001 + wait)
    return S("HTTP.request", start, start + 0.2,
             S("API.QueryCoalesced", start + 0.0005, start + 0.15, q))


def test_queue_wait_is_the_median_over_requests_started_in_the_window():
    snap = marks([request(-1.0, 0.5)],
                 [request(-0.05, 0.009), request(1.0, 0.002),
                  request(2.0, 0.004), request(3.0, 0.008)])
    # The request started before the open is not the window's.
    assert reader("queue_wait_ms").read(ctx_of("queue_wait_ms", snap)) == \
        pytest.approx(4.0, abs=US)


def test_call_ms_takes_the_outermost_calls_closed_in_the_window():
    inner = S("Executor.call", 1.002, 1.004)
    flushes = [
        S("Coalescer.flush", 1.0, 1.02, S("Executor.call", 1.0, 1.01,
                                          inner)),
        S("Coalescer.flush", 2.0, 2.05, S("Executor.call", 2.0, 2.03)),
        S("Coalescer.flush", 9.99, 10.5, S("Executor.call", 9.99, 10.4)),
    ]
    snap = marks([S("Coalescer.flush", -2, -1, S("Executor.call", -2, -1))],
                 flushes)
    assert reader("call_ms").read(ctx_of("call_ms", snap)) == \
        pytest.approx(20.0, abs=US)


def test_idle_host_busy_share_joins_spans_and_device_on_the_wall_clock():
    # Traced part: [0, 1) s. Executor spans cover [0.1, 0.4) (a flush),
    # [0.35, 0.5) (a direct-path API.Query under its HTTP root) and
    # [0.8, 1.2) (a drain, clipped at 1). The device runs [0.2, 0.3) and
    # [0.45, 0.9). Idle while the host runs the executor: [0.1, 0.2),
    # [0.3, 0.45) and [0.9, 1.0): 0.35 s of 1 s.
    during = [S("Coalescer.flush", 0.1, 0.4),
              S("HTTP.request", 0.3, 0.6, S("API.Query", 0.35, 0.5)),
              S("Coalescer.finish", 0.8, 1.2),
              S("Coalescer.queue", 0.0, 1.0)]  # not an executor span
    lo, hi = int(T0 * 1e9), int((T0 + 1.0) * 1e9)

    def dev(a, b):
        return ("k", lo + int(a * 1e9), lo + int(b * 1e9))
    events = types.SimpleNamespace(device=[dev(0.2, 0.3), dev(0.45, 0.9)])
    ctx = ctx_of("idle_host_busy_share", marks([], during), events=events,
                 window_ns=(lo, hi))
    assert reader("idle_host_busy_share").read(ctx) == pytest.approx(
        35.0, abs=1e-3)
    ctx.events = None
    assert reader("idle_host_busy_share").read(ctx) is None


def test_setup_metrics_sum_the_spans_closed_before_the_open():
    before = [
        S("Field.import", -50, -40,
          S("Fragment.import", -50, -40,
            S("Bitmap.importBatch", -50, -47), S("Bitmap.importBatch",
                                                 -46, -44.5),
            S("Fragment.touchRows", -44, -43))),
        S("Coalescer.flush", -30, -1,
          S("Executor.call", -30, -1,
            S("Bank.build", -30, -5, S("Bank.upload", -20, -10)),
            S("Bank.build", -4, -3.5))),
    ]
    during = [S("Coalescer.flush", 1, 2, S("Bank.build", 1, 2))]
    snap = marks(before, during)
    assert reader("bank_build_s").read(ctx_of("bank_build_s", snap)) == \
        pytest.approx(25.5)
    assert reader("import_native_s").read(
        ctx_of("import_native_s", snap)) == pytest.approx(4.5)


@pytest.mark.parametrize("name", ["queue_wait_ms", "call_ms",
                                  "idle_host_busy_share"])
def test_none_when_the_ring_no_longer_reaches_the_open(name):
    during = [request(1.0, 0.002),
              S("Coalescer.flush", 1.0, 1.1, S("Executor.call", 1.0, 1.1))]
    lo = int(T0 * 1e9)
    kw = dict(events=types.SimpleNamespace(device=[("k", lo, lo + 10)]),
              window_ns=(lo, lo + 2 * 10**9))
    whole = marks([S("x", -1, -0.5)], during)
    assert reader(name).read(ctx_of(name, whole, **kw)) is not None
    # One root closed after the open is gone by the close.
    cut = marks([S("x", -1, -0.5)], during, evicted_close=2)
    assert reader(name).read(ctx_of(name, cut, **kw)) is None


@pytest.mark.parametrize("name", ["bank_build_s", "import_native_s"])
def test_setup_metrics_none_once_the_ring_let_a_root_go(name):
    before = [S("Bank.build", -2, -1), S("Bitmap.importBatch", -3, -2)]
    assert reader(name).read(ctx_of(name, marks(before, []))) is not None
    assert reader(name).read(
        ctx_of(name, marks(before, [], evicted_open=1))) is None


def test_a_tracer_without_a_ring_reads_none():
    """A program whose tracer keeps no marked ring (the ring before the
    byte bound) gives no mark, and every reader reads None."""
    env = types.SimpleNamespace(api=types.SimpleNamespace(
        tracer=types.SimpleNamespace(finished=[])))
    assert spans.mark(env) is None
    for name in ("queue_wait_ms", "call_ms", "idle_host_busy_share",
                 "bank_build_s", "import_native_s"):
        ctx = ctx_of(name, (spans.mark(env), spans.mark(env)),
                     events=types.SimpleNamespace(device=[]),
                     window_ns=(0, 1))
        assert reader(name).read(ctx) is None


def test_minus_and_self_time():
    assert spans.minus([(0, 10), (20, 30)], [(2, 3), (5, 22), (25, 40)]) \
        == [(0, 2), (3, 5), (22, 25)]
    parent = S("p", 0, 1, S("a", 0.1, 0.3), S("b", 0.2, 0.5),
               S("c", 0.9, 1.5))
    assert spans.self_time(parent) == pytest.approx(0.5)


def test_breakdown_names_idle_time_by_the_innermost_span():
    roots = [S("HTTP.request", 0.0, 0.5,
               S("API.QueryCoalesced", 0.0, 0.45)),
             S("Coalescer.flush", 0.1, 0.4,
               S("Executor.call", 0.1, 0.4,
                 S("Executor.launch", 0.2, 0.35)))]
    lo, hi = int(T0 * 1e9), int((T0 + 1.0) * 1e9)
    events = types.SimpleNamespace(device=[
        ("k", lo + int(0.25e9), lo + int(0.3e9))], ranges={})
    got = dict(spans.idle_by_span(roots, events, lo, hi))
    want = {"no span": 0.5, "API.QueryCoalesced": 0.15,
            "Executor.call": 0.15, "Executor.launch": 0.1,
            "HTTP.request": 0.05}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    out = spans.breakdown((roots, T0, T0 + 10))
    assert out["self_share"]["Executor.call"] == pytest.approx(
        0.15 / 0.3, abs=1e-6)
    assert out["by_name"]["Executor.launch"]["n"] == 1
    assert "idle_by_span" not in out
    out = spans.breakdown((roots, T0, T0 + 10), events, (lo, hi))
    assert dict(out["idle_by_span"]) == got
    assert out["clock_offset_us"] == {}


def test_union_and_clock_offsets():
    assert spans.union([(5, 7), (0, 2), (1, 3), (4, 4), (7, 8)]) == \
        [(0, 3), (5, 8)]
    roots = [S("HTTP.request", 0.0, 0.5), S("HTTP.request", 1.0, 1.5),
             S("Coalescer.flush", 0.1, 0.4)]
    t = int(T0 * 1e9)
    events = types.SimpleNamespace(ranges={
        "HTTP.request": (t + int(1.0e9) + 30_000, t + int(1.5e9)),
        "Executor.call": (t, t + 1)})
    got = spans.clock_offsets(roots, events)
    assert set(got) == {"HTTP.request"}
    assert got["HTTP.request"] == pytest.approx(30.0, abs=0.5)


def test_traced_run_on_the_cpu_reports_the_span_metrics():
    out = harness.run_cell("fingerprint-similarity", 2**31 + 17, 2.0, True,
                           device="cpu",
                           overrides={"molecules": 20_000,
                                      "load_chunk": 5_000},
                           log=lambda m: None)
    assert out["correct"] is True
    got = out["metrics"]
    for name in ("queue_wait_ms", "call_ms", "bank_build_s",
                 "import_native_s"):
        assert got[name]["value"] > 0, name
    assert got["bank_build_s"]["value"] <= got["warm_s"]["value"]
    assert got["import_native_s"]["value"] <= got["import_s"]["value"]
    # The CPU has no device activity to join with.
    assert "idle_host_busy_share" not in got
