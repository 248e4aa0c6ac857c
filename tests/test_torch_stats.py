"""The port's metrics interface (``pilosa_tpu_torch/utils/stats.py``)
against the JAX package's: the same calls on a ``MemStatsClient`` of
each package give equal snapshots and byte-identical Prometheus text,
and the exposition's invariants hold (label escaping, no ``_seconds`` on
a ``_size`` family, cumulative histograms, one TYPE line a family,
contiguous families); the statsd client's wire format equals the JAX
client's and its close joins its flush thread."""

import socket
import threading

import pytest

from pilosa_tpu.utils import stats as jax_stats
from pilosa_tpu_torch.utils import stats as port_stats
from pilosa_tpu_torch.utils.stats import (
    MemStatsClient, MultiStatsClient, NopStatsClient, StatsdStatsClient,
    Timer, prometheus_text,
)


def _escaping(s):
    s.with_tags('path:C:\\tmp', 'msg:say "hi"').count("esc", 2)


def _sizes(s):
    s.histogram("coalescer.batch_size", 4)
    s.timing("queue.wait_size", 3)
    s.timing("coalescer.request", 0.25)


def _pow2_histogram(s):
    for v in (1, 1, 2, 3, 5, 64, 200):
        s.histogram("executor.fusion_group_size", v)
    s.with_tags("index:i1").histogram("executor.fusion_group_size", 2)


def _slo_histogram(s):
    buckets = tuple(2.0 ** e for e in range(-14, 4))
    for i, v in enumerate((0.0001, 0.003, 0.5, 9.0, 0.003)):
        s.with_tags("endpoint:/metrics", f"status:{200 + i % 2}").histogram(
            "http_request_seconds", v, buckets=buckets)


def _interleave(s):
    s.count("fragment.reads", 7)
    s.count("fragment.reads_dedup", 1)
    s.with_tags("index:i1").count("fragment.reads", 3)
    s.gauge("depth", 3)
    s.with_tags("index:a").gauge("depth", 5)


def _timings(s):
    for i in range(1500):
        s.timing("executor.plan", i / 1000.0)
    s.with_tags("sampled:true").timing("executor.device", 0.002)
    s.set("users", "a")
    s.set("users", "b")
    s.set("users", "a")


def _executor_series(s):
    s.count("executor.mega_launches", 1)
    s.count("executor.mega_queries", 18)
    s.histogram("executor.mega_batch_size", 18)
    for kind, n in (("gather", 10), ("compute", 20), ("expand", 0),
                    ("pad", 5)):
        s.with_tags(f"kind:{kind}").count("executor.launch_bytes", n)
    s.with_tags("op:and").count("executor.opcode", 48)
    s.gauge("roofline_gbps", 3350.0)
    s.with_tags("category:bank").gauge("memory.bytes", 1 << 30)


SCENARIOS = {"escaping": _escaping, "sizes": _sizes,
             "pow2_histogram": _pow2_histogram,
             "slo_histogram": _slo_histogram, "interleave": _interleave,
             "timings": _timings, "executor_series": _executor_series}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prometheus_text_matches_jax(name):
    """The same calls on each package's MemStatsClient: equal snapshots,
    byte-identical exposition."""
    j, p = jax_stats.MemStatsClient(), port_stats.MemStatsClient()
    SCENARIOS[name](j)
    SCENARIOS[name](p)
    assert p.snapshot() == j.snapshot()
    assert prometheus_text(p) == jax_stats.prometheus_text(j)


def test_prom_label_escaping():
    stats = MemStatsClient()
    _escaping(stats)
    line = next(ln for ln in prometheus_text(stats).splitlines()
                if ln.startswith("pilosa_esc_total{"))
    assert 'path="C:\\\\tmp"' in line
    assert 'msg="say \\"hi\\""' in line
    assert line.endswith(" 2")


def test_prom_size_metrics_have_no_seconds_suffix():
    stats = MemStatsClient()
    _sizes(stats)
    out = prometheus_text(stats)
    assert 'pilosa_coalescer_batch_size_bucket{le="4"} 1' in out
    assert "pilosa_coalescer_batch_size_seconds" not in out
    assert "pilosa_queue_wait_size{" in out
    assert "pilosa_queue_wait_size_seconds" not in out
    assert "pilosa_coalescer_request_seconds{" in out


def test_prom_histogram_bucket_invariants():
    stats = MemStatsClient()
    for v in (1, 1, 2, 3, 5, 64, 200):
        stats.histogram("executor.fusion_group_size", v)
    snap = stats.snapshot()["histograms"]["executor.fusion_group_size"]
    assert snap["buckets"] == {"1": 2, "2": 3, "4": 4, "8": 5,
                               "16": 5, "32": 5, "64": 6, "+Inf": 7}
    assert snap["count"] == 7 and snap["sum"] == 276
    out = prometheus_text(stats)
    assert "# TYPE pilosa_executor_fusion_group_size histogram" in out
    assert 'pilosa_executor_fusion_group_size_bucket{le="+Inf"} 7' in out
    assert "pilosa_executor_fusion_group_size_sum 276" in out


def test_prom_one_type_line_per_family_and_contiguous():
    stats = MemStatsClient()
    _interleave(stats)
    stats.timing("lat", 0.1)
    stats.with_tags("index:a").timing("lat", 0.2)
    lines = prometheus_text(stats).splitlines()
    names = [ln.split()[2] for ln in lines if ln.startswith("# TYPE ")]
    assert len(names) == len(set(names)), names
    fam = [i for i, ln in enumerate(lines)
           if ln.startswith("pilosa_fragment_reads_total")
           or ln == "# TYPE pilosa_fragment_reads_total counter"]
    assert fam == list(range(fam[0], fam[0] + 3))
    help_lines = [ln for ln in lines if ln.startswith("# HELP ")]
    assert len(help_lines) == len(names)


def test_prom_tagged_names_stay_bounded():
    stats = MemStatsClient()
    stats.with_tags("index:i1").count("query", 1)
    out = prometheus_text(stats)
    assert 'pilosa_query_total{index="i1"} 1' in out
    assert "i1_total" not in out


def test_nop_multi_and_timer():
    """The nop client records nothing; a multi client fans out and
    snapshots its first snapshot-capable member; Timer times into
    ``timing``."""
    nop = NopStatsClient()
    assert nop.with_tags("a:b") is nop
    nop.count("x")
    mem = MemStatsClient()
    multi = MultiStatsClient(NopStatsClient(), mem)
    multi.with_tags("k:v").count("x", 2)
    multi.gauge("g", 1.5)
    with Timer(multi, "t"):
        pass
    snap = multi.snapshot()
    assert snap["counters"] == {"x{k:v}": 2}
    assert snap["gauges"] == {"g": 1.5}
    assert snap["timings"]["t"]["count"] == 1


def _statsd_datagrams(mod):
    """The datagrams one scripted sequence sends to a local UDP socket."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    c = mod.StatsdStatsClient(f"127.0.0.1:{rx.getsockname()[1]}",
                              tags=("node:a",))
    try:
        c.count("q", 3)
        c.with_tags("index:i").gauge("depth", 2.5)
        c.histogram("batch", 4)
        c.timing("lat", 0.0125)
        c.set("users", "u1")
        c.flush()
        return rx.recv(65536).decode()
    finally:
        c.close()
        rx.close()


def test_statsd_wire_matches_jax():
    assert _statsd_datagrams(port_stats) == _statsd_datagrams(jax_stats)


def test_statsd_close_joins_flush_thread():
    before = threading.active_count()
    c = StatsdStatsClient("localhost:1")  # UDP, nothing listening
    t = c._shared["thread"]
    assert t.is_alive()
    c.count("x", 1)
    c.with_tags("a:b").close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert c._shared["stop"].is_set()
    assert threading.active_count() <= before + 1
