"""Metrics interface, after the JAX package's ``utils/stats.py``.

``StatsClient`` (count, gauge, histogram, set and timing, with tags) and
its implementations: in memory (``MemStatsClient``, served at
``/debug/vars`` and as Prometheus text at ``/metrics`` through
``prometheus_text``), nop, statsd over UDP (``StatsdStatsClient``, the
dogstatsd wire format) and multi (``MultiStatsClient``).
"""

from __future__ import annotations

import threading
from pilosa_tpu_torch.utils.locks import make_lock
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence


class StatsClient:
    def with_tags(self, *tags: str) -> "StatsClient":
        return self

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        pass

    def histogram(self, name: str, value: float, rate: float = 1.0,
                  buckets: Optional[Sequence[float]] = None) -> None:
        pass

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        pass

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        pass


class NopStatsClient(StatsClient):
    pass


# Default bucket upper bounds for MemStatsClient histograms (+Inf
# implied). Powers of two because the original histogrammed quantities
# are batch / fusion group sizes, which pad to powers of two by
# construction. Callers with a different distribution (the HTTP SLO
# latency histograms) pass their own `buckets=`; the bucket set is
# fixed per metric family at first observation.
HISTOGRAM_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _le_label(le: float) -> str:
    """Prometheus le= label text for one bucket bound: integral bounds
    print as integers (the pow2 size buckets stay "1","2",...); float
    bounds print exactly (repr round-trips)."""
    f = float(le)
    return str(int(f)) if f.is_integer() else repr(f)


class MemStatsClient(StatsClient):
    """In-memory stats served at /debug/vars (the reference's expvar
    backend, stats/stats.go:84)."""

    def __init__(self, tags: Optional[Sequence[str]] = None,
                 parent: Optional["MemStatsClient"] = None) -> None:
        self._parent = parent or self
        self.tags = tuple(tags or ())
        if parent is None:
            self.counters: Dict[str, int] = defaultdict(int)
            self.gauges: Dict[str, float] = {}
            self.timings: Dict[str, List[float]] = defaultdict(list)
            # Real cumulative histograms (fusion_group_size,
            # batch_size, http_request_seconds): per-bucket increment
            # counts + running sum + the bucket bounds the entry was
            # created with — NOT an alias of the timing summary store,
            # which cannot express Prometheus _bucket/_sum/_count
            # semantics.
            self.histos: Dict[str, dict] = {}
            self.sets: Dict[str, set] = defaultdict(set)
            self._lock = make_lock("MemStatsClient._lock")

    def _key(self, name: str) -> str:
        return f"{name}{{{','.join(self.tags)}}}" if self.tags else name

    def with_tags(self, *tags: str) -> "MemStatsClient":
        child = MemStatsClient(tags=self.tags + tags, parent=self._parent)
        return child

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        root = self._parent
        with root._lock:
            root.counters[self._key(name)] += value

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        root = self._parent
        with root._lock:
            root.gauges[self._key(name)] = value

    def histogram(self, name: str, value: float, rate: float = 1.0,
                  buckets: Optional[Sequence[float]] = None) -> None:
        """One observation into the bucketed histogram for `name`
        (default buckets HISTOGRAM_BUCKETS + +Inf; exported with
        cumulative _bucket/_sum/_count lines by prometheus_text).
        `buckets` sets the bounds when the entry is first created —
        first-seen wins, so one family never mixes bucket layouts."""
        root = self._parent
        key = self._key(name)
        with root._lock:
            h = root.histos.get(key)
            if h is None:
                b = tuple(buckets) if buckets is not None \
                    else HISTOGRAM_BUCKETS
                h = root.histos[key] = {"counts": [0] * (len(b) + 1),
                                        "sum": 0.0, "buckets": b}
            b = h["buckets"]
            i = 0
            while i < len(b) and value > b[i]:
                i += 1
            h["counts"][i] += 1
            h["sum"] += value

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        root = self._parent
        with root._lock:
            root.sets[self._key(name)].add(value)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        root = self._parent
        with root._lock:
            vals = root.timings[self._key(name)]
            vals.append(value)
            if len(vals) > 1000:
                del vals[:-1000]

    def snapshot(self) -> dict:
        root = self._parent
        with root._lock:
            out = {"counters": dict(root.counters),
                   "gauges": dict(root.gauges),
                   "sets": {k: sorted(v) for k, v in root.sets.items()}}
            out["histograms"] = {}
            for k, h in root.histos.items():
                bounds = h.get("buckets", HISTOGRAM_BUCKETS)
                cum, buckets = 0, {}
                for le, c in zip(bounds, h["counts"]):
                    cum += c
                    buckets[_le_label(le)] = cum
                buckets["+Inf"] = cum + h["counts"][-1]
                out["histograms"][k] = {"buckets": buckets,
                                        "sum": h["sum"],
                                        "count": buckets["+Inf"]}
            out["timings"] = {}
            for k, vals in root.timings.items():
                if vals:
                    s = sorted(vals)
                    out["timings"][k] = {
                        "count": len(s),
                        "p50": s[len(s) // 2],
                        "p95": s[min(len(s) - 1, int(len(s) * 0.95))],
                        "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                    }
            return out


class MultiStatsClient(StatsClient):
    def __init__(self, *clients: StatsClient) -> None:
        self.clients = clients

    def with_tags(self, *tags: str) -> "MultiStatsClient":
        return MultiStatsClient(*[c.with_tags(*tags) for c in self.clients])

    def snapshot(self) -> dict:
        for c in self.clients:
            if hasattr(c, "snapshot"):
                return c.snapshot()
        return {}

    def flush(self) -> None:
        for c in self.clients:
            if hasattr(c, "flush"):
                c.flush()

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        for c in self.clients:
            c.count(name, value, rate)

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        for c in self.clients:
            c.gauge(name, value, rate)

    def histogram(self, name: str, value: float, rate: float = 1.0,
                  buckets: Optional[Sequence[float]] = None) -> None:
        for c in self.clients:
            c.histogram(name, value, rate, buckets=buckets)

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        for c in self.clients:
            c.set(name, value, rate)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        for c in self.clients:
            c.timing(name, value, rate)


class Timer:
    def __init__(self, stats: StatsClient, name: str) -> None:
        self.stats = stats
        self.name = name

    def __enter__(self) -> "Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self.stats.timing(self.name, time.perf_counter() - self.t0)


class StatsdStatsClient(StatsClient):
    """DataDog-flavored statsd over UDP (reference statsd/statsd.go:41,
    dogstatsd wire format `prefix.name:value|type|@rate|#tag,tag`).
    Fire-and-forget datagrams with a small in-process buffer flushed by
    size or interval (the reference uses statsd.NewBuffered, bufferLen
    datagrams per packet); send errors are logged once and never raised
    into the serving path."""

    PREFIX = "pilosa."
    BUFFER_LEN = 16
    FLUSH_INTERVAL = 1.0

    def __init__(self, host: str, tags: Optional[Sequence[str]] = None,
                 logger: Optional[Any] = None,
                 _shared: Optional[Dict[str, Any]] = None) -> None:
        import socket

        self.tags = tuple(tags or ())
        if _shared is not None:
            self._shared = _shared
            return
        addr = host.rsplit(":", 1)
        self._shared = {
            "addr": (addr[0] or "localhost",
                     int(addr[1]) if len(addr) == 2 else 8125),
            "sock": socket.socket(socket.AF_INET, socket.SOCK_DGRAM),
            "buf": [],
            "lock": make_lock("StatsdStatsClient._shared.lock"),
            "logger": logger,
            "warned": False,
            "last_flush": time.monotonic(),
            "stop": threading.Event(),
        }
        # Periodic drain: without it, tail datagrams after a burst would
        # sit in the buffer until the next _emit (or forever). The
        # thread handle is kept so close() can join it.
        t = threading.Thread(target=self._flush_loop, daemon=True)
        self._shared["thread"] = t
        t.start()

    def _flush_loop(self) -> None:
        stop = self._shared["stop"]
        while not stop.wait(self.FLUSH_INTERVAL):
            self.flush()

    def close(self) -> None:
        """Stop the periodic drain and flush what's left. Joins the
        flush thread (it wakes from stop.wait within FLUSH_INTERVAL) so
        a concurrent loop-driven flush() cannot race the final one —
        previously the daemon thread was never joined and could still
        be sending while the caller tore the socket down."""
        s = self._shared
        s["stop"].set()
        t = s.get("thread")
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.FLUSH_INTERVAL * 2)
        self.flush()

    def with_tags(self, *tags: str) -> "StatsdStatsClient":
        # Sorted-union like the reference's unionStringSlice.
        merged = tuple(sorted(set(self.tags) | set(tags)))
        return StatsdStatsClient("", tags=merged, _shared=self._shared)

    def _emit(self, name: str, payload: str, rate: float) -> None:
        if rate < 1.0:
            import random
            if random.random() > rate:
                return
        line = f"{self.PREFIX}{name}:{payload}"
        if rate < 1.0:
            line += f"|@{rate}"
        if self.tags:
            line += "|#" + ",".join(self.tags)
        s = self._shared
        with s["lock"]:
            s["buf"].append(line)
            now = time.monotonic()
            if len(s["buf"]) < self.BUFFER_LEN and \
                    now - s["last_flush"] < self.FLUSH_INTERVAL:
                return
            data = "\n".join(s["buf"]).encode()
            s["buf"].clear()
            s["last_flush"] = now
            try:
                s["sock"].sendto(data, s["addr"])
            except OSError as e:
                if not s["warned"] and s["logger"] is not None:
                    s["logger"].printf("statsd send failed: %s", e)
                    s["warned"] = True

    def flush(self) -> None:
        s = self._shared
        with s["lock"]:
            if not s["buf"]:
                return
            data = "\n".join(s["buf"]).encode()
            s["buf"].clear()
            s["last_flush"] = time.monotonic()
            try:
                s["sock"].sendto(data, s["addr"])
            except OSError:
                pass

    @staticmethod
    def _num(value: float) -> str:
        """Exact decimal formatting: integral values print as integers
        (no %g 6-digit truncation, no exponent notation that non-DataDog
        statsd servers may reject)."""
        f = float(value)
        return str(int(f)) if f.is_integer() else repr(f)

    def count(self, name: str, value: int = 1, rate: float = 1.0) -> None:
        self._emit(name, f"{int(value)}|c", rate)

    def gauge(self, name: str, value: float, rate: float = 1.0) -> None:
        self._emit(name, f"{self._num(value)}|g", rate)

    def histogram(self, name: str, value: float, rate: float = 1.0,
                  buckets: Optional[Sequence[float]] = None) -> None:
        # statsd histograms are server-side bucketed; `buckets` is a
        # MemStatsClient concern and is ignored on the wire.
        self._emit(name, f"{self._num(value)}|h", rate)

    def set(self, name: str, value: str, rate: float = 1.0) -> None:
        self._emit(name, f"{value}|s", rate)

    def timing(self, name: str, value: float, rate: float = 1.0) -> None:
        # seconds -> ms, the statsd timing unit.
        self._emit(name, f"{self._num(value * 1000.0)}|ms", rate)


# Central metric-description registry: exported family name ->
# # HELP text (one line, plain ASCII). prometheus_text emits exactly
# one HELP + one TYPE line per family (pinned by test); families not
# listed here get a generic fallback so every family still carries a
# HELP line. Keep entries alphabetical within their plane.
METRIC_HELP: Dict[str, str] = {
    "pilosa_build_info":
        "Constant 1 labeled with the server version and torch device.",
    "pilosa_coalescer_batch_size":
        "Queries per coalesced executor batch.",
    "pilosa_device_idle_ratio":
        "Fraction of the rolling window the device spent idle between "
        "dispatches (utils/timeline.py gap analyzer).",
    "pilosa_executor_fusion_group_size":
        "Queries fused per executor dispatch group.",
    "pilosa_executor_jit_cache_size":
        "Entries in the executor's LRU jit trace cache.",
    "pilosa_fragment_reads_total":
        "Fragment read accesses recorded by the workload plane.",
    "pilosa_fragment_writes_total":
        "Fragment write accesses recorded by the workload plane.",
    "pilosa_http_request_seconds":
        "Per-endpoint RED request latency histogram (pow2 buckets), "
        "labeled by endpoint and status.",
    "pilosa_memory_bytes":
        "Live bytes registered with the memory ledger, per category.",
    "pilosa_memory_objects":
        "Live allocations registered with the memory ledger, per "
        "category.",
    "pilosa_memory_padding_bytes":
        "Pow2-padding waste bytes in the memory ledger, per category.",
    "pilosa_process_uptime_seconds":
        "Seconds since this server process constructed its API.",
    "pilosa_query_repeat_ratio":
        "Fraction of queries in the rolling window that repeat an "
        "already-seen query identity.",
    "pilosa_rank_cache_bytes":
        "Device bytes held by the TopN rank cache.",
    "pilosa_rank_cache_entries":
        "Live entries in the TopN rank cache.",
    "pilosa_roofline_achieved_gbps":
        "Fence-sampled achieved HBM bandwidth, GB/s.",
    "pilosa_roofline_cohorts":
        "Cohort-signature entries tracked by the roofline recorder.",
    "pilosa_roofline_drift_flagged":
        "Cohorts currently inverting the optimizer's predicted cost "
        "ordering.",
    "pilosa_roofline_drift_total":
        "Cumulative cost-model drift flags raised.",
    "pilosa_roofline_fraction":
        "EWMA of achieved bandwidth over the device roofline.",
    "pilosa_roofline_gbps":
        "Configured or auto-resolved device roofline, GB/s.",
    "pilosa_sentinel_alerts_active":
        "Alerts currently active in the sentinel (burn-rate + "
        "conditions).",
    "pilosa_sentinel_alerts_fired":
        "Cumulative alerts fired since process start.",
    "pilosa_sentinel_series":
        "History series tracked by the sentinel ring store.",
    "pilosa_slo_burn_rate":
        "Error-budget burn rate over the trailing window (1.0 = "
        "burning exactly at budget), labeled by endpoint and window.",
    "pilosa_slo_error_budget_remaining":
        "Fraction of the error budget left over the retained history "
        "span, per endpoint objective.",
}


def prometheus_text(stats: object) -> str:
    """Prometheus text exposition (v0.0.4) of a snapshot()-capable stats
    client — the modern pull-based complement to /debug/vars and the
    statsd push backend (reference metric backends, stats/stats.go:84,
    statsd/statsd.go:41)."""
    import re as _re

    snap = getattr(stats, "snapshot", lambda: {})()

    def clean(name: str) -> str:
        return _re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    def split_key(k: str) -> "tuple[str, str]":
        """'name{tag1,k:v}' (MemStatsClient._key) -> (name, labelstr):
        tags become proper Prometheus labels, never part of the metric
        name (tag values must not explode name cardinality)."""
        m = _re.fullmatch(r"([^{]+)\{(.*)\}", k)
        if not m:
            return clean(k), ""
        name, raw = m.groups()
        labels = []
        for i, t in enumerate(x for x in raw.split(",") if x):
            if "=" in t:
                lk, lv = t.split("=", 1)
            elif ":" in t:
                lk, lv = t.split(":", 1)
            else:
                lk, lv = f"tag{i}", t
            lv = lv.replace("\\", "\\\\").replace('"', '\\"')
            labels.append(f'{clean(lk)}="{lv}"')
        return clean(name), "{" + ",".join(labels) + "}" if labels else ""

    # Samples grouped BY FAMILY, not by raw store key: the exposition
    # format requires every line of one metric family to form a single
    # contiguous group under exactly one # TYPE line. Sorting raw keys
    # alone breaks that whenever another family's name sorts between a
    # family's untagged and tagged spellings ("fragment.reads" <
    # "fragment.reads_dedup" < "fragment.reads{index=...}" — '_' <
    # '{'), which split pilosa_fragment_reads_total into two groups
    # with the second one TYPE-less. Families render in first-seen
    # (sorted-key) order; the first-seen type wins, so exactly one
    # TYPE line per family by construction.
    families: Dict[str, List[str]] = {}
    order: List[str] = []

    def emit(name: str, typ: str, sample_lines: List[str]) -> None:
        group = families.get(name)
        if group is None:
            # HELP directly above the family's single TYPE line (the
            # exposition convention); samples still directly follow
            # TYPE, so the contiguity pins hold unchanged.
            help_text = METRIC_HELP.get(
                name, f"pilosa-tpu metric {name}.")
            group = families[name] = [f"# HELP {name} {help_text}",
                                      f"# TYPE {name} {typ}"]
            order.append(name)
        group.extend(sample_lines)

    for k, v in sorted(snap.get("counters", {}).items()):
        name, lab = split_key(k)
        n = f"pilosa_{name}_total"
        emit(n, "counter", [f"{n}{lab} {v}"])
    for k, v in sorted(snap.get("gauges", {}).items()):
        name, lab = split_key(k)
        n = f"pilosa_{name}"
        emit(n, "gauge", [f"{n}{lab} {v}"])
    for k, h in sorted(snap.get("histograms", {}).items()):
        # Real cumulative histogram exposition: _bucket counts are
        # monotone non-decreasing in le, le="+Inf" equals _count, and
        # _sum carries the running total (tests/test_stats.py pins the
        # invariants).
        name, lab = split_key(k)
        n = f"pilosa_{name}"
        inner = lab[1:-1] + "," if lab else ""
        sample_lines = [f'{n}_bucket{{{inner}le="{le}"}} {c}'
                        for le, c in h["buckets"].items()]
        sample_lines.append(f"{n}_sum{lab} {h['sum']}")
        sample_lines.append(f"{n}_count{lab} {h['count']}")
        emit(n, "histogram", sample_lines)
    for k, t in sorted(snap.get("timings", {}).items()):
        name, lab = split_key(k)
        # The timings store holds any distribution, not only durations
        # (bucketed histograms live in their own store above, but
        # timing() is still called with unitless values): a name ending
        # in _size (e.g. queue.wait_size) is a unitless count and
        # must not export with the _seconds suffix, which would assert
        # a time unit to every dashboard reading it.
        suffix = "" if name.endswith("_size") else "_seconds"
        n = f"pilosa_{name}{suffix}"
        inner = lab[1:-1] + "," if lab else ""
        quantiles = [f'{n}{{{inner}quantile="0.5"}} {t["p50"]}']
        if "p95" in t:
            quantiles.append(f'{n}{{{inner}quantile="0.95"}} {t["p95"]}')
        quantiles.append(f'{n}{{{inner}quantile="0.99"}} {t["p99"]}')
        emit(n, "summary", quantiles + [f"{n}_count{lab} {t['count']}"])
    lines = [line for name in order for line in families[name]]
    return "\n".join(lines) + ("\n" if lines else "")
