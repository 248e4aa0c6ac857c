"""SLO and regression sentinel, after the JAX package's
``utils/sentinel.py``: bounded metrics history and burn-rate alerts.

- ``SentinelRecorder.sample(gauges, histograms)`` appends one point per
  series to a raw ring and, every ``decimate`` raw points, their mean
  to a decimated ring, so the history covers ``ring * decimate``
  samples in bounded memory. The server samples it at the memory
  watchdog's cadence with host-side gauges (device idle ratio,
  roofline bandwidth and fraction, result- and rank-cache hit ratios,
  device live/padded bytes, coalescer queue depth) and the cumulative
  ``pilosa_http_request_seconds{endpoint,status}`` histograms.
- From the histogram deltas it derives per-endpoint request rates and
  windowed p50/p90/p99 (bucket-interpolated), and, for each declared
  objective (``[slo] query = "99.9% < 25ms"``), the error-budget burn
  rate over a fast and a slow window pair. An alert fires when both
  windows of a pair burn past their threshold and clears only below
  half of it (hysteresis).
- ``note_condition`` records edge-triggered external alerts (roofline
  drift, device-memory watermark pressure) in the same alert ring.

Host-only module: no device touch, no fence. The clock is injectable,
so the windows are testable.
"""

from __future__ import annotations

import re
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from pilosa_tpu_torch.utils.locks import make_lock

# Ledger cost model for the telemetry category: one (t, value) point,
# one per-endpoint cumulative sample (timestamp + ~19 bucket counts +
# sum + good/total), one alert-ring event.
POINT_NBYTES = 40
EP_SAMPLE_NBYTES = 224
ALERT_NBYTES = 160

# Multi-window, multi-burn-rate pairs (SRE Workbook ch. 5): the fast
# window catches the page-worthy burn, the slow window guards against
# a brief blip paging. Thresholds are the canonical 2%-of-30d-budget-
# in-1h (14.4x) and 5%-in-6h (6x) rates.
BURN_WINDOWS: Tuple[Dict[str, float], ...] = (
    {"fastS": 300.0, "slowS": 3600.0, "threshold": 14.4},
    {"fastS": 1800.0, "slowS": 21600.0, "threshold": 6.0},
)

# Hysteresis: an active alert clears only when BOTH windows drop below
# threshold * CLEAR_FACTOR; between the two lines the alert is sticky.
CLEAR_FACTOR = 0.5

_OBJECTIVE_RX = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*%\s*<\s*(\d+(?:\.\d+)?)\s*(us|ms|s)\s*$")

_5XX_RX = re.compile(r"^5\d\d$")


def parse_objective(spec: str) -> Tuple[float, float]:
    """``"99.9% < 25ms"`` -> ``(0.999, 0.025)``. Raises ValueError on
    anything else — config validation surfaces the message verbatim."""
    m = _OBJECTIVE_RX.match(str(spec))
    if m is None:
        raise ValueError(
            f"bad SLO objective {spec!r} (want e.g. '99.9% < 25ms')")
    target = float(m.group(1)) / 100.0
    if not 0.0 < target < 1.0:
        raise ValueError(
            f"bad SLO availability {m.group(1)}% (want 0 < p < 100)")
    scale = {"us": 1e-6, "ms": 1e-3, "s": 1.0}[m.group(3)]
    threshold = float(m.group(2)) * scale
    if threshold <= 0:
        raise ValueError(f"bad SLO latency threshold in {spec!r}")
    return target, threshold


def quantile_from_deltas(bounds: List[float], deltas: List[float],
                         q: float) -> float:
    """Prometheus histogram_quantile over a *delta* histogram: `bounds`
    are the finite bucket upper bounds (ascending), `deltas` the
    per-bucket (non-cumulative) counts with the +Inf bucket last
    (len(bounds) + 1 entries). Linear interpolation within the target
    bucket; the +Inf bucket clamps to the highest finite bound."""
    total = sum(deltas)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, d in enumerate(deltas):
        prev = cum
        cum += d
        if cum >= rank and d > 0:
            if i >= len(bounds):  # +Inf bucket
                return bounds[-1] if bounds else 0.0
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * ((rank - prev) / d)
    return bounds[-1] if bounds else 0.0


def _split_histo_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``http_request_seconds{endpoint:/index/{index}/query,status:200}``
    -> ``("http_request_seconds", {"endpoint": ..., "status": "200"})``.
    Endpoint labels contain braces but never commas or colons, so the
    outer split is unambiguous."""
    if "{" not in key:
        return key, {}
    name, rest = key.split("{", 1)
    labels: Dict[str, str] = {}
    for part in rest[:-1].split(","):
        if ":" in part:
            k, v = part.split(":", 1)
            labels[k] = v
    return name, labels


def _at_or_before(raw: deque, dec: deque, t: float) -> Optional[tuple]:
    """Newest retained sample with timestamp <= t — raw tier first,
    then the decimated tier's deeper history. When nothing is old
    enough (short uptime), fall back to the oldest retained sample so
    the burn window degrades to the actual covered span instead of
    reporting nothing."""
    for p in reversed(raw):
        if p[0] <= t:
            return p
    for p in reversed(dec):
        if p[0] <= t:
            return p
    if dec:
        return dec[0]
    if raw:
        return raw[0]
    return None


class _Series:
    """One bounded time series: raw ring of (t, value) + a 10:1
    decimated tier where each point is the mean of one decimation
    stride (stamped at the stride's last timestamp)."""

    __slots__ = ("raw", "dec", "decimate", "_acc", "_n")

    def __init__(self, ring: int, dec_ring: int, decimate: int) -> None:
        self.raw: deque = deque(maxlen=max(2, int(ring)))
        self.dec: deque = deque(maxlen=max(2, int(dec_ring)))
        self.decimate = max(1, int(decimate))
        self._acc = 0.0
        self._n = 0

    def add(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        self._acc += v
        self._n += 1
        if self._n >= self.decimate:
            self.dec.append((t, self._acc / self._n))
            self._acc = 0.0
            self._n = 0


class _Endpoint:
    """Cumulative RED-histogram samples for one endpoint label:
    (t, per-bucket cumulative counts incl +Inf, sum, good, total).
    `good` counts non-5xx requests at or under the threshold bucket;
    endpoints without an objective still ring (for q/s + quantiles)
    with `good` = all non-5xx. Decimated tier keeps every Nth sample
    verbatim — cumulative counters decimate by subsampling, not
    averaging."""

    __slots__ = ("endpoint", "alias", "target", "threshold_s",
                 "threshold_bucket", "bounds", "raw", "dec", "decimate",
                 "_k", "last_rates", "burn")

    def __init__(self, endpoint: str, alias: Optional[str],
                 target: Optional[float], threshold_s: Optional[float],
                 ring: int, dec_ring: int, decimate: int) -> None:
        self.endpoint = endpoint
        self.alias = alias
        self.target = target
        self.threshold_s = threshold_s
        self.threshold_bucket: Optional[float] = None
        self.bounds: Optional[List[float]] = None
        self.raw: deque = deque(maxlen=max(2, int(ring)))
        self.dec: deque = deque(maxlen=max(2, int(dec_ring)))
        self.decimate = max(1, int(decimate))
        self._k = 0
        # Latest derived instantaneous rates and per-pair burn state,
        # refreshed each sample (read by snapshot/publish).
        self.last_rates: Dict[str, float] = {}
        self.burn: List[Dict[str, Any]] = []

    def label(self) -> str:
        return self.alias or self.endpoint

    def add(self, sample: tuple) -> None:
        self.raw.append(sample)
        self._k += 1
        if self._k >= self.decimate:
            self.dec.append(sample)
            self._k = 0


class SentinelRecorder:
    """Process-wide history + SLO engine (singleton ``SENTINEL`` below,
    same idiom as timeline.TIMELINE / roofline.ROOFLINE). Leaf lock;
    every public method is O(ring) host-side arithmetic at the watchdog
    cadence — nothing here runs per request."""

    # Belt-and-braces caps on the series/endpoint maps. Key spaces are
    # closed in practice (the fixed sample_sentinel gauge list, the
    # route-template endpoint labels), but always-on telemetry must be
    # provably bounded (the GL008 contract), so creation past the cap
    # is refused rather than trusted.
    MAX_SERIES = 512
    MAX_ENDPOINTS = 128

    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self._lock = make_lock("SentinelRecorder._lock")
        self.enabled = True
        self.clock = clock
        self.ring = 720
        self.dec_ring = 720
        self.decimate = 10
        self.alert_ring_size = 256
        self.watermark_bytes = 0
        self._reset_state()

    def _reset_state(self) -> None:
        self._series: Dict[str, _Series] = {}
        self._endpoints: Dict[str, _Endpoint] = {}
        self._objectives: Dict[str, Tuple[float, float, str]] = {}
        self._alerts: Dict[str, Dict[str, Any]] = {}
        self._alert_ring: deque = deque(maxlen=self.alert_ring_size)
        self.samples = 0
        self.alerts_fired = 0
        self.alerts_cleared = 0
        self.last_sample_at: Optional[float] = None

    # ------------------------------------------------------ configure

    def configure(self, enabled: Optional[bool] = None,
                  ring: Optional[int] = None,
                  decimate: Optional[int] = None,
                  alert_ring: Optional[int] = None,
                  objectives: Optional[Dict[str, str]] = None,
                  watermark_bytes: Optional[int] = None,
                  clock: Optional[Callable[[], float]] = None) -> None:
        """Apply [sentinel]/[slo] config. Ring sizes apply to series
        created after the call — configure before serving (the tests'
        reset() + configure() sequence always does)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if ring is not None:
                self.ring = max(2, int(ring))
                self.dec_ring = self.ring
            if decimate is not None:
                self.decimate = max(1, int(decimate))
            if alert_ring is not None:
                self.alert_ring_size = max(8, int(alert_ring))
                self._alert_ring = deque(self._alert_ring,
                                         maxlen=self.alert_ring_size)
            if objectives is not None:
                parsed: Dict[str, Tuple[float, float, str]] = {}
                for alias, spec in objectives.items():
                    target, thr = parse_objective(spec)
                    parsed[str(alias)] = (target, thr, str(spec))
                self._objectives = parsed
            if watermark_bytes is not None:
                self.watermark_bytes = max(0, int(watermark_bytes))
            if clock is not None:
                self.clock = clock

    def reset(self) -> None:
        with self._lock:
            self._reset_state()

    # ------------------------------------------------------- sampling

    def _match_objective(
            self, endpoint: str
    ) -> Tuple[Optional[str], Optional[float], Optional[float]]:
        """Objective lookup: exact endpoint-label key wins, else the
        label's last path segment (``query`` matches
        ``/index/{index}/query``)."""
        obj = self._objectives.get(endpoint)
        if obj is not None:
            return endpoint, obj[0], obj[1]
        tail = endpoint.rstrip("/").rsplit("/", 1)[-1]
        obj = self._objectives.get(tail)
        if obj is not None:
            return tail, obj[0], obj[1]
        return None, None, None

    def _series_add(self, name: str, t: float, v: float) -> None:
        s = self._series.get(name)
        if s is None:
            if len(self._series) >= self.MAX_SERIES:
                return
            s = self._series[name] = _Series(self.ring, self.dec_ring,
                                             self.decimate)
        s.add(t, float(v))

    def sample(self, gauges: Optional[Dict[str, Any]] = None,
               histograms: Optional[Dict[str, Any]] = None,
               now: Optional[float] = None) -> None:
        """One sentinel tick (watchdog cadence): record the gauge
        series, ingest the cumulative RED histograms (deriving q/s +
        windowed p50/p95/p99 per endpoint), then evaluate every
        burn-rate alert pair."""
        if not self.enabled:
            return
        with self._lock:
            t = self.clock() if now is None else float(now)
            for name, v in (gauges or {}).items():
                if v is None:
                    continue
                try:
                    self._series_add(name, t, float(v))
                except (TypeError, ValueError):
                    continue
            if histograms:
                self._ingest_http_locked(histograms, t)
            self._evaluate_locked(t)
            self.samples += 1
            self.last_sample_at = t

    def _ingest_http_locked(self, histos: Dict[str, Any],
                            t: float) -> None:
        # Group the {endpoint,status} series by endpoint: summed
        # cumulative bucket counts across ALL statuses (latency
        # quantiles judge every response), good = non-5xx only.
        grouped: Dict[str, Dict[str, Any]] = {}
        for key, h in histos.items():
            name, labels = _split_histo_key(key)
            if name != "http_request_seconds":
                continue
            ep = labels.get("endpoint")
            if ep is None:
                continue
            g = grouped.get(ep)
            if g is None:
                bounds, cum = [], []
                for le, c in h["buckets"].items():
                    cum.append(int(c))
                    if le != "+Inf":
                        bounds.append(float(le))
                g = grouped[ep] = {"bounds": bounds, "cum": cum,
                                   "sum": float(h["sum"]),
                                   "total": int(h["count"]),
                                   "ok_cum": [0] * len(cum)}
            else:
                for i, c in enumerate(h["buckets"].values()):
                    g["cum"][i] += int(c)
                g["sum"] += float(h["sum"])
                g["total"] += int(h["count"])
            if not _5XX_RX.match(labels.get("status", "")):
                for i, c in enumerate(h["buckets"].values()):
                    g["ok_cum"][i] += int(c)
        for ep, g in grouped.items():
            rec = self._endpoints.get(ep)
            if rec is None:
                if len(self._endpoints) >= self.MAX_ENDPOINTS:
                    continue
                alias, target, thr = self._match_objective(ep)
                rec = self._endpoints[ep] = _Endpoint(
                    ep, alias, target, thr, self.ring, self.dec_ring,
                    self.decimate)
            if rec.bounds is None:
                rec.bounds = g["bounds"]
                if rec.threshold_s is not None:
                    idx = None
                    for i, b in enumerate(rec.bounds):
                        if b >= rec.threshold_s:
                            idx = i
                            break
                    # Threshold past every finite bound: latency can
                    # never fail the objective; +Inf is the bucket.
                    rec.threshold_bucket = (
                        rec.bounds[idx] if idx is not None
                        else float("inf"))
            # good = non-5xx at-or-under the threshold bucket (last
            # entry of ok_cum is the non-5xx +Inf total, used when no
            # latency bound applies).
            if rec.threshold_bucket is not None and \
                    rec.threshold_bucket != float("inf"):
                ti = rec.bounds.index(rec.threshold_bucket)
                good = g["ok_cum"][ti]
            else:
                good = g["ok_cum"][-1]
            prev = rec.raw[-1] if rec.raw else None
            sample = (t, tuple(g["cum"]), g["sum"], int(good),
                      int(g["total"]))
            rec.add(sample)
            if prev is not None and t > prev[0]:
                dt = t - prev[0]
                d_total = sample[4] - prev[4]
                # Bucket counts are cumulative (Prometheus `le`
                # semantics), so the sample-to-sample delta is still
                # cumulative across buckets; difference adjacent
                # entries to get the per-bucket increments the
                # quantile interpolation expects.
                cum_d = [c - p for c, p in zip(sample[1], prev[1])]
                deltas = [cum_d[0]] + [cum_d[i] - cum_d[i - 1]
                                       for i in range(1, len(cum_d))]
                label = rec.label()
                rates = {"qps": d_total / dt}
                for qn, q in (("p50", 0.50), ("p95", 0.95),
                              ("p99", 0.99)):
                    rates[qn] = quantile_from_deltas(rec.bounds,
                                                     deltas, q)
                rec.last_rates = rates
                for k, v in rates.items():
                    self._series_add(f"endpoint.{label}.{k}", t, v)

    # ------------------------------------------------------ burn rates

    def _burn_locked(self, rec: _Endpoint, window_s: float,
                     t: float) -> float:
        """Error-budget burn rate over the trailing window: the bad
        fraction of requests divided by the budget fraction
        (1 - availability target). 1.0 = burning exactly at budget."""
        if rec.target is None or not rec.raw:
            return 0.0
        new = rec.raw[-1]
        old = _at_or_before(rec.raw, rec.dec, t - window_s)
        if old is None or old[0] >= new[0]:
            return 0.0
        d_total = new[4] - old[4]
        if d_total <= 0:
            return 0.0
        d_bad = d_total - (new[3] - old[3])
        frac = max(0.0, d_bad / d_total)
        budget = 1.0 - rec.target
        return frac / budget if budget > 0 else 0.0

    def _budget_locked(self, rec: _Endpoint) -> Dict[str, Any]:
        """Budget consumed over the full retained history span."""
        out = {"spanS": 0.0, "total": 0, "bad": 0,
               "budgetConsumed": 0.0, "budgetRemaining": 1.0}
        if rec.target is None or len(rec.raw) + len(rec.dec) == 0:
            return out
        new = rec.raw[-1] if rec.raw else rec.dec[-1]
        old = rec.dec[0] if rec.dec else rec.raw[0]
        if rec.raw and rec.raw[0][0] < old[0]:
            old = rec.raw[0]
        out["spanS"] = max(0.0, new[0] - old[0])
        d_total = new[4] - old[4]
        if d_total <= 0:
            return out
        d_bad = max(0, d_total - (new[3] - old[3]))
        out["total"] = d_total
        out["bad"] = d_bad
        budget = 1.0 - rec.target
        consumed = (d_bad / d_total) / budget if budget > 0 else 0.0
        out["budgetConsumed"] = consumed
        out["budgetRemaining"] = max(0.0, 1.0 - consumed)
        return out

    def _evaluate_locked(self, t: float) -> None:
        for rec in self._endpoints.values():
            if rec.target is None:
                continue
            rec.burn = []
            for pair in BURN_WINDOWS:
                fast = self._burn_locked(rec, pair["fastS"], t)
                slow = self._burn_locked(rec, pair["slowS"], t)
                thr = pair["threshold"]
                key = f"slo-burn:{rec.label()}:{int(pair['fastS'])}s"
                active = key in self._alerts
                if not active and fast > thr and slow > thr:
                    self._fire_locked(
                        key, "slo-burn", t,
                        f"{rec.label()}: burn {fast:.1f}x/"
                        f"{slow:.1f}x over {int(pair['fastS'])}s/"
                        f"{int(pair['slowS'])}s (threshold {thr}x)",
                        endpoint=rec.endpoint, fastBurn=fast,
                        slowBurn=slow, threshold=thr)
                elif active and fast < thr * CLEAR_FACTOR and \
                        slow < thr * CLEAR_FACTOR:
                    self._clear_locked(
                        key, t,
                        f"{rec.label()}: burn recovered to "
                        f"{fast:.2f}x/{slow:.2f}x")
                rec.burn.append({
                    "fastS": pair["fastS"], "slowS": pair["slowS"],
                    "threshold": thr, "fastBurn": fast,
                    "slowBurn": slow,
                    "active": key in self._alerts,
                })

    # --------------------------------------------------------- alerts

    def _fire_locked(self, key: str, kind: str, t: float, message: str,
                     **meta: Any) -> None:
        self._alerts[key] = {"key": key, "kind": kind, "firedAt": t,
                             "message": message, **meta}
        self._alert_ring.append({"t": t, "event": "fire", "key": key,
                                 "kind": kind, "message": message})
        self.alerts_fired += 1

    def _clear_locked(self, key: str, t: float, message: str) -> None:
        old = self._alerts.pop(key, None)
        if old is None:
            return
        self._alert_ring.append({"t": t, "event": "clear", "key": key,
                                 "kind": old.get("kind", "condition"),
                                 "message": message})
        self.alerts_cleared += 1

    def note_condition(self, key: str, active: bool, message: str = "",
                       kind: str = "condition",
                       now: Optional[float] = None) -> None:
        """Edge-triggered external alert source (roofline drift, HBM
        watermark pressure, cluster node-down): fires when `active`
        goes true for an inactive key, clears on the false edge,
        no-ops otherwise — callers report state every sample without
        flooding the ring."""
        if not self.enabled:
            return
        with self._lock:
            t = self.clock() if now is None else float(now)
            if active and key not in self._alerts:
                self._fire_locked(key, kind, t, message or key)
            elif not active and key in self._alerts:
                self._clear_locked(key, t, message or f"{key} cleared")

    def active_alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._alerts.values()]

    # ------------------------------------------------------ reporting

    def history(self, series: Optional[List[str]] = None,
                last: Optional[int] = None,
                pid: int = 0) -> Dict[str, Any]:
        """The /debug/history document: points per series (raw +
        decimated tiers) plus a Perfetto counter-track export
        (``ph:"C"``) that loads beside the request timeline."""
        with self._lock:
            names = sorted(self._series)
            if series:
                wanted = set(series)
                names = [n for n in names if n in wanted]
            docs: Dict[str, Any] = {}
            events: List[Dict[str, Any]] = []
            n = None if last is None else max(1, int(last))
            for name in names:
                s = self._series[name]
                raw = list(s.raw)
                if n is not None:
                    raw = raw[-n:]
                docs[name] = {
                    "points": [[p[0], p[1]] for p in raw],
                    "decimated": [[p[0], p[1]] for p in s.dec],
                    "decimate": s.decimate,
                }
                for p in raw:
                    events.append({
                        "name": f"history:{name}", "ph": "C",
                        "cat": "pilosa", "ts": p[0] * 1e6, "dur": 0,
                        "pid": pid, "tid": 0,
                        "args": {"value": p[1]},
                    })
            return {
                "samples": self.samples,
                "lastSampleAt": self.last_sample_at,
                "series": docs,
                "traceEvents": events,
            }

    def slo_snapshot(self) -> Dict[str, Any]:
        """The /debug/slo document: objectives, per-endpoint budgets +
        burn rates + latest derived rates, and the alert ring."""
        with self._lock:
            endpoints = []
            for ep in sorted(self._endpoints):
                rec = self._endpoints[ep]
                doc: Dict[str, Any] = {
                    "endpoint": rec.endpoint,
                    "alias": rec.alias,
                    "samples": len(rec.raw),
                    "rates": dict(rec.last_rates),
                }
                if rec.target is not None:
                    tb = rec.threshold_bucket
                    doc.update({
                        "target": rec.target,
                        "thresholdS": rec.threshold_s,
                        "thresholdBucket": (
                            tb if tb is None or tb != float("inf")
                            else "+Inf"),
                        "burn": [dict(b) for b in rec.burn],
                        **self._budget_locked(rec),
                    })
                endpoints.append(doc)
            return {
                "enabled": self.enabled,
                "samples": self.samples,
                "lastSampleAt": self.last_sample_at,
                "burnWindows": [dict(w) for w in BURN_WINDOWS],
                "clearFactor": CLEAR_FACTOR,
                "objectives": {
                    alias: {"target": o[0], "thresholdS": o[1],
                            "spec": o[2]}
                    for alias, o in sorted(self._objectives.items())},
                "endpoints": endpoints,
                "alerts": {
                    "active": [dict(a) for a in self._alerts.values()],
                    "fired": self.alerts_fired,
                    "cleared": self.alerts_cleared,
                    "ring": [dict(e) for e in self._alert_ring],
                },
            }

    def health_stanza(self) -> Dict[str, Any]:
        """Compact slo/alert stanza for /internal/health and the
        cluster roll-up (mirrors _roofline_health's shape discipline)."""
        with self._lock:
            worst = 0.0
            for rec in self._endpoints.values():
                for b in rec.burn:
                    worst = max(worst, b["fastBurn"], b["slowBurn"])
            return {
                "objectives": len(self._objectives),
                "endpointsTracked": len(self._endpoints),
                "alertsActive": len(self._alerts),
                "alertsFired": self.alerts_fired,
                "worstBurn": worst,
                "samples": self.samples,
            }

    def publish(self, stats: Any) -> None:
        """Burn/budget/alert gauges into /metrics. Values are gathered
        under the lock; the stats client (its own lock) is called
        outside it — the ledger's locking discipline."""
        if stats is None:
            return
        gauges: List[Tuple[Tuple[str, ...], str, float]] = []
        with self._lock:
            for rec in self._endpoints.values():
                if rec.target is None:
                    continue
                label = rec.label()
                for b in rec.burn:
                    for wk in ("fast", "slow"):
                        gauges.append((
                            (f"endpoint:{label}",
                             f"window:{int(b[wk + 'S'])}s"),
                            "slo_burn_rate", b[wk + "Burn"]))
                budget = self._budget_locked(rec)
                gauges.append(((f"endpoint:{label}",),
                               "slo_error_budget_remaining",
                               budget["budgetRemaining"]))
            gauges.append(((), "sentinel_alerts_active",
                           float(len(self._alerts))))
            gauges.append(((), "sentinel_alerts_fired",
                           float(self.alerts_fired)))
            gauges.append(((), "sentinel_series",
                           float(len(self._series))))
        for tags, name, value in gauges:
            (stats.with_tags(*tags) if tags else stats).gauge(name,
                                                              value)

    # ------------------------------------------------------ ledger/drain

    def ring_nbytes(self) -> int:
        with self._lock:
            n = 512
            for s in self._series.values():
                n += (len(s.raw) + len(s.dec)) * POINT_NBYTES
            for rec in self._endpoints.values():
                n += (len(rec.raw) + len(rec.dec)) * EP_SAMPLE_NBYTES
            n += len(self._alert_ring) * ALERT_NBYTES
            return n

    def register_memory(self, ledger: Any) -> None:
        """History + alert rings into the ledger's host-side
        `telemetry` category so /debug/memory totals stay provable."""
        with self._lock:
            series = len(self._series)
            endpoints = len(self._endpoints)
        ledger.register("telemetry", "sentinel_rings",
                        self.ring_nbytes(), owner=self,
                        kind="sentinel", series=series,
                        endpoints=endpoints)

    def dump(self, logger: Optional[Any], last: int = 5) -> int:
        """Write the SLO verdict + recent alert events to the log (the
        SIGTERM drain path). Returns lines written. Logger convention
        matches the other planes: ``printf(fmt, *args)``."""
        snap = self.slo_snapshot()
        if logger is None or snap["samples"] == 0:
            return 0
        n = 1
        logger.printf(
            "sentinel: %d samples, %d series, %d objectives, alerts "
            "active=%d fired=%d cleared=%d",
            snap["samples"], len(self._series),
            len(snap["objectives"]),
            len(snap["alerts"]["active"]), snap["alerts"]["fired"],
            snap["alerts"]["cleared"])
        for ep in snap["endpoints"]:
            if "target" not in ep:
                continue
            n += 1
            logger.printf(
                "sentinel: %s target=%.5f budget consumed=%.3f "
                "remaining=%.3f over %.0fs (%d total, %d bad)",
                ep["alias"] or ep["endpoint"], ep["target"],
                ep["budgetConsumed"], ep["budgetRemaining"],
                ep["spanS"], ep["total"], ep["bad"])
        for ev in snap["alerts"]["ring"][-max(0, int(last)):]:
            n += 1
            logger.printf("sentinel: alert %s %s at %.3f: %s",
                          ev["event"], ev["key"], ev["t"],
                          ev["message"])
        return n


SENTINEL = SentinelRecorder()
