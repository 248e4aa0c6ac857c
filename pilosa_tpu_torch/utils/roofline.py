"""Live roofline attribution: bytes and bandwidth per megakernel launch,
calibrated against the optimizer's predicted cost. After the JAX
package's ``utils/roofline.py``.

``ops/megakernel.plan_cost()`` prices every launch's memory traffic from
the verified ``[P, 4]`` plan (host numpy, microseconds); the executor
joins that cost vector with the profiler's *sampled* device fences
(``utils/profile.py``: the unsampled path takes no fence and no sync)
and feeds this recorder. What comes out:

* achieved GB/s and roofline fraction, overall and as an EWMA per
  cohort signature (the ``S{..}|W{..}|T{..}|P{..}`` capacity bucket);
* per-opcode instruction totals and per-kind byte splits
  (gather/compute/expand/pad; pad is the pow2 capacity waste);
* the calibration loop: ``ops/plan_opt.py``'s density-predicted plan
  cost is recorded beside the measured fenced time, and a drift
  detector flags cohorts whose MEASURED cost ordering inverts the
  PREDICTED ordering.

``plan_cost`` models the JAX package's TPU kernel: a register slab in
device memory, one register row read and written per instruction. The
port's ``mega_interpret`` keeps its registers in shared memory and reads
each slot row once, so on the card ``rooflineFraction`` reads above 1.0:
the model counts more bytes than the kernel moves. The model is kept as
it is, so the two packages price the same plan alike.

The roofline itself is configured (``ROOFLINE.configure(gbps=...)``) or,
at 0, resolved from the device by ``utils/benchenv.resolve_roofline``
(an unknown card and the CPU are labelled estimate-only). Sampling bias:
``pilosa_executor_device_seconds`` is fed only by 1-in-N fences, so the
recorder carries the profiler's sample rate and reports the scaled
``deviceSecondsEstimate`` next to the raw sampled sum; achieved GB/s
comes from per-fence (bytes, seconds) pairs and is unbiased either way.

Pure host module: no torch import, no device touch, no fences. The
executor resolves the device kind and pushes it in via
``set_resolved``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.utils.locks import make_lock

# Rough per-cohort state footprint for the memory ledger's telemetry
# category: key + ~12 floats/ints + the drift bookkeeping.
COHORT_NBYTES = 192

# Two cohorts "disagree" only past this margin on BOTH axes — EWMA
# noise on CPU easily swings 10-15%, so a drift flag needs a real
# inversion, not jitter.
DRIFT_MARGIN = 1.25


def _ewma(old: Optional[float], x: float, alpha: float) -> float:
    return x if old is None else old + alpha * (x - old)


class RooflineRecorder:
    """Process-wide launch cost/bandwidth accumulator (singleton
    ``ROOFLINE`` below, same pattern as timeline.TIMELINE). Leaf lock,
    O(1) per unfenced launch; the per-fence drift scan is bounded by
    ``max_cohorts`` (LRU-evicted, so state can never grow without
    bound — the GL008 contract for always-on telemetry)."""

    def __init__(self, ewma_alpha: float = 0.25,
                 max_cohorts: int = 256) -> None:
        self._lock = make_lock("RooflineRecorder._lock")
        self.enabled = True
        self.gbps_configured = 0.0  # [roofline] gbps; 0 = auto-resolve
        self.ewma_alpha = float(ewma_alpha)
        self.max_cohorts = int(max_cohorts)
        # Profiler's device-fence rate (1-in-N; 0 = only forced
        # ?profile=true fences) — pushed in by Profiler.configure so
        # the total-device-seconds estimate can scale by it.
        self.sample_every = 0
        self._resolved: Optional[Tuple[float, str, bool]] = None
        self._reset_state()

    def _reset_state(self) -> None:
        self._cohorts: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.launches = 0
        self.fenced_launches = 0
        self.bytes_by_kind = {"gather": 0, "compute": 0,
                              "expand": 0, "pad": 0}
        self.op_counts: Dict[str, int] = {}
        self.fenced_bytes = 0
        self.fenced_device_s = 0.0
        # Fenced device time with NO cost vector (the per-group fused
        # and unfused paths): the coverage-honesty counter — how much
        # sampled device time the byte attribution does not explain.
        self.unattributed_fences = 0
        self.unattributed_device_s = 0.0
        self.drift_total = 0
        self._drift_published = 0
        self._frac_ewma: Optional[float] = None

    # ------------------------------------------------------ configure

    def configure(self, enabled: Optional[bool] = None,
                  gbps: Optional[float] = None,
                  ewma_alpha: Optional[float] = None,
                  max_cohorts: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if gbps is not None:
                self.gbps_configured = max(0.0, float(gbps))
            if ewma_alpha is not None:
                self.ewma_alpha = min(1.0, max(1e-6, float(ewma_alpha)))
            if max_cohorts is not None:
                self.max_cohorts = max(1, int(max_cohorts))

    def reset(self) -> None:
        with self._lock:
            self._reset_state()
            self._resolved = None

    def needs_resolve(self) -> bool:
        return (self.enabled and self.gbps_configured <= 0
                and self._resolved is None)

    def set_resolved(self, gbps: float, kind: str,
                     estimated: bool) -> None:
        with self._lock:
            self._resolved = (float(gbps), str(kind), bool(estimated))

    def note_sample_every(self, n: int) -> None:
        with self._lock:
            self.sample_every = max(0, int(n))

    def roofline_gbps(self) -> Tuple[float, str, bool]:
        """(GB/s, source label, estimate-only?) — config wins; an
        auto-resolved unknown device or the CPU is estimate-only."""
        if self.gbps_configured > 0:
            return self.gbps_configured, "config", False
        if self._resolved is not None:
            return self._resolved
        return 0.0, "unresolved", True

    # ----------------------------------------------------- accounting

    def _cohort(self, key: str) -> Dict[str, Any]:
        rec = self._cohorts.get(key)
        if rec is None:
            rec = {"launches": 0, "fenced": 0, "bytes": 0,
                   "lastCostBytes": 0, "predictedBytes": None,
                   "gbpsEwma": None, "deviceSEwma": None,
                   "bytesEwma": None, "drift": False}
            self._cohorts[key] = rec
            while len(self._cohorts) > self.max_cohorts:
                self._cohorts.popitem(last=False)
        else:
            self._cohorts.move_to_end(key)
        return rec

    def note_launch(self, cohort_key: str, cost: Dict[str, Any],
                    predicted_bytes: Optional[int] = None) -> None:
        """Every megakernel launch, fenced or not: byte splits, opcode
        totals, and the optimizer's predicted cost beside them."""
        if not self.enabled:
            return
        with self._lock:
            self.launches += 1
            self.bytes_by_kind["gather"] += int(cost["gatherBytes"])
            self.bytes_by_kind["compute"] += int(cost["computeBytes"])
            self.bytes_by_kind["expand"] += int(cost["expandBytes"])
            self.bytes_by_kind["pad"] += int(cost["padBytes"])
            for name, n in cost["opcodeHist"].items():
                self.op_counts[name] = self.op_counts.get(name, 0) + n
            rec = self._cohort(cohort_key)
            rec["launches"] += 1
            total = int(cost["totalBytes"])
            rec["bytes"] += total
            rec["lastCostBytes"] = total
            rec["bytesEwma"] = _ewma(rec["bytesEwma"], float(total),
                                     self.ewma_alpha)
            if predicted_bytes is not None and predicted_bytes > 0:
                rec["predictedBytes"] = _ewma(
                    rec["predictedBytes"], float(predicted_bytes),
                    self.ewma_alpha)

    def note_device(self, cohort_key: str, total_bytes: int,
                    device_s: float) -> Optional[Dict[str, float]]:
        """A launch that hit a sampled fence: join bytes with measured
        seconds. Returns {bytesPerS, gbps, frac} for the caller's
        timeline counter track, or None when unusable."""
        if not self.enabled or device_s <= 0:
            return None
        with self._lock:
            self.fenced_launches += 1
            self.fenced_bytes += int(total_bytes)
            self.fenced_device_s += float(device_s)
            bytes_per_s = total_bytes / device_s
            gbps = bytes_per_s / 1e9
            roof, _src, _est = self.roofline_gbps()
            frac = (gbps / roof) if roof > 0 else 0.0
            if roof > 0:
                self._frac_ewma = _ewma(self._frac_ewma, frac,
                                        self.ewma_alpha)
            rec = self._cohort(cohort_key)
            rec["fenced"] += 1
            rec["gbpsEwma"] = _ewma(rec["gbpsEwma"], gbps,
                                    self.ewma_alpha)
            rec["deviceSEwma"] = _ewma(rec["deviceSEwma"],
                                       float(device_s), self.ewma_alpha)
            self._detect_drift(cohort_key, rec)
            return {"bytesPerS": bytes_per_s, "gbps": gbps,
                    "frac": frac}

    def note_unattributed_fence(self, device_s: float) -> None:
        """Sampled fence on a path with no plan IR (fused/unfused):
        counted so the roofline surface states its own coverage."""
        if not self.enabled or device_s <= 0:
            return
        with self._lock:
            self.unattributed_fences += 1
            self.unattributed_device_s += float(device_s)

    # -------------------------------------------------- drift detector

    def _detect_drift(self, key: str, rec: Dict[str, Any]) -> None:
        """Flag cohorts whose measured cost ordering inverts the
        optimizer's predicted ordering: predicted says cohort A is
        cheaper than B, the fences say the opposite (with margin on
        both axes). Called under the lock; O(max_cohorts)."""
        pa, ma = rec["predictedBytes"], rec["deviceSEwma"]
        if pa is None or ma is None:
            return
        inverted = False
        for other_key, other in self._cohorts.items():
            if other_key == key:
                continue
            pb, mb = other["predictedBytes"], other["deviceSEwma"]
            if pb is None or mb is None:
                continue
            if (pa * DRIFT_MARGIN < pb and ma > mb * DRIFT_MARGIN) or \
                    (pb * DRIFT_MARGIN < pa and mb > ma * DRIFT_MARGIN):
                inverted = True
                if not other["drift"]:
                    other["drift"] = True
                    self.drift_total += 1
        if inverted and not rec["drift"]:
            rec["drift"] = True
            self.drift_total += 1
        elif not inverted and rec["drift"]:
            # Orderings re-agree (densities drifted back): clear the
            # flag so the gauge reflects the present, the counter the
            # history.
            rec["drift"] = False

    # ------------------------------------------------------- reporting

    def _residuals_locked(self) -> List[Dict[str, Any]]:
        """Predicted-vs-measured residual per cohort, ranked by drift
        (|log measured/predicted seconds|, flagged cohorts first)."""
        roof, _src, _est = self.roofline_gbps()
        out: List[Dict[str, Any]] = []
        for key, rec in self._cohorts.items():
            pred, meas = rec["predictedBytes"], rec["deviceSEwma"]
            if pred is None or meas is None or roof <= 0:
                continue
            pred_s = pred / (roof * 1e9)
            ratio = meas / pred_s if pred_s > 0 else 0.0
            out.append({
                "cohort": key,
                "predictedBytes": int(pred),
                "predictedSeconds": pred_s,
                "measuredSeconds": meas,
                "ratio": ratio,
                "drift": bool(rec["drift"]),
            })
        out.sort(key=lambda r: (not r["drift"],
                                -abs(math.log(r["ratio"]))
                                if r["ratio"] > 0 else 0.0))
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            roof, src, est = self.roofline_gbps()
            agg_gbps = (self.fenced_bytes / self.fenced_device_s / 1e9
                        if self.fenced_device_s > 0 else 0.0)
            scale = max(1, self.sample_every)
            cohorts = []
            for key, rec in self._cohorts.items():
                cohorts.append({
                    "cohort": key,
                    "launches": rec["launches"],
                    "fenced": rec["fenced"],
                    "bytes": rec["bytes"],
                    "lastCostBytes": rec["lastCostBytes"],
                    "costBytesEwma": rec["bytesEwma"],
                    "predictedBytesEwma": rec["predictedBytes"],
                    "achievedGbpsEwma": rec["gbpsEwma"],
                    "deviceSecondsEwma": rec["deviceSEwma"],
                    "drift": bool(rec["drift"]),
                })
            cohorts.sort(key=lambda c: -c["bytes"])
            return {
                "enabled": self.enabled,
                "rooflineGbps": roof,
                "rooflineSource": src,
                "estimateOnly": est,
                "launches": self.launches,
                "fencedLaunches": self.fenced_launches,
                "bytesByKind": dict(self.bytes_by_kind),
                "opcodeTotals": dict(self.op_counts),
                "achievedGbps": agg_gbps,
                "rooflineFraction": (self._frac_ewma
                                     if self._frac_ewma is not None
                                     else 0.0),
                "deviceSampleEvery": self.sample_every,
                "deviceSecondsSampled": self.fenced_device_s,
                # The sampled sum scaled by the fence rate — the
                # unbiased estimate of TOTAL device time the
                # `sampled="true"` metric label warns about.
                "deviceSecondsEstimate": self.fenced_device_s * scale,
                "unattributedFences": self.unattributed_fences,
                "unattributedDeviceSeconds": self.unattributed_device_s,
                "driftFlags": self.drift_total,
                "cohorts": cohorts,
                "residuals": self._residuals_locked(),
            }

    def publish(self, stats: Any) -> None:
        """Gauges + the drift counter into /metrics (called from the
        same refresh hook as the ledger/timeline publishers)."""
        if stats is None:
            return
        with self._lock:
            roof, _src, _est = self.roofline_gbps()
            agg = (self.fenced_bytes / self.fenced_device_s / 1e9
                   if self.fenced_device_s > 0 else 0.0)
            stats.gauge("roofline_gbps", roof)
            stats.gauge("roofline_achieved_gbps", agg)
            stats.gauge("roofline_fraction",
                        self._frac_ewma
                        if self._frac_ewma is not None else 0.0)
            stats.gauge("roofline_cohorts", len(self._cohorts))
            stats.gauge("roofline_drift_flagged",
                        sum(1 for r in self._cohorts.values()
                            if r["drift"]))
            delta = self.drift_total - self._drift_published
            if delta > 0:
                stats.count("roofline_drift", delta)
                self._drift_published = self.drift_total

    def state_nbytes(self) -> int:
        with self._lock:
            return 256 + len(self._cohorts) * COHORT_NBYTES

    def register_memory(self, ledger: Any) -> None:
        """Roofline state into the ledger's host-side `telemetry`
        category so /debug/memory totals stay provable."""
        ledger.register("telemetry", "roofline_state",
                        self.state_nbytes(), owner=self,
                        kind="roofline", cohorts=len(self._cohorts))

    def dump(self, logger: Optional[Any]) -> int:
        """Write the live calibration state to the log — the SIGTERM
        drain (cli.main.drain_telemetry) calls this so a post-mortem
        can judge the optimizer's cost model without a scrape. Returns
        lines written. Logger convention matches the other planes:
        `printf(fmt, *args)`."""
        snap = self.snapshot()
        if logger is None or snap["launches"] == 0:
            return 0
        n = 2
        logger.printf(
            "roofline: %d launches (%d fenced), achieved %.1f GB/s "
            "of %.1f GB/s (%s%s) = %.3f fraction, drift flags %d",
            snap["launches"], snap["fencedLaunches"],
            snap["achievedGbps"], snap["rooflineGbps"],
            snap["rooflineSource"],
            ", estimate-only" if snap["estimateOnly"] else "",
            snap["rooflineFraction"], snap["driftFlags"])
        kinds = snap["bytesByKind"]
        logger.printf(
            "roofline: bytes gather=%d compute=%d expand=%d pad=%d "
            "unattributed fences=%d (%.6fs)",
            kinds["gather"], kinds["compute"], kinds["expand"],
            kinds["pad"], snap["unattributedFences"],
            snap["unattributedDeviceSeconds"])
        for res in snap["residuals"][:5]:
            n += 1
            logger.printf(
                "roofline: residual %s predicted=%.6fs measured=%.6fs "
                "ratio=%.2f%s", res["cohort"],
                res["predictedSeconds"], res["measuredSeconds"],
                res["ratio"], " DRIFT" if res["drift"] else "")
        return n


ROOFLINE = RooflineRecorder()
