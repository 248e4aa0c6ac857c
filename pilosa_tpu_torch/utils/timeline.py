"""Request-lifecycle timeline plane: where each request's wall clock
goes. After the JAX package's ``utils/timeline.py``.

- ``TimelineRecorder``: a bounded per-process ring of per-request
  timelines. Each request records ``ph:"X"`` slices (queue wait,
  coalescer flush, plan, dispatch, sampled device time, materialize,
  serialize) stamped against ONE wall-clock anchor taken at request
  start; durations are ``time.perf_counter()`` deltas, so an NTP step
  mid-request cannot corrupt them. Served at ``GET /debug/timeline?last=N``
  as trace-event JSON that Perfetto and chrome://tracing load as is.
- the **dispatch-gap analyzer**: every launch site notes its host
  enqueue interval into a rolling window; ``idle_ratio()`` is the share
  of that window with nothing being enqueued, exported as
  ``pilosa_device_idle_ratio``. The JAX package taps its one program
  funnel (``Executor._call_program``); the port has none, so three sites
  feed it: each kernel wrapper of ``ops/kernels.py`` around its C entry,
  the eager evaluation of one call's tree (``Executor._eval_node``:
  torch elementwise work and the kernels it launches), and the
  megakernel's ``_launch`` (``executor/megakernel.py``: the plan checks,
  the upload, the expansion and the interpreter). Intervals that
  overlap merge, so a kernel inside an eager tree counts once in the
  busy time (``dispatchesTotal`` counts every note). The intervals are
  host enqueue times, not device times: the ratio is the share of the
  window in which the host was not handing the card work.

Device slices ride the profiler's *sampled* fences only
(``QueryProfile.sample_device``): the unsampled path records host
timestamps and takes no CUDA event and no sync.

Pure host module: no torch import, no device interaction; recording is
list and deque appends under leaf locks.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.utils.locks import make_lock

# Stage lanes (Chrome trace-event tid): one horizontal track per
# pipeline stage so a request reads top-to-bottom as it flows through
# the serving path. Names surface via thread_name metadata events.
LANE_REQUEST = 0
LANE_QUEUE = 1
LANE_COALESCE = 2
LANE_PLAN = 3
LANE_DISPATCH = 4
LANE_DEVICE = 5
LANE_FETCH = 6
LANE_SERIALIZE = 7
LANE_REMOTE = 8
LANE_CACHE = 9

LANE_NAMES = {
    LANE_REQUEST: "request",
    LANE_QUEUE: "queue",
    LANE_COALESCE: "coalesce",
    LANE_PLAN: "plan",
    LANE_DISPATCH: "dispatch",
    LANE_DEVICE: "device",
    LANE_FETCH: "materialize",
    LANE_SERIALIZE: "serialize",
    LANE_REMOTE: "remote",
    LANE_CACHE: "cache",
}

# Stage names whose slice durations feed the summary medians (the
# bench's stage-time breakdown reads these).
_SUMMARY_STAGES = ("queue", "coalesce", "plan", "dispatch", "device",
                   "materialize", "serialize")


class _TimelineRequest:
    """One request's recorded slices. ``t0_wall`` is the single
    wall-clock anchor for export timestamps; every event start is a
    ``perf_counter`` reading converted at snapshot time as
    ``t0_wall + (start_pc - t0_pc)`` — monotonic durations, one wall
    read per request."""

    __slots__ = ("trace_id", "index", "seq", "t0_wall", "t0_pc",
                 "events", "dropped", "error")

    def __init__(self, trace_id: str, index: str, seq: int) -> None:
        self.trace_id = trace_id
        self.index = index
        self.seq = seq
        self.t0_wall = time.time()
        self.t0_pc = time.perf_counter()
        # (name, lane, start_pc, dur_s, args-or-None); appended by the
        # request thread AND (for coalesced/cluster requests) the
        # dispatcher / scatter threads — list.append is atomic, and the
        # ring holds the object only after finish(), so snapshot copies
        # see a consistent prefix.
        self.events: List[tuple] = []
        self.dropped = 0
        self.error: Optional[str] = None


class TimelineRecorder:
    """Process-wide timeline ring + dispatch-gap analyzer (the timeline
    analog of hotspots.WORKLOAD / memledger.LEDGER).

    ``begin`` is on the path of every query: it decides sampling and
    hands back a request handle (or None — every ``event`` call on a
    None handle is a no-op, so the unsampled/disabled path costs one
    attribute read). ``note_dispatch`` is independent of request
    sampling: the gap analyzer must see EVERY dispatch or idle gaps
    would be fictional."""

    # Slices kept per request: enough for a realistic multi-call query
    # (ops × {plan, dispatch, materialize} + queue/flush/serialize)
    # without letting a 1024-call query bloat the ring.
    MAX_EVENTS_PER_REQUEST = 192
    # Rough per-event ledger cost (tuple + strings + args dict).
    EVENT_NBYTES = 120
    # Roofline counter-track samples kept (ph:"C" lanes in the export);
    # fed only by sampled device fences, so the ring turns over slowly.
    MAX_COUNTER_SAMPLES = 512
    # Rough per-sample ledger cost (tuple of three floats).
    COUNTER_NBYTES = 48

    def __init__(self, ring: int = 256, sample_every: int = 1,
                 gap_window_s: float = 60.0,
                 max_dispatches: int = 4096) -> None:
        self.enabled = True
        self.sample_every = max(1, int(sample_every))
        self.gap_window_s = max(0.001, float(gap_window_s))
        self._lock = make_lock("TimelineRecorder._lock")
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._seq = 0
        self.requests_recorded = 0
        self.requests_skipped = 0
        self._tls = threading.local()
        # Dispatch-gap analyzer: (start_pc, end_pc) per compiled-program
        # invocation, its own leaf lock — note_dispatch runs on the
        # dispatch hot path and must never contend with a snapshot
        # walking the request ring.
        self._gap_lock = make_lock("TimelineRecorder._gap_lock")
        self._dispatches: deque = deque(maxlen=max(16, int(max_dispatches)))
        self.dispatches_total = 0
        # Roofline counter track: (wall_s, bytes_per_s, fraction)
        # samples from the megakernel's sampled device fences
        # (executor/megakernel._attribute via roofline.note_device) —
        # exported as ph:"C" Perfetto counter lanes. Guarded by the
        # gap lock: both are leaf locks fed from the dispatch path.
        self._counters: deque = deque(maxlen=self.MAX_COUNTER_SAMPLES)
        self.counters_total = 0

    # ------------------------------------------------------------ configure

    def configure(self, enabled: Optional[bool] = None,
                  ring: Optional[int] = None,
                  sample_every: Optional[int] = None,
                  gap_window_s: Optional[float] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if ring is not None:
                self._ring = deque(self._ring, maxlen=max(1, int(ring)))
            if sample_every is not None:
                self.sample_every = max(1, int(sample_every))
        if gap_window_s is not None:
            self.gap_window_s = max(0.001, float(gap_window_s))

    def reset(self) -> None:
        """Tests only: drop every recorded timeline and counter."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self.requests_recorded = 0
            self.requests_skipped = 0
        with self._gap_lock:
            self._dispatches.clear()
            self.dispatches_total = 0
            self._counters.clear()
            self.counters_total = 0

    # ------------------------------------------------------------ recording

    def begin(self, trace_id: Optional[str],
              index: str = "") -> Optional[_TimelineRequest]:
        """Open a request timeline (None = not sampled / disabled).
        ``trace_id`` should be the same id the tracer propagates
        (W3C traceparent) so cross-node legs stitch by it."""
        # A new request on this thread invalidates the previous one's
        # post-finish hook: if its serialize slice never fired (error
        # path, broken pipe), note_serialize must not attach THIS
        # request's serialize time to an already-published timeline.
        self._tls.last = None
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            if self.sample_every > 1 and self._seq % self.sample_every:
                self.requests_skipped += 1
                return None
        return _TimelineRequest(trace_id or uuid.uuid4().hex, index,
                                self._seq)

    def event(self, req: Optional[_TimelineRequest], name: str,
              lane: int, start_pc: float, dur_s: float,
              **args: Any) -> None:
        """Record one ``ph:"X"`` slice. ``start_pc`` is a
        ``time.perf_counter()`` reading; negative durations clamp to 0
        (clock granularity)."""
        if req is None:
            return
        if len(req.events) >= self.MAX_EVENTS_PER_REQUEST:
            req.dropped += 1
            return
        req.events.append((name, lane, start_pc, max(0.0, dur_s),
                           args or None))

    def finish(self, req: Optional[_TimelineRequest],
               error: Optional[BaseException] = None) -> None:
        """Close a request timeline: append the request-level slice and
        publish the timeline into the ring. Also remembers the request
        on the calling thread so a post-response hook (HTTP serialize)
        can still attach to it."""
        if req is None:
            return
        if error is not None:
            req.error = f"{type(error).__name__}: {error}"
        dur = time.perf_counter() - req.t0_pc
        args: Dict[str, Any] = {"trace": req.trace_id}
        if req.index:
            args["index"] = req.index
        if req.error:
            args["error"] = req.error
        req.events.append(("request", LANE_REQUEST, req.t0_pc,
                           max(0.0, dur), args))
        with self._lock:
            self._ring.append(req)
            self.requests_recorded += 1
        self._tls.last = req

    def note_serialize(self, start_pc: float, dur_s: float) -> None:
        """Attach an HTTP-serialize slice to the request this thread
        most recently finished (the handler thread writes the response
        after the API layer closed the timeline)."""
        req = getattr(self._tls, "last", None)
        if req is None:
            return
        self.event(req, "serialize", LANE_SERIALIZE, start_pc, dur_s)
        self._tls.last = None

    # ------------------------------------------- dispatch-gap analyzer

    def note_dispatch(self, start_pc: float, dur_s: float) -> None:
        """One compiled-program invocation (enqueue interval). Always
        on when the recorder is enabled — independent of request
        sampling, so the idle ratio reflects every dispatch."""
        if not self.enabled:
            return
        with self._gap_lock:
            self._dispatches.append((start_pc, start_pc + max(0.0, dur_s)))
            self.dispatches_total += 1

    def note_bandwidth(self, bytes_per_s: float,
                       roofline_frac: float) -> None:
        """One achieved-bandwidth sample (a megakernel launch that hit
        a sampled device fence): feeds the ph:"C" counter lanes in the
        export. Independent of request sampling, like note_dispatch —
        the fence already happened, recording it costs one append."""
        if not self.enabled:
            return
        with self._gap_lock:
            self._counters.append((time.time(), float(bytes_per_s),
                                   float(roofline_frac)))
            self.counters_total += 1

    def counter_samples(self) -> List[Tuple[float, float, float]]:
        with self._gap_lock:
            return list(self._counters)

    def _export_counters(self, pid: int) -> List[Dict[str, Any]]:
        """Chrome ``ph:"C"`` counter events — one bytes/s lane and one
        roofline-fraction lane per sample. ``dur``/``tid`` ride along
        as 0 so every event in the document carries the full
        ph/ts/dur/pid/tid shape (the CI smoke validates exactly
        that)."""
        events: List[Dict[str, Any]] = []
        for wall_s, bps, frac in self.counter_samples():
            ts = wall_s * 1e6
            events.append({"name": "launch_bytes_per_s", "ph": "C",
                           "cat": "pilosa", "ts": ts, "dur": 0,
                           "pid": pid, "tid": 0,
                           "args": {"bytes_per_s": bps}})
            events.append({"name": "roofline_fraction", "ph": "C",
                           "cat": "pilosa", "ts": ts, "dur": 0,
                           "pid": pid, "tid": 0,
                           "args": {"fraction": frac}})
        return events

    def gap_summary(self, now_pc: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Dispatch-gap stats over the rolling window: ``idleRatio`` is
        the fraction of the span between the first and last dispatch in
        the window that no dispatch covered — the time an RTT-hiding
        pipeline (ROADMAP 5) could fill. In [0, 1] by construction;
        0.0 with fewer than two dispatches in the window (no gaps are
        measurable yet)."""
        now = time.perf_counter() if now_pc is None else now_pc
        horizon = now - self.gap_window_s
        with self._gap_lock:
            ivals = [(s, e) for s, e in self._dispatches if e >= horizon]
            total = self.dispatches_total
        out = {"dispatches": len(ivals), "dispatchesTotal": total,
               "windowS": self.gap_window_s, "idleRatio": 0.0,
               "busyS": 0.0, "idleS": 0.0, "largestGapS": 0.0}
        if len(ivals) < 2:
            return out
        ivals.sort()
        span_start, span_end = ivals[0][0], max(e for _, e in ivals)
        busy = 0.0
        largest_gap = 0.0
        cur_s, cur_e = ivals[0]
        for s, e in ivals[1:]:
            if s > cur_e:
                largest_gap = max(largest_gap, s - cur_e)
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        span = max(1e-12, span_end - span_start)
        idle = max(0.0, span - busy)
        out["busyS"] = busy
        out["idleS"] = idle
        out["largestGapS"] = largest_gap
        out["idleRatio"] = min(1.0, max(0.0, idle / span))
        return out

    def idle_ratio(self, now_pc: Optional[float] = None) -> float:
        return self.gap_summary(now_pc)["idleRatio"]

    # -------------------------------------------------------------- reading

    def _export_events(self, reqs: List[_TimelineRequest], pid: int
                       ) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        for req in reqs:
            anchor_us = req.t0_wall * 1e6
            for name, lane, start_pc, dur_s, args in list(req.events):
                ev: Dict[str, Any] = {
                    "name": name, "ph": "X", "cat": "pilosa",
                    "ts": anchor_us + (start_pc - req.t0_pc) * 1e6,
                    "dur": dur_s * 1e6,
                    "pid": pid, "tid": lane,
                }
                a = dict(args) if args else {}
                a.setdefault("trace", req.trace_id)
                ev["args"] = a
                events.append(ev)
        return events

    @staticmethod
    def metadata_events(pid: int, node_name: str) -> List[Dict[str, Any]]:
        """Chrome ``ph:"M"`` naming events for one process (node) and
        its stage lanes. ``ts``/``dur`` ride along as 0 so every event
        in the document carries the full ph/ts/dur/pid/tid shape (the
        CI smoke validates exactly that)."""
        meta = [{"name": "process_name", "ph": "M", "ts": 0, "dur": 0,
                 "pid": pid, "tid": 0, "args": {"name": node_name}}]
        for lane, lname in LANE_NAMES.items():
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "dur": 0, "pid": pid, "tid": lane,
                         "args": {"name": lname}})
        return meta

    def requests(self, last: Optional[int] = None,
                 trace_id: Optional[str] = None) -> List[_TimelineRequest]:
        """Most-recent-last request handles, optionally filtered by
        trace id and bounded to the last N."""
        with self._lock:
            reqs = list(self._ring)
        if trace_id:
            reqs = [r for r in reqs if r.trace_id == trace_id]
        if last is not None and last >= 0:
            reqs = reqs[-last:]
        return reqs

    def _stage_medians(self, reqs: List[_TimelineRequest]
                       ) -> Dict[str, float]:
        per: Dict[str, List[float]] = {}
        for req in reqs:
            for name, _lane, _s, dur_s, _a in list(req.events):
                if name in _SUMMARY_STAGES:
                    per.setdefault(name, []).append(dur_s)
        out = {}
        for name, vals in per.items():
            vals.sort()
            out[name] = vals[len(vals) // 2]
        return out

    def snapshot(self, last: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 node_id: str = "local", pid: int = 0) -> Dict[str, Any]:
        """The ``GET /debug/timeline`` document: trace-event JSON
        (``traceEvents`` — the Chrome JSON object format, loadable
        directly in Perfetto/chrome://tracing) plus a summary with the
        dispatch-gap analysis and per-stage duration medians."""
        reqs = self.requests(last=last, trace_id=trace_id)
        counters = self._export_counters(pid)
        events = self.metadata_events(pid, node_id) \
            + counters + self._export_events(reqs, pid)
        gap = self.gap_summary()
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "node": node_id,
            "summary": {
                "requests": len(reqs),
                "requestsRecorded": self.requests_recorded,
                "requestsSkipped": self.requests_skipped,
                "ringCapacity": self._ring.maxlen,
                "sampleEvery": self.sample_every,
                "counterSamples": len(counters) // 2,
                "deviceIdleRatio": gap["idleRatio"],
                "dispatchGap": gap,
                "stageMedianS": self._stage_medians(reqs),
            },
        }

    def ring_count(self) -> int:
        with self._lock:
            return len(self._ring)

    def ring_nbytes(self) -> int:
        """Estimated bytes held by the timeline ring (the memory-ledger
        ``telemetry`` registration; O(ring) under the lock)."""
        with self._lock:
            n_events = sum(len(r.events) for r in self._ring)
            n_reqs = len(self._ring)
        with self._gap_lock:
            n_counters = len(self._counters)
        return (n_events * self.EVENT_NBYTES + n_reqs * 160
                + n_counters * self.COUNTER_NBYTES)

    def register_memory(self, ledger: Optional[Any] = None) -> None:
        """Register the ring's bytes with the memory ledger (category
        ``telemetry``) so /debug/memory totals stay provable."""
        if ledger is None:
            from pilosa_tpu_torch.utils.memledger import LEDGER as ledger
        ledger.register("telemetry", "timeline_ring", self.ring_nbytes(),
                        owner=self, kind="timeline",
                        entries=self.ring_count())

    def publish(self, stats: Optional[Any]) -> None:
        """Export the dispatch-gap gauges: ``pilosa_device_idle_ratio``
        plus the dispatch counter the ratio derives from."""
        if stats is None:
            return
        gap = self.gap_summary()
        stats.gauge("device_idle_ratio", gap["idleRatio"])
        stats.gauge("timeline_window_dispatches", gap["dispatches"])

    def dump(self, logger: Optional[Any], last: int = 5) -> int:
        """Write the most recent `last` request timelines to the log —
        the SIGTERM drain calls this so buffered timelines survive a
        graceful shutdown. Returns records written."""
        reqs = self.requests(last=max(0, int(last)))
        if logger is not None and reqs:
            gap = self.gap_summary()
            logger.printf(
                "timeline: dumping %d request timeline(s) on shutdown "
                "(idle ratio %.3f over %d dispatches)", len(reqs),
                gap["idleRatio"], gap["dispatches"])
            for r in reqs:
                stages = ",".join(
                    f"{name}={dur_s * 1e3:.2f}ms"
                    for name, _l, _s, dur_s, _a in list(r.events)
                    if name != "request")
                logger.printf("timeline: trace=%s index=%s %s",
                              r.trace_id, r.index or "-", stages)
        return len(reqs)


# The process-wide recorder every serving-path seam reports into (the
# timeline analog of hotspots.WORKLOAD — one process, one timeline).
TIMELINE = TimelineRecorder()
