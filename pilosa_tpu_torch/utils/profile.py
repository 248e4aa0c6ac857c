"""Per-query execution profiler with device-time attribution, after the
JAX package's ``utils/profile.py``.

Kernel launches are asynchronous: the host returns from a launch long
before the card has run it, so wall-clock timings at the API layer
cannot say where a query's time went. This module is the attribution
layer:

- ``QueryProfile``: a per-query tree of ``ProfileNode``s the executor
  fills in as it runs: one op node per PQL call, with ``eval`` children
  per evaluated tree recording planning time, kernel-library hit/miss
  (``jit``: a miss is a launch that had to build or load the kernels
  through ``ops/build.py``; the CPU path always hits), dispatch time,
  upload bytes and, when device sampling is on, the device time between
  two CUDA events around the launch. Materialization time and
  device-to-host bytes land on the op node.
- ``Profiler``: process-wide policy and sinks. Decides which queries get
  the device fence (``?profile=true`` always; a configurable 1-in-N
  sample otherwise; unsampled queries record no event and take no
  sync), feeds every finished profile into the stats client
  (``executor.*`` timings and counters, the ``pilosa_executor_*``
  Prometheus series) and keeps the bounded slow-query ring served at
  ``GET /debug/queries``.

The cluster's profile merge (``nodes[id]``) is kept in the data model
but nothing fills it: the port is single-node.

Pure host module: no torch import. The one fencing site is
``executor.executor._fence_device``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from pilosa_tpu_torch.utils.locks import make_lock


def pql_text(query: Any, limit: int = 2000) -> str:
    """Best-effort PQL string for profiles/slow-query records: parsed
    Call/Query trees serialize back through to_pql; anything else falls
    back to str(). Bounded — ring records must stay small."""
    try:
        to = getattr(query, "to_pql", None)
        if to is not None:
            return to()[:limit]
        calls = getattr(query, "calls", None)
        if calls is not None:  # pql.Query has no to_pql of its own
            return "".join(c.to_pql() for c in calls)[:limit]
    except Exception:
        pass
    return str(query)[:limit]


class ProfileNode:
    """One span in a profile tree. ``attrs`` is JSON-clean by
    construction (floats/ints/strings only — the executor rounds
    nothing; consumers format)."""

    __slots__ = ("name", "attrs", "children")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs)
        self.children: List["ProfileNode"] = []

    def child(self, name: str, **attrs: Any) -> "ProfileNode":
        node = ProfileNode(name, **attrs)
        self.children.append(node)
        return node

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, **self.attrs}
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class QueryProfile:
    """Per-query profile the executor fills in via thread-local
    attachment (Executor._tls.profile). Single-writer by design — the
    dispatch and finalize phases of one query run on one thread; only
    the cluster fragment map (written by remote fan-out threads) takes
    a lock."""

    def __init__(self, index: str, query: Any,
                 shards: Optional[Sequence[int]] = None,
                 sample_device: bool = False, forced: bool = False,
                 trace_id: Optional[str] = None):
        self.index = index
        self.pql = pql_text(query)
        self.shards = list(shards) if shards is not None else None
        # Device fencing on: every evaluated tree and megakernel launch
        # is bracketed by a CUDA event pair and waited on, so deviceS is
        # the card's time, not the enqueue time. Off: no event, no sync.
        self.sample_device = bool(sample_device)
        # forced = explicit ?profile=true: the profile embeds in the
        # response, propagates to remote nodes, and is never deduped by
        # the coalescer.
        self.forced = bool(forced)
        self.trace_id = trace_id
        self.started_at = time.time()
        self.duration: Optional[float] = None
        self.error: Optional[str] = None
        self.ops: List[ProfileNode] = []
        self._cur: Optional[ProfileNode] = None
        # finish_op indexes ops RELATIVE to the dispatch run that
        # created them: the cluster path reuses one profile across an
        # execute() per PQL call, so per-run indices must rebase or the
        # second call's finalize would land on the first call's nodes.
        self._op_base = 0
        self.jit_hits = 0
        self.jit_misses = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.totals = {"plan": 0.0, "dispatch": 0.0, "device": 0.0,
                       "materialize": 0.0}
        self.coalesced: Optional[Dict[str, Any]] = None
        # Request-timeline handle (utils/timeline._TimelineRequest or
        # None): the API layer attaches it so executor/coalescer/
        # cluster seams — which already carry the profile — can record
        # stage slices without any new plumbing of their own.
        self.timeline: Any = None
        # Largest same-signature fusion group this query's evals ran
        # in (None = nothing fused; see Executor.execute_batch).
        self.fused_batch: Optional[int] = None
        self._frag_lock = make_lock("QueryProfile._frag_lock")
        self.node_fragments: Dict[str, Any] = {}
        # Fragments the query read, (index, field, view, shard): a slow
        # record joins them with the workload recorder's standings.
        self.touched: Dict[tuple, None] = {}

    # ------------------------------------------------ executor-facing hooks

    # Touched-fragment keys kept per profile: every operand of a
    # realistic tree, without a 1024-shard sweep bloating ring records.
    TOUCHED_CAP = 64

    def touch_fragments(self, index: str, field: str, view: str,
                        shards) -> None:
        """Note fragments an evaluation or a TopN sweep read."""
        for s in shards:
            if len(self.touched) >= self.TOUCHED_CAP:
                return
            self.touched[(index, field, view, int(s))] = None

    def mark_dispatch(self) -> None:
        """A dispatch run begins: ops appended from here on belong to
        it, and the matching finalize's finish_op(i) resolves against
        this base (called by Executor._dispatch_query)."""
        self._op_base = len(self.ops)

    def begin_op(self, name: str) -> ProfileNode:
        """Open the op node for one PQL call (dispatch phase). Nodes are
        appended in call order — finalize addresses them by index
        relative to the last mark_dispatch."""
        node = ProfileNode(name)
        self.ops.append(node)
        self._cur = node
        return node

    def end_op(self, node: ProfileNode, dispatch_s: float) -> None:
        node.attrs["dispatchS"] = dispatch_s
        self.totals["dispatch"] += dispatch_s
        self._cur = None

    def finish_op(self, i: int, materialize_s: float,
                  d2h_bytes: int = 0) -> None:
        """Close op i OF THE CURRENT DISPATCH RUN with its
        finalize-phase costs (blocking fetch + host-side result
        build)."""
        i += self._op_base
        if i < len(self.ops):
            op = self.ops[i]
            op.attrs["materializeS"] = materialize_s
            if d2h_bytes:
                op.attrs["d2hBytes"] = d2h_bytes
        self.totals["materialize"] += materialize_s
        self.d2h_bytes += int(d2h_bytes)

    def tree(self, mode: str, sig: str, jit_hit: Optional[bool],
             plan_s: float, h2d_bytes: int, n_shards: int) -> ProfileNode:
        """One evaluated tree (Executor._eval_node). Child of the
        current op when one is open (it always is on the query path).
        ``jit_hit=None`` means not yet known: a staged eval is planned
        before its group runs; tree_jit() closes the field then."""
        parent = self._cur
        node = (parent.child(f"eval:{mode}") if parent is not None
                else ProfileNode(f"eval:{mode}"))
        if parent is None:
            self.ops.append(node)
        node.attrs["sig"] = sig[:200]
        node.attrs["planS"] = plan_s
        node.attrs["shards"] = n_shards
        if h2d_bytes:
            node.attrs["h2dBytes"] = h2d_bytes
        if jit_hit is not None:
            self.tree_jit(node, jit_hit)
        self.totals["plan"] += plan_s
        self.h2d_bytes += int(h2d_bytes)
        return node

    def tree_jit(self, node: ProfileNode, jit_hit: bool) -> None:
        node.attrs["jit"] = "hit" if jit_hit else "miss"
        if jit_hit:
            self.jit_hits += 1
        else:
            self.jit_misses += 1

    def tree_h2d(self, node: ProfileNode, h2d_bytes: int) -> None:
        """Late upload attribution for staged evals (the plan upload
        happens at the collector's flush, after tree() recorded 0)."""
        if h2d_bytes:
            node.attrs["h2dBytes"] = \
                node.attrs.get("h2dBytes", 0) + h2d_bytes
            self.h2d_bytes += int(h2d_bytes)

    def set_fused(self, batch: int) -> None:
        """This query's terminal eval ran inside a fused batch of
        `batch` same-signature queries (largest group wins when a
        multi-call query fused several evals). Surfaces at top level
        in to_json so the slow-query ring records group size without
        walking the tree."""
        self.fused_batch = max(self.fused_batch or 0, int(batch))

    def tree_dispatch(self, node: ProfileNode, dispatch_s: float) -> None:
        node.attrs["dispatchS"] = dispatch_s

    def tree_device(self, node: ProfileNode, device_s: float) -> None:
        node.attrs["deviceS"] = device_s
        self.totals["device"] += device_s

    # -------------------------------------------------- server-facing hooks

    def set_coalesced(self, batch: int, queue_wait_s: float) -> None:
        self.coalesced = {"batch": batch, "queueWaitS": queue_wait_s}

    def add_node_fragment(self, node_id: str, fragment: Any) -> None:
        """Adopt a remote node's profile fragment (cluster fan-out;
        called from per-node scatter threads)."""
        with self._frag_lock:
            self.node_fragments[node_id] = fragment

    def close(self, duration: float, error: Optional[BaseException] = None
              ) -> None:
        if self.duration is None:
            self.duration = duration
            if error is not None:
                self.error = f"{type(error).__name__}: {error}"

    def annotate_span(self, span) -> None:
        """Summarize onto an open tracer span (RecordingTracer Span.set)
        so exported traces carry the device/host split too."""
        if span is None:
            return
        span.set("profile.planS", self.totals["plan"])
        span.set("profile.dispatchS", self.totals["dispatch"])
        span.set("profile.materializeS", self.totals["materialize"])
        if self.sample_device:
            span.set("profile.deviceS", self.totals["device"])
        span.set("profile.jitMisses", self.jit_misses)
        span.set("profile.h2dBytes", self.h2d_bytes)
        span.set("profile.d2hBytes", self.d2h_bytes)
        if self.fused_batch:
            span.set("profile.fusedBatch", self.fused_batch)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "index": self.index,
            "pql": self.pql,
            "startedAt": self.started_at,
            "deviceSampled": self.sample_device,
            "jit": {"hits": self.jit_hits, "misses": self.jit_misses},
            "h2dBytes": self.h2d_bytes,
            "d2hBytes": self.d2h_bytes,
            "totals": {"planS": self.totals["plan"],
                       "dispatchS": self.totals["dispatch"],
                       "deviceS": self.totals["device"],
                       "materializeS": self.totals["materialize"]},
            "ops": [op.to_json() for op in self.ops],
        }
        if self.duration is not None:
            out["durS"] = self.duration
        if self.shards is not None:
            out["shards"] = self.shards
        if self.trace_id:
            out["traceId"] = self.trace_id
        if self.coalesced:
            out["coalesced"] = self.coalesced
        if self.fused_batch:
            out["fusedBatch"] = self.fused_batch
        if self.error:
            out["error"] = self.error
        with self._frag_lock:
            if self.node_fragments:
                out["nodes"] = dict(self.node_fragments)
        return out


class Profiler:
    """Process-wide profiling policy + sinks (one per API instance).

    ``begin`` is on the path of EVERY query: it builds a passive
    QueryProfile (a few host-side objects; no device interaction) and
    decides device sampling. ``observe`` is the single funnel every
    query path reports through — it feeds the stats client, maintains
    the process-wide retrace counter, and keeps the slow-query ring
    (replacing the previously copy-pasted SLOW QUERY printf blocks in
    server/api.py)."""

    def __init__(self, stats=None, tracer=None):
        from pilosa_tpu_torch.utils.stats import NopStatsClient
        from pilosa_tpu_torch.utils.tracing import NopTracer
        self.stats = stats or NopStatsClient()
        self.tracer = tracer or NopTracer()
        self.sample_every = 0   # fence 1-in-N unforced queries; 0 = none
        self._lock = make_lock("Profiler._lock")
        self._seq = 0
        self._ring: deque = deque(maxlen=128)
        # Cumulative slow-query count: the ring is bounded (its length
        # saturates at capacity), so rate consumers — /internal/health,
        # the fleet totals — need the running total.
        self.slow_total = 0

    def configure(self, sample_every: Optional[int] = None,
                  ring_size: Optional[int] = None) -> None:
        if sample_every is not None:
            # Under the lock: begin() divides by it inside the same
            # critical section that bumps _seq.
            with self._lock:
                self.sample_every = max(0, int(sample_every))
            # The roofline plane scales its total-device-time estimate
            # by the fence rate (the sampled="true" bias warning made
            # quantitative).
            from pilosa_tpu_torch.utils.roofline import ROOFLINE
            ROOFLINE.note_sample_every(self.sample_every)
        if ring_size is not None:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(1, int(ring_size)))

    # ----------------------------------------------------------- lifecycle

    def begin(self, index: str, query: Any,
              shards: Optional[Sequence[int]] = None,
              force: bool = False) -> QueryProfile:
        sample = bool(force)
        if not sample and self.sample_every > 0:
            with self._lock:
                self._seq += 1
                sample = self._seq % self.sample_every == 0
        tid = getattr(self.tracer, "current_trace_id", lambda: None)()
        return QueryProfile(index, query, shards, sample_device=sample,
                            forced=bool(force), trace_id=tid)

    def observe(self, index: str, query: Any, duration: float,
                profile: Optional[QueryProfile] = None,
                error: Optional[BaseException] = None,
                long_query_time: float = 0.0, logger=None,
                kind: str = "query") -> None:
        """Report one finished query: stats feed + slow-query handling.
        Safe on every path (never raises into the serving path)."""
        p = profile
        if p is not None:
            p.close(duration, error)
        if p is not None and p.ops:
            # Only profiles that recorded executor work feed the series:
            # a coalescer-deduped request executed nothing itself and
            # would dilute the timing distributions with zeros.
            st = self.stats
            st.timing("executor.plan", p.totals["plan"])
            st.timing("executor.dispatch", p.totals["dispatch"])
            st.timing("executor.materialize", p.totals["materialize"])
            if p.sample_device:
                # Fed ONLY by sampled fences (1-in-N + forced), never
                # total device time: the label says so, and the gauge
                # beside it carries the rate a reader must scale by
                # (0 = only ?profile=true fences; see the roofline
                # plane's deviceSecondsEstimate for the scaled view).
                st.with_tags("sampled:true").timing(
                    "executor.device", p.totals["device"])
                st.gauge("executor.device_sample_every",
                         self.sample_every)
            if p.jit_hits:
                st.count("executor.jit_hit", p.jit_hits)
            if p.jit_misses:
                st.count("executor.jit_miss", p.jit_misses)
                st.count("executor.retrace", p.jit_misses)
            if p.h2d_bytes:
                st.count("executor.h2d_bytes", p.h2d_bytes)
            if p.d2h_bytes:
                st.count("executor.d2h_bytes", p.d2h_bytes)
        if long_query_time > 0 and duration > long_query_time:
            if logger is not None:
                if kind == "batch":
                    logger.printf("%.3fs SLOW BATCH [%s]", duration, query)
                else:
                    logger.printf("%.3fs SLOW QUERY [%s] %r", duration,
                                  index, pql_text(query, 500))
            self.record_slow(index, query, duration, profile=p,
                             error=error, kind=kind)

    def record_slow(self, index: str, query: Any, duration: float,
                    profile: Optional[QueryProfile] = None,
                    error: Optional[BaseException] = None,
                    kind: str = "query",
                    trace_id: Optional[str] = None) -> None:
        """`trace_id` cross-links profile-less records (the HTTP SLO
        layer's slow non-query endpoints) into the timeline plane: the
        ring record's traceId opens the request in
        /debug/timeline?trace=... and /cluster/timeline/{trace}."""
        rec: Dict[str, Any] = {
            "time": time.time(),
            "durS": duration,
            "index": index,
            "query": pql_text(query, 500),
            "kind": kind,
        }
        if trace_id:
            rec["traceId"] = trace_id
        if profile is not None:
            if profile.trace_id:
                rec["traceId"] = profile.trace_id
            if profile.shards is not None:
                rec["shards"] = profile.shards
            rec["profile"] = profile.to_json()
            if profile.touched:
                # The workload recorder's standings of the fragments
                # this query read, hottest first.
                from pilosa_tpu_torch.utils.hotspots import WORKLOAD
                hot = WORKLOAD.fragment_ranks(list(profile.touched))
                if hot:
                    rec["hotFragments"] = hot
        if error is not None:
            rec["error"] = f"{type(error).__name__}: {error}"
        with self._lock:
            self._ring.append(rec)
            self.slow_total += 1
        self.stats.count("executor.slow_query", 1)

    def slow_queries(self) -> List[Dict[str, Any]]:
        """Most-recent-first snapshot of the slow-query ring (served at
        GET /debug/queries)."""
        with self._lock:
            return list(reversed(self._ring))

    def ring_count(self) -> int:
        """Slow-query records currently held (the health plane reads
        this without copying the ring)."""
        with self._lock:
            return len(self._ring)

    def dump(self, logger, last: int = 10) -> int:
        """Write the most recent `last` slow-query records to the log —
        the SIGTERM drain calls this so a shutdown never discards the
        buffered evidence of what was slow. Returns records written."""
        recs = self.slow_queries()[:max(0, int(last))]
        if logger is not None and recs:
            logger.printf("profiler: dumping %d slow-query record(s) "
                          "on shutdown", len(recs))
            for r in recs:
                logger.printf(
                    "profiler: %.3fs [%s] %s", r.get("durS", 0.0),
                    r.get("index", "?"), r.get("query", ""))
        return len(recs)
