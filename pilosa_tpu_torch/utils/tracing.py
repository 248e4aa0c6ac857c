"""Tracing facade, after the JAX package's ``utils/tracing.py``.

A span-tree recorder with W3C ``traceparent`` header propagation (the
legacy ``X-Trace-Id`` spelling is still emitted and accepted), pluggable
like the reference's opentracing adapter: ``NopTracer``,
``RecordingTracer`` (the newest finished root spans, in process, within
a byte budget) and ``ExportingTracer`` (OTLP/HTTP JSON, which Jaeger's
``:4318/v1/traces`` and the OpenTelemetry collector ingest, from a
background thread with head sampling). The port's server reads
``traceparent`` from each request and sends it back on the response.

Each node has one tracer: the holder is given it or makes one
(``Holder.tracer``), hands it to its indexes and fields, and the API
adopts it. Code below the API opens its spans with the module's
``span()``, which nests them under the span open on the calling thread
(in whichever tracer opened it) and records nothing where none is open;
``span_in(tracer, ...)`` opens a root in the node's tracer instead. While
a ``torch.profiler`` records, every span is also a ``record_function``
range of its name, so a profiler trace carries the program's spans on
its own clock; a span's ``start`` is on that clock too (Unix time). The
module does not import torch: where torch is not loaded, no profiler
records, so the CLI's file tools stay free of it.
"""

from __future__ import annotations

import contextlib
import json
import random
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from pilosa_tpu_torch.utils.locks import make_lock

# W3C Trace Context (https://www.w3.org/TR/trace-context/): the
# header every OTel-aware proxy/collector understands, so traces stay
# joined across non-pilosa hops too. Format:
#   traceparent: 00-<32 hex trace-id>-<16 hex parent-span-id>-<flags>
TRACEPARENT_HEADER = "traceparent"
# Pre-traceparent header, still EMITTED and ACCEPTED for one release
# so a mixed-version cluster keeps correlating in both directions
# during a rolling upgrade; both sides drop with the window.
TRACE_HEADER = "X-Trace-Id"

# Host bytes of finished root spans a RecordingTracer keeps (by
# ``Span.nbytes``): a few thousand request trees, the newest.
RING_BYTES = 4 << 20

# The tracer whose span is open on this thread, if any: ``span()`` nests
# under it.
_ACTIVE = threading.local()
_NO_SPAN = contextlib.nullcontext()
# Loaded with torch; its ``_is_profiler_enabled`` is set while any
# profiler records.
_PROFILER_MODULE = "torch.autograd.profiler"


def new_span_id() -> str:
    """16 hex digits of a random 64-bit id, never all zero."""
    return f"{random.getrandbits(64) or 1:016x}"


def new_trace_id() -> str:
    """32 hex digits of a random 128-bit id, never all zero (a W3C trace
    id; ``uuid4().hex`` costs several times more)."""
    return f"{random.getrandbits(128) or 1:032x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    """00-<trace>-<span>-01 (flags 01 = sampled: we always record
    locally; export sampling is decided at root-span close)."""
    return (f"00-{trace_id[:32].ljust(32, '0')}"
            f"-{span_id[:16].ljust(16, '0')}-01")


def parse_traceparent(value: str) -> Optional[str]:
    """Trace id from a traceparent header, or None when malformed
    (wrong field count/width, non-hex, all-zero trace id, or the
    reserved version ff). Malformed headers fall back to a fresh local
    trace rather than poisoning the export pipeline."""
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[:4]
    hexdigits = set("0123456789abcdef")
    if len(version) != 2 or not set(version) <= hexdigits \
            or version == "ff":
        return None
    # Version 00 defines exactly 4 fields; trailing fields make the
    # header invalid (future versions may legitimately append them).
    if version == "00" and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not set(trace_id) <= hexdigits \
            or trace_id == "0" * 32:
        return None
    # Parent span id must be 16 hex and not all-zero; flags 2 hex.
    if len(span_id) != 16 or not set(span_id) <= hexdigits \
            or span_id == "0" * 16:
        return None
    if len(flags) != 2 or not set(flags) <= hexdigits:
        return None
    return trace_id


class Span:
    """``start``/``end`` are wall-clock *export anchors*; durations are
    pure ``time.perf_counter()`` deltas (``pc_start``/``pc_end``), so an
    NTP step mid-span cannot corrupt them. ``end`` is derived at close
    as ``start + duration()`` — one wall-clock read per span, never a
    second one the clock could have stepped between. ``span_id`` is
    drawn when first read (a propagated parent, an export)."""

    __slots__ = ("name", "trace_id", "_span_id", "start", "end",
                 "pc_start", "pc_end", "attrs", "children", "tree")

    def __init__(self, name: str, trace_id: str, attrs: dict,
                 tree: Optional[List[int]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self._span_id: Optional[str] = None
        self.start = time.time()
        self.end: Optional[float] = None
        self.pc_start = time.perf_counter()
        self.pc_end: Optional[float] = None
        self.attrs = attrs
        self.children: List["Span"] = []
        # The whole tree's ``nbytes``, one cell shared by its spans and
        # kept as they are made and annotated: the ring sizes a
        # finished root without walking it.
        size = 160 + len(name)
        for k, v in attrs.items():
            size += _attr_bytes(k, v)
        if tree is None:
            tree = [0]
        tree[0] += size
        self.tree = tree

    @property
    def span_id(self) -> str:
        if self._span_id is None:
            self._span_id = new_span_id()
        return self._span_id

    def duration(self) -> float:
        return (self.pc_end if self.pc_end is not None
                else time.perf_counter()) - self.pc_start

    def close(self) -> None:
        """Stamp the monotonic end and derive the wall-clock end from
        the span's own anchor + duration (skew-proof)."""
        if self.pc_end is None:
            self.pc_end = time.perf_counter()
        self.end = self.start + self.duration()

    def nbytes(self) -> int:
        """Rough retained-memory estimate for the whole subtree (the
        tracer ring's memory-ledger registration); of a root, what
        ``tree`` holds."""
        n = 160 + len(self.name)
        for k, v in self.attrs.items():
            n += _attr_bytes(k, v)
        for c in self.children:
            n += c.nbytes()
        return n

    def add_closed(self, name: str, pc_start: float, pc_end: float,
                   **attrs: Any) -> "Span":
        """Append a finished child whose interval was stamped elsewhere,
        by ``time.perf_counter()`` readings of this or another thread:
        its wall-clock start follows from this span's anchor."""
        child = Span(name, self.trace_id, attrs, self.tree)
        child.pc_start, child.pc_end = pc_start, pc_end
        child.start = self.start + (pc_start - self.pc_start)
        child.end = child.start + (pc_end - pc_start)
        self.children.append(child)
        return child

    def set(self, key: str, value: Any) -> None:
        """Annotate an open span with a value only known mid-span (e.g.
        the coalescer flush's post-dedup unique-query count) — the
        opentracing Span.SetTag analog the reference uses on its query
        spans."""
        if key in self.attrs:
            self.tree[0] -= _attr_bytes(key, self.attrs[key])
        self.tree[0] += _attr_bytes(key, value)
        self.attrs[key] = value


def _attr_bytes(key: str, value: Any) -> int:
    """An attribute's bytes as the ring counts them: a string by its
    length, any other value as 24."""
    return len(key) + (len(value) if type(value) is str else 24) + 32


class NopTracer:
    def span(self, name: str, **attrs: Any):
        return _NO_SPAN

    def inject(self, headers: Dict[str, str]) -> None:
        pass

    def extract(self, headers: Dict[str, str]) -> None:
        pass


def span(name: str, **attrs: Any):
    """A span under the one open on this thread, in that span's tracer;
    nothing (it yields None) where no span is open."""
    tracer = getattr(_ACTIVE, "tracer", None)
    return _NO_SPAN if tracer is None else _SpanCtx(tracer, name, attrs)


def span_in(tracer: Any, name: str, **attrs: Any):
    """``span()``, or a root in ``tracer`` (the node's; None records
    nothing) where no span is open on this thread."""
    active = getattr(_ACTIVE, "tracer", None)
    if active is not None:
        return _SpanCtx(active, name, attrs)
    return _NO_SPAN if tracer is None else tracer.span(name, **attrs)


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    tracer = getattr(_ACTIVE, "tracer", None)
    stack = tracer._stack() if tracer is not None else None
    return stack[-1] if stack else None


class _SpanCtx:
    """One span of a RecordingTracer while it is open: a child of the
    thread's innermost open span, or a root that makes its tracer the
    thread's active one. While a torch profiler records (in any thread:
    ``_is_profiler_enabled`` is process-wide, where
    ``torch.autograd._profiler_enabled()`` is per thread), the span is
    also a ``record_function`` range of its name; where torch is not
    loaded, none records."""

    __slots__ = ("tracer", "name", "attrs", "span", "stack", "prev", "rf")

    def __init__(self, tracer: "RecordingTracer", name: str,
                 attrs: dict) -> None:
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.rf = None

    def __enter__(self) -> Span:
        tracer = self.tracer
        stack = self.stack = tracer._stack()
        if stack:
            trace_id = stack[0].trace_id
        else:
            trace_id = getattr(tracer._local, "trace_id", None) \
                or new_trace_id()
            self.prev = getattr(_ACTIVE, "tracer", None)
            _ACTIVE.tracer = tracer
        if stack:
            parent = stack[-1]
            span = Span(self.name, trace_id, self.attrs, parent.tree)
            parent.children.append(span)
        else:
            span = Span(self.name, trace_id, self.attrs)
        self.span = span
        stack.append(span)
        prof = sys.modules.get(_PROFILER_MODULE)
        if prof is not None and prof._is_profiler_enabled:
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return span

    def __exit__(self, *exc: Any) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        span = self.span
        span.close()
        stack = self.stack
        stack.pop()
        if not stack:
            _ACTIVE.tracer = self.prev
            self.tracer._finish_root(span)


class RecordingTracer:
    """Keeps the newest finished root spans, within ``ring_bytes`` bytes
    of their trees by ``Span.nbytes`` (at least the newest one), for
    inspection (the in-process analog of the reference's Jaeger
    wiring). ``roots_closed`` counts every root that finished and
    ``roots_evicted`` those the ring let go, so a reader can tell
    whether the ring still holds every root since a point it marked."""

    def __init__(self, ring_bytes: int = RING_BYTES) -> None:
        self.ring_bytes = ring_bytes
        self.finished: Deque[Span] = deque()
        self._sizes: Deque[int] = deque()
        self.roots_closed = 0
        self.roots_evicted = 0
        self._local = threading.local()
        self._lock = make_lock("RecordingTracer._lock")
        # Bytes retained by `finished` (span trees), maintained
        # incrementally under _lock — the memory ledger's `telemetry`
        # registration reads it without walking the ring.
        self._ring_bytes = 0

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    def _finish_root(self, span: Span) -> None:
        nbytes = span.tree[0]
        with self._lock:
            self.finished.append(span)
            self._sizes.append(nbytes)
            self._ring_bytes += nbytes
            self.roots_closed += 1
            while self._ring_bytes > self.ring_bytes \
                    and len(self.finished) > 1:
                self.finished.popleft()
                self._ring_bytes -= self._sizes.popleft()
                self.roots_evicted += 1

    def mark(self) -> tuple:
        """(Unix time, roots closed, roots evicted, the ring's roots
        oldest first) at this moment."""
        with self._lock:
            return (time.time(), self.roots_closed, self.roots_evicted,
                    list(self.finished))

    def inject(self, headers: Dict[str, str]) -> None:
        """Stamp outgoing node-to-node requests with W3C traceparent:
        the root span's trace id + the innermost open span as parent.
        With no span open, an adopted thread trace id (extract(), or
        adopt() on a scatter-gather worker) still propagates — the
        coordinator's fan-out legs run on threads that never opened a
        span, and before this fallback their query POSTs carried no
        trace context at all (the old cross-node stitching only worked
        through a stale-thread-local side channel). The legacy header
        rides along for the same one-release window extract keeps
        accepting it — a not-yet-upgraded peer only reads X-Trace-Id,
        and a mixed-version cluster must keep correlating in BOTH
        directions during a rolling upgrade."""
        stack = self._stack()
        if stack:
            headers[TRACEPARENT_HEADER] = format_traceparent(
                stack[0].trace_id, stack[-1].span_id)
            headers[TRACE_HEADER] = stack[0].trace_id
            return
        tid = getattr(self._local, "trace_id", None)
        if tid:
            # No open span to parent under: mint a synthetic parent id
            # (the W3C field is mandatory; non-recording propagation-
            # only contexts do the same in mainstream tracers).
            headers[TRACEPARENT_HEADER] = format_traceparent(
                tid, new_span_id())
            headers[TRACE_HEADER] = tid

    def adopt(self, trace_id: Optional[str]) -> None:
        """Adopt a trace id on THIS thread (scatter-gather workers call
        it with the coordinator request's id so their outgoing legs
        inject the same trace the request arrived under)."""
        self._local.trace_id = trace_id

    def extract(self, headers: Dict[str, str]) -> None:
        """Adopt an incoming trace context: W3C traceparent first, the
        legacy X-Trace-Id spelling as a fallback (accepted for one
        release so mixed-version clusters keep correlating). A request
        carrying NEITHER header clears any previously adopted id —
        handler threads are reused across keep-alive requests, and a
        stale id would stitch unrelated requests into one trace."""
        self._local.trace_id = None
        tp = headers.get(TRACEPARENT_HEADER)
        if tp:
            tid = parse_traceparent(tp)
            if tid is not None:
                self._local.trace_id = tid
                return
        tid = headers.get(TRACE_HEADER)
        if tid:
            self._local.trace_id = _sanitize_trace_id(tid)

    def current_trace_id(self) -> Optional[str]:
        """Trace id of the thread's open root span (or the id extracted
        from the incoming request, before any span opened) — lets the
        query profiler stamp its slow-query records with the same id
        the exported spans carry."""
        stack = self._stack()
        if stack:
            return stack[0].trace_id
        return getattr(self._local, "trace_id", None)

    def ensure_trace_id(self) -> str:
        """The thread's current trace id, minting (and adopting) one
        when none was extracted — so the timeline recorder, the
        profiler AND the spans a request subsequently opens all carry
        the SAME id even for requests that arrived without a
        traceparent header."""
        tid = self.current_trace_id()
        if tid is None:
            tid = new_trace_id()
            self._local.trace_id = tid
        return tid

    def ring_nbytes(self) -> int:
        with self._lock:
            return max(0, self._ring_bytes)

    def register_memory(self, ledger: Optional[Any] = None) -> None:
        """Register the finished-span ring with the memory ledger
        (category ``telemetry``) so /debug/memory totals stay provable."""
        if ledger is None:
            from pilosa_tpu_torch.utils.memledger import LEDGER as ledger
        with self._lock:
            nbytes = max(0, self._ring_bytes)
            count = len(self.finished)
        ledger.register("telemetry", "tracer_ring", nbytes, owner=self,
                        kind="tracer", entries=count)

    def dump(self, logger: Optional[Any], last: int = 10) -> int:
        """Write the most recent `last` finished root spans to the log
        (the SIGTERM drain path — buffered spans that never exported
        still leave evidence). Returns spans written."""
        with self._lock:
            spans = list(self.finished)[-int(last):] if last > 0 else []
        if logger is not None and spans:
            logger.printf("tracer: dumping %d finished span(s) on "
                          "shutdown", len(spans))
            for s in spans:
                logger.printf("tracer: %.3fs %s trace=%s",
                              s.duration(), s.name, s.trace_id)
        return len(spans)


def _sanitize_trace_id(tid: str) -> str:
    """Trace ids must be 32 hex chars on the OTLP wire. Our own nodes
    propagate 32 hex digits, but the header is client-settable; a non-hex
    value is re-hashed deterministically (same junk id on every node
    still correlates) instead of poisoning a whole export batch."""
    t = tid.strip().lower()
    if len(t) == 32 and all(c in "0123456789abcdef" for c in t):
        return t
    import hashlib
    return hashlib.md5(tid.encode()).hexdigest()


def spans_to_otlp(spans: List[Span], service_name: str) -> dict:
    """Encode finished span trees as an OTLP/HTTP JSON
    ExportTraceServiceRequest (the opentelemetry-proto JSON mapping:
    hex ids, stringified uint64 nanos, keyed attribute values). This is
    the rebuild's analog of the reference's Jaeger span reporter
    (server/config.go:110-118 wires jaeger-client-go)."""
    flat = []

    def walk(span: Span, parent_id: str, anchor_wall: float,
             anchor_pc: float) -> None:
        # One wall-clock anchor PER TRACE (the root span's): every
        # descendant's export timestamps are monotonic offsets from it,
        # so an NTP step mid-trace shifts nothing within the trace.
        start = anchor_wall + (span.pc_start - anchor_pc)
        end = start + span.duration()
        entry = {
            "traceId": span.trace_id[:32].ljust(32, "0"),
            "spanId": span.span_id,
            "name": span.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(start * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": [
                {"key": str(k), "value": {"stringValue": str(v)}}
                for k, v in span.attrs.items()],
        }
        if parent_id:
            entry["parentSpanId"] = parent_id
        flat.append(entry)
        for child in span.children:
            walk(child, span.span_id, anchor_wall, anchor_pc)

    for s in spans:
        walk(s, "", s.start, s.pc_start)
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{"scope": {"name": "pilosa_tpu_torch"},
                        "spans": flat}],
    }]}


class ExportingTracer(RecordingTracer):
    """RecordingTracer that ships finished root span trees to an
    OTLP/HTTP endpoint (e.g. Jaeger's :4318/v1/traces) from a background
    thread. Batches up to `batch_size` spans or `flush_interval`
    seconds, whichever first; export failures are dropped after a log
    line — tracing must never stall queries."""

    def __init__(self, endpoint: str, service_name: str = "pilosa-tpu",
                 ring_bytes: int = RING_BYTES, batch_size: int = 64,
                 flush_interval: float = 5.0,
                 logger: Optional[Any] = None,
                 sampler_type: str = "const",
                 sampler_param: float = 1.0) -> None:
        super().__init__(ring_bytes=ring_bytes)
        self.endpoint = endpoint
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.logger = logger
        # Head sampling (reference SamplerType/SamplerParam,
        # server/config.go:110-118, jaeger sampler semantics): decides
        # per ROOT span whether its tree exports. Exporting every span
        # is untenable at production query rates; local recording
        # (/debug introspection) keeps working for unsampled traces.
        if sampler_type not in ("const", "probabilistic", "ratelimiting"):
            raise ValueError(f"unknown sampler type {sampler_type!r}")
        self.sampler_type = sampler_type
        self.sampler_param = float(sampler_param)
        # The ratelimiting token bucket has its own lock: sampling
        # decisions happen on every request thread at root-span close
        # and must not contend with the exporter thread holding
        # _pending_lock through a drain.
        self._rl_tokens = self.sampler_param  # ratelimiting bucket
        self._rl_stamp = time.monotonic()
        self._rl_lock = make_lock("ExportingTracer._rl_lock")
        self._pending: List[Span] = []
        self._pending_lock = make_lock("ExportingTracer._pending_lock")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sampled(self, span: Span) -> bool:
        if self.sampler_type == "const":
            return self.sampler_param != 0
        if self.sampler_type == "probabilistic":
            # Deterministic on trace id: every node in the cluster makes
            # the SAME decision for one propagated trace, so sampled
            # traces export complete (jaeger's probabilistic sampler
            # hashes the same way for the same reason).
            import hashlib
            h = int.from_bytes(hashlib.md5(
                span.trace_id.encode()).digest()[:8], "big")
            return h / 2**64 < self.sampler_param
        # ratelimiting: token bucket of sampler_param traces/second.
        with self._rl_lock:
            now = time.monotonic()
            self._rl_tokens = min(
                max(self.sampler_param, 1.0),
                self._rl_tokens + (now - self._rl_stamp)
                * self.sampler_param)
            self._rl_stamp = now
            if self._rl_tokens >= 1.0:
                self._rl_tokens -= 1.0
                return True
            return False

    def _finish_root(self, span: Span) -> None:
        super()._finish_root(span)
        # Queued on the error path too: traces of FAILED requests are
        # the ones operators need most.
        if self._sampled(span):
            with self._pending_lock:
                self._pending.append(span)
                full = len(self._pending) >= self.batch_size
            if full:
                self._wake.set()

    def _drain(self) -> List[Span]:
        with self._pending_lock:
            out, self._pending = self._pending, []
        return out

    def flush(self) -> bool:
        """Export everything pending now. Returns False on failure
        (spans are dropped, not retried — bounded memory)."""
        spans = self._drain()
        if not spans:
            return True
        body = json.dumps(
            spans_to_otlp(spans, self.service_name)).encode()
        try:
            import urllib.request
            req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
            return True
        except Exception as e:
            if self.logger is not None:
                self.logger.printf("otlp export failed (%d spans "
                                   "dropped): %s", len(spans), e)
            return False

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.is_set():
                self._wake.wait(self.flush_interval)
                self._wake.clear()
                self.flush()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="otlp-exporter")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush()
