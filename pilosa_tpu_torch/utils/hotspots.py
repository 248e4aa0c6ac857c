"""Workload recorder: access heatmaps, write churn and the
cache-opportunity estimator, after the JAX package's
``utils/hotspots.py``.

- The executor records each staged or eager read per (index, field,
  view, shard) fragment and the rows it names, and one query signature
  per terminal eval: its fingerprint (tree signature, row ids, predicate
  values) under the operand views' generation, the same (key,
  generation) pair the result cache's eval tier uses. Fragments record
  their writes; views record the device-bank rebuilds writes forced. The
  serving coalescer records request identities, so repeated reads are
  measured across requests over a rolling window.
- ``view_read_rates`` sums the decayed fragment read rates per view: the
  access axis of the demotion score that ``BankBudget`` eviction and the
  ``LayoutManager`` pass rank banks by.
- Counters are decayed (a rate halves every ``half_life_s`` of quiet),
  cumulative, and bounded: fragments, rows and signatures live in LRU
  maps whose evicted counts fold into ``evicted``, so
  ``totals.X == tracked.X + evicted.X`` holds in every snapshot.
- ``snapshot`` is the ``/debug/hotspots`` document: top fragments, rows,
  signatures and churn, the repeat windows, and the opportunity report
  (repeats at an unchanged generation times the observed eval seconds,
  ``note_eval_seconds``; and the resident banks in density-by-access
  quadrants from the memory ledger).

Host-only module: dict arithmetic under a leaf lock, no device touch.
The clock is injectable, so the decay is testable.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pilosa_tpu_torch.utils.fingerprint import digest
from pilosa_tpu_torch.utils.locks import make_lock
from pilosa_tpu_torch.utils.tracing import span

# Row identities recorded per record_read call: queries naming more
# rows than this (chunked TopN sweeps over 500k-row fields) record the
# aggregate rowsScanned count instead of per-row touches — identity
# tracking is for *named* hot rows, not full-bank scans.
ROW_CAP_PER_CALL = 64


class _Decayed:
    """Cumulative count + exponentially decayed rate. The rate halves
    every ``half_life_s`` of inactivity, so it reads as "events in the
    recent past" — a fragment hammered last week and idle since scores
    ~0 while keeping its cumulative total."""

    __slots__ = ("count", "rate", "t")

    def __init__(self) -> None:
        self.count = 0
        self.rate = 0.0
        self.t = 0.0

    def add(self, n: int, now: float, half_life_s: float) -> None:
        if self.rate:
            self.rate *= math.pow(0.5, (now - self.t) / half_life_s)
        self.rate += n
        self.t = now
        self.count += n

    def value(self, now: float, half_life_s: float) -> float:
        if not self.rate:
            return 0.0
        return self.rate * math.pow(0.5, max(0.0, now - self.t)
                                    / half_life_s)


class _FragStat:
    __slots__ = ("reads", "writes", "rows_scanned", "generation",
                 "invalidations")

    def __init__(self) -> None:
        self.reads = _Decayed()
        self.writes = _Decayed()
        self.rows_scanned = 0   # aggregate sweep rows (TopN/Rows)
        self.generation: Optional[int] = None
        self.invalidations = 0  # device-bank rebuilds forced by churn


class _SigStat:
    __slots__ = ("hits", "gen", "gen_hits", "eval_s", "index",
                 "mode", "n_shards", "sig_head")

    def __init__(self, index: str, mode: str, n_shards: int,
                 sig_head: str) -> None:
        self.hits = _Decayed()
        self.gen: Any = None
        self.gen_hits = 0       # hits since the generation last moved
        self.eval_s: Optional[float] = None  # EWMA of observed seconds
        self.index = index
        self.mode = mode
        self.n_shards = n_shards
        self.sig_head = sig_head


class _Window:
    """Rolling-window repeat tracker: a deque of (t, key) pruned by age
    (and capped by event count, so a flood cannot grow it without
    bound). ``repeats`` counts arrivals whose key was already in the
    live window — the cross-request duplicate-read signal."""

    __slots__ = ("window_s", "max_events", "events", "counts",
                 "seen_total", "repeats_total")

    def __init__(self, window_s: float, max_events: int) -> None:
        self.window_s = float(window_s)
        self.max_events = int(max_events)
        self.events: deque = deque()
        self.counts: Dict[Any, int] = {}
        self.seen_total = 0
        self.repeats_total = 0

    def _drop_oldest(self) -> None:
        _, old = self.events.popleft()
        left = self.counts.get(old, 0) - 1
        if left <= 0:
            self.counts.pop(old, None)
        else:
            self.counts[old] = left

    def prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self.events and self.events[0][0] < horizon:
            self._drop_oldest()
        while len(self.events) > self.max_events:
            self._drop_oldest()

    def add(self, key: Any, now: float) -> bool:
        """Record one arrival; True when `key` was already live in the
        window (a cross-request repeat)."""
        self.prune(now)
        repeat = key in self.counts
        self.counts[key] = self.counts.get(key, 0) + 1
        self.events.append((now, key))
        if len(self.events) > self.max_events:
            self._drop_oldest()
        self.seen_total += 1
        if repeat:
            self.repeats_total += 1
        return repeat

    def snapshot(self, now: float) -> Dict[str, Any]:
        self.prune(now)
        seen = len(self.events)
        repeats = seen - len(self.counts)
        return {
            "windowS": self.window_s,
            "seen": seen,
            "repeats": repeats,
            "ratio": (repeats / seen) if seen else 0.0,
            "seenTotal": self.seen_total,
            "repeatsTotal": self.repeats_total,
        }

    def ratio(self, now: float) -> float:
        self.prune(now)
        seen = len(self.events)
        return ((seen - len(self.counts)) / seen) if seen else 0.0


class WorkloadRecorder:
    """Process-wide workload-shape registry (see module docstring).

    Thread-safe; every record method is O(keys touched) dict work under
    one leaf lock. ``enabled = False`` is the kill switch: record
    methods return before taking the lock. ``clock`` is injectable so
    decay math is testable under a synthetic clock."""

    def __init__(self, half_life_s: float = 600.0,
                 window_s: float = 300.0, max_fragments: int = 4096,
                 max_rows: int = 4096, max_signatures: int = 1024,
                 max_window_events: int = 8192,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.enabled = True
        self.stats = None  # attached by the API layer (may stay None)
        self.clock = clock
        self.half_life_s = max(0.001, float(half_life_s))
        self.top_k = 10
        self._max_fragments = max(1, int(max_fragments))
        self._max_rows = max(1, int(max_rows))
        self._max_signatures = max(1, int(max_signatures))
        self._lock = make_lock("WorkloadRecorder._lock")
        # Insertion-ordered dicts double as LRU maps (pop + reinsert on
        # touch), exactly like Executor._jit_cache.
        self._fragments: Dict[Tuple[str, str, str, int], _FragStat] = {}
        self._rows: Dict[Tuple[str, str, int], _Decayed] = {}
        self._sigs: Dict[Any, _SigStat] = {}
        # Rolling repeat windows: query fingerprints (staging time,
        # keyed (fingerprint, generation) — a repeat is only cacheable
        # at an unchanged generation) and request identities (the
        # coalescer's (index, pql, shards) keys).
        self.queries_window = _Window(window_s, max_window_events)
        self.requests_window = _Window(window_s, max_window_events)
        # Cumulative totals, independent of LRU state; eviction folds
        # an entry's counts into `_evicted` so
        # totals.X == sum(tracked) + evicted.X always holds.
        self._totals = {"fragmentReads": 0, "fragmentWrites": 0,
                        "rowTouches": 0, "rowsScanned": 0, "queries": 0,
                        "bankInvalidations": 0}
        self._evicted = {"fragmentReads": 0, "fragmentWrites": 0,
                         "rowTouches": 0, "rowsScanned": 0, "queries": 0}

    # ------------------------------------------------------------ configure

    def configure(self, enabled: Optional[bool] = None,
                  half_life_s: Optional[float] = None,
                  window_s: Optional[float] = None,
                  top_k: Optional[int] = None,
                  max_fragments: Optional[int] = None,
                  max_rows: Optional[int] = None,
                  max_signatures: Optional[int] = None) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if half_life_s is not None:
                self.half_life_s = max(0.001, float(half_life_s))
            if window_s is not None:
                self.queries_window.window_s = float(window_s)
                self.requests_window.window_s = float(window_s)
            if top_k is not None:
                self.top_k = max(1, int(top_k))
            if max_fragments is not None:
                self._max_fragments = max(1, int(max_fragments))
            if max_rows is not None:
                self._max_rows = max(1, int(max_rows))
            if max_signatures is not None:
                self._max_signatures = max(1, int(max_signatures))

    # ---------------------------------------------------------- LRU helpers

    def _frag(self, key: Tuple[str, str, str, int]) -> _FragStat:
        # Pop + reinsert on touch makes dict insertion order LRU order
        # (same dance as Executor._jit_cache); evicted entries fold
        # their counts into the evicted buckets so totals stay
        # provable.
        st = self._fragments.pop(key, None)
        if st is None:
            st = _FragStat()
        self._fragments[key] = st
        while len(self._fragments) > self._max_fragments:
            k0 = next(iter(self._fragments))
            old = self._fragments.pop(k0)
            self._evicted["fragmentReads"] += old.reads.count
            self._evicted["fragmentWrites"] += old.writes.count
            self._evicted["rowsScanned"] += old.rows_scanned
        return st

    def _row(self, key: Tuple[str, str, int]) -> _Decayed:
        st = self._rows.pop(key, None)
        if st is None:
            st = _Decayed()
        self._rows[key] = st
        while len(self._rows) > self._max_rows:
            k0 = next(iter(self._rows))
            self._evicted["rowTouches"] += self._rows.pop(k0).count
        return st

    def _sig(self, key: Any, index: str, mode: str, n_shards: int,
             sig_head: str) -> _SigStat:
        st = self._sigs.pop(key, None)
        if st is None:
            st = _SigStat(index, mode, n_shards, sig_head)
        self._sigs[key] = st
        while len(self._sigs) > self._max_signatures:
            k0 = next(iter(self._sigs))
            self._evicted["queries"] += self._sigs.pop(k0).hits.count
        return st

    # ------------------------------------------------------------ recording

    def record_read(self, index: str, field: str, view: str,
                    shards: Sequence[int],
                    rows: Optional[Sequence[int]] = None,
                    rows_scanned: int = 0) -> None:
        """One staged read over (index, field, view) × shards. `rows`
        are the row identities the read named (Row leaves, BSI planes,
        small TopN candidate sets) — capped at ROW_CAP_PER_CALL, read
        without walking the rest (a TopN passes a view's every row id);
        `rows_scanned` counts aggregate sweep rows beyond that."""
        if not self.enabled:
            return
        with span("Workload.record", kind="read"):
            now = self.clock()
            hl = self.half_life_s
            row_ids: List[int] = []
            if rows is not None:
                with span("Workload.rowIds", rows=len(rows)):
                    row_ids = list(itertools.islice(rows, ROW_CAP_PER_CALL))
                if len(rows) > ROW_CAP_PER_CALL:
                    rows_scanned += len(rows) - ROW_CAP_PER_CALL
            n_shards = len(shards)
            with self._lock:
                for s in shards:
                    self._frag((index, field, view, int(s))).reads.add(
                        1, now, hl)
                self._totals["fragmentReads"] += n_shards
                for r in row_ids:
                    self._row((index, field, int(r))).add(1, now, hl)
                self._totals["rowTouches"] += len(row_ids)
                if rows_scanned:
                    self._totals["rowsScanned"] += int(rows_scanned)
                    if shards:
                        st = self._frag((index, field, view, int(shards[0])))
                        st.rows_scanned += int(rows_scanned)
            stats = self.stats
            if stats is not None and n_shards:
                stats.count("fragment.reads", n_shards)

    def record_write(self, index: str, field: str, view: str,
                     shard: int, generation: Optional[int] = None,
                     n: int = 1) -> None:
        """`n` fragment row mutations in one batch (called by
        Fragment._touch_rows with the bumped write version — the
        generation every cache keys on). Bulk imports record once per
        (fragment, batch) with n = rows touched, so write totals keep
        per-row semantics without per-row plane calls."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            st = self._frag((index, field, view, int(shard)))
            st.writes.add(n, now, self.half_life_s)
            if generation is not None:
                st.generation = int(generation)
            self._totals["fragmentWrites"] += n
        stats = self.stats
        if stats is not None:
            stats.count("fragment.writes", n)

    def record_invalidation(self, index: str, field: str, view: str,
                            shards: Sequence[int]) -> None:
        """A cached device bank over these fragments was found stale
        (version moved) and had to patch/rebuild — the moment write
        churn actually cost device work, and exactly when a
        generation-keyed result cache would have invalidated too."""
        if not self.enabled:
            return
        with self._lock:
            for s in shards:
                self._frag((index, field, view, int(s))) \
                    .invalidations += 1
            self._totals["bankInvalidations"] += len(shards)

    def record_query(self, fingerprint: Any, generation: Any,
                     index: str, mode: str, n_shards: int,
                     sig: str = "") -> None:
        """One staged query program, identified by its semantic
        fingerprint (tree signature + row ids + predicate params) under
        the operand banks' generation — the identity a result cache
        would key on. Repeats at an unchanged generation are cacheable;
        a generation bump resets the run."""
        if not self.enabled:
            return
        with span("Workload.record", kind="query"):
            now = self.clock()
            with self._lock:
                st = self._sig(fingerprint, index, mode, n_shards,
                               str(sig)[:80])
                st.hits.add(1, now, self.half_life_s)
                if st.gen != generation:
                    st.gen = generation
                    st.gen_hits = 1
                else:
                    st.gen_hits += 1
                self._totals["queries"] += 1
                self.queries_window.add((fingerprint, generation), now)

    def note_eval_seconds(self, fingerprint: Any, seconds: float
                          ) -> None:
        """Attribute one observed eval duration (profiler dispatch +
        fenced device time when sampled) to a signature: the
        saved-seconds estimate multiplies repeats by this EWMA."""
        if not self.enabled:
            return
        with self._lock:
            st = self._sigs.get(fingerprint)
            if st is None:
                return
            if st.eval_s is None:
                st.eval_s = float(seconds)
            else:
                st.eval_s += 0.25 * (float(seconds) - st.eval_s)

    def record_request(self, key: Any) -> bool:
        """One read-only serving request (the coalescer's
        (index, pql, shards) identity). Returns True when the same
        request was already seen within the rolling window — a
        cross-request duplicate the in-batch dedup could not see."""
        if not self.enabled:
            return False
        with span("Workload.record", kind="request"):
            now = self.clock()
            with self._lock:
                return self.requests_window.add(key, now)

    # -------------------------------------------------------------- reading

    def fragment_ranks(self, keys: Sequence[Tuple[str, str, str, int]],
                       top: int = 5) -> List[Dict[str, Any]]:
        """Current read standings for `keys` (the slow-query ring's
        hotFragments annotation), hottest first."""
        now = self.clock()
        hl = self.half_life_s
        out = []
        with self._lock:
            for k in keys:
                st = self._fragments.get(tuple(k))
                if st is None:
                    continue
                out.append({"index": k[0], "field": k[1], "view": k[2],
                            "shard": int(k[3]), "reads": st.reads.count,
                            "readRate": st.reads.value(now, hl)})
        out.sort(key=lambda d: (-d["readRate"], -d["reads"]))
        return out[:max(0, int(top))]

    def view_read_rates(self) -> Dict[Tuple[str, str, str], float]:
        """Summed decayed fragment read rate per (index, field, view)
        — the access axis of the demotion ranking, shared by the bank
        quadrants, the BankBudget eviction scorer and the hybrid-
        layout re-layout pass (core/layout.py). One pass over the
        tracked fragments under the leaf lock; host dict work only."""
        now = self.clock()
        hl = self.half_life_s
        out: Dict[Tuple[str, str, str], float] = {}
        with self._lock:
            for fk, st in self._fragments.items():
                key = (fk[0], fk[1], fk[2])
                out[key] = out.get(key, 0.0) + st.reads.value(now, hl)
        return out

    def summary(self) -> Dict[str, Any]:
        """The /internal/health workload stanza: cheap cumulative
        counters + the live repeat ratios."""
        now = self.clock()
        with self._lock:
            return {
                "enabled": self.enabled,
                "fragmentReads": self._totals["fragmentReads"],
                "fragmentWrites": self._totals["fragmentWrites"],
                "queries": self._totals["queries"],
                "queryRepeatRatio": self.queries_window.ratio(now),
                "requestRepeatRatio": self.requests_window.ratio(now),
                "trackedFragments": len(self._fragments),
                "trackedRows": len(self._rows),
                "trackedSignatures": len(self._sigs),
            }

    def publish(self, stats: Optional[Any]) -> None:
        """Export the scrape-time gauges (counters are incremented at
        record time so pilosa_fragment_{reads,writes}_total stay true
        monotone counters)."""
        if stats is None:
            return
        s = self.summary()
        stats.gauge("query.repeat_ratio", s["queryRepeatRatio"])
        stats.gauge("workload.tracked_fragments", s["trackedFragments"])
        stats.gauge("workload.tracked_signatures",
                    s["trackedSignatures"])

    @staticmethod
    def _sig_entry(key: Any, st: _SigStat, now: float, hl: float
                   ) -> Dict[str, Any]:
        saved = (max(0, st.gen_hits - 1) * st.eval_s
                 if st.eval_s is not None else None)
        return {
            # Stable digest (utils/fingerprint.py), not hash(): str
            # hashing is salted per process, and the fingerprint must
            # name the same signature across restarts (the dumps).
            "fingerprint": digest(key),
            "index": st.index,
            "mode": st.mode,
            "shards": st.n_shards,
            "sig": st.sig_head,
            "hits": st.hits.count,
            "hitRate": st.hits.value(now, hl),
            "genHits": st.gen_hits,
            "avgEvalS": st.eval_s,
            "estSavedS": saved,
        }

    def snapshot(self, top_k: Optional[int] = None,
                 bank_entries: Optional[List[Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
        """The GET /debug/hotspots document. Totals are provable from
        the document itself: ``totals.X == tracked.X + evicted.X``, and
        ``tracked.X`` is the sum over ALL tracked entries (the top-K
        lists are views of the same maps). `bank_entries` (memledger
        rows for the bank categories) enables the density-vs-access
        quadrants in the opportunity report."""
        k = self.top_k if top_k is None else max(1, int(top_k))
        now = self.clock()
        hl = self.half_life_s
        with self._lock:
            frags = [
                {"index": fk[0], "field": fk[1], "view": fk[2],
                 "shard": fk[3], "reads": st.reads.count,
                 "readRate": st.reads.value(now, hl),
                 "writes": st.writes.count,
                 "writeRate": st.writes.value(now, hl),
                 "rowsScanned": st.rows_scanned,
                 "generation": st.generation,
                 "bankInvalidations": st.invalidations}
                for fk, st in self._fragments.items()]
            rows = [
                {"index": rk[0], "field": rk[1], "row": rk[2],
                 "touches": st.count, "touchRate": st.value(now, hl)}
                for rk, st in self._rows.items()]
            sigs = [self._sig_entry(sk, st, now, hl)
                    for sk, st in self._sigs.items()]
            tracked = {
                "fragmentReads": sum(f["reads"] for f in frags),
                "fragmentWrites": sum(f["writes"] for f in frags),
                "rowTouches": sum(r["touches"] for r in rows),
                "queries": sum(s["hits"] for s in sigs),
            }
            totals = dict(self._totals)
            evicted = dict(self._evicted)
            qwin = self.queries_window.snapshot(now)
            rwin = self.requests_window.snapshot(now)
        frags.sort(key=lambda d: (-d["readRate"], -d["reads"]))
        rows.sort(key=lambda d: (-d["touchRate"], -d["touches"]))
        sigs.sort(key=lambda d: (-d["hitRate"], -d["hits"]))
        churn = sorted(frags, key=lambda d: (-d["writeRate"],
                                             -d["writes"]))
        churn = [c for c in churn if c["writes"]][:k]
        cacheable = sorted(
            (s for s in sigs if (s["estSavedS"] or 0) > 0),
            key=lambda d: -d["estSavedS"])
        opp_sigs = cacheable[:k]
        # The TOTAL over every cacheable signature, not the top-K
        # slice: the result-cache sizing number must not change with
        # the requested list bound.
        total_saved = sum(s["estSavedS"] for s in cacheable)
        doc: Dict[str, Any] = {
            "enabled": self.enabled,
            "halfLifeS": hl,
            "totals": totals,
            "tracked": tracked,
            "evicted": evicted,
            "fragments": frags[:k],
            "rows": rows[:k],
            "signatures": sigs[:k],
            "churn": churn,
            "queriesWindow": qwin,
            "requestsWindow": rwin,
            "opportunity": {
                "signatures": opp_sigs,
                "totalEstSavedS": total_saved,
                "banks": self._bank_quadrants(bank_entries, frags, k),
            },
        }
        return doc

    def _bank_quadrants(self, bank_entries: List[Dict[str, Any]],
                        frags: List[Dict[str, Any]], k: int
                        ) -> List[Dict[str, Any]]:
        """Join memledger bank rows against fragment read rates:
        density = live fraction (1 - padding share), access = summed
        decayed read rate over the bank's (index, field, view). The
        quadrant labels rank banks for compression demotion —
        sparse-cold first (highest demotionScore), dense-hot last."""
        if not bank_entries:
            return []
        rate_by_view: Dict[Tuple[str, str, str], float] = {}
        for f in frags:
            key = (f["index"], f["field"], f["view"])
            rate_by_view[key] = rate_by_view.get(key, 0.0) \
                + f["readRate"]
        out = []
        for e in bank_entries:
            nbytes = int(e.get("bytes", 0) or 0)
            if nbytes <= 0:
                continue
            padded = int(e.get("paddedBytes", 0) or 0)
            density = max(0.0, 1.0 - padded / nbytes)
            # True live-bit density when the bank build sampled one
            # (popcount-based, core/view._sampled_live_density): the
            # pad share only sees pow2 capacity slack, so a FULL-WIDTH
            # row of mostly-zero words scored dense before this —
            # exactly the rows the hybrid layout exists to demote.
            live = e.get("liveDensity")
            if live is not None:
                try:
                    density *= max(0.0, min(1.0, float(live)))
                except (TypeError, ValueError):
                    live = None
            key = (e.get("index", ""), e.get("field", ""),
                   e.get("view", ""))
            rate = rate_by_view.get(key, 0.0)
            quadrant = (("dense" if density >= 0.5 else "sparse")
                        + "-" + ("hot" if rate > 0.0 else "cold"))
            out.append({
                "index": key[0], "field": key[1], "view": key[2],
                "category": e.get("category", "bank"),
                "bytes": nbytes, "paddedBytes": padded,
                "density": density, "liveDensity": live,
                "readRate": rate,
                "quadrant": quadrant,
                # Sparse and cold banks demote first: padding + dead-
                # bit waste scaled down by recent access.
                "demotionScore": (1.0 - density) * nbytes
                / (1.0 + rate),
            })
        out.sort(key=lambda d: -d["demotionScore"])
        return out[:k]

    def dump(self, logger: Optional[Any], top: int = 5) -> None:
        """Log a compact hotspot summary (the SIGTERM drain calls this
        so a shutdown records what was hot)."""
        if logger is None:
            return
        snap = self.snapshot(top_k=max(1, int(top)))
        logger.printf(
            "workload: %d fragment reads, %d writes, %d queries, "
            "query repeat ratio %.3f",
            snap["totals"]["fragmentReads"],
            snap["totals"]["fragmentWrites"],
            snap["totals"]["queries"],
            snap["queriesWindow"]["ratio"])
        for f in snap["fragments"]:
            logger.printf(
                "workload: hot fragment %s/%s/%s/shard%s reads=%d "
                "writes=%d", f["index"], f["field"], f["view"],
                f["shard"], f["reads"], f["writes"])
        for s in snap["opportunity"]["signatures"]:
            logger.printf(
                "workload: cacheable signature %s hits=%d "
                "estSavedS=%.4f", s["fingerprint"], s["hits"],
                s["estSavedS"])

    def reset(self) -> None:
        """Drop every tracked entry and total (test isolation — the
        recorder is process-wide)."""
        with self._lock:
            self._fragments.clear()
            self._rows.clear()
            self._sigs.clear()
            for d in (self._totals, self._evicted):
                for key in d:
                    d[key] = 0
            for w in (self.queries_window, self.requests_window):
                w.events.clear()
                w.counts.clear()
                w.seen_total = 0
                w.repeats_total = 0


# The process-wide recorder every read/write path reports into (the
# workload analog of memledger.LEDGER — one process, one workload).
WORKLOAD = WorkloadRecorder()
