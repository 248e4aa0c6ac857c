"""API facade of the port's server: the programmatic surface between the
HTTP routes and the executor, after the JAX package's ``server/api.py``.

Single node only. Key translation runs here for imports (a whole
import's keys at once, ``TranslateStore.translate_keys``) and in the
executor for queries. Over a holder with a data directory, every write
reaches the fragments' files before the call returns; ``import_roaring``
(the fastest import: a serialized roaring bitmap a shard) rewrites the
fragment's snapshot, and ``export_csv`` reads one shard back as CSV.

The measurement plane rides every query: ``stats`` (a
``utils/stats.StatsClient``), ``tracer`` (``utils/tracing``) and
``profiler`` (``utils/profile.Profiler``: the ``executor.*`` series,
device sampling, the slow-query ring). ``query(..., profile=True)``
embeds the profile tree in the response. ``refresh_memory_gauges``
publishes the memory, layout, timeline, roofline, workload, result- and
rank-cache and sentinel gauges that ``/metrics`` serves;
``debug_memory``, ``debug_timeline``, ``debug_roofline``,
``debug_hotspots``, ``debug_history``, ``debug_slo`` and ``node_health``
are the documents of their routes. ``sample_sentinel`` is one history
tick of the sentinel (the memory watchdog's hook calls it). The
failpoint sites ``api.query`` and ``api.status`` fire here;
``failpoints_snapshot``/``failpoints_update`` answer only when the plane
was enabled at boot. The cluster is not ported: a request that needs it
answers an error that names it, and the health document's cluster
fields answer as a single JAX node's do.
"""

from __future__ import annotations

import csv
import io
import logging
import os
import time
import uuid
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.layout import LayoutManager
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.utils.failpoints import FAILPOINTS
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.profile import Profiler
from pilosa_tpu_torch.utils.sentinel import SENTINEL
from pilosa_tpu_torch.utils.stats import NopStatsClient
from pilosa_tpu_torch.utils.timeline import TIMELINE
from pilosa_tpu_torch.utils.tracing import NopTracer

# Fault-injection sites on the server's seams (utils/failpoints.py):
# /status (what a prober hits) and the query entry.
_FP_STATUS = FAILPOINTS.register("api.status")
_FP_QUERY = FAILPOINTS.register("api.query")

# Field options the create-field body may carry (reference names).
_FIELD_OPTIONS = {"type": "type", "cacheType": "cache_type",
                  "cacheSize": "cache_size", "min": "min", "max": "max",
                  "timeQuantum": "time_quantum", "keys": "keys",
                  "noStandardView": "no_standard_view",
                  "maxColumns": "max_columns"}


class PrintfLogger:
    """The ``printf`` logger the measurement plane writes to (slow
    queries, shutdown dumps), over the standard ``logging`` module."""

    def __init__(self, name: str = "pilosa_tpu_torch") -> None:
        self._log = logging.getLogger(name)

    def printf(self, fmt: str, *args: Any) -> None:
        self._log.info(fmt % args if args else fmt)


class ApiError(ValueError):
    """A request error with its HTTP status; ``headers`` go out with
    the response."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status
        self.headers: Optional[Dict[str, str]] = None


def not_ported(what: str) -> ApiError:
    return ApiError(f"{what} is not ported yet", 400)


def _string_keys(what: str, keys) -> Optional[List[str]]:
    """An import's keys as a list, refused (400) unless it is a list of
    strings, before the translators allocate any id. None stays None."""
    if keys is None:
        return None
    try:
        keys = list(keys)
    except TypeError:
        raise ApiError(f"{what} must be a list of strings") from None
    if not all(issubclass(t, str) for t in set(map(type, keys))):
        bad = next(k for k in keys if not isinstance(k, str))
        raise ApiError(f"{what} must be strings, got {bad!r}")
    return keys


def export_fragment_lines(idx, field_name: str, shard: int):
    """CSV lines ``row,col`` (each with its newline) of one shard of the
    field's standard view, row by row: keys in place of ids on a keyed
    field or index (the id where an id has no key), quoted as the csv
    module quotes. A generator, so a CLI export streams shard after
    shard."""
    f = idx.field(field_name) if idx is not None else None
    if f is None:
        raise ApiError(f"field not found: {field_name}", 404)
    view = f.view()
    frag = view.fragment(shard) if view is not None else None
    if frag is None:
        return
    row_tx = f.row_translator.translate_id if f.options.keys else None
    col_tx = idx.column_translator.translate_ids if idx.keys else None
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    base = np.uint64(shard * SHARD_WIDTH)
    for row in frag.row_ids():
        r = row_tx(row) if row_tx else row
        if r is None:
            r = row
        cols = frag.row_offsets(row) + base
        keys = col_tx(cols) if col_tx else None
        for i, col in enumerate(cols.tolist()):
            c = keys[i] if keys is not None and keys[i] is not None else col
            buf.seek(0)
            buf.truncate()
            w.writerow([r, c])
            yield buf.getvalue()


class API:
    """Queries, schema and imports over one Holder (in memory or over a
    data directory). The executor runs on the holder's device.
    ``coalescer`` is attached by the server wiring (``cli/main.py``) or
    a test; None means every query takes the direct path. ``stats`` and
    ``tracer`` default to the nop clients; ``long_query_time`` (seconds,
    0 off) sends slower queries to the log and the slow-query ring."""

    def __init__(self, holder: Holder, stats: Any = None,
                 tracer: Any = None):
        self.holder = holder
        self.executor = Executor(holder, device=holder.device)
        self.stats = stats or NopStatsClient()
        self.executor.stats = self.stats
        # The workload recorder and the result cache count into the stats
        # client at event time (the last API attached wins, as the
        # ledger's publish target does).
        WORKLOAD.stats = self.stats
        self.executor.result_cache.stats = self.stats
        self.tracer = tracer or NopTracer()
        self.logger = PrintfLogger()
        self.long_query_time = 0.0
        self.profiler = Profiler(stats=self.stats, tracer=self.tracer)
        self._started_at = time.time()
        self.coalescer = None
        # The hybrid layout's re-layout pass over this holder; the server
        # wiring configures and starts it (cli/main.py), as it does the
        # memory watchdog.
        self.layout = LayoutManager(holder, stats=self.stats)
        self.watchdog = None
        self.node_id = uuid.uuid4().hex

    # ----------------------------------------------------------------- query

    def _observe_query(self, index: str, query: Any, dur: float,
                       profile: Any = None, error: Any = None,
                       kind: str = "query") -> None:
        """The one stats and slow-query sink of every query path."""
        self.profiler.observe(index, query, dur, profile=profile,
                              error=error,
                              long_query_time=self.long_query_time,
                              logger=self.logger, kind=kind)

    def _begin_timeline(self, index: str) -> Any:
        """A request timeline under the trace id the tracer stamps on
        this request's spans (minted when the request carried none)."""
        tid = getattr(self.tracer, "ensure_trace_id", lambda: None)()
        return TIMELINE.begin(tid, index)

    def _end_timeline(self, tl: Any, err: Any) -> None:
        TIMELINE.finish(tl, error=err)
        # The request is over: an embedded caller's next query on this
        # thread mints a fresh trace id.
        adopt = getattr(self.tracer, "adopt", None)
        if adopt is not None:
            adopt(None)

    def query(self, index: str, query: Any,
              shards: Optional[Sequence[int]] = None,
              profile: bool = False) -> Dict[str, Any]:
        """The direct path: ``{"results": [...]}`` of one request.
        ``profile=True`` (``?profile=true``) embeds the profile tree
        under ``"profile"``, with device sampling on."""
        _FP_QUERY.fire(index=index, remote=False)
        tl = self._begin_timeline(index)
        prof = self.profiler.begin(index, query, shards,
                                   force=bool(profile))
        prof.timeline = tl
        t0 = time.perf_counter()
        err = None
        try:
            with self.tracer.span("API.Query", index=index) as sp:
                self.stats.count("query", 1)
                try:
                    resp = self.executor.execute_full(
                        index, query, shards=shards, profile=prof)
                finally:
                    prof.annotate_span(sp)
            if profile:
                prof.close(time.perf_counter() - t0)
                resp = dict(resp)
                resp["profile"] = prof.to_json()
            return resp
        except Exception as e:
            err = e
            raise
        finally:
            dur = time.perf_counter() - t0
            self.stats.timing("query.direct", dur)
            self._end_timeline(tl, err)
            self._observe_query(index, query, dur, prof, err)

    def query_coalesced(self, index: str, query: Any,
                        shards: Optional[Sequence[int]] = None,
                        profile: bool = False) -> Dict[str, Any]:
        """``query`` through the coalescer when one is attached and
        running: concurrent requests share executor batches. Only a
        coalescer that stopped under the request (``CoalescerStopped``)
        re-runs it on the direct path; any other error is the
        request's. A forced profile is never shared with an identical
        batchmate."""
        from pilosa_tpu_torch.server.coalescer import CoalescerStopped
        coal = self.coalescer
        if coal is None or not coal.running:
            return self.query(index, query, shards=shards, profile=profile)
        _FP_QUERY.fire(index=index, remote=False)
        tl = self._begin_timeline(index)
        prof = self.profiler.begin(index, query, shards,
                                   force=bool(profile))
        prof.timeline = tl
        t0 = time.perf_counter()
        err = None
        try:
            with self.tracer.span("API.QueryCoalesced", index=index) as sp:
                self.stats.count("query", 1)
                try:
                    resp = coal.submit(index, query, shards=shards,
                                       profile=prof)
                except CoalescerStopped:
                    t1 = time.perf_counter()
                    try:
                        resp = self.executor.execute_full(
                            index, query, shards=shards, profile=prof)
                    finally:
                        self.stats.timing("query.direct",
                                          time.perf_counter() - t1)
                prof.annotate_span(sp)
            if profile:
                prof.close(time.perf_counter() - t0)
                resp = dict(resp)
                resp["profile"] = prof.to_json()
            return resp
        except Exception as e:
            err = e
            raise
        finally:
            dur = time.perf_counter() - t0
            self._end_timeline(tl, err)
            self._observe_query(index, query, dur, prof, err)

    def query_batch(self, items: Sequence[Any],
                    profile: bool = False) -> List[Dict[str, Any]]:
        """N independent queries in one request and one executor batch.
        Each item is ``{"index", "query", "shards"?}``; the answer holds
        ``{"results": ...}`` or ``{"error": ...}`` per item, so one bad
        item fails none of its batchmates. ``profile=True`` profiles
        every item with device sampling on and embeds each item's tree
        under its ``"profile"``; with the profiler sampling (its
        ``sample_every`` above 0) each item gets a profile sampled 1 in
        N that feeds the ``executor.*`` series. Otherwise the items run
        unprofiled, as in the JAX package."""
        with self.tracer.span("API.QueryBatch", n=len(items)):
            self.stats.count("query", len(items))
            t0 = time.perf_counter()
            out = self._query_batch(items, profile)
            self._observe_query("*", f"{len(items)} queries",
                                time.perf_counter() - t0, kind="batch")
            return out

    def _query_batch(self, items: Sequence[Any],
                     profile: bool) -> List[Dict[str, Any]]:
        reqs: List[Any] = []
        bad: Dict[int, Dict[str, str]] = {}
        for pos, it in enumerate(items):
            try:
                reqs.append((it["index"], it["query"], it.get("shards")))
            except (KeyError, TypeError) as e:
                bad[pos] = {"error": f"bad batch item: {e!r}"}
                reqs.append(None)
        good = [r for r in reqs if r is not None]
        profs = None
        if profile or self.profiler.sample_every > 0:
            profs = [self.profiler.begin(i, q, sh, force=profile)
                     for i, q, sh in good]
        t0 = time.perf_counter()
        shaped = self.executor.execute_batch_shaped(good, profiles=profs)
        dur = time.perf_counter() - t0
        out = []
        it = iter(range(len(good)))
        for pos, r in enumerate(reqs):
            if r is None:
                out.append(bad[pos])
                continue
            k = next(it)
            res = shaped[k]
            err = res if isinstance(res, Exception) else None
            resp = {"error": str(res)} if err is not None else dict(res)
            if profs is not None:
                # The stats feed; the batch is one slow-query record.
                self.profiler.observe(good[k][0], good[k][1], dur,
                                      profile=profs[k], error=err)
                if profile:
                    resp["profile"] = profs[k].to_json()
            out.append(resp)
        return out

    # ---------------------------------------------------------------- schema

    def schema(self) -> Dict[str, Any]:
        return {"indexes": self.holder.schema()}

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Dict[str, Any]:
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        return {"name": idx.name}

    def delete_index(self, name: str) -> None:
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    def create_field(self, index: str, name: str,
                     options: Optional[dict] = None) -> Dict[str, Any]:
        idx = self._index(index)
        opts = FieldOptions()
        for k, v in dict(options or {}).items():
            if k not in _FIELD_OPTIONS:
                raise ApiError(f"unknown field option {k!r}")
            setattr(opts, _FIELD_OPTIONS[k], v)
        try:
            f = idx.create_field(name, opts)
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        return {"name": f.name}

    def delete_field(self, index: str, name: str) -> None:
        idx = self._index(index)
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    # --------------------------------------------------------------- imports

    def import_bits(self, index: str, field: str, rows=None, columns=None,
                    row_keys=None, column_keys=None, timestamps=None,
                    clear: bool = False) -> None:
        """Bulk bit import: the bits go into the field's standard view
        and, with ``timestamps`` (time fields), into each time's views;
        the columns go into existence unless ``clear``. A timestamp is
        seconds since the epoch (int or float, read in local time, as
        ``datetime.fromtimestamp`` reads it) or a PQL timestamp
        string. A keyed index takes ``column_keys`` and a keyed field
        ``row_keys`` in place of ids; new keys are allocated ids in the
        order they first appear."""
        idx = self._index(index)
        f = self._field(idx, field)
        if f.options.keys and row_keys is None and rows is not None:
            raise ApiError("row ids cannot be used because field uses "
                           "string keys")
        if idx.keys and column_keys is None and columns is not None:
            raise ApiError("column ids cannot be used because index uses "
                           "string keys")
        row_keys = _string_keys("rowKeys", row_keys)
        column_keys = _string_keys("columnKeys", column_keys)
        if column_keys is not None:
            columns = self._column_ids(idx, column_keys)
        if row_keys is not None:
            if not f.options.keys:
                raise ApiError(f"field {field} does not use row keys")
            rows = f.row_translator.translate_keys(row_keys)
        rows = np.asarray(rows, dtype=np.uint64)
        columns = np.asarray(columns, dtype=np.uint64)
        if len(rows) != len(columns):
            raise ApiError("rows and columns length mismatch")
        ts = None
        if timestamps is not None:
            ts = [datetime.fromtimestamp(t) if isinstance(t, (int, float))
                  else (timeq.parse_timestamp(t) if isinstance(t, str) else t)
                  for t in timestamps]
        f.import_bits(rows, columns, timestamps=ts, clear=clear)
        if not clear:
            idx.add_existence(columns)

    def import_values(self, index: str, field: str, columns=None,
                      values=None, column_keys=None,
                      clear: bool = False) -> None:
        """Bulk integer import into an int field's BSI view; a keyed
        index takes ``column_keys`` in place of ids."""
        idx = self._index(index)
        f = self._field(idx, field)
        if idx.keys and column_keys is None and columns is not None:
            raise ApiError("column ids cannot be used because index uses "
                           "string keys")
        column_keys = _string_keys("columnKeys", column_keys)
        if column_keys is not None:
            columns = self._column_ids(idx, column_keys)
        columns = np.asarray(columns, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if len(columns) != len(values):
            raise ApiError("columns and values length mismatch")
        try:
            f.import_values(columns, values, clear=clear)
        except ValueError as e:
            raise ApiError(str(e))
        if not clear:
            idx.add_existence(columns)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, clear: bool = False,
                       view: str = "standard") -> None:
        """Union a serialized roaring bitmap into one shard of a view of
        the field (with ``clear``, clear its bits), then mark every
        column the fragment holds in existence. Malformed bytes answer
        400."""
        idx = self._index(index)
        f = self._field(idx, field)
        frag = f.create_view_if_not_exists(view) \
            .create_fragment_if_not_exists(shard)
        try:
            frag.import_roaring(data, clear=clear)
        except ValueError as e:
            raise ApiError(f"invalid roaring payload: {e}")
        idx.add_existence_words(shard, frag.column_words())

    def export_csv(self, index: str, field: str, shard: int) -> str:
        """``row,col`` CSV of one shard (``export_fragment_lines``)."""
        return "".join(export_fragment_lines(self._index(index), field,
                                             shard))

    def recalculate_caches(self) -> None:
        """Rebuild every fragment's TopN count cache from its storage."""
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    for frag in list(v.fragments.values()):
                        frag.recalculate_cache()

    # ------------------------------------------------ memory / measurement

    def refresh_memory_gauges(self) -> None:
        """Publish the scrape-time gauges into the stats client: the
        memory ledger's (``pilosa_memory_*``, the telemetry rings
        registered first), the timeline's idle ratio, the roofline's,
        the rank cache's, the layout pass's, the uptime and the build
        info. Host dict reads only, no device work."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        from pilosa_tpu_torch.utils.roofline import ROOFLINE
        TIMELINE.register_memory(LEDGER)
        ROOFLINE.register_memory(LEDGER)
        SENTINEL.register_memory(LEDGER)
        if hasattr(self.tracer, "register_memory"):
            self.tracer.register_memory(LEDGER)
        LEDGER.publish(self.stats)
        WORKLOAD.publish(self.stats)
        TIMELINE.publish(self.stats)
        ROOFLINE.publish(self.stats)
        self.executor.result_cache.publish(self.stats)
        rsnap = self.holder.rank_cache.snapshot()
        self.stats.gauge("rank_cache.entries", rsnap["entries"])
        self.stats.gauge("rank_cache.bytes", rsnap["bytes"])
        self.layout.publish(self.stats)
        SENTINEL.publish(self.stats)
        self.stats.gauge("process_uptime_seconds",
                         time.time() - self._started_at)
        self.stats.with_tags(f"version:{__version__}",
                             f"backend:{self.holder.device.type}").gauge(
            "build_info", 1)

    def debug_memory(self, top_k: int = 10) -> Dict[str, Any]:
        """The ``GET /debug/memory`` document: bytes by category and the
        largest entries (``totalBytes`` is the sum of the categories'),
        with the layout pass's stanza beside them."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        self.refresh_memory_gauges()
        doc = LEDGER.snapshot(top_k=top_k)
        doc["layout"] = self.layout.snapshot()
        return doc

    def debug_timeline(self, last: Optional[int] = None,
                       trace: Optional[str] = None) -> Dict[str, Any]:
        """The ``GET /debug/timeline`` document: trace-event JSON of the
        last N recorded requests (or one trace id) with the dispatch-gap
        summary."""
        self.refresh_memory_gauges()
        return TIMELINE.snapshot(last=last, trace_id=trace,
                                 node_id=self.node_id)

    def debug_roofline(self) -> Dict[str, Any]:
        """The ``GET /debug/roofline`` document: the recorder's byte
        splits, opcode totals, per-cohort bandwidth and drift, with the
        executor's cumulative splits beside them."""
        from pilosa_tpu_torch.utils.roofline import ROOFLINE
        self.refresh_memory_gauges()
        doc = ROOFLINE.snapshot()
        doc["node"] = self.node_id
        ex = self.executor
        doc["executor"] = {
            "launchBytesGather": ex.launch_bytes_gather,
            "launchBytesCompute": ex.launch_bytes_compute,
            "launchBytesExpand": ex.launch_bytes_expand,
            "launchBytesPad": ex.launch_bytes_pad,
            "opcodeTotals": dict(ex.opcode_counts),
            "megaLaunches": ex.mega_launches,
        }
        return doc

    def debug_hotspots(self, top_k: Optional[int] = None
                       ) -> Dict[str, Any]:
        """The ``GET /debug/hotspots`` document: the workload recorder's
        snapshot (hot fragments, rows and signatures, churn, the repeat
        windows, the opportunity report with the banks' quadrants from
        the ledger), the result cache's observed hits beside the
        predicted savings, and the rank cache."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        self.refresh_memory_gauges()
        doc = WORKLOAD.snapshot(
            top_k=top_k,
            bank_entries=LEDGER.entries("bank", "fragment_bank"))
        rc = self.executor.result_cache.snapshot()
        doc["resultCache"] = rc
        doc["rankCache"] = self.holder.rank_cache.snapshot()
        doc["rankCache"]["hits"] = self.executor.rank_cache_hits
        doc["rankCache"]["patches"] = self.executor.rank_cache_patches
        doc["rankCache"]["rebuilds"] = self.executor.rank_cache_rebuilds
        doc["opportunity"]["observed"] = {
            "hits": rc["hits"],
            "misses": rc["misses"],
            "hitRatio": rc["hitRatio"],
            "predictedTotalEstSavedS":
                doc["opportunity"]["totalEstSavedS"],
        }
        return doc

    def sample_sentinel(self) -> None:
        """One sentinel history tick: the key gauges of every plane
        (host dict reads, no device touch) and the cumulative RED
        histograms, then the edge-triggered conditions (roofline drift,
        device-memory watermark pressure). The memory watchdog's gauge
        hook calls it at its period; tests call it with an injected
        clock."""
        from pilosa_tpu_torch.utils.memledger import HOST_CATEGORIES, \
            LEDGER
        from pilosa_tpu_torch.utils.roofline import ROOFLINE
        if not SENTINEL.enabled:
            return
        rsnap = ROOFLINE.snapshot()
        rc = self.executor.result_cache.snapshot()
        live = padded = 0
        for cat, t in LEDGER.totals().items():
            if cat not in HOST_CATEGORIES:
                live += t["bytes"]
                padded += t["paddedBytes"]
        hits = self.executor.rank_cache_hits
        rebuilds = self.executor.rank_cache_rebuilds
        coal = self.coalescer
        gauges = {
            "device_idle_ratio": TIMELINE.idle_ratio(),
            "roofline_achieved_gbps": rsnap["achievedGbps"],
            "roofline_fraction": rsnap["rooflineFraction"],
            "result_cache_hit_ratio": rc["hitRatio"],
            "rank_cache_hit_ratio": (hits / (hits + rebuilds)
                                     if hits + rebuilds else 0.0),
            "hbm_live_bytes": live,
            "hbm_padded_bytes": padded,
            # One card and no mesh: no collective moves a byte.
            "mesh_collective_bytes": 0,
            "coalescer_queue_depth": (coal.queue_depth()
                                      if coal is not None else 0),
        }
        snap_fn = getattr(self.stats, "snapshot", None)
        histos = (snap_fn() or {}).get("histograms") \
            if snap_fn is not None else None
        SENTINEL.sample(gauges=gauges, histograms=histos)
        flagged = sum(1 for c in rsnap["cohorts"] if c["drift"])
        SENTINEL.note_condition(
            "roofline.drift", flagged > 0,
            f"{flagged} cohort(s) invert the optimizer's predicted "
            f"cost ordering (see /debug/roofline)", kind="roofline")
        if SENTINEL.watermark_bytes > 0:
            SENTINEL.note_condition(
                "hbm.pressure", live >= SENTINEL.watermark_bytes,
                f"{live} device bytes ledgered (watermark "
                f"{SENTINEL.watermark_bytes})", kind="memory")

    def debug_history(self, series: Optional[List[str]] = None,
                      last: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /debug/history`` document: the sentinel's history
        rings (raw and decimated) and their trace-event counter tracks."""
        self.refresh_memory_gauges()
        doc = SENTINEL.history(series=series, last=last)
        doc["node"] = self.node_id
        return doc

    def debug_slo(self) -> Dict[str, Any]:
        """The ``GET /debug/slo`` document: the declared objectives,
        their error budgets and burn rates, the request rates and
        windowed quantiles by endpoint, and the alert ring."""
        self.refresh_memory_gauges()
        doc = SENTINEL.slo_snapshot()
        doc["node"] = self.node_id
        return doc

    def node_health(self) -> Dict[str, Any]:
        """The ``GET /internal/health`` document, with the JAX package's
        keys: memory totals, the coalescer, the executor's launch, plan
        and roofline counters, the result and rank caches, the
        slow-query counts, the workload summary, the timeline, the
        watchdog, the SLO stanza, the layout and the failpoints. The
        cluster fields answer as a single JAX node's do, and the JAX
        executor's compile-cache and vmapped-fusion counters, which the
        port has no counterpart of, answer 0."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        now = time.time()
        mem = LEDGER.snapshot(top_k=3)
        coal = self.coalescer
        wd = self.watchdog
        ex = self.executor
        return {
            "id": self.node_id,
            "uri": "",
            "state": "NORMAL",
            "healthy": True,
            "time": now,
            "uptimeS": now - self._started_at,
            "memory": {
                "totalBytes": mem["totalBytes"],
                "deviceBytes": mem["deviceBytes"],
                "paddingBytes": mem["paddingBytes"],
                "categories": {c: t["bytes"]
                               for c, t in mem["categories"].items()},
            },
            "coalescer": {
                "attached": coal is not None,
                "running": bool(coal is not None and coal.running),
                "queueDepth": coal.queue_depth() if coal is not None
                else 0,
            },
            "executor": {
                "jitCacheSize": 0,
                "retraces": ex.jit_compiles,
                "fusedDispatches": 0,
                "fusedQueries": 0,
                "megaLaunches": ex.mega_launches,
                "megaQueries": ex.mega_queries,
                "megaPlanEntries": ex.mega_plan_entries,
                "megaPlanBytes": ex.mega_plan_bytes,
                "meshLaunches": 0,
                "meshCollectiveBytes": 0,
                "planVerifyPasses": ex.plan_verify_passes,
                "planVerifyRejects": ex.plan_verify_rejects,
                "opt": {
                    "plans": ex.opt_plans,
                    "cseHits": ex.opt_cse_hits,
                    "entriesEliminated": ex.opt_entries_eliminated,
                    "foldsReordered": ex.opt_folds_reordered,
                    "bytesSaved": ex.opt_bytes_saved,
                },
                "roofline": self._roofline_health(),
            },
            "resultCache": ex.result_cache.snapshot(),
            "rankCache": {
                "hits": ex.rank_cache_hits,
                "patches": ex.rank_cache_patches,
                "rebuilds": ex.rank_cache_rebuilds,
            },
            "slowQueries": self.profiler.slow_total,
            "slowRing": self.profiler.ring_count(),
            "workload": WORKLOAD.summary(),
            "timeline": {
                "requestsRecorded": TIMELINE.requests_recorded,
                "deviceIdleRatio": TIMELINE.idle_ratio(),
            },
            "watchdog": {
                "running": bool(wd is not None and wd.running),
                "samples": wd.samples_taken if wd is not None else 0,
                "lastSampleAt": (wd.last_sample_at if wd is not None
                                 else None),
            },
            "slo": SENTINEL.health_stanza(),
            "layout": self.layout.snapshot(),
            "failpoints": {k: v for k, v in FAILPOINTS.snapshot().items()
                           if k in ("armed", "fired")},
            "clusterEvents": [],
            "placementGen": 0,
        }

    def _roofline_health(self) -> Dict[str, Any]:
        """The roofline stanza of ``node_health``."""
        from pilosa_tpu_torch.utils.roofline import ROOFLINE
        snap = ROOFLINE.snapshot()
        ex = self.executor
        return {
            "enabled": snap["enabled"],
            "launches": snap["launches"],
            "fencedLaunches": snap["fencedLaunches"],
            "launchBytes": (ex.launch_bytes_gather
                            + ex.launch_bytes_compute
                            + ex.launch_bytes_expand
                            + ex.launch_bytes_pad),
            "rooflineGbps": snap["rooflineGbps"],
            "achievedGbps": snap["achievedGbps"],
            "fraction": snap["rooflineFraction"],
            "estimateOnly": snap["estimateOnly"],
            "driftFlags": snap["driftFlags"],
        }

    # ------------------------------------------------------ failpoints

    def failpoints_snapshot(self) -> Dict[str, Any]:
        """``GET /internal/failpoints``: the sites, their armed specs
        and hit counts; 403 unless the plane was enabled at boot."""
        self._failpoints_gate()
        return FAILPOINTS.snapshot()

    def failpoints_update(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /internal/failpoints``: ``{"arm": {site: spec},
        "disarm": [site, ...], "disarm_all": bool}``; disarms apply
        first, so one request can retarget the plane."""
        self._failpoints_gate()
        try:
            if body.get("disarm_all"):
                FAILPOINTS.disarm_all()
            for name in body.get("disarm") or []:
                FAILPOINTS.disarm(name)
            for name, spec in (body.get("arm") or {}).items():
                FAILPOINTS.arm(name, str(spec))
        except (KeyError, ValueError) as e:
            raise ApiError(str(e), 400)
        return FAILPOINTS.snapshot()

    @staticmethod
    def _failpoints_gate() -> None:
        if not FAILPOINTS.http_enabled:
            raise ApiError(
                "failpoints surface disabled (enable with "
                "PILOSA_TPU_FAILPOINTS / [failpoints] config at boot)",
                403)

    def debug_queries(self) -> Dict[str, Any]:
        """The ``GET /debug/queries`` document: the slow-query ring, most
        recent first, and the executor's launch and plan counters."""
        ex = self.executor
        return {"queries": self.profiler.slow_queries(),
                "retraces": ex.jit_compiles,
                "megaLaunches": ex.mega_launches,
                "megaQueries": ex.mega_queries,
                "megaPlanEntries": ex.mega_plan_entries,
                "megaPlanBytes": ex.mega_plan_bytes,
                "planVerifyPasses": ex.plan_verify_passes,
                "planVerifyRejects": ex.plan_verify_rejects,
                "optPlans": ex.opt_plans,
                "optCseHits": ex.opt_cse_hits,
                "optEntriesEliminated": ex.opt_entries_eliminated,
                "optFoldsReordered": ex.opt_folds_reordered,
                "optBytesSaved": ex.opt_bytes_saved,
                "launchBytesGather": ex.launch_bytes_gather,
                "launchBytesCompute": ex.launch_bytes_compute,
                "launchBytesExpand": ex.launch_bytes_expand,
                "launchBytesPad": ex.launch_bytes_pad,
                "opcodeTotals": dict(ex.opcode_counts)}

    # ---------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        # An armed api.status makes this node look dead to a prober.
        _FP_STATUS.fire()
        return {"state": "NORMAL",
                "nodes": [{"id": self.node_id, "isCoordinator": True,
                           "uri": {}}]}

    def info(self) -> Dict[str, Any]:
        return {"shardWidth": SHARD_WIDTH,
                "cpuPhysicalCores": os.cpu_count(),
                "version": __version__,
                "tailDroppedBytes": self.holder.tail_dropped_bytes(),
                "device": str(self.holder.device)}

    def version(self) -> Dict[str, str]:
        return {"version": __version__}

    # --------------------------------------------------------------- helpers

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index not found: {name}", 404)
        return idx

    @staticmethod
    def _column_ids(idx, column_keys) -> np.ndarray:
        if not idx.keys:
            raise ApiError(f"index {idx.name} does not use column keys")
        return idx.column_translator.translate_keys(column_keys)

    def _field(self, idx, name: str):
        f = idx.field(name)
        if f is None:
            raise ApiError(f"field not found: {name}", 404)
        return f
