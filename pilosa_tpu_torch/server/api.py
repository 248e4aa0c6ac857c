"""API facade of the port's server: the programmatic surface between the
HTTP routes and the executor, after the JAX package's ``server/api.py``.

A single node, or one node of a static cluster (``cluster=``, after the
JAX package's cluster half of ``server/api.py``): the coordinator of a
query fans it out by owning node and merges the legs
(``parallel/cluster_executor.py``), a ``remote`` leg runs only its
shards, imports go to every replica that owns their shard, schema
changes are sent to every node, and keys are allocated on the translate
primary, whose log the other nodes replicate. Key translation runs here
for imports (a whole import's keys at once) and in the executor for
queries. Over a holder with a data directory, every write
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
was enabled at boot. ``cluster_health``, ``cluster_hotspots``,
``cluster_slo`` and ``cluster_timeline`` merge every member's document
(an unreachable node is reported with its error). What the static
cluster does not do yet (seed join, resize, anti-entropy) answers an
error that names it.
"""

from __future__ import annotations

import csv
import io
import logging
import os
import threading
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
from pilosa_tpu_torch.executor.executor import column_attr_sets
from pilosa_tpu_torch.executor.results import result_to_json
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.parallel import heartbeat  # noqa: F401 (its site)
from pilosa_tpu_torch.parallel.broadcast import AsyncBroadcaster
from pilosa_tpu_torch.parallel.client import ClientError, InternalClient
from pilosa_tpu_torch.parallel.cluster import STATE_RESIZING, Node
from pilosa_tpu_torch.parallel.cluster_executor import ClusterExecutor
from pilosa_tpu_torch.pql import parse_string
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


# What the static cluster leaves to the seed join, resize and
# anti-entropy slice.
RESIZE_PART = "seed join, resize and anti-entropy"

# Cluster messages of that part, refused by handle_cluster_message.
_RESIZE_MESSAGES = ("node-join", "node-leave", "resize-complete",
                    "topology", "set-coordinator")


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
                 tracer: Any = None, cluster: Any = None,
                 client_ssl_context: Any = None):
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
        # Which members were down at the sentinel's last sample, so its
        # alert ring sees node-down edges, not a steady state.
        self._sentinel_down_prev: set = set()
        # Ids the translate primary could not resolve, by (index,
        # field), valid for the local store size they were found at.
        self._translate_negative: Dict[Any, Any] = {}
        # The static cluster (parallel/): None on a single node. The
        # anti-entropy syncer and the resize puller stay None until
        # seed join and resize are ported.
        self.cluster = cluster
        self.cluster_executor = None
        self.broadcaster = None
        self.syncer = None
        self.resize_puller = None
        self._client = None
        if cluster is not None:
            client = InternalClient(tracer=self.tracer,
                                    ssl_context=client_ssl_context)
            # Membership and cache messages ride a queued, retried
            # path, so a briefly-down peer does not miss them.
            self.broadcaster = AsyncBroadcaster(client, logger=self.logger)
            self.cluster_executor = ClusterExecutor(
                self.executor, cluster, client,
                broadcaster=self.broadcaster, stats=self.stats)
            self.executor.key_resolver = self._resolve_key_via_primary
            self.executor.id_resolver = self._resolve_ids_via_primary
            self._client = client

    # -------------------------------------------------- translation primary

    def _translate_primary(self) -> Node:
        """The pinned primary allocates every key (by default the
        lexically-first member)."""
        return self.cluster.translate_primary()

    def _resolve_key_via_primary(self, index: str, field: Optional[str],
                                 keys: List[str]) -> List[int]:
        """Ids of ``keys`` allocated on the primary, one round trip a
        call however many keys; adopted locally so results translate
        back here before replication catches up."""
        primary = self._translate_primary()
        if primary.id == self.cluster.local.id:
            return self.translate_keys_local(index, field, keys)
        ids = self._client.translate_keys(primary.uri, index, field, keys)
        self._translate_store(index, field).apply_entries(zip(keys, ids))
        return ids

    def _translate_store(self, index: str, field: Optional[str]):
        idx = self._index(index)
        if field is None:
            return idx.column_translator
        return self._field(idx, field).row_translator

    def translate_keys_local(self, index: str, field: Optional[str],
                             keys: List[str]) -> List[int]:
        """Allocate ids here (the primary's side of
        ``/internal/translate/keys``)."""
        store = self._translate_store(index, field)
        return [int(i) for i in store.translate_keys(keys)]

    def translate_ids_local(self, index: str, field: Optional[str],
                            ids: List[int]) -> List[Optional[str]]:
        """Reverse lookup here (the primary's side of
        ``/internal/translate/ids``)."""
        store = self._translate_store(index, field)
        return store.translate_ids([int(i) for i in ids])

    def _resolve_ids_via_primary(self, index: str, field: Optional[str],
                                 ids: List[int]) -> List[Optional[str]]:
        """Keys of ``ids``: local hits stay local; the misses take one
        round trip to the primary and are adopted. An id the primary
        cannot resolve exists nowhere, so the miss is remembered
        (bounded) until the local store grows."""
        store = self._translate_store(index, field)
        keys = store.translate_ids([int(i) for i in ids])
        size = store.size()
        cached_size, neg = self._translate_negative.get(
            (index, field), (-1, set()))
        if cached_size != size:
            neg = set()
            self._translate_negative[(index, field)] = (size, neg)
        missing = [int(i) for i, k in zip(ids, keys)
                   if k is None and int(i) not in neg]
        if not missing:
            return keys
        primary = self._translate_primary()
        if primary.id == self.cluster.local.id:
            return keys
        try:
            fetched = dict(zip(missing, self._client.translate_ids(
                primary.uri, index, field, missing)))
        except Exception as e:
            self.logger.printf(
                "translate-id fallback to primary %s failed: %r",
                primary.uri, e)
            return keys
        store.apply_entries((k, i) for i, k in fetched.items()
                            if k is not None)
        if len(neg) < 100_000:
            neg.update(i for i, k in fetched.items() if k is None)
        self._translate_negative[(index, field)] = (store.size(), neg)
        return [k if k is not None else fetched.get(int(i))
                for i, k in zip(ids, keys)]

    def translate_data(self, index: str, field: Optional[str] = None,
                       offset: int = 0) -> bytes:
        """``GET /internal/translate/data``: the replication stream from
        ``offset``. A replica that has not streamed since it started
        serves nothing until its own pull re-establishes the prefix
        (its log may hold entries adopted out of order)."""
        store = self._translate_store(index, field)
        if self.cluster is not None \
                and self._translate_primary().id != self.cluster.local.id:
            with store._lock:
                if store.served_limit is None:
                    store.served_limit = 0
        return store.read_log_from(offset)

    def _translate_source(self) -> Node:
        """Where this replica streams translate logs from: its ring
        predecessor (chained replication: the primary serves one
        stream), or the primary when the predecessor is the primary or
        is down."""
        primary = self._translate_primary()
        prev = self.cluster.previous_node()
        if prev is None or prev.id == primary.id \
                or prev.id in self.cluster.down_ids:
            return primary
        return prev

    def _lift_translate_serving(self) -> None:
        """This node just became the translate primary: serve the whole
        id-ordered log."""
        for idx in self.holder.indexes.values():
            if idx.keys:
                idx.column_translator.served_limit = None
            for f in idx.fields.values():
                if f.options.keys:
                    f.row_translator.served_limit = None

    def _sync_translate_stores(self, direct_primary: bool = False) -> None:
        """One replication pass: every keyed store pulls the stream
        from its replica offset, from the chain source first, then the
        primary (``direct_primary`` pulls from the primary only)."""
        primary = self._translate_primary()
        if primary.id == self.cluster.local.id:
            return
        source = primary if direct_primary else self._translate_source()
        sources = [source] + ([primary] if primary.id != source.id else [])

        def pull(store, index: str, field: Optional[str] = None) -> None:
            for node in sources:
                try:
                    store.apply_log(self._client.translate_data(
                        node.uri, index, field, store.replica_offset),
                        resume=True)
                    return
                except ClientError:
                    continue

        for idx in list(self.holder.indexes.values()):
            if idx.keys:
                pull(idx.column_translator, idx.name)
            for f in list(idx.fields.values()):
                if f.options.keys:
                    pull(f.row_translator, idx.name, f.name)

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
              remote: bool = False, profile: bool = False
              ) -> Dict[str, Any]:
        """The direct path: ``{"results": [...]}`` of one request.
        ``remote=True`` marks a node-to-node leg: it runs its shards
        here only and answers the results alone (the coordinator shapes
        the response). ``profile=True`` (``?profile=true``) embeds the
        profile tree under ``"profile"``, with device sampling on."""
        _FP_QUERY.fire(index=index, remote=remote)
        tl = self._begin_timeline(index)
        prof = self.profiler.begin(index, query, shards,
                                   force=bool(profile))
        prof.timeline = tl
        t0 = time.perf_counter()
        err = None
        try:
            resp = self._query(index, query, shards, remote, prof)
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

    def _query(self, index: str, query: Any,
               shards: Optional[Sequence[int]], remote: bool,
               prof: Any) -> Dict[str, Any]:
        with self.tracer.span("API.Query", index=index) as sp:
            self.stats.count("query", 1)
            try:
                if remote:
                    results = self.executor.execute(index, query,
                                                    shards=shards,
                                                    profile=prof)
                    return {"results": [result_to_json(r)
                                        for r in results]}
                if self.cluster_executor is not None:
                    # A fresh parse: the fan-out consumes Options(shards=)
                    # from the tree it is given.
                    q = parse_string(query) if isinstance(query, str) \
                        else query
                    resp = {"results": self.cluster_executor.execute(
                        index, q, shards=shards, profile=prof)}
                    self._attach_column_attrs(index, q, resp)
                    return resp
                return self.executor.execute_full(index, query,
                                                  shards=shards,
                                                  profile=prof)
            finally:
                prof.annotate_span(sp)

    def _attach_column_attrs(self, index: str, q: Any,
                             resp: Dict[str, Any]) -> None:
        """The coordinator's ``columnAttrs``: when an Options asks for
        them, the attributes of every merged Row column, from this
        node's store (attribute writes reach every node)."""
        if not any(c.name == "Options" and c.args.get("columnAttrs")
                   for c in q.calls):
            return
        idx = self.holder.index(index)
        if idx is None:
            return
        ids = sorted({int(c) for r in resp["results"]
                      if isinstance(r, dict) for c in r.get("columns", [])})
        resp["columnAttrs"] = column_attr_sets(
            idx, ids,
            resolve=lambda xs: self._resolve_ids_via_primary(index, None,
                                                             xs))

    def query_coalesced(self, index: str, query: Any,
                        shards: Optional[Sequence[int]] = None,
                        remote: bool = False, profile: bool = False
                        ) -> Dict[str, Any]:
        """``query`` through the coalescer when one is attached and
        running: concurrent requests share executor batches. A cluster
        node and a remote leg take the direct path (the fan-out's legs
        already run per node). Only a coalescer that stopped under the
        request (``CoalescerStopped``) re-runs it on the direct path;
        any other error is the request's. A forced profile is never
        shared with an identical batchmate."""
        from pilosa_tpu_torch.server.coalescer import CoalescerStopped
        coal = self.coalescer
        if coal is None or not coal.running or remote \
                or self.cluster_executor is not None:
            return self.query(index, query, shards=shards, remote=remote,
                              profile=profile)
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
            if self.cluster_executor is not None:
                # The cluster path runs the items in turn (each fans
                # out); query() counts the "query" stat per item.
                out = []
                for it in items:
                    try:
                        out.append(self.query(it["index"], it["query"],
                                              shards=it.get("shards"),
                                              profile=profile))
                    except Exception as e:
                        out.append({"error": str(e)})
                return out
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

    def _validate_normal(self, method: str) -> None:
        """Schema changes are refused while the cluster is RESIZING
        (queries and imports stay available)."""
        if self.cluster is not None and \
                self.cluster.state == STATE_RESIZING:
            raise ApiError(
                f"api method {method} not allowed in state RESIZING", 409)

    def _broadcast_schema(self, remote: bool, send) -> None:
        """A schema change made here is sent to every other node (a
        ``remote`` one is such a copy); a node that misses it is left
        to anti-entropy."""
        if remote or self.cluster is None:
            return
        for node in self.cluster.nodes():
            if node.id == self.cluster.local.id:
                continue
            try:
                send(node.uri)
            except ClientError:
                pass

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True,
                     remote: bool = False) -> Dict[str, Any]:
        self._validate_normal("CreateIndex")
        try:
            idx = self.holder.create_index(name, keys=keys,
                                           track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        self._broadcast_schema(remote, lambda uri: self._client
                               .create_index_node(uri, name, {
                                   "keys": keys,
                                   "trackExistence": track_existence}))
        return {"name": idx.name}

    def delete_index(self, name: str) -> None:
        self._validate_normal("DeleteIndex")
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    def create_field(self, index: str, name: str,
                     options: Optional[dict] = None,
                     remote: bool = False) -> Dict[str, Any]:
        self._validate_normal("CreateField")
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
        self._broadcast_schema(remote, lambda uri: self._client
                               .create_field_node(uri, index, name,
                                                  dict(options or {})))
        return {"name": f.name}

    def delete_field(self, index: str, name: str) -> None:
        self._validate_normal("DeleteField")
        idx = self._index(index)
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    # --------------------------------------------------------------- imports

    def import_bits(self, index: str, field: str, rows=None, columns=None,
                    row_keys=None, column_keys=None, timestamps=None,
                    clear: bool = False, remote: bool = False,
                    ignore_key_check: bool = False) -> None:
        """Bulk bit import: the bits go into the field's standard view
        and, with ``timestamps`` (time fields), into each time's views;
        the columns go into existence unless ``clear``. A timestamp is
        seconds since the epoch (int or float, read in local time, as
        ``datetime.fromtimestamp`` reads it) or a PQL timestamp
        string. A keyed index takes ``column_keys`` and a keyed field
        ``row_keys`` in place of ids; new keys are allocated ids in the
        order they first appear (on the translate primary in a cluster).

        In a cluster the bits go to every replica that owns their shard
        (``_import_fanout``); a ``remote`` import is such a leg, already
        translated, so it skips the key checks (as ``ignore_key_check``
        does)."""
        idx = self._index(index)
        f = self._field(idx, field)
        if not remote and not ignore_key_check:
            if f.options.keys and row_keys is None and rows is not None:
                raise ApiError("row ids cannot be used because field uses "
                               "string keys")
            if idx.keys and column_keys is None and columns is not None:
                raise ApiError("column ids cannot be used because index "
                               "uses string keys")
        row_keys = _string_keys("rowKeys", row_keys)
        column_keys = _string_keys("columnKeys", column_keys)
        if column_keys is not None:
            columns = self._column_ids(idx, column_keys)
        if row_keys is not None:
            if not f.options.keys:
                raise ApiError(f"field {field} does not use row keys")
            rows = self.executor.row_keys(idx, f, row_keys)
        rows = np.asarray(rows, dtype=np.uint64)
        columns = np.asarray(columns, dtype=np.uint64)
        if len(rows) != len(columns):
            raise ApiError("rows and columns length mismatch")
        if self.cluster is not None and not remote:
            self._import_fanout(index, field, rows, columns, timestamps,
                                clear, values=None)
            # After the fan-out: peers told now re-discover shard lists
            # that hold the new shards.
            self.cluster_executor.note_written_shards(
                index, np.unique(columns // np.uint64(SHARD_WIDTH)).tolist())
            return
        ts = None
        if timestamps is not None:
            ts = [datetime.fromtimestamp(t) if isinstance(t, (int, float))
                  else (timeq.parse_timestamp(t) if isinstance(t, str) else t)
                  for t in timestamps]
        f.import_bits(rows, columns, timestamps=ts, clear=clear)
        if not clear:
            idx.add_existence(columns)
        if self.cluster_executor is not None:
            # A leg: the coordinator tells the peers.
            self.cluster_executor.invalidate_shards_cache(index)

    def _import_fanout(self, index: str, field: str, rows, columns,
                       timestamps, clear: bool, values) -> None:
        """Send each bit (or value) to every node that owns its shard:
        this node's share is imported here, the others' as one remote
        import a node. A node that fails its import is left to
        anti-entropy, as in the JAX package."""
        shards = columns // np.uint64(SHARD_WIDTH)
        masks: Dict[str, np.ndarray] = {}
        for shard in np.unique(shards).tolist():
            hit = shards == np.uint64(shard)
            for node in self.cluster.write_nodes(index, int(shard)):
                m = masks.get(node.id)
                masks[node.id] = hit if m is None else (m | hit)
        for node_id, mask in masks.items():
            sel = np.flatnonzero(mask)
            body: Dict[str, Any] = {"columnIDs": columns[sel].tolist()}
            if values is not None:
                body["values"] = values[sel].tolist()
            else:
                body["rowIDs"] = rows[sel].tolist()
                if timestamps is not None:
                    body["timestamps"] = [timestamps[i] for i in sel]
            if node_id == self.cluster.local.id:
                if values is not None:
                    self.import_values(index, field,
                                       columns=body["columnIDs"],
                                       values=body["values"], clear=clear,
                                       remote=True)
                else:
                    self.import_bits(index, field, rows=body["rowIDs"],
                                     columns=body["columnIDs"],
                                     timestamps=body.get("timestamps"),
                                     clear=clear, remote=True)
                continue
            node = self.cluster.node_by_id(node_id)
            try:
                self._client.import_node(node.uri, index, field, body,
                                         clear=clear)
            except ClientError:
                pass

    def import_values(self, index: str, field: str, columns=None,
                      values=None, column_keys=None,
                      clear: bool = False, remote: bool = False,
                      ignore_key_check: bool = False) -> None:
        """Bulk integer import into an int field's BSI view; a keyed
        index takes ``column_keys`` in place of ids. In a cluster the
        values go to every replica that owns their shard."""
        idx = self._index(index)
        f = self._field(idx, field)
        if not remote and not ignore_key_check and idx.keys \
                and column_keys is None and columns is not None:
            raise ApiError("column ids cannot be used because index uses "
                           "string keys")
        column_keys = _string_keys("columnKeys", column_keys)
        if column_keys is not None:
            columns = self._column_ids(idx, column_keys)
        columns = np.asarray(columns, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if len(columns) != len(values):
            raise ApiError("columns and values length mismatch")
        if self.cluster is not None and not remote:
            self._import_fanout(index, field, None, columns, None, clear,
                                values=values)
            self.cluster_executor.note_written_shards(
                index, np.unique(columns // np.uint64(SHARD_WIDTH)).tolist())
            return
        try:
            f.import_values(columns, values, clear=clear)
        except ValueError as e:
            raise ApiError(str(e))
        if not clear:
            idx.add_existence(columns)
        if self.cluster_executor is not None:
            self.cluster_executor.invalidate_shards_cache(index)

    def import_roaring(self, index: str, field: str, shard: int,
                       data: bytes, clear: bool = False,
                       view: str = "standard",
                       remote: bool = False) -> None:
        """Union a serialized roaring bitmap into one shard of a view of
        the field (with ``clear``, clear its bits), then mark every
        column the fragment holds in existence. Malformed bytes answer
        400. It stays on this node in a cluster too (the client sends
        it to each owner, ``GET /internal/fragment/nodes``); a
        ``remote`` one drops only this node's shard list, any other
        tells the peers about a new shard."""
        idx = self._index(index)
        f = self._field(idx, field)
        frag = f.create_view_if_not_exists(view) \
            .create_fragment_if_not_exists(shard)
        try:
            frag.import_roaring(data, clear=clear)
        except ValueError as e:
            raise ApiError(f"invalid roaring payload: {e}")
        idx.add_existence_words(shard, frag.column_words())
        if self.cluster_executor is not None:
            if remote:
                self.cluster_executor.invalidate_shards_cache(index)
            else:
                self.cluster_executor.note_written_shards(index,
                                                          [int(shard)])

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
                                 node_id=self._node_ident()[0])

    def debug_roofline(self) -> Dict[str, Any]:
        """The ``GET /debug/roofline`` document: the recorder's byte
        splits, opcode totals, per-cohort bandwidth and drift, with the
        executor's cumulative splits beside them."""
        from pilosa_tpu_torch.utils.roofline import ROOFLINE
        self.refresh_memory_gauges()
        doc = ROOFLINE.snapshot()
        doc["node"] = self._node_ident()[0]
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
        if self.cluster is not None:
            down = set(self.cluster.down_ids)
            for nid in down:
                SENTINEL.note_condition(
                    f"cluster.node_down:{nid}", True,
                    f"node {nid} marked down by the failure detector",
                    kind="cluster")
            for nid in self._sentinel_down_prev - down:
                SENTINEL.note_condition(
                    f"cluster.node_down:{nid}", False,
                    f"node {nid} recovered", kind="cluster")
            self._sentinel_down_prev = down

    def debug_history(self, series: Optional[List[str]] = None,
                      last: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /debug/history`` document: the sentinel's history
        rings (raw and decimated) and their trace-event counter tracks."""
        self.refresh_memory_gauges()
        doc = SENTINEL.history(series=series, last=last)
        doc["node"] = self._node_ident()[0]
        return doc

    def debug_slo(self) -> Dict[str, Any]:
        """The ``GET /debug/slo`` document: the declared objectives,
        their error budgets and burn rates, the request rates and
        windowed quantiles by endpoint, and the alert ring."""
        self.refresh_memory_gauges()
        doc = SENTINEL.slo_snapshot()
        doc["node"] = self._node_ident()[0]
        return doc

    def node_health(self) -> Dict[str, Any]:
        """The ``GET /internal/health`` document, with the JAX package's
        keys: memory totals, the coalescer, the executor's launch, plan
        and roofline counters, the result and rank caches, the
        slow-query counts, the workload summary, the timeline, the
        watchdog, the SLO stanza, the layout, the failpoints, and this
        node's cluster lifecycle events and placement generation (none
        and 0 on a single node). The JAX executor's compile-cache and
        vmapped-fusion counters, which the port has no counterpart of,
        answer 0."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        now = time.time()
        node_id, uri = self._node_ident()
        state = self.cluster.state if self.cluster is not None \
            else "NORMAL"
        mem = LEDGER.snapshot(top_k=3)
        coal = self.coalescer
        wd = self.watchdog
        ex = self.executor
        return {
            "id": node_id,
            "uri": uri,
            "state": state,
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
            "clusterEvents": (self.cluster.recent_events(32)
                              if self.cluster is not None else []),
            "placementGen": (self.cluster.placement_gen
                             if self.cluster is not None else 0),
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
        if self.cluster is not None:
            return self.cluster.status()
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

    # --------------------------------------------------------------- cluster

    def _node_ident(self):
        """(id, uri) of this node: the cluster's local node, or the
        single node's id and no uri."""
        if self.cluster is not None:
            return self.cluster.local.id, self.cluster.local.uri
        return self.node_id, ""

    def local_shards(self) -> Dict[str, List[int]]:
        """Shards held here, by index (``GET /internal/local-shards``,
        the coordinators' shard discovery)."""
        return {idx.name: idx.available_shards()
                for idx in list(self.holder.indexes.values())}

    def views_of(self, index: str, field: str) -> List[str]:
        idx = self._index(index)
        return sorted(self._field(idx, field).views.keys())

    def shards_max(self) -> Dict[str, int]:
        """``GET /internal/shards/max``: the largest shard held here, by
        index."""
        out = {}
        for idx in list(self.holder.indexes.values()):
            shards = idx.available_shards()
            out[idx.name] = max(shards) if shards else 0
        return out

    def fragment_nodes(self, index: str, shard: int) -> List[dict]:
        """``GET /internal/fragment/nodes``: the nodes that own a shard,
        primary first."""
        self._index(index)  # 404 on an unknown index
        if self.cluster is None:
            return [{"id": "local", "uri": "", "isCoordinator": True}]
        return [n.to_json()
                for n in self.cluster.shard_nodes(index, int(shard))]

    def handle_cluster_message(self, msg: dict) -> None:
        """``POST /internal/cluster/message``: a translate primary pin
        (which lifts this node's serving limit when it is the new
        primary) and the shard-list invalidation of a static cluster.
        The membership and resize messages answer an error naming the
        part they belong to; an unknown type is ignored, as in the JAX
        package."""
        if self.cluster is None:
            return
        typ = msg.get("type")
        if typ in _RESIZE_MESSAGES:
            raise not_ported(f"cluster message {typ!r} ({RESIZE_PART})")
        if msg.get("translatePrimary"):
            self.cluster.pin_translate_primary(msg["translatePrimary"])
            if msg["translatePrimary"] == self.cluster.local.id:
                self._lift_translate_serving()
        if typ == "shards-changed":
            self.cluster_executor.invalidate_shards_cache(msg["index"])

    def _fan_docs(self, fetch) -> Dict[str, Any]:
        """``fetch(node)`` for every member at once, each on a thread;
        returns {node id: what it returned}."""
        docs: Dict[str, Any] = {}
        members = list(self.cluster.nodes())

        def run(node):
            docs[node.id] = fetch(node)

        threads = [threading.Thread(target=run, args=(n,))
                   for n in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return docs

    @staticmethod
    def _merge_health_totals(nodes: List[Dict[str, Any]]
                             ) -> Dict[str, Any]:
        tot = {"memoryBytes": 0, "paddingBytes": 0, "queueDepth": 0,
               "jitCacheSize": 0, "retraces": 0, "slowQueries": 0,
               "fragmentReads": 0, "fragmentWrites": 0,
               "launchBytes": 0, "rooflineDriftFlags": 0,
               "sloAlertsActive": 0, "sloAlertsFired": 0}
        for d in nodes:
            mem = d.get("memory") or {}
            tot["memoryBytes"] += int(mem.get("totalBytes", 0))
            tot["paddingBytes"] += int(mem.get("paddingBytes", 0))
            tot["queueDepth"] += int(
                (d.get("coalescer") or {}).get("queueDepth", 0))
            ex = d.get("executor") or {}
            tot["jitCacheSize"] += int(ex.get("jitCacheSize", 0))
            tot["retraces"] += int(ex.get("retraces", 0))
            tot["slowQueries"] += int(d.get("slowQueries", 0))
            wl = d.get("workload") or {}
            tot["fragmentReads"] += int(wl.get("fragmentReads", 0))
            tot["fragmentWrites"] += int(wl.get("fragmentWrites", 0))
            rf = ex.get("roofline") or {}
            tot["launchBytes"] += int(rf.get("launchBytes", 0))
            tot["rooflineDriftFlags"] += int(rf.get("driftFlags", 0))
            slo = d.get("slo") or {}
            tot["sloAlertsActive"] += int(slo.get("alertsActive", 0))
            tot["sloAlertsFired"] += int(slo.get("alertsFired", 0))
        return tot

    def cluster_health(self) -> Dict[str, Any]:
        """``GET /cluster/health``: every member's health document (this
        node's inline, the others' fetched at once), with liveness (an
        unreachable node is unhealthy with its error, a down-marked one
        ``down``), staleness (``ageS`` on this node's clock) and fleet
        totals over the nodes that answered."""
        now = time.time()
        local = self.node_health()
        if self.cluster is None:
            local["down"] = False
            local["ageS"] = 0.0
            nodes = [local]
            return {"state": "NORMAL", "totalNodes": 1,
                    "healthyNodes": 1, "nodes": nodes,
                    "totals": self._merge_health_totals(nodes)}
        down = set(self.cluster.down_ids)

        def fetch(node):
            if node.id == self.cluster.local.id:
                return local
            try:
                doc = self._client.node_health(node.uri)
                if not isinstance(doc, dict):
                    raise ValueError(f"bad health body: {doc!r}")
            except Exception as e:
                doc = {"id": node.id, "uri": node.uri, "healthy": False,
                       "error": f"{type(e).__name__}: {e}"}
            doc["_received"] = time.time()
            return doc

        members = list(self.cluster.nodes())
        docs = self._fan_docs(fetch)
        nodes = []
        end = time.time()
        for node in members:
            doc = docs.get(node.id,
                           {"id": node.id, "uri": node.uri,
                            "healthy": False, "error": "no response"})
            doc.setdefault("id", node.id)
            doc.setdefault("uri", node.uri)
            doc["down"] = node.id in down
            if doc["down"]:
                doc["healthy"] = False
            received = doc.pop("_received", now)
            doc["ageS"] = max(0.0, end - received)
            nodes.append(doc)
        return {
            "state": self.cluster.state,
            "coordinator": next((n.id for n in members
                                 if n.is_coordinator), None),
            "totalNodes": len(nodes),
            "healthyNodes": sum(1 for d in nodes if d.get("healthy")),
            "nodes": nodes,
            "totals": self._merge_health_totals(
                [d for d in nodes if "memory" in d]),
        }

    def _cluster_docs(self, key: str, local: Dict[str, Any],
                      fetch) -> List[Dict[str, Any]]:
        """Every member's ``key`` document, as {id, uri, healthy, key}
        or {id, uri, healthy: false, error}, down-marked nodes
        unhealthy."""
        down = set(self.cluster.down_ids)

        def one(node):
            if node.id == self.cluster.local.id:
                return {"id": node.id, "uri": node.uri, "healthy": True,
                        key: local}
            try:
                doc = fetch(node)
                if not isinstance(doc, dict):
                    raise ValueError(f"bad {key} body: {doc!r}")
                return {"id": node.id, "uri": node.uri, "healthy": True,
                        key: doc}
            except Exception as e:
                return {"id": node.id, "uri": node.uri, "healthy": False,
                        "error": f"{type(e).__name__}: {e}"}

        docs = self._fan_docs(one)
        nodes = []
        for node in self.cluster.nodes():
            doc = docs.get(node.id, {"id": node.id, "uri": node.uri,
                                     "healthy": False,
                                     "error": "no response"})
            doc["down"] = node.id in down
            if doc["down"]:
                doc["healthy"] = False
            nodes.append(doc)
        return nodes

    def cluster_hotspots(self, top_k: Optional[int] = None
                         ) -> Dict[str, Any]:
        """``GET /cluster/hotspots``: every member's ``/debug/hotspots``
        with fleet workload totals; an unreachable node is reported."""
        local = self.debug_hotspots(top_k=top_k)
        if self.cluster is None:
            nodes = [{"id": self.node_id, "uri": "", "healthy": True,
                      "hotspots": local}]
            return {"totalNodes": 1, "respondedNodes": 1,
                    "nodes": nodes,
                    "totals": self._merge_hotspot_totals(nodes)}
        nodes = self._cluster_docs(
            "hotspots", local,
            lambda n: self._client.node_hotspots(n.uri, top_k=top_k))
        return {"totalNodes": len(nodes),
                "respondedNodes": sum(1 for d in nodes if "hotspots" in d),
                "nodes": nodes,
                "totals": self._merge_hotspot_totals(nodes)}

    @staticmethod
    def _merge_hotspot_totals(nodes: List[Dict[str, Any]]
                              ) -> Dict[str, Any]:
        tot = {"fragmentReads": 0, "fragmentWrites": 0, "queries": 0,
               "windowSeen": 0, "windowRepeats": 0}
        for d in nodes:
            hs = d.get("hotspots") or {}
            t = hs.get("totals") or {}
            tot["fragmentReads"] += int(t.get("fragmentReads", 0))
            tot["fragmentWrites"] += int(t.get("fragmentWrites", 0))
            tot["queries"] += int(t.get("queries", 0))
            w = hs.get("queriesWindow") or {}
            tot["windowSeen"] += int(w.get("seen", 0))
            tot["windowRepeats"] += int(w.get("repeats", 0))
        tot["queryRepeatRatio"] = (
            tot["windowRepeats"] / tot["windowSeen"]
            if tot["windowSeen"] else 0.0)
        return tot

    def cluster_slo(self) -> Dict[str, Any]:
        """``GET /cluster/slo``: every member's ``/debug/slo`` with one
        fleet error budget an objective; an unreachable node is
        reported."""
        local = self.debug_slo()
        if self.cluster is None:
            nodes = [{"id": self.node_id, "uri": "", "healthy": True,
                      "slo": local}]
            return {"totalNodes": 1, "respondedNodes": 1,
                    "nodes": nodes,
                    "totals": self._merge_slo_totals(nodes)}
        nodes = self._cluster_docs(
            "slo", local, lambda n: self._client.node_slo(n.uri))
        return {"totalNodes": len(nodes),
                "respondedNodes": sum(1 for d in nodes if "slo" in d),
                "nodes": nodes,
                "totals": self._merge_slo_totals(nodes)}

    @staticmethod
    def _merge_slo_totals(nodes: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Per-objective bad and total sums over the nodes that answered,
        re-derived into one fleet budget."""
        tot: Dict[str, Any] = {"alertsActive": 0, "alertsFired": 0,
                               "endpoints": {}}
        for d in nodes:
            doc = d.get("slo") or {}
            alerts = doc.get("alerts") or {}
            tot["alertsActive"] += len(alerts.get("active") or [])
            tot["alertsFired"] += int(alerts.get("fired", 0))
            for ep in doc.get("endpoints") or []:
                if "target" not in ep:
                    continue
                label = ep.get("alias") or ep["endpoint"]
                agg = tot["endpoints"].setdefault(
                    label, {"target": ep["target"], "total": 0, "bad": 0})
                agg["total"] += int(ep.get("total", 0))
                agg["bad"] += int(ep.get("bad", 0))
        for agg in tot["endpoints"].values():
            budget = 1.0 - agg["target"]
            consumed = ((agg["bad"] / agg["total"]) / budget
                        if agg["total"] and budget > 0 else 0.0)
            agg["budgetConsumed"] = consumed
            agg["budgetRemaining"] = max(0.0, 1.0 - consumed)
        return tot

    @staticmethod
    def _merge_timeline_events(pid: int, node_id: str,
                               doc: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One node's slices re-based under ``pid``, each stamped with
        its node in ``args``."""
        from pilosa_tpu_torch.utils.timeline import TimelineRecorder
        evs = TimelineRecorder.metadata_events(pid, node_id)
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            ev = dict(ev)
            ev["pid"] = pid
            args = dict(ev.get("args") or {})
            args["node"] = node_id
            ev["args"] = args
            evs.append(ev)
        return evs

    def cluster_timeline(self, trace_id: str) -> Dict[str, Any]:
        """``GET /cluster/timeline/{trace}``: every member's slices of one
        trace id as one trace-event document, this node pid 0 and each
        other member its own pid; an unreachable node is reported with
        its error."""
        node_id, uri = self._node_ident()
        local = self.debug_timeline(trace=trace_id)
        if self.cluster is None:
            nodes = [{"id": node_id, "uri": uri, "healthy": True,
                      "down": False,
                      "events": local["summary"]["requests"]}]
            return {"traceId": trace_id, "totalNodes": 1,
                    "respondedNodes": 1, "nodes": nodes,
                    "displayTimeUnit": "ms",
                    "traceEvents": self._merge_timeline_events(
                        0, node_id, local)}
        down = set(self.cluster.down_ids)

        def fetch(node):
            if node.id == self.cluster.local.id:
                return local
            try:
                doc = self._client.node_timeline(node.uri, trace_id)
                if not isinstance(doc, dict):
                    raise ValueError(f"bad timeline body: {doc!r}")
                return doc
            except Exception as e:
                return {"error": f"{type(e).__name__}: {e}"}

        docs = self._fan_docs(fetch)
        # This node first: pid 0 is the node that assembled it.
        members = sorted(self.cluster.nodes(),
                         key=lambda n: n.id != self.cluster.local.id)
        nodes = []
        events: List[Dict[str, Any]] = []
        for pid, node in enumerate(members):
            doc = docs.get(node.id, {"error": "no response"})
            entry: Dict[str, Any] = {"id": node.id, "uri": node.uri,
                                     "pid": pid,
                                     "healthy": "error" not in doc,
                                     "down": node.id in down}
            if entry["down"]:
                entry["healthy"] = False
            if "error" in doc:
                entry["error"] = doc["error"]
            else:
                entry["events"] = doc.get("summary", {}).get("requests", 0)
                events.extend(self._merge_timeline_events(pid, node.id,
                                                          doc))
            nodes.append(entry)
        return {"traceId": trace_id, "totalNodes": len(nodes),
                "respondedNodes": sum(1 for n in nodes
                                      if "error" not in n),
                "nodes": nodes, "displayTimeUnit": "ms",
                "traceEvents": events}

    def cluster_timeline_events(self) -> Dict[str, Any]:
        """``GET /cluster/timeline``: every member's lifecycle event ring
        (heartbeat down and up, membership) merged by time, each event
        stamped with the node that observed it, and as trace-event
        instants."""
        from pilosa_tpu_torch.utils.timeline import TimelineRecorder
        health = self.cluster_health()
        merged: List[Dict[str, Any]] = []
        trace_events: List[Dict[str, Any]] = []
        for pid, nd in enumerate(health["nodes"]):
            evs = nd.get("clusterEvents") or []
            if evs:
                trace_events.extend(TimelineRecorder.metadata_events(
                    pid, str(nd.get("id", pid))))
            for ev in evs:
                merged.append({**ev, "observer": nd.get("id")})
                trace_events.append({
                    "ph": "i", "s": "g", "pid": pid, "tid": 0,
                    "ts": float(ev.get("time", 0.0)) * 1e6,
                    "name": ev.get("type", "event"),
                    "args": {k: v for k, v in ev.items()
                             if k not in ("time", "type")},
                })
        merged.sort(key=lambda e: e.get("time", 0.0))
        return {
            "state": health["state"],
            "totalNodes": health["totalNodes"],
            "respondedNodes": sum(1 for n in health["nodes"]
                                  if "clusterEvents" in n),
            "events": merged,
            "displayTimeUnit": "ms",
            "traceEvents": trace_events,
        }

    # --------------------------------------------------------------- helpers

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index not found: {name}", 404)
        return idx

    def _column_ids(self, idx, column_keys) -> np.ndarray:
        if not idx.keys:
            raise ApiError(f"index {idx.name} does not use column keys")
        return self.executor.col_keys(idx, column_keys)

    def _field(self, idx, name: str):
        f = idx.field(name)
        if f is None:
            raise ApiError(f"field not found: {name}", 404)
        return f
