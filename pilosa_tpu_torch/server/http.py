"""HTTP surface of the port's server: the routes of the JAX package's
``server/http.py`` on the stdlib threading HTTP server, over HTTP or
HTTPS (``serve(ssl_context=)``).

Routes:
  GET    /  /schema  /status  /info  /version
  GET    /index  /index/{i}  /index/{i}/field
  GET    /export?index&field&shard  one shard as ``row,col`` CSV
  GET    /metrics              Prometheus text of the stats client
  GET    /debug/vars           the stats client's snapshot as JSON
  GET    /debug/queries        the slow-query ring and launch counters
  GET    /debug/memory         the memory ledger and the layout stanza
  GET    /debug/timeline?last&trace  trace-event JSON of the timelines
  GET    /debug/roofline       per-launch bytes, bandwidth and drift
  GET    /debug/hotspots?topk  hot fragments, rows and signatures, the
                               repeat windows, the opportunity report
                               and the result and rank caches
  GET    /debug/history?series&last  the sentinel's history rings
  GET    /debug/slo            objectives, burn rates, quantiles, alerts
  GET    /internal/health      this node's health document
  GET    /internal/failpoints  the failpoint sites (403 unless enabled
                               at boot)
  GET    /cluster/health  /cluster/hotspots?topk  /cluster/slo
                               every member's document, merged
  GET    /cluster/timeline     the members' lifecycle events, merged
  GET    /cluster/timeline/{trace}  one trace's slices on every member
  GET    /internal/nodes  /internal/local-shards
  GET    /internal/views?index&field  /internal/shards/max
  GET    /internal/fragment/nodes?index&shard  the owners of a shard
  GET    /internal/translate/data?index&field&offset  the translate
                               log's replication stream
  GET    /internal/fragment/blocks?index&field&view&shard  the block
                               digests of a fragment
  GET    /internal/fragment/block/data?index&field&view&shard&block
                               one block's (row, column) pairs
  GET    /internal/fragment/data?index&field&view&shard  the whole
                               fragment (roaring bytes)
  GET    /internal/attr/blocks?index&field  the block digests of an
                               attribute store (the index's without
                               field)
  GET    /internal/attr/block/data?index&field&block  one block's
                               attributes
  POST   /index/{i}/query      raw PQL, {"query": ...}, or a protobuf
                               QueryRequest; URL args shards,
                               excludeColumns, excludeRowAttrs,
                               columnAttrs, profile (JSON only: the
                               profile tree in the response), remote
                               (a node-to-node leg)
  POST   /batch/query          {"queries": [{"index", "query",
                               "shards"?}, ...]}, at most 1024; URL
                               arg profile
  POST   /index/{i}/field/{f}/import   JSON {"rowIDs"|"rowKeys",
                               "columnIDs"|"columnKeys"} or
                               {"columnIDs"|"columnKeys", "values"}, or
                               a protobuf ImportRequest /
                               ImportValueRequest; URL args clear,
                               remote, ignoreKeyCheck
  POST   /index/{i}/field/{f}/import-roaring/{shard}  a serialized
                               roaring bitmap (raw bytes), or a protobuf
                               ImportRoaringRequest (per-view bitmaps);
                               URL args clear, view, remote
  POST   /index/{i}            {"options": {"keys", "trackExistence"}}
  POST   /index/{i}/field/{f}  {"options": {...}} (both: URL arg remote,
                               a copy sent by the node that made it)
  POST   /recalculate-caches   rebuild every fragment's TopN count cache
  POST   /internal/failpoints  {"arm": {site: spec}, "disarm": [...],
                               "disarm_all": bool} (403 unless enabled)
  POST   /internal/cluster/message  a cluster message
  POST   /internal/translate/keys  {"index", "field", "keys"} (or a
                               protobuf TranslateKeysRequest): ids,
                               allocated here
  POST   /internal/translate/ids   {"index", "field", "ids"}: keys
  POST   /internal/attr/merge?index&field  {"attrs": {id: {...}}}
  POST   /internal/join        a node's {"id", "uri"}: a seed join
  POST   /internal/sync        one anti-entropy pass: its counts
  POST   /internal/resize/pull  one resize pull pass: fragments fetched
  POST   /cluster/resize/remove-node  {"id"}: the node leaves
  POST   /cluster/resize/set-coordinator  {"id"}
  POST   /cluster/resize/abort  adopt the new placement now
  POST   /cluster/resize/run   pull what this node owns, drop the rest
  DELETE /index/{i}  /index/{i}/field/{f}

JSON query responses ride the coalescer when one is attached; protobuf
queries take the direct path, as in the JAX package. Over a holder with
a data directory every write is in the fragments' files before its 200
goes out. Each request reads a W3C ``traceparent`` (or the legacy
``X-Trace-Id``) into the tracer and runs under an ``HTTP.request``
root span (a query's answer is encoded and written under
``HTTP.encode``), and its response carries the ``traceparent`` of the
trace it ran under, the id ``/debug/timeline`` and ``/debug/queries``
know it by. Every request is observed in
``pilosa_http_request_seconds{endpoint,status}`` (endpoints labelled as
the JAX package labels them, unknown paths as "other"). A request
that accepts ``application/x-pilosa-wire`` gets its JSON answer in the
binary wire codec (``server/wire.py``), and a body of that type is read
with it, as between nodes.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.pql.ast import Call, Query
from pilosa_tpu_torch.server import proto_compat, wire
from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.utils.stats import prometheus_text
from pilosa_tpu_torch.utils.timeline import TIMELINE
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.tracing import TRACEPARENT_HEADER, \
    format_traceparent, new_span_id

# Per-endpoint latency buckets (seconds), the JAX package's: powers of
# two from about 61 us to 8 s.
SLO_BUCKETS = tuple(2.0 ** e for e in range(-14, 4))

# Endpoint labels, the JAX package's: path parameters collapse to
# placeholders so pilosa_http_request_seconds{endpoint=...} stays a
# bounded label set.
_EP_PATTERNS = [
    (re.compile(r"/index/[^/]+/query"), "/index/{index}/query"),
    (re.compile(r"/index/[^/]+/field/[^/]+/import-roaring/\d+"),
     "/index/{index}/field/{field}/import-roaring/{shard}"),
    (re.compile(r"/index/[^/]+/field/[^/]+/import"),
     "/index/{index}/field/{field}/import"),
    (re.compile(r"/index/[^/]+/field/[^/]+"),
     "/index/{index}/field/{field}"),
    (re.compile(r"/index/[^/]+/field"), "/index/{index}/field"),
    (re.compile(r"/index/[^/]+"), "/index/{index}"),
    (re.compile(r"/cluster/timeline/[^/]+"),
     "/cluster/timeline/{trace}"),
]
_EP_STATIC = frozenset({
    "/", "/schema", "/status", "/info", "/version", "/index",
    "/metrics", "/batch/query", "/export", "/recalculate-caches",
    "/debug/vars", "/debug/queries", "/debug/memory", "/debug/hotspots",
    "/debug/timeline", "/debug/roofline", "/debug/history",
    "/debug/slo", "/cluster/health", "/cluster/hotspots",
    "/cluster/slo",
    "/cluster/timeline", "/internal/failpoints",
    "/internal/health", "/internal/nodes", "/internal/local-shards",
    "/internal/views", "/internal/join", "/internal/cluster/message",
    "/internal/sync", "/internal/resize/pull", "/internal/shards/max",
    "/internal/fragment/blocks", "/internal/fragment/block/data",
    "/internal/fragment/data", "/internal/fragment/nodes",
    "/internal/attr/blocks", "/internal/attr/block/data",
    "/internal/attr/merge", "/internal/translate/data",
    "/internal/translate/keys", "/internal/translate/ids",
    "/cluster/resize/remove-node", "/cluster/resize/set-coordinator",
    "/cluster/resize/abort", "/cluster/resize/run",
})


def endpoint_label(path: str) -> str:
    """Bounded endpoint label of a path; unknown paths fold into
    "other", so a scanner walking random URLs mints no series."""
    if path in _EP_STATIC:
        return path
    for rx, label in _EP_PATTERNS:
        if rx.fullmatch(path):
            return label
    return "other"


class Handler(BaseHTTPRequestHandler):
    api: API = None  # bound by make_server
    protocol_version = "HTTP/1.1"
    # Headers and body go out in separate writes; with Nagle on, a
    # keep-alive client would pay a delayed-ACK stall per response.
    disable_nagle_algorithm = True

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):
        pass  # no access log

    def _encode(self, obj: Any, force_json: bool = False):
        """(body, content type) of ``obj``: JSON, or the wire codec when
        the request accepts it (a value the codec cannot hold, an int
        past 64 bits, falls back to JSON)."""
        if not force_json and wire.CONTENT_TYPE in (
                self.headers.get("Accept") or ""):
            try:
                return wire.dumps(obj), wire.CONTENT_TYPE
            except TypeError:
                pass
        return json.dumps(obj).encode("utf-8"), "application/json"

    def _json(self, obj: Any, status: int = 200,
              extra_headers: Optional[dict] = None,
              force_json: bool = False) -> None:
        data, ctype = self._encode(obj, force_json)
        self._bytes(data, status, ctype, extra_headers)

    def _bytes(self, data: bytes, status: int = 200,
               ctype: str = "application/octet-stream",
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        tid = getattr(self, "_trace_id", None)
        if tid:
            self.send_header(TRACEPARENT_HEADER,
                             format_traceparent(tid, new_span_id()))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def send_response(self, code, message=None):
        # The status of the response, for the latency histogram.
        self._slo_status = code
        super().send_response(code, message)

    def _observe_slo(self, method: str, path: str, dur: float) -> None:
        """One latency observation per request, by endpoint and status;
        a slow request on another route than the query routes goes into
        the slow-query ring under its trace id."""
        api = self.api
        ep = endpoint_label(path)
        status = getattr(self, "_slo_status", 200)
        api.stats.with_tags(f"endpoint:{ep}", f"status:{status}").histogram(
            "http_request_seconds", dur, buckets=SLO_BUCKETS)
        lqt = api.long_query_time
        if lqt > 0 and dur > lqt and ep not in (
                "/index/{index}/query", "/batch/query"):
            api.profiler.record_slow("-", f"{method} {ep}", dur,
                                     kind="http",
                                     trace_id=getattr(self, "_trace_id",
                                                      None))

    def _error(self, msg: str, status: int = 400,
               extra_headers: Optional[dict] = None) -> None:
        self._json({"error": msg}, status, extra_headers, force_json=True)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _body_json(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
        if (self.headers.get("Content-Type") or "").startswith(
                wire.CONTENT_TYPE):
            try:
                return wire.loads(raw)
            except wire.WireError as e:
                raise ApiError(f"invalid wire body: {e}")
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid JSON body: {e}")

    def _is_proto(self) -> bool:
        return (self.headers.get("Content-Type") or "").startswith(
            proto_compat.CONTENT_TYPE)

    @staticmethod
    def _qbool(q: dict, name: str) -> bool:
        """On for '1'/'true' (any case), off otherwise."""
        return (q.get(name) or "").lower() in ("1", "true")

    @staticmethod
    def _check_args(q: dict, *allowed: str) -> None:
        """Reject unknown URL args with 400."""
        unknown = set(q) - set(allowed)
        if unknown:
            raise ApiError(
                f"invalid query params: {' '.join(sorted(unknown))}")

    @staticmethod
    def _wrap_options(pql: Any, optargs: dict) -> Any:
        """Every call of a PQL string wrapped in Options(...): the
        request-level execution options of the URL args."""
        if not optargs:
            return pql
        return Query([Call("Options", dict(optargs), [c])
                      for c in parse_string(pql).calls])

    def _exec_optargs(self, q: dict, req: Optional[dict] = None) -> dict:
        """Execution options from URL args, OR'd with protobuf flags."""
        return {k: True for k in
                ("columnAttrs", "excludeRowAttrs", "excludeColumns")
                if self._qbool(q, k) or (req or {}).get(k)}

    def _query_args(self, q: dict) -> Optional[list]:
        """Check the query route's URL args; returns ``shards``."""
        self._check_args(q, "shards", "remote", "columnAttrs",
                         "excludeRowAttrs", "excludeColumns", "profile")
        if q.get("shards"):
            return [int(s) for s in q["shards"].split(",")]
        return None

    # -- dispatch -----------------------------------------------------------

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def _dispatch(self, method: str) -> None:
        parsed = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        path = parsed.path.rstrip("/") or "/"
        tracer = self.api.tracer
        tracer.extract(self.headers)
        self._trace_id = getattr(tracer, "ensure_trace_id",
                                 lambda: None)()
        t0 = time.perf_counter()
        try:
            with tracer.span("HTTP.request", method=method,
                             endpoint=endpoint_label(path)):
                try:
                    if not self._handle(method, path, q):
                        self._error(f"no route for {method} {path}", 404)
                except ApiError as e:
                    # Carries its status (404, 408, 409, 429) and headers
                    # (Retry-After on the coalescer's overload).
                    self._error(str(e), e.status, e.headers)
                except Exception as e:  # the reference's panic recovery
                    self._error(f"internal error: {type(e).__name__}: {e}",
                                500)
        finally:
            try:
                self._observe_slo(method, path, time.perf_counter() - t0)
            except Exception:
                pass  # metrics never fail a served response

    def _handle(self, method: str, path: str, q: dict) -> bool:
        api = self.api
        if method == "GET":
            if path == "/":
                self._json({"pilosa-tpu": True, **api.info()})
            elif path == "/schema":
                self._json(api.schema())
            elif path == "/status":
                self._json(api.status())
            elif path == "/info":
                self._json(api.info())
            elif path == "/version":
                self._json(api.version())
            elif path == "/metrics":
                # The scrape refreshes the gauges first.
                api.refresh_memory_gauges()
                self._bytes(prometheus_text(api.stats).encode(),
                            ctype="text/plain; version=0.0.4")
            elif path == "/debug/vars":
                self._json(getattr(api.stats, "snapshot", lambda: {})())
            elif path == "/debug/queries":
                self._json(api.debug_queries())
            elif path == "/debug/memory":
                self._json(api.debug_memory())
            elif path == "/debug/timeline":
                self._check_args(q, "last", "trace")
                self._json(api.debug_timeline(
                    last=int(q["last"]) if q.get("last") else None,
                    trace=q.get("trace")))
            elif path == "/debug/roofline":
                self._json(api.debug_roofline())
            elif path == "/debug/hotspots":
                self._check_args(q, "topk")
                self._json(api.debug_hotspots(
                    top_k=int(q["topk"]) if q.get("topk") else None))
            elif path == "/debug/history":
                self._check_args(q, "series", "last")
                series = [s for s in (q.get("series") or "").split(",")
                          if s]
                self._json(api.debug_history(
                    series=series or None,
                    last=int(q["last"]) if q.get("last") else None))
            elif path == "/debug/slo":
                self._json(api.debug_slo())
            elif path == "/internal/health":
                self._json(api.node_health())
            elif path == "/internal/failpoints":
                self._json(api.failpoints_snapshot())
            elif path == "/cluster/health":
                self._json(api.cluster_health())
            elif path == "/cluster/hotspots":
                self._check_args(q, "topk")
                self._json(api.cluster_hotspots(
                    top_k=int(q["topk"]) if q.get("topk") else None))
            elif path == "/cluster/slo":
                self._json(api.cluster_slo())
            elif path == "/cluster/timeline":
                self._json(api.cluster_timeline_events())
            elif m := re.fullmatch(r"/cluster/timeline/([^/]+)", path):
                self._json(api.cluster_timeline(m.group(1)))
            elif path == "/internal/fragment/nodes":
                self._check_args(q, "index", "shard")
                self._json(api.fragment_nodes(q["index"], int(q["shard"])))
            elif path == "/internal/fragment/blocks":
                self._check_args(q, "index", "field", "view", "shard")
                self._json({"blocks": api.fragment_blocks(
                    q["index"], q["field"], q.get("view", "standard"),
                    int(q["shard"]))})
            elif path == "/internal/fragment/block/data":
                self._json(api.fragment_block_data(
                    q["index"], q["field"], q.get("view", "standard"),
                    int(q["shard"]), int(q["block"])))
            elif path == "/internal/fragment/data":
                self._check_args(q, "index", "field", "view", "shard")
                self._bytes(api.fragment_data(
                    q["index"], q["field"], q.get("view", "standard"),
                    int(q["shard"])))
            elif path == "/internal/attr/blocks":
                self._json({"blocks": api.attr_blocks(
                    q["index"], q.get("field"))})
            elif path == "/internal/attr/block/data":
                self._json(api.attr_block_data(
                    q["index"], q.get("field"), int(q["block"])))
            elif path == "/internal/shards/max":
                self._json({"standard": api.shards_max()})
            elif path == "/internal/translate/data":
                self._bytes(api.translate_data(
                    q["index"], q.get("field"), int(q.get("offset", 0))))
            elif path == "/internal/nodes":
                self._json(api.status().get("nodes", []))
            elif path == "/internal/local-shards":
                self._json(api.local_shards())
            elif path == "/internal/views":
                self._json({"views": api.views_of(q["index"], q["field"])})
            elif path == "/export":
                self._check_args(q, "index", "field", "shard")
                csv = api.export_csv(q["index"], q["field"],
                                     int(q.get("shard", 0)))
                self._bytes(csv.encode(), ctype="text/csv")
            elif path == "/index":
                self._json(api.schema()["indexes"])
            elif m := re.fullmatch(r"/index/([^/]+)/field", path):
                self._json({"fields": self._index_schema(m.group(1))
                            .get("fields", [])})
            elif m := re.fullmatch(r"/index/([^/]+)", path):
                self._json(self._index_schema(m.group(1)))
            else:
                return False
            return True

        if method == "POST":
            if m := re.fullmatch(r"/index/([^/]+)/query", path):
                self._post_query(m.group(1), q)
            elif path == "/batch/query":
                items = self._body_json().get("queries")
                self._check_args(q, "profile")
                if not isinstance(items, list):
                    raise ApiError("body must carry a 'queries' list")
                if len(items) > 1024:
                    # Every item's device work launches before any
                    # result resolves: the batch must stay bounded.
                    raise ApiError("batch too large (max 1024 queries)")
                self._json({"responses": api.query_batch(
                    items, profile=self._qbool(q, "profile"))})
            elif path == "/recalculate-caches":
                api.recalculate_caches()
                self._json({})
            elif path == "/internal/failpoints":
                self._json(api.failpoints_update(self._body_json()))
            elif path == "/internal/cluster/message":
                api.handle_cluster_message(self._body_json())
                self._json({})
            elif path == "/internal/attr/merge":
                api.attr_merge(q["index"], q.get("field"),
                               self._body_json().get("attrs", {}))
                self._json({})
            elif path == "/internal/join":
                self._json(api.handle_join(self._body_json()))
            elif path == "/internal/sync":
                self._json(api.sync_now())
            elif path == "/internal/resize/pull":
                self._json(api.resize_pull())
            elif path == "/cluster/resize/remove-node":
                self._json(api.remove_node(self._body_json().get("id")))
            elif path == "/cluster/resize/set-coordinator":
                self._json(api.set_coordinator(
                    self._body_json().get("id")))
            elif path == "/cluster/resize/abort":
                self._json(api.resize_abort())
            elif path == "/cluster/resize/run":
                self._json(api.resize_now())
            elif path == "/internal/translate/keys":
                self._post_translate_keys()
            elif path == "/internal/translate/ids":
                b = self._body_json()
                ids = b.get("ids", [])
                self._json({"ids": ids, "keys": api.translate_ids_local(
                    b["index"], b.get("field"), ids)})
            elif m := re.fullmatch(r"/index/([^/]+)/field/([^/]+)/import",
                                   path):
                self._post_import(m.group(1), m.group(2), q)
            elif m := re.fullmatch(
                    r"/index/([^/]+)/field/([^/]+)/import-roaring/(\d+)",
                    path):
                self._post_import_roaring(m.group(1), m.group(2),
                                          int(m.group(3)), q)
            elif m := re.fullmatch(r"/index/([^/]+)/field/([^/]+)", path):
                b = self._body_json()
                self._json(api.create_field(m.group(1), m.group(2),
                                            b.get("options"),
                                            remote=self._qbool(q, "remote")))
            elif m := re.fullmatch(r"/index/([^/]+)", path):
                opts = self._body_json().get("options", {})
                self._json(api.create_index(
                    m.group(1), keys=opts.get("keys", False),
                    track_existence=opts.get("trackExistence", True),
                    remote=self._qbool(q, "remote")))
            else:
                return False
            return True

        if method == "DELETE":
            if m := re.fullmatch(r"/index/([^/]+)/field/([^/]+)", path):
                api.delete_field(m.group(1), m.group(2))
                self._json({})
            elif m := re.fullmatch(r"/index/([^/]+)", path):
                api.delete_index(m.group(1))
                self._json({})
            else:
                return False
            return True
        return False

    def _index_schema(self, name: str) -> dict:
        for idx in self.api.schema()["indexes"]:
            if idx["name"] == name:
                return idx
        raise ApiError(f"index not found: {name}", 404)

    def _post_query(self, index: str, q: dict) -> None:
        # The body is read before any check can answer, so a keep-alive
        # connection never carries an unread body into its next request.
        raw = self._body()
        shards = self._query_args(q)
        if self._is_proto():
            self._query_proto(index, raw, q, shards)
            return
        try:
            body = json.loads(raw) if raw.lstrip()[:1] == b"{" else None
        except json.JSONDecodeError:
            body = None
        pql = (body or {}).get("query") if body else raw.decode()
        try:
            pql = self._wrap_options(pql, self._exec_optargs(q))
            resp = self.api.query_coalesced(
                index, pql, shards=shards, remote=self._qbool(q, "remote"),
                profile=self._qbool(q, "profile"))
        except ApiError:
            raise  # keeps its status (429 overload, 408 deadline)
        except ValueError as e:
            raise ApiError(str(e))
        # The serialize slice (the answer's encoding) attaches to the
        # request this thread just finished, before its bytes go out: a
        # client's next request always finds it.
        with tracing.span("HTTP.encode") as sp:
            data, ctype = self._encode(resp)
            if sp is not None:
                TIMELINE.note_serialize(sp.pc_start, sp.duration())
            self._bytes(data, ctype=ctype)

    def _query_proto(self, index: str, raw: bytes, q: dict,
                     shards: Optional[list]) -> None:
        """Reference-client protobuf query: a QueryRequest in, a
        QueryResponse out (its Err field set on a 400)."""
        try:
            req = proto_compat.decode_query_request(raw)
        except proto_compat.ProtoError as e:
            raise ApiError(f"invalid protobuf body: {e}")
        try:
            pql = self._wrap_options(req["query"],
                                     self._exec_optargs(q, req))
            res = self.api.query(index, pql,
                                 shards=shards or req["shards"] or None,
                                 remote=req["remote"]
                                 or self._qbool(q, "remote"))
            body = proto_compat.encode_query_response(
                res["results"], column_attr_sets=res.get("columnAttrs"))
        except ValueError as e:
            self._bytes(proto_compat.encode_query_response([], err=str(e)),
                        status=400, ctype=proto_compat.RESPONSE_CONTENT_TYPE)
            return
        self._bytes(body, ctype=proto_compat.RESPONSE_CONTENT_TYPE)

    def _post_import(self, index: str, field: str, q: dict) -> None:
        b = self._proto_import_body(index, field) if self._is_proto() \
            else self._body_json()
        self._check_args(q, "clear", "remote", "ignoreKeyCheck")
        clear = self._qbool(q, "clear")
        remote = self._qbool(q, "remote")
        ignore_keys = self._qbool(q, "ignoreKeyCheck")
        if "values" in b:
            self.api.import_values(
                index, field, columns=b.get("columnIDs"), values=b["values"],
                column_keys=b.get("columnKeys"), clear=clear, remote=remote,
                ignore_key_check=ignore_keys)
        else:
            self.api.import_bits(
                index, field, rows=b.get("rowIDs"),
                columns=b.get("columnIDs"), row_keys=b.get("rowKeys"),
                column_keys=b.get("columnKeys"),
                timestamps=b.get("timestamps"), clear=clear, remote=remote,
                ignore_key_check=ignore_keys)
        self._json({})

    def _post_translate_keys(self) -> None:
        """Ids of keys, allocated here: a JSON (or wire) body answers
        ``{"keys", "ids"}``, a protobuf TranslateKeysRequest a
        TranslateKeysResponse."""
        if self._is_proto():
            try:
                b = proto_compat.decode_translate_keys_request(self._body())
            except proto_compat.ProtoError as e:
                raise ApiError(f"invalid protobuf body: {e}")
            ids = self.api.translate_keys_local(b["index"],
                                                b.get("field") or None,
                                                b["keys"])
            self._bytes(proto_compat.encode_translate_keys_response(ids),
                        ctype=proto_compat.RESPONSE_CONTENT_TYPE)
            return
        b = self._body_json()
        keys = b.get("keys", [])
        self._json({"keys": keys, "ids": self.api.translate_keys_local(
            b["index"], b.get("field"), keys)})

    def _post_import_roaring(self, index: str, field: str, shard: int,
                             q: dict) -> None:
        """A raw roaring body goes into ``?view`` (default standard); a
        protobuf ImportRoaringRequest carries a bitmap a view and its
        own clear flag, OR'd with ``?clear``."""
        raw = self._body()
        self._check_args(q, "remote", "clear", "view")
        clear = self._qbool(q, "clear")
        remote = self._qbool(q, "remote")
        view = q.get("view", "standard")
        if self._is_proto():
            try:
                b = proto_compat.decode_import_roaring_request(raw)
            except proto_compat.ProtoError as e:
                raise ApiError(f"invalid protobuf body: {e}")
            for name, blob in b["views"]:
                self.api.import_roaring(index, field, shard, blob,
                                        clear=b["clear"] or clear,
                                        view=name or view, remote=remote)
        else:
            self.api.import_roaring(index, field, shard, raw, clear=clear,
                                    view=view, remote=remote)
        self._json({})

    def _proto_import_body(self, index: str, field: str) -> dict:
        """A reference-client import body, by field type: an int field
        takes an ImportValueRequest, any other an ImportRequest."""
        raw = self._body()
        idx = self.api.holder.index(index)
        f = idx.field(field) if idx is not None else None
        try:
            if f is not None and f.options.type == "int":
                b = proto_compat.decode_import_value_request(raw)
            else:
                b = proto_compat.decode_import_request(raw)
        except proto_compat.ProtoError as e:
            raise ApiError(f"invalid protobuf body: {e}")
        out = {k: v for k, v in b.items()
               if k in ("rowIDs", "columnIDs", "values") and len(v)}
        for k in ("rowKeys", "columnKeys"):
            if b.get(k):
                out[k] = b[k]
        # The reference client sends nanoseconds; the API takes seconds.
        if b.get("timestamps"):
            out["timestamps"] = [t / 1e9 for t in b["timestamps"]]
        if "values" in b and "values" not in out:
            out["values"] = []  # an int field's import keeps its path
        return out


class PilosaHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks its open connections, so
    ``server_close`` also severs idle keep-alive connections."""

    daemon_threads = True
    # The default backlog (5) resets connections under a concurrent
    # burst; a front door needs a deeper accept queue.
    request_queue_size = 128

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._open_conns: set = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._open_conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._open_conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conns_lock:
            conns = list(self._open_conns)
            self._open_conns.clear()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


def make_server(api: API, host: str = "localhost", port: int = 10101,
                ssl_context: Any = None) -> PilosaHTTPServer:
    """A bound (not yet serving) server for ``api``; port 0 picks a free
    one (``server.server_address``). With ``ssl_context`` the listener
    speaks TLS; each connection's handshake runs on its handler thread,
    so a slow client cannot stall the accept loop."""
    handler = type("BoundHandler", (Handler,), {"api": api})
    server = PilosaHTTPServer((host, port), handler)
    if ssl_context is not None:
        server.socket = ssl_context.wrap_socket(
            server.socket, server_side=True, do_handshake_on_connect=False)
    return server


def serve(api: API, host: str = "localhost", port: int = 10101,
          background: bool = False, ssl_context: Any = None
          ) -> PilosaHTTPServer:
    """Serve ``api``; blocks unless ``background``, and returns the
    server (stop it with ``shutdown()`` and ``server_close()``).
    ``ssl_context`` (``Config.server_ssl_context()``) serves HTTPS, to
    clients and to the other nodes alike."""
    server = make_server(api, host, port, ssl_context=ssl_context)
    if background:
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="http-serve").start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server
