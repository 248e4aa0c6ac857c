"""HTTP surface of the port's server: the single-node routes of the JAX
package's ``server/http.py`` on the stdlib threading HTTP server.

Routes:
  GET    /  /schema  /status  /info  /version
  GET    /index  /index/{i}  /index/{i}/field
  POST   /index/{i}/query      raw PQL, {"query": ...}, or a protobuf
                               QueryRequest; URL args shards,
                               excludeColumns, excludeRowAttrs,
                               columnAttrs
  POST   /batch/query          {"queries": [{"index", "query",
                               "shards"?}, ...]}, at most 1024
  POST   /index/{i}/field/{f}/import   JSON {"rowIDs", "columnIDs"} or
                               {"columnIDs", "values"}, or a protobuf
                               ImportRequest / ImportValueRequest
  POST   /index/{i}            {"options": {"trackExistence": ...}}
  POST   /index/{i}/field/{f}  {"options": {...}}
  DELETE /index/{i}  /index/{i}/field/{f}

JSON query responses ride the coalescer when one is attached; protobuf
queries take the direct path, as in the JAX package. Other routes of the
JAX package's server answer 404 with the part that is not ported.
"""

from __future__ import annotations

import json
import re
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.pql.ast import Call, Query
from pilosa_tpu_torch.server import proto_compat
from pilosa_tpu_torch.server.api import API, ApiError, not_ported

# Route prefixes the JAX package's server answers and this one does not
# yet, with the part each needs.
_NOT_PORTED_ROUTES = (
    (re.compile(r"/index/[^/]+/field/[^/]+/import-roaring/\d+"),
     "roaring import"),
    (re.compile(r"/export"), "CSV export"),
    (re.compile(r"/internal/.*"), "the node-to-node API (cluster)"),
    (re.compile(r"/cluster/.*"), "the cluster plane"),
    (re.compile(r"/debug/.*|/metrics"), "the debug and metrics planes"),
    (re.compile(r"/recalculate-caches"), "the rank caches"),
)
# URL args of the query route that name a part not ported.
_QUERY_ARGS_NOT_PORTED = {"remote": "remote query legs (cluster)",
                          "profile": "the query profiler"}


class Handler(BaseHTTPRequestHandler):
    api: API = None  # bound by make_server
    protocol_version = "HTTP/1.1"
    # Headers and body go out in separate writes; with Nagle on, a
    # keep-alive client would pay a delayed-ACK stall per response.
    disable_nagle_algorithm = True

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):
        pass  # no access log

    def _json(self, obj: Any, status: int = 200,
              extra_headers: Optional[dict] = None) -> None:
        self._bytes(json.dumps(obj).encode("utf-8"), status,
                    "application/json", extra_headers)

    def _bytes(self, data: bytes, status: int = 200,
               ctype: str = "application/octet-stream",
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, msg: str, status: int = 400,
               extra_headers: Optional[dict] = None) -> None:
        self._json({"error": msg}, status, extra_headers)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _body_json(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
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
        self._check_args(q, "shards", "columnAttrs", "excludeRowAttrs",
                         "excludeColumns", *_QUERY_ARGS_NOT_PORTED)
        for arg, what in _QUERY_ARGS_NOT_PORTED.items():
            if self._qbool(q, arg):
                raise not_ported(what)
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
        try:
            if not self._handle(method, path, q):
                msg = f"no route for {method} {path}"
                for rx, what in _NOT_PORTED_ROUTES:
                    if rx.fullmatch(path):
                        msg += f": {what} is not ported yet"
                        break
                self._error(msg, 404)
        except ApiError as e:
            # Carries its status (404, 408, 409, 429) and headers
            # (Retry-After on the coalescer's overload).
            self._error(str(e), e.status, e.headers)
        except Exception as e:  # the reference's panic recovery
            self._error(f"internal error: {type(e).__name__}: {e}", 500)

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
                if not isinstance(items, list):
                    raise ApiError("body must carry a 'queries' list")
                if len(items) > 1024:
                    # Every item's device work launches before any
                    # result resolves: the batch must stay bounded.
                    raise ApiError("batch too large (max 1024 queries)")
                self._json({"responses": api.query_batch(items)})
            elif m := re.fullmatch(r"/index/([^/]+)/field/([^/]+)/import",
                                   path):
                self._post_import(m.group(1), m.group(2), q)
            elif m := re.fullmatch(r"/index/([^/]+)/field/([^/]+)", path):
                b = self._body_json()
                self._json(api.create_field(m.group(1), m.group(2),
                                            b.get("options")))
            elif m := re.fullmatch(r"/index/([^/]+)", path):
                opts = self._body_json().get("options", {})
                self._json(api.create_index(
                    m.group(1), keys=opts.get("keys", False),
                    track_existence=opts.get("trackExistence", True)))
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
            resp = self.api.query_coalesced(index, pql, shards=shards)
        except ApiError:
            raise  # keeps its status (429 overload, 408 deadline)
        except ValueError as e:
            raise ApiError(str(e))
        self._json(resp)

    def _query_proto(self, index: str, raw: bytes, q: dict,
                     shards: Optional[list]) -> None:
        """Reference-client protobuf query: a QueryRequest in, a
        QueryResponse out (its Err field set on a 400)."""
        try:
            req = proto_compat.decode_query_request(raw)
        except proto_compat.ProtoError as e:
            raise ApiError(f"invalid protobuf body: {e}")
        try:
            if req["remote"]:
                raise not_ported(_QUERY_ARGS_NOT_PORTED["remote"])
            pql = self._wrap_options(req["query"],
                                     self._exec_optargs(q, req))
            res = self.api.query(index, pql,
                                 shards=shards or req["shards"] or None)
            body = proto_compat.encode_query_response(res["results"])
        except ValueError as e:
            self._bytes(proto_compat.encode_query_response([], err=str(e)),
                        status=400, ctype=proto_compat.RESPONSE_CONTENT_TYPE)
            return
        self._bytes(body, ctype=proto_compat.RESPONSE_CONTENT_TYPE)

    def _post_import(self, index: str, field: str, q: dict) -> None:
        b = self._proto_import_body(index, field) if self._is_proto() \
            else self._body_json()
        self._check_args(q, "clear")
        clear = self._qbool(q, "clear")
        if "values" in b:
            self.api.import_values(
                index, field, columns=b.get("columnIDs"), values=b["values"],
                column_keys=b.get("columnKeys"), clear=clear)
        else:
            self.api.import_bits(
                index, field, rows=b.get("rowIDs"),
                columns=b.get("columnIDs"), row_keys=b.get("rowKeys"),
                column_keys=b.get("columnKeys"),
                timestamps=b.get("timestamps"), clear=clear)
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
        for k in ("rowKeys", "columnKeys", "timestamps"):
            if b.get(k):
                out[k] = b[k]
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


def make_server(api: API, host: str = "localhost",
                port: int = 10101) -> PilosaHTTPServer:
    """A bound (not yet serving) server for ``api``; port 0 picks a free
    one (``server.server_address``)."""
    handler = type("BoundHandler", (Handler,), {"api": api})
    return PilosaHTTPServer((host, port), handler)


def serve(api: API, host: str = "localhost", port: int = 10101,
          background: bool = False) -> PilosaHTTPServer:
    """Serve ``api``; blocks unless ``background``, and returns the
    server (stop it with ``shutdown()`` and ``server_close()``)."""
    server = make_server(api, host, port)
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
