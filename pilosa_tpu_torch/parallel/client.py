"""Node-to-node HTTP client, after the JAX package's
``parallel/client.py``: pooled keep-alive connections (``TCP_NODELAY``
on every socket, TLS through an ``ssl_context``), the binary wire codec
(``server/wire.py``) with JSON as the fallback, one stale-connection
retry, and the four fault-injection sites of an internal RPC.

The calls are the static cluster's: query legs, imports, schema and
status, the health, hotspots, SLO and timeline probes of the cluster
documents, local shards and views, schema creation and deletion,
cluster messages and key translation through the primary. The calls
that move fragments and attributes between nodes (anti-entropy,
resize) are not ported yet.

Reference: http/client.go (InternalClient — query fan-out :241,
imports :439) and client.go:32.
"""

from __future__ import annotations

import http.client
import json
from pilosa_tpu_torch.utils.failpoints import (
    FAILPOINTS, FailpointDrop, FailpointError,
)
from pilosa_tpu_torch.utils.locks import make_lock
from typing import Any, Dict, List, Optional
from urllib.parse import urlsplit

from pilosa_tpu_torch.server import wire

# Fault-injection sites on the four ways an internal RPC actually fails
# in production (utils/failpoints.py catalog): connect refused /
# partitioned, mid-flight connection loss, a 5xx answer, and a torn
# response body (the one that parses into a NON-ClientError).
_FP_CONNECT = FAILPOINTS.register("client.connect")
_FP_READ = FAILPOINTS.register("client.read")
_FP_5XX = FAILPOINTS.register("client.5xx")
_FP_TORN = FAILPOINTS.register("client.torn_body")


class ClientError(RuntimeError):
    """status/body are set for HTTP >=400 responses (None for transport
    errors), so callers can match on the response rather than substring-
    scanning a string that also contains the request URL."""

    def __init__(self, msg: str, status: Optional[int] = None,
                 body: str = ""):
        super().__init__(msg)
        self.status = status
        self.body = body


class _ConnPool:
    """Keep-alive HTTP/1.1 connections per (scheme, host, port). The
    reference gets this from Go's default http.Transport pooling (TLS
    included); without it every scatter-gather leg pays a TCP — and for
    https a TLS — handshake."""

    MAX_IDLE_PER_HOST = 8

    def __init__(self, timeout: float, ssl_context=None):
        self.timeout = timeout
        self.ssl_context = ssl_context
        self._idle: Dict[tuple, list] = {}
        self._lock = make_lock("_ConnPool._lock")

    def _new_conn(self, scheme: str, host: str, port: int,
                  timeout: float) -> http.client.HTTPConnection:
        import socket as _socket
        if scheme == "https":
            ctx = self.ssl_context
            if ctx is None:
                # https peer with no configured context: strict default
                # verification (system CA bundle) — never silently
                # downgrade to unverified.
                import ssl
                ctx = ssl.create_default_context()
                self.ssl_context = ctx
            conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                               context=ctx)
        else:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.connect()
        # Nagle + delayed-ACK on a reused connection turns every small
        # header+body request pair into a ~40 ms stall; disable it.
        raw = getattr(conn.sock, "socket", conn.sock)  # unwrap SSLSocket
        raw.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        return conn

    def get(self, scheme: str, host: str, port: int,
            timeout: Optional[float] = None):
        """-> (connection, reused): reused=True means it came from the
        idle pool and may have been closed server-side while idle.
        `timeout` overrides the socket timeout for THIS request only —
        the connection still pools (put() restores the default), so a
        per-request deadline no longer costs a TCP(+TLS) handshake the
        way the old dedicated-connection path did."""
        with self._lock:
            idle = self._idle.get((scheme, host, port))
            conn = idle.pop() if idle else None
        if conn is not None:
            if timeout is not None:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            return conn, True
        return self._new_conn(scheme, host, port,
                              self.timeout if timeout is None
                              else timeout), False

    def put(self, scheme: str, host: str, port: int,
            conn: http.client.HTTPConnection) -> None:
        if conn.timeout != self.timeout:
            # Restore the pool default before the conn serves another
            # request (a short health-probe timeout must not leak onto
            # the next 30 s query leg, nor vice versa).
            conn.timeout = self.timeout
            if conn.sock is not None:
                conn.sock.settimeout(self.timeout)
        with self._lock:
            idle = self._idle.setdefault((scheme, host, port), [])
            if len(idle) < self.MAX_IDLE_PER_HOST:
                idle.append(conn)
                return
        conn.close()

    def clear(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for c in conns:
            c.close()


class InternalClient:
    # Class-level defaults for the three RPC classes (overridden per
    # instance by the [cluster] config keys — cli/main.py wiring). The
    # old scattered 5 s / 30 s / 600 s literals all resolve here now.
    DEFAULT_TIMEOUT = 30.0       # general RPC ([cluster] rpc_timeout_s)
    HEALTH_TIMEOUT = 5.0         # health/hotspots/timeline probes

    def __init__(self, timeout: float = DEFAULT_TIMEOUT, tracer=None,
                 ssl_context=None,
                 health_timeout: float = HEALTH_TIMEOUT):
        """`ssl_context` verifies https peers (config.client_ssl_context
        builds it: CA bundle or skip-verify, reference
        server/server.go:244 InsecureSkipVerify). None + an https URI =
        strict system-CA verification."""
        self.timeout = timeout
        self.health_timeout = health_timeout
        self.tracer = tracer
        self._pool = _ConnPool(timeout, ssl_context=ssl_context)

    def configure(self, timeout: Optional[float] = None,
                  health_timeout: Optional[float] = None) -> None:
        """[cluster] config wiring (cli/main.py): rpc_timeout_s /
        health_timeout_s."""
        if timeout is not None:
            self.timeout = float(timeout)
            self._pool.timeout = float(timeout)
        if health_timeout is not None:
            self.health_timeout = float(health_timeout)

    def drop_idle(self) -> None:
        """Close every idle pooled connection (test harnesses use this to
        sever keep-alive sockets when simulating a dead peer)."""
        self._pool.clear()

    def _req(self, method: str, url: str, body: Optional[bytes] = None,
             raw: bool = False, obj=None, timeout: Optional[float] = None):
        """One internal request over a pooled keep-alive connection.
        `obj` bodies and non-raw responses use the binary wire codec
        (server/wire.py — the rebuild's analog of the reference's
        protobuf Serializer, encoding/proto/proto.go:29); JSON stays the
        fallback for older peers."""
        if obj is not None:
            try:
                body = wire.dumps(obj)
                headers = {"Content-Type": wire.CONTENT_TYPE}
            except TypeError:  # e.g. >64-bit int — JSON handles it
                body = json.dumps(obj).encode("utf-8")
                headers = {"Content-Type": "application/json"}
        else:
            headers = {"Content-Type": "application/json"}
        if not raw:
            headers["Accept"] = f"{wire.CONTENT_TYPE}, application/json"
        if self.tracer is not None:
            self.tracer.inject(headers)
        try:
            _FP_5XX.fire(url=url)
        except FailpointError as e:
            raise ClientError(f"{method} {url}: 500: failpoint",
                              status=500, body="failpoint") from e
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        host = parts.hostname or "localhost"
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path + (f"?{parts.query}" if parts.query else "")
        try:
            _FP_CONNECT.fire(url=url)
            conn, reused = self._pool.get(scheme, host, port,
                                          timeout=timeout)
        except OSError as e:  # eager connect: refused/unreachable
            raise ClientError(f"{method} {url}: {e}") from e
        try:
            try:
                _FP_READ.fire(url=url)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            except (http.client.HTTPException, ConnectionError,
                    OSError) as e:
                # A REUSED connection may have gone stale (server closed
                # the idle socket); retry once on a fresh one — but never
                # after a timeout (a slow-but-alive peer must not be hit
                # twice) and never for fresh connections, matching Go's
                # transport semantics (retry only reused conns). The
                # narrow duplicate-POST race (server processed AND closed
                # before our read) is safe for every endpoint this path
                # carries: imports/cluster messages/attr merges are
                # idempotent, translate allocation is get-or-allocate,
                # and the schema create legs treat already-exists as
                # success (see create_index_node).
                conn.close()
                if not reused or isinstance(e, TimeoutError):
                    raise
                conn = self._pool._new_conn(scheme, host, port,
                                            timeout or self.timeout)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            payload = resp.read()
            try:
                _FP_TORN.fire(url=url)
            except FailpointDrop:
                payload = b""  # response lost after the server acted
            except FailpointError:
                # Torn body: the connection died mid-read. The parse
                # below then raises a NON-ClientError (JSONDecodeError /
                # WireError) — exactly the class the scatter-gather
                # accounting must survive.
                payload = payload[: len(payload) // 2]
            status = resp.status
            ctype = resp.headers.get("Content-Type") or ""
            reusable = not resp.will_close
            if reusable:
                self._pool.put(scheme, host, port, conn)
            else:
                conn.close()
            if status >= 400:
                body = payload.decode("utf-8", "replace")[:500]
                raise ClientError(f"{method} {url}: {status}: {body}",
                                  status=status, body=body)
            if raw:
                return payload
            if ctype.startswith(wire.CONTENT_TYPE):
                return wire.loads(payload)
            return json.loads(payload or b"{}")
        except ClientError:
            raise
        except (http.client.HTTPException, ConnectionError, OSError,
                TimeoutError) as e:
            conn.close()
            raise ClientError(f"{method} {url}: {e}") from e

    # -- query fan-out (reference QueryNode, http/client.go:241) -------------

    def query_node(self, uri: str, index: str, pql: str,
                   shards: List[int],
                   timeout: Optional[float] = None) -> List[Any]:
        return self.query_node_full(uri, index, pql, shards,
                                    timeout=timeout)["results"]

    def query_node_full(self, uri: str, index: str, pql: str,
                        shards: List[int], profile: bool = False,
                        timeout: Optional[float] = None
                        ) -> Dict[str, Any]:
        """query_node returning the FULL response dict. With
        profile=True the ?profile=true flag propagates to the remote
        node, whose response carries its own execution-profile fragment
        under "profile" — the coordinator merges these into one tree
        (cluster_executor._map_reduce -> QueryProfile.add_node_fragment).
        `timeout` is the scatter leg's share of the request's fan-out
        deadline budget (cluster_executor._map_reduce); None keeps the
        client default."""
        q = ",".join(str(s) for s in shards)
        p = "&profile=true" if profile else ""
        return self._req("POST", f"{uri}/index/{index}/query"
                                 f"?shards={q}&remote=true{p}",
                         pql.encode("utf-8"), timeout=timeout)

    # -- imports (reference importNode, http/client.go:439) ------------------

    def import_node(self, uri: str, index: str, field: str,
                    body: Dict[str, Any], clear: bool = False) -> None:
        suffix = "?clear=1&remote=true" if clear else "?remote=true"
        self._req("POST", f"{uri}/index/{index}/field/{field}/import{suffix}",
                  obj=body)

    def import_roaring_node(self, uri: str, index: str, field: str,
                            shard: int, data: bytes,
                            view: str = "standard") -> None:
        self._req("POST",
                  f"{uri}/index/{index}/field/{field}/import-roaring/{shard}"
                  f"?view={view}&remote=true", data)

    # -- schema / membership --------------------------------------------------

    def schema(self, uri: str) -> dict:
        return self._req("GET", f"{uri}/schema")

    def status(self, uri: str) -> dict:
        return self._req("GET", f"{uri}/status")

    def node_health(self, uri: str,
                    timeout: Optional[float] = None) -> dict:
        """One node's health self-report (GET /internal/health) for the
        coordinator's /cluster/health merge. Short timeout (default
        `health_timeout`, [cluster] health_timeout_s): the health plane
        must report a wedged node as unhealthy, not hang the whole
        fleet document behind it."""
        return self._req("GET", f"{uri}/internal/health",
                         timeout=timeout or self.health_timeout)

    def node_hotspots(self, uri: str, timeout: Optional[float] = None,
                      top_k: Optional[int] = None) -> dict:
        """One node's workload snapshot (GET /debug/hotspots) for the
        /cluster/hotspots merge — same short-timeout rule as
        node_health: a wedged node is reported, not waited on. `top_k`
        forwards the coordinator's ?topk so every member's lists share
        one bound."""
        q = f"?topk={int(top_k)}" if top_k is not None else ""
        return self._req("GET", f"{uri}/debug/hotspots{q}",
                         timeout=timeout or self.health_timeout)

    def node_slo(self, uri: str,
                 timeout: Optional[float] = None) -> dict:
        """One node's SLO snapshot (GET /debug/slo) for the
        /cluster/slo merge — same short-timeout rule as node_health:
        a wedged node is reported, not waited on."""
        return self._req("GET", f"{uri}/debug/slo",
                         timeout=timeout or self.health_timeout)

    def node_timeline(self, uri: str, trace_id: str,
                      timeout: Optional[float] = None) -> dict:
        """One node's timeline slices for a trace id (GET
        /debug/timeline?trace=...) for the coordinator's
        /cluster/timeline assembly — same short-timeout rule as
        node_health: a wedged node is reported, not waited on."""
        from urllib.parse import quote
        return self._req("GET",
                         f"{uri}/debug/timeline?trace={quote(trace_id)}",
                         timeout=timeout or self.health_timeout)

    def local_shards(self, uri: str) -> Dict[str, List[int]]:
        return self._req("GET", f"{uri}/internal/local-shards")

    def views(self, uri: str, index: str, field: str) -> List[str]:
        return self._req(
            "GET", f"{uri}/internal/views?index={index}&field={field}"
        )["views"]

    def cluster_message(self, uri: str, message: dict) -> None:
        self._req("POST", f"{uri}/internal/cluster/message", obj=message)

    @staticmethod
    def _is_already_exists(e: ClientError) -> bool:
        # 409 alone is not enough: the API also answers 409 for "method
        # not allowed in state RESIZING" (server/api.py), which must NOT
        # read as success. Match the response BODY, never the whole
        # string — it contains the URL, and an index named "exists"
        # would alias.
        return e.status == 409 and "exists" in e.body

    def create_index_node(self, uri: str, index: str, options: dict) -> None:
        """Remote create leg. Already-exists reads as success: the
        stale-connection retry in _req can duplicate a POST when the
        peer processed the first request but closed the socket before
        the response was read."""
        try:
            self._req("POST", f"{uri}/index/{index}?remote=true",
                      obj={"options": options})
        except ClientError as e:
            if not self._is_already_exists(e):
                raise

    def create_field_node(self, uri: str, index: str, field: str,
                          options: dict) -> None:
        try:
            self._req("POST", f"{uri}/index/{index}/field/{field}"
                              f"?remote=true",
                      obj={"options": options})
        except ClientError as e:
            if not self._is_already_exists(e):
                raise

    # -- key translation through the primary (reference
    # http/handler.go:274, translate.go:400) ----------------------------------

    def translate_keys(self, uri: str, index: str, field: Optional[str],
                       keys: List[str]) -> List[int]:
        """Ids of ``keys`` from the translate primary, allocated there
        when new (one round trip however many keys)."""
        body = json.dumps({"index": index, "field": field,
                           "keys": list(keys)}).encode()
        res = self._req("POST", f"{uri}/internal/translate/keys", body)
        return [int(i) for i in res["ids"]]

    def translate_ids(self, uri: str, index: str, field: Optional[str],
                      ids: List[int]) -> List[Optional[str]]:
        """Keys of ``ids`` from the translate primary (None where the
        primary has none)."""
        body = json.dumps({"index": index, "field": field,
                           "ids": [int(i) for i in ids]}).encode()
        return self._req("POST", f"{uri}/internal/translate/ids",
                         body)["keys"]

    def translate_data(self, uri: str, index: str, field: Optional[str],
                       offset: int) -> bytes:
        """The translate log's records from byte ``offset`` of the
        replication stream (``TranslateStore.read_log_from``)."""
        fld = f"&field={field}" if field else ""
        return self._req("GET", f"{uri}/internal/translate/data"
                                f"?index={index}{fld}&offset={int(offset)}",
                         raw=True)
