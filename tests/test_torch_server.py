"""Differential tests of the port's HTTP server against the JAX package's.

A JAX server (as ``tests/conftest.py``'s ``live_server`` builds it, with
the coalescer attached) and a port server on ``device="cpu"`` with the
same coalescer window answer one fixed request script, phase by phase:
status codes must be identical, JSON bodies equal after ``json.loads``
(error messages included: no pair of messages differs), protobuf bodies
byte-identical. Also: concurrent mixed reads and
writes against the port server, and the begin/finish isolation of a
batch on the executor.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from datetime import datetime

import numpy as np
import pytest
import torch

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import proto_compat as jax_proto
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.server.coalescer import QueryCoalescer as JaxCoalescer
from pilosa_tpu.utils.stats import MemStatsClient
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.server import API, serve
from pilosa_tpu_torch.server.coalescer import QueryCoalescer


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag this
    file's sampled fences raise must not reach a later test's sentinel
    (its ``roofline.drift`` alert)."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


WINDOW_S = 0.0005
PROTO = "application/x-protobuf"


def call(base, method, path, body=None, ctype=None, timeout=60):
    """(status, content type, body bytes); 4xx/5xx captured."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    headers = {"Content-Type": ctype} if ctype else {}
    r = urllib.request.Request(base + path, data=body, method=method,
                               headers=headers)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def pb_query(pql, shards=(), exclude_columns=False):
    """A reference-client QueryRequest (Query=1, Shards=2,
    ExcludeColumns=7), encoded with the JAX package's codec helpers."""
    out = jax_proto._str_field(1, pql) + jax_proto._packed_uint64(2, shards)
    if exclude_columns:
        out += jax_proto._varint_field(7, 1)
    return out


def pb_import(index, field, rows, cols):
    """ImportRequest: Index=1, Field=2, RowIDs=4, ColumnIDs=5."""
    return (jax_proto._str_field(1, index) + jax_proto._str_field(2, field)
            + jax_proto._packed_uint64(4, rows)
            + jax_proto._packed_uint64(5, cols))


def pb_import_values(index, field, cols, values):
    """ImportValueRequest: ColumnIDs=5, Values=6 (int64 varints)."""
    return (jax_proto._str_field(1, index) + jax_proto._str_field(2, field)
            + jax_proto._packed_uint64(5, cols)
            + jax_proto._packed_uint64(6, [v & (2 ** 64 - 1)
                                           for v in values]))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(jax base URL, port base URL, port API), both with a coalescer at
    WINDOW_S."""
    jh = JaxHolder(str(tmp_path_factory.mktemp("jaxsrv")))
    jh.open()
    japi = JaxAPI(jh, stats=MemStatsClient())
    japi.coalescer = JaxCoalescer(japi.executor, window_s=WINDOW_S,
                                  stats=japi.stats, tracer=japi.tracer)
    japi.coalescer.start()
    jsrv = jax_serve(japi, "localhost", 0, background=True)
    papi = API(Holder(device="cpu"))
    papi.coalescer = QueryCoalescer(papi.executor, window_s=WINDOW_S)
    papi.coalescer.start()
    psrv = serve(papi, "localhost", 0, background=True)
    yield (f"http://localhost:{jsrv.server_address[1]}",
           f"http://localhost:{psrv.server_address[1]}", papi)
    for srv, api in ((jsrv, japi), (psrv, papi)):
        srv.shutdown()
        srv.server_close()
        api.coalescer.stop()
    jh.close()


def run_script(servers, phase, steps):
    """Send each (method, path, body, content type) to both servers in
    order and compare; returns the port's parsed answers."""
    jbase, pbase, _ = servers
    answers = []
    for i, (method, path, body, ctype) in enumerate(steps):
        js, jct, jb = call(jbase, method, path, body, ctype)
        ps, pct, pb = call(pbase, method, path, body, ctype)
        where = f"{phase}[{i}] {method} {path} {body!r:.200}"
        assert js == ps, (where, js, jb[:300], ps, pb[:300])
        assert jct == pct, (where, jct, pct)
        if jct == "application/json":
            jv, pv = json.loads(jb), json.loads(pb)
            assert jv == pv, (where, jv, pv)
            answers.append(pv)
        else:
            assert jb == pb, (where, jb[:200], pb[:200])
            answers.append(pb)
    return answers


def load_steps(index):
    """Create an index with two set fields and an int field, then JSON
    and protobuf imports into each, from a numpy seed."""
    rng = np.random.default_rng(23)
    spans = (70000, 3000, 200000)
    f_rows, f_cols = [], []
    for shard, span in enumerate(spans):
        for r in range(6):
            k = int(rng.integers(20, 300))
            f_rows += [r] * k
            f_cols += (shard * SHARD_WIDTH
                       + rng.integers(0, span, k)).tolist()
    g_rows = rng.integers(1, 4, 600).tolist()
    g_cols = (rng.integers(0, 3, 600) * SHARD_WIDTH
              + rng.integers(0, 50000, 600)).tolist()
    cols = sorted(set(f_cols) | set(g_cols))
    v_cols = [c for c in cols if rng.random() < 0.6]
    v_vals = rng.integers(-10, 1001, len(v_cols)).tolist()
    half = len(v_cols) // 2
    return [
        ("POST", f"/index/{index}", {"options": {}}, None),
        ("POST", f"/index/{index}/field/f", {}, None),
        ("POST", f"/index/{index}/field/g",
         {"options": {"cacheType": "none", "cacheSize": 0}}, None),
        ("POST", f"/index/{index}/field/v",
         {"options": {"type": "int", "min": -10, "max": 1000}}, None),
        ("POST", f"/index/{index}/field/f/import",
         {"rowIDs": f_rows, "columnIDs": f_cols}, None),
        ("POST", f"/index/{index}/field/g/import",
         pb_import(index, "g", g_rows, g_cols), PROTO),
        ("POST", f"/index/{index}/field/v/import",
         {"columnIDs": v_cols[:half], "values": v_vals[:half]}, None),
        ("POST", f"/index/{index}/field/v/import",
         pb_import_values(index, "v", v_cols[half:], v_vals[half:]), PROTO),
        ("POST", f"/index/{index}/query", "Set(5, f=9)", None),
        ("POST", f"/index/{index}/query", "Set(5, f=9)", None),
        ("POST", f"/index/{index}/query",
         f"Set({SHARD_WIDTH + 11}, f=1) Set(3, v=42)", None),
        ("POST", f"/index/{index}/query", f"Clear({f_cols[0]}, f=0)", None),
        ("POST", f"/index/{index}/query", f"Clear({v_cols[1]}, v=0)", None),
    ]


READS = [
    "Row(f=1)", "Row(g=2)", "Row(f=99)", "Count(Row(f=9))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Intersect(Row(f=0), Row(g=1))",
    "Count(Union(Row(f=1), Row(g=3)))", "Union(Row(f=5), Row(g=1))",
    "Difference(Row(g=3), Row(f=3))",
    "Count(Difference(Row(f=1), Row(g=2)))",
    "Xor(Row(f=4), Row(f=5))", "Count(Xor(Row(f=3), Row(g=1)))",
    "Not(Row(f=1))", "Count(Not(Union(Row(f=1), Row(g=1))))",
    "Shift(Row(f=2), n=3)", "Count(Shift(Row(g=1), n=70000))",
    "Threshold(Row(f=1), Row(f=2), Row(g=1), k=2)",
    "Count(Threshold(Row(f=1), Row(f=2), Row(g=2), Row(g=3), k=3))",
    "Row(v > 500)", "Count(Row(v < 0))", "Count(Row(v == 42))",
    "Count(Row(v != 100))", "Count(Row(v >= -10))",
    "Count(Row(-5 < v < 200))", "Row(v >= 2000)",
    "Count(Intersect(Row(f=2), Row(v <= 300)))",
    "TopN(f)", "TopN(f, n=3)", "TopN(g, Row(f=1), n=2)",
    "TopN(f, ids=[1, 3, 5], n=2)", "TopN(f, threshold=150)",
    "TopN(f, Row(f=2), n=4, tanimotoThreshold=5)",
    "Sum(field=v)", "Sum(Row(f=1), field=v)", "Min(field=v)",
    "Max(Row(g=2), field=v)", "Min(Row(f=99), field=v)",
    "Options(Row(f=1), excludeColumns=true)",
    "Options(Row(f=1), shards=[0, 2])",
    "Options(Count(Row(f=2)), shards=[1])",
    "Options(Row(g=3), excludeRowAttrs=true)",
    "Count(Row(f=1)) TopN(g, n=2) Row(f=3)",
]


def test_load_and_reads_match_jax(servers):
    """Create, import (JSON and protobuf, set and int), Set/Clear, then
    every read form, raw PQL, through the coalesced query route."""
    answers = run_script(servers, "load", load_steps("dl"))
    assert answers[9]["results"] == [False]  # the second Set(5, f=9)
    reads = run_script(servers, "reads", [
        ("POST", "/index/dl/query", pql, None) for pql in READS])
    assert all("results" in a for a in reads)


def test_url_args_json_body_and_protobuf_match_jax(servers):
    run_script(servers, "load", load_steps("du"))
    steps = [
        ("POST", "/index/du/query?shards=0,2", "Row(f=1)", None),
        ("POST", "/index/du/query?shards=1", "Count(Row(g=2))", None),
        ("POST", "/index/du/query?excludeColumns=true", "Row(f=1)", None),
        ("POST", "/index/du/query?excludeRowAttrs=true",
         "Row(f=2) Count(Row(f=2))", None),
        ("POST", "/index/du/query", {"query": "TopN(f, n=2)"}, None),
        ("POST", "/index/du/query?shards=2",
         {"query": "Sum(Row(f=1), field=v)"}, None),
    ]
    steps += [("POST", "/index/du/query", pb_query(pql), PROTO) for pql in (
        "Row(f=1)", "Count(Row(f=2))", "TopN(f, n=3)", "Sum(field=v)",
        "Set(77, f=4)", "Count(Row(f=4)) Row(v > 900)",
        "Row(nope=1)", "Row(f=")]
    steps += [
        ("POST", "/index/du/query", pb_query("Row(f=3)", shards=(0, 1)),
         PROTO),
        ("POST", "/index/du/query",
         pb_query("Row(f=3)", exclude_columns=True), PROTO),
        ("POST", "/index/du/query?shards=2", pb_query("Row(f=3)"), PROTO),
    ]
    run_script(servers, "args", steps)


def test_batch_query_with_a_write_matches_jax(servers):
    run_script(servers, "load", load_steps("db"))
    items = [{"index": "db", "query": q} for q in (
        "Count(Row(f=1))", "Row(f=2)", "Count(Intersect(Row(f=1), "
        "Row(g=2)))", "Count(Row(v > 100))")]
    items.append({"index": "db", "query": f"Set({2 * SHARD_WIDTH + 5}, f=1)"})
    items += [{"index": "db", "query": "Count(Row(f=1))"},
              {"index": "db", "query": "Row(f=1)", "shards": [2]},
              {"index": "db", "query": "Row(nope=1)"},
              {"index": "nope", "query": "Row(f=1)"},
              {"index": "db"}, "not an item",
              {"index": "db", "query": "TopN(f, n=2)"}]
    (out,) = run_script(servers, "batch", [
        ("POST", "/batch/query", {"queries": items}, None)])
    before, after = out["responses"][0], out["responses"][5]
    assert after["results"][0] == before["results"][0] + 1


def test_schema_and_deletes_match_jax(servers):
    run_script(servers, "load", load_steps("ds"))
    run_script(servers, "schema", [
        ("GET", "/schema", None, None),
        ("GET", "/index", None, None),
        ("GET", "/index/ds", None, None),
        ("GET", "/index/ds/field", None, None),
        ("GET", "/version", None, None),
        ("DELETE", "/index/ds/field/g", None, None),
        ("GET", "/index/ds", None, None),
        ("POST", "/index/ds/query", "Row(g=1)", None),
        ("DELETE", "/index/ds/field/g", None, None),
        ("DELETE", "/index/ds", None, None),
        ("GET", "/index/ds", None, None),
        ("GET", "/index/ds/field", None, None),
        ("POST", "/index/ds/query", "Row(f=1)", None),
        ("DELETE", "/index/ds", None, None),
    ])


def test_errors_match_jax(servers):
    run_script(servers, "load", load_steps("de"))
    run_script(servers, "errors", [
        ("POST", "/index/nope/query", "Row(f=1)", None),
        ("POST", "/index/de/query", "Row(nope=1)", None),
        ("POST", "/index/de/query", "Row(f=", None),
        ("POST", "/index/de/query", "Count(Row(f=1), Row(f=2))", None),
        ("POST", "/index/de/query", "Row(v=3)", None),
        ("POST", "/index/de/query", "Threshold(Row(f=1), k=0)", None),
        ("POST", "/index/de/query?bogus=1", "Row(f=1)", None),
        ("POST", "/batch/query",
         {"queries": [{"index": "de", "query": "Row(f=1)"}] * 1025}, None),
        ("POST", "/batch/query", {"nothing": 1}, None),
        ("POST", "/index/de", {"options": {}}, None),
        ("POST", "/index/de/field/f", {}, None),
        ("POST", "/index/de/field/h", {"options": {"bogus": 1}}, None),
        ("POST", "/index/Bad", {}, None),
        ("POST", "/index/nope/field/f", {}, None),
        ("POST", "/index/de/field/nope/import",
         {"rowIDs": [1], "columnIDs": [1]}, None),
        ("POST", "/index/de/field/f/import",
         {"rowIDs": [1, 2], "columnIDs": [1]}, None),
        ("POST", "/index/de/field/v/import",
         {"columnIDs": [1], "values": [5000]}, None),
        ("POST", "/index/de/field/f/import?bogus=1",
         {"rowIDs": [1], "columnIDs": [1]}, None),
        ("DELETE", "/index/de/field/nope", None, None),
        ("DELETE", "/index/nope", None, None),
        ("GET", "/no/such/route", None, None),
    ])


GROUP_READS = [
    "Rows(f)", "Rows(g, limit=2)", "Rows(f, previous=2, limit=3)",
    f"Rows(f, column={SHARD_WIDTH + 11})", "Rows(v)",
    "GroupBy(Rows(f), Rows(g))", "GroupBy(Rows(g), Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), filter=Row(v > 500))",
    "GroupBy(Rows(f), Rows(g), limit=4)",
    "GroupBy(Rows(f), Rows(g), limit=4, previous=[1, 2])",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=99))",
    "Count(Row(f=1)) GroupBy(Rows(g)) Rows(g)",
]


def test_rows_groupby_and_writes_match_jax(servers):
    """Rows and GroupBy as JSON and protobuf answers, ClearRow and Store
    (into a field the Store makes), fields made with each cacheType and
    a cacheSize, TopN over them, /recalculate-caches and a /batch/query
    holding all of it: equal status codes and bodies."""
    run_script(servers, "load", load_steps("dg"))
    steps = [("POST", "/index/dg/query", q, None) for q in GROUP_READS]
    steps += [("POST", "/index/dg/query", pb_query(q), PROTO)
              for q in GROUP_READS]
    steps += [
        ("POST", "/index/dg/field/l",
         {"options": {"cacheType": "lru", "cacheSize": 2}}, None),
        ("POST", "/index/dg/field/n", {"options": {"cacheType": "none"}},
         None),
        ("POST", "/index/dg/field/r", {"options": {"cacheSize": 1}}, None),
    ]
    for fld in ("l", "n", "r"):
        steps.append(("POST", f"/index/dg/field/{fld}/import",
                      {"rowIDs": [1, 1, 2, 3, 3, 3],
                       "columnIDs": [1, 2, 3, 4, 5, SHARD_WIDTH + 6]}, None))
    q = "/index/dg/query"
    steps += [
        ("POST", q, "TopN(l, n=2) TopN(n, n=2) TopN(r, n=2)", None),
        ("POST", q, "Store(Intersect(Row(f=1), Row(g=2)), s=7)", None),
        ("POST", q, "Count(Row(s=7)) Rows(s) TopN(s)", None),
        ("POST", q, pb_query("Store(Row(f=2), n=1)"), PROTO),
        ("POST", q, "TopN(n, n=3) GroupBy(Rows(n), Rows(l))", None),
        ("POST", q, "ClearRow(f=1)", None),
        ("POST", q, pb_query("ClearRow(g=2)"), PROTO),
        ("POST", q, "Count(Row(f=1)) Rows(g) TopN(f, n=2)", None),
        ("POST", q, "ClearRow(v=1)", None),
        ("POST", q, "Store(Row(f=3), v=1)", None),
        ("POST", "/recalculate-caches", None, None),
        ("POST", q, "TopN(f, n=3) TopN(l) TopN(r)", None),
        ("POST", "/batch/query", {"queries": [
            {"index": "dg", "query": "GroupBy(Rows(f), Rows(g))"},
            {"index": "dg", "query": "Store(Row(f=3), g=9)"},
            {"index": "dg", "query": "Rows(g) Count(Row(g=9))"},
            {"index": "dg", "query": "ClearRow(g=9)"},
            {"index": "dg", "query": "Rows(g)"},
            {"index": "dg", "query": "GroupBy(Rows(f), previous=[1])"}]},
         None),
        ("GET", "/schema", None, None),
    ]
    answers = run_script(servers, "groups", steps)
    assert answers[5]["results"][0] and answers[1]["results"][0]["rows"]


def test_queue_c_faults_match_jax(servers):
    """The four port faults found against the reference: a negative
    Shift, a range of three values and a string row on a field without
    keys answer as the JAX server does; a one-value range is the
    recorded divergence (the reference's 500 is its own fault); a
    negative row id is refused before it is stored (port only), and
    TopN keeps answering."""
    _, pbase, _ = servers
    run_script(servers, "load", load_steps("dq"))
    q = "/index/dq/query"
    run_script(servers, "queue-c", [
        ("POST", q, "Shift(Row(f=1), n=-1)", None),
        ("POST", q, "Count(Shift(Row(f=2), n=-2))", None),
        ("POST", q, "Row(v >< [5, 6, 7])", None),
        ("POST", q, "Count(Row(v >< [-5, 300, 900]))", None),
        ("POST", q, "Row(f='a')", None),
        ("POST", q, pb_query("Row(f='a')"), PROTO),
        ("POST", "/batch/query", {"queries": [
            {"index": "dq", "query": "Shift(Row(f=1), n=-1)"},
            {"index": "dq", "query": "Row(v >< [5, 6, 7])"},
            {"index": "dq", "query": "Count(Row(f='a'))"}]}, None),
    ])
    jbase = servers[0]
    js, _, _ = call(jbase, "POST", q, "Row(v >< [5])")
    ps, _, raw = call(pbase, "POST", q, "Row(v >< [5])")
    assert (js, ps) == (500, 400), raw
    for pql in ("Set(2, f=-1)", "ClearRow(f=-1)", "Store(Row(f=1), f=-1)"):
        st, _, raw = call(pbase, "POST", q, pql)
        assert st == 400 and b"out of range" in raw, (pql, raw)
    st, _, raw = call(pbase, "POST", q, "TopN(f) Row(f=-1)")
    assert st == 200, raw
    assert json.loads(raw)["results"][1] == {"columns": []}


def test_port_refuses_what_is_not_ported(servers):
    """The routes of seed join, resize and anti-entropy answer 404
    naming that part: never a silently different answer. What was
    refused before and is ported now (remote query legs and the static
    cluster's node-to-node routes among it) is answered as the JAX server
    does."""
    _, pbase, _ = servers
    # Column attributes, a column key, SetRowAttrs, index and field keys
    # and a keyed import are ported: the port answers them as the JAX
    # server does (an unkeyed index refuses a column key with the JAX
    # package's message).
    run_script(servers, "keys-ported", [
        ("POST", "/index/dn", {}, None),
        ("POST", "/index/dn/field/f", {}, None),
        ("POST", "/index/dn/query", "Set(3, f=1) SetColumnAttrs(3, x=1)",
         None),
        ("POST", "/index/dn/query?columnAttrs=true", "Row(f=1)", None),
        ("POST", "/index/dn/query", "Options(Row(f=1), columnAttrs=true)",
         None),
        ("POST", "/index/dn/query", "Set('k', f=1)", None),
        ("POST", "/index/dn/query", "SetRowAttrs(f, 1, x=2) Row(f=1)",
         None),
        ("POST", "/index/kx", {"options": {"keys": True}}, None),
        ("POST", "/index/dn/field/k", {"options": {"keys": True}}, None),
        ("POST", "/index/dn/field/f/import",
         {"rowKeys": ["a"], "columnIDs": [1]}, None),
        ("POST", "/index/dn/field/k/import",
         {"rowKeys": ["a"], "columnIDs": [1]}, None),
        ("POST", "/index/dn/query", "Row(k='a') TopN(k)", None),
        ("GET", "/index/kx", None, None),
    ])
    # A time range, a time field and import timestamps are ported: the
    # port answers them as the JAX server does.
    run_script(servers, "time-ported", [
        ("POST", "/index/dtp", {}, None),
        ("POST", "/index/dtp/field/f", {}, None),
        ("POST", "/index/dtp/query", "Row(f=1, from='2020-01-01T00:00')",
         None),
        ("POST", "/index/dtp/field/t",
         {"options": {"type": "time", "timeQuantum": "YMD"}}, None),
        ("POST", "/index/dtp/field/f/import",
         {"rowIDs": [1], "columnIDs": [1], "timestamps": [1]}, None),
        ("POST", "/index/dtp/field/t/import",
         {"rowIDs": [1], "columnIDs": [1], "timestamps": [1]}, None),
        ("POST", "/index/dtp/query",
         "Rows(t, from='1969-12-01', to='1970-02-01') Row(t=1)", None),
    ])
    # Roaring imports and the CSV export are ported: the port answers
    # them as the JAX server does.
    run_script(servers, "persist-ported", [
        ("POST", "/index/dn/field/f/import-roaring/0",
         roaring([1 * SHARD_WIDTH + 4, 2 * SHARD_WIDTH + 4]), None),
        ("GET", "/export?index=dn&field=f&shard=0", None, None),
    ])
    # A remote query leg (the static cluster is ported) answers on a
    # single node as the JAX server's does.
    run_script(servers, "remote-ported", [
        ("POST", "/index/dn/query?remote=true", "Row(f=1)", None),
        ("POST", "/index/dn/query?remote=true&shards=0", "Count(Row(f=1))",
         None),
        ("GET", "/internal/local-shards", None, None),
        ("GET", "/internal/fragment/nodes?index=dn&shard=1", None, None),
        ("GET", "/internal/shards/max", None, None),
        ("GET", "/internal/views?index=dn&field=f", None, None),
    ])
    jbase = servers[0]
    assert call(pbase, "GET", "/internal/nodes")[0] == \
        call(jbase, "GET", "/internal/nodes")[0] == 200
    # Seed join, resize and anti-entropy are not: their routes answer
    # 404 naming that part.
    for method, path in (("GET", "/internal/fragment/blocks"),
                         ("GET", "/internal/fragment/block/data"),
                         ("GET", "/internal/fragment/data"),
                         ("GET", "/internal/attr/blocks"),
                         ("GET", "/internal/attr/block/data"),
                         ("POST", "/internal/attr/merge"),
                         ("POST", "/internal/sync"),
                         ("POST", "/internal/join"),
                         ("POST", "/internal/resize/pull"),
                         ("POST", "/cluster/resize/remove-node"),
                         ("POST", "/cluster/resize/set-coordinator"),
                         ("POST", "/cluster/resize/abort"),
                         ("POST", "/cluster/resize/run")):
        st, _, raw = call(pbase, method, path, {} if method == "POST"
                          else None)
        assert st == 404 and "resize" in json.loads(raw)["error"], \
            (path, raw)
    # The serving planes are ported: their routes answer as the JAX
    # server's do.
    for path in ("/debug/hotspots", "/debug/history", "/debug/slo",
                 "/internal/health", "/internal/failpoints"):
        st, _, raw = call(pbase, "GET", path)
        assert st == call(jbase, "GET", path)[0], (path, st, raw)
    # The profiler and /metrics are ported: a profiled query answers as
    # the direct one, with its tree beside the results.
    st, _, raw = call(pbase, "POST", "/index/dn/query?profile=true",
                      "Row(f=1)")
    assert st == 200, raw
    got = json.loads(raw)
    assert got["results"] == json.loads(call(
        pbase, "POST", "/index/dn/query", "Row(f=1)")[2])["results"]
    assert got["profile"]["ops"][0]["name"] == "Row"
    # No stats client here (the nop one): an empty exposition.
    assert call(pbase, "GET", "/metrics")[:1] == (200,)
    # A protobuf query with its Remote flag is a remote leg too.
    body = pb_query("Row(f=1)") + jax_proto._varint_field(5, 1)
    assert call(pbase, "POST", "/index/dn/query", body, PROTO) == \
        call(jbase, "POST", "/index/dn/query", body, PROTO)


def roaring(positions):
    """Serialized roaring bytes of ``positions`` (the JAX codec)."""
    from pilosa_tpu.storage.roaring import Bitmap as JaxBitmap
    return JaxBitmap(np.asarray(positions, np.uint64)).write_bytes()


def pb_import_roaring(views, clear=False):
    """ImportRoaringRequest: Clear=1, views=2 (Name=1, Data=2)."""
    out = jax_proto._varint_field(1, 1) if clear else b""
    for name, blob in views:
        out += jax_proto._len_field(2, jax_proto._str_field(1, name)
                                    + jax_proto._len_field(2, blob))
    return out


def test_import_roaring_and_export_match_jax(servers):
    """Roaring imports (raw bytes into a shard and a ``?view``, a
    ``?clear``, protobuf ImportRoaringRequests with several views and
    their clear flag, a malformed payload, unknown fields and args) and
    the CSV export (unkeyed, keyed, an empty shard, unknown names):
    equal status codes and bodies, and the reads after them."""
    rng = np.random.default_rng(31)
    rows = rng.integers(0, 4, 3000).astype(np.uint64)
    cols = rng.integers(0, 60000, 3000).astype(np.uint64)
    pos = np.unique(rows * np.uint64(SHARD_WIDTH) + cols)
    day = np.unique(rng.integers(0, 3, 400).astype(np.uint64)
                    * np.uint64(SHARD_WIDTH) + cols[:400])
    base = "/index/rr/field"
    q = "/index/rr/query"
    steps = [
        ("POST", "/index/rr", {}, None),
        ("POST", "/index/rr/field/f", {}, None),
        ("POST", "/index/rr/field/t",
         {"options": {"type": "time", "timeQuantum": "YMD"}}, None),
        ("POST", f"{base}/f/import-roaring/0", roaring(pos), None),
        ("POST", f"{base}/f/import-roaring/1?view=standard",
         roaring(pos[::3]), None),
        ("POST", f"{base}/f/import-roaring/0?clear=true",
         roaring(pos[::7]), None),
        ("POST", f"{base}/t/import-roaring/2",
         pb_import_roaring([("", roaring(day)),
                            ("standard_20190105", roaring(day)),
                            ("standard_201901", roaring(day))]), PROTO),
        ("POST", f"{base}/t/import-roaring/2",
         pb_import_roaring([("standard_20190105", roaring(day[::2]))],
                           clear=True), PROTO),
        ("POST", f"{base}/f/import-roaring/0", b"not a roaring file", None),
        ("POST", f"{base}/f/import-roaring/0",
         roaring(pos)[:-5], None),
        ("POST", f"{base}/nope/import-roaring/0", roaring(pos), None),
        ("POST", "/index/nope/field/f/import-roaring/0", roaring(pos), None),
        ("POST", f"{base}/f/import-roaring/0?bogus=1", roaring(pos), None),
        ("POST", q, "Count(Row(f=1)) Row(f=2) TopN(f) Count(Not(Row(f=0)))",
         None),
        ("POST", q, "Row(t=1, from='2019-01-05T00:00', "
                    "to='2019-01-06T00:00') Count(Row(t=2)) Rows(t)", None),
        ("GET", "/export?index=rr&field=f&shard=0", None, None),
        ("GET", "/export?index=rr&field=f&shard=1", None, None),
        ("GET", "/export?index=rr&field=f&shard=9", None, None),
        ("GET", "/export?index=rr&field=t&shard=2", None, None),
        ("GET", "/export?index=rr&field=nope&shard=0", None, None),
        ("GET", "/export?index=nope&field=f&shard=0", None, None),
        ("GET", "/export?index=rr&field=f&shard=0&x=1", None, None),
        ("POST", "/index/rk", {"options": {"keys": True}}, None),
        ("POST", "/index/rk/field/kf", {"options": {"keys": True}}, None),
        ("POST", "/index/rk/field/kf/import",
         {"rowKeys": ["a", "b,c", "a", "d\"q"],
          "columnKeys": ["x", "y", "z", "x"]}, None),
        ("POST", "/index/rk/query", "Set('w', kf='a')", None),
        ("GET", "/export?index=rk&field=kf&shard=0", None, None),
    ]
    run_script(servers, "roaring", steps)


def pb_import_keys(index, field, row_keys, col_keys):
    """ImportRequest with RowKeys=7 and ColumnKeys=8 (repeated strings)."""
    return (jax_proto._str_field(1, index) + jax_proto._str_field(2, field)
            + b"".join(jax_proto._str_field(7, k) for k in row_keys)
            + b"".join(jax_proto._str_field(8, k) for k in col_keys))


def pb_import_value_keys(index, field, col_keys, values):
    """ImportValueRequest with ColumnKeys=7 and Values=6."""
    return (jax_proto._str_field(1, index) + jax_proto._str_field(2, field)
            + b"".join(jax_proto._str_field(7, k) for k in col_keys)
            + jax_proto._packed_uint64(6, values))


def test_keys_and_attributes_match_jax(servers):
    """A keyed index over HTTP: schema, keyed imports as JSON and as
    protobuf (and the key errors of both), reads with keys in their
    results as JSON, as protobuf and in a batch, attribute writes,
    ?columnAttrs=true, Options(columnAttrs=true) and protobuf
    ColumnAttrSets: equal status codes and bodies."""
    rng = np.random.default_rng(31)
    users = [f"u{i}" for i in rng.integers(0, 8, 300)]
    repos = [f"o{i % 5}/r{i}" for i in rng.integers(0, 120, 300)]
    langs = ["go", "py", "rs"]
    mine = {u: r for u, r in zip(users, repos)}  # a repo each user starred
    q = "/index/dk/query"
    steps = [
        ("POST", "/index/dk", {"options": {"keys": True}}, None),
        ("POST", "/index/dk/field/star", {"options": {"keys": True}}, None),
        ("POST", "/index/dk/field/lang", {"options": {"keys": True}}, None),
        ("POST", "/index/dk/field/n",
         {"options": {"type": "int", "min": 0, "max": 1000}}, None),
        ("POST", "/index/dk/field/plain", {}, None),
        ("GET", "/schema", None, None),
        ("POST", "/index/dk/field/star/import",
         {"rowKeys": users[:150], "columnKeys": repos[:150]}, None),
        ("POST", "/index/dk/field/star/import",
         pb_import_keys("dk", "star", users[150:], repos[150:]), PROTO),
        ("POST", "/index/dk/field/lang/import",
         {"rowKeys": [langs[i % 3] for i in range(60)],
          "columnKeys": repos[:60]}, None),
        ("POST", "/index/dk/field/n/import",
         {"columnKeys": repos[:40], "values": list(range(40))}, None),
        ("POST", "/index/dk/field/n/import",
         pb_import_value_keys("dk", "n", repos[40:80],
                              list(range(100, 140))), PROTO),
        ("POST", "/index/dk/field/plain/import",
         {"rowIDs": [1, 1], "columnKeys": repos[:2]}, None),
        # The key errors of an import.
        ("POST", "/index/dk/field/star/import",
         {"rowIDs": [1], "columnKeys": ["x"]}, None),
        ("POST", "/index/dk/field/star/import",
         {"rowKeys": ["a"], "columnIDs": [1]}, None),
        ("POST", "/index/dk/field/plain/import",
         {"rowKeys": ["a"], "columnKeys": ["x"]}, None),
        ("POST", "/index/dk/field/n/import",
         {"columnIDs": [1], "values": [1]}, None),
        ("POST", "/index/dk/field/star/import",
         {"rowKeys": ["a", "b"], "columnKeys": ["x"]}, None),
        ("POST", q, "SetRowAttrs(star, 'u1', active=true, n=3) "
                    "SetRowAttrs(star, 'u2', active=false) "
                    "SetRowAttrs(lang, 'go', kind='systems')", None),
        ("POST", q, f"SetColumnAttrs('{mine['u1']}', url='x', stars=5) "
                    f"SetColumnAttrs('{mine['u2']}', hot=true)", None),
        ("POST", q, "Set('new/repo', star='u1') Row(star='u1')", None),
        ("POST", q, "TopN(star, n=3) Rows(lang) Row(lang='go')", None),
        ("POST", q, "TopN(star, attrName='active', attrValues=[true])",
         None),
        ("POST", q, "GroupBy(Rows(lang), filter=Row(star='u2'))", None),
        ("POST", q + "?columnAttrs=true", "Row(star='u1')", None),
        ("POST", q, "Options(Row(star='u2'), columnAttrs=true) "
                    "Count(Row(n > 20))", None),
        ("POST", q + "?excludeRowAttrs=true", "Row(star='u1')", None),
        ("POST", q, pb_query("Row(star='u1') TopN(star, n=2) Rows(lang)"),
         PROTO),
        ("POST", q, pb_query("GroupBy(Rows(lang))"), PROTO),
        ("POST", q, pb_query("Row(star='u1')") + jax_proto._varint_field(
            3, 1), PROTO),
        ("POST", q + "?columnAttrs=true", pb_query("Row(lang='py')"),
         PROTO),
        ("POST", q, pb_query("Row(plain='a')"), PROTO),
        ("POST", q, "Row(star='nobody') Count(Row(star='nobody2'))", None),
        ("POST", "/batch/query", {"queries": [
            {"index": "dk", "query": "Row(star='fresh1')"},
            {"index": "dk", "query": "Options(Row(star='u1'), "
                                     "columnAttrs=true)"},
            {"index": "dk", "query": "SetRowAttrs(star, 'u3', active=true)"},
            {"index": "dk", "query": "TopN(star, attrName='active', "
                                     "attrValues=[true])"},
            {"index": "dk", "query": "Count(Row(star='fresh2'))"}]}, None),
        ("POST", q, "Rows(star) Row(star='fresh2')", None),
        ("GET", "/index/dk", None, None),
    ]
    answers = run_script(servers, "keys", steps)
    assert answers[-2]["results"][1] == {"columns": [], "keys": []}
    with_attrs = [a for a in answers
                  if isinstance(a, dict) and a.get("columnAttrs")]
    assert len(with_attrs) == 2 and all(
        "key" in c for a in with_attrs for c in a["columnAttrs"])


@pytest.mark.parametrize("body", [
    {"rowKeys": ["a", 7], "columnKeys": ["x", "y"]},
    {"rowKeys": ["a", "b"], "columnKeys": ["x", None]},
    {"rowKeys": [["a"]], "columnKeys": ["x"]},
    {"rowKeys": 5, "columnKeys": ["x"]},
    {"columnKeys": [1.5], "values": [3]},
], ids=["int-row", "null-column", "list-row", "not-a-list", "float-values"])
def test_non_string_keys_are_refused_before_allocation(servers, body):
    """A keyed JSON import holding a key that is not a string (or keys
    that are not a list) answers 400 in the port before either
    translator allocates an id; the JAX server answers 500 (its
    translate log's AttributeError), the recorded divergence. The port
    then takes a good import with the next ids."""
    jbase, pbase, papi = servers
    name = "dkn"
    if papi.holder.index(name) is None:
        run_script(servers, "keyed-schema", [
            ("POST", f"/index/{name}", {"options": {"keys": True}}, None),
            ("POST", f"/index/{name}/field/star",
             {"options": {"keys": True}}, None),
            ("POST", f"/index/{name}/field/n",
             {"options": {"type": "int", "min": 0, "max": 100}}, None),
            ("POST", f"/index/{name}/field/star/import",
             {"rowKeys": ["u0"], "columnKeys": ["r0"]}, None)])
    idx = papi.holder.index(name)
    cols, rows = idx.column_translator, idx.field("star").row_translator
    sizes = (cols.size(), rows.size())
    path = f"/index/{name}/field/{'n' if 'values' in body else 'star'}" \
        "/import"
    js, _, _ = call(jbase, "POST", path, body)
    ps, _, raw = call(pbase, "POST", path, body)
    assert (js, ps) == (500, 400), raw
    assert b"must be" in raw, raw
    assert (cols.size(), rows.size()) == sizes
    fresh = f"fresh{sizes[0]}"
    st, _, raw = call(pbase, "POST", f"/index/{name}/field/star/import",
                      {"rowKeys": [fresh], "columnKeys": [fresh]})
    assert st == 200, raw
    assert (cols.size(), rows.size()) == (sizes[0] + 1, sizes[1] + 1)


def pb_import_times(index, field, rows, cols, nanos):
    """ImportRequest with Timestamps=6 (int64 nanoseconds, packed)."""
    return pb_import(index, field, rows, cols) \
        + jax_proto._packed_uint64(6, nanos)


def test_time_mutex_bool_fields_match_jax(servers):
    """Time, mutex and bool fields over HTTP: creation (and the refused
    options), JSON imports with second, float and string timestamps, a
    protobuf import with nanosecond timestamps, mutex and bool imports,
    ranged reads, timestamped and mutex Sets, ClearRow and the index's
    schema: equal status codes and bodies."""
    rng = np.random.default_rng(29)
    n = 500
    cols = (rng.integers(0, 2, n) * SHARD_WIDTH
            + rng.integers(0, 5000, n)).tolist()
    rows = rng.integers(0, 3, n).tolist()
    # Seconds over January 2019 (read in local time, as both APIs read
    # them), as ints, floats and PQL strings; the same instants in
    # nanoseconds for the protobuf import.
    secs = (1546300800 + rng.integers(0, 31 * 86400, n)).tolist()
    as_json = [s if i % 3 == 0 else (s + 0.5 if i % 3 == 1 else
               datetime.fromtimestamp(s).strftime("%Y-%m-%dT%H:%M"))
               for i, s in enumerate(secs)]
    mutex_cols = cols + cols[:100]
    mutex_rows = rng.integers(1, 7, len(mutex_cols)).tolist()
    q = "/index/dtm/query"
    steps = [
        ("POST", "/index/dtm", {}, None),
        ("POST", "/index/dtm/field/t",
         {"options": {"type": "time", "timeQuantum": "YMD"}}, None),
        ("POST", "/index/dtm/field/tn",
         {"options": {"type": "time", "timeQuantum": "YMDH",
                      "noStandardView": True}}, None),
        ("POST", "/index/dtm/field/m", {"options": {"type": "mutex"}}, None),
        ("POST", "/index/dtm/field/b", {"options": {"type": "bool"}}, None),
        ("POST", "/index/dtm/field/c", {}, None),
        ("POST", "/index/dtm/field/x", {"options": {"type": "time"}}, None),
        ("POST", "/index/dtm/field/y",
         {"options": {"type": "time", "timeQuantum": "DY"}}, None),
        ("POST", "/index/dtm/field/z", {"options": {"type": "nope"}}, None),
        ("POST", "/index/dtm/field/t/import",
         {"rowIDs": rows, "columnIDs": cols, "timestamps": as_json}, None),
        ("POST", "/index/dtm/field/tn/import",
         pb_import_times("dtm", "tn", rows, cols,
                         [s * 10 ** 9 + 123 for s in secs]), PROTO),
        ("POST", "/index/dtm/field/m/import",
         {"rowIDs": mutex_rows, "columnIDs": mutex_cols}, None),
        ("POST", "/index/dtm/field/b/import",
         pb_import("dtm", "b", [int(c % 7 == 0) for c in cols], cols),
         PROTO),
        ("POST", "/index/dtm/field/c/import",
         {"rowIDs": rows, "columnIDs": cols}, None),
        ("POST", "/index/dtm/field/m/import",
         {"rowIDs": [1], "columnIDs": [1], "timestamps": [1]}, None),
        ("GET", "/index/dtm", None, None),
        ("POST", q, "Count(Row(t=1, from='2019-01-05', to='2019-01-12')) "
                    "Count(Row(t=1, from='2019-01-02', to='2019-01-20')) "
                    "Count(Range(t=2, from='2019-01-01', to='2019-02-01'))",
         None),
        ("POST", q, "Row(tn=0, from='2019-01-05T03:00', "
                    "to='2019-01-07T00:00')", None),
        ("POST", q, pb_query("Rows(tn) Rows(t, from='2019-01-10')"), PROTO),
        ("POST", q, "TopN(m) TopN(b) Row(b=true) Count(Row(m=3))", None),
        ("POST", q, "TopN(c, Row(t=0, from='2019-01-05', to='2019-01-12'))",
         None),
        ("POST", q, "GroupBy(Rows(m), Rows(b)) "
                    "GroupBy(Rows(t, from='2019-01-05', to='2019-01-12'), "
                    "Rows(c))", None),
        ("POST", q, f"Set({cols[0]}, t=2, 2019-01-30T08:00) "
                    f"Set({cols[0]}, m=6) Set({cols[0]}, b=true) "
                    f"Set({cols[0]}, c=1, 2019-01-30T08:00)", None),
        ("POST", q, "Count(Row(t=2, from='2019-01-30', to='2019-01-31')) "
                    f"Rows(m, column={cols[0]}) TopN(m)", None),
        ("POST", "/batch/query", {"queries": [
            {"index": "dtm",
             "query": "Count(Row(t=1, from='2019-01-03', to='2019-01-11'))"},
            {"index": "dtm", "query": "Count(Row(m=2))"},
            {"index": "dtm", "query": "Row(b=false)"},
            {"index": "dtm", "query": "Count(Row(t=0, from='2019-01-02', "
                                      "to='2019-01-20'))"}]}, None),
        ("POST", q, "ClearRow(m=2) ClearRow(t=1) Rows(m) "
                    "Rows(t, from='2019-01-01', to='2019-02-01')", None),
        ("POST", q, "Store(Row(c=1), t=5) Count(Row(t=5)) "
                    "Store(Row(c=1), m=5)", None),
    ]
    answers = run_script(servers, "time-mutex-bool", steps)
    # /schema: the other tests leave port-only indexes behind, so the
    # two servers' entries for this index are compared.
    schemas = [[i for i in json.loads(call(base, "GET", "/schema")[2])[
        "indexes"] if i["name"] == "dtm"] for base in servers[:2]]
    assert schemas[0] == schemas[1] and len(schemas[0]) == 1
    fields = {f["name"]: f["options"] for f in answers[15]["fields"]}
    assert (fields["t"]["type"], fields["tn"]["noStandardView"],
            fields["m"]["type"], fields["b"]["type"]) == \
        ("time", True, "mutex", "bool")
    counts = answers[16]["results"]
    assert counts[1] > counts[0] > 0 and counts[2] > 0


def test_concurrent_mixed_reads_and_writes(servers):
    """32 concurrent POSTs released together: reads of rows no write
    touches equal the direct path's answer, every read of the written row
    lies between the writes finished before it was sent and the writes
    sent before it was answered, and the coalescer formed a batch."""
    _, pbase, papi = servers
    run_script(servers, "load", load_steps("dc"))
    reads = ["Count(Row(f=1))", "Row(g=2)", "Count(Row(v > 400))",
             "TopN(f, n=3)", "Count(Intersect(Row(f=2), Row(g=1)))",
             "Count(Union(Row(f=3), Row(g=3)))"]
    want = {q: papi.executor.execute_full("dc", q) for q in reads}
    n_threads, n_writes = 32, 8
    write_cols = [3 * SHARD_WIDTH + 100 * i for i in range(n_writes)]
    done_writes, lock = [], threading.Lock()
    errors, observed = [], []
    barrier = threading.Barrier(n_threads)
    coal = papi.coalescer
    before = coal.counters.get("batches", 0)
    coal.window_s = 0.005

    def worker(t):
        try:
            barrier.wait(timeout=30)
            if t < n_writes:
                st, _, raw = call(pbase, "POST", "/index/dc/query",
                                  f"Set({write_cols[t]}, h=7)")
                assert st == 200, raw
                with lock:
                    done_writes.append(write_cols[t])
            elif t % 3 == 0:
                with lock:
                    floor = set(done_writes)
                st, _, raw = call(pbase, "POST", "/index/dc/query",
                                  "Row(h=7)")
                assert st == 200, raw
                observed.append((floor, set(json.loads(raw)["results"][0]
                                            ["columns"])))
            else:
                q = reads[t % len(reads)]
                st, _, raw = call(pbase, "POST", "/index/dc/query", q)
                assert st == 200, raw
                assert json.loads(raw) == want[q], q
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    papi.create_field("dc", "h")
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        coal.window_s = WINDOW_S
    assert not errors, errors
    assert observed
    for floor, cols in observed:
        assert floor <= cols <= set(write_cols), (floor, cols)
    assert coal.counters.get("batches", 0) > before
    st, _, raw = call(pbase, "POST", "/index/dc/query", "Count(Row(h=7))")
    assert json.loads(raw)["results"] == [n_writes]


@pytest.mark.parametrize("megakernel", [False, True])
def test_write_between_begin_and_finish_does_not_leak(monkeypatch,
                                                      megakernel):
    """A batch's finish answers the state its begin saw, though a write
    lands in between (the pipelined coalescer's overlap)."""
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor import megakernel as megamod
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", megakernel)
    h = Holder(device="cpu")
    idx = h.create_index("i")
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 3000).astype(np.uint64)
    idx.create_field("f").import_bits(
        rng.integers(0, 4, 3000).astype(np.uint64), cols)
    idx.add_existence(cols)
    ex = Executor(h, device="cpu")
    # The batch must launch after the same reads ran once: no result
    # cache.
    ex.result_cache.enabled = False
    reqs = [("i", q, None) for q in (
        "Count(Row(f=1))", "Row(f=1)", "Count(Intersect(Row(f=1), "
        "Row(f=2)))", "Count(Not(Row(f=1)))", "TopN(f, n=2)")]
    want = [ex.execute_full(i, q) for i, q, _ in reqs]
    launches = ex.mega_launches
    flight = ex.execute_batch_shaped_begin(reqs)
    new_col = 2 * SHARD_WIDTH + 17
    assert ex.execute("i", f"Set({new_col}, f=1) Set({new_col}, f=2)") \
        == [True, True]
    got = ex.execute_batch_shaped_finish(flight)
    assert got == want
    assert ex.mega_launches == launches + int(megakernel)
    after = ex.execute_full("i", "Count(Row(f=1))")["results"][0]
    assert after == want[0]["results"][0] + 1


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_cli(*args):
    """Start ``python -m pilosa_tpu_torch.cli server`` with ``args``;
    returns (process, queue of its stdout lines)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    return proc, lines


def test_cli_server_answers_on_cpu():
    """The CLI's server on the CPU: create an index with a set and an
    int field, import, and answer Count, TopN and Sum exactly."""
    proc, lines = start_cli("--device", "cpu", "--bind", "127.0.0.1:0")
    try:
        first = lines.get(timeout=120)
        assert "listening on http://127.0.0.1:" in first, first
        base = first.split("listening on ")[1].split()[0]
        rng = np.random.default_rng(5)
        cols = np.arange(50000, dtype=np.uint64) * 7
        cab = rng.integers(0, 3, len(cols))
        dist = rng.integers(0, 300, len(cols))
        for step in [
                ("POST", "/index/taxi", {}),
                ("POST", "/index/taxi/field/cab_type", {}),
                ("POST", "/index/taxi/field/dist",
                 {"options": {"type": "int", "min": 0, "max": 300}}),
                ("POST", "/index/taxi/field/cab_type/import",
                 {"rowIDs": cab.tolist(), "columnIDs": cols.tolist()}),
                ("POST", "/index/taxi/field/dist/import",
                 {"columnIDs": cols.tolist(), "values": dist.tolist()})]:
            st, _, raw = call(base, *step)
            assert st == 200, (step[1], raw)
        st, _, raw = call(base, "POST", "/index/taxi/query",
                          "Count(Row(cab_type=1)) TopN(cab_type, n=2) "
                          "Sum(Row(cab_type=2), field=dist)")
        assert st == 200, raw
        counts = sorted(((int((cab == c).sum()), c) for c in range(3)),
                        key=lambda x: (-x[0], x[1]))
        assert json.loads(raw)["results"] == [
            int((cab == 1).sum()),
            [{"id": c, "count": n} for n, c in counts[:2]],
            {"value": int(dist[cab == 2].sum()),
             "count": int((cab == 2).sum())}]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, proc.stderr.read()


def cli_base(lines):
    first = lines.get(timeout=120)
    assert "listening on http://127.0.0.1:" in first, first
    return first.split("listening on ")[1].split()[0]


def test_cli_server_restarts_on_its_data_dir(tmp_path):
    """``server --data-dir`` on the CPU: imports and a Set, SIGTERM (exit
    0), a restart on the same directory with the same answers; a Set
    acknowledged just before SIGKILL reads back after the next restart;
    ``export`` writes the field as the server exports it."""
    data = str(tmp_path / "data")
    args = ("--device", "cpu", "--bind", "127.0.0.1:0", "--data-dir", data,
            "--no-coalescer")
    rng = np.random.default_rng(6)
    cols = rng.choice(3 * SHARD_WIDTH, 20000, replace=False).astype(np.uint64)
    cab = rng.integers(0, 3, len(cols))
    q = "/index/taxi/query"
    reads = ("Count(Row(cab_type=1)) TopN(cab_type, n=3) "
             "Sum(Row(cab_type=2), field=dist) Count(Row(cab_type=7))")
    proc, lines = start_cli(*args)
    try:
        base = cli_base(lines)
        for step in [
                ("POST", "/index/taxi", {}),
                ("POST", "/index/taxi/field/cab_type", {}),
                ("POST", "/index/taxi/field/dist",
                 {"options": {"type": "int", "min": 0, "max": 300}}),
                ("POST", "/index/taxi/field/cab_type/import",
                 {"rowIDs": cab.tolist(), "columnIDs": cols.tolist()}),
                ("POST", "/index/taxi/field/dist/import",
                 {"columnIDs": cols.tolist(),
                  "values": (cab * 100).tolist()}),
                ("POST", q, f"Set({int(cols[0])}, cab_type=7)")]:
            st, _, raw = call(base, *step)
            assert st == 200, (step[1], raw)
        st, _, want = call(base, "POST", q, reads)
        assert st == 200, want
        st, _, csv_want = call(base, "GET",
                               "/export?index=taxi&field=cab_type&shard=1")
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, proc.stderr.read()
    assert json.loads(want)["results"][0] == int((cab == 1).sum())
    proc, lines = start_cli(*args)
    try:
        base = cli_base(lines)
        assert call(base, "POST", q, reads)[2] == want
        st, _, raw = call(base, "POST", q, "Set(5, cab_type=8)")
        assert st == 200 and json.loads(raw)["results"] == [True]
    finally:
        proc.kill()
        proc.wait(timeout=60)
    proc, lines = start_cli(*args)
    try:
        base = cli_base(lines)
        assert call(base, "POST", q, reads)[2] == want
        st, _, raw = call(base, "POST", q, "Row(cab_type=8)")
        assert json.loads(raw)["results"] == [{"columns": [5]}]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    out = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "export", "--data-dir",
         data, "--index", "taxi", "--field", "cab_type", "--shard", "1",
         "--device", "cpu"], cwd=REPO, capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == csv_want and csv_want.count(b"\n") == \
        int(((cols >= SHARD_WIDTH) & (cols < 2 * SHARD_WIDTH)).sum())


def test_cli_server_refuses_to_start_without_a_card():
    """No CUDA device and no --device cpu: the server raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would start")
    proc, _ = start_cli("--bind", "127.0.0.1:0")
    rc = proc.wait(timeout=120)
    assert rc != 0
    assert "no CUDA device" in proc.stderr.read()


# ------------------------------------------------------ measurement plane

# /metrics families of the JAX server that only XLA has, and so stay
# the JAX server's alone:
# - pilosa_executor_jit_cache_size: the size of the JAX executor's cache
#   of compiled XLA programs; the port compiles no program per shape
#   (its kernels are one prebuilt library).
# - pilosa_executor_jit_miss_total and pilosa_executor_retrace_total:
#   XLA traces and compiles of a new program shape; the port's CPU path
#   loads no kernel library, so it never counts one.
# - pilosa_executor_h2d_bytes_total: the per-program operand vectors the
#   JAX eager path uploads to its jitted program; the port's eager path
#   passes no operand vector.
JAX_ONLY_FAMILIES = {
    "pilosa_executor_jit_cache_size", "pilosa_executor_jit_miss_total",
    "pilosa_executor_retrace_total", "pilosa_executor_h2d_bytes_total",
}

METRICS_TRAFFIC = [
    ("POST", "/index/m", {}),
    ("POST", "/index/m/field/f", {}),
    ("POST", "/index/m/field/g", {}),
    ("POST", "/index/m/field/v",
     {"options": {"type": "int", "min": 0, "max": 100}}),
    ("POST", "/index/m/field/f/import",
     {"rowIDs": [1, 1, 2, 3], "columnIDs": [1, 5, SHARD_WIDTH, 9]}),
    ("POST", "/index/m/field/g/import", {"rowIDs": [1, 2],
                                         "columnIDs": [1, 9]}),
    ("POST", "/index/m/field/v/import", {"columnIDs": [1, 9],
                                         "values": [5, 50]}),
    ("POST", "/index/m/query", "Count(Intersect(Row(f=1), Row(g=1)))"),
    ("POST", "/index/m/query?profile=true",
     "Row(f=1) Sum(Row(f=1), field=v) TopN(f, n=2)"),
    ("POST", "/batch/query", {"queries": [
        {"index": "m", "query": q} for q in (
            "Count(Row(f=1))", "Row(g=2)",
            "Count(Union(Row(f=2), Row(g=1)))")]}),
    ("GET", "/debug/queries", None),
    ("GET", "/debug/memory", None),
    ("GET", "/debug/roofline", None),
    ("GET", "/debug/timeline?last=2", None),
    ("GET", "/debug/vars", None),
    ("GET", "/nope", None),
]


@pytest.fixture
def stat_servers(tmp_path, monkeypatch):
    """A JAX and a port server with in-memory stats clients, span
    recorders and coalescers, the megakernel on in both."""
    from pilosa_tpu.executor import megakernel as jmegamod
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.utils.stats import MemStatsClient as PortStats
    from pilosa_tpu_torch.utils.tracing import RecordingTracer
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    # The roofline recorders are process-wide: an earlier test's drift
    # must not publish into these servers' fresh stats clients.
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    japi = JaxAPI(jh, stats=MemStatsClient())
    papi = API(Holder(device="cpu"), stats=PortStats(),
               tracer=RecordingTracer())
    japi.coalescer = JaxCoalescer(japi.executor, window_s=WINDOW_S,
                                  stats=japi.stats, tracer=japi.tracer)
    papi.coalescer = QueryCoalescer(papi.executor, window_s=WINDOW_S,
                                    stats=papi.stats, tracer=papi.tracer)
    servers = []
    for api, srv_fn in ((japi, jax_serve), (papi, serve)):
        api.coalescer.start()
        servers.append(srv_fn(api, "localhost", 0, background=True))
    yield [f"http://localhost:{s.server_address[1]}" for s in servers], \
        papi
    for srv, api in zip(servers, (japi, papi)):
        srv.shutdown()
        srv.server_close()
        api.coalescer.stop()
    jh.close()


def _families(base):
    st, ctype, raw = call(base, "GET", "/metrics")
    assert st == 200 and ctype.startswith("text/plain"), (st, ctype)
    return {ln.split()[2] for ln in raw.decode().splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_families_match_jax(stat_servers):
    """After the same traffic both servers answer every request with the
    same status, and their /metrics carry the same families apart from
    JAX_ONLY_FAMILIES."""
    (jbase, pbase), _ = stat_servers
    for method, path, body in METRICS_TRAFFIC:
        js = call(jbase, method, path, body)[0]
        ps = call(pbase, method, path, body)[0]
        assert js == ps, (path, js, ps)
    jf, pf = _families(jbase), _families(pbase)
    assert pf == jf - JAX_ONLY_FAMILIES, (sorted(pf ^ (jf - JAX_ONLY_FAMILIES)))
    for fam in ("pilosa_executor_mega_launches_total",
                "pilosa_executor_launch_bytes_total",
                "pilosa_roofline_gbps", "pilosa_device_idle_ratio",
                "pilosa_memory_bytes", "pilosa_http_request_seconds",
                "pilosa_executor_device_seconds"):
        assert fam in pf, fam


def test_debug_routes_and_traceparent(stat_servers):
    """The port's /debug routes answer the JAX server's documents' keys;
    a request's traceparent comes back on its response and names its
    timeline."""
    (jbase, pbase), papi = stat_servers
    for method, path, body in METRICS_TRAFFIC[:10]:
        call(jbase, method, path, body)
        call(pbase, method, path, body)
    for path in ("/debug/memory", "/debug/roofline", "/debug/timeline",
                 "/debug/vars"):
        jdoc = json.loads(call(jbase, "GET", path)[2])
        pdoc = json.loads(call(pbase, "GET", path)[2])
        assert set(pdoc) <= set(jdoc), (path, set(pdoc) - set(jdoc))
        assert pdoc, path
    pq = json.loads(call(pbase, "GET", "/debug/queries")[2])
    jq = json.loads(call(jbase, "GET", "/debug/queries")[2])
    assert set(pq) <= set(jq)
    roof = json.loads(call(pbase, "GET", "/debug/roofline")[2])
    assert roof["launches"] >= 1 and roof["estimateOnly"] is True
    assert roof["executor"]["megaLaunches"] == papi.executor.mega_launches
    tid = "12" * 16
    req = urllib.request.Request(
        pbase + "/index/m/query", data=b"Count(Row(f=1))", method="POST",
        headers={"traceparent": f"00-{tid}-{'34' * 8}-01"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert json.loads(resp.read())["results"] == [2]
        assert resp.headers["traceparent"].split("-")[1] == tid
    doc = json.loads(call(pbase, "GET", f"/debug/timeline?trace={tid}")[2])
    assert doc["summary"]["requests"] == 1
    with urllib.request.urlopen(pbase + "/version", timeout=30) as resp:
        minted = resp.headers["traceparent"].split("-")[1]
    assert len(minted) == 32 and minted != tid


def _key_tree(doc, depth=2):
    """A document's keys, nested ``depth`` levels into dicts."""
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in doc.items()}


def test_serving_plane_routes_answer_like_jax(stat_servers, monkeypatch):
    """/debug/hotspots, /debug/history, /debug/slo, /internal/health and
    /internal/failpoints (GET and POST) answer with the JAX server's
    statuses and document shapes after the same traffic; the SLO stanza,
    the failpoint counts and the result cache's per-tier counters are
    equal."""
    from pilosa_tpu.utils.failpoints import FAILPOINTS as JAX_FAILPOINTS
    from pilosa_tpu_torch.utils.failpoints import FAILPOINTS
    # The registries are process-wide and other test files fire them:
    # the counts compared are this test's own.
    for reg in (JAX_FAILPOINTS, FAILPOINTS):
        monkeypatch.setattr(reg, "fired_total", 0)
        for site in reg._sites.values():
            monkeypatch.setattr(site, "hits", 0)
    (jbase, pbase), papi = stat_servers
    for method, path, body in METRICS_TRAFFIC:
        assert call(jbase, method, path, body)[0] == \
            call(pbase, method, path, body)[0]
    docs = {}
    for path in ("/debug/hotspots", "/debug/hotspots?topk=2",
                 "/debug/history", "/debug/history?series=x&last=1",
                 "/debug/slo", "/internal/health", "/internal/failpoints",
                 "/debug/history?bogus=1", "/debug/hotspots?topk=x"):
        (js, _, jb), (ps, _, pb) = (call(jbase, "GET", path),
                                    call(pbase, "GET", path))
        assert js == ps, (path, js, ps, pb[:300])
        docs[path] = (json.loads(jb), json.loads(pb))
    j, p = docs["/debug/hotspots"]
    assert _key_tree(p, 1) == _key_tree(j, 1)
    assert _key_tree(p["opportunity"]) == _key_tree(j["opportunity"])
    assert p["resultCache"]["tiers"] == j["resultCache"]["tiers"]
    j, p = docs["/debug/slo"]
    j.pop("node"), p.pop("node")
    assert p == j
    j, p = docs["/internal/health"]
    assert set(p) == set(j)
    for k, v in j.items():
        if isinstance(v, dict) and k != "layout":
            assert _key_tree(p[k], 1) == _key_tree(v, 1), k
    assert p["slo"] == j["slo"] and p["failpoints"] == j["failpoints"]
    assert p["clusterEvents"] == j["clusterEvents"] == []
    assert p["placementGen"] == j["placementGen"] == 0
    assert p["executor"]["meshLaunches"] == 0
    assert docs["/internal/failpoints"][1]["error"].startswith(
        "failpoints surface disabled")
    post = {"arm": {"api.status": "errorx1"}}
    assert call(jbase, "POST", "/internal/failpoints", post)[0] == \
        call(pbase, "POST", "/internal/failpoints", post)[0] == 403
    try:
        for fp in (JAX_FAILPOINTS, FAILPOINTS):
            fp.http_enabled = True
        outs = [json.loads(call(b, "POST", "/internal/failpoints",
                                post)[2]) for b in (jbase, pbase)]
        assert outs[1]["sites"]["api.status"] == \
            outs[0]["sites"]["api.status"] == {"armed": "errorx1",
                                               "hits": 0}
        assert [call(b, "GET", "/status")[0] for b in (jbase, pbase)] \
            == [500, 500]
        assert [call(b, "GET", "/status")[0] for b in (jbase, pbase)] \
            == [200, 200]
        bad = {"arm": {"nope": "error"}}
        assert call(jbase, "POST", "/internal/failpoints", bad)[0] == \
            call(pbase, "POST", "/internal/failpoints", bad)[0] == 400
    finally:
        for fp in (JAX_FAILPOINTS, FAILPOINTS):
            fp.disarm_all()
            fp.http_enabled = False
