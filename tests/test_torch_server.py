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


def test_port_refuses_what_is_not_ported(servers):
    """Requests that need an unported part answer 400 (404 for a route)
    naming it: never a silently different answer."""
    _, pbase, papi = servers
    papi.create_index("dn")
    papi.create_field("dn", "f")
    cases = [
        ("POST", "/index/dn/query?columnAttrs=true", "Row(f=1)",
         "column attributes"),
        ("POST", "/index/dn/query", "Options(Row(f=1), columnAttrs=true)",
         "column attributes"),
        ("POST", "/index/dn/query?profile=true", "Row(f=1)",
         "query profiler"),
        ("POST", "/index/dn/query?remote=true", "Row(f=1)", "cluster"),
        ("POST", "/index/dn/query", "Row(f=1, from='2020-01-01T00:00')",
         "time ranges"),
        ("POST", "/index/dn/query", "Set('k', f=1)", "column keys"),
        ("POST", "/index/dn/query", "Rows(f)", "Rows"),
        ("POST", "/index/kx", {"options": {"keys": True}}, "index keys"),
        ("POST", "/index/dn/field/t",
         {"options": {"type": "time", "timeQuantum": "YMD"}}, "time"),
        ("POST", "/index/dn/field/k", {"options": {"keys": True}}, "keyed"),
        ("POST", "/index/dn/field/f/import",
         {"rowKeys": ["a"], "columnIDs": [1]}, "key translation"),
        ("POST", "/index/dn/field/f/import",
         {"rowIDs": [1], "columnIDs": [1], "timestamps": [1]}, "timestamps"),
    ]
    for method, path, body, what in cases:
        st, _, raw = call(pbase, method, path, body)
        assert st == 400, (path, body, st, raw)
        assert what in json.loads(raw)["error"], (path, body, raw)
    for path, what in (("/export", "export"), ("/metrics", "metrics"),
                       ("/internal/nodes", "cluster")):
        st, _, raw = call(pbase, "GET", path)
        assert st == 404 and what in json.loads(raw)["error"], (path, raw)
    st, _, raw = call(pbase, "POST", "/index/dn/query",
                      pb_query("Row(f=1)") + jax_proto._varint_field(5, 1),
                      PROTO)
    assert st == 400 and b"cluster" in raw


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
    reqs = [("i", q, None) for q in (
        "Count(Row(f=1))", "Row(f=1)", "Count(Intersect(Row(f=1), "
        "Row(f=2)))", "Count(Not(Row(f=1)))", "TopN(f, n=2)")]
    want = [ex.execute_full(i, q) for i, q, _ in reqs]
    launches = ex.mega_launches
    flight = ex.execute_batch_begin(reqs)
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


def test_cli_server_refuses_to_start_without_a_card():
    """No CUDA device and no --device cpu: the server raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would start")
    proc, _ = start_cli("--bind", "127.0.0.1:0")
    rc = proc.wait(timeout=120)
    assert rc != 0
    assert "no CUDA device" in proc.stderr.read()
