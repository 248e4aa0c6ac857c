"""The port's static cluster (``pilosa_tpu_torch/parallel/``, the
cluster half of ``server/api.py`` and ``server/http.py``) against the
JAX package's, on the CPU: three real servers a cluster on loopback,
built as ``tests/test_cluster.py`` builds them, with the same node ids
in both clusters so that placement (and with it TopN's one-pass merge)
is the same. Seeded random scripts of reads and writes over set, int,
time, mutex and bool fields go through every node as coordinator, one
request at a time and as ``/batch/query``, at replica 1 and 2, and the
JSON answers must be equal; so must they with a node stopped, and in a
mixed cluster of two JAX nodes and one port node (the node-to-node API
and the wire codec between the packages)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.parallel.cluster import Cluster as JaxCluster
from pilosa_tpu.parallel.cluster import Node as JaxNode
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.utils.stats import MemStatsClient as JaxStats

from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.parallel.cluster import STATE_NORMAL, Cluster, Node
from pilosa_tpu_torch.server import API, serve
from pilosa_tpu_torch.utils.stats import MemStatsClient

SW = 1 << 20
N_SHARDS = 6


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag raised here
    must not reach a later test's sentinel."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


class ClusterNode:
    """One server of a test cluster: a JAX or a port holder, its API and
    its HTTP server on a free loopback port."""

    def __init__(self, kind, tmp_path, name, server_ssl=None,
                 client_ssl=None):
        self.kind = kind
        self.client_ssl = client_ssl
        if kind == "jax":
            self.holder = JaxHolder(str(tmp_path / name))
            self.holder.open()
            self.api = JaxAPI(self.holder, stats=JaxStats())
            self.server = jax_serve(self.api, "localhost", 0,
                                    background=True, ssl_context=server_ssl)
        else:
            self.holder = Holder(device="cpu")
            self.api = API(self.holder, stats=MemStatsClient())
            self.server = serve(self.api, "localhost", 0, background=True,
                                ssl_context=server_ssl)
        scheme = "https" if server_ssl is not None else "http"
        self.uri = f"{scheme}://localhost:{self.server.server_address[1]}"
        self.cluster = None

    def attach(self, members, replica_n):
        """Join the static cluster of ``members`` [(id, uri)]: the API
        is rebuilt over the same holder and server."""
        node_id = next(i for i, u in members if u == self.uri)
        C, N, A = (JaxCluster, JaxNode, JaxAPI) if self.kind == "jax" \
            else (Cluster, Node, API)
        stats = JaxStats() if self.kind == "jax" else MemStatsClient()
        cluster = C(N(node_id, self.uri), replica_n=replica_n)
        for i, u in members:
            if u != self.uri:
                cluster.add_node(N(i, u))
        cluster.set_state(STATE_NORMAL)
        self.api = A(self.holder, cluster=cluster, stats=stats,
                     client_ssl_context=self.client_ssl)
        self.server.RequestHandlerClass.api = self.api
        self.cluster = cluster

    def stop_server(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None

    def close(self):
        if self.api.broadcaster is not None:
            self.api.broadcaster.stop()
        self.stop_server()
        if self.kind == "jax":
            self.holder.close()


def start_cluster(tmp_path, kinds, replica_n=1, server_ssl=None,
                  client_ssl=None, prefix=""):
    """A static cluster of one node a kind, ids n0, n1, ... in order."""
    nodes = [ClusterNode(k, tmp_path, f"{prefix}{k}{i}",
                         server_ssl=server_ssl, client_ssl=client_ssl)
             for i, k in enumerate(kinds)]
    members = [(f"n{i}", nd.uri) for i, nd in enumerate(nodes)]
    for nd in nodes:
        nd.attach(members, replica_n)
    return nodes


def close_all(*clusters):
    """Close every node at once (a server's shutdown waits out its
    serve loop's poll)."""
    import threading
    threads = [threading.Thread(target=nd.close)
               for nodes in clusters for nd in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def call(base, method, path, body=None, headers=None, ssl_ctx=None):
    """(status, parsed JSON) of one request."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=60, context=ssl_ctx) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def both(clusters, node, method, path, body=None, where=""):
    """Send one request to node ``node`` of every cluster; the answers
    must be equal. Returns the first."""
    got = [call(c[node].uri, method, path, body) for c in clusters]
    for g in got[1:]:
        assert g == got[0], (where, node, method, path, body, got)
    return got[0]


FIELDS = [("f", {}), ("m", {"type": "mutex"}), ("b", {"type": "bool"}),
          ("t", {"type": "time", "timeQuantum": "YMD"}),
          ("v", {"type": "int", "min": -1000, "max": 1000})]


def load_steps(index, seed, n_bits=240):
    """Schema and bulk imports of a seeded index over N_SHARDS shards."""
    rng = np.random.default_rng(seed)
    cols = (rng.integers(0, N_SHARDS, n_bits) * SW
            + rng.integers(0, 400, n_bits)).tolist()
    steps = [("POST", f"/index/{index}", {"options": {}})]
    steps += [("POST", f"/index/{index}/field/{name}", {"options": opts})
              for name, opts in FIELDS]
    imp = f"/index/{index}/field/%s/import"
    steps += [
        ("POST", imp % "f", {"rowIDs": rng.integers(0, 6, n_bits).tolist(),
                             "columnIDs": cols}),
        ("POST", imp % "m", {"rowIDs": rng.integers(0, 4, n_bits).tolist(),
                             "columnIDs": cols}),
        ("POST", imp % "b", {"rowIDs": rng.integers(0, 2, n_bits).tolist(),
                             "columnIDs": cols}),
        ("POST", imp % "t", {"rowIDs": rng.integers(0, 3, n_bits).tolist(),
                             "columnIDs": cols,
                             "timestamps": [f"2019-01-{d:02d}T00:00" for d in
                                            rng.integers(1, 28, n_bits)]}),
        ("POST", imp % "v", {"columnIDs": cols,
                             "values": rng.integers(-900, 900,
                                                    n_bits).tolist()}),
    ]
    return steps


def random_pql(rng):
    """One read or write of the script."""
    r = int(rng.integers(0, 6))
    col = int(rng.integers(0, N_SHARDS + 1) * SW + rng.integers(0, 400))
    a, b = sorted(int(x) for x in rng.integers(1, 28, 2))
    reads = [
        f"Count(Row(f={r}))", f"Row(m={r % 4})", f"TopN(f, n={r % 3 + 1})",
        f"TopN(f, Row(m={r % 4}), n=2)", "Rows(f)", "Rows(m, limit=2)",
        "GroupBy(Rows(f), Rows(b))", "GroupBy(Rows(m), limit=3)",
        "Sum(field=v)", f"Sum(Row(f={r}), field=v)", "Min(field=v)",
        f"Max(Row(m={r % 4}), field=v)", f"Count(Row(v > {r * 100 - 300}))",
        f"Count(Row(t={r % 3}, from='2019-01-{a:02d}T00:00', "
        f"to='2019-01-{b:02d}T00:00'))",
        f"Count(Union(Row(f={r}), Row(m={r % 4})))",
        f"Count(Intersect(Row(f={r}), Row(b=true)))",
        f"Count(Difference(Row(f={r}), Row(m=1)))",
        f"Count(Xor(Row(f={r}), Row(f={(r + 1) % 6})))",
        f"Count(Not(Row(f={r})))",
        f"Options(Count(Row(f={r})), shards=[0, 2, 5])",
        f"Row(f={r}) Count(Row(b=false))",
    ]
    writes = [
        f"Set({col}, f={r})", f"Clear({col}, f={r})", f"Set({col}, m={r % 4})",
        f"Set({col}, b=true)", f"Set({col}, v={r * 37 - 100})",
        f"Set({col}, t={r % 3}, 2019-01-{a:02d}T00:00)",
        f"ClearRow(f={(r + 2) % 6})", f"Set({col}, f={r}) Count(Row(f={r}))",
    ]
    pool = writes if rng.random() < 0.3 else reads
    return pool[int(rng.integers(0, len(pool)))]


def run_script(clusters, index, seed, steps=12, nodes=(0, 1, 2)):
    """``steps`` seeded requests, each through a coordinator drawn from
    ``nodes``: a single query, or every fourth a /batch/query of three."""
    rng = np.random.default_rng(1000 + seed)
    for i in range(steps):
        node = nodes[int(rng.integers(0, len(nodes)))]
        if i % 4 == 3:
            items = [{"index": index, "query": random_pql(rng)}
                     for _ in range(3)]
            items.append({"index": index, "query": "Count(Row(f=1))",
                          "shards": [0, 1]})
            st, _ = both(clusters, node, "POST", "/batch/query",
                         {"queries": items}, where=f"step {i}")
        else:
            st, _ = both(clusters, node, "POST", f"/index/{index}/query",
                         random_pql(rng).encode(), where=f"step {i}")
        assert st == 200, (i, st)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("replica_n", [1, 2])
def test_random_scripts_match_jax(tmp_path, replica_n, seed):
    jc = start_cluster(tmp_path, ["jax"] * 3, replica_n, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 3, replica_n, prefix="p")
    try:
        clusters = [jc, pc]
        for i, (m, p, b) in enumerate(load_steps("d", seed)):
            assert both(clusters, i % 3, m, p, b)[0] == 200, p
        # Every node sees the schema the coordinators created.
        for node in range(3):
            both(clusters, node, "GET", "/schema")
        run_script(clusters, "d", seed)
        # Each node holds exactly the shards placement gives it.
        for nd in pc:
            held = set(nd.holder.index("d").available_shards())
            owned = {s for s in range(N_SHARDS + 1)
                     if nd.cluster.owns_shard("d", s)}
            assert held <= owned, (nd.cluster.local.id, held, owned)
    finally:
        close_all(jc, pc)


@pytest.mark.parametrize("down", [0, 2])
def test_failover_with_a_node_stopped_matches_jax(tmp_path, down):
    """Replica 2: with one node's server stopped, every read through the
    survivors still answers as the JAX cluster's does, and a write to a
    shard the stopped node co-owns lands on its live owner."""
    jc = start_cluster(tmp_path, ["jax"] * 3, 2, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 3, 2, prefix="p")
    try:
        clusters = [jc, pc]
        for m, p, b in load_steps("d", 7):
            both(clusters, 0, m, p, b)
        for c in clusters:
            c[down].stop_server()
        live = [i for i in range(3) if i != down]
        run_script(clusters, "d", 7 + down, steps=8, nodes=live)
        # A Set into a shard the stopped node owns reads back.
        c0 = pc[live[0]].cluster
        shard = next(s for s in range(64)
                     if f"n{down}" in [n.id for n in c0.shard_nodes("d", s)])
        col = shard * SW + 11
        both(clusters, live[0], "POST", "/index/d/query",
             f"Set({col}, f=5)".encode())
        st, got = both(clusters, live[1], "POST", "/index/d/query",
                       f"Row(f=5)".encode())
        assert col in got["results"][0]["columns"]
    finally:
        close_all(jc, pc)


@pytest.mark.parametrize("port_at", [0, 2])
def test_mixed_cluster_answers_like_jax(tmp_path, port_at):
    """Two JAX nodes and one port node form one cluster (the port node
    first or last in id order, so it is the translate primary or not):
    imports, schema broadcast, fan-out and merge cross the packages over
    the wire codec, and every answer equals an all-JAX cluster's."""
    kinds = ["jax"] * 3
    kinds[port_at] = "torch"
    jc = start_cluster(tmp_path, ["jax"] * 3, 2, prefix="j")
    mc = start_cluster(tmp_path, kinds, 2, prefix="m")
    try:
        clusters = [jc, mc]
        for i, (m, p, b) in enumerate(load_steps("d", 3)):
            both(clusters, i % 3, m, p, b)
        run_script(clusters, "d", 3, steps=8)
        # A keyed index through the mixed cluster's nodes.
        steps = [("POST", "/index/k", {"options": {"keys": True}}),
                 ("POST", "/index/k/field/g", {"options": {"keys": True}})]
        for m, p, b in steps:
            both(clusters, 1, m, p, b)
        for node, pql in ((0, "Set('alice', g='admin')"),
                          (1, "Set('bob', g='admin')"),
                          (2, "Set('carol', g='ops')"),
                          (port_at, "Row(g='admin')"),
                          (2 - port_at // 2, "TopN(g)")):
            both(clusters, node, "POST", "/index/k/query", pql.encode())
    finally:
        close_all(jc, mc)


def test_import_routes_to_every_owner(tmp_path):
    """An import through one node lands on exactly the owners of each
    shard (replica 2), and ``/internal/fragment/nodes`` names them."""
    pc = start_cluster(tmp_path, ["torch"] * 3, 2)
    try:
        base = pc[0].uri
        for m, p, b in load_steps("d", 5):
            assert call(base, m, p, b)[0] == 200
        for s in range(N_SHARDS):
            st, owners = call(base, "GET",
                              f"/internal/fragment/nodes?index=d&shard={s}")
            assert st == 200 and len(owners) == 2
            ids = {o["id"] for o in owners}
            for nd in pc:
                held = s in nd.holder.index("d").available_shards()
                assert held == (nd.cluster.local.id in ids), (s, ids)
        st, doc = call(base, "GET", "/internal/shards/max")
        assert doc == {"standard": {"d": N_SHARDS - 1}} or \
            doc["standard"]["d"] <= N_SHARDS - 1
        st, views = call(pc[0].uri, "GET", "/internal/views?index=d&field=t")
        assert "standard" in views["views"]
    finally:
        close_all(pc)


def test_options_shards_consumed_at_coordinator(tmp_path):
    """Options(shards=) is consumed at the coordinator: replicated
    shards count once (the JAX package's test_cluster.py:1066)."""
    pc = start_cluster(tmp_path, ["torch"] * 2, 2)
    try:
        call(pc[0].uri, "POST", "/index/oi", {})
        call(pc[0].uri, "POST", "/index/oi/field/f", {})
        sets = " ".join(f"Set({c}, f=1)" for c in (1, 2, SW + 5))
        call(pc[0].uri, "POST", "/index/oi/query", sets.encode())
        for nd in pc:
            st, res = call(nd.uri, "POST", "/index/oi/query",
                           b"Options(Count(Row(f=1)), shards=[0, 1])")
            assert res["results"] == [3], (nd.uri, res)
            st, res = call(nd.uri, "POST", "/index/oi/query",
                           b"Options(Count(Row(f=1)), shards=[0])")
            assert res["results"] == [2], (nd.uri, res)
            st, res = call(nd.uri, "POST", "/index/oi/query",
                           b"Options(Row(f=1), columnAttrs=true)")
            assert res["results"][0]["columns"] == [1, 2, SW + 5]
    finally:
        close_all(pc)


def test_max_writes_per_request(tmp_path):
    pc = start_cluster(tmp_path, ["torch"] * 2)
    try:
        call(pc[0].uri, "POST", "/index/mw", {"options": {}})
        call(pc[0].uri, "POST", "/index/mw/field/f", {"options": {}})
        pc[0].api.executor.max_writes_per_request = 3
        st, res = call(pc[0].uri, "POST", "/index/mw/query",
                       b"Set(1, f=1) Set(2, f=1) Set(3, f=1) Set(4, f=1)")
        assert st == 400 and "too many write commands" in res["error"]
        st, res = call(pc[0].uri, "POST", "/index/mw/query",
                       b"Set(1, f=1) Set(2, f=1) Set(3, f=1) "
                       b"Count(Row(f=1))")
        assert st == 200 and res["results"][3] == 3
    finally:
        close_all(pc)


def test_write_fails_when_no_replica_is_live(tmp_path):
    """Replica 1: a Set whose only owner is stopped is refused (nothing
    took the write), as the JAX package refuses it."""
    pc = start_cluster(tmp_path, ["torch"] * 2)
    try:
        call(pc[0].uri, "POST", "/index/ci", {"options": {}})
        call(pc[0].uri, "POST", "/index/ci/field/f", {"options": {}})
        c0 = pc[0].cluster
        target = next(s * SW for s in range(64)
                      if c0.shard_nodes("ci", s)[0].id != c0.local.id)
        pc[1].stop_server()
        st, res = call(pc[0].uri, "POST", "/index/ci/query",
                       f"Set({target}, f=1)".encode())
        assert st >= 400, res
    finally:
        close_all(pc)


def test_batch_query_cluster_path(tmp_path):
    pc = start_cluster(tmp_path, ["torch"] * 2)
    try:
        call(pc[0].uri, "POST", "/index/bq", {"options": {}})
        call(pc[0].uri, "POST", "/index/bq/field/f", {"options": {}})
        call(pc[0].uri, "POST", "/index/bq/query",
             f"Set(1, f=6) Set({SW + 2}, f=6)".encode())
        st, res = call(pc[0].uri, "POST", "/batch/query", {"queries": [
            {"index": "bq", "query": "Count(Row(f=6))"},
            {"index": "bq", "query": "Row(f=6)"},
            {"index": "nope", "query": "Count(Row(f=6))"},
            {"index": "bq"}]})
        out = res["responses"]
        assert out[0] == {"results": [2]}
        assert out[1]["results"][0]["columns"] == [1, SW + 2]
        assert "error" in out[2] and "error" in out[3]
        st, res = call(pc[1].uri, "POST", "/batch/query", {"queries": [
            {"index": "bq", "query": "Count(Row(f=6))"}]})
        assert res["responses"][0] == {"results": [2]}
    finally:
        close_all(pc)


def test_remote_leg_answers_only_its_shards(tmp_path):
    """``?remote=true&shards=`` runs the named shards on that node only
    (no fan-out), with the wire codec when asked for."""
    from pilosa_tpu_torch.server import wire
    pc = start_cluster(tmp_path, ["torch"] * 3, 2)
    try:
        for m, p, b in load_steps("d", 9):
            call(pc[0].uri, m, p, b)
        nd = pc[1]
        mine = nd.holder.index("d").available_shards()
        total = 0
        for s in mine:
            st, res = call(nd.uri, "POST",
                           f"/index/d/query?remote=true&shards={s}",
                           b"Count(Row(f=1))")
            total += res["results"][0]
            want = nd.api.executor.execute("d", "Count(Row(f=1))",
                                           shards=[s])[0]
            assert res["results"][0] == want
        r = urllib.request.Request(
            nd.uri + "/index/d/query?remote=true&shards="
            + ",".join(map(str, mine)),
            data=b"Count(Row(f=1)) Row(f=2)", method="POST",
            headers={"Accept": wire.CONTENT_TYPE})
        with urllib.request.urlopen(r, timeout=30) as resp:
            assert resp.headers["Content-Type"] == wire.CONTENT_TYPE
            got = wire.loads(resp.read())
        assert got["results"][0] == total
    finally:
        close_all(pc)


@pytest.mark.parametrize("seed", range(4))
def test_merge_results_match_jax(seed):
    """The coordinator's merge table on seeded per-node parts (ids past
    one digit, so ``str`` ordering of TopN ties and GroupBy groups
    differs from numeric): equal to the JAX package's for every call
    shape."""
    from pilosa_tpu.parallel.cluster_executor import \
        merge_results as jax_merge
    from pilosa_tpu.pql import parse_string as jax_parse
    from pilosa_tpu_torch.parallel.cluster_executor import merge_results
    from pilosa_tpu_torch.pql import parse_string
    rng = np.random.default_rng(seed)

    def ids(k):
        return sorted({int(x) for x in rng.integers(0, 40, k)})

    def pairs(keyed):
        out = [{"key" if keyed else "id": f"k{i}" if keyed else i,
                "count": int(rng.integers(1, 4))} for i in ids(6)]
        return sorted(out, key=lambda p: -p["count"])

    def groups():
        return [{"group": [{"field": "f", "rowID": i},
                           {"field": "g", "rowID": int(rng.integers(0, 12))}],
                 "count": int(rng.integers(1, 9))} for i in ids(5)]

    cases = [
        ("Count(Row(f=1))", lambda: int(rng.integers(0, 100))),
        ("Row(f=1)", lambda: {"columns": ids(8)}),
        ("Options(Row(f=1), shards=[1])", lambda: {"columns": ids(5)}),
        ("TopN(f, n=4)", lambda: pairs(False)),
        ("TopN(f)", lambda: pairs(False)),
        ("TopN(k, n=3)", lambda: pairs(True)),
        ("Rows(f, limit=5)", lambda: {"rows": ids(6)}),
        ("Rows(k)", lambda: {"keys": [f"k{i}" for i in ids(4)]}),
        ("GroupBy(Rows(f), Rows(g), limit=6)", groups),
        ("Sum(field=v)", lambda: {"value": int(rng.integers(-50, 50)),
                                  "count": int(rng.integers(0, 9))}),
        ("Min(field=v)", lambda: {"value": int(rng.integers(-5, 5)),
                                  "count": int(rng.integers(0, 3))}),
        ("Max(field=v)", lambda: {"value": int(rng.integers(-5, 5)),
                                  "count": int(rng.integers(0, 3))}),
        ("Set(3, f=1)", lambda: bool(rng.integers(0, 2))),
        ("ClearRow(f=1)", lambda: bool(rng.integers(0, 2))),
    ]
    for pql, part in cases:
        parts = [part() for _ in range(int(rng.integers(1, 4)))]
        parts.insert(int(rng.integers(0, len(parts))), None)
        assert merge_results(parse_string(pql).calls[0], parts) == \
            jax_merge(jax_parse(pql).calls[0], parts), (pql, parts)
