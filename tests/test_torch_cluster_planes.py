"""The port's static cluster off the plain read path, on the CPU: keys
translated through the primary and its log replicated (standing loop,
chained replicas, a restarted replica that must not serve a stale log),
the heartbeat, the queued broadcast, the fan-out's hardening (a failed
or wedged leg, hedged reads, down-marked nodes), the cluster documents
(``?profile=true`` fragments, ``traceparent`` from coordinator to
remote, ``/cluster/{health,hotspots,slo,timeline}`` with an unreachable
node) against the JAX package's, TLS, the topology file, and two
``cli server`` processes that name each other in ``cluster_peers``,
answering as two JAX CLI servers do. The harness is
``tests/test_torch_cluster.py``'s."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from test_torch_cluster import SW, both, call, close_all, start_cluster

from pilosa_tpu_torch.parallel.cluster import STATE_NORMAL, Cluster, Node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_rooflines():
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


def seed_bits(base, index="ci", shards=6):
    call(base, "POST", f"/index/{index}", {"options": {}})
    call(base, "POST", f"/index/{index}/field/f", {"options": {}})
    cols = [s * SW + 1 for s in range(shards)]
    st, _ = call(base, "POST", f"/index/{index}/field/f/import",
                 {"rowIDs": [1] * shards, "columnIDs": cols})
    assert st == 200


def key_tree(doc, depth=2):
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: key_tree(v, depth - 1) for k, v in doc.items()}


# ------------------------------------------------------------------ keys


def test_keyed_cluster_matches_jax(tmp_path):
    """A keyed index through the non-primary nodes: every key is
    allocated on the primary (n0), each node reads the same keys, and
    the answers equal a JAX cluster's."""
    jc = start_cluster(tmp_path, ["jax"] * 3, 2, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 3, 2, prefix="p")
    try:
        cl = [jc, pc]
        both(cl, 1, "POST", "/index/ki", {"options": {"keys": True}})
        both(cl, 2, "POST", "/index/ki/field/f", {"options": {"keys": True}})
        both(cl, 1, "POST", "/index/ki/field/v",
             {"options": {"type": "int", "min": 0, "max": 100}})
        both(cl, 2, "POST", "/index/ki/query",
             b"Set('alice', f='admin') Set('bob', f='admin') "
             b"Set('carol', f='ops')")
        both(cl, 1, "POST", "/index/ki/field/f/import",
             {"rowKeys": ["ops", "dev", "dev"],
              "columnKeys": ["dave", "erin", "alice"]})
        both(cl, 2, "POST", "/index/ki/field/v/import",
             {"columnKeys": ["alice", "frank"], "values": [7, 9]})
        for node in range(3):
            for pql in ("Row(f='admin')", "TopN(f)", "Rows(f)",
                        "Count(Row(f='dev'))", "Sum(field=v)",
                        "GroupBy(Rows(f))",
                        "Options(Row(f='ops'), columnAttrs=true)"):
                both(cl, node, "POST", "/index/ki/query", pql.encode())
        # Only the primary allocated: its store holds every key, in the
        # order they came.
        prim = pc[0].holder.index("ki").column_translator
        assert [k for k, _ in prim.entries()] == \
            ["alice", "bob", "carol", "dave", "erin", "frank"]
    finally:
        close_all(jc, pc)


def test_translate_replication_loop_and_chain(tmp_path):
    """Replicas converge on the primary's log with no read-path
    fallback: the standing loop's one pass, then the chain (each node
    pulls from its ring predecessor; a down predecessor is bypassed)."""
    from pilosa_tpu_torch.parallel.heartbeat import TranslateReplicationLoop
    pc = start_cluster(tmp_path, ["torch"] * 3)
    try:
        primary, middle, last = pc
        assert middle.api._translate_source().id == "n0"
        assert last.api._translate_source().id == "n1"
        call(primary.uri, "POST", "/index/ch", {"options": {"keys": True}})
        call(primary.uri, "POST", "/index/ch/field/f", {"options": {}})
        call(primary.uri, "POST", "/index/ch/query", b"Set('kx', f=1)")

        def has(n, key):
            st = n.holder.index("ch").column_translator
            return st.translate_key(key, create=False) is not None

        last.api._sync_translate_stores()
        assert not has(last, "kx")
        TranslateReplicationLoop(middle.api, interval=0.0).replicate_once()
        assert has(middle, "kx")
        last.api._sync_translate_stores()
        assert has(last, "kx")
        call(primary.uri, "POST", "/index/ch/query", b"Set('ky', f=1)")
        last.cluster.down_ids.add("n1")
        assert last.api._translate_source().id == "n0"
        last.api._sync_translate_stores()
        assert has(last, "ky")
        # The loop runs on its own at an interval.
        call(primary.uri, "POST", "/index/ch/query", b"Set('kz', f=1)")
        loop = TranslateReplicationLoop(middle.api, interval=0.05)
        loop.start()
        try:
            deadline = time.time() + 10
            while not has(middle, "kz"):
                assert time.time() < deadline
                time.sleep(0.02)
        finally:
            loop.stop()
    finally:
        close_all(pc)


def test_replica_serves_only_its_streamed_prefix_like_jax():
    """Store level, both packages on the same script: out-of-band
    adopted entries stay out of the served stream until the stream
    delivers them; a store that allocates serves its whole log."""
    from pilosa_tpu.core.translate import TranslateStore as JaxStore
    from pilosa_tpu_torch.core.translate import TranslateStore
    outs = []
    for T in (JaxStore, TranslateStore):
        primary = T()
        for k in ("a", "bb", "c", "dddd", "e"):
            primary.translate_key(k)
        full = primary.read_log_from(0)
        replica = T()
        two = 2 * 12 + 3
        replica.apply_log(full[:two + 5], resume=True)  # a torn third
        replica.apply_entries([("dddd", 4)])
        out = [replica.replica_offset, replica.served_limit,
               replica.read_log_from(0), replica.read_log_from(7)]
        replica.apply_log(primary.read_log_from(replica.replica_offset),
                          resume=True)
        out += [replica.read_log_from(0) == full, replica.replica_offset]
        replica.translate_key("f")
        out += [replica.served_limit, len(replica.read_log_from(0))]
        outs.append(out)
    assert outs[0] == outs[1]


def test_restarted_replica_does_not_serve_a_stale_log(tmp_path):
    pc = start_cluster(tmp_path, ["torch"] * 3)
    try:
        primary, middle, _ = pc
        call(primary.uri, "POST", "/index/rg", {"options": {"keys": True}})
        call(primary.uri, "POST", "/index/rg/field/f", {"options": {}})
        call(primary.uri, "POST", "/index/rg/query", b"Set('k1', f=1)")
        middle.api._sync_translate_stores()
        st = middle.holder.index("rg").column_translator
        assert st.served_limit == st.replica_offset > 0
        st.served_limit = None  # as after a restart
        assert middle.api.translate_data("rg") == b""
        assert st.served_limit == 0
        assert len(primary.api.translate_data("rg")) > 0
        middle.api._sync_translate_stores()
        assert len(middle.api.translate_data("rg")) > 0
        # Over HTTP, from an offset.
        req = urllib.request.Request(
            middle.uri + "/internal/translate/data?index=rg&offset=0")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.read() == middle.api.translate_data("rg")
    finally:
        close_all(pc)


def test_translate_routes_answer_like_jax(tmp_path):
    """``/internal/translate/keys`` (JSON and protobuf) and ``/ids`` on a
    single node of each package."""
    from pilosa_tpu.server import proto_compat as jpc
    jc = start_cluster(tmp_path, ["jax"], prefix="j")
    pc = start_cluster(tmp_path, ["torch"], prefix="p")
    try:
        cl = [jc, pc]
        both(cl, 0, "POST", "/index/tk", {"options": {"keys": True}})
        both(cl, 0, "POST", "/index/tk/field/f", {"options": {"keys": True}})
        both(cl, 0, "POST", "/internal/translate/keys",
             {"index": "tk", "field": None, "keys": ["x", "y", "x"]})
        both(cl, 0, "POST", "/internal/translate/keys",
             {"index": "tk", "field": "f", "keys": ["r"]})
        both(cl, 0, "POST", "/internal/translate/ids",
             {"index": "tk", "field": None, "ids": [1, 2, 9]})
        body = (jpc._str_field(1, "tk") + jpc._str_field(3, "z")
                + jpc._str_field(3, "x"))
        got = []
        for c in cl:
            r = urllib.request.Request(
                c[0].uri + "/internal/translate/keys", data=body,
                method="POST",
                headers={"Content-Type": "application/x-protobuf"})
            with urllib.request.urlopen(r, timeout=10) as resp:
                got.append((resp.headers["Content-Type"], resp.read()))
        assert got[0] == got[1]
    finally:
        close_all(jc, pc)


# ------------------------------------------------------------ liveness


def test_heartbeat_marks_down_and_recovers(tmp_path):
    """Two failed probes mark the stopped node DOWN (cluster DEGRADED,
    the node gets no query RPC, reads stay exact, the sentinel fires
    its node-down edge); one good probe marks it READY again."""
    from pilosa_tpu_torch.parallel.heartbeat import Heartbeater
    from pilosa_tpu_torch.server.http import serve
    from pilosa_tpu_torch.utils.sentinel import SENTINEL
    pc = start_cluster(tmp_path, ["torch"] * 3, 2)
    try:
        base = pc[0].uri
        seed_bits(base, "hb")
        hb = Heartbeater(pc[0].cluster, interval=0.1, suspect_after=2,
                         timeout=2.0)
        hb.probe_once()
        assert pc[0].cluster.state == STATE_NORMAL
        port = pc[2].server.server_address[1]
        pc[2].stop_server()
        hb.probe_once()
        assert pc[0].cluster.state == STATE_NORMAL  # suspect only
        hb.probe_once()
        st, doc = call(base, "GET", "/status")
        assert doc["state"] == "DEGRADED"
        assert [n["id"] for n in doc["nodes"] if n["state"] == "DOWN"] \
            == ["n2"]
        ce = pc[0].api.cluster_executor
        calls = []
        real = ce.client.query_node_full

        def counting(uri, *a, **kw):
            calls.append(uri)
            return real(uri, *a, **kw)

        ce.client.query_node_full = counting
        for _ in range(3):
            assert call(base, "POST", "/index/hb/query",
                        b"Count(Row(f=1))")[1]["results"] == [6]
        assert pc[2].uri not in calls
        pc[0].api.sample_sentinel()
        active = {a["key"] for a in SENTINEL.active_alerts()}
        assert "cluster.node_down:n2" in active
        pc[2].server = serve(pc[2].api, "localhost", port, background=True)
        hb.probe_once()
        assert pc[0].cluster.state == STATE_NORMAL
        pc[0].api.sample_sentinel()
        assert "cluster.node_down:n2" not in \
            {a["key"] for a in SENTINEL.active_alerts()}
        kinds = [e["type"] for e in pc[0].cluster.recent_events()]
        assert kinds[-2:] == ["node-down", "node-up"]
        st, health = call(base, "GET", "/internal/health")
        assert [e["type"] for e in health["clusterEvents"]][-2:] == \
            ["node-down", "node-up"]
    finally:
        close_all(pc)


def test_heartbeat_probe_load_is_bounded_like_jax():
    """At N=20 both packages' probers send at most probes_per_round
    (+1 for the down slot) a round, mark a dead peer down and back up;
    with the same random seed they probe the same peers."""
    import random
    from pilosa_tpu.parallel.cluster import Cluster as JaxCluster
    from pilosa_tpu.parallel.cluster import Node as JaxNode
    from pilosa_tpu.parallel.heartbeat import Heartbeater as JaxHB
    from pilosa_tpu.parallel.client import ClientError as JaxClientError
    from pilosa_tpu_torch.parallel.client import ClientError
    from pilosa_tpu_torch.parallel.heartbeat import Heartbeater
    traces = []
    for C, N, H, E in ((JaxCluster, JaxNode, JaxHB, JaxClientError),
                       (Cluster, Node, Heartbeater, ClientError)):
        cluster = C(N("n00", "http://h0:1"), replica_n=2)
        for i in range(1, 20):
            cluster.add_node(N(f"n{i:02d}", f"http://h{i}:1"))
        cluster.state = "NORMAL"
        hb = H(cluster, interval=0, suspect_after=3)
        probed, dead = [], set()

        class Cli:
            def status(self, uri):
                probed.append(uri)
                if uri in dead:
                    raise E("down")
                return {}

        hb.client = Cli()
        random.seed(4)
        rounds = []
        for step in range(30):
            if step == 5:
                dead.add("http://h7:1")
            if step == 25:
                dead.clear()
            hb.probe_once()
            assert hb.last_round_probes <= hb.probes_per_round + 1
            rounds.append((hb.last_round_probes, sorted(cluster.down_ids)))
        assert any("n07" in d for _, d in rounds)
        assert cluster.state == "NORMAL"
        traces.append((probed, rounds))
    assert traces[0] == traces[1]


def test_async_broadcast_retries_and_expires(tmp_path):
    """A message queued while its peer is down is delivered when it
    returns; one to a peer that never returns expires."""
    from pilosa_tpu_torch.parallel.broadcast import AsyncBroadcaster
    from pilosa_tpu_torch.server.http import serve
    pc = start_cluster(tmp_path, ["torch"])
    nd = pc[0]
    port = nd.server.server_address[1]
    bc = AsyncBroadcaster(ttl=60.0)
    dead = AsyncBroadcaster(ttl=1.0)
    bc.RETRY_BASE_S = dead.RETRY_BASE_S = 0.2
    try:
        call(nd.uri, "POST", "/index/ab", {"options": {}})
        ce = nd.api.cluster_executor
        ce._shards_cache = {"ab": (time.monotonic(), [0, 1, 2])}
        nd.stop_server()
        bc.send(nd.uri, {"type": "shards-changed", "index": "ab"})
        dead.send("http://localhost:1", {"type": "shards-changed",
                                         "index": "ab"})
        time.sleep(0.5)
        assert bc.sent == 0
        nd.server = serve(nd.api, "localhost", port, background=True)
        assert bc.flush(timeout=20.0)
        assert bc.sent == 1 and bc.expired == 0
        assert "ab" not in ce._shards_cache  # applied, not only acked
        assert dead.flush(timeout=20.0)
        assert dead.expired == 1 and dead.sent == 0
    finally:
        bc.stop()
        dead.stop()
        close_all(pc)


# ------------------------------------------------------------- hardening


def test_failed_leg_fails_over_and_down_node_is_last_resort(tmp_path):
    """A leg that raises something else than ClientError (a torn body)
    fails over to the replica with the exact answer; at replica 1 a
    down-marked node still serves the shards only it holds."""
    pc = start_cluster(tmp_path, ["torch"] * 2, 2)
    p1 = start_cluster(tmp_path, ["torch"] * 2, 1, prefix="r1")
    try:
        seed_bits(pc[0].uri)
        ce = pc[0].api.cluster_executor
        real = ce.client.query_node_full

        def torn(uri, *a, **kw):
            raise ValueError("torn response body")

        ce.client.query_node_full = torn
        assert call(pc[0].uri, "POST", "/index/ci/query",
                    b"Count(Row(f=1))")[1]["results"] == [6]
        counters = pc[0].api.stats.snapshot()["counters"]
        assert counters.get("cluster.partition_losses", 0) >= 1
        assert counters.get("cluster.failovers", 0) >= 1
        ce.client.query_node_full = real
        seed_bits(p1[0].uri)
        assert p1[0].cluster.mark_down("n1")
        assert call(p1[0].uri, "POST", "/index/ci/query",
                    b"Count(Row(f=1))")[1]["results"] == [6]
        counters = p1[0].api.stats.snapshot()["counters"]
        assert counters.get("cluster.excluded_nodes", 0) >= 1
    finally:
        close_all(pc, p1)


def test_fanout_deadline_bounds_a_wedged_peer(tmp_path):
    pc = start_cluster(tmp_path, ["torch"] * 2)
    try:
        seed_bits(pc[0].uri)
        ce = pc[0].api.cluster_executor
        ce.configure(fanout_deadline_s=0.4, backoff_base_s=0.01,
                     backoff_cap_s=0.02)

        def wedged(uri, *a, **kw):
            time.sleep(5.0)
            raise AssertionError("unreachable")

        ce.client.query_node_full = wedged
        t0 = time.monotonic()
        st, res = call(pc[0].uri, "POST", "/index/ci/query",
                       b"Count(Row(f=1))")
        assert st >= 400 and time.monotonic() - t0 < 3.0
    finally:
        close_all(pc)


def test_hedged_read_serves_from_the_replica(tmp_path):
    pc = start_cluster(tmp_path, ["torch"] * 3, 2)
    try:
        base = pc[0].uri
        c0 = pc[0].cluster
        shard = next(s for s in range(64)
                     if "n0" not in [n.id for n in c0.shard_nodes("ci", s)])
        slow_id = c0.shard_nodes("ci", shard)[0].id
        call(base, "POST", "/index/ci", {"options": {}})
        call(base, "POST", "/index/ci/field/f", {"options": {}})
        call(base, "POST", "/index/ci/field/f/import",
             {"rowIDs": [1, 1], "columnIDs": [shard * SW + 1,
                                              shard * SW + 2]})
        ce = pc[0].api.cluster_executor
        ce.configure(hedge_quantile=0.5)
        ce._leg_lat.extend([0.01] * 16)
        real = ce.client.query_node_full
        slow_uri = c0.node_by_id(slow_id).uri

        def slow_primary(uri, *a, **kw):
            if uri == slow_uri:
                time.sleep(3.0)
            return real(uri, *a, **kw)

        ce.client.query_node_full = slow_primary
        t0 = time.monotonic()
        st, res = call(base, "POST", "/index/ci/query", b"Count(Row(f=1))")
        assert res["results"] == [2]
        assert time.monotonic() - t0 < 2.5  # the hedge's, not the sleeper's
        counters = pc[0].api.stats.snapshot()["counters"]
        assert counters.get("cluster.hedged_reads", 0) >= 1
    finally:
        close_all(pc)


def test_failpoint_5xx_fails_over_exactly(tmp_path):
    from pilosa_tpu_torch.utils.failpoints import FAILPOINTS
    pc = start_cluster(tmp_path, ["torch"] * 2, 2)
    try:
        seed_bits(pc[0].uri)
        q = b"Count(Row(f=1)) Row(f=1)"
        want = call(pc[0].uri, "POST", "/index/ci/query", q)[1]
        port1 = pc[1].uri.rsplit(":", 1)[1]
        FAILPOINTS.arm("client.5xx", f"partition(:{port1})")
        for _ in range(3):
            assert call(pc[0].uri, "POST", "/index/ci/query", q)[1] == want
        assert FAILPOINTS.snapshot()["sites"]["client.5xx"]["hits"] > 0
    finally:
        FAILPOINTS.disarm_all()
        close_all(pc)


def test_write_then_read_is_fresh_on_every_node(tmp_path):
    """A write through one node is read back through every node at
    once, with the result caches on: no node serves its pre-write
    answer, and a new shard shows in every coordinator's shard list."""
    pc = start_cluster(tmp_path, ["torch"] * 3, 2)
    try:
        seed_bits(pc[0].uri)
        q = b"Count(Row(f=1)) Count(Row(f=2))"
        for nd in pc:
            for _ in range(2):
                assert call(nd.uri, "POST", "/index/ci/query",
                            q)[1]["results"] == [6, 0]
        for i, col in enumerate((3, SW + 3, 9 * SW + 3)):
            call(pc[i % 3].uri, "POST", "/index/ci/query",
                 f"Set({col}, f=2)".encode())
            for nd in pc:
                assert call(nd.uri, "POST", "/index/ci/query",
                            q)[1]["results"] == [6, i + 1], (i, nd.uri)
        call(pc[1].uri, "POST", "/index/ci/field/f/import",
             {"rowIDs": [1], "columnIDs": [11 * SW]})
        for nd in pc:
            assert call(nd.uri, "POST", "/index/ci/query",
                        q)[1]["results"] == [7, 3]
    finally:
        close_all(pc)


# ---------------------------------------------------------- documents


def test_cluster_documents_match_jax(tmp_path):
    """``?profile=true`` carries the remote nodes' fragments, the
    client's ``traceparent`` stamps the remote leg, and /cluster/health,
    /cluster/hotspots, /cluster/slo, /cluster/timeline and
    /cluster/timeline/{trace} have the JAX cluster's shape and counts,
    also with a node's server stopped."""
    from pilosa_tpu.utils.timeline import TIMELINE as JAX_TIMELINE
    from pilosa_tpu.utils.tracing import RecordingTracer as JaxTracer
    from pilosa_tpu_torch.utils.timeline import TIMELINE
    from pilosa_tpu_torch.utils.tracing import RecordingTracer
    jc = start_cluster(tmp_path, ["jax"] * 3, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 3, prefix="p")
    try:
        JAX_TIMELINE.reset()
        TIMELINE.reset()
        for c, T in ((jc, JaxTracer), (pc, RecordingTracer)):
            for nd in c:
                rt = T()
                nd.api.tracer = rt
                nd.api._client.tracer = rt
                nd.api.profiler.tracer = rt
            seed_bits(c[0].uri)
        prof = [call(c[0].uri, "POST", "/index/ci/query?profile=true",
                     b"Count(Row(f=1))")[1] for c in (jc, pc)]
        assert prof[0]["results"] == prof[1]["results"] == [6]
        assert set(prof[1]["profile"]["nodes"]) == \
            set(prof[0]["profile"]["nodes"]) == {"n1", "n2"}
        for frag in prof[1]["profile"]["nodes"].values():
            assert frag["ops"] and frag["ops"][0]["name"] == "Count"
        trace_id = "e1" * 16
        for c in (jc, pc):
            st, res = call(c[0].uri, "POST", "/index/ci/query",
                           b"Count(Row(f=1))",
                           headers={"traceparent":
                                    f"00-{trace_id}-{'ab' * 8}-01"})
            assert res["results"] == [6]
            remote = [s for s in c[1].api.tracer.finished
                      if s.trace_id == trace_id]
            assert remote
        docs = {}
        for path in ("/cluster/health", "/cluster/hotspots", "/cluster/slo",
                     "/cluster/timeline", f"/cluster/timeline/{trace_id}"):
            docs[path] = [call(c[0].uri, "GET", path) for c in (jc, pc)]
        for c in (jc, pc):
            c[2].stop_server()
            c[0].api._client.drop_idle()
        for path in ("/cluster/health", "/cluster/hotspots", "/cluster/slo",
                     f"/cluster/timeline/{trace_id}"):
            docs[path + " down"] = [call(c[0].uri, "GET", path)
                                    for c in (jc, pc)]
        for path, ((js, j), (ps, p)) in docs.items():
            assert js == ps == 200, path
            assert key_tree(p, 1) == key_tree(j, 1), path
            for k in ("totalNodes", "healthyNodes", "respondedNodes",
                      "state", "coordinator", "traceId"):
                assert p.get(k) == j.get(k), (path, k)
            assert [n["id"] for n in p.get("nodes", [])] == \
                [n["id"] for n in j.get("nodes", [])], path
            assert [n["healthy"] for n in p.get("nodes", [])] == \
                [n["healthy"] for n in j.get("nodes", [])], path
            assert [("error" in n) for n in p.get("nodes", [])] == \
                [("error" in n) for n in j.get("nodes", [])], path
        j, p = docs["/cluster/health"][0][1], docs["/cluster/health"][1][1]
        for jn, pn in zip(j["nodes"], p["nodes"]):
            assert set(pn) == set(jn)
        tl = docs[f"/cluster/timeline/{trace_id}"][1][1]
        xs = [e for e in tl["traceEvents"] if e["ph"] == "X"]
        assert {e["args"]["node"] for e in xs} == {"n0", "n1", "n2"}
        assert {e["pid"] for e in xs} == {0, 1, 2}
        assert all(e["args"]["trace"] == trace_id for e in xs)
        assert any(e["name"].startswith("remote:") for e in xs
                   if e["pid"] == 0)
    finally:
        JAX_TIMELINE.reset()
        TIMELINE.reset()
        close_all(jc, pc)


def _no_uris(doc):
    """A status document without its nodes' URIs (each cluster's own
    ports), for comparing two clusters."""
    if isinstance(doc, dict):
        return {k: _no_uris(v) for k, v in doc.items() if k != "uri"}
    if isinstance(doc, list):
        return [_no_uris(v) for v in doc]
    return doc


def test_schema_broadcast_and_resize_refusals(tmp_path):
    """A schema change through one node reaches every node (a remote
    create that already exists reads as success); the membership and
    resize messages and routes, which the port refused before it had the
    dynamic cluster, answer as the JAX cluster's; status and
    /internal/nodes answer as the JAX cluster's."""
    jc = start_cluster(tmp_path, ["jax"] * 2, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 2, prefix="p")
    try:
        cl = [jc, pc]
        both(cl, 1, "POST", "/index/sb", {"options": {"keys": False}})
        both(cl, 0, "POST", "/index/sb/field/t",
             {"options": {"type": "time", "timeQuantum": "YM"}})
        for node in (0, 1):
            both(cl, node, "GET", "/schema")
            both(cl, node, "GET", "/internal/local-shards")
        both(cl, 0, "POST", "/index/sb?remote=true", {"options": {}})
        st = [call(c[0].uri, "GET", "/status")[1] for c in cl]
        assert [n["id"] for n in st[0]["nodes"]] == \
            [n["id"] for n in st[1]["nodes"]]
        assert st[1]["state"] == "NORMAL" and st[1]["localID"] == "n0"
        assert st[1]["translatePrimary"] == "n0"
        assert call(pc[0].uri, "GET", "/internal/nodes")[1] == st[1]["nodes"]
        # The membership messages: a node joins (RESIZING), leaves, the
        # resize completes; each state as the JAX node's.
        prev = [{"id": "n0", "uri": "u0"}, {"id": "n1", "uri": "u1"}]
        for msg in ({"type": "node-join", "node": {"id": "x", "uri": "y"},
                     "prev": prev},
                    {"type": "node-leave", "nodeID": "x", "prev": prev},
                    {"type": "resize-complete"},
                    {"type": "set-coordinator", "nodeID": "n1"},
                    {"type": "shards-changed", "index": "sb"}):
            got = [call(c[0].uri, "POST", "/internal/cluster/message",
                        msg) for c in cl]
            assert got[0] == got[1] and got[1][0] == 200, (msg, got)
            st = [_no_uris(call(c[0].uri, "GET", "/status")[1])
                  for c in cl]
            assert st[0] == st[1], (msg, st)
        both(cl, 0, "POST", "/index/sb/query",
             b"Set(1, t=2, 2019-02-03T00:00) Set(70, t=2, 2019-02-03T00:00)")
        # The routes of seed join, resize and anti-entropy.
        shard0 = "index=sb&field=t&view=standard&shard=0"
        for method, path, body in (
                ("POST", "/internal/sync", None),
                ("POST", "/internal/resize/pull", None),
                ("GET", f"/internal/fragment/blocks?{shard0}", None),
                ("GET", f"/internal/fragment/block/data?{shard0}&block=0",
                 None),
                ("GET", "/internal/fragment/blocks?index=sb&field=t&shard=7",
                 None),
                ("GET", "/internal/attr/blocks?index=sb", None),
                ("POST", "/internal/attr/merge?index=sb",
                 {"attrs": {"1": {"a": 1}}}),
                ("POST", "/internal/sync", None),
                ("GET", "/internal/attr/blocks?index=sb", None),
                ("POST", "/cluster/resize/remove-node", {"id": "zz"}),
                ("POST", "/cluster/resize/run", None)):
            both(cl, 0, method, path, body)
            both(cl, 1, method, path, body)
        data = [urllib.request.urlopen(
            f"{c[1].uri}/internal/fragment/data?{shard0}").read()
            for c in cl]
        assert data[0] == data[1]
        for path, body in (("/cluster/resize/abort", None),
                           ("/cluster/resize/set-coordinator",
                            {"id": "n0"})):
            got = [call(c[1].uri, "POST", path, body) for c in cl]
            assert _no_uris(list(got[0])) == _no_uris(list(got[1])), \
                (path, got)
    finally:
        close_all(jc, pc)


# ------------------------------------------------------ TLS and topology


def _self_signed_cert(tmp_path):
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost"),
                 x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .sign(key, hashes.SHA256()))
    cert_path, key_path = tmp_path / "node.crt", tmp_path / "node.key"
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(cert_path), str(key_path)


def test_cluster_over_tls(tmp_path):
    """Three port nodes over HTTPS, verified against the self-signed
    certificate as CA (no skip-verify): schema broadcast, import fan-out
    and query legs cross TLS; a client that does not trust the CA is
    refused by the handshake."""
    pytest.importorskip("cryptography")
    import ssl
    from pilosa_tpu_torch.utils.config import Config
    cert, key = _self_signed_cert(tmp_path)
    cfg = Config(tls_certificate=cert, tls_key=key, tls_ca_certificate=cert)
    cfg.validate()
    assert cfg.scheme == "https"
    pc = start_cluster(tmp_path, ["torch"] * 3, 2,
                       server_ssl=cfg.server_ssl_context(),
                       client_ssl=cfg.client_ssl_context())
    ctx = cfg.client_ssl_context()
    try:
        base = pc[0].uri
        assert base.startswith("https://")
        call(base, "POST", "/index/ti", {"options": {}}, ssl_ctx=ctx)
        call(base, "POST", "/index/ti/field/f", {"options": {}}, ssl_ctx=ctx)
        for nd in pc:
            doc = call(nd.uri, "GET", "/schema", ssl_ctx=ctx)[1]
            assert doc["indexes"][0]["name"] == "ti"
        cols = [s * SW + 1 for s in range(6)]
        call(base, "POST", "/index/ti/field/f/import",
             {"rowIDs": [1] * 6, "columnIDs": cols}, ssl_ctx=ctx)
        placed = [len(nd.holder.index("ti").available_shards()) for nd in pc]
        assert sum(placed) == 12
        for nd in pc:
            res = call(nd.uri, "POST", "/index/ti/query",
                       b"Count(Row(f=1)) TopN(f)", ssl_ctx=ctx)[1]
            assert res["results"] == [6, [{"id": 1, "count": 6}]]
        with pytest.raises((ssl.SSLError, urllib.error.URLError)):
            call(base, "GET", "/schema")
    finally:
        close_all(pc)


def test_topology_file_round_trips_and_memory_holder_writes_none(tmp_path):
    """``save``/``load`` keep the topology in ``.topology`` as the JAX
    package writes it; with no path (a holder in memory) they do
    nothing and do not fail."""
    from pilosa_tpu.parallel.cluster import Cluster as JaxCluster
    from pilosa_tpu.parallel.cluster import Node as JaxNode
    docs = []
    for C, N, name in ((JaxCluster, JaxNode, "j"), (Cluster, Node, "p")):
        path = str(tmp_path / f"{name}.topology")
        c = C(N("a", "http://a:1"), replica_n=2, topology_path=path)
        c.add_node(N("b", "http://b:1"))
        c.pin_translate_primary("b")
        docs.append(json.load(open(path)))
        c2 = C(N("a", "http://a:1"), topology_path=path)
        c2.load()
        assert [n.id for n in c2.nodes()] == ["a", "b"]
        assert c2.replica_n == 2 and c2.translate_primary().id == "b"
    assert docs[0] == docs[1]
    mem = Cluster(Node("a", "http://a:1"), topology_path=None)
    mem.add_node(Node("b", "http://b:1"))
    mem.save()
    mem.load()
    assert [n.id for n in mem.nodes()] == ["a", "b"]
    assert sorted(os.listdir(tmp_path)) == ["j.topology", "p.topology"]


def test_tls_config_validation_matches_jax():
    from pilosa_tpu.utils.config import Config as JaxConfig
    from pilosa_tpu_torch.utils.config import Config
    for C in (JaxConfig, Config):
        with pytest.raises(ValueError, match="set together"):
            C(tls_certificate="x.pem").validate()
        with pytest.raises(ValueError, match="set together"):
            C(tls_key="x.pem").validate()
        cfg = C(tls_skip_verify=True)
        assert cfg.scheme == "http" and not cfg.tls_enabled
        ctx = cfg.client_ssl_context()
        assert ctx is not None and not ctx.check_hostname
        assert C().client_ssl_context() is None
        assert C().server_ssl_context() is None


# ----------------------------------------------------------------- CLI


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _start(module, toml, extra=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PILOSA_TPU_")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-m", module, "server", "-c", str(toml), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_up(base, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            with urllib.request.urlopen(base + "/status", timeout=2):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"{base} did not come up")


def test_cli_servers_form_a_cluster_like_jax(tmp_path):
    """Two ``cli server -c cluster.toml`` processes that name each other
    in ``cluster_peers`` (replica 2, heartbeat on): an import through
    the coordinator lands on both, and a Count and a TopN through each
    node answer as two JAX CLI servers do; SIGTERM stops each with 0."""
    import signal
    procs, bases = {}, {}
    for kind, module in (("jax", "pilosa_tpu.cli"),
                         ("torch", "pilosa_tpu_torch.cli")):
        ports = _free_ports(2)
        uris = [f"http://127.0.0.1:{p}" for p in ports]
        peers = ", ".join(f'"{u}"' for u in uris)
        for i, p in enumerate(ports):
            toml = tmp_path / f"{kind}{i}.toml"
            body = (f'bind = "127.0.0.1:{p}"\n'
                    f"cluster_peers = [{peers}]\ncluster_replicas = 2\n"
                    "heartbeat_interval = 0.5\n"
                    "translate_replication_interval = 0.5\n")
            extra = ["--device", "cpu"] if kind == "torch" else \
                ["-d", str(tmp_path / f"jd{i}")]
            toml.write_text(body)
            procs[(kind, i)] = _start(module, toml, extra)
        bases[kind] = uris
    try:
        for (kind, i), proc in procs.items():
            _wait_up(bases[kind][i], proc)
        cols = [s * SW + c for s in range(4) for c in (1, 5, 9)]
        rows = [c % 3 for c in range(len(cols))]
        answers = {}
        for kind, uris in bases.items():
            base = uris[0]
            assert call(base, "POST", "/index/cl", {"options": {}})[0] == 200
            assert call(base, "POST", "/index/cl/field/f",
                        {"options": {}})[0] == 200
            assert call(base, "POST", "/index/cl/field/f/import",
                        {"rowIDs": rows, "columnIDs": cols})[0] == 200
            answers[kind] = [
                call(u, "POST", "/index/cl/query",
                     b"Count(Row(f=1)) TopN(f, n=2)")[1] for u in uris]
            st, status = call(uris[1], "GET", "/status")
            assert len(status["nodes"]) == 2
        assert answers["torch"] == answers["jax"]
        assert answers["torch"][0]["results"][0] == rows.count(1)
    finally:
        for proc in procs.values():
            proc.send_signal(signal.SIGTERM)
        for (kind, i), proc in procs.items():
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            if kind == "torch":
                assert rc == 0, proc.stdout.read()
