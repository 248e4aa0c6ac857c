"""The port's seed join and resize (``server/api.py`` ``handle_join``,
``join_via_seeds``, the resize job, ``remove_node``,
``set_coordinator``, ``resize_abort``, ``resize_now``;
``parallel/syncer.py`` ``ResizePuller``) against the JAX package's, on
the CPU. Each case runs once over a JAX cluster and once over a port
cluster built the same way (real servers on loopback, the same node
ids, so the same placement) and records what a client sees: states,
members, the shards each node holds, query answers. The records must
be equal, and each case checks what the JAX package's own test of it
checks (``tests/test_cluster.py``: seed join, rejoin, pruning, the pull
on join, reads inside the resize window, a failed pull, overlapping
resizes, abort, remove-node, set-coordinator, the translate primary
across membership, routing mid-join, the placement change's cache
drop, concurrent imports under a join, and the puller's units)."""

import threading
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest

from test_torch_cluster import SW, ClusterNode, call, close_all, \
    start_cluster

from pilosa_tpu.parallel.cluster import Node as JaxNode

from pilosa_tpu_torch.parallel.cluster import Node

NORMAL = "NORMAL"


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag raised here
    must not reach a later test's sentinel."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


def wait_for(pred, timeout=30.0, every=0.02):
    """Poll ``pred`` until it holds; False at the deadline."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(every)
    return False


def differential(tmp_path, scenario, **kw):
    """``scenario(kind, dir)`` over a JAX cluster and a port cluster;
    their records must be equal. Returns the port's."""
    out = {}
    for kind in ("jax", "torch"):
        d = tmp_path / kind
        d.mkdir()
        out[kind] = scenario(kind, d, **kw)
    assert out["torch"] == out["jax"]
    return out["torch"]


def joiner(kind, tmp, node_id, replica_n=1, name=None):
    """A server whose cluster is itself alone, ready to join."""
    nd = ClusterNode(kind, tmp, name or f"x{node_id}")
    nd.attach([(node_id, nd.uri)], replica_n)
    return nd


def node_class(kind):
    return JaxNode if kind == "jax" else Node


def ok(base, method, path, body=None):
    st, res = call(base, method, path, body)
    assert st == 200, (path, st, res)
    return res


def query(nd, index, pql):
    """(status, answer) of one query through ``nd``."""
    st, res = call(nd.uri, "POST", f"/index/{index}/query", pql.encode())
    return st, res.get("results", res.get("error"))


def seed(base, index, n_shards, row=1, col=0):
    """An index with a set field ``f``, one bit of ``row`` a shard."""
    ok(base, "POST", f"/index/{index}", {"options": {}})
    ok(base, "POST", f"/index/{index}/field/f", {"options": {}})
    ok(base, "POST", f"/index/{index}/field/f/import",
       {"rowIDs": [row] * n_shards,
        "columnIDs": [s * SW + col for s in range(n_shards)]})


def held(nd, index):
    idx = nd.holder.index(index)
    return sorted(idx.available_shards()) if idx is not None else []


def normal(nodes, n_members):
    return wait_for(lambda: all(
        len(nd.cluster.nodes()) == n_members
        and nd.cluster.state == NORMAL for nd in nodes))


def states(nodes):
    return [ok(nd.uri, "GET", "/status")["state"] for nd in nodes]


# ------------------------------------------------------------ seed join


def _seed_join_triggers_resize(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 3, 1)
    n3 = None
    try:
        n_shards = 32
        seed(nodes[0].uri, "si", n_shards, col=3)
        n3 = joiner(kind, tmp, "n3")
        status = n3.api.join_via_seeds([nodes[0].uri])
        rec = [len(status["nodes"])]
        allnodes = nodes + [n3]
        assert normal(allnodes, 4), [(nd.cluster.state,
                                      len(nd.cluster.nodes()))
                                     for nd in allnodes]
        by_id = {nd.cluster.local.id: nd for nd in allnodes}

        def owners_hold():
            return all(s in held(by_id[o.id], "si")
                       for s in range(n_shards)
                       for o in nodes[0].cluster.shard_nodes("si", s))

        assert wait_for(owners_hold)
        rec.append([held(nd, "si") for nd in allnodes])
        answers = [query(nd, "si", "Count(Row(f=1))") for nd in allnodes]
        assert answers == [(200, [n_shards])] * 4
        rec.append(answers)
        # A rejoin is idempotent: no resize, four members, NORMAL.
        gen0 = nodes[0].cluster.resize_gen
        n3.api.join_via_seeds([nodes[0].uri])
        rec.append((nodes[0].cluster.resize_gen - gen0,
                    nodes[0].cluster.state, len(nodes[0].cluster.nodes())))
        assert rec[-1] == (0, NORMAL, 4)
        return rec
    finally:
        close_all(nodes, [n3] if n3 is not None else [])


def test_seed_join_triggers_resize(tmp_path):
    differential(tmp_path, _seed_join_triggers_resize)


def _rejoin_with_new_uri(kind, tmp):
    from pilosa_tpu.server import serve as jax_serve
    from pilosa_tpu_torch.server import serve
    nodes = start_cluster(tmp, [kind] * 2, 1)
    n2 = None
    try:
        n2 = joiner(kind, tmp, "stable-n3")
        n2.api.join_via_seeds([nodes[0].uri])
        allnodes = nodes + [n2]
        assert normal(allnodes, 3)
        # The listener restarts on a new port, same identity.
        n2.stop_server()
        n2.server = (jax_serve if kind == "jax" else serve)(
            n2.api, "localhost", 0, background=True)
        new_uri = f"http://localhost:{n2.server.server_address[1]}"
        n2.cluster.local.uri = n2.uri = new_uri
        gen0 = nodes[0].cluster.resize_gen
        status = n2.api.join_via_seeds([nodes[0].uri])
        rec = [len(status["nodes"]), nodes[0].cluster.resize_gen - gen0]
        assert rec == [3, 0]
        assert wait_for(lambda: all(
            any(n.id == "stable-n3" and n.uri == new_uri
                for n in nd.cluster.nodes()) for nd in nodes))
        rec.append([sorted(n.id for n in nd.cluster.nodes())
                    for nd in allnodes])
        return rec
    finally:
        close_all(nodes, [n2] if n2 is not None else [])


def test_rejoin_with_new_uri_updates_peers(tmp_path):
    differential(tmp_path, _rejoin_with_new_uri)


def _seed_join_prunes_stale(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 1)
    n2 = None
    try:
        n2 = joiner(kind, tmp, "stable-g")
        n2.cluster.add_node(node_class(kind)("ghost", "http://localhost:1"))
        n2.api.join_via_seeds([nodes[0].uri])
        allnodes = nodes + [n2]
        want = ["n0", "n1", "stable-g"]
        assert wait_for(lambda: all(
            sorted(n.id for n in nd.cluster.nodes()) == want
            for nd in allnodes)), [[n.id for n in nd.cluster.nodes()]
                                   for nd in allnodes]
        assert wait_for(lambda: all(nd.cluster.state == NORMAL
                                    for nd in allnodes))
        return [sorted(n.id for n in nd.cluster.nodes())
                for nd in allnodes]
    finally:
        close_all(nodes, [n2] if n2 is not None else [])


def test_seed_join_prunes_stale_members(tmp_path):
    differential(tmp_path, _seed_join_prunes_stale)


# ------------------------------------------------------- the resize job


def _resize_pull_on_join(kind, tmp):
    nodes = start_cluster(tmp, [kind], 1)
    newcomer = ClusterNode(kind, tmp, "n9")
    try:
        n_shards = 16
        seed(nodes[0].uri, "ci", n_shards)
        ok(nodes[0].uri, "POST", "/internal/join",
           {"id": "n9", "uri": newcomer.uri})
        newcomer.attach([("n0", nodes[0].uri), ("n9", newcomer.uri)], 1)
        ok(newcomer.uri, "POST", "/cluster/resize/run")
        owned = [s for s in range(n_shards)
                 if newcomer.cluster.owns_shard("ci", s)]
        assert owned and held(newcomer, "ci") == owned
        answers = [query(nd, "ci", "Count(Row(f=1))")
                   for nd in (nodes[0], newcomer)]
        assert answers == [(200, [n_shards])] * 2
        return [owned, answers]
    finally:
        close_all(nodes, [newcomer])


def test_resize_pull_on_join(tmp_path):
    differential(tmp_path, _resize_pull_on_join)


def _query_during_resize_window(kind, tmp):
    nodes = start_cluster(tmp, [kind], 1)
    base = nodes[0].uri
    seed(base, "rz", 6)
    newcomer = ClusterNode(kind, tmp, "n9")
    newcomer.attach([("n0", base), ("n9", newcomer.uri)], 1)
    try:
        # The newcomer's pull waits, so the resize window stays open.
        release, pulled = threading.Event(), threading.Event()
        orig = newcomer.api.resize_puller.pull_owned

        def slow_pull():
            release.wait(timeout=30)
            n = orig()
            pulled.set()
            return n

        newcomer.api.resize_puller.pull_owned = slow_pull
        ok(base, "POST", "/internal/join", {"id": "n9", "uri": newcomer.uri})
        rec = [ok(base, "GET", "/status")["state"],
               [s for s in range(6) if newcomer.cluster.owns_shard("rz", s)],
               held(newcomer, "rz")]
        assert rec[0] == "RESIZING" and rec[1] and rec[2] == []
        # Reads through either node see every bit; a write lands.
        rec.append([query(nd, "rz", "Count(Row(f=1))")
                    for nd in (nodes[0], newcomer)])
        assert rec[-1] == [(200, [6])] * 2
        query(nodes[0], "rz", "Set(99, f=1)")
        rec.append(query(nodes[0], "rz", "Count(Row(f=1))"))
        assert rec[-1] == (200, [7])
        release.set()
        assert pulled.wait(timeout=30)
        assert wait_for(lambda: set(states([nodes[0], newcomer]))
                        == {NORMAL})
        assert set(rec[1]) <= set(held(newcomer, "rz"))
        rec.append([query(nd, "rz", "Count(Row(f=1))")
                    for nd in (nodes[0], newcomer)])
        assert rec[-1] == [(200, [7])] * 2
        return rec
    finally:
        close_all(nodes, [newcomer])


def test_query_during_resize_window_no_undercount(tmp_path):
    differential(tmp_path, _query_during_resize_window)


def _failed_pull(kind, tmp):
    nodes = start_cluster(tmp, [kind], 1)
    base = nodes[0].uri
    seed(base, "fz", 4)
    newcomer = ClusterNode(kind, tmp, "n9")
    newcomer.attach([("n0", base), ("n9", newcomer.uri)], 1)
    try:
        def broken_pull():
            raise RuntimeError("disk full")

        newcomer.api.resize_puller.pull_owned = broken_pull
        # The job's failure handler logs "stays RESIZING": wait for it.
        handled = threading.Event()
        orig = nodes[0].api.logger.printf

        def recording(fmt, *args):
            if "stays" in fmt and "RESIZING" in fmt:
                handled.set()
            return orig(fmt, *args)

        nodes[0].api.logger.printf = recording
        ok(base, "POST", "/internal/join", {"id": "n9", "uri": newcomer.uri})
        assert handled.wait(timeout=15)
        rec = [ok(base, "GET", "/status")["state"],
               [query(nd, "fz", "Count(Row(f=1))")
                for nd in (nodes[0], newcomer)]]
        assert rec == ["RESIZING", [(200, [4])] * 2]
        res = ok(base, "POST", "/cluster/resize/abort")
        rec += [res["aborted"], res["state"],
                ok(newcomer.uri, "GET", "/status")["state"]]
        assert rec[2:] == [True, NORMAL, NORMAL]
        return rec
    finally:
        close_all(nodes, [newcomer])


def test_failed_pull_leaves_cluster_resizing(tmp_path):
    differential(tmp_path, _failed_pull)


def _overlapping_resizes(kind, tmp):
    nodes = start_cluster(tmp, [kind], 1)
    base = nodes[0].uri
    seed(base, "ov", 6)
    n1 = ClusterNode(kind, tmp, "na")
    n1.attach([("n0", base), ("na", n1.uri)], 1)
    n2 = ClusterNode(kind, tmp, "nb")
    try:
        # The first join's pull on n1 waits until released.
        release = threading.Event()
        orig = n1.api.resize_puller.pull_owned

        def slow():
            release.wait(timeout=30)
            return orig()

        n1.api.resize_puller.pull_owned = slow
        ok(base, "POST", "/internal/join", {"id": "na", "uri": n1.uri})
        rec = [ok(base, "GET", "/status")["state"]]
        n2.attach([("n0", base), ("na", n1.uri), ("nb", n2.uri)], 1)
        ok(base, "POST", "/internal/join", {"id": "nb", "uri": n2.uri})
        release.set()
        # Never NORMAL while n2 lacks a shard it owns.
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            if ok(base, "GET", "/status")["state"] == NORMAL:
                owned = [s for s in range(6)
                         if n2.cluster.owns_shard("ov", s)]
                assert set(owned) <= set(held(n2, "ov"))
            time.sleep(0.05)
        allnodes = [nodes[0], n1, n2]
        assert [query(nd, "ov", "Count(Row(f=1))") for nd in allnodes] \
            == [(200, [6])] * 3
        assert wait_for(lambda: set(states(allnodes)) == {NORMAL})
        rec.append([query(nd, "ov", "Count(Row(f=1))") for nd in allnodes])
        assert rec[-1] == [(200, [6])] * 3
        rec.append([[n.id for n in nd.cluster.nodes()] for nd in allnodes])
        return rec
    finally:
        close_all(nodes, [n1, n2])


def test_overlapping_resizes_finalize_only_latest(tmp_path):
    differential(tmp_path, _overlapping_resizes)


def _abort(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 1)
    try:
        nodes[0].cluster.begin_resize()
        rec = [ok(nodes[0].uri, "GET", "/status")["state"],
               call(nodes[0].uri, "POST", "/index/nope",
                    {"options": {}})[0]]
        res = ok(nodes[0].uri, "POST", "/cluster/resize/abort")
        rec += [res["aborted"], res["note"], res["state"],
                ok(nodes[0].uri, "POST", "/cluster/resize/abort")["aborted"]]
        assert rec[0] == "RESIZING" and rec[1] == 409
        assert rec[2] is True and rec[4] == NORMAL and rec[5] is False
        return rec
    finally:
        close_all(nodes)


def test_resize_abort_is_honest(tmp_path):
    differential(tmp_path, _abort)


def _remove_live_node(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 1)
    try:
        base = nodes[0].uri
        seed(base, "rl", 8, col=2)
        rec = [held(nodes[1], "rl")]
        assert rec[0]
        st = ok(base, "POST", "/cluster/resize/remove-node", {"id": "n1"})
        rec.append(len(st["nodes"]))
        assert wait_for(lambda: ok(base, "GET", "/status")["state"]
                        == NORMAL)
        rec += [held(nodes[0], "rl"), query(nodes[0], "rl",
                                            "Count(Row(f=1))"),
                [n.id for n in nodes[1].cluster.nodes()]]
        assert rec[1:] == [1, list(range(8)), (200, [8]), ["n1"]]
        return rec
    finally:
        close_all(nodes)


def test_remove_live_node_pulls_its_data(tmp_path):
    differential(tmp_path, _remove_live_node)


def _admin_remove_and_coordinator(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 3, 2)
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/rm", {"options": {}})
        ok(base, "POST", "/index/rm/field/f", {"options": {}})
        ok(base, "POST", "/index/rm/query", b"Set(1, f=1) Set(2, f=1)")
        owners = ok(base, "GET", "/internal/fragment/nodes?index=rm&shard=0")
        rec = [[o["id"] for o in owners]]
        st = ok(base, "POST", "/cluster/resize/set-coordinator",
                {"id": "n1"})
        rec.append([n["id"] for n in st["nodes"] if n.get("isCoordinator")])
        assert rec[-1] == ["n1"]
        st = ok(base, "POST", "/cluster/resize/remove-node", {"id": "n2"})
        rec.append(len(st["nodes"]))
        rec.append(len(ok(nodes[1].uri, "GET", "/status")["nodes"]))
        rec.append([n["id"] for n in
                    ok(nodes[2].uri, "GET", "/status")["nodes"]])
        assert rec[-3:] == [2, 2, ["n2"]]
        assert wait_for(lambda: set(states(nodes[:2])) == {NORMAL})
        rec.append(query(nodes[0], "rm", "Count(Row(f=1))"))
        assert rec[-1] == (200, [2])
        rec.append(sorted(ok(base, "POST", "/cluster/resize/abort")))
        # Unknown and self-removal answer as the JAX package's.
        rec.append(call(base, "POST", "/cluster/resize/remove-node",
                        {"id": "zz"}))
        rec.append(call(base, "POST", "/cluster/resize/remove-node",
                        {"id": "n0"}))
        rec.append(call(base, "POST", "/cluster/resize/set-coordinator",
                        {"id": "zz"}))
        return rec
    finally:
        close_all(nodes)


def test_cluster_admin_remove_node_and_coordinator(tmp_path):
    differential(tmp_path, _admin_remove_and_coordinator)


def _translate_primary_pinned(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 1)
    newcomer = ClusterNode(kind, tmp, "na")
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/ki", {"options": {"keys": True}})
        ok(base, "POST", "/index/ki/field/f", {"options": {}})
        ok(base, "POST", "/index/ki/query", b"Set('alice', f=1)")
        # An id that sorts before every other must not allocate keys.
        newcomer.attach([("n0", base), ("n1", nodes[1].uri),
                         ("aaa-first", newcomer.uri)], 1)
        ok(base, "POST", "/internal/join",
           {"id": "aaa-first", "uri": newcomer.uri})
        assert wait_for(lambda: ok(base, "GET", "/status")["state"]
                        == NORMAL)
        st = ok(base, "GET", "/status")
        rec = [st["translatePrimary"]]
        assert rec[0] in ("n0", "n1")
        ok(nodes[1].uri, "POST", "/index/ki/query", b"Set('bob', f=1)")
        r = ok(base, "POST", "/index/ki/query", b"Row(f=1)")
        rec.append(sorted(r["results"][0]["keys"]))
        assert rec[-1] == ["alice", "bob"]
        # Removing the primary promotes the node that removes it.
        primary = rec[0]
        via = nodes[1] if primary == "n0" else nodes[0]
        st2 = ok(via.uri, "POST", "/cluster/resize/remove-node",
                 {"id": primary})
        rec.append(st2["translatePrimary"])
        assert rec[-1] == via.cluster.local.id
        ok(via.uri, "POST", "/index/ki/query", b"Set('carol', f=1)")
        r = ok(via.uri, "POST", "/index/ki/query", b"Row(f=1)")
        rec.append(sorted(r["results"][0]["keys"]))
        assert rec[-1] == ["alice", "bob", "carol"]
        return rec
    finally:
        close_all(nodes, [newcomer])


def test_translate_primary_pinned_across_membership(tmp_path):
    differential(tmp_path, _translate_primary_pinned)


def _mid_join_routing(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 1)
    try:
        base = nodes[0].uri
        seed(base, "ci", 6)
        c0 = nodes[0].api.cluster
        c0.begin_resize()
        c0.add_node(node_class(kind)("zzz-unpulled-joiner",
                                     "http://127.0.0.1:1"))
        by_node, previous = c0.route_shards("ci", list(range(6)))
        rec = [previous, sorted(by_node),
               query(nodes[0], "ci", "Count(Row(f=1))"),
               query(nodes[0], "ci", "TopN(f, n=1)")]
        assert rec[0] is True and "zzz-unpulled-joiner" not in rec[1]
        assert rec[2:] == [(200, [6]), (200, [[{"id": 1, "count": 6}]])]
        return rec
    finally:
        close_all(nodes)


def test_mid_join_routing_never_targets_unpulled_joiner(tmp_path):
    differential(tmp_path, _mid_join_routing)


def _placement_change_drops_cache(kind, tmp):
    nodes = start_cluster(tmp, [kind], 1)
    try:
        seed(nodes[0].uri, "ci", 6)
        for _ in range(3):
            assert query(nodes[0], "ci", "Count(Row(f=1))") == (200, [6])
        api0 = nodes[0].api
        rc = api0.executor.result_cache
        evals = [k for k in rc._entries
                 if isinstance(k, tuple) and k and k[0] == "eval"]
        assert evals, "the eval tier never filled"
        c0 = api0.cluster
        gen0 = c0.placement_gen
        c0.begin_resize()
        c0.add_node(node_class(kind)("zzz-joiner", "http://127.0.0.1:1"))
        moved = api0._moved_shards()
        assert moved
        c0.end_resize()
        api0._note_placement_change(moved)
        left = [k for k in rc._entries
                if isinstance(k, tuple) and k and k[0] == "eval"
                and any((k[1], int(s)) in moved for s in k[3])]
        assert not left, left
        counters = api0.stats.snapshot()["counters"]
        rec = [sorted(moved), c0.placement_gen > gen0,
               rc.placement_invalidations >= 1,
               counters.get("cluster.placement_invalidations", 0) >= 1]
        assert all(rec[1:])
        return rec
    finally:
        close_all(nodes)


def test_placement_change_invalidates_cache_entries(tmp_path):
    differential(tmp_path, _placement_change_drops_cache)


def _join_under_imports(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 3, 1)
    n3 = None
    stop = threading.Event()
    imported: list = []
    errors: list = []
    uris = [nd.uri for nd in nodes]

    def writer(k):
        i = 0
        while not stop.is_set() and not errors:
            b = (i * 997 + k * 4_000_003) % (8 * SW)
            cols = [(b + j * 61) % (8 * SW) for j in range(40)]
            try:
                ok(uris[i % len(uris)], "POST", "/index/ji/field/f/import",
                   {"rowIDs": [1] * len(cols), "columnIDs": cols})
            except Exception as e:  # noqa: BLE001 (the test fails on it)
                errors.append(e)
                return
            imported.extend(cols)
            i += 1

    threads = []
    try:
        ok(uris[0], "POST", "/index/ji", {"options": {}})
        ok(uris[0], "POST", "/index/ji/field/f", {"options": {}})
        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        assert wait_for(lambda: len(imported) >= 160)
        n3 = joiner(kind, tmp, "n3")
        n3.api.join_via_seeds([uris[0]])
        allnodes = nodes + [n3]
        assert normal(allnodes, 4)
        n_after = len(imported)
        assert wait_for(lambda: len(imported) >= n_after + 160)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    try:
        assert not errors, errors
        want = len(set(imported))
        ok(uris[0], "POST", "/internal/sync")
        answers = [query(nd, "ji", "Count(Row(f=1))") for nd in allnodes]
        assert answers == [(200, [want])] * 4, (answers, want)
        return [len(answers)]
    finally:
        close_all(nodes, [n3] if n3 is not None else [])


def test_seed_join_under_concurrent_imports(tmp_path):
    differential(tmp_path, _join_under_imports)


# ------------------------------------------------------ puller units


def _pullers():
    from pilosa_tpu.parallel.syncer import ResizePuller as JaxPuller
    from pilosa_tpu_torch.parallel.syncer import ResizePuller
    return (("jax", JaxPuller), ("torch", ResizePuller))


def test_resize_puller_source_order_unit():
    """Pre-change owners first, then current owners, then any other
    holder; a placement node that does not hold the shard is
    skipped."""
    n = {i: NS(id=f"n{i}", uri=f"u{i}") for i in range(4)}

    class FC:
        def shard_nodes(self, index, shard, previous=False):
            return [n[1], n[2]] if previous else [n[2], n[3]]

    out = []
    for _, cls in _pullers():
        rp = cls(holder=None, cluster=FC(), client=NS())
        out.append(([x.id for x in rp._source_order(
                        "i", 0, [n[0], n[3], n[2], n[1]])],
                    [x.id for x in rp._source_order("i", 0, [n[0], n[3]])]))
    assert out[1] == out[0] == (["n1", "n2", "n3", "n0"], ["n3", "n0"])


def _fragment_columns(kind, frag, row):
    if kind == "jax":
        return sorted(frag.row_columns(row).tolist())
    return sorted(frag.row_offsets(row).tolist())


def test_resize_puller_regain_ownership_refreshes(tmp_path):
    """A node regaining a shard refreshes its copy from the
    authoritative owner (a replace: bits cleared while it was no owner
    do not come back); an owner of the previous epoch keeps its own."""
    from pilosa_tpu.core.holder import Holder as JaxHolder
    from pilosa_tpu_torch import Holder

    def holder(kind, name):
        if kind == "jax":
            h = JaxHolder(str(tmp_path / name))
            h.open()
            return h
        return Holder(device="cpu")

    out = []
    for kind, cls in _pullers():
        auth = holder(kind, f"auth-{kind}")
        fa = auth.create_index("ri", track_existence=False) \
            .create_field("rf")
        fa.import_bits(np.array([0, 0], np.uint64),
                       np.array([2, 3], np.uint64))
        data = fa.view().fragment(0).write_bytes()
        h = holder(kind, f"local-{kind}")
        idx = h.create_index("ri", track_existence=False)
        f = idx.create_field("rf")
        f.import_bits(np.array([0], np.uint64), np.array([1], np.uint64))

        class Client:
            def views(self, uri, index, field):
                return ["standard"]

            def retrieve_shard(self, uri, index, field, view, shard):
                return data

        class FC:
            def owns_shard(self, index, shard):
                return True

        rp = cls(h, FC(), client=Client())
        peer = NS(id="peer", uri="u-peer")
        rec = [rp._maybe_pull(peer, idx, 0, refresh=False),
               _fragment_columns(kind, f.view().fragment(0), 0),
               rp._maybe_pull(peer, idx, 0, refresh=True),
               _fragment_columns(kind, f.view().fragment(0), 0)]
        out.append(rec)
        if kind == "jax":
            auth.close()
            h.close()
    assert out[1] == out[0] == [0, [1], 1, [2, 3]]


def test_pull_owned_regain_sets_refresh(tmp_path):
    """The pass asks for a refresh exactly where this node was no owner
    of the shard before the change."""
    from pilosa_tpu.core.holder import Holder as JaxHolder
    from pilosa_tpu_torch import Holder

    local = NS(id="me", uri="u-me")
    peer = NS(id="peer", uri="u-peer")

    class Client:
        def schema(self, uri):
            return {"indexes": [{"name": "ri", "options": {},
                                 "fields": [{"name": "rf",
                                             "options": {}}],
                                 "shards": [0]}]}

    class FC:
        def __init__(self, was_owner):
            self.local = local
            self.was_owner = was_owner

        def known_nodes(self):
            return [local, peer]

        def owns_shard(self, index, shard):
            return True

        def shard_nodes(self, index, shard, previous=False):
            if previous:
                return [local, peer] if self.was_owner else [peer]
            return [local]

    out = []
    for kind, cls in _pullers():
        if kind == "jax":
            h = JaxHolder(str(tmp_path / "h"))
            h.open()
        else:
            h = Holder(device="cpu")
        h.create_index("ri").create_field("rf")
        seen = []
        for was_owner in (True, False):
            rp = cls(h, FC(was_owner), client=Client())
            rp._maybe_pull = lambda p, idx, s, refresh=False: (
                seen.append(refresh), 0)[1]
            rp.pull_owned()
        out.append(seen)
        if kind == "jax":
            h.close()
    assert out[1] == out[0] == [False, True]
