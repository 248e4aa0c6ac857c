"""The port's anti-entropy (``parallel/syncer.py`` ``HolderSyncer``,
``POST /internal/sync``) against the JAX package's, on the CPU. Each
case runs once over a JAX cluster and once over a port cluster built the
same way (the same node ids, so the same placement) and records what it
sees: the pass's merged and pushed counts, the bits and attributes each
replica holds, query answers. The records must be equal. The cases are
those of ``tests/test_cluster.py`` (a lagging replica, attributes, the
schema a peer lacks, a node paused during an import), the JAX package's
union-only merge pinned (a missed Clear comes back; an int or time
field's differing block is pushed through the field's import route),
and a mixed cluster: a port node joins a JAX cluster through a seed,
pulls its shards and converges with the JAX nodes."""

import numpy as np
import pytest

from test_torch_cluster import SW, close_all, start_cluster
from test_torch_resize import differential, held, joiner, normal, ok, \
    query


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag raised here
    must not reach a later test's sentinel."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


def u64(*xs):
    return np.array(xs, np.uint64)


def bits(nd, index, field, view="standard"):
    """{shard: sorted (row, column)} of a view on one node."""
    f = nd.holder.index(index).field(field) \
        if nd.holder.index(index) is not None else None
    v = f.view(view) if f is not None else None
    if v is None:
        return {}
    out = {}
    for shard, frag in sorted(v.fragments.items()):
        rows, cols = [], []
        for blk, _ in frag.checksum_blocks():
            r, c = frag.block_data(blk)
            rows += r.tolist()
            cols += c.tolist()
        out[shard] = sorted(zip(rows, cols))
    return out


def _lagging_replica(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 2)
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/ci", {"options": {}})
        ok(base, "POST", "/index/ci/field/f", {"options": {}})
        # Written into node 0's holder alone: a replica that missed it.
        nodes[0].holder.index("ci").field("f").import_bits(
            u64(1, 1, 2), u64(5, 6, SW + 9))
        rec = [bits(nodes[1], "ci", "f")]
        assert rec[0] == {}
        stats = ok(base, "POST", "/internal/sync")
        rec += [stats, bits(nodes[1], "ci", "f")]
        assert stats["pushed"] > 0
        assert rec[-1] == bits(nodes[0], "ci", "f")
        # A second pass finds nothing to do.
        rec.append(ok(base, "POST", "/internal/sync"))
        assert rec[-1]["merged"] == rec[-1]["pushed"] == 0
        return rec
    finally:
        close_all(nodes)


def test_anti_entropy_heals_lagging_replica(tmp_path):
    differential(tmp_path, _lagging_replica)


def _attrs(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 2)
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/ai", {"options": {}})
        ok(base, "POST", "/index/ai/field/f", {"options": {}})
        i0, i1 = (nd.holder.index("ai") for nd in nodes)
        i0.column_attr_store.set(7, {"city": "spokane"})
        i0.field("f").row_attr_store.set(3, {"label": "x"})
        i1.column_attr_store.set(7, {"zip": 99201})
        i1.column_attr_store.set(412, {"n": [1, 2]})
        rec = [ok(base, "POST", "/internal/sync")]
        assert rec[0]["attrs_pushed"] > 0 and rec[0]["attrs_merged"] > 0
        for i in (i0, i1):
            assert i.column_attr_store.get(7) == {"city": "spokane",
                                                  "zip": 99201}
            assert i.column_attr_store.get(412) == {"n": [1, 2]}
            assert i.field("f").row_attr_store.get(3) == {"label": "x"}
        # Node 1 pulls what only node 0 holds when it runs the pass.
        i0.column_attr_store.set(8, {"n": 1})
        rec.append(ok(nodes[1].uri, "POST", "/internal/sync"))
        assert i1.column_attr_store.get(8) == {"n": 1}
        rec.append([i.column_attr_store.blocks() == i1.column_attr_store
                    .blocks() for i in (i0,)])
        return rec
    finally:
        close_all(nodes)


def test_anti_entropy_syncs_attrs(tmp_path):
    differential(tmp_path, _attrs)


def _missing_schema(kind, tmp):
    if kind == "jax":
        from pilosa_tpu.core.field import FieldOptions
    else:
        from pilosa_tpu_torch.core.field import FieldOptions
    nodes = start_cluster(tmp, [kind] * 2, 2)
    try:
        # Schema and data node 1 never heard of.
        idx = nodes[0].holder.create_index("lone")
        idx.create_field("f").import_bits(u64(1), u64(3))
        idx.create_field("fp", FieldOptions(max_columns=4096,
                                            cache_size=123)) \
            .import_bits(u64(1), u64(9))
        rec = [ok(nodes[0].uri, "POST", "/internal/sync")]
        i1 = nodes[1].holder.index("lone")
        assert i1 is not None
        o = i1.field("fp").options
        rec += [bits(nodes[1], "lone", "f"), bits(nodes[1], "lone", "fp"),
                o.max_columns, o.cache_size]
        assert rec[1] == {0: [(1, 3)]} and rec[3:] == [4096, 123]
        return rec
    finally:
        close_all(nodes)


def test_sync_creates_missing_schema(tmp_path):
    differential(tmp_path, _missing_schema)


def _restart(nd, kind, port):
    from pilosa_tpu.server import serve as jax_serve
    from pilosa_tpu_torch.server import serve
    nd.server = (jax_serve if kind == "jax" else serve)(
        nd.api, "localhost", port, background=True)


def _paused_import(kind, tmp):
    nodes = start_cluster(tmp, [kind] * 2, 2)
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/pz", {"options": {}})
        ok(base, "POST", "/index/pz/field/f", {"options": {}})
        ok(base, "POST", "/index/pz/field/f/import",
           {"rowIDs": [1, 1], "columnIDs": [1, 2]})
        port = nodes[1].server.server_address[1]
        nodes[1].stop_server()
        cols = [s * SW + 9 for s in range(4)]
        ok(base, "POST", "/index/pz/field/f/import",
           {"rowIDs": [2] * 4, "columnIDs": cols})
        rec = [query(nodes[0], "pz", "Count(Row(f=2))")]
        assert rec[0] == (200, [4])
        f1 = bits(nodes[1], "pz", "f")
        assert not any(r == 2 for pairs in f1.values() for r, _ in pairs)
        _restart(nodes[1], kind, port)
        stats = ok(base, "POST", "/internal/sync")
        assert stats["pushed"] > 0
        rec += [stats, bits(nodes[1], "pz", "f"),
                query(nodes[1], "pz", "Count(Row(f=2))")]
        assert rec[-1] == (200, [4])
        assert rec[-2] == bits(nodes[0], "pz", "f")
        return rec
    finally:
        close_all(nodes)


def test_node_paused_during_import_heals_by_anti_entropy(tmp_path):
    differential(tmp_path, _paused_import)


def _union_only(kind, tmp):
    """What a union-only merge does, pinned: a Clear the stopped replica
    missed comes back from it; a differing block of an int (BSI) view
    and of a time view is pushed to the peer through the field's import
    route, which writes the rows into the field's standard view."""
    nodes = start_cluster(tmp, [kind] * 2, 2)
    try:
        base = nodes[0].uri
        ok(base, "POST", "/index/un", {"options": {}})
        for name, opts in (("f", {}), ("v", {"type": "int", "min": 0,
                                             "max": 1000}),
                           ("t", {"type": "time", "timeQuantum": "Y"})):
            ok(base, "POST", f"/index/un/field/{name}", {"options": opts})
        ok(base, "POST", "/index/un/query",
           b"Set(5, f=1) Set(6, f=1) Set(5, v=10) Set(6, v=20) "
           b"Set(5, t=1, 2019-01-02T00:00)")
        port = nodes[1].server.server_address[1]
        nodes[1].stop_server()
        ok(base, "POST", "/index/un/query", b"Clear(5, f=1)")
        rec = [query(nodes[0], "un", "Count(Row(f=1))")]
        _restart(nodes[1], kind, port)
        rec.append(ok(base, "POST", "/internal/sync"))
        rec.append(query(nodes[0], "un", "Count(Row(f=1))"))
        assert rec[0] == (200, [1]) and rec[-1] == (200, [2])
        # Each replica writes a value and a time bit the other lacks,
        # into its own holder; node 1 runs the pass.
        for nd, col, val in ((nodes[0], 7, 30), (nodes[1], 8, 40)):
            idx = nd.holder.index("un")
            idx.field("v").import_values(u64(col), np.array([val]))
            from datetime import datetime
            idx.field("t").import_bits(u64(2), u64(col),
                                       timestamps=[datetime(2019, 3, 1)])
        rec.append(ok(nodes[1].uri, "POST", "/internal/sync"))
        for nd in nodes:
            rec.append({name: sorted(nd.holder.index("un").field(name)
                                     .views)
                        for name in ("v", "t")})
            rec.append([bits(nd, "un", "v", view) for view in
                        sorted(nd.holder.index("un").field("v").views)])
            rec.append(bits(nd, "un", "t", "standard"))
        rec.append([query(nd, "un", "Sum(field=v)") for nd in nodes])
        return rec
    finally:
        close_all(nodes)


def test_union_only_merge_is_the_jax_packages(tmp_path):
    differential(tmp_path, _union_only)


def test_port_node_joins_a_jax_cluster_and_converges(tmp_path):
    """Two JAX nodes (replica 2) with data; a port node joins through a
    seed, pulls the shards it owns (the JAX nodes' fragment bytes), then
    each replica misses a write and one anti-entropy pass on every node
    converges them: every owner's block digests equal, every node
    answering as the others do."""
    jn = start_cluster(tmp_path, ["jax"] * 2, 2, prefix="j")
    pn = None
    try:
        base = jn[0].uri
        ok(base, "POST", "/index/mx", {"options": {}})
        ok(base, "POST", "/index/mx/field/f", {"options": {}})
        ok(base, "POST", "/index/mx/field/v",
           {"options": {"type": "int", "min": -50, "max": 50}})
        rng = np.random.default_rng(4)
        cols = (rng.integers(0, 8, 400) * SW
                + rng.integers(0, 5000, 400)).tolist()
        ok(base, "POST", "/index/mx/field/f/import",
           {"rowIDs": rng.integers(0, 4, 400).tolist(), "columnIDs": cols})
        ok(base, "POST", "/index/mx/field/v/import",
           {"columnIDs": cols, "values": rng.integers(-50, 50,
                                                       400).tolist()})
        pn = joiner("torch", tmp_path, "n2", replica_n=2)
        pn.api.join_via_seeds([base])
        nodes = jn + [pn]
        assert normal(nodes, 3)
        owned = [s for s in range(8) if pn.cluster.owns_shard("mx", s)]
        assert owned and set(owned) <= set(held(pn, "mx"))
        reads = ["Count(Row(f=1))", "Sum(field=v)", "Row(f=2)",
                 "Count(Row(v > 10))", "TopN(f, n=3)"]
        want = [query(jn[0], "mx", q) for q in reads]
        for nd in nodes:
            assert [query(nd, "mx", q) for q in reads] == want, nd.uri
        # Each replica misses a write (into its holder alone, in a shard
        # it owns).
        missed = []
        for i, nd in enumerate(nodes):
            s = next(s for s in range(8)
                     if nd.cluster.owns_shard("mx", s))
            missed.append(s * SW + 11 + i)
            nd.holder.index("mx").field("f").import_bits(u64(7),
                                                         u64(missed[-1]))
        for nd in nodes:
            ok(nd.uri, "POST", "/internal/sync")
        by_id = {nd.cluster.local.id: nd for nd in nodes}
        for s in range(8):
            owners = [by_id[n.id] for n in pn.cluster.shard_nodes("mx", s)]
            for fname, vname in (("f", "standard"), ("v", "bsig_v")):
                digests = [nd.holder.index("mx").field(fname).view(vname)
                           .fragment(s).checksum_blocks() for nd in owners]
                assert all(d == digests[0] for d in digests), (s, fname)
        want = [query(jn[0], "mx", q) for q in reads + ["Row(f=7)"]]
        assert want[-1][1][0]["columns"] == sorted(missed)
        for nd in nodes:
            assert [query(nd, "mx", q) for q in reads + ["Row(f=7)"]] \
                == want, nd.uri
    finally:
        close_all(jn, [pn] if pn is not None else [])


def test_resize_run_drops_unowned_and_reads_stay_exact(tmp_path):
    """After a join, ``/cluster/resize/run`` on every node leaves each
    holding exactly its placement's shards, the dropped fragments' banks
    and files gone, and every read through every node exact, in both
    packages alike."""
    def scenario(kind, tmp):
        nodes = start_cluster(tmp, [kind] * 3, 2)
        n3 = None
        try:
            base = nodes[0].uri
            ok(base, "POST", "/index/dr", {"options": {}})
            ok(base, "POST", "/index/dr/field/f", {"options": {}})
            rng = np.random.default_rng(8)
            cols = (rng.integers(0, 12, 600) * SW
                    + rng.integers(0, 3000, 600)).tolist()
            ok(base, "POST", "/index/dr/field/f/import",
               {"rowIDs": rng.integers(0, 5, 600).tolist(),
                "columnIDs": cols})
            reads = ["Count(Row(f=1))", "Row(f=4)", "TopN(f, n=2)"]
            before = [query(nodes[0], "dr", q) for q in reads]
            n3 = joiner(kind, tmp, "n3", replica_n=2)
            n3.api.join_via_seeds([base])
            allnodes = nodes + [n3]
            assert normal(allnodes, 4)
            rec = [[ok(nd.uri, "POST", "/cluster/resize/run")["removed"]
                    for nd in allnodes]]
            for nd in allnodes:
                owned = [s for s in range(12)
                         if nd.cluster.owns_shard("dr", s)]
                assert held(nd, "dr") == owned, nd.cluster.local.id
            rec.append([held(nd, "dr") for nd in allnodes])
            counts = [query(nd, "dr", reads[0]) for nd in allnodes]
            assert counts == [before[0]] * 4
            rec.append([[query(nd, "dr", q) for q in reads]
                        for nd in allnodes])
            return rec
        finally:
            close_all(nodes, [n3] if n3 is not None else [])

    differential(tmp_path, scenario)


@pytest.mark.parametrize("slow", ["_exists", "f"])
@pytest.mark.parametrize("scenario", [_union_only, _paused_import],
                         ids=["union_only", "paused_import"])
def test_sync_order_within_a_shard_is_the_jax_packages(
        tmp_path, monkeypatch, scenario, slow):
    """A pass reconciles a shard's fragments in the JAX package's order,
    whatever each peer takes to answer: with the port client's block
    digests of one field slowed, a push into the peer's field must
    still reach the peer before the comparison of its ``_exists`` that
    follows it (and not after), so both passes count what the JAX
    package's do."""
    import time

    from pilosa_tpu_torch.parallel.client import InternalClient
    real = InternalClient.fragment_blocks

    def slowed(self, uri, index, field, view, shard):
        if field == slow:
            time.sleep(0.3)
        return real(self, uri, index, field, view, shard)

    monkeypatch.setattr(InternalClient, "fragment_blocks", slowed)
    differential(tmp_path, scenario)
