"""The port's dynamic cluster under the seeded random scripts of
``tests/test_torch_cluster.py`` against the JAX package's, on the CPU:
a three-node JAX cluster and a port cluster built the same way (replica
2, the same node ids) take the same requests through node 2 stopped
while Sets land and then healed by anti-entropy, a fourth node joining
through a seed and node 1 removed. After each change every answer
through the live nodes is the JAX cluster's, and the exact reads (no
per-leg TopN cut) through every node equal one JAX node's that took
every request."""

import pytest

from test_torch_cluster import ClusterNode, both, call, close_all, \
    load_steps, run_script, set_pql, start_cluster


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag raised here
    must not reach a later test's sentinel."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


# Reads whose cluster answer is exact (no per-leg TopN cut).
EXACT_READS = ["Count(Row(f=1))", "Row(f=2)", "Row(m=1)", "Sum(field=v)",
               "Count(Row(b=true))", "Count(Union(Row(f=0), Row(f=5)))",
               "Count(Row(t=1, from='2019-01-03T00:00', "
               "to='2019-01-20T00:00'))", "Min(field=v)"]


@pytest.mark.parametrize("seed", [0, 1])
def test_random_scripts_through_resize_match_jax(tmp_path, seed):
    """Node 2's server stops while Sets land (a union-only merge heals
    Sets, not Clears), returns on its port and every node runs an
    anti-entropy pass; n3 joins; n1 is removed."""
    from pilosa_tpu.server import serve as jax_serve
    from pilosa_tpu_torch.server import serve
    from test_torch_resize import joiner, normal, ok
    jc = start_cluster(tmp_path, ["jax"] * 3, 2, prefix="j")
    pc = start_cluster(tmp_path, ["torch"] * 3, 2, prefix="p")
    single = ClusterNode("jax", tmp_path, "single")
    clusters = [jc, pc]

    def exact(nodes):
        want = [call(single.uri, "POST", "/index/d/query", q.encode())
                for q in EXACT_READS]
        for node in nodes:
            got = both(clusters, node, "POST", "/batch/query", {
                "queries": [{"index": "d", "query": q}
                            for q in EXACT_READS]})
            assert [(200, r) for r in got[1]["responses"]] == want, node

    try:
        for i, (m, p, b) in enumerate(load_steps("d", 20 + seed)):
            both(clusters, i % 3, m, p, b)
            call(single.uri, m, p, b)
        run_script(clusters, "d", seed, steps=6, single=single)
        exact((0, 1, 2))
        ports = [c[2].server.server_address[1] for c in clusters]
        for c in clusters:
            c[2].stop_server()
        run_script(clusters, "d", 50 + seed, steps=6, nodes=(0, 1),
                   single=single, draw=set_pql)
        for c, port, srv in zip(clusters, ports, (jax_serve, serve)):
            c[2].server = srv(c[2].api, "localhost", port, background=True)
            for nd in c:
                ok(nd.uri, "POST", "/internal/sync")
        exact((0, 1, 2))
        for c, kind in zip(clusters, ("jax", "torch")):
            c.append(joiner(kind, tmp_path, "n3", replica_n=2,
                            name=f"{kind}-n3"))
            c[3].api.join_via_seeds([c[0].uri])
            assert normal(c, 4)
        run_script(clusters, "d", 70 + seed, steps=6, nodes=(0, 1, 2, 3),
                   single=single)
        exact((0, 1, 2, 3))
        for c in clusters:
            ok(c[0].uri, "POST", "/cluster/resize/remove-node",
               {"id": "n1"})
            assert normal([c[0], c[2], c[3]], 3)
        run_script(clusters, "d", 90 + seed, steps=6, nodes=(0, 2, 3),
                   single=single)
        exact((0, 2, 3))
    finally:
        close_all(jc, pc, [single])
