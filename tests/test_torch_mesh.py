"""The port's device mesh (``parallel/mesh.py``, ``Executor(mesh=)``,
the mesh cohort launch, the mesh epilogue of ``ops/megakernel.py``)
against the JAX package's, on the CPU. Port meshes are
``MeshContext(["cpu"] * n)``; JAX meshes take the virtual CPU devices
``tests/conftest.py`` sets. The same data goes through both packages
(the port's holder is loaded from the JAX holder's state) and every
answer and counter must be equal:

- placement: ``ShardPlacement``'s padding and ``device_of`` (with the
  reference note that ``put_bank`` places contiguous blocks);
- the mesh rules of ``verify_plan`` on the same live plan, each
  rejection with the JAX package's text, and ``plan_cost``'s mesh keys;
- ``tests/test_parallel.py``'s mesh cases and ``dryrun_multichip``;
- ``tests/test_megakernel.py``'s mesh cohort cases: one launch, the
  counters (``mesh_launches``, ``mesh_collective_bytes``), the kill
  switch byte-identical, the coalesced burst;
- a cluster whose nodes each run a mesh (``API(mesh=)``);
- ``cli server``'s mesh construction."""

import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.ops import megakernel as jmk
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu.parallel import MeshContext as JaxMesh
from pilosa_tpu.parallel.mesh import ShardPlacement as JaxPlacement
from pilosa_tpu_torch import Executor, Holder, load_state
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.parallel import MeshContext, ShardPlacement
from pilosa_tpu_torch.parallel.mesh import MeshTensor
from test_torch_batch import answers
from test_torch_executor import state_from_jax

N_ROWS = 16


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: launches counted here
    must not reach a later test file's readings."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


def jax_devices(n):
    import jax
    assert len(jax.devices()) >= n
    return jax.devices()[:n]


def port_of(jh):
    return load_state(Holder(device="cpu"), state_from_jax(jh))


def norm(res):
    """A comparable form of one call's result, either package."""
    if hasattr(res, "columns"):
        return ("columns", np.asarray(res.columns(), np.uint64).tolist())
    if hasattr(res, "pairs"):
        return ("pairs", [tuple(int(x) for x in p) for p in res.pairs])
    if hasattr(res, "value"):
        return ("valcount", int(res.value), int(res.count))
    if hasattr(res, "rows"):
        return ("rows", [int(r) for r in res.rows])
    if isinstance(res, list):
        return [g.to_json() for g in res]
    return res


# ----------------------------------------------------------- placement


@pytest.mark.parametrize("n,shards,floor", [
    (4, [0, 1, 2, 3], 0), (4, [0, 1, 2, 3, 4, 5], 0), (4, [0, 2], 9),
    (4, [7, 3], 0), (2, [], 0), (4, [5], 0), (4, [0, 1, 2, 3, 7], 0),
    (5, list(range(96)), 96), (8, list(range(10)), 0)])
def test_placement_pads_as_jax(n, shards, floor):
    got = ShardPlacement(n).pad(shards, floor=floor)
    assert got == JaxPlacement(n).pad(shards, floor=floor)
    assert len(got) % n == 0 and len(set(got)) == len(got)
    for s in shards:
        assert ShardPlacement(n).device_of(shards, s) == \
            JaxPlacement(n).device_of(shards, s)


def test_device_of_is_round_robin_but_put_bank_places_blocks():
    """The reference note: ``device_of`` names ``index % n`` of the
    padded list (the JAX package's rule, kept as written) while
    ``put_bank`` puts contiguous blocks, so for 8 shards on 4 devices
    shard 1 is named device 1 but held by part 0."""
    shards = list(range(8))
    p = ShardPlacement(4)
    assert [p.device_of(shards, s) for s in shards] == \
        [0, 1, 2, 3, 0, 1, 2, 3]
    mesh = MeshContext(["cpu"] * 4)
    host = np.arange(8, dtype=np.uint32).reshape(1, 8, 1)
    bank = mesh.put_bank(host)
    held = [int(v) for part in bank.parts for v in part.flatten()]
    assert [held.index(s) // 2 for s in shards] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(part.is_contiguous() for part in bank.parts)


def test_mesh_context_axes_replicas_and_keys():
    m = MeshContext(["cpu"] * 8, replicas=2)
    assert (m.n_shard_devices, m.replicas) == (4, 2)
    assert m.shape == {"replica": 2, "shards": 4}
    j = JaxMesh(jax_devices(8), replicas=2)
    assert (j.n_shard_devices, j.replicas) == (m.n_shard_devices,
                                               m.replicas)
    with pytest.raises(ValueError) as want:
        JaxMesh(jax_devices(4), replicas=3)
    with pytest.raises(ValueError) as got:
        MeshContext(["cpu"] * 4, replicas=3)
    assert str(got.value) == str(want.value)
    assert MeshContext(["cpu"] * 4).cache_key() == \
        MeshContext(["cpu"] * 4).cache_key()
    assert MeshContext(["cpu"] * 4).cache_key() != \
        MeshContext(["cpu"] * 2).cache_key()
    assert MeshContext(["cpu"] * 8).cache_key() != m.cache_key()
    # Replica r holds a copy of every part; reads use replica 0's.
    bank = m.put_bank(np.arange(24, dtype=np.uint32).reshape(1, 8, 3))
    assert len(bank.copies) == 2 and bank.copies[0] is bank.parts
    assert all(torch.equal(a, b) for a, b in zip(*bank.copies))
    assert tuple(bank.parts[0].shape) == (1, 2, 3)


def test_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MeshContext()
    with pytest.raises(RuntimeError):
        MeshContext(["cuda:0"] * 4)
    with pytest.raises(ValueError):
        Executor(Holder(device="cpu"), device="cpu",
                 mesh=MeshContext(["cpu", "meta"]))


def test_mesh_tensor_ops_run_part_by_part():
    """Elementwise ops, index and slices off the shard axis, reshapes of
    the leading axes and the word pad stay sharded; a reduction over the
    shard axis gathers; an in-place op that does not split writes back
    into the parts."""
    rng = np.random.default_rng(0)
    host = rng.integers(0, 2**32, (5, 8, 6), dtype=np.uint32)
    full = torch.from_numpy(host.view(np.int32))
    bank = MeshContext(["cpu"] * 4).put_bank(host)
    row = bank[2]
    assert isinstance(row, MeshTensor) and row.axis == 0
    x = torch.bitwise_and(bank[1], bank[3]) | ~bank[0]
    assert isinstance(x, MeshTensor)
    assert torch.equal(x.gather(), (full[1] & full[3]) | ~full[0])
    y = full[4] & x
    assert isinstance(y, MeshTensor)
    assert torch.equal(y.gather(), full[4] & ((full[1] & full[3])
                                              | ~full[0]))
    pairs = torch.bitwise_and(bank[1:3][:, None], bank[None]).reshape(
        -1, 8, 6)
    assert isinstance(pairs, MeshTensor) and pairs.axis == 1
    assert torch.equal(pairs.gather(), (full[1:3][:, None]
                                        & full[None]).reshape(-1, 8, 6))
    padded = torch.nn.functional.pad(row, (0, 3))
    assert isinstance(padded, MeshTensor)
    assert torch.equal(padded.gather(),
                       torch.nn.functional.pad(full[2], (0, 3)))
    sel = bank.index_select(0, torch.tensor([4, 0]))
    assert isinstance(sel, MeshTensor)
    assert torch.equal(sel.gather(), full[[4, 0]])
    assert bool(torch.any(row != 0)) == bool(torch.any(full[2] != 0))
    w = row.clone()
    w[1, 2] = 7
    want = full[2].clone()
    want[1, 2] = 7
    assert torch.equal(w.gather(), want)
    assert torch.equal(kernels.bank_row_counts(bank),
                       kernels.bank_row_counts(full))


# ------------------------------------------------- mesh plan rules


@pytest.fixture(scope="module")
def live_plans(tmp_path_factory):
    """The (plan, n_shards, w_mega) of one mixed batch from each
    package's lowering, on the same data."""
    jh = JaxHolder(str(tmp_path_factory.mktemp("plan")))
    jh.open()
    idx = jh.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 8, 3000).astype(np.uint64)
    cols = rng.integers(0, 4 * SHARD_WIDTH, 3000).astype(np.uint64)
    f.import_bits(rows, cols)
    idx.add_existence(cols)
    th = port_of(jh)
    reqs = [("i", "Count(Row(f=1))", None), ("i", "Row(f=2)", None),
            ("i", "Count(Row(f=3))", None)]
    out = {}
    for kind, mod, ex in (
            ("jax", jmegamod, JaxExecutor(jh)),
            ("torch", megamod, Executor(th, device="cpu"))):
        ex.result_cache.enabled = False
        captured = []
        orig, prev = mod._build, mod.MEGAKERNEL_ENABLED

        def wrapped(cohort, orig=orig, captured=captured):
            plan, w_mega, lanes = orig(cohort)
            captured.append((plan, cohort[0].entries[0].n_shards, w_mega))
            return plan, w_mega, lanes
        mod._build, mod.MEGAKERNEL_ENABLED = wrapped, True
        try:
            ex.execute_batch_shaped(reqs)
        finally:
            mod._build, mod.MEGAKERNEL_ENABLED = orig, prev
        assert captured, kind
        out[kind] = captured[0]
    jh.close()
    return out


def _specs(m, plan):
    """The same mesh specs (and mutations) built in module ``m``."""
    epi = m.mesh_epilogue(plan)
    return {
        "canonical": m.MeshSpec("shards", "replica", 2, 1, epi),
        "uneven": m.MeshSpec("shards", "replica", 3, 1, epi),
        "no_epilogue": m.MeshSpec("shards", "replica", 2, 1, None),
        "replica_axis": m.MeshSpec("shards", "replica", 2, 2, m.Epilogue(
            ("shards", "replica"), epi.count_ops, epi.row_ops)),
        "collision": m.MeshSpec("shards", "shards", 2, 1, epi),
        "zero_devices": m.MeshSpec("shards", "replica", 0, 1, epi),
        "count_none": m.MeshSpec("shards", "replica", 2, 1, m.Epilogue(
            epi.axes, [m.EPI_NONE] * len(epi.count_ops), epi.row_ops)),
        "row_psum": m.MeshSpec("shards", "replica", 2, 1, m.Epilogue(
            epi.axes, epi.count_ops, [m.EPI_PSUM] * len(epi.row_ops))),
        "lanes": m.MeshSpec("shards", "replica", 2, 1, m.Epilogue(
            epi.axes, list(epi.count_ops) + [m.EPI_PSUM], epi.row_ops)),
    }


@pytest.mark.parametrize("case", [
    "canonical", "uneven", "no_epilogue", "replica_axis", "collision",
    "zero_devices", "count_none", "row_psum", "lanes"])
def test_verify_mesh_rejects_as_jax(live_plans, case):
    jplan, jS, jW = live_plans["jax"]
    tplan, tS, tW = live_plans["torch"]
    assert (tS, tW) == (jS, jW)
    outcome = []
    for m, plan, S, W in ((jmk, jplan, jS, jW), (mk, tplan, tS, tW)):
        try:
            m.verify_plan(plan, S, W, mesh=_specs(m, plan)[case])
            outcome.append(None)
        except m.PlanVerifyError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[1] is None) == (case == "canonical")


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_plan_cost_mesh_keys_as_jax(live_plans, n_devices):
    jplan, S, W = live_plans["jax"]
    tplan = live_plans["torch"][0]
    want = jmk.plan_cost(jplan, S, W, mesh=jmk.MeshSpec(
        "shards", "replica", n_devices, 1, jmk.mesh_epilogue(jplan)))
    got = mk.plan_cost(tplan, S, W, mesh=mk.MeshSpec(
        "shards", "replica", n_devices, 1, mk.mesh_epilogue(tplan)))
    assert got == want
    assert got["meshDevices"] == n_devices
    assert (got["collectiveBytes"] == 0) == (n_devices == 1)


# ------------------------------------------------ the parallel cases


@pytest.fixture(scope="module")
def ten_shards(tmp_path_factory):
    """10 shards (not a multiple of 8: padding), rows 0-4 of f and an
    int field n over 9 shards."""
    jh = JaxHolder(str(tmp_path_factory.mktemp("ten")))
    jh.open()
    idx = jh.create_index("i")
    f = idx.create_field("f")
    rng = np.random.default_rng(3)
    cols = rng.choice(10 * SHARD_WIDTH, size=20000,
                      replace=False).astype(np.uint64)
    f.import_bits(np.arange(20000, dtype=np.uint64) % 5, cols)
    idx.add_existence(cols)
    n = idx.create_field("n", JaxFieldOptions(type="int", min=-5,
                                              max=100))
    ncols = np.arange(0, 9 * SHARD_WIDTH, 1000, dtype=np.uint64)
    n.import_values(ncols, (np.arange(len(ncols)) % 106 - 5)
                    .astype(np.int64))
    th = port_of(jh)
    yield jh, th
    jh.close()


PARALLEL_QUERIES = [
    "Count(Row(f=0))", "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Union(Row(f=0), Row(f=1), Row(f=2)))", "Count(Not(Row(f=3)))",
    "TopN(f, n=3)", "Row(f=2)", "Count(Row(n > 50))", 'Sum(field="n")',
    'Min(field="n")', 'Max(field="n")', "TopN(f, Row(f=1), n=3)",
    "Count(Shift(Row(f=1), n=3))", "GroupBy(Rows(f), Rows(f), limit=7)",
    "Count(Xor(Row(f=1), Row(f=2)))",
]


def test_sharded_queries_match_jax(ten_shards):
    """tests/test_parallel.py's sharded query and BSI cases: the port's
    8-part mesh answers as the JAX package's 8-device mesh and as the
    unmeshed port."""
    jh, th = ten_shards
    jex = JaxExecutor(jh, mesh=JaxMesh(jax_devices(8)))
    tex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * 8))
    local = Executor(th, device="cpu")
    for ex in (jex, tex, local):
        ex.result_cache.enabled = False
    for q in PARALLEL_QUERIES:
        (want,) = jex.execute("i", q)
        (got,) = tex.execute("i", q)
        (plain,) = local.execute("i", q)
        assert norm(got) == norm(want) == norm(plain), q


def test_pad_does_not_alias_excluded_shards(tmp_path):
    """Padding a shard subset must not pull in real excluded shards."""
    out = []
    cols = (np.arange(10, dtype=np.uint64) * SHARD_WIDTH) + 7
    jh = JaxHolder(str(tmp_path))
    jh.open()
    jh.create_index("i").create_field("f").import_bits(
        np.zeros(10, np.uint64), cols)
    th = port_of(jh)
    jex = JaxExecutor(jh, mesh=JaxMesh(jax_devices(8)))
    tex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * 8))
    for ex in (jex, tex):
        out.append(ex.execute("i", "Count(Row(f=0))", shards=[0, 1]))
    assert out[0] == out[1] == [2]
    assert tex._shards(th.index("i"), [0, 1]) == \
        jex._shards(jh.index("i"), [0, 1])
    jh.close()


def test_store_does_not_create_phantom_shards(tmp_path):
    out = []
    jh = JaxHolder(str(tmp_path))
    jh.open()
    jh.create_index("i").create_field("f").import_bits(
        np.zeros(3, np.uint64),
        np.array([0, SHARD_WIDTH, 2 * SHARD_WIDTH], np.uint64))
    th = port_of(jh)
    for h, ex in ((jh, JaxExecutor(jh, mesh=JaxMesh(jax_devices(8)))),
                  (th, Executor(th, device="cpu",
                                mesh=MeshContext(["cpu"] * 8)))):
        ex.execute("i", "Store(Row(f=0), g=1)")
        out.append((h.index("i").field("g").available_shards(),
                    norm(ex.execute("i", "Row(g=1)")[0])))
    assert out[0] == out[1]
    assert out[1][0] == [0, 1, 2]
    jh.close()


def test_replicated_mesh_matches_jax(ten_shards):
    jh, th = ten_shards
    jex = JaxExecutor(jh, mesh=JaxMesh(jax_devices(8), replicas=2))
    tex = Executor(th, device="cpu",
                   mesh=MeshContext(["cpu"] * 8, replicas=2))
    for q in ("Count(Row(f=0))", "TopN(f, n=2)", 'Sum(field="n")'):
        assert norm(tex.execute("i", q)[0]) == \
            norm(jex.execute("i", q)[0]), q


def test_chunked_topn_under_mesh(tmp_path, monkeypatch):
    """The over-budget TopN stream (chunk banks) under the mesh, warm
    repeats, and a write between queries, as the JAX package answers."""
    from pilosa_tpu.executor import executor as jexec_mod
    from pilosa_tpu_torch.executor import executor as texec_mod
    jh = JaxHolder(str(tmp_path))
    jh.open()
    f = jh.create_index("ct").create_field("f")
    rng = np.random.default_rng(5)
    # The first 2^16 columns of each of 10 shards: narrow banks keep the
    # CPU's plain popcounts short.
    picks = rng.choice(10 * 65536, size=30000, replace=False)
    cols = ((picks // 65536) * SHARD_WIDTH + picks % 65536).astype(
        np.uint64)
    f.import_bits(np.arange(30000, dtype=np.uint64) % 300, cols)
    th = port_of(jh)
    for mod in (jexec_mod, texec_mod):
        monkeypatch.setattr(mod, "TOPN_MAX_BANK_BYTES", 1)
        monkeypatch.setattr(mod, "TOPN_CHUNK_ROWS", 64)
    jex = JaxExecutor(jh, mesh=JaxMesh(jax_devices(8)))
    tex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * 8))
    q = "TopN(f, Row(f=0), n=10)"
    rec = {"jax": [], "torch": []}
    for kind, ex in (("jax", jex), ("torch", tex)):
        rec[kind].append(norm(ex.execute("ct", q)[0]))
        rec[kind].append(norm(ex.execute("ct", q)[0]))
        ex.execute("ct", "Set(10000000, f=0) Set(10000000, f=1)")
        rec[kind].append(norm(ex.execute("ct", q)[0]))
    assert rec["torch"] == rec["jax"]
    assert rec["torch"][0] == rec["torch"][1] != rec["torch"][2]
    jh.close()


def test_dryrun_multichip_answers_as_jax(capsys):
    """The port's dryrun over 4 CPU parts (its own checks are the JAX
    dryrun's) and the JAX dryrun over 4 virtual devices report the same
    answers."""
    import __graft_entry__ as ge
    from pilosa_tpu_torch.parallel.dryrun import dryrun_multichip
    got = dryrun_multichip(4, "cpu")
    capsys.readouterr()
    ge.dryrun_multichip(4)
    line = capsys.readouterr().out
    assert f"Count={got['count']}," in line
    assert f"TopN={[tuple(p) for p in got['topn']]}," in line
    assert f"Sum={got['sum'][0]}/{got['sum'][1]}," in line
    assert f"GroupBy={got['groups']} groups" in line
    assert f"subset-bank Count={got['subset_count']}" in line
    assert "replica-axis mesh" in line and \
        f"Count={got['replica_count']}" in line
    assert got["mesh"] == {"shards": 4}
    assert got["replica_mesh"] == {"replica": 2, "shards": 2}


# ------------------------------------------------ the mesh cohort


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """tests/test_megakernel.py's data in both packages."""
    jh = JaxHolder(str(tmp_path_factory.mktemp("mega")))
    jh.open()
    idx = jh.create_index("i")
    f = idx.create_field("f")
    g = idx.create_field("g")
    rng = np.random.default_rng(23)
    rows = rng.integers(0, N_ROWS, 6000).astype(np.uint64)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 6000).astype(np.uint64)
    f.import_bits(rows, cols)
    g.import_bits(rows[::2], cols[::2])
    idx.create_field("v", JaxFieldOptions(type="int", min=-500,
                                          max=10000))
    vcols = rng.integers(0, 2 * SHARD_WIDTH, 900).astype(np.uint64)
    idx.field("v").import_values(
        vcols, rng.integers(-500, 10000, 900).astype(np.int64))
    idx.add_existence(cols)
    th = port_of(jh)
    yield jh, th
    jh.close()


@pytest.fixture
def mega_on(monkeypatch):
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)


MIXED = ([("i", f"Count(Row(f={r}))", None) for r in (1, 2, 3)]
         + [("i", f"Row(g={r})", None) for r in (4, 5)]
         + [("i", "Count(Intersect(Row(f=6), Row(g=7)))", None)]
         + [("i", "Count(Row(v > 300))", None)]
         + [("i", "Row(v < 9000)", None)])


def _mesh_pair(pair, n=4):
    jh, th = pair
    jex = JaxExecutor(jh, mesh=JaxMesh(jax_devices(n)))
    tex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * n))
    jex.result_cache.enabled = tex.result_cache.enabled = False
    return jex, tex


COUNTERS = ("mesh_launches", "mega_launches", "mesh_collective_bytes",
            "mega_queries")


def test_mesh_cohort_single_launch_and_counters(pair, mega_on, monkeypatch):
    """A mixed batch on a mesh executor is one mesh cohort launch, one
    ``mega_interpret`` call a part, with the JAX package's answers and
    counters (``mesh_collective_bytes`` is plan_cost's, the same plan's
    in both)."""
    jex, tex = _mesh_pair(pair)
    calls = []
    orig = kernels.mega_interpret

    def count(banks, *a, **k):
        if not any(isinstance(b, MeshTensor) for b in banks):
            calls.append(int(banks[0].shape[1]))
        return orig(banks, *a, **k)
    monkeypatch.setattr(kernels, "mega_interpret", count)
    want = answers(jex.execute_batch(MIXED))
    got = answers(tex.execute_batch(MIXED))
    assert got == want
    part = len(tex._shards(tex.holder.index("i"), None)) // 4
    assert calls == [part] * 4
    assert tex.mesh_launches == 1 and tex.plan_verify_passes >= 1
    assert {c: getattr(tex, c) for c in COUNTERS} == \
        {c: getattr(jex, c) for c in COUNTERS}
    assert tex.mesh_collective_bytes > 0
    assert answers(tex.execute_batch(MIXED)) == want
    jex.execute_batch(MIXED)
    assert tex.mesh_launches == 2
    assert {c: getattr(tex, c) for c in COUNTERS} == \
        {c: getattr(jex, c) for c in COUNTERS}


def test_mesh_kill_switch_bit_identical(pair, mega_on, monkeypatch):
    """``PILOSA_TPU_MESH=0`` (``MESH_ENABLED``): no collector under the
    mesh, no mesh launch, the same answers."""
    jh, th = pair
    direct = answers(Executor(th, device="cpu").execute_batch(MIXED))
    jex, tex = _mesh_pair(pair)
    monkeypatch.setattr(megamod, "MESH_ENABLED", False)
    monkeypatch.setattr(jmegamod, "MESH_ENABLED", False)
    assert answers(tex.execute_batch(MIXED)) == direct == \
        answers(jex.execute_batch(MIXED))
    assert (tex.mesh_launches, tex.mega_launches) == \
        (jex.mesh_launches, jex.mega_launches) == (0, 0)


def test_mesh_burst_bit_identical(pair, mega_on, monkeypatch):
    """A 32-thread mixed burst through the pipelined coalescer on a mesh
    executor answers as the unmeshed executor, with the mesh cohort on
    and off."""
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.utils.stats import MemStatsClient
    jh, th = pair
    queries = []
    for k in range(32):
        r = k % N_ROWS
        queries.append([f"Count(Row(f={r}))", f"Row(g={r})",
                        f"Count(Intersect(Row(f={r}), Row(g={r})))",
                        f"Count(Union(Row(f={r}), Row(g={r})))"][k % 4])
    plain = Executor(th, device="cpu")
    plain.result_cache.enabled = False
    direct = {i: plain.execute_full("i", q) for i, q in enumerate(queries)}

    def burst(executor):
        co = QueryCoalescer(executor, window_s=0.005, max_batch=8,
                            stats=MemStatsClient(), pipeline=True)
        co.start()
        results, errors = {}, []
        barrier = threading.Barrier(len(queries))

        def worker(i, q):
            try:
                barrier.wait()
                results[i] = co.submit("i", q)
            except Exception as e:  # noqa: BLE001
                errors.append((q, e))
        threads = [threading.Thread(target=worker, args=(i, q))
                   for i, q in enumerate(queries)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        co.stop()
        assert not errors, errors
        return results

    on_ex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * 4))
    on_ex.result_cache.enabled = False
    on = burst(on_ex)
    assert on_ex.mesh_launches >= 1
    monkeypatch.setattr(megamod, "MESH_ENABLED", False)
    off_ex = Executor(th, device="cpu", mesh=MeshContext(["cpu"] * 4))
    off_ex.result_cache.enabled = False
    off = burst(off_ex)
    assert off_ex.mesh_launches == 0
    assert on == off == direct


# ------------------------------------------------ cluster and server


def test_cluster_with_per_node_mesh_composes(tmp_path):
    """HTTP scatter-gather across two nodes, each node's executor
    running its shards over a 4-part mesh, in both packages alike."""
    from pilosa_tpu.server.api import API as JaxAPI
    from pilosa_tpu.utils.stats import MemStatsClient as JaxStats
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.utils.stats import MemStatsClient
    from test_torch_cluster import call, close_all, start_cluster

    rec = {}
    for kind in ("jax", "torch"):
        d = tmp_path / kind
        d.mkdir()
        nodes = start_cluster(d, [kind] * 2, 1)
        try:
            for nd in nodes:
                if kind == "jax":
                    nd.api = JaxAPI(nd.holder, mesh=JaxMesh(jax_devices(4)),
                                    cluster=nd.cluster, stats=JaxStats())
                else:
                    nd.api = API(nd.holder, cluster=nd.cluster,
                                 stats=MemStatsClient(),
                                 mesh=MeshContext(["cpu"] * 4))
                nd.server.RequestHandlerClass.api = nd.api
            base = nodes[0].uri
            call(base, "POST", "/index/mm", {"options": {}})
            call(base, "POST", "/index/mm/field/f", {"options": {}})
            cols = [s * SHARD_WIDTH + 3 for s in range(10)]
            call(base, "POST", "/index/mm/field/f/import",
                 {"rowIDs": [1] * 10 + [2] * 10,
                  "columnIDs": cols + [c + 1 for c in cols]})
            rec[kind] = [call(nd.uri, "POST", "/index/mm/query",
                              b"Count(Row(f=1)) Count(Intersect(Row(f=1),"
                              b" Row(f=2))) TopN(f, n=1) Row(f=2)")
                         for nd in nodes]
        finally:
            close_all(nodes)
    assert rec["torch"] == rec["jax"]
    assert rec["torch"][0][1]["results"][:2] == [10, 0]
    assert rec["torch"][0][1]["results"][2][0]["count"] == 10


def test_cli_builds_the_mesh_as_jax():
    """``cli server``'s mesh: none for ``mesh_devices = 1`` or a single
    visible device; the first ``mesh_devices`` devices of the server's
    type otherwise; ``mesh_collectives = false`` switches the cohort
    path off one way."""
    from pilosa_tpu_torch.cli.main import build_mesh, configure_planes
    from pilosa_tpu_torch.server.api import API
    from pilosa_tpu_torch.utils.config import load_config
    cpu = torch.device("cpu")
    assert build_mesh(load_config(environ={}), cpu) is None
    assert build_mesh(load_config(overrides={"mesh_devices": 1},
                                  environ={}), cpu) is None
    m = build_mesh(load_config(overrides={"mesh_devices": 4},
                               environ={}), cpu)
    assert m is not None and m.devices == [cpu]
    cfg = load_config(overrides={"mesh_collectives": False}, environ={})
    prev = megamod.MESH_ENABLED
    try:
        api = API(Holder(device="cpu"), mesh=MeshContext(["cpu"] * 2))
        configure_planes(api, cfg)
        assert megamod.MESH_ENABLED is False
        assert api.executor.mesh.n_shard_devices == 2
    finally:
        megamod.MESH_ENABLED = prev
