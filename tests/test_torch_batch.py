"""The port's batch path (``Executor.execute_batch``: staging, the fusion
collector, the plan-buffer megakernel) against the JAX package, exact
equality throughout:

- staging: the same queries over the same data (carried over with
  load_state) stage to the same signature, IR, gather slots and params;
- end to end: the ``tools/plan_fuzz`` dataset and its committed corpus
  plus a seeded slice of generated forests, through port execute_batch
  with the megakernel on and off, JAX execute_batch with its megakernel
  on, and the fuzzer's packed-numpy oracle (the port holds the sparse
  field ``s`` densely, which gives the same bits);
- semantics: write fences inside a batch, per-request parse errors,
  Threshold edges, the megakernel's fallbacks and error routing, and
  batches of ranged reads over periods with no views (plans that read
  no bank), answers and megakernel counters equal to the JAX
  package's."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.executor.results import RowResult as JaxRow
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu_torch import Executor, Holder, load_state
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.executor.executor import ExecutionError
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.ops import plan_opt
from pilosa_tpu_torch.pql import parse_string
from test_torch_executor import build_jax_index, state_from_jax
from tools.plan_fuzz import DEFAULT_CORPUS, Harness, gen_case, render_query


def answer(res):
    """A comparable form of one call result (either package)."""
    if isinstance(res, Exception):
        return ("error", type(res).__name__)
    if isinstance(res, (JaxRow,)) or hasattr(res, "columns"):
        return ("columns", np.asarray(res.columns(), np.uint64).tolist())
    if hasattr(res, "pairs"):
        return ("pairs", [tuple(p) for p in res.pairs])
    if hasattr(res, "value"):
        return ("valcount", res.value, res.count)
    if hasattr(res, "rows"):
        return ("rows", [int(r) for r in res.rows])
    return res


def answers(batch_out):
    out = []
    for item in batch_out:
        if isinstance(item, Exception):
            out.append(("error",))
        else:
            results, opts = item
            out.append([answer(r) for r in results])
    return out


@pytest.fixture
def mega_on(monkeypatch):
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)


# ------------------------------------------------------------- staging


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jh = build_jax_index(tmp_path_factory.mktemp("jax"))
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    yield jex, tex
    jh.close()


STAGED = [
    "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(g=3), Row(f=99)))", "Not(Row(f=1))",
    "Count(Difference(Row(g=3), Row(f=3)))", "Xor(Row(f=4), Row(f=5))",
    "Count(Row(v < 100))", "Row(v >= 1000)", "Row(v == 7)",
    "Row(v != 5000)", "Row(v >< [-3, 250])", "Row(v > 5000)",
    "Count(Row(big > 1099511627000))", "Row(big >< [5, 549755813888])",
    "Count(Threshold(Row(f=1), Row(g=2), Row(v > 10), k=2))",
    "Threshold(Row(f=1), Row(f=2), k=1)", "Threshold(Row(f=1), k=3)",
    "Count(Threshold(Row(f=1), Row(f=2), Row(g=1), k=3))",
    "Shift(Row(f=2), n=33)", "Count(Not(Shift(Row(g=1), n=3)))",
]


@pytest.mark.parametrize("pql", STAGED)
def test_staging_matches_jax(pair, pql):
    jex, tex = pair
    jcall, tcall = jax_parse(pql).calls[0], parse_string(pql).calls[0]
    mode = "row"
    if jcall.name == "Count":
        jcall, tcall, mode = jcall.children[0], tcall.children[0], "count"
    jidx, tidx = jex.holder.index("i"), tex.holder.index("i")
    jshards = jex._shards(jidx, jex._restrict_shards(
        jidx, jcall, jex._shards(jidx, None, pad=False)))
    tshards = tex._restrict_shards(tidx, tcall, tex._shards(tidx, None))
    assert tshards == jshards
    want = jex._stage_tree(jidx, jcall, jshards, mode)
    got = tex._stage_tree(tidx, tcall, tshards, mode)
    assert got.sig == want.sig
    assert got.ir == want.ir
    assert got.idxs == list(want.idxs)
    assert got.params == list(want.params)
    assert got.width == want.width


# ---------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def fuzz():
    h = Harness(data_seed=0)
    th = load_state(Holder(device="cpu"), state_from_jax(h.holder))
    tex = Executor(th, device="cpu")
    # Cases repeat across tests of this module: each must run (and
    # launch) the megakernel and the eager path, not the result cache.
    tex.result_cache.enabled = False
    yield h, tex
    h.close()


def _check_case(fuzz, case, monkeypatch):
    h, tex = fuzz
    reqs = [("pf", render_query(mode, tree), None) for mode, tree in case]
    want = []
    for mode, tree in case:
        exp = h.oracle.expected(mode, tree)
        want.append([exp if mode == "count"
                     else ("columns", exp["columns"])])
    monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
    jax_out = answers(h.executor.execute_batch(reqs))
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    launches = tex.mega_launches
    fallbacks = tex.mega_fallbacks
    mega_out = answers(tex.execute_batch(reqs))
    launched = tex.mega_launches - launches
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", False)
    eager_out = answers(tex.execute_batch(reqs))
    for i, q in enumerate(reqs):
        assert mega_out[i] == want[i], (i, q[1], "megakernel vs oracle")
        assert eager_out[i] == want[i], (i, q[1], "eager vs oracle")
        assert jax_out[i] == want[i], (i, q[1], "jax vs oracle")
    assert tex.mega_fallbacks == fallbacks
    return launched


_CORPUS = sorted(glob.glob(os.path.join(DEFAULT_CORPUS, "*.json")))


@pytest.mark.parametrize("path", _CORPUS, ids=os.path.basename)
def test_corpus_matches_jax_and_oracle(fuzz, path, monkeypatch):
    with open(path) as f:
        doc = json.load(f)
    assert int(doc.get("dataSeed", 0)) == 0
    assert _check_case(fuzz, doc["queries"], monkeypatch) >= 1


@pytest.mark.parametrize("index", range(10))
def test_generated_cases_match_jax_and_oracle(fuzz, index, monkeypatch):
    _check_case(fuzz, gen_case(5, index), monkeypatch)


def test_fuzz_slice_takes_the_megakernel(fuzz, monkeypatch):
    launched = sum(_check_case(fuzz, gen_case(5, i), monkeypatch)
                   for i in range(3))
    assert launched >= 1


# ----------------------------------------------------------- semantics


MIXED = [
    "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
    "Row(v > 500)", "Count(Row(v < 100))", "Count(Not(Row(g=1)))",
    "TopN(f, n=2)", "Sum(field=v)",
    "Count(Row(f=1)) Count(Union(Row(g=1), Row(g=3)))",
    "Shift(Row(f=2), n=1)", "Count(Threshold(Row(f=1), Row(g=2), "
    "Row(f=3), k=2))",
]


def test_batch_matches_jax_and_single_execute(pair, mega_on):
    jex, tex = pair
    reqs = [("i", q, None) for q in MIXED]
    launches = tex.mega_launches
    got = answers(tex.execute_batch(reqs))
    assert tex.mega_launches == launches + 1
    assert got == answers(jex.execute_batch(reqs))
    assert got == [[answer(r) for r in tex.execute("i", q)] for q in MIXED]


def test_write_in_batch_fences_like_jax(tmp_path, mega_on):
    jh = build_jax_index(tmp_path, seed=3)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    reqs = [("i", q, None) for q in (
        "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
        "Set(5, f=1) Set(6, g=2)", "Count(Row(f=1))",
        "Count(Intersect(Row(f=1), Row(g=2)))", "Clear(5, f=1)",
        "Count(Row(f=1)) Row(f=1)", "Not(Row(g=2))")]
    got = answers(tex.execute_batch(reqs))
    assert got == answers(jex.execute_batch(reqs))
    assert got[0][0] + 1 == got[3][0]
    assert got[6][0] == got[0][0]
    jh.close()


def test_clearrow_and_store_fence_like_jax(tmp_path, mega_on):
    """ClearRow and Store are writes: a batch fences on each, so the reads
    after one see it and the reads before do not, as in the JAX
    package's batch."""
    jh = build_jax_index(tmp_path, seed=7)
    th = load_state(Holder(device="cpu"), state_from_jax(jh))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    reqs = [("i", q, None) for q in (
        "Count(Row(f=1))", "Count(Row(g=2))", "Row(f=1)",
        "Store(Row(g=2), f=1)", "Count(Row(f=1))", "Row(f=1)",
        "Count(Intersect(Row(f=1), Row(g=2)))", "ClearRow(f=1)",
        "Count(Row(f=1)) Count(Row(g=2))", "Store(Row(f=9), g=2) Rows(g)",
        "Count(Row(g=2))", "TopN(f, n=3)")]
    got = answers(tex.execute_batch(reqs))
    assert got == answers(jex.execute_batch(reqs))
    assert got[4][0] == got[1][0] == got[6][0]
    assert got[8] == [0, got[1][0]]
    assert got[10] == [0]
    jh.close()


def test_parse_error_fails_only_its_request(pair, mega_on):
    jex, tex = pair
    reqs = [("i", "Count(Row(f=1))", None), ("i", "Count(Row(f=", None),
            ("i", "Count(Row(nope=1))", None), ("nope", "Row(f=1)", None),
            ("i", "Count(Row(g=2))", None)]
    got = tex.execute_batch(reqs)
    assert [isinstance(r, Exception) for r in got] == \
        [False, True, True, True, False]
    assert answers(got) == answers(jex.execute_batch(reqs))


@pytest.mark.parametrize("pql", [
    "Threshold(Row(f=1), Row(g=2), k=3)", "Threshold(Row(f=1), k=1)",
    "Threshold(Row(f=1), Row(f=2), Row(g=1), k=3)",
    "Count(Threshold(Row(f=1), Row(f=2), Row(g=1), Row(g=2), k=2))",
    "Count(Threshold(Row(f=1), Row(v > 300), Row(g=1), k=2))",
    "Threshold(Row(f=1), Row(f=2), k=1.5)", "Threshold(Row(f=1), k=0)",
    "Threshold(Row(f=1), k=true)", "Threshold(k=2)",
])
def test_threshold_edges_match_jax(pair, mega_on, pql):
    jex, tex = pair
    reqs = [("i", pql, None), ("i", "Count(Row(f=1))", None)]
    assert answers(tex.execute_batch(reqs)) == \
        answers(jex.execute_batch(reqs))
    try:
        want = [answer(r) for r in jex.execute("i", pql)]
    except Exception:
        with pytest.raises(ExecutionError):
            tex.execute("i", pql)
        return
    assert [answer(r) for r in tex.execute("i", pql)] == want


def _burst(tex):
    reqs = [("i", q, None) for q in (
        "Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
        "Row(v > 500)")]
    return reqs, [[answer(r) for r in tex.execute("i", q)]
                  for _, q, _ in reqs]


def test_lowering_surprise_falls_back_per_group(pair, mega_on, monkeypatch):
    _, tex = pair
    reqs, want = _burst(tex)

    def broken(*args, **kwargs):
        raise ValueError("lowering surprise")
    monkeypatch.setattr(mk.Lowering, "add_entry", broken)
    before = (tex.mega_launches, tex.mega_fallbacks)
    assert answers(tex.execute_batch(reqs)) == want
    assert tex.mega_launches == before[0]
    assert tex.mega_fallbacks == before[1] + 3


def test_slab_budget_falls_back_per_group(pair, mega_on, monkeypatch):
    _, tex = pair
    reqs, want = _burst(tex)
    monkeypatch.setattr(megamod, "MEGA_MAX_BYTES", 1024)
    before = (tex.mega_launches, tex.mega_budget_fallbacks)
    assert answers(tex.execute_batch(reqs)) == want
    assert tex.mega_launches == before[0]
    assert tex.mega_budget_fallbacks == before[1] + 3


def test_launch_failure_is_the_cohorts_error(pair, mega_on, monkeypatch):
    _, tex = pair
    reqs, _ = _burst(tex)

    def failed(*args, **kwargs):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(mk, "run_program", failed)
    got = tex.execute_batch(reqs + [("i", "TopN(f, n=1)", None)])
    assert [isinstance(r, RuntimeError) for r in got] == \
        [True, True, True, False]


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_verify_gate_rejects_a_bad_plan(pair, mega_on, monkeypatch, mode):
    _, tex = pair
    reqs, _ = _burst(tex)
    optimize = plan_opt.optimize_plan

    def corrupt(plan, n_shards, w_mega):
        plan, stats = optimize(plan, n_shards, w_mega)
        plan.instrs[0, 1] = 0  # writes a shared slot register
        return plan, stats
    monkeypatch.setattr(plan_opt, "optimize_plan", corrupt)
    monkeypatch.setattr(megamod, "PLAN_VERIFY_MODE", mode)
    monkeypatch.setattr(tex, "_verified_sigs", {})
    got = tex.execute_batch(reqs)
    assert all(isinstance(r, mk.PlanVerifyError) for r in got)


def test_megakernel_defaults_off_on_cpu(pair, monkeypatch):
    _, tex = pair
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", None)
    assert not megamod.enabled_for(tex)
    reqs, want = _burst(tex)
    launches = tex.mega_launches
    assert answers(tex.execute_batch(reqs)) == want
    assert tex.mega_launches == launches


def test_cpu_batch_launches_no_kernel(pair, mega_on):
    _, tex = pair
    reqs, _ = _burst(tex)
    before = dict(kernels.LAUNCHES)
    launches = tex.mega_launches
    tex.execute_batch(reqs)
    assert tex.mega_launches == launches + 1
    assert kernels.LAUNCHES == before


def test_row_results_keep_device_words(pair, mega_on):
    _, tex = pair
    (res,), _ = tex.execute_batch([("i", "Row(f=1)", None),
                                   ("i", "Count(Row(g=1))", None)])[0]
    assert isinstance(res.words, torch.Tensor)
    assert res.words.dtype == torch.int32


# ------------------------------------------------- bankless megakernel plans


EMPTY = "from='2019-01-15', to='2019-03-01'"  # no view in this period
FULL = "from='2019-06-01', to='2019-06-30'"


@pytest.fixture(scope="module")
def timed(tmp_path_factory):
    """(JAX executor, port executor) over a YMD time field ``t`` with
    bits in June 2019 only, in two shards, and a set field ``c``."""
    from datetime import datetime

    from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
    from pilosa_tpu.core.holder import Holder as JaxHolder
    from pilosa_tpu_torch import FieldOptions
    from pilosa_tpu.ops.bitset import SHARD_WIDTH
    rng = np.random.default_rng(11)
    cols = (rng.integers(0, 2, 300) * SHARD_WIDTH
            + rng.integers(0, 5000, 300)).astype(np.uint64)
    rows = rng.integers(1, 3, 300).astype(np.uint64)
    stamps = [datetime(2019, 6, 1 + int(d)) for d in rng.integers(0, 29, 300)]
    jh = JaxHolder(str(tmp_path_factory.mktemp("timed")))
    jh.open()
    th = Holder(device="cpu")
    for h, opts in ((jh, JaxFieldOptions), (th, FieldOptions)):
        idx = h.create_index("i")
        idx.create_field("t", opts(type="time", time_quantum="YMD")) \
            .import_bits(rows, cols, timestamps=stamps)
        idx.create_field("c", opts()).import_bits(rows, cols)
        idx.add_existence(cols)
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    yield jex, tex
    jh.close()


@pytest.mark.parametrize("pqls", [
    [f"Count(Row(t=1, {EMPTY}))", f"Row(t=1, {EMPTY})"],
    [f"Count(Row(t=1, {EMPTY}))", f"Count(Row(t=2, {EMPTY}))",
     f"Row(t=2, {EMPTY})"],
    [f"Options(Count(Row(t=1, {EMPTY})), shards=[1])",
     f"Options(Row(t=1, {EMPTY}), shards=[1])"],
    [f"Options(Count(Row(t=1, {EMPTY})), shards=[0, 1])",
     f"Options(Row(t=2, {EMPTY}), shards=[0])",
     f"Options(Count(Row(t=2, {EMPTY})), shards=[0])"],
    [f"Count(Row(t=1, {EMPTY}))", f"Row(t=1, {EMPTY})", "Count(Row(c=1))",
     f"Count(Row(t=2, {FULL}))"],
    [f"Options(Row(t=1, {EMPTY}), shards=[1])", "Options(Row(c=2), "
     "shards=[1])", f"Count(Intersect(Row(t=1, {EMPTY}), Row(c=1)))"],
], ids=["count-row", "two-rows", "shards", "shard-cohorts", "mixed",
        "mixed-shards"])
def test_empty_time_covers_batch_like_jax(timed, mega_on, pqls):
    """A batch of ranged reads over a period with no views, alone or
    beside reads that do hold banks, with and without ``shards=``, the
    megakernel on in both packages: the same answers, and the port's
    mega_launches and mega_queries move as the JAX package's do (a
    cohort that reads no bank counts as a launch there and here, and
    launches nothing here). The JAX package has no fallback counter and
    takes no fallback; the port's mega_fallbacks stays put."""
    jex, tex = timed
    reqs = [("i", q, None) for q in pqls]
    before = [(ex.mega_launches, ex.mega_queries) for ex in (jex, tex)]
    fallbacks, launches = tex.mega_fallbacks, dict(kernels.LAUNCHES)
    want = answers(jex.execute_batch(reqs))
    got = answers(tex.execute_batch(reqs))
    assert got == want
    assert all(a != ("error",) for a in got), got
    assert [(ex.mega_launches - b[0], ex.mega_queries - b[1])
            for ex, b in zip((jex, tex), before)] == [
        (jex.mega_launches - before[0][0],
         jex.mega_queries - before[0][1])] * 2
    assert jex.mega_launches > before[0][0]
    assert tex.mega_fallbacks == fallbacks
    assert kernels.LAUNCHES == launches
    assert got == [[answer(r) for r in tex.execute("i", q)] for q in pqls]
