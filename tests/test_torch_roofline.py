"""The port's roofline plane against the JAX package's: ``plan_cost``
(``pilosa_tpu_torch/ops/megakernel.py``) gives the JAX package's dict for
the same plan (hand-built plans of every opcode, the verifier's synthetic
plans, seeded random plans with expand registers, and the plans the
committed ``tests/plan_corpus/`` batches lower to in both packages);
``predict_cost_bytes`` and ``OptStats.predicted_bytes`` agree; the
recorder (``utils/roofline.py``) counts the same launches, bytes by kind
and opcodes after the same bursts, and its drift detector, LRU bound and
sample-rate scaling behave as the JAX recorder's; the card's roofline
table; and the unsampled path takes no fence."""

import json
import os
from collections import OrderedDict

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.ops import megakernel as jmk
from pilosa_tpu.ops import plan_opt as jplan_opt
from pilosa_tpu.utils import roofline as jroofline
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.ops import plan_opt
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.utils import benchenv
from pilosa_tpu_torch.utils.memledger import MemoryLedger
from pilosa_tpu_torch.utils.profile import QueryProfile
from pilosa_tpu_torch.utils.roofline import (
    DRIFT_MARGIN, ROOFLINE, RooflineRecorder,
)
from pilosa_tpu_torch.utils.stats import MemStatsClient, prometheus_text
from tools.plan_fuzz import BSI_FIELDS, DEFAULT_CORPUS, N_ROWS, \
    render_query
from tools.planverify import synthetic_plans

DEFAULTS = dict(enabled=True, gbps=0.0, ewma_alpha=0.25, max_cohorts=256)


@pytest.fixture(autouse=True)
def _reset_roofline():
    for rec in (ROOFLINE, jroofline.ROOFLINE):
        rec.reset()
        rec.configure(**DEFAULTS)
        rec.note_sample_every(0)
    yield
    for rec in (ROOFLINE, jroofline.ROOFLINE):
        rec.reset()
        rec.configure(**DEFAULTS)
        rec.note_sample_every(0)


@pytest.fixture
def no_densities(monkeypatch):
    """Both optimizers sort by the densities their banks report; the two
    packages sample them alike but not from one stream, so the plans
    compare with every density at its default."""
    monkeypatch.setattr(jplan_opt, "_density", OrderedDict())
    monkeypatch.setattr(plan_opt, "_density", OrderedDict())
    monkeypatch.setattr(jplan_opt, "note_bank_density", lambda *a: None)
    monkeypatch.setattr(plan_opt, "note_bank_density", lambda *a: None)


def _to_port(plan):
    return mk.Plan(banks=plan.banks, slots=plan.slots, widths=plan.widths,
                   instrs=plan.instrs, out_count=plan.out_count,
                   out_row=plan.out_row, n_slots=plan.n_slots,
                   n_regs=plan.n_regs, n_instrs=plan.n_instrs,
                   lane_count_widths=plan.lane_count_widths,
                   lane_row_widths=plan.lane_row_widths,
                   xbanks=plan.xbanks, xslots=plan.xslots,
                   n_xslots=plan.n_xslots)


# --------------------------------------------------- plan_cost arithmetic


def _hand_plan(module, *, n_slots, widths, instrs, n_instrs, n_regs,
               out_count, out_row, lane_count_widths=(),
               lane_row_widths=(), slots=None, xbanks=(), xslots=(),
               n_xslots=0):
    if slots is None:
        slots = tuple(np.array([i], np.int32) for i in range(n_slots))
    w = np.zeros(n_regs, np.int32)
    w[:len(widths)] = widths
    return module.Plan(
        banks=tuple(None for _ in range(n_slots)), slots=slots, widths=w,
        instrs=np.asarray(instrs, np.int32).reshape(-1, 4),
        out_count=np.asarray(out_count, np.int32),
        out_row=np.asarray(out_row, np.int32), n_slots=n_slots,
        n_regs=n_regs, n_instrs=n_instrs,
        lane_count_widths=lane_count_widths,
        lane_row_widths=lane_row_widths, xbanks=xbanks, xslots=xslots,
        n_xslots=n_xslots)


class _Opaque:  # no nbytes, no shape
    pass


POS, STARTS = np.zeros(10, np.int32), np.zeros(5, np.int32)
HAND = {
    "opcode_table": dict(
        n_slots=2, widths=[3, 8], n_instrs=7, n_regs=8, out_count=[6, 7],
        out_row=[4], lane_count_widths=(5,), lane_row_widths=(8,),
        instrs=[(mk.OP_AND, 2, 0, 1), (mk.OP_OR, 3, 0, 1),
                (mk.OP_XOR, 4, 0, 1), (mk.OP_ANDNOT, 5, 2, 3),
                (mk.OP_ZERO, 6, 0, 0), (mk.OP_COPY, 2, 4, 0),
                (mk.OP_THRESH, 6, 2, 3), (mk.OP_ZERO, 7, 7, 7)]),
    "expand": dict(
        n_slots=1, widths=[4], n_instrs=3, n_regs=8, out_count=[],
        out_row=[6], lane_row_widths=(4,), xbanks=((POS, STARTS),),
        xslots=(np.array([0, 1], np.int32),), n_xslots=2,
        instrs=[(mk.OP_EXPAND, 4, 1, 0), (mk.OP_EXPAND, 5, 2, 0),
                (mk.OP_AND, 6, 4, 5), (mk.OP_ZERO, 7, 7, 7)]),
    "opaque_xbank": dict(
        n_slots=0, widths=[], slots=(), n_instrs=1, n_regs=4,
        out_count=[], out_row=[1], lane_row_widths=(4,),
        xbanks=((_Opaque(), _Opaque()),),
        xslots=(np.array([0], np.int32),), n_xslots=1,
        instrs=[(mk.OP_EXPAND, 1, 0, 0)]),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_plan_cost_matches_jax_on_hand_plans(name):
    S, W = 2, 8
    got = mk.plan_cost(_hand_plan(mk, **HAND[name]), S, W)
    assert got == jmk.plan_cost(_hand_plan(jmk, **HAND[name]), S, W)
    assert got["totalBytes"] == sum(got[k] for k in (
        "gatherBytes", "computeBytes", "expandBytes", "padBytes"))


def test_plan_cost_opcode_table_exact():
    S, W = 2, 8
    row = S * W * 4
    plan = _hand_plan(mk, **HAND["opcode_table"])
    cost = mk.plan_cost(plan, S, W)
    assert cost["gatherBytes"] == (S * 3 * 4 + row) + (S * 8 * 4 + row)
    assert cost["computeBytes"] == (4 * 3 * row + row + 2 * row + 4 * row
                                    + (row + S * 4) + 2 * row)
    assert cost["padBytes"] == row + row + (row + S * 4)
    assert cost["opcodeHist"] == {"and": 1, "or": 1, "xor": 1,
                                  "andnot": 1, "zero": 1, "copy": 1,
                                  "thresh": 1}
    assert cost["planBytes"] == plan.plan_nbytes
    assert cost["slabBytes"] == mk.slab_nbytes(8, S, W)


_SYNTH = synthetic_plans()


@pytest.mark.parametrize("case", range(len(_SYNTH)),
                         ids=[p[0] for p in _SYNTH])
def test_plan_cost_matches_jax_on_synthetic_plans(case):
    _, plan, n_shards, w_mega = _SYNTH[case]
    assert mk.plan_cost(_to_port(plan), n_shards, w_mega) == \
        jmk.plan_cost(plan, n_shards, w_mega)


def _random_entries(seed):
    """Seeded random staged evals over three dense banks and two sparse
    (pos, starts) pairs: folds, thresholds and expand leaves."""
    rng = np.random.default_rng([41, seed])
    banks = [np.zeros((12, 2, w), np.uint32) for w in (8, 4, 16)]
    pairs = [(np.arange(4 * k + 6, dtype=np.int32),
              np.arange(0, 12, 2, dtype=np.int32)) for k in range(2)]
    arrays = banks + pairs
    entries = []
    for _ in range(int(rng.integers(2, 9))):
        ir, idxs = [], []

        def leaf():
            pos = int(rng.integers(0, len(arrays)))
            idxs.append(int(rng.integers(0, 5)))
            ir.append(("xslot" if pos >= 3 else "slot", pos,
                       len(idxs) - 1))

        def tree(depth):
            if depth == 0 or rng.random() < 0.3:
                leaf()
                return
            n = int(rng.integers(2, 4))
            for _ in range(n):
                tree(depth - 1)
            if rng.random() < 0.2:
                ir.append(("thresh", int(rng.integers(1, n + 1)), n))
            else:
                ir.append(("fold", str(rng.choice(
                    ["and", "or", "xor", "diff"])), n))

        tree(3)
        entries.append((tuple(ir), arrays, idxs, [],
                        int(rng.choice([4, 8, 16])),
                        "count" if rng.random() < 0.6 else "row"))
    return entries


@pytest.mark.parametrize("seed", range(8))
def test_plan_cost_and_prediction_match_jax_on_random_plans(
        seed, no_densities):
    entries = _random_entries(seed)
    plans = []
    for module in (mk, jmk):
        low = module.Lowering()
        for e in entries:
            low.add_entry(*e)
        plans.append(low.finish())
    port, jax_plan = plans
    assert port.n_xslots == jax_plan.n_xslots
    assert mk.plan_cost(port, 2, 16) == jmk.plan_cost(jax_plan, 2, 16)
    p_opt, p_stats = plan_opt.optimize_plan(port, 2, 16)
    j_opt, j_stats = jplan_opt.optimize_plan(jax_plan, 2, 16)
    assert p_stats.predicted_bytes == j_stats.predicted_bytes > 0
    assert p_stats.fold_order_densities == j_stats.fold_order_densities
    assert p_stats.as_dict() == j_stats.as_dict()
    assert (p_opt.opt_stats is p_stats) == (j_opt.opt_stats is j_stats)
    assert mk.plan_cost(p_opt, 2, 16) == jmk.plan_cost(j_opt, 2, 16)
    rows = [[int(x) for x in r]
            for r in port.instrs[:port.n_instrs].tolist()]
    dens = {r: d for r, d in zip(range(port.n_slots), (0.1, 0.9, 0.5))}
    assert plan_opt.predict_cost_bytes(rows, dens, 2, 16) == \
        jplan_opt.predict_cost_bytes(rows, dens, 2, 16)


def test_predict_cost_bytes_density_weighting():
    S, W = 2, 8
    row = S * W * 4
    rows = [(mk.OP_AND, 2, 0, 1)]
    assert plan_opt.predict_cost_bytes(rows, {0: 1.0, 1: 1.0}, S, W) == \
        3 * row
    sparse = plan_opt.predict_cost_bytes(
        rows, {0: plan_opt.SPARSE_DENSITY, 1: plan_opt.SPARSE_DENSITY},
        S, W)
    assert sparse == int((2 * plan_opt.SPARSE_DENSITY + 1.0) * row)


# ------------------------------------------- the corpus through both packages


def _corpus_holders(tmp_path):
    """The plan fuzzer's data (``tools/plan_fuzz.Harness``, seed 0) in a
    JAX and a port holder, the "s" view in the sparse layout in both."""
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    ph = Holder(device="cpu")
    rng = np.random.default_rng([0, 77])
    n_cols = 2 * SHARD_WIDTH
    jidx, pidx = jh.create_index("pf"), ph.create_index("pf")
    all_cols = []
    for field, n, hi in (("f", 6000, n_cols), ("g", 3000, n_cols),
                         ("s", 400, 4096)):
        rows = rng.integers(0, N_ROWS, n).astype(np.uint64)
        cols = rng.integers(0, hi, n).astype(np.uint64)
        jidx.create_field(field).import_bits(rows, cols)
        pidx.create_field(field).import_bits(rows, cols)
        all_cols.append(cols)
    for idx in (jidx, pidx):
        assert idx.field("s").view("standard").set_layout("sparse")
    for field, (lo, hi) in sorted(BSI_FIELDS.items()):
        cols = rng.choice(n_cols, size=1500, replace=False).astype(np.uint64)
        vals = rng.integers(lo, hi + 1, 1500).astype(np.int64)
        jidx.create_field(field, JaxFieldOptions(type="int", min=lo, max=hi))
        pidx.create_field(field, FieldOptions(type="int", min=lo, max=hi))
        jidx.field(field).import_values(cols, vals)
        pidx.field(field).import_values(cols, vals)
        all_cols.append(cols)
    exist = np.unique(np.concatenate(all_cols))
    jidx.add_existence(exist)
    pidx.add_existence(exist)
    return jh, ph


def _captured(module, build_attr="_build"):
    plans, orig = [], getattr(module, build_attr)

    def capture(cohort):
        plan, w_mega, lanes = orig(cohort)
        plans.append((plan, cohort[0].entries[0].n_shards, w_mega))
        return plan, w_mega, lanes
    return plans, capture


CORPUS = sorted(n for n in os.listdir(DEFAULT_CORPUS) if n.endswith(".json"))


@pytest.mark.parametrize("name", CORPUS)
def test_plan_cost_matches_jax_on_corpus_plans(name, tmp_path, monkeypatch,
                                               no_densities):
    """Each committed corpus batch through both packages' executors with
    the megakernel on: the same plans, the same plan_cost dicts and
    predicted bytes, and the same roofline counters."""
    with open(os.path.join(DEFAULT_CORPUS, name)) as f:
        doc = json.load(f)
    reqs = [("pf", render_query(mode, tree), None)
            for mode, tree in doc["queries"]]
    jh, ph = _corpus_holders(tmp_path)
    try:
        jex, pex = JaxExecutor(jh), Executor(ph, device="cpu")
        jex.result_cache.enabled = False
        pex.result_cache.enabled = False
        jplans, jcap = _captured(jmegamod)
        pplans, pcap = _captured(megamod)
        monkeypatch.setattr(jmegamod, "_build", jcap)
        monkeypatch.setattr(megamod, "_build", pcap)
        monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
        monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
        want = jex.execute_batch_shaped(reqs)
        got = pex.execute_batch_shaped(reqs)
        assert [str(r) if isinstance(r, Exception) else r["results"]
                for r in got] == [str(r) if isinstance(r, Exception)
                                  else r["results"] for r in want]
        assert len(pplans) == len(jplans) >= 1
        for (pp, ps, pw), (jp, js, jw) in zip(pplans, jplans):
            assert (ps, pw) == (js, jw)
            assert mk.plan_cost(pp, ps, pw) == jmk.plan_cost(jp, js, jw)
            assert mk.plan_cost(_to_port(jp), js, jw) == \
                jmk.plan_cost(jp, js, jw)
            if jp.opt_stats is not None:
                assert pp.opt_stats.predicted_bytes == \
                    jp.opt_stats.predicted_bytes
        for a, b in ((ROOFLINE, jroofline.ROOFLINE),):
            assert a.launches == b.launches == len(pplans)
            assert a.bytes_by_kind == b.bytes_by_kind
            assert a.op_counts == b.op_counts
        for attr in ("launch_bytes_gather", "launch_bytes_compute",
                     "launch_bytes_expand", "launch_bytes_pad",
                     "opcode_counts", "mega_plan_bytes", "opt_plans",
                     "opt_cse_hits", "opt_entries_eliminated",
                     "opt_folds_reordered", "opt_bytes_saved"):
            assert getattr(pex, attr) == getattr(jex, attr), attr
    finally:
        jh.close()


# ------------------------------------------------ live wiring in the port


MIXED = ([("i", f"Count(Row(f={r}))", None) for r in (1, 2, 3)]
         + [("i", f"Row(g={r})", None) for r in (4, 5)]
         + [("i", "Count(Intersect(Row(f=6), Row(g=7)))", None)])


@pytest.fixture
def ex(monkeypatch):
    h = Holder(device="cpu")
    idx = h.create_index("i")
    rng = np.random.default_rng(23)
    rows = rng.integers(0, 8, 4000).astype(np.uint64)
    cols = rng.integers(0, 2 * SHARD_WIDTH, 4000).astype(np.uint64)
    idx.create_field("f").import_bits(rows, cols)
    idx.create_field("g").import_bits(rows[::2], cols[::2])
    idx.add_existence(cols)
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    pex = Executor(h, device="cpu")
    # Repeated batches must launch: the launch counters read the launch
    # path, not the result cache.
    pex.result_cache.enabled = False
    return pex


def test_zero_new_fences_on_unsampled_path(ex, monkeypatch):
    fences = []
    real = ex_mod._fence_device
    monkeypatch.setattr(ex_mod, "_fence_device",
                        lambda s: fences.append(1) or real(s))
    profs = [QueryProfile(i, q) for i, q, _ in MIXED]
    ex.execute_batch_shaped(MIXED, profiles=profs)
    ex.execute_batch_shaped(MIXED)
    assert fences == []
    assert ex.mega_launches == 2
    snap = ROOFLINE.snapshot()
    assert snap["launches"] == 2 and snap["fencedLaunches"] == 0
    assert ex.launch_bytes_gather > 0 and ex.launch_bytes_compute > 0
    sampled = [QueryProfile(i, q, sample_device=True) for i, q, _ in MIXED]
    ex.execute_batch_shaped(MIXED, profiles=sampled)
    assert fences == [1]  # one fence for the whole launch
    assert ROOFLINE.snapshot()["fencedLaunches"] == 1


def test_launch_cost_metrics_families(ex):
    ex.stats = MemStatsClient()
    profs = [QueryProfile(i, q, sample_device=True) for i, q, _ in MIXED]
    ex.execute_batch_shaped(MIXED, profiles=profs)
    ROOFLINE.publish(ex.stats)
    prom = prometheus_text(ex.stats)
    for kind in ("gather", "compute", "pad"):
        assert f'pilosa_executor_launch_bytes_total{{kind="{kind}"}}' \
            in prom, prom
    assert prom.count("# TYPE pilosa_executor_launch_bytes_total") == 1
    assert prom.count("# TYPE pilosa_executor_opcode_total") == 1
    snap = ROOFLINE.snapshot()
    assert snap["bytesByKind"]["gather"] == ex.launch_bytes_gather
    assert snap["opcodeTotals"] == ex.opcode_counts
    assert snap["fencedLaunches"] == 1 and snap["achievedGbps"] > 0
    assert (snap["rooflineGbps"], snap["rooflineSource"],
            snap["estimateOnly"]) == (benchenv.ROOFLINE_GBPS_DEFAULT, "cpu",
                                      True)


# ------------------------------------------------------------ the recorder


def _cost(total):
    return {"gatherBytes": total, "computeBytes": 0, "expandBytes": 0,
            "padBytes": 0, "totalBytes": total,
            "opcodeHist": {"and": 1}, "nInstrs": 1}


def _drift_script(module):
    rec = module.RooflineRecorder(ewma_alpha=1.0)
    rec.configure(enabled=True, gbps=100.0, ewma_alpha=1.0)
    rec.note_launch("A", _cost(100_000), predicted_bytes=100_000)
    rec.note_device("A", 100_000, 0.001)
    rec.note_launch("B", _cost(200_000), predicted_bytes=200_000)
    rec.note_device("B", 200_000, 0.0004)
    first = rec.snapshot()
    rec.note_device("B", 200_000, 0.005)
    rec.note_device("A", 100_000, 0.001)
    return first, rec.snapshot()


def test_drift_detector_matches_jax():
    """The JAX test's inverted cohorts: both flagged, then cleared when
    the measured order agrees again, in both recorders alike."""
    (first, last) = _drift_script(__import__(
        "pilosa_tpu_torch.utils.roofline", fromlist=["x"]))
    assert (first, last) == _drift_script(jroofline)
    assert first["driftFlags"] == 2
    assert all(c["drift"] for c in first["cohorts"])
    assert first["residuals"][0]["drift"]
    assert not any(c["drift"] for c in last["cohorts"])
    assert last["driftFlags"] == 2
    assert 200_000 > 100_000 * DRIFT_MARGIN
    rec = RooflineRecorder(ewma_alpha=1.0)
    rec.configure(gbps=100.0)
    rec.note_launch("A", _cost(100_000), predicted_bytes=100_000)
    rec.note_device("A", 100_000, 0.001)
    rec.note_launch("B", _cost(200_000), predicted_bytes=200_000)
    rec.note_device("B", 200_000, 0.0004)
    stats = MemStatsClient()
    rec.publish(stats)
    rec.publish(stats)
    assert "pilosa_roofline_drift_total 2" in prometheus_text(stats)


def test_cohort_lru_bound_and_ledger_registration():
    got = []
    for module in (__import__("pilosa_tpu_torch.utils.roofline",
                              fromlist=["x"]), jroofline):
        rec = module.RooflineRecorder(max_cohorts=2)
        for key in ("A", "B", "C"):
            rec.note_launch(key, _cost(1000))
        got.append(({c["cohort"] for c in rec.snapshot()["cohorts"]},
                    rec.state_nbytes()))
    assert got[0] == got[1] == ({"B", "C"}, got[1][1])
    rec = RooflineRecorder(max_cohorts=2)
    rec.note_launch("A", _cost(1000))
    led = MemoryLedger()
    rec.register_memory(led)
    assert led.totals()["telemetry"]["bytes"] == rec.state_nbytes()


def test_sample_rate_unattributed_disabled_and_source():
    rec = RooflineRecorder()
    rec.configure(enabled=True, gbps=10.0)
    rec.note_sample_every(4)
    rec.note_launch("A", _cost(10_000_000))
    rec.note_device("A", 10_000_000, 0.001)
    rec.note_unattributed_fence(0.002)
    rec.note_unattributed_fence(0.0)
    snap = rec.snapshot()
    assert snap["deviceSecondsEstimate"] == pytest.approx(0.004)
    assert snap["achievedGbps"] == pytest.approx(10.0)
    assert snap["rooflineFraction"] == pytest.approx(1.0)
    assert snap["unattributedFences"] == 1
    off = RooflineRecorder()
    off.configure(enabled=False)
    off.note_launch("A", _cost(1000))
    assert off.note_device("A", 1000, 0.001) is None
    assert off.snapshot()["launches"] == 0
    src = RooflineRecorder()
    assert src.roofline_gbps() == (0.0, "unresolved", True)
    src.set_resolved(*benchenv.resolve_kind("NVIDIA H100 80GB HBM3"))
    assert src.roofline_gbps() == (3350.0, "NVIDIA H100 80GB HBM3", False)
    src.configure(gbps=1640.0)
    assert src.roofline_gbps() == (1640.0, "config", False)


CARDS = [("NVIDIA H100 80GB HBM3", 3350.0, False),
         ("NVIDIA H100 PCIe", 2000.0, False),
         ("NVIDIA H100 NVL", 3900.0, False),
         ("NVIDIA H200", 4800.0, False),
         ("NVIDIA A100-SXM4-80GB", 2039.0, False),
         ("NVIDIA A100 80GB PCIe", 1935.0, False),
         ("NVIDIA A100-SXM4-40GB", 1555.0, False),
         ("TPU v5 lite", benchenv.ROOFLINE_GBPS_DEFAULT, True),
         ("", benchenv.ROOFLINE_GBPS_DEFAULT, True)]


@pytest.mark.parametrize("kind,gbps,estimated", CARDS)
def test_resolve_roofline_table(kind, gbps, estimated):
    got = benchenv.resolve_kind(kind)
    assert got[0] == gbps and got[2] is estimated
    assert benchenv.resolve_roofline("cpu") == \
        (benchenv.ROOFLINE_GBPS_DEFAULT, "cpu", True)


def test_dump_writes_printf_lines():
    rec = RooflineRecorder()
    rec.configure(enabled=True, gbps=100.0)
    rec.note_launch("A", _cost(1000), predicted_bytes=1000)
    rec.note_device("A", 1000, 0.001)
    lines = []

    class _Log:
        def printf(self, fmt, *args):
            lines.append(fmt % args if args else fmt)

    assert rec.dump(_Log()) >= 2
    assert all(ln.startswith("roofline:") for ln in lines)
    assert RooflineRecorder().dump(_Log()) == 0
