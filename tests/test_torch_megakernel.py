"""The port's plan-buffer megakernel against the JAX package, exact
equality throughout (every output is an integer):

- the interpreter's plain version (``kernels.mega_interpret_ref``, what a
  CPU tensor runs) against the JAX jnp interpreter (``build_program``
  with ``use_pallas=False``) on random plans over every opcode, and
  against the numpy reference of ``tests/test_pallas_kernels.py`` (which
  models opcodes 0..5) including its read-after-write chain case;
- ``Lowering``, ``optimize_plan`` and ``verify_plan``: identical IR fed to
  both packages gives identical buffers, and the port's verifier gives
  the JAX verdict on the synthetic plans of ``tools/planverify`` and on
  every one of their mutations;
- the wrapper's plain version over 2-3 banks narrower than, as wide as
  and wider than the launch width, with plan widths below the bank
  width, against the JAX ``build_program(...).run`` (gather, fit, mask,
  plan, both output stages);
- the live plan prefix the kernel runs (``mega_live_rows``), the routing
  of a cohort whose T exceeds the kernel's shared-memory tile;
- the wrapper's checks, and the CUDA kernel against its plain version on
  a card (marked gpu, skipped without one)."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import megakernel as jmk
from pilosa_tpu.ops import plan_opt as jplan_opt
from pilosa_tpu_torch.ops import build, kernels
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.ops import plan_opt
from test_pallas_kernels import _mega_reference
from tools.planverify import PLAN_MUTATIONS, mutate_plan, synthetic_plans

# ------------------------------------------------------------ interpreter


def _random_plan(rng, T, P, n_ops=8):
    return np.stack([rng.integers(0, n_ops, P), rng.integers(0, T, P),
                     rng.integers(0, T, P), rng.integers(0, T, P)],
                    axis=1).astype(np.int32)


def _port_interpret(slab_u32, instrs, out_count):
    """The port's wrapper over a slab whose every register is a gathered
    row at full width, with every register a row lane: the final slab."""
    T, S, W = slab_u32.shape
    slab = torch.from_numpy(slab_u32.view(np.int32).copy())
    counts, rows = kernels.mega_interpret(
        (slab,), (np.arange(T, dtype=np.int32),), np.full(T, W, np.int32),
        torch.from_numpy(instrs), torch.from_numpy(out_count),
        np.arange(T, dtype=np.int32), T, S, W)
    return rows.numpy().view(np.uint32), counts.numpy()


_JAX_RUNS = {}


def _jax_interpret(slab_u32, instrs, out_count):
    """The JAX jnp interpreter over a slab whose every register is a
    gathered row at full width (so the prologue passes it through)."""
    T, S, W = slab_u32.shape
    run = _JAX_RUNS.get((T, S, W))
    if run is None:
        run = _JAX_RUNS[(T, S, W)] = jax.jit(
            jmk.build_program(S, W, T, use_pallas=False))
    counts, rows = run((jnp.asarray(slab_u32),),
                       (jnp.arange(T, dtype=jnp.int32),),
                       jnp.full((T,), W, jnp.int32), jnp.asarray(instrs),
                       jnp.asarray(out_count),
                       jnp.arange(T, dtype=jnp.int32))
    return (np.asarray(rows),
            np.asarray(counts).astype(np.int64).sum(axis=-1))


@pytest.mark.parametrize("seed", range(6))
def test_interpreter_matches_jax_on_random_plans(seed):
    rng = np.random.default_rng([41, seed])
    T, S, W, P = 16, 2, 8, 32
    slab = rng.integers(0, 2**32, (T, S, W), dtype=np.uint32)
    instrs = _random_plan(rng, T, P)
    out_count = rng.integers(0, T, 8).astype(np.int32)
    got_slab, got_counts = _port_interpret(slab, instrs, out_count)
    want_slab, want_counts = _jax_interpret(slab, instrs, out_count)
    np.testing.assert_array_equal(got_slab, want_slab)
    np.testing.assert_array_equal(got_counts, want_counts)


def test_interpreter_covers_every_opcode_with_aliasing():
    """Every opcode, THRESH chains, dst == a and a == b aliasing and pow2
    pad rows, against JAX."""
    rng = np.random.default_rng(3)
    T, S, W = 8, 3, 5
    slab = rng.integers(0, 2**32, (T, S, W), dtype=np.uint32)
    instrs = np.array([
        [mk.OP_ZERO, 4, 4, 4],
        [mk.OP_THRESH, 4, 0, 1],      # 0 | (r0 & r1)
        [mk.OP_THRESH, 4, 4, 2],      # reads dst as a
        [mk.OP_THRESH, 5, 3, 3],      # a == b
        [mk.OP_AND, 6, 6, 6],
        [mk.OP_XOR, 6, 6, 0],
        [mk.OP_ANDNOT, 0, 0, 4],      # dst == a
        [mk.OP_EXPAND, 1, 2, 2],
        [mk.OP_COPY, 2, 5, 0],
        [mk.OP_OR, 3, 3, 6],
        [mk.OP_ZERO, 7, 7, 7],        # pad rows
        [mk.OP_ZERO, 7, 7, 7],
    ], np.int32)
    out_count = np.arange(T, dtype=np.int32)
    got = _port_interpret(slab, instrs, out_count)
    want = _jax_interpret(slab, instrs, out_count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_interpreter_matches_numpy_reference_with_raw_chains():
    """The read-after-write case of tests/test_pallas_kernels.py: entry k
    reads the register entry k-1 wrote."""
    rng = np.random.default_rng(5)
    slab = rng.integers(0, 2**32, (16, 2, 8), dtype=np.uint32)
    instrs = np.array([
        [mk.OP_AND, 12, 0, 1],
        [mk.OP_OR, 12, 12, 2],
        [mk.OP_ANDNOT, 13, 3, 12],
        [mk.OP_XOR, 13, 13, 4],
        [mk.OP_COPY, 14, 13, 0],
        [mk.OP_ZERO, 15, 15, 15],
        [mk.OP_OR, 14, 14, 15],
    ], np.int32)
    got, counts = _port_interpret(slab, instrs, np.array([12, 13, 14],
                                                          np.int32))
    want = _mega_reference(slab, instrs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        counts, [int(np.bitwise_count(want[r]).sum()) for r in (12, 13, 14)])


@pytest.mark.parametrize("seed", range(4))
def test_interpreter_matches_numpy_reference_random(seed):
    rng = np.random.default_rng([17, seed])
    slab = rng.integers(0, 2**32, (8, 1, 4), dtype=np.uint32)
    instrs = _random_plan(rng, 8, int(rng.integers(1, 12)), n_ops=6)
    got, _ = _port_interpret(slab, instrs, np.zeros(1, np.int32))
    np.testing.assert_array_equal(got, _mega_reference(slab, instrs))


@pytest.mark.parametrize("case", ["opcode", "register", "negative",
                                  "lane", "shape", "dtype", "meta",
                                  "noncontiguous", "shards", "slot",
                                  "width_zero", "width_wide", "row_lane",
                                  "tile"])
def test_wrapper_refuses_bad_plans(case):
    bank = torch.zeros((4, 2, 8), dtype=torch.int32)
    slots = [np.array([0, 1], np.int32)]
    widths = np.array([8, 8, 0, 0], np.int32)
    instrs = torch.tensor([[mk.OP_AND, 2, 0, 1]], dtype=torch.int32)
    lanes = torch.tensor([2], dtype=torch.int32)
    row_lanes = np.array([3], np.int32)
    T, S = 4, 2
    if case == "opcode":
        instrs[0, 0] = 8
    elif case == "register":
        instrs[0, 3] = 4
    elif case == "negative":
        instrs[0, 1] = -1
    elif case == "lane":
        lanes[0] = 4
    elif case == "shape":
        instrs = instrs[:, :3]
    elif case == "dtype":
        instrs = instrs.to(torch.int64)
    elif case == "meta":
        bank = bank.to("meta")
    elif case == "noncontiguous":
        bank = torch.zeros((4, 8, 2), dtype=torch.int32).transpose(1, 2)
    elif case == "shards":
        S = 3
    elif case == "slot":
        slots[0][1] = 4
    elif case == "width_zero":
        widths[0] = 0
    elif case == "width_wide":
        widths[1] = 9
    elif case == "row_lane":
        row_lanes[0] = -1
    else:
        T = kernels.MEGA_MAX_REGS + 1
    with pytest.raises((ValueError, TypeError)):
        kernels.mega_interpret((bank,), slots, widths, instrs, lanes,
                               row_lanes, T, S, 8)


def test_tile_limit_matches_the_kernel():
    """MEGA_MAX_REGS is the most registers whose narrowest column tile
    fits one block's 227 KB beside everything the kernel stages; pow2
    plans stop at 1024."""
    src = (build.CSRC_DIR / "mega_interpret.cu").read_text()
    for name, value in (("MIN_TILE_WORDS", kernels.MEGA_MIN_TILE_WORDS),
                        ("SLOT_CAP", kernels.MEGA_SLOT_CAP),
                        ("PLAN_CAP", kernels.MEGA_PLAN_CAP),
                        ("LANE_CAP", kernels.MEGA_LANE_CAP),
                        ("MAX_BLOCK_SMEM", kernels.MEGA_BLOCK_SMEM)):
        assert f"constexpr int {name} = {value};" in src
    T = kernels.MEGA_MAX_REGS
    staged = (256 + 512) * 16 + 2 * 256 * 4
    assert T * 32 * 4 + staged <= 232448 < (T + 1) * 32 * 4 + staged
    assert mk.pow2_at_least(T + 1) // 2 == 1024


def test_run_program_on_cpu_launches_no_kernel():
    rng = np.random.default_rng(9)
    bank = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 2, 6),
                                         dtype=np.int64).astype(np.int32))
    low = mk.Lowering()
    low.add_entry((("slot", 0, 0), ("slot", 0, 1), ("fold", "and", 2)),
                  [bank], [0, 3], [], 6, "count")
    low.add_entry((("slot", 0, 0), ("slot", 0, 1), ("fold", "or", 2)),
                  [bank], [1, 2], [], 6, "row")
    plan = low.finish()
    before = dict(kernels.LAUNCHES)
    counts, rows = mk.run_program(plan, 2, 6)
    assert kernels.LAUNCHES == before
    b = bank.numpy().view(np.uint32)
    assert int(counts[0]) == int(np.bitwise_count(b[0] & b[3]).sum())
    np.testing.assert_array_equal(rows[0].numpy().view(np.uint32),
                                  b[1] | b[2])


# Banks narrower than, as wide as and wider than the launch width, with
# plan widths below the bank width (the mask): (bank widths, w_mega).
_BANK_CASES = [((12, 16, 20), 16), ((8, 33), 33), ((40, 9, 33), 33),
               ((6, 5), 7)]


def _multibank_case(rng, bank_ws, w_mega, S=3, T=16, P=40):
    banks = [rng.integers(0, 2**32, (int(rng.integers(3, 7)), S, w),
                          dtype=np.uint32) for w in bank_ws]
    slots = [rng.integers(0, len(b), int(rng.integers(1, 4)))
             .astype(np.int32) for b in banks]
    n_slots = sum(len(sl) for sl in slots)
    widths = np.zeros(T, np.int32)
    for k, w in enumerate(np.concatenate(
            [np.full(len(sl), b.shape[-1]) for b, sl in zip(banks, slots)])):
        # mostly below the bank width; sometimes the full launch width
        hi = min(int(w), w_mega)
        widths[k] = w_mega if rng.random() < 0.2 else \
            int(rng.integers(1, hi + 1))
    instrs = _random_plan(rng, T, P)        # writes slot registers too
    instrs = np.concatenate([instrs, np.tile(
        np.array([[mk.OP_ZERO, T - 1, T - 1, T - 1]], np.int32), (24, 1))])
    out_count = np.concatenate([rng.integers(0, T - 1, 5),
                                [T - 1] * 3]).astype(np.int32)
    out_row = np.concatenate([rng.integers(0, T - 1, 3),
                              [T - 1]]).astype(np.int32)
    assert n_slots < T
    return banks, slots, widths, instrs, out_count, out_row


def _jax_run(banks, slots, widths, instrs, out_count, out_row, T, S,
             w_mega):
    key = (T, S, w_mega, tuple(b.shape for b in banks))
    jrun = _JAX_RUNS.get(key)
    if jrun is None:
        jrun = _JAX_RUNS[key] = jax.jit(
            jmk.build_program(S, w_mega, T, use_pallas=False))
    counts, rows = jrun(tuple(jnp.asarray(b) for b in banks),
                        tuple(jnp.asarray(sl) for sl in slots),
                        jnp.asarray(widths), jnp.asarray(instrs),
                        jnp.asarray(out_count), jnp.asarray(out_row))
    return (np.asarray(counts).astype(np.int64).sum(axis=-1),
            np.asarray(rows))


@pytest.mark.parametrize("case", range(len(_BANK_CASES)))
@pytest.mark.parametrize("seed", range(2))
def test_plain_version_matches_jax_run_over_banks(case, seed):
    """kernels.mega_interpret (the plain version on the CPU) against JAX
    build_program(...).run over 2-3 banks: gather, fit, width mask,
    zeroed scratch, the plan and both output stages."""
    bank_ws, w_mega = _BANK_CASES[case]
    rng = np.random.default_rng([61, case, seed])
    T, S = 16, 3
    banks, slots, widths, instrs, out_count, out_row = _multibank_case(
        rng, bank_ws, w_mega, S, T)
    want_counts, want_rows = _jax_run(banks, slots, widths, instrs,
                                      out_count, out_row, T, S, w_mega)
    tb = [torch.from_numpy(b.view(np.int32)) for b in banks]
    got_counts, got_rows = kernels.mega_interpret(
        tb, slots, widths, torch.from_numpy(instrs), out_count, out_row, T,
        S, w_mega)
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_array_equal(got_rows.numpy().view(np.uint32),
                                  want_rows)
    ref_counts, ref_rows = kernels.mega_interpret_ref(
        tb, slots, widths, torch.from_numpy(instrs), out_count, out_row, T,
        S, w_mega)
    assert torch.equal(ref_counts, got_counts)
    assert torch.equal(ref_rows, got_rows)


@pytest.mark.parametrize("seed", range(6))
def test_live_rows_drop_only_noop_pad_rows(seed):
    """The kernel runs the plan's live prefix (``mega_live_rows``): every
    output, pad lanes included, equals running every row. The body ORs
    slot rows into scratch registers; the tail ZEROes registers the body
    left alone (droppable) and, for odd seeds, one it wrote (not)."""
    rng = np.random.default_rng([67, seed])
    T, S, W, n_slots = 12, 2, 5, 3
    slab = torch.from_numpy(rng.integers(1, 2**31, (T, S, W),
                                         dtype=np.int64).astype(np.int32))
    written = [int(r) for r in rng.choice(np.arange(n_slots, T - 1), 4,
                                          replace=False)]
    body = [(mk.OP_OR, r, int(rng.integers(0, n_slots)),
             int(rng.integers(0, n_slots))) for r in written]
    untouched = [r for r in range(n_slots, T) if r not in written]
    tail = [(mk.OP_ZERO, int(rng.choice(untouched)), 0, 0)
            for _ in range(6)]
    at = None
    if seed % 2:
        at = int(rng.integers(0, len(tail)))
        tail[at] = (mk.OP_ZERO, written[0], 0, 0)
    instrs = np.asarray(body + tail, np.int32)
    n_run = kernels.mega_live_rows(instrs, n_slots)
    assert n_run == len(body) + (0 if at is None else at + 1)
    lanes = np.arange(T, dtype=np.int32)
    args = ((slab,), (np.arange(n_slots, dtype=np.int32),),
            np.full(T, W, np.int32))
    want = kernels.mega_interpret_ref(*args, torch.from_numpy(instrs),
                                      lanes, lanes, T, S, W)
    got = kernels.mega_interpret_ref(
        *args, torch.from_numpy(instrs[:n_run]), lanes, lanes, T, S, W)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_live_rows_keep_the_pad_when_a_real_row_writes_the_spare():
    low = mk.Lowering()
    bank = np.zeros((4, 2, 8), np.uint32)
    low.add_entry((("slot", 0, 0), ("slot", 0, 1), ("fold", "and", 2)),
                  [bank], [0, 1], [], 8, "count")
    low.add_entry((("slot", 0, 0), ("slot", 0, 1), ("slot", 0, 2),
                   ("fold", "or", 3)), [bank], [0, 1, 2], [], 8, "row")
    plan = low.finish()
    assert plan.n_instrs < len(plan.instrs)  # carries pad rows
    assert kernels.mega_live_rows(plan.instrs, plan.n_slots) == \
        plan.n_instrs
    instrs = plan.instrs.copy()
    instrs[0, 1] = plan.n_regs - 1
    assert kernels.mega_live_rows(instrs, plan.n_slots) == len(instrs)


@pytest.fixture
def taxi_like():
    """A small CPU holder (two set fields, one int field over 2 shards)
    with the megakernel forced on."""
    from pilosa_tpu_torch import Executor, FieldOptions, Holder
    from pilosa_tpu_torch.executor import megakernel as megamod
    rng = np.random.default_rng(71)
    n = 2 * (1 << 20)
    cols = rng.choice(n, 3000, replace=False).astype(np.uint64)
    h = Holder(device="cpu")
    idx = h.create_index("t")
    idx.create_field("a").import_bits(
        rng.integers(0, 3, len(cols)).astype(np.uint64), cols)
    idx.create_field("b").import_bits(
        rng.integers(1, 5, len(cols)).astype(np.uint64), cols)
    idx.create_field("v", FieldOptions(type="int", min=0, max=300)) \
        .import_values(cols, rng.integers(0, 300, len(cols)))
    prev = megamod.MEGAKERNEL_ENABLED
    megamod.MEGAKERNEL_ENABLED = True
    ex = Executor(h, device="cpu")
    # The tests read the launch path's counters after computing their
    # expected answers through the same executor: no result cache.
    ex.result_cache.enabled = False
    yield ex
    megamod.MEGAKERNEL_ENABLED = prev


_ROUTED = ["Count(Row(a=1))", "Count(Intersect(Row(a=2), Row(b=3)))",
           "Count(Row(v > 100))", "Union(Row(a=0), Row(b=4))"]


def _routed_answers(out):
    got = []
    for item in out:
        (res,), _ = item
        got.append(res if isinstance(res, int) else res.columns().tolist())
    return got


@pytest.mark.parametrize("limit", ["default", "under"])
def test_t_over_the_tile_limit_runs_per_group(taxi_like, monkeypatch,
                                               limit):
    """A cohort whose T exceeds MEGA_MAX_REGS runs per group, counted in
    mega_budget_fallbacks, with the eager answers; under the limit the
    same cohort takes one launch."""
    ex = taxi_like
    want = [ex.execute("t", q)[0] for q in _ROUTED]
    want = [w if isinstance(w, int) else w.columns().tolist() for w in want]
    if limit == "under":
        monkeypatch.setattr(kernels, "MEGA_MAX_REGS", 2)
    before = (ex.mega_launches, ex.mega_budget_fallbacks)
    got = _routed_answers(ex.execute_batch([("t", q, None)
                                            for q in _ROUTED]))
    assert got == want
    if limit == "under":
        assert (ex.mega_launches, ex.mega_budget_fallbacks) == \
            (before[0], before[1] + len(_ROUTED))
    else:
        assert (ex.mega_launches, ex.mega_budget_fallbacks) == \
            (before[0] + 1, before[1])


# -------------------------------------------- lowering / optimizer parity


def _random_ir(rng, depth_by_bank, n_banks):
    """One random postfix IR entry with its idxs/params: slot leaves,
    zero leaves, folds, thresholds and BSI comparisons."""
    ir, idxs, params = [], [], []

    def leaf():
        kind = rng.random()
        if kind < 0.55:
            pos = int(rng.integers(0, n_banks))
            ir.append(("slot", pos, len(idxs)))
            idxs.append(int(rng.integers(0, 6)))
        elif kind < 0.65:
            ir.append(("zero",))
        else:
            pos = int(rng.integers(0, n_banks))
            depth = depth_by_bank[pos]
            i0 = len(idxs)
            idxs.extend(range(depth + 1))
            bkind = ("eq", "neq", "notnull", "lt", "gt",
                     "between")[int(rng.integers(0, 6))]
            j = len(params)
            for _ in range(2 if bkind == "between" else 1):
                v = int(rng.integers(0, 1 << depth))
                params.extend([v & 0xFFFFFFFF, v >> 32])
            k = j + 2 if bkind == "between" else 0
            ir.append(("bsi", bkind, pos, i0, depth, j, k,
                       bool(rng.random() < 0.5)))

    def tree(level):
        if level == 0 or rng.random() < 0.3:
            leaf()
            return
        n = int(rng.integers(1, 5))
        for _ in range(n):
            tree(level - 1)
        if rng.random() < 0.25:
            ir.append(("thresh", int(rng.integers(1, n + 2)), n))
        else:
            fold = ("and", "or", "xor", "diff")[int(rng.integers(0, 4))]
            ir.append(("fold", fold, n))

    tree(3)
    return tuple(ir), idxs, params


def _random_entries(seed):
    rng = np.random.default_rng([23, seed])
    depths = [5, 3, 9]
    banks = [np.zeros((max(6, d + 1), 2, w), np.uint32)
             for d, w in zip(depths, (8, 4, 16))]
    entries = []
    for _ in range(int(rng.integers(1, 9))):
        ir, idxs, params = _random_ir(rng, depths, len(banks))
        width = int(rng.choice([4, 8, 16]))
        mode = "count" if rng.random() < 0.6 else "row"
        entries.append((ir, banks, idxs, params, width, mode))
    return entries


def _lower(module, entries):
    low = module.Lowering()
    lanes = [low.add_entry(*e) for e in entries]
    return low.finish(), lanes


def _assert_same_plan(got, want):
    for name in ("instrs", "widths", "out_count", "out_row"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert len(got.slots) == len(want.slots)
    for g, w in zip(got.slots, want.slots):
        np.testing.assert_array_equal(g, w)
    assert [id(b) for b in got.banks] == [id(b) for b in want.banks]
    for name in ("n_slots", "n_regs", "n_instrs", "lane_count_widths",
                 "lane_row_widths"):
        assert tuple(np.atleast_1d(getattr(got, name))) == \
            tuple(np.atleast_1d(getattr(want, name))), name


@pytest.fixture
def no_jax_densities(monkeypatch):
    """Both optimizers sort by densities their banks reported by id();
    the stand-in banks here have none (an id reused from a freed bank of
    another test must not lend them one)."""
    monkeypatch.setattr(jplan_opt, "_density", OrderedDict())
    monkeypatch.setattr(plan_opt, "_density", OrderedDict())


@pytest.mark.parametrize("seed", range(12))
def test_lowering_and_optimizer_match_jax(seed, no_jax_densities):
    entries = _random_entries(seed)
    got, got_lanes = _lower(mk, entries)
    want, want_lanes = _lower(jmk, entries)
    assert got_lanes == want_lanes
    _assert_same_plan(got, want)
    mk.verify_plan(got, 2, 16)
    jmk.verify_plan(want, 2, 16)
    got_opt, got_stats = plan_opt.optimize_plan(got, 2, 16)
    want_opt, want_stats = jplan_opt.optimize_plan(want, 2, 16)
    _assert_same_plan(got_opt, want_opt)
    assert got_stats.cse_hits == want_stats.cse_hits
    assert got_stats.folds_reordered == want_stats.folds_reordered
    mk.verify_plan(got_opt, 2, 16)


def test_lowering_refuses_sparse_leaves():
    """A sparse leaf lowers to an expand register read only through
    OP_EXPAND, as in the JAX package; a leaf kind the lowering does not
    know is still refused."""
    pair = (np.zeros(1024, np.int32), np.zeros(3, np.int32))
    low = mk.Lowering()
    low.add_entry((("xslot", 0, 0),), [pair], [0], [], 4, "count")
    plan = low.finish()
    assert plan.n_slots == 0 and plan.n_xslots == 1
    assert plan.instrs[0].tolist() == [mk.OP_EXPAND, 1, 0, 0]
    mk.verify_plan(plan, 1, 4)
    with pytest.raises(ValueError):
        mk.Lowering().add_entry((("yslot", 0, 0),), [pair], [0], [], 4,
                                "count")


# -------------------------------------------------------- verifier parity


def _to_port(plan):
    return mk.Plan(banks=plan.banks, slots=plan.slots, widths=plan.widths,
                   instrs=plan.instrs, out_count=plan.out_count,
                   out_row=plan.out_row, n_slots=plan.n_slots,
                   n_regs=plan.n_regs, n_instrs=plan.n_instrs,
                   lane_count_widths=plan.lane_count_widths,
                   lane_row_widths=plan.lane_row_widths)


def _verdict(verify, plan, n_shards, w_mega):
    try:
        verify(plan, n_shards, w_mega)
    except (mk.PlanVerifyError, jmk.PlanVerifyError):
        return False
    return True


_DENSE_PLANS = [p for p in synthetic_plans() if not p[1].xbanks]


@pytest.mark.parametrize("case", range(len(_DENSE_PLANS)),
                         ids=[p[0] for p in _DENSE_PLANS])
def test_verifier_matches_jax_on_synthetic_plans(case):
    _, plan, n_shards, w_mega = _DENSE_PLANS[case]
    assert _verdict(mk.verify_plan, _to_port(plan), n_shards, w_mega)
    applied = 0
    for ki, kind in enumerate(PLAN_MUTATIONS):
        for trial in range(3):
            rng = np.random.default_rng([case, ki, trial])
            mutated = mutate_plan(rng, plan, kind, w_mega=w_mega)
            if mutated is None:
                continue
            applied += 1
            want = _verdict(jmk.verify_plan, mutated, n_shards, w_mega)
            got = _verdict(mk.verify_plan, _to_port(mutated), n_shards,
                           w_mega)
            assert got == want, (kind, trial)
    assert applied


@pytest.mark.parametrize("seed", range(4))
def test_verifier_matches_jax_on_mutated_random_plans(seed):
    plan, _ = _lower(jmk, _random_entries(100 + seed))
    for ki, kind in enumerate(PLAN_MUTATIONS):
        rng = np.random.default_rng([seed, ki])
        mutated = mutate_plan(rng, plan, kind, w_mega=16)
        if mutated is None:
            continue
        assert _verdict(mk.verify_plan, _to_port(mutated), 2, 16) == \
            _verdict(jmk.verify_plan, mutated, 2, 16), kind


def test_verifier_rejects_expand_without_expand_registers():
    ir = (("slot", 0, 0), ("slot", 0, 1), ("fold", "and", 2))
    plan, _ = _lower(mk, [(ir, [np.zeros((4, 2, 8), np.uint32)], [0, 1],
                           [], 8, "count")])
    plan.instrs[0, 0] = mk.OP_EXPAND
    with pytest.raises(mk.PlanVerifyError):
        mk.verify_plan(plan, 2, 8)


# ------------------------------------------------------------------- card


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 96, 32768), (8, 3, 33), (8, 3, 128),
                                   (8, 3, 2048), (1024, 3, 128)])
def test_cuda_mega_interpret_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    T, S, W = shape
    rng = np.random.default_rng(T + W)
    slab = torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    n_slots = T // 2
    args = ((slab,), (np.arange(n_slots, dtype=np.int32),),
            np.full(T, W, np.int32), torch.from_numpy(_random_plan(rng, T, 64)),
            rng.integers(0, T, 16).astype(np.int32),
            rng.integers(0, T, 4).astype(np.int32), T, S, W)
    want = kernels.mega_interpret_ref(*args)
    before = kernels.LAUNCHES["mega_interpret"]
    got = kernels.mega_interpret(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mega_interpret"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(_BANK_CASES)))
def test_cuda_mega_interpret_over_banks_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    bank_ws, w_mega = _BANK_CASES[case]
    rng = np.random.default_rng([73, case])
    banks, slots, widths, instrs, out_count, out_row = _multibank_case(
        rng, bank_ws, w_mega)
    args = ([torch.from_numpy(b.view(np.int32)).to(dev) for b in banks],
            slots, widths, torch.from_numpy(instrs), out_count, out_row, 16,
            3, w_mega)
    want = kernels.mega_interpret_ref(*args)
    got = kernels.mega_interpret(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_views", [7, 8])
def test_cuda_time_range_or_fold_matches_plain(n_views):
    """A time range's lowering: one slot of each of ``n_views`` day-view
    banks and an OR fold, as a count lane and a row lane, beside an
    unrelated entry; the kernel's answer equals the plain version's and
    the numpy union."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    S, W = 4, 2048
    rng = np.random.default_rng([97, n_views])
    host = [rng.integers(0, 2**32, (2, S, W), dtype=np.uint32)
            & np.uint32(rng.integers(0, 2**32)) for _ in range(n_views)]
    for b in host:
        b[-1] = 0  # the zero slot
    banks = [torch.from_numpy(b.view(np.int32)).to(dev) for b in host]
    ir = tuple(("slot", k, k) for k in range(n_views)) \
        + (("fold", "or", n_views),)
    low = mk.Lowering()
    for mode in ("count", "row"):
        low.add_entry(ir, banks, [0] * n_views, [], W, mode)
    low.add_entry((("slot", 0, 0), ("slot", 1, 1), ("fold", "and", 2)),
                  banks[:2], [0, 0], [], W, "count")
    plan = low.finish()
    mk.verify_plan(plan, S, W)
    args = (plan.banks, plan.slots, plan.widths, plan.instrs,
            plan.out_count, plan.out_row, plan.n_regs, S, W)
    want = kernels.mega_interpret_ref(*args)
    before = kernels.LAUNCHES["mega_interpret"]
    got = kernels.mega_interpret(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mega_interpret"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    union = np.bitwise_or.reduce(np.stack([b[0] for b in host]), axis=0)
    assert int(got[0][0]) == int(np.unpackbits(union.view(np.uint8)).sum())
    np.testing.assert_array_equal(got[1][0].cpu().numpy().view(np.uint32),
                                  union)


def _sparse_rows(rng, n_rows, n_shards, width, widen=0):
    """Encoded (shard << 16) | bitpos positions, unique per (row, shard),
    row after row, with int32 offsets per row slot (rows past n_rows and
    every fifth row empty) and a pad tail; ``widen`` words of positions
    past width * 32."""
    parts, lens = [], []
    for r in range(n_rows):
        row = [np.empty(0, np.uint32)]
        if r % 5 != 3:
            for sh in range(n_shards):
                bits = np.unique(rng.integers(0, (width + widen) * 32,
                                              int(rng.integers(0, 80))))
                row.append(bits.astype(np.uint32) | np.uint32(sh << 16))
        parts.append(np.concatenate(row))
        lens.append(len(parts[-1]))
    cap = 1 << n_rows.bit_length()
    starts = np.zeros(cap + 1, np.int64)
    np.cumsum(lens, out=starts[1:n_rows + 1])
    starts[n_rows + 1:] = starts[n_rows]
    pos = np.zeros(int(starts[-1]) + 1024, np.uint32)
    pos[:starts[-1]] = np.concatenate(parts)
    return pos.view(np.int32), starts.astype(np.int32), cap


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows,n_shards,width,widen", [
    (64, 1, 128, 0), (40, 96, 2048, 0), (20, 3, 128, 64), (33, 1, 2048, 0)])
def test_cuda_expand_positions_matches_plain(n_rows, n_shards, width,
                                             widen):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng([n_rows, n_shards, width])
    pos, starts, cap = _sparse_rows(rng, n_rows, n_shards, width, widen)
    slots = np.concatenate([np.arange(n_rows), [cap - 1, 0, 3]]).astype(
        np.int32)  # the zero slot and repeats
    args = (torch.from_numpy(pos).to(dev), torch.from_numpy(starts).to(dev),
            slots, n_shards, width)
    want = kernels.expand_positions_ref(*args[:2], torch.from_numpy(slots)
                                        .to(dev), n_shards, width)
    before = kernels.LAUNCHES["expand_positions"]
    got = kernels.expand_positions(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_positions"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_mega_interpret_with_expand_registers_matches_plain():
    """A plan reading a dense bank and a sparse bank through OP_EXPAND:
    one expand_positions launch and one mega_interpret launch, equal to
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(29)
    S, W = 3, 128
    dense = rng.integers(0, 2**32, (8, S, W), dtype=np.uint32)
    pos, starts, cap = _sparse_rows(rng, 12, S, W)
    bank = torch.from_numpy(dense.view(np.int32)).to(dev)
    pair = (torch.from_numpy(pos).to(dev), torch.from_numpy(starts).to(dev))
    low = mk.Lowering()
    for ir, idxs, width, mode in [
            ((("slot", 0, 0), ("xslot", 1, 1), ("fold", "and", 2)), [1, 3],
             W, "count"),
            ((("xslot", 1, 0), ("xslot", 1, 1), ("fold", "or", 2)),
             [2, cap - 1], 100, "row"),
            ((("xslot", 1, 0), ("slot", 0, 1), ("slot", 0, 2),
              ("thresh", 2, 3)), [4, 5, 6], W, "count")]:
        low.add_entry(ir, [bank, pair], idxs, [], width, mode)
    plan = low.finish()
    mk.verify_plan(plan, S, W)
    args = (plan.banks, plan.slots, plan.widths, plan.instrs,
            plan.out_count, plan.out_row, plan.n_regs, S, W, plan.xbanks,
            plan.xslots)
    want = kernels.mega_interpret_ref(*args)
    before = dict(kernels.LAUNCHES)
    got = kernels.mega_interpret(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand_positions"] == \
        before["expand_positions"] + 1
    assert kernels.LAUNCHES["mega_interpret"] == before["mega_interpret"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
