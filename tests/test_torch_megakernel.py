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
from pilosa_tpu_torch.ops import kernels
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
    slab = torch.from_numpy(slab_u32.view(np.int32).copy())
    out, counts = kernels.mega_interpret(slab, torch.from_numpy(instrs),
                                         torch.from_numpy(out_count))
    assert out is slab  # in place
    return out.numpy().view(np.uint32), counts.numpy()


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
                                  "lane", "shape", "dtype", "meta"])
def test_wrapper_refuses_bad_plans(case):
    slab = torch.zeros((4, 2, 8), dtype=torch.int32)
    instrs = torch.tensor([[mk.OP_AND, 2, 0, 1]], dtype=torch.int32)
    lanes = torch.tensor([2], dtype=torch.int32)
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
    else:
        slab = slab.to("meta")
    with pytest.raises((ValueError, TypeError)):
        kernels.mega_interpret(slab, instrs, lanes)


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
    """The JAX optimizer sorts by densities its banks reported by id();
    the stand-in banks here have none, as in the port."""
    monkeypatch.setattr(jplan_opt, "_density", OrderedDict())


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
    low = mk.Lowering()
    with pytest.raises(ValueError):
        low.add_entry((("xslot", 0, 0),), [np.zeros((2, 1, 4))], [0], [],
                      4, "count")


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
                                   (8, 3, 2048)])
def test_cuda_mega_interpret_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    T, S, W = shape
    rng = np.random.default_rng(T + W)
    slab = torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    instrs = torch.from_numpy(_random_plan(rng, T, 64))
    lanes = torch.from_numpy(rng.integers(0, T, 16).astype(np.int32))
    want_slab, want_counts = kernels.mega_interpret_ref(slab.clone(), instrs,
                                                        lanes)
    before = kernels.LAUNCHES["mega_interpret"]
    got_slab, got_counts = kernels.mega_interpret(slab, instrs, lanes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mega_interpret"] == before + 1
    assert torch.equal(got_slab, want_slab)
    assert torch.equal(got_counts, want_counts)
