#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``pilosa_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. build: compile ``pilosa_tpu_torch/csrc/*.cu`` with nvcc (one process
   per source, in parallel) and load it; print the card's name and power
   limit.
2. kernels: hold each of the three popcount kernels bit-exact against
   its plain PyTorch version at the taxi path's shapes (R in {1, 8, 16},
   S = 96, W = 32768) and at ragged shapes (R = 5, S = 3, W in {33, 128,
   2048, 6144}), on random (p = 0.5) and all-ones banks; time each at
   its main-path shape beside its bound and its plain version. Hold
   ``mega_interpret`` bit-exact (slab and counts) against its plain
   version on seeded random plans over all eight opcodes, with
   read-after-write and THRESH chains, dst == a aliasing and pow2 pad
   rows, at the burst's shape (T = 64, S = 96, W = 32768) and at ragged
   shapes (T = 8, S = 3, W in {33, 128, 2048}).
3. taxi: build the NYC-taxi ride index (100M rides = 96 shards, seed 5;
   cab_type, passenger_count, dist, amount, existence) on
   ``Holder(device="cuda")`` and answer five queries through
   ``Executor.execute``, each checked exactly against numpy.
4. burst: on the same holder, one ``Executor.execute_batch`` of eighteen
   read requests of different shapes (a dashboard refresh), checked
   exactly against numpy; the flush must take exactly one megakernel
   launch with no fallback. Then the burst's warm p50 beside the sum of
   the same requests' warm p50s one at a time, the gather prologue's and
   the kernel's time on the burst's real plan, the kernel's bound and its
   plain version's time.

Launch counts are set to 0 just before each path (taxi, burst) and read
just after; every kernel must have launched on its path. The
second-to-last line is the kernels JSON, the last line
``{"ok": true, "device": {...}}``. The script imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "bank_row_counts": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "bank_row_counts_masked": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "bsi_plane_counts": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "mega_interpret": "pilosa_tpu_torch/csrc/mega_interpret.cu",
}
REPLACES = {
    "bank_row_counts": "pilosa_tpu/ops/pallas_kernels.py:143",
    "bank_row_counts_masked": "pilosa_tpu/ops/pallas_kernels.py:168",
    "bsi_plane_counts": "pilosa_tpu/ops/pallas_kernels.py:374",
    "mega_interpret": "pilosa_tpu/ops/pallas_kernels.py:337",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
SHARD_WIDTH = 1 << 20
WORDS = 32768
N_RIDES = 100_000_000  # 96 shards
ITERS = 5  # warm runs per taxi query for the p50

# The burst: one dashboard refresh, eighteen read requests of different
# shapes over the taxi index (name, PQL).
BURST = [(f"cab{c}_pax{p}",
          f"Count(Intersect(Row(cab_type={c}), Row(passenger_count={p})))")
         for c in range(3) for p in (1, 2)]
BURST += [(f"dist_lt_{v}", f"Count(Row(dist < {v}))")
          for v in (10, 50, 100, 250)]
BURST += [
    ("cab1_amount_ge_400",
     "Count(Intersect(Row(cab_type=1), Row(amount >= 400)))"),
    ("pax1_amount_lt_100",
     "Count(Intersect(Row(passenger_count=1), Row(amount < 100)))"),
    ("not_cab0", "Count(Not(Row(cab_type=0)))"),
    ("pax5_or_pax6",
     "Count(Union(Row(passenger_count=5), Row(passenger_count=6)))"),
    ("cab0_xor_pax2", "Count(Xor(Row(cab_type=0), Row(passenger_count=2)))"),
    ("cab1_minus_dist_gt_20",
     "Count(Difference(Row(cab_type=1), Row(dist > 20)))"),
    ("threshold_2_of_3",
     "Count(Threshold(Row(cab_type=2), Row(passenger_count=1), "
     "Row(dist >= 200), k=2))"),
    ("rows_cab2_pax6_dist299",
     "Intersect(Row(cab_type=2), Row(passenger_count=6), Row(dist == 299))"),
]

TAXI_QUERIES = [
    ("count_intersect",
     "Count(Intersect(Row(cab_type=0), Row(passenger_count=2)))"),
    ("bsi_range_count", "Count(Row(dist < 50))"),
    ("sum_filtered", "Sum(Row(cab_type=1), field=amount)"),
    ("topn", "TopN(passenger_count, n=3)"),
    ("topn_filtered",
     "TopN(cab_type, Intersect(Row(passenger_count=2), Row(dist > 100)), "
     "n=3)"),
]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- kernels


def random_bank(torch, shape, gen, device):
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=gen, device=device)


def kernel_cases(torch, kernels):
    """name -> (wrapper, plain, make_inputs(R, S, W, fill)) where the
    wrapper and plain take the inputs and return a tuple of counts."""
    def bank_in(R, S, W, make):
        return (make((R, S, W)),)

    def masked_in(R, S, W, make):
        return make((R, S, W)), make((S, W))

    def as_tuple(fn):
        def run(*args):
            out = fn(*args)
            return out if isinstance(out, tuple) else (out,)
        return run

    return {
        "bank_row_counts": (as_tuple(kernels.bank_row_counts),
                            as_tuple(kernels.bank_row_counts_ref), bank_in),
        "bank_row_counts_masked": (
            as_tuple(kernels.bank_row_counts_masked),
            as_tuple(kernels.bank_row_counts_masked_ref), masked_in),
        "bsi_plane_counts": (as_tuple(kernels.bsi_plane_counts),
                             as_tuple(kernels.bsi_plane_counts_ref),
                             masked_in),
    }


def check_kernels(torch, kernels, device):
    """Bit-exact comparison at main-path and ragged shapes; returns the
    max |kernel - plain| per kernel (always 0 when this returns)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    shapes = [(R, 96, WORDS) for R in (1, 8, 16)] + \
        [(5, 3, W) for W in (33, 128, 2048, 6144)]
    errs = {}
    for name, (wrapper, plain, make_inputs) in \
            kernel_cases(torch, kernels).items():
        worst = 0
        for shape in shapes:
            for fill in ("p0.5", "ones"):
                if fill == "ones":
                    def make(s):
                        return torch.full(s, -1, dtype=torch.int32,
                                          device=device)
                else:
                    def make(s):
                        return random_bank(torch, s, gen, device)
                inputs = make_inputs(*shape, make)
                got = wrapper(*inputs)
                want = plain(*inputs)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if g.device.type != "cuda" or g.dtype != torch.int64:
                        raise AssertionError(f"{name}: bad output {g}")
                    err = int((g - w).abs().max()) if g.numel() else 0
                    worst = max(worst, err)
                    if err:
                        raise AssertionError(
                            f"{name} {shape} {fill}: kernel {g.tolist()} "
                            f"!= plain {w.tolist()}")
                del inputs, got, want
        errs[name] = worst
        log(f"kernels: {name} bit-exact over {len(shapes) * 2} cases")
    return errs


def time_cuda(torch, fn, iters=20, warmup=3):
    """Median device time (ms) of fn() over `iters` launches, each
    bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def time_kernels(torch, kernels, device, n_shards):
    """Time each kernel (its C entry on preallocated outputs, so only the
    kernel runs) and its plain version at the taxi path's shapes:
    passenger_count's bank [8, S, W] for bank_row_counts, cab_type's bank
    [4, S, W] with a filter for the masked sweep, amount's 10 planes for
    bsi_plane_counts."""
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    S, W = n_shards, WORDS
    n = S * W
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {}

    def record(name, R, extra_in, n_out, kernel_fn, plain_fn):
        nbytes = (R * n + extra_in) * 4 + n_out * R * 4
        if kernel_fn() != 0:
            raise RuntimeError(f"{name}: kernel launch failed")
        ms = time_cuda(torch, kernel_fn)
        plain_ms = time_cuda(torch, plain_fn, iters=5, warmup=1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         shape=[R, S, W])
        log(f"timing: {name} [{R},{S},{W}] kernel {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms")

    bank = random_bank(torch, (8, S, W), gen, device)
    o1 = torch.zeros(8, dtype=torch.int32, device=device)
    record("bank_row_counts", 8, 0, 1,
           lambda: lib.bank_row_counts(bank.data_ptr(), o1.data_ptr(), 8, n,
                                       stream),
           lambda: kernels.bank_row_counts_ref(bank))
    bank4 = bank[:4]
    filt = random_bank(torch, (S, W), gen, device)
    oi = torch.zeros(4, dtype=torch.int32, device=device)
    orw = torch.zeros_like(oi)
    record("bank_row_counts_masked", 4, n, 2,
           lambda: lib.bank_row_counts_masked(
               bank4.data_ptr(), filt.data_ptr(), oi.data_ptr(),
               orw.data_ptr(), 4, n, stream),
           lambda: kernels.bank_row_counts_masked_ref(bank4, filt))
    planes = random_bank(torch, (10, S, W), gen, device)
    op = torch.zeros(10, dtype=torch.int32, device=device)
    record("bsi_plane_counts", 10, n, 1,
           lambda: lib.bsi_plane_counts(planes.data_ptr(), filt.data_ptr(),
                                        op.data_ptr(), 10, n, stream),
           lambda: kernels.bsi_plane_counts_ref(planes, filt))
    del bank, bank4, filt, planes
    torch.cuda.empty_cache()
    return out


def random_mega_plan(rng, T, n_real):
    """A seeded random plan over T registers: n_real rows covering all
    eight opcodes, read-after-write chains (a row reading the previous
    row's dst), THRESH chains, dst == a aliasing, then pow2 pad rows
    (ZERO, spare, spare, spare). Returns (instrs [P, 4], out_count)."""
    import numpy as np
    spare = T - 1
    rows = []
    prev = 0
    for i in range(n_real):
        op = i % 8 if i < 8 else int(rng.integers(0, 8))
        dst = int(rng.integers(0, T - 1))
        a = int(rng.integers(0, T - 1))
        b = int(rng.integers(0, T - 1))
        shape = i % 4
        if shape == 1:
            a = prev                  # read-after-write chain
        elif shape == 2:
            a = dst                   # dst == a aliasing
        elif shape == 3:
            op, a = 7, prev           # THRESH chain through prev
        rows.append((op, dst, a, b))
        prev = dst
    P = 1 << max(0, n_real - 1).bit_length()
    if P == n_real:
        P *= 2                        # always carry pad rows
    rows += [(4, spare, spare, spare)] * (P - n_real)
    lanes = sorted({int(r) for r in rng.integers(0, T - 1, 7)}) + [spare]
    return (np.asarray(rows, np.int32).reshape(P, 4),
            np.asarray(lanes, np.int32))


def check_mega(torch, kernels, device):
    """mega_interpret against mega_interpret_ref, slab and counts bit for
    bit; returns the max |kernel - plain| (0 when this returns)."""
    import numpy as np
    rng = np.random.default_rng(13)
    cases = [((64, 96, WORDS), 200)] + \
        [((8, 3, W), n) for W in (33, 128, 2048) for n in (5, 24)]
    for (T, S, W), n_real in cases:
        instrs, lanes = random_mega_plan(rng, T, n_real)
        words = rng.integers(0, 1 << 32, (T, S, W), dtype=np.uint32)
        slab = torch.from_numpy(words.view(np.int32)).to(device)
        want_slab, want_counts = kernels.mega_interpret_ref(
            slab.clone(), torch.from_numpy(instrs), torch.from_numpy(lanes))
        got_slab, got_counts = kernels.mega_interpret(
            slab, torch.from_numpy(instrs), torch.from_numpy(lanes))
        torch.cuda.synchronize()
        if got_counts.device.type != "cuda" or \
                got_counts.dtype != torch.int64:
            raise AssertionError(f"mega_interpret: bad output {got_counts}")
        if not torch.equal(got_slab, want_slab) or \
                not torch.equal(got_counts, want_counts):
            raise AssertionError(
                f"mega_interpret [{T},{S},{W}] P={len(instrs)}: kernel "
                f"counts {got_counts.tolist()} != plain "
                f"{want_counts.tolist()} or slabs differ")
        del slab, want_slab, got_slab
    torch.cuda.empty_cache()
    log(f"kernels: mega_interpret bit-exact over {len(cases)} plans")
    return 0


# ---------------------------------------------------------------- taxi


def taxi_data(n_rides, seed=5):
    """The ride columns of the taxi bench (benches/taxi.py), from `seed`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cab = rng.integers(0, 3, n_rides).astype(np.uint64)
    pax = rng.integers(1, 7, n_rides).astype(np.uint64)
    dist = rng.integers(0, 300, n_rides).astype(np.int64)
    amount = (dist * 25 // 10 + rng.integers(3, 20, n_rides)).astype(np.int64)
    return cab, pax, dist, amount


def taxi_expected(cab, pax, dist, amount):
    """Exact answers of TAXI_QUERIES, recomputed with numpy."""
    want = {}
    want["count_intersect"] = int(((cab == 0) & (pax == 2)).sum())
    want["bsi_range_count"] = int((dist < 50).sum())
    c1 = cab == 1
    want["sum_filtered"] = (int(amount[c1].sum()), int(c1.sum()))
    counts = [(p, int((pax == p).sum())) for p in range(1, 7)]
    want["topn"] = sorted(counts, key=lambda rc: (-rc[1], rc[0]))[:3]
    m = (pax == 2) & (dist > 100)
    counts = [(c, int((m & (cab == c)).sum())) for c in range(3)]
    want["topn_filtered"] = sorted(
        [rc for rc in counts if rc[1] > 0], key=lambda rc: (-rc[1], rc[0]))[:3]
    return want


def taxi_answer(name, result):
    if name in ("count_intersect", "bsi_range_count"):
        return result
    if name == "sum_filtered":
        return (result.value, result.count)
    return [tuple(p) for p in result.pairs]


def load_taxi(device, cab, pax, dist, amount):
    """Build the taxi index on a port Holder; returns (holder, seconds)."""
    import numpy as np
    from pilosa_tpu_torch import Executor, FieldOptions, Holder
    t0 = time.perf_counter()
    cols = np.arange(len(cab), dtype=np.uint64)
    holder = Holder(device=device)
    idx = holder.create_index("taxi")
    idx.create_field("cab_type").import_bits(cab, cols)
    idx.create_field("passenger_count").import_bits(pax, cols)
    idx.create_field("dist", FieldOptions(type="int", min=0, max=300)) \
        .import_values(cols, dist)
    idx.create_field("amount", FieldOptions(type="int", min=0, max=1000)) \
        .import_values(cols, amount)
    idx.add_existence(cols)
    return holder, Executor(holder, device=device), \
        time.perf_counter() - t0


def burst_expected(cab, pax, dist, amount):
    """Exact answers of BURST, recomputed with numpy: ints for counts,
    sorted column ids for the row request."""
    import numpy as np
    want = {}
    for c in range(3):
        for p in (1, 2):
            want[f"cab{c}_pax{p}"] = int(((cab == c) & (pax == p)).sum())
    for v in (10, 50, 100, 250):
        want[f"dist_lt_{v}"] = int((dist < v).sum())
    want["cab1_amount_ge_400"] = int(((cab == 1) & (amount >= 400)).sum())
    want["pax1_amount_lt_100"] = int(((pax == 1) & (amount < 100)).sum())
    want["not_cab0"] = int((cab != 0).sum())
    want["pax5_or_pax6"] = int(((pax == 5) | (pax == 6)).sum())
    want["cab0_xor_pax2"] = int(((cab == 0) ^ (pax == 2)).sum())
    want["cab1_minus_dist_gt_20"] = int(((cab == 1) & (dist <= 20)).sum())
    votes = (cab == 2).astype(np.int8) + (pax == 1) + (dist >= 200)
    want["threshold_2_of_3"] = int((votes >= 2).sum())
    want["rows_cab2_pax6_dist299"] = np.flatnonzero(
        (cab == 2) & (pax == 6) & (dist == 299)).tolist()
    return want


def run_main(device, n_rides, iters=ITERS, profile=False):
    """Load the taxi index, then drive both paths on it: the five taxi
    queries one at a time, then the eighteen-request burst through
    execute_batch. Returns (report, taxi launches, burst launches).
    Raises on any wrong answer."""
    import torch
    cab, pax, dist, amount = taxi_data(n_rides)
    want_taxi = taxi_expected(cab, pax, dist, amount)
    want_burst = burst_expected(cab, pax, dist, amount)
    holder, ex, load_s = load_taxi(device, cab, pax, dist, amount)
    del cab, pax, dist, amount
    log(f"taxi: loaded {n_rides} rides in {load_s:.2f} s")
    report = {"rides": n_rides,
              "shards": (n_rides + SHARD_WIDTH - 1) // SHARD_WIDTH,
              "load_s": load_s}
    report["taxi"], taxi_launches = run_taxi(ex, want_taxi, device, iters,
                                             profile)
    report["burst"], burst_launches = run_burst(ex, want_burst, device,
                                                iters, profile)
    if device != "cpu":
        report["device_bytes"] = torch.cuda.max_memory_allocated()
    del ex, holder
    return report, taxi_launches, burst_launches


def run_taxi(ex, want, device, iters=ITERS, profile=False):
    """The five taxi queries through Executor.execute: one pass with the
    launch counts set to 0 just before it and read just after, then the
    warm p50s. Returns (report, launches)."""
    import torch
    from pilosa_tpu_torch.ops import kernels
    report = {}
    kernels.reset_launches()
    for name, pql in TAXI_QUERIES:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (got,) = ex.execute("taxi", pql)
        first_s = time.perf_counter() - t0
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if taxi_answer(name, got) != want[name]:
            raise AssertionError(f"taxi {name}: port {taxi_answer(name, got)}"
                                 f" != numpy {want[name]}")
        report[name] = {"pql": pql, "first_s": first_s, "launches": delta,
                        "answer": taxi_answer(name, got)}
    launches = dict(kernels.LAUNCHES)
    for name, pql in TAXI_QUERIES:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            (got,) = ex.execute("taxi", pql)
            if device != "cpu":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if taxi_answer(name, got) != want[name]:
                raise AssertionError(f"taxi {name}: warm answer changed")
        times.sort()
        report[name]["p50_s"] = times[len(times) // 2]
        log(f"taxi: {name} first {report[name]['first_s']:.4f}"
            f" s, warm p50 {times[len(times) // 2]:.6f} s, launches "
            f"{report[name]['launches']}")
    if device != "cpu" and profile:
        report["profile"] = profile_taxi(torch, ex, iters)
    return report, launches


# --------------------------------------------------------------- burst


def burst_answers(out, want):
    """Check one execute_batch output against numpy; raises on any
    difference or request error."""
    if len(out) != len(BURST):
        raise AssertionError(f"burst: {len(out)} results for {len(BURST)}")
    for (name, pql), item in zip(BURST, out):
        if isinstance(item, Exception):
            raise AssertionError(f"burst {name}: {pql} raised {item!r}")
        (res,), _ = item
        got = res if isinstance(res, int) else res.columns().tolist()
        if got != want[name]:
            brief = got if isinstance(got, int) else f"{len(got)} columns"
            raise AssertionError(f"burst {name}: port {brief} != numpy")


def run_burst(ex, want, device, iters=ITERS, profile=False):
    """The burst through Executor.execute_batch: one run with the launch
    counts set to 0 just before it and read just after, which must answer
    exactly, in one megakernel launch with no fallback; then its warm p50
    beside the same requests one at a time, and the prologue's and the
    kernel's times on the burst's own plan. Returns (report, launches)."""
    import torch
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.ops import kernels
    reqs = [("taxi", pql, None) for _, pql in BURST]
    captured = []
    build_fn = megamod._build

    def capture(cohort):
        t0 = time.perf_counter()
        plan, w_mega, lanes = build_fn(cohort)
        captured.append((plan, cohort[0].entries[0].n_shards, w_mega,
                         time.perf_counter() - t0))
        return plan, w_mega, lanes

    prev = megamod.MEGAKERNEL_ENABLED
    megamod._build = capture
    if device == "cpu":
        # Rehearsal only: the megakernel defaults to off on the CPU.
        megamod.MEGAKERNEL_ENABLED = True
    try:
        before = (ex.mega_launches, ex.mega_fallbacks,
                  ex.mega_budget_fallbacks)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = ex.execute_batch(reqs)
        if device != "cpu":
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        burst_answers(out, want)
        after = (ex.mega_launches, ex.mega_fallbacks,
                 ex.mega_budget_fallbacks)
        if after != (before[0] + 1, before[1], before[2]) or \
                len(captured) != 1:
            raise AssertionError(
                f"burst: megakernel launches/fallbacks/budget fallbacks "
                f"{before} -> {after}, {len(captured)} plans: expected one "
                "launch and no fallback")
        if device != "cpu" and launches["mega_interpret"] != 1:
            raise AssertionError(f"burst: kernel launches {launches}")
        plan, n_shards, w_mega, _ = captured[0]
        from pilosa_tpu_torch.ops import megakernel as mk
        slab_bytes = mk.slab_nbytes(plan.n_regs, n_shards, w_mega)
        report = {"requests": len(reqs), "first_s": first_s,
                  "launches": launches, "n_slots": plan.n_slots,
                  "n_regs": plan.n_regs, "n_instrs": plan.n_instrs,
                  "instr_capacity": int(plan.instrs.shape[0]),
                  "count_lanes": len(plan.lane_count_widths),
                  "row_lanes": len(plan.lane_row_widths),
                  "slab_bytes": slab_bytes, "plan_bytes": plan.plan_nbytes,
                  "n_shards": n_shards, "w_mega": w_mega}
        log(f"burst: {len(reqs)} requests answered exactly in one launch; "
            f"n_slots {plan.n_slots}, n_regs {plan.n_regs}, n_instrs "
            f"{plan.n_instrs} (capacity {plan.instrs.shape[0]}), slab "
            f"{slab_bytes} bytes, first {first_s:.4f} s")
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = ex.execute_batch(reqs)
            if device != "cpu":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            burst_answers(out, want)
        times.sort()
        report["p50_s"] = times[len(times) // 2]
        # Host time of the lowering and the plan optimizer in the warm
        # runs (the verify gate runs on a plan signature's first launch
        # only).
        lower = sorted(c[3] for c in captured[1:])
        report["lower_opt_p50_s"] = lower[len(lower) // 2]
    finally:
        megamod._build = build_fn
        megamod.MEGAKERNEL_ENABLED = prev
    singles = {}
    for name, pql in BURST:
        ex.execute("taxi", pql)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            ex.execute("taxi", pql)
            if device != "cpu":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        times.sort()
        singles[name] = times[len(times) // 2]
    report["single_p50_s"] = singles
    report["single_p50_sum_s"] = sum(singles.values())
    log(f"burst: warm p50 {report['p50_s']:.6f} s for {len(reqs)} "
        f"requests (lowering and optimizer {report['lower_opt_p50_s']:.6f}"
        f" s of it); one at a time the p50s sum to "
        f"{report['single_p50_sum_s']:.6f} s")
    if device != "cpu":
        report.update(time_mega(torch, kernels, device, plan, n_shards,
                                w_mega))
        if profile:
            report["profile"] = profile_burst(torch, ex, reqs, iters)
    return report, launches


def time_mega(torch, kernels, device, plan, n_shards, w_mega):
    """On the burst's own plan: the gather prologue's time, the kernel's
    (its C entry on the gathered slab, plan buffers already on the card)
    and its plain version's, median of CUDA-event timings; the kernel is
    held bit-exact against the plain version on this plan too."""
    from pilosa_tpu_torch.ops import build
    from pilosa_tpu_torch.ops import megakernel as mk
    lib = build.load()
    gather_ms = time_cuda(torch, lambda: mk.gather_slab(plan, n_shards,
                                                        w_mega), iters=10)
    host_instrs = torch.from_numpy(plan.instrs)
    host_lanes = torch.from_numpy(plan.out_count)
    slab = mk.gather_slab(plan, n_shards, w_mega)
    want_slab, want_counts = kernels.mega_interpret_ref(
        slab.clone(), host_instrs, host_lanes)
    got_slab, got_counts = kernels.mega_interpret(slab, host_instrs,
                                                  host_lanes)
    torch.cuda.synchronize()
    if not torch.equal(got_slab, want_slab) or \
            not torch.equal(got_counts, want_counts):
        raise AssertionError("mega_interpret differs from its plain version "
                             "on the burst's plan")
    instrs = host_instrs.to(device)
    lanes = host_lanes.to(device)
    counts = torch.zeros(len(plan.out_count), dtype=torch.int32,
                         device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    n = n_shards * w_mega

    def kernel():
        # A verified plan defines every scratch register before reading
        # it, so rerunning it over the same slab is idempotent.
        return lib.mega_interpret(slab.data_ptr(), instrs.data_ptr(),
                                  lanes.data_ptr(), counts.data_ptr(),
                                  plan.n_regs, n, plan.instrs.shape[0],
                                  len(plan.out_count), stream)

    if kernel() != 0:
        raise RuntimeError("mega_interpret: kernel launch failed")
    ms = time_cuda(torch, kernel)
    plain_slab = want_slab
    plain_ms = time_cuda(torch, lambda: kernels.mega_interpret_ref(
        plain_slab, host_instrs, host_lanes), iters=3, warmup=1)
    row = n * 4
    nbytes = (plan.n_slots * row + len(plan.lane_row_widths) * row
              + len(plan.lane_count_widths) * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing: mega_interpret [{plan.n_regs},{n_shards},{w_mega}] "
        f"P={plan.instrs.shape[0]} kernel {ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms (bytes), plain {plain_ms:.4f} ms; gather prologue "
        f"{gather_ms:.4f} ms")
    log("timing: no single PyTorch call computes a plan interpreter, so "
        "mega_interpret has no library yardstick (library_ms null)")
    del slab, want_slab, got_slab, plain_slab
    torch.cuda.empty_cache()
    return {"gather_ms": gather_ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_bytes": nbytes}


def profile_burst(torch, ex, reqs, iters):
    """The warm burst under torch.profiler: wall and device time per
    burst, the device's busy share, and the device items that took it."""
    from torch.profiler import ProfilerActivity, profile
    ex.execute_batch(reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            ex.execute_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = device_times(torch, prof, iters)
    device_ms = sum(per_kernel.values())
    wall_ms = wall / iters * 1e3
    log(f"profile: burst wall {wall_ms:.4f} ms/burst, device "
        f"{device_ms:.4f} ms/burst, busy {device_ms / wall_ms:.3f}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernels_ms": dict(sorted(per_kernel.items(),
                                      key=lambda kv: -kv[1])[:12])}


def device_times(torch, prof, iters):
    """Device time per run (ms) of each device-side event of a profile:
    kernels and memcpys only, since an aten op's device time repeats that
    of the kernels it launched."""
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            per_kernel[ev.key] = dev_us / iters / 1e3
    return per_kernel


def profile_taxi(torch, ex, iters):
    """Per query, under torch.profiler over `iters` warm runs: wall time
    and device time per query, the device's busy share, and the kernels
    that took the device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, pql in TAXI_QUERIES:
        ex.execute("taxi", pql)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                ex.execute("taxi", pql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per_kernel = device_times(torch, prof, iters)
        device_ms = sum(per_kernel.values())
        wall_ms = wall / iters * 1e3
        out[name] = {"wall_ms": wall_ms, "device_ms": device_ms,
                     "busy_share": device_ms / wall_ms,
                     "kernels_ms": dict(sorted(per_kernel.items(),
                                               key=lambda kv: -kv[1]))}
        log(f"profile: {name} wall {wall_ms:.4f} ms/query, device "
            f"{device_ms:.4f} ms/query, busy {device_ms / wall_ms:.3f}")
    return out


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the warm taxi queries and the burst "
                         "with torch.profiler (device time, busy share)")
    ap.add_argument("--report", metavar="PATH",
                    help="write the full taxi, burst and timing report as "
                         "JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    if not os.path.isdir(os.path.join(REPO, "pilosa_tpu_torch")):
        log("chip_smoke: pilosa_tpu_torch/ not found beside this script")
        return 1
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 1. build
    from pilosa_tpu_torch.ops import build, kernels
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    log(f"build: {build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")
    card = card_line()
    print(card, flush=True)

    # 2. kernels
    errs = check_kernels(torch, kernels, device)
    errs["mega_interpret"] = check_mega(torch, kernels, device)
    n_shards = (N_RIDES + SHARD_WIDTH - 1) // SHARD_WIDTH
    timing = time_kernels(torch, kernels, device, n_shards)
    log("timing: torch has no single popcount call, so there is no "
        "library yardstick (library_ms null)")

    # 3-4. the main paths: taxi queries one at a time, then the burst
    report, taxi_launches, burst_launches = run_main(
        "cuda", N_RIDES, ITERS, profile=args.profile)
    launches = {name: taxi_launches[name] for name in REPLACES
                if name != "mega_interpret"}
    launches["mega_interpret"] = burst_launches["mega_interpret"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on its "
                                 "path")
    burst = report["burst"]
    timing["mega_interpret"] = {"ms": burst["kernel_ms"],
                                "plain_ms": burst["plain_ms"],
                                "bound_ms": burst["bound_ms"]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "report": report, "timing": timing}, f,
                      indent=1)
    taxi = report["taxi"]
    print(json.dumps({"taxi": {
        "rides": report["rides"], "shards": report["shards"],
        "load_s": report["load_s"],
        "p50_s": {k: v["p50_s"] for k, v in taxi.items()
                  if k != "profile"},
        "launches": {k: v["launches"] for k, v in taxi.items()
                     if k != "profile"}}}), flush=True)
    print(json.dumps({"burst": {k: burst[k] for k in (
        "requests", "p50_s", "single_p50_sum_s", "lower_opt_p50_s",
        "first_s", "gather_ms",
        "kernel_ms", "plain_ms", "bound_ms", "n_slots", "n_regs",
        "n_instrs", "instr_capacity", "count_lanes", "row_lanes",
        "slab_bytes", "launches")}}), flush=True)

    # 5. kernels line, then the result line
    rows = []
    for name in kernels.LAUNCHES:
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
