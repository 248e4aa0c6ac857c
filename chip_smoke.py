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
   ``mega_interpret`` bit-exact (count lanes and row lanes) against its
   plain version on seeded random banks, slot lists, plan widths and
   plans over all eight opcodes, with read-after-write and THRESH
   chains, dst == a aliasing, writes into slot registers and pow2 pad
   rows: the burst's shape (T = 64 over three banks of 96 x 32768), T in
   {8, 512, 1024} at S = 3, banks narrower than, as wide as and wider
   than the launch width with plan widths below the bank width, W in
   {33, 34, 128, 2048}, bank rows that allow only 4-byte copies, more
   count lanes than the kernel keeps in shared memory, and word counts
   that no column tile divides. Hold
   ``pbank_membership_counts`` bit-exact against its plain version on
   fixed [65536, 48] rows with 0xFFFF pads (48- and 1500-bit filters),
   fixed [1024, 128] and flat rows of 0-200 positions, W in {1, 128,
   2047}.
3. taxi: build the NYC-taxi ride index (100M rides = 96 shards, seed 5;
   cab_type, passenger_count, dist, amount, existence) on
   ``Holder(device="cuda")`` and answer five queries through
   ``Executor.execute``, each checked exactly against numpy.
4. burst: on the same holder, one ``Executor.execute_batch`` of eighteen
   read requests of different shapes (a dashboard refresh), checked
   exactly against numpy; the flush must take exactly one megakernel
   launch with no fallback. Then the burst's warm p50 beside the sum of
   the same requests' warm p50s one at a time, the device memory one
   warm burst allocates at its peak, and on the burst's real plan the
   kernel's time (its column tile, shared memory and grid, and its
   registers from ``-Xptxas -v``), its byte and shared-memory bounds and
   its plain version's time.
5. tanimoto: a fingerprint index of 10M molecules (``--molecules``;
   4096-bit fingerprints of 48 draws each from seed 11, one shard, 200
   planted analogues of molecule 12345) loaded through
   ``Field.import_bits``, then five TopN queries (Tanimoto 60 and 30,
   filtered, unfiltered, threshold) through ``Executor.execute``, each
   exact against numpy and answered from the device-resident positions
   bank with no full dense bank; then one Set into the query molecule,
   after which the answers stay exact and every other segment keeps its
   device arrays. Then the membership kernel's time on one segment of
   that bank beside its bound, its plain version and torch.isin.
6. serve: the port's HTTP server over the holders already loaded, each
   answer exact against numpy. On the taxi holder (``serve_taxi``): an
   ``API`` with a ``QueryCoalescer`` at its default window behind
   ``serve()`` on a free loopback port; ``GET /schema`` lists the taxi
   fields; the five taxi queries as raw-PQL POSTs (each response equal
   to the in-process answer too) and their warm HTTP p50s; the burst as
   one ``POST /batch/query`` (warm p50) and as 18 concurrent POSTs
   released by a barrier, ten rounds, which must take megakernel
   launches with no fallback; then a ``set`` field made over HTTP, one
   shard of rides imported as JSON and one as a protobuf
   ``ImportRequest`` (seconds per request), one ``Set`` through the
   query route, and TopN, a Count(Intersect) and a ``?shards=0`` Row
   read back. On the fingerprint holder (``serve_fingerprint``): the
   five queries over HTTP (the first also as a protobuf
   ``QueryRequest``), a second Set through the query route, the five
   again, still through the positions bank. Then ``python -m
   pilosa_tpu_torch.cli server`` as a subprocess (``serve_cli``): an
   index with a set and an int field made, imported and asked Count,
   TopN and Sum; the seconds from its start to the first answer.

Launch counts are set to 0 just before each path (taxi, burst,
fingerprint, the serve path's taxi and fingerprint servers) and read
just after; every kernel must have launched on its path, and on the
serve path. The ``serve`` line, the card's name and power limit, the
kernels JSON and the ``{"ok": true, "device": {...}}`` line end the
output. The script imports nothing of JAX or of the JAX package.

``--burst-probe [--tree DIR]`` runs only the taxi load and the burst,
with the ``pilosa_tpu_torch`` package of DIR (default: beside this
script), and prints one ``probe`` JSON line: the burst's warm p50, the
device memory one warm burst allocates at its peak, and its device time
by kernel under torch.profiler. Runs of two trees in turns compare them
on one card.
"""

from __future__ import annotations

import argparse
import bisect
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
    "pbank_membership_counts": "pilosa_tpu_torch/csrc/pbank_membership.cu",
}
REPLACES = {
    "bank_row_counts": "pilosa_tpu/ops/pallas_kernels.py:143",
    "bank_row_counts_masked": "pilosa_tpu/ops/pallas_kernels.py:168",
    "bsi_plane_counts": "pilosa_tpu/ops/pallas_kernels.py:374",
    "mega_interpret": "pilosa_tpu/ops/pallas_kernels.py:337",
    "pbank_membership_counts": "pilosa_tpu/ops/pallas_kernels.py:250",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
SHARD_WIDTH = 1 << 20
WORDS = 32768
N_RIDES = 100_000_000  # 96 shards
ITERS = 5  # warm runs per taxi query for the p50
PROBE_ITERS = 21  # warm bursts for the p50 of --burst-probe

# The fingerprint index: the reference's chemical-similarity example
# (benches/tanimoto_chunked.py) — one row per molecule, 48 draws of a
# 4096-bit Morgan fingerprint each, one shard.
N_MOLECULES = 10_000_000
FP_BITS = 4096
BITS_PER_MOL = 48
FP_SEED = 11
QUERY_MOL = 12345
N_ANALOGUES = 200  # planted near neighbours of the query molecule
LOAD_CHUNK = 1_000_000  # molecules per Field.import_bits call
FP_QUERIES = [
    ("tanimoto60", f"TopN(fingerprint, Row(fingerprint={QUERY_MOL}), n=50, "
                   "tanimotoThreshold=60)"),
    ("tanimoto30", f"TopN(fingerprint, Row(fingerprint={QUERY_MOL}), n=100, "
                   "tanimotoThreshold=30)"),
    ("filtered", f"TopN(fingerprint, Row(fingerprint={QUERY_MOL}), n=50)"),
    ("unfiltered", "TopN(fingerprint, n=10)"),
    ("threshold30", f"TopN(fingerprint, Row(fingerprint={QUERY_MOL}), n=20, "
                    "threshold=30)"),
]

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


def random_mega_case(rng, torch, device, T, S, w_mega, bank_ws, n_slots,
                     n_real, n_lanes=None):
    """Seeded random launch inputs: banks of widths ``bank_ws`` with S
    shards on the card, ``n_slots`` slot rows spread over them, a plan
    width per slot (mostly below its bank's width, a fifth at the launch
    width), a random_mega_plan of ``n_real`` rows and row lanes (three
    random registers and the spare). ``n_lanes`` replaces the plan's
    count lanes with that many random ones. Returns the wrapper's
    arguments."""
    import numpy as np
    per_bank = np.full(len(bank_ws), n_slots // len(bank_ws))
    per_bank[:n_slots % len(bank_ws)] += 1
    banks, slots, widths = [], [], np.zeros(T, np.int32)
    k = 0
    for W, m in zip(bank_ws, per_bank.tolist()):
        words = rng.integers(0, 1 << 32, (m + 2, S, W), dtype=np.uint32)
        banks.append(torch.from_numpy(words.view(np.int32)).to(device))
        slots.append(rng.integers(0, m + 2, m).astype(np.int32))
        for _ in range(m):
            widths[k] = w_mega if rng.random() < 0.2 else \
                int(rng.integers(1, min(W, w_mega) + 1))
            k += 1
    instrs, lanes = random_mega_plan(rng, T, n_real)
    if n_lanes is not None:
        lanes = rng.integers(0, T, n_lanes).astype(np.int32)
    out_row = np.asarray(sorted(rng.integers(0, T - 1, 3).tolist())
                         + [T - 1], np.int32)
    return (banks, slots, widths, torch.from_numpy(instrs), lanes, out_row,
            T, S, w_mega)


MEGA_CASES = [
    # (T, S, w_mega, bank widths, slots, real plan rows, count lanes)
    (64, 96, WORDS, (WORDS, WORDS, WORDS), 29, 200, None),  # the burst
    (8, 3, 128, (128,), 6, 24, None),
    (512, 3, 128, (128, 96), 200, 700, None),
    (1024, 3, 128, (160, 128), 500, 1500, None),
    (16, 3, 128, (100, 128, 160), 9, 60, None),   # narrower, equal, wider
    (8, 3, 33, (33, 28, 40), 5, 24, None),        # 4-byte columns
    (8, 3, 34, (34, 30), 5, 24, None),            # 8-byte columns
    (16, 3, 2048, (2048, 2000, 2100), 9, 60, None),
    (16, 3, 128, (130, 126), 6, 40, None),        # 4-byte copies only
    (64, 5, 1000, (1000, 1200, 900), 20, 120, None),  # ragged last tile
    (32, 7, 100, (100,), 10, 50, 300),            # lanes past LANE_CAP
]


def check_mega(torch, kernels, device):
    """mega_interpret against mega_interpret_ref, count lanes and row
    lanes bit for bit, on MEGA_CASES; returns the max |kernel - plain| (0
    when this returns)."""
    import numpy as np
    rng = np.random.default_rng(13)
    for T, S, W, bank_ws, n_slots, n_real, n_lanes in MEGA_CASES:
        args = random_mega_case(rng, torch, device, T, S, W, bank_ws,
                                n_slots, n_real, n_lanes)
        want_counts, want_rows = kernels.mega_interpret_ref(*args)
        got_counts, got_rows = kernels.mega_interpret(*args)
        torch.cuda.synchronize()
        if got_counts.device.type != "cuda" or \
                got_counts.dtype != torch.int64:
            raise AssertionError(f"mega_interpret: bad output {got_counts}")
        if not torch.equal(got_rows, want_rows) or \
                not torch.equal(got_counts, want_counts):
            raise AssertionError(
                f"mega_interpret T={T} S={S} W={W} banks {bank_ws} "
                f"P={len(args[3])}: kernel counts {got_counts.tolist()} != "
                f"plain {want_counts.tolist()} or row lanes differ")
        del args, want_rows, got_rows
    torch.cuda.empty_cache()
    log(f"kernels: mega_interpret bit-exact over {len(MEGA_CASES)} plans")
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
    """Load the taxi index, then drive three paths on it: the five taxi
    queries one at a time, the eighteen-request burst through
    execute_batch, and the serve path's phases 1-2 over HTTP
    (``serve_taxi``). Returns (report, taxi launches, burst launches,
    serve launches). Raises on any wrong answer."""
    import numpy as np
    import torch
    cab, pax, dist, amount = taxi_data(n_rides)
    want_taxi = taxi_expected(cab, pax, dist, amount)
    want_burst = burst_expected(cab, pax, dist, amount)
    # cab_type of the first two shards' columns (255: no ride), for the
    # serve path's writes.
    cab_head = np.full(2 * SHARD_WIDTH, 255, np.uint64)
    cab_head[:min(n_rides, 2 * SHARD_WIDTH)] = cab[:2 * SHARD_WIDTH]
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
        report["device_bytes"] = max(torch.cuda.max_memory_allocated(),
                                     report["burst"]["peak_before_bytes"])
    report["serve"], serve_launches = serve_taxi(
        holder, want_taxi, want_burst, cab_head,
        {"taxi": {k: v["p50_s"] for k, v in report["taxi"].items()
                  if k != "profile"},
         "burst": report["burst"]["p50_s"]}, iters)
    del ex, holder
    return report, taxi_launches, burst_launches, serve_launches


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
        report["profile"] = profile_queries(torch, ex, "taxi", TAXI_QUERIES,
                                            iters)
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
        report = {"requests": len(reqs), "first_s": first_s,
                  "launches": launches, "n_slots": plan.n_slots,
                  "n_regs": plan.n_regs, "n_instrs": plan.n_instrs,
                  "instr_capacity": int(plan.instrs.shape[0]),
                  "count_lanes": len(plan.lane_count_widths),
                  "row_lanes": len(plan.lane_row_widths),
                  "plan_bytes": plan.plan_nbytes,
                  "n_shards": n_shards, "w_mega": w_mega}
        log(f"burst: {len(reqs)} requests answered exactly in one launch; "
            f"n_slots {plan.n_slots}, n_regs {plan.n_regs}, n_instrs "
            f"{plan.n_instrs} (capacity {plan.instrs.shape[0]}), first "
            f"{first_s:.4f} s")
        report["p50_s"] = burst_p50(ex, reqs, want, device, iters)
        if device != "cpu":
            report.update(burst_peak(torch, ex, reqs, want))
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


def burst_p50(ex, reqs, want, device, iters):
    """Warm p50 (s) of the burst through execute_batch, each run checked."""
    import torch
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = ex.execute_batch(reqs)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        burst_answers(out, want)
    times.sort()
    return times[len(times) // 2]


def burst_peak(torch, ex, reqs, want):
    """Device memory one warm burst allocates at its peak, above what was
    allocated before it (the holder's banks). The peak counter is reset
    for it; the peak of the run so far is returned as peak_before_bytes
    so the caller can still report the whole run's peak."""
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ex.execute_batch(reqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    burst_answers(out, want)
    log(f"burst: one warm burst peaks {peak} bytes above the "
        f"{base} bytes allocated before it")
    return {"burst_peak_bytes": peak, "burst_base_bytes": base,
            "peak_before_bytes": peak_before}


def smem_bound_ms(plan, live_rows, n):
    """Least time of the kernel's shared-memory traffic on the card: each
    executed plan row reads a and b and writes dst a column (THRESH also
    reads dst), plus the gathered and zeroed registers' writes and the
    lanes' reads, at 128 bytes a clock on each SM at the card's highest SM
    clock."""
    import numpy as np
    import torch
    access = np.array([3, 3, 3, 3, 3, 3, 3, 4])
    per_col = int(access[plan.instrs[:live_rows, 0]].sum()) + plan.n_regs \
        + len(plan.out_row) + len(plan.out_count)
    nbytes = per_col * n * 4
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return nbytes / (sms * 128 * mhz * 1e6) * 1e3, nbytes


def ptxas_lines(source):
    """The ``-Xptxas -v`` lines of each kernel compiled from ``source`` in
    this run's build (empty when the library was already built)."""
    from pilosa_tpu_torch.ops import build
    out, name = {}, None
    for line in build.BUILD_LOG.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def time_mega(torch, kernels, device, plan, n_shards, w_mega):
    """On the burst's own plan: the kernel held bit-exact against its
    plain version, then the kernel's time (its C entry, the plan buffers
    and slot descriptors already on the card), its tile, shared memory
    and grid, and the plain version's time, median of CUDA-event
    timings."""
    import ctypes
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    call = (plan.banks, plan.slots, plan.widths, plan.instrs,
            plan.out_count, plan.out_row, plan.n_regs, n_shards, w_mega)
    want = kernels.mega_interpret_ref(*call)
    got = kernels.mega_interpret(*call)
    torch.cuda.synchronize()
    if any(not torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("mega_interpret differs from its plain version "
                             "on the burst's plan")
    del got, want
    args, counts, rows, buf = kernels.mega_launch_args(*call)
    info = (ctypes.c_longlong * 4)()
    stream = torch.cuda.current_stream(device).cuda_stream

    def kernel():
        # Every run gathers anew from the banks; only the count lanes
        # accumulate, which timing ignores.
        return lib.mega_interpret(*args, counts.data_ptr(), rows.data_ptr(),
                                  ctypes.addressof(info), stream)

    if kernel() != 0:
        raise RuntimeError("mega_interpret: kernel launch failed")
    ms = time_cuda(torch, kernel)
    plain_ms = time_cuda(torch, lambda: kernels.mega_interpret_ref(*call),
                         iters=3, warmup=1)
    n = n_shards * w_mega
    row = n * 4
    nbytes = (plan.n_slots * row + len(plan.lane_row_widths) * row
              + len(plan.lane_count_widths) * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    live_rows = args[3]
    smem_ms, smem_bytes = smem_bound_ms(plan, live_rows, n)
    tile = {"tile_cols": info[0], "smem_bytes_per_block": info[1],
            "blocks": info[2], "threads": info[3]}
    ptxas = ptxas_lines("mega_interpret.cu")
    log(f"timing: mega_interpret T={plan.n_regs} S={n_shards} W={w_mega} "
        f"P={plan.instrs.shape[0]} ({live_rows} rows run) kernel {ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms (bytes), shared-memory bound "
        f"{smem_ms:.4f} ms, plain {plain_ms:.4f} ms; tile {tile}; ptxas "
        f"{ptxas}")
    log("timing: no single PyTorch call computes a plan interpreter, so "
        "mega_interpret has no library yardstick (library_ms null)")
    del buf, counts, rows
    torch.cuda.empty_cache()
    return {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_bytes": nbytes, "smem_bound_ms": smem_ms,
            "smem_bytes": smem_bytes, "live_rows": live_rows,
            "ptxas": ptxas, **tile}


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


def profile_queries(torch, ex, index, queries, iters):
    """Per query, under torch.profiler over `iters` warm runs: wall time
    and device time per query, the device's busy share, and the kernels
    that took the device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, pql in queries:
        ex.execute(index, pql)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                ex.execute(index, pql)
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


# --------------------------------------------------------- fingerprints


def fingerprint_positions(n, seed=FP_SEED):
    """Sorted fingerprint bit positions uint16 [n, BITS_PER_MOL] (draws may
    repeat), with N_ANALOGUES planted analogues of QUERY_MOL: each shares
    24-47 of its distinct bits and draws the rest outside them, so the
    Tanimoto thresholds return real ranked lists with ties."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, FP_BITS, (n, BITS_PER_MOL),
                               dtype=np.uint16), axis=1)
    plant = np.random.default_rng(seed + 1)
    qbits = np.unique(pos[QUERY_MOL])
    others = np.setdiff1d(np.arange(FP_BITS, dtype=np.uint16), qbits)
    cand = plant.choice(n - 1, N_ANALOGUES, replace=False)
    for mol in (cand + (cand >= QUERY_MOL)).tolist():
        k = int(plant.integers(24, min(48, len(qbits) + 1)))
        row = np.concatenate([
            plant.choice(qbits, k, replace=False),
            plant.choice(others, BITS_PER_MOL - k, replace=False)])
        pos[mol] = np.sort(row)
    return pos


def top_pairs(counts, n):
    """The first n (row, count) pairs of counts > 0 in (-count, row)
    order, in O(rows): every row above the n-th count, then the lowest
    rows at it."""
    import numpy as np
    if len(counts) > n:
        kth = max(1, int(np.partition(counts, len(counts) - n)
                         [len(counts) - n]))
    else:
        kth = 1
    above = np.flatnonzero(counts > kth)
    at = np.flatnonzero(counts == kth)[:max(0, n - len(above))]
    cand = np.concatenate([above, at])
    order = np.lexsort((cand, -counts[cand]))[:n]
    return [(int(cand[o]), int(counts[cand[o]])) for o in order]


def fingerprint_expected(pos, extra_cols=()):
    """Exact answers of FP_QUERIES from the positions array with numpy
    (distinct bits per row, the query row's bits as the filter), in 1M-row
    chunks. ``extra_cols`` adds columns (not among its bits) to the query
    molecule first."""
    import numpy as np
    filt = np.zeros(FP_BITS, dtype=bool)
    filt[pos[QUERY_MOL]] = True
    filt[list(extra_cols)] = True
    inter = np.empty(len(pos), np.int64)
    raw = np.empty(len(pos), np.int64)
    for c0 in range(0, len(pos), 1_000_000):
        p = pos[c0:c0 + 1_000_000]
        keep = np.empty(p.shape, dtype=bool)
        keep[:, 0] = True
        np.not_equal(p[:, 1:], p[:, :-1], out=keep[:, 1:])
        raw[c0:c0 + len(p)] = keep.sum(axis=1)
        inter[c0:c0 + len(p)] = (filt[p] & keep).sum(axis=1)
    raw[QUERY_MOL] += len(extra_cols)
    inter[QUERY_MOL] += len(extra_cols)
    src = int(raw[QUERY_MOL])
    denom = raw + src - inter
    want = {}
    for name, t, n in (("tanimoto60", 60, 50), ("tanimoto30", 30, 100)):
        ok = (denom > 0) & ((inter * 100) // np.maximum(denom, 1) >= t)
        want[name] = top_pairs(np.where(ok, inter, 0), n)
    want["filtered"] = top_pairs(inter, 50)
    want["unfiltered"] = top_pairs(raw, 10)
    want["threshold30"] = top_pairs(np.where(inter >= 30, inter, 0), 20)
    return want


def load_fingerprints(device, pos):
    """The fingerprint index on a port Holder through Field.import_bits,
    LOAD_CHUNK molecules a call. Returns (holder, executor, field,
    seconds)."""
    import numpy as np
    from pilosa_tpu_torch import Executor, FieldOptions, Holder
    t0 = time.perf_counter()
    holder = Holder(device=device)
    idx = holder.create_index("mole", track_existence=False)
    field = idx.create_field("fingerprint", FieldOptions(max_columns=FP_BITS))
    for c0 in range(0, len(pos), LOAD_CHUNK):
        chunk = pos[c0:c0 + LOAD_CHUNK]
        field.import_bits(
            np.repeat(np.arange(c0, c0 + len(chunk), dtype=np.uint64),
                      BITS_PER_MOL),
            chunk.reshape(-1).astype(np.uint64))
    return holder, Executor(holder, device=device), field, \
        time.perf_counter() - t0


def run_fingerprint(device, n_molecules, iters=ITERS, profile=False):
    """The fingerprint phase: load, the five queries through
    Executor.execute with the launch counts set to 0 just before the
    first pass and read just after (exact against numpy, through the
    positions bank), warm p50s, then one Set into the query molecule's
    segment, after which the answers stay exact and every other
    segment's device arrays are reused; then the serve path's phase 3
    on the same holder (``serve_fingerprint``). Returns (report,
    launches, timing inputs, serve launches)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.core.view import PositionsBank, ViewBank
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.ops.bitset import pack_positions, to_tensor
    t0 = time.perf_counter()
    pos = fingerprint_positions(n_molecules)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fingerprint_expected(pos)
    numpy_s = time.perf_counter() - t0
    holder, ex, field, load_s = load_fingerprints(device, pos)
    log(f"fingerprint: {n_molecules} molecules generated in {gen_s:.2f} s, "
        f"loaded in {load_s:.2f} s; numpy answers in {numpy_s:.2f} s")
    report = {"molecules": n_molecules, "load_s": load_s, "gen_s": gen_s,
              "queries": {}}
    kernels.reset_launches()
    for name, pql in FP_QUERIES:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (got,) = ex.execute("mole", pql)
        first_s = time.perf_counter() - t0
        if got.pairs != want[name]:
            raise AssertionError(f"fingerprint {name}: port {got.pairs[:5]}"
                                 f"... != numpy {want[name][:5]}...")
        report["queries"][name] = {
            "pql": pql, "first_s": first_s, "answers": len(got.pairs),
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in before if kernels.LAUNCHES[k] != before[k]}}
    launches = dict(kernels.LAUNCHES)
    view = field.view()
    width = view.trimmed_words()
    pb = view._bank_cache.get(("pbank", 0, width))
    dense = [k for k, b in view._bank_cache.items()
             if isinstance(b, ViewBank) and b.array.shape[0] > 2]
    if not isinstance(pb, PositionsBank) or dense or (
            device != "cpu" and launches["pbank_membership_counts"] <= 0):
        raise AssertionError(f"fingerprint: the path did not take the "
                             f"positions bank (bank {type(pb).__name__}, "
                             f"dense banks {dense}, launches {launches})")
    report["segments"] = [
        {"layout": "fixed" if seg[2].dim() == 2 else "flat",
         "rows": seg[1], "shape": list(seg[2].shape), "positions": seg[4]}
        for seg in pb.segments]
    report["pbank_bytes"] = pb.nbytes
    report["cold_first_query_s"] = \
        report["queries"][FP_QUERIES[0][0]]["first_s"]
    for name, pql in FP_QUERIES:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            (got,) = ex.execute("mole", pql)
            times.append(time.perf_counter() - t0)
            if got.pairs != want[name]:
                raise AssertionError(f"fingerprint {name}: warm answer "
                                     "changed")
        times.sort()
        report["queries"][name]["p50_s"] = times[len(times) // 2]
        log(f"fingerprint: {name} first "
            f"{report['queries'][name]['first_s']:.4f} s, warm p50 "
            f"{times[len(times) // 2]:.6f} s, launches "
            f"{report['queries'][name]['launches']}, "
            f"{len(want[name])} answers")
    if device != "cpu" and profile:
        report["profile"] = profile_queries(torch, ex, "mole", FP_QUERIES,
                                            iters)
    # The Set: one new bit in the query molecule's row, in segment 0.
    qbits = set(pos[QUERY_MOL].tolist())
    col = next(c for c in range(FP_BITS) if c not in qbits)
    (changed,) = ex.execute("mole", f"Set({col}, fingerprint={QUERY_MOL})")
    if not changed:
        raise AssertionError("fingerprint: the Set changed nothing")
    t0 = time.perf_counter()
    pb2 = view.positions_bank(0, width)
    report["patch_s"] = time.perf_counter() - t0
    q_at = bisect.bisect_left(pb2.row_ids, QUERY_MOL)
    seg_of = next(i for i, seg in enumerate(pb2.segments)
                  if seg[0] <= q_at < seg[0] + seg[1])
    reused = [i for i, (a, b) in enumerate(zip(pb.segments, pb2.segments))
              if b[2] is a[2]]
    if len(pb2.segments) != len(pb.segments) or \
            reused != [i for i in range(len(pb.segments)) if i != seg_of]:
        raise AssertionError(f"fingerprint: the patch reused segments "
                             f"{reused} of {len(pb.segments)} (query in "
                             f"segment {seg_of})")
    want = fingerprint_expected(pos, extra_cols=(col,))
    for name, pql in FP_QUERIES:
        (got,) = ex.execute("mole", pql)
        if got.pairs != want[name]:
            raise AssertionError(f"fingerprint {name} after the Set: port "
                                 f"{got.pairs[:5]}... != numpy "
                                 f"{want[name][:5]}...")
    report["patched_segment"] = seg_of
    log(f"fingerprint: Set({col}) patched segment {seg_of} of "
        f"{len(pb2.segments)} in {report['patch_s']:.3f} s; all five "
        "answers exact after it")
    if device != "cpu":
        report["device_bytes"] = torch.cuda.max_memory_allocated()
    report["serve"], serve_launches = serve_fingerprint(
        holder, pos, col, want,
        {k: v["p50_s"] for k, v in report["queries"].items()}, iters)
    # The timing row's inputs, as the main path met them before the Set:
    # one fixed segment of the bank and the query's filter words at the
    # bank's width.
    seg = next(s[2] for s in pb.segments if s[2].dim() == 2)
    qpos = np.asarray(sorted(qbits), np.int16)
    timing_in = {
        "pos": seg,
        "filt": to_tensor(pack_positions(qpos.astype(np.uint64),
                                         width * 32), seg.device),
        "qpos": torch.from_numpy(qpos).to(seg.device)}
    del holder, ex, field, pos, pb, pb2
    return report, launches, timing_in, serve_launches


def check_pbank(torch, kernels, device):
    """pbank_membership_counts bit-exact against its plain version:
    fixed [65536, 48] rows of random lengths padded with 0xFFFF under a
    48-bit and a 1500-bit filter, fixed [1024, 128], flat with ragged
    lengths 0-200 over 10k rows; filters of W in {1, 128, 2047} words,
    with bits at word 2046. Returns the max |kernel - plain| (0)."""
    import numpy as np
    from pilosa_tpu_torch.ops.bitset import pack_positions, to_tensor
    rng = np.random.default_rng(17)

    def fixed(R, L, hi):
        pos = np.sort(rng.integers(0, hi, (R, L)), axis=1).astype(np.uint16)
        lens = rng.integers(0, L + 1, R)
        pos[np.arange(L)[None, :] >= lens[:, None]] = 0xFFFF
        return torch.from_numpy(pos.view(np.int16)).to(device), None

    def flat(R, max_len, hi):
        lens = rng.integers(0, max_len + 1, R)
        starts = np.zeros(R + 1, np.int32)
        np.cumsum(lens, out=starts[1:])
        buf = np.full(int(starts[-1]) + 4096, 0xFFFF, np.uint16)
        buf[:starts[-1]] = rng.integers(0, hi, int(starts[-1]))
        return (torch.from_numpy(buf.view(np.int16)).to(device),
                torch.from_numpy(starts).to(device))

    def filt(W, n_bits=None):
        if n_bits is None:
            words = rng.integers(0, 1 << 32, W, dtype=np.uint32)
        else:
            words = pack_positions(rng.choice(min(W * 32, FP_BITS), n_bits,
                                              replace=False), W * 32)
        if W == 2047:
            words[2046] |= np.uint32(0x80000001)
        return to_tensor(words, device)

    cases = [("fixed [65536, 48], 48-bit filter", fixed(65536, 48, FP_BITS),
              filt(128, 48)),
             ("fixed [65536, 48], 1500-bit filter",
              fixed(65536, 48, FP_BITS), filt(128, 1500))]
    for W in (1, 128, 2047):
        cases.append((f"fixed [1024, 128], W={W}", fixed(1024, 128, 65535),
                      filt(W)))
        cases.append((f"flat 10k rows of 0-200, W={W}",
                      flat(10_000, 200, 65535), filt(W)))
    for name, (pos, starts), fw in cases:
        got = kernels.pbank_membership_counts(pos, fw, starts)
        want = kernels.pbank_membership_counts_ref(pos, fw, starts)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or got.dtype != torch.int32 or \
                not torch.equal(got, want):
            raise AssertionError(f"pbank_membership_counts {name}: kernel "
                                 "differs from its plain version")
    log(f"kernels: pbank_membership_counts bit-exact over {len(cases)} "
        "cases")
    return 0


def time_pbank(torch, kernels, device, tin):
    """The membership kernel at the main path's shape (one fixed segment
    of the fingerprint bank, the query's filter): its C entry on a
    preallocated output, its byte bound, its plain version and
    torch.isin(pos, qpos).sum(1) — the nearest PyTorch expression, two
    calls — each held equal to the kernel."""
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    pos, filt, qpos = tin["pos"], tin["filt"], tin["qpos"]
    R, L = pos.shape
    out = torch.empty(R, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def kernel():
        return lib.pbank_membership_counts(pos.data_ptr(), None,
                                           filt.data_ptr(), out.data_ptr(),
                                           R, L, filt.numel(), stream)

    if kernel() != 0:
        raise RuntimeError("pbank_membership_counts: kernel launch failed")
    want = kernels.pbank_membership_counts_ref(pos, filt)
    lib_out = torch.isin(pos, qpos).sum(1, dtype=torch.int32)
    torch.cuda.synchronize()
    if not torch.equal(out, want) or not torch.equal(out, lib_out):
        raise AssertionError("pbank_membership_counts differs on the "
                             "fingerprint segment")
    ms = time_cuda(torch, kernel)
    plain_ms = time_cuda(torch, lambda: kernels.pbank_membership_counts_ref(
        pos, filt), iters=5, warmup=1)
    library_ms = time_cuda(torch, lambda: torch.isin(pos, qpos).sum(
        1, dtype=torch.int32))
    nbytes = R * L * 2 + filt.numel() * 4 + R * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing: pbank_membership_counts [{R},{L}] W={filt.numel()} kernel "
        f"{ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), plain "
        f"{plain_ms:.4f} ms, torch.isin + sum (two calls) "
        f"{library_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": library_ms, "shape": [R, L], "bound_bytes": nbytes}




def run_probe(device, n_rides, iters=PROBE_ITERS):
    """The taxi load and the burst alone, with whichever
    pilosa_tpu_torch is first on the path: the first burst must answer
    exactly in one launch with no fallback; then its warm p50, the
    device memory one warm burst allocates at its peak, its device time
    by kernel under torch.profiler, and, where the tree has the server,
    the burst over HTTP (``serve_burst``)."""
    import importlib.util
    import torch
    cab, pax, dist, amount = taxi_data(n_rides)
    want = burst_expected(cab, pax, dist, amount)
    holder, ex, load_s = load_taxi(device, cab, pax, dist, amount)
    del cab, pax, dist, amount
    reqs = [("taxi", pql, None) for _, pql in BURST]
    before = (ex.mega_launches, ex.mega_fallbacks, ex.mega_budget_fallbacks)
    burst_answers(ex.execute_batch(reqs), want)
    after = (ex.mega_launches, ex.mega_fallbacks, ex.mega_budget_fallbacks)
    if after != (before[0] + 1, before[1], before[2]):
        raise AssertionError(f"probe: megakernel launches/fallbacks/budget "
                             f"fallbacks {before} -> {after}")
    report = {"rides": n_rides, "load_s": load_s,
              "p50_s": burst_p50(ex, reqs, want, device, iters)}
    report.update(burst_peak(torch, ex, reqs, want))
    report["profile"] = profile_burst(torch, ex, reqs, iters)
    report["serve"] = None
    if importlib.util.find_spec("pilosa_tpu_torch.server") is not None:
        api, srv, base = start_server(holder)
        try:
            report["serve"] = serve_burst(api, base, want, iters)
        finally:
            stop_server(api, srv)
    del ex, holder
    return report


# --------------------------------------------------------------- serve

PAY_SEED = 17
PAY_ROWS = 5  # payment_type rows 0-4
SERVE_ROUNDS = 10  # concurrent 18-client rounds
CLI_COLUMNS = 200_000


def http(base, method, path, body=None, ctype=None, timeout=600):
    """(status, body bytes) of one request; an error status is returned,
    not raised."""
    import urllib.error
    import urllib.request
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    elif isinstance(body, str):
        body = body.encode()
    req = urllib.request.Request(
        base + path, data=body, method=method,
        headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_json(base, method, path, body=None, ctype=None):
    """The JSON answer of a request that must succeed."""
    status, raw = http(base, method, path, body, ctype)
    if status != 200:
        raise AssertionError(f"serve: {method} {path} answered {status}: "
                             f"{raw[:300]!r}")
    return json.loads(raw)


def start_server(holder):
    """The port's server over ``holder``: API, a coalescer at its
    default window, and the HTTP routes on a free loopback port.
    Returns (api, server, base URL)."""
    from pilosa_tpu_torch.server import API, serve
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    api = API(holder)
    api.coalescer = QueryCoalescer(api.executor)
    api.coalescer.start()
    srv = serve(api, "127.0.0.1", 0, background=True)
    return api, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def stop_server(api, srv):
    srv.shutdown()
    srv.server_close()
    api.coalescer.stop()


def p50(times):
    times = sorted(times)
    return times[len(times) // 2]


def http_p50(base, index, pql, want, iters):
    """Warm p50 (s) of one raw-PQL POST, each answer checked."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        got = http_json(base, "POST", f"/index/{index}/query", pql)
        times.append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"serve: {pql} warm answer changed")
    return p50(times)


def taxi_json(name, want):
    """A TAXI_QUERIES answer in the server's JSON form."""
    if name == "sum_filtered":
        return {"value": want[0], "count": want[1]}
    if name in ("topn", "topn_filtered"):
        return [{"id": r, "count": c} for r, c in want]
    return want


def burst_json(name, want):
    return {"columns": want} if isinstance(want, list) else want


def mega_state(ex):
    return (ex.mega_launches, ex.mega_fallbacks, ex.mega_budget_fallbacks)


def check_mega_taken(ex, before, what):
    """The executor's megakernel launched since ``before`` and took no
    fallback; returns the launches."""
    after = mega_state(ex)
    if after[0] <= before[0] or after[1:] != before[1:]:
        raise AssertionError(f"serve: {what}: megakernel launches/fallbacks"
                             f"/budget fallbacks {before} -> {after}")
    return after[0] - before[0]


def concurrent_round(base, reqs):
    """``reqs`` (name, PQL) POSTed together by one thread each, released
    by a barrier. Returns ({name: JSON answer}, seconds from the first
    send to the last answer)."""
    import threading
    barrier = threading.Barrier(len(reqs))
    out, errors, spans = {}, [], []

    def worker(name, pql):
        try:
            barrier.wait(timeout=60)
            t0 = time.perf_counter()
            out[name] = http_json(base, "POST", "/index/taxi/query", pql)
            spans.append((t0, time.perf_counter()))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=r) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: concurrent round failed: {errors}")
    return out, max(e for _, e in spans) - min(s for s, _ in spans)


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def serve_burst(api, base, want_burst, iters):
    """The burst over HTTP on a taxi server: as one /batch/query (warm
    p50) and as SERVE_ROUNDS rounds of one concurrent client a request,
    every answer exact, the megakernel launched with no fallback."""
    ex = api.executor
    want_items = [{"results": [burst_json(n, want_burst[n])]}
                  for n, _ in BURST]
    body = {"queries": [{"index": "taxi", "query": q} for _, q in BURST]}
    times = []
    for _ in range(iters):
        before = mega_state(ex)
        t0 = time.perf_counter()
        got = http_json(base, "POST", "/batch/query", body)
        times.append(time.perf_counter() - t0)
        if got["responses"] != want_items:
            raise AssertionError("serve: /batch/query burst != numpy")
        check_mega_taken(ex, before, "/batch/query")
    coal = api.coalescer
    c0 = dict(coal.counters)
    before = mega_state(ex)
    rounds = []
    for _ in range(SERVE_ROUNDS):
        out, dt = concurrent_round(base, BURST)
        rounds.append(dt)
        for (name, _), want in zip(BURST, want_items):
            if out[name] != want:
                raise AssertionError(f"serve: concurrent {name} != numpy")
    return {"batch_http_p50_s": p50(times), "concurrent": {
        "rounds": SERVE_ROUNDS, "clients": len(BURST),
        "round_p50_s": p50(rounds),
        "batches": coal.counters.get("batches", 0) - c0.get("batches", 0),
        "batched_requests": coal.counters.get("batched_requests", 0)
        - c0.get("batched_requests", 0),
        "pipelined": coal.counters.get("pipelined", 0)
        - c0.get("pipelined", 0),
        "mega_launches": check_mega_taken(ex, before, "concurrent rounds")}}


def serve_taxi(holder, want_taxi, want_burst, cab_head, in_process,
               iters=ITERS):
    """Phases 1-2 of the serve path on the loaded taxi holder: the five
    queries, the burst as one /batch/query and as concurrent rounds, then
    a new field written over HTTP (JSON and protobuf imports, one Set)
    and read back. Returns (report, launches)."""
    import numpy as np
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.executor.results import result_to_json
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import proto_compat
    api, srv, base = start_server(holder)
    ex = api.executor
    report = {}
    prev = megamod.MEGAKERNEL_ENABLED
    if holder.device.type == "cpu":
        # Rehearsal only: the megakernel defaults to off on the CPU.
        megamod.MEGAKERNEL_ENABLED = True
    try:
        kernels.reset_launches()
        # 1. schema, the five queries, the burst
        schema = http_json(base, "GET", "/schema")
        got = {f["name"]: f["options"] for i in schema["indexes"]
               if i["name"] == "taxi" for f in i["fields"]}
        for name, typ, lo, hi in (("cab_type", "set", 0, 0),
                                  ("passenger_count", "set", 0, 0),
                                  ("dist", "int", 0, 300),
                                  ("amount", "int", 0, 1000)):
            o = got.get(name, {})
            if (o.get("type"), o.get("min"), o.get("max")) != (typ, lo, hi):
                raise AssertionError(f"serve: /schema lists {name} as {o}")
        report["taxi_http_p50_s"] = {}
        for name, pql in TAXI_QUERIES:
            want = taxi_json(name, want_taxi[name])
            resp = http_json(base, "POST", "/index/taxi/query", pql)
            direct = [result_to_json(r) for r in ex.execute("taxi", pql)]
            if resp["results"] != [want] or direct != [want]:
                raise AssertionError(f"serve: {name}: HTTP {resp}, "
                                     f"in-process {direct}, numpy {want}")
            report["taxi_http_p50_s"][name] = http_p50(
                base, "taxi", pql, resp, iters)
        report["taxi_in_process_p50_s"] = in_process["taxi"]
        report.update(serve_burst(api, base, want_burst, iters))
        report["burst_in_process_p50_s"] = in_process["burst"]
        # Where a lone request's HTTP time goes: the round trip with no
        # work, and the same query with the coalescer detached.
        report["http_floor_p50_s"] = p50(
            [timed(lambda: http_json(base, "GET", "/version"))
             for _ in range(iters)])
        name, pql = TAXI_QUERIES[0]
        coal, api.coalescer = api.coalescer, None
        report["direct_http_p50_s"] = {name: http_p50(
            base, "taxi", pql, {"results": [taxi_json(name, want_taxi[name])]},
            iters)}
        api.coalescer = coal
        log(f"serve: taxi over HTTP exact; /batch/query p50 "
            f"{report['batch_http_p50_s']:.6f} s; {SERVE_ROUNDS} rounds of "
            f"{len(BURST)} concurrent clients p50 "
            f"{report['concurrent']['round_p50_s']:.6f} s in "
            f"{report['concurrent']['batches']} batches, "
            f"{report['concurrent']['mega_launches']} mega launches")
        # 2. writes: a new set field, one shard by JSON, one by protobuf
        http_json(base, "POST", "/index/taxi/field/payment_type", {})
        pay = np.random.default_rng(PAY_SEED).integers(
            0, PAY_ROWS, 2 * SHARD_WIDTH).astype(np.uint64)
        cols = np.arange(2 * SHARD_WIDTH, dtype=np.uint64)
        t0 = time.perf_counter()
        http_json(base, "POST", "/index/taxi/field/payment_type/import",
                  {"rowIDs": pay[:SHARD_WIDTH].tolist(),
                   "columnIDs": cols[:SHARD_WIDTH].tolist()})
        report["import_json_s"] = time.perf_counter() - t0
        msg = (proto_compat._str_field(1, "taxi")
               + proto_compat._str_field(2, "payment_type")
               + proto_compat._packed_uint64(4, pay[SHARD_WIDTH:].tolist())
               + proto_compat._packed_uint64(5, cols[SHARD_WIDTH:].tolist()))
        t0 = time.perf_counter()
        http_json(base, "POST", "/index/taxi/field/payment_type/import",
                  msg, proto_compat.CONTENT_TYPE)
        report["import_proto_s"] = time.perf_counter() - t0
        report["import_bits_per_request"] = SHARD_WIDTH
        set_col = int(np.flatnonzero(pay[:SHARD_WIDTH] != 2)[0])
        got = http_json(base, "POST", "/index/taxi/query",
                        f"Set({set_col}, payment_type=2)")
        if got != {"results": [True]}:
            raise AssertionError(f"serve: the Set answered {got}")
        # A set field keeps the column's old row: the Set adds one bit.
        counts = np.bincount(pay.astype(np.int64), minlength=PAY_ROWS)
        counts[2] += 1
        want_top = sorted(((int(c), r) for r, c in enumerate(counts)),
                          key=lambda x: (-x[0], x[1]))
        row2 = np.flatnonzero(pay[:SHARD_WIDTH] == 2)
        row2 = np.sort(np.append(row2, set_col))
        checks = [
            ("TopN(payment_type)", "",
             [{"id": r, "count": c} for c, r in want_top]),
            ("Count(Intersect(Row(payment_type=1), Row(cab_type=0)))", "",
             int(((pay == 1) & (cab_head == 0)).sum())),
            ("Row(payment_type=2)", "?shards=0",
             {"columns": row2.tolist()})]
        for pql, args, want in checks:
            got = http_json(base, "POST", f"/index/taxi/query{args}", pql)
            if got != {"results": [want]}:
                raise AssertionError(f"serve: after the imports {pql} != "
                                     "numpy")
        log(f"serve: imports of {SHARD_WIDTH} bits: JSON "
            f"{report['import_json_s']:.3f} s, protobuf "
            f"{report['import_proto_s']:.3f} s; the reads after them exact")
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
        stop_server(api, srv)
    launches = dict(kernels.LAUNCHES)
    return report, launches


def serve_fingerprint(holder, pos, col, want, in_process, iters=ITERS):
    """Phase 3 of the serve path on the loaded fingerprint holder (its
    query molecule already holds one Set bit, ``col``): the five queries
    over HTTP (the first also as a protobuf QueryRequest), a second Set
    through the query route, and the five again, all exact against
    numpy through the positions bank. Returns (report, launches)."""
    from pilosa_tpu_torch.core.view import PositionsBank, ViewBank
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import proto_compat
    api, srv, base = start_server(holder)
    report = {"fp_http_p50_s": {}, "fp_in_process_p50_s": in_process}
    try:
        kernels.reset_launches()

        def check_all(want, timed):
            for i, (name, pql) in enumerate(FP_QUERIES):
                pairs = [{"id": r, "count": c} for r, c in want[name]]
                got = http_json(base, "POST", "/index/mole/query", pql)
                if got != {"results": [pairs]}:
                    raise AssertionError(f"serve: fingerprint {name} != "
                                         "numpy")
                if i == 0:
                    status, raw = http(
                        base, "POST", "/index/mole/query",
                        proto_compat._str_field(1, pql),
                        proto_compat.CONTENT_TYPE)
                    if status != 200 or raw != \
                            proto_compat.encode_query_response([pairs]):
                        raise AssertionError(f"serve: protobuf {name} != "
                                             "numpy")
                if timed:
                    report["fp_http_p50_s"][name] = http_p50(
                        base, "mole", pql, got, iters)

        check_all(want, True)
        qbits = set(pos[QUERY_MOL].tolist())
        col2 = next(c for c in range(FP_BITS)
                    if c not in qbits and c != col)
        got = http_json(base, "POST", "/index/mole/query",
                        f"Set({col2}, fingerprint={QUERY_MOL})")
        if got != {"results": [True]}:
            raise AssertionError(f"serve: the fingerprint Set answered {got}")
        check_all(fingerprint_expected(pos, extra_cols=(col, col2)), False)
    finally:
        stop_server(api, srv)
    launches = dict(kernels.LAUNCHES)
    view = holder.index("mole").field("fingerprint").view()
    banks = list(view._bank_cache.values())
    dense = [b.array.shape for b in banks
             if isinstance(b, ViewBank) and b.array.shape[0] > 2]
    if not any(isinstance(b, PositionsBank) for b in banks) or dense:
        raise AssertionError(f"serve: the fingerprint queries left the "
                             f"positions bank (dense banks {dense})")
    log("serve: fingerprint queries over HTTP exact before and after a "
        "Set through the query route, through the positions bank")
    return report, launches


def serve_cli(device):
    """Phase 4: ``python -m pilosa_tpu_torch.cli server`` as a
    subprocess on a free port; an index with a set and an int field made
    and imported over HTTP, then Count, TopN and Sum checked exactly.
    Returns the seconds from the start to the first answer."""
    import queue
    import signal
    import threading
    import numpy as np
    cmd = [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
           "--bind", "127.0.0.1:0"]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    report = {}
    try:
        first = lines.get(timeout=300)
        if "listening on " not in first:
            raise AssertionError(f"serve: the CLI server printed {first!r}")
        base = first.split("listening on ")[1].split()[0]
        rng = np.random.default_rng(29)
        cols = np.arange(CLI_COLUMNS, dtype=np.int64) * 20
        rows = rng.integers(0, 4, CLI_COLUMNS)
        vals = rng.integers(0, 1001, CLI_COLUMNS)
        for path, body in (
                ("/index/cli", {}), ("/index/cli/field/f", {}),
                ("/index/cli/field/v",
                 {"options": {"type": "int", "min": 0, "max": 1000}}),
                ("/index/cli/field/f/import",
                 {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}),
                ("/index/cli/field/v/import",
                 {"columnIDs": cols.tolist(), "values": vals.tolist()})):
            http_json(base, "POST", path, body)
        got = http_json(base, "POST", "/index/cli/query",
                        "Count(Row(f=1)) TopN(f, n=2) "
                        "Sum(Row(f=3), field=v)")
        report["start_to_first_answer_s"] = time.perf_counter() - t0
        counts = sorted(((int((rows == r).sum()), r) for r in range(4)),
                        key=lambda x: (-x[0], x[1]))
        want = [int((rows == 1).sum()),
                [{"id": r, "count": c} for c, r in counts[:2]],
                {"value": int(vals[rows == 3].sum()),
                 "count": int((rows == 3).sum())}]
        if got != {"results": want}:
            raise AssertionError(f"serve: the CLI server answered {got}, "
                                 f"numpy {want}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    if rc != 0:
        raise AssertionError(f"serve: the CLI server exited {rc}")
    log(f"serve: the CLI server answered Count, TopN and Sum exactly, "
        f"{report['start_to_first_answer_s']:.2f} s after its start")
    return report


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the warm taxi and fingerprint queries "
                         "and the burst with torch.profiler (device time, "
                         "busy share)")
    ap.add_argument("--report", metavar="PATH",
                    help="write the full taxi, burst, fingerprint and "
                         "timing report as JSON")
    ap.add_argument("--molecules", type=int, default=N_MOLECULES,
                    help="molecules in the fingerprint index (default "
                         "%(default)s)")
    ap.add_argument("--burst-probe", action="store_true",
                    help="run only the taxi load and the burst and print "
                         "one probe line (p50, peak memory, device time)")
    ap.add_argument("--tree", metavar="DIR", default=REPO,
                    help="with --burst-probe: the checkout whose "
                         "pilosa_tpu_torch runs (default: this script's)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    tree = os.path.abspath(args.tree if args.burst_probe else REPO)
    if not os.path.isdir(os.path.join(tree, "pilosa_tpu_torch")):
        log(f"chip_smoke: pilosa_tpu_torch/ not found in {tree}")
        return 1
    sys.path.insert(0, tree)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    if args.burst_probe:
        from pilosa_tpu_torch.ops import build
        build.build()
        card = card_line()
        print(card, flush=True)
        probe = run_probe("cuda", N_RIDES)
        print(json.dumps({"probe": {"tree": tree, "card": card, **probe}}),
              flush=True)
        return 0

    # 1. build
    from pilosa_tpu_torch.ops import build, kernels
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    log(f"build: {build.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s")
    card = card_line()
    log(f"card: {card}")

    # 2. kernels
    errs = check_kernels(torch, kernels, device)
    errs["mega_interpret"] = check_mega(torch, kernels, device)
    errs["pbank_membership_counts"] = check_pbank(torch, kernels, device)
    n_shards = (N_RIDES + SHARD_WIDTH - 1) // SHARD_WIDTH
    timing = time_kernels(torch, kernels, device, n_shards)
    log("timing: torch has no single popcount call, so there is no "
        "library yardstick (library_ms null)")

    # 3-4, 6. the taxi paths: queries one at a time, the burst, and the
    # serve path's taxi phases
    report, taxi_launches, burst_launches, serve_launches = run_main(
        "cuda", N_RIDES, ITERS, profile=args.profile)
    torch.cuda.empty_cache()
    # 5-6. the fingerprint path and the serve path's fingerprint phase
    torch.cuda.reset_peak_memory_stats()
    fp, fp_launches, timing_in, serve_fp_launches = run_fingerprint(
        "cuda", args.molecules, profile=args.profile)
    timing["pbank_membership_counts"] = time_pbank(torch, kernels, device,
                                                   timing_in)
    del timing_in
    # 6. the serve path's CLI phase
    cli = serve_cli("cuda")
    launches = {name: taxi_launches[name] for name in (
        "bank_row_counts", "bank_row_counts_masked", "bsi_plane_counts")}
    launches["mega_interpret"] = burst_launches["mega_interpret"]
    launches["pbank_membership_counts"] = \
        fp_launches["pbank_membership_counts"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on its "
                                 "path")
    # The serve path runs every kernel: the sweeps and the interpreter
    # on the taxi server, the membership kernel on the fingerprint one.
    serve_counts = {name: serve_launches[name] for name in (
        "bank_row_counts", "bank_row_counts_masked", "bsi_plane_counts",
        "mega_interpret")}
    serve_counts["pbank_membership_counts"] = \
        serve_fp_launches["pbank_membership_counts"]
    for name, n in serve_counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "serve path")
    burst = report["burst"]
    timing["mega_interpret"] = {"ms": burst["kernel_ms"],
                                "plain_ms": burst["plain_ms"],
                                "bound_ms": burst["bound_ms"]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "report": report, "fingerprint": fp,
                       "cli": cli, "timing": timing}, f, indent=1)
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
        "first_s", "kernel_ms", "plain_ms", "bound_ms", "smem_bound_ms",
        "tile_cols", "smem_bytes_per_block", "blocks", "burst_peak_bytes",
        "n_slots", "n_regs", "n_instrs", "instr_capacity", "count_lanes",
        "row_lanes", "launches")}}), flush=True)
    queries = fp["queries"]
    print(json.dumps({"tanimoto": {
        "molecules": fp["molecules"], "load_s": fp["load_s"],
        "cold_first_query_s": fp["cold_first_query_s"],
        "p50_s": {k: v["p50_s"] for k, v in queries.items()},
        "launches": {k: v["launches"] for k, v in queries.items()},
        "answers": {k: v["answers"] for k, v in queries.items()},
        "segments": fp["segments"], "pbank_bytes": fp["pbank_bytes"],
        "device_bytes": fp["device_bytes"], "patch_s": fp["patch_s"],
        "patched_segment": fp["patched_segment"]}}), flush=True)
    serve, serve_fp = report["serve"], fp["serve"]
    print(json.dumps({"serve": {
        "taxi_http_p50_s": serve["taxi_http_p50_s"],
        "taxi_in_process_p50_s": serve["taxi_in_process_p50_s"],
        "http_floor_p50_s": serve["http_floor_p50_s"],
        "direct_http_p50_s": serve["direct_http_p50_s"],
        "batch_http_p50_s": serve["batch_http_p50_s"],
        "burst_in_process_p50_s": serve["burst_in_process_p50_s"],
        "concurrent": serve["concurrent"],
        "import_json_s": serve["import_json_s"],
        "import_proto_s": serve["import_proto_s"],
        "import_bits_per_request": serve["import_bits_per_request"],
        "fp_http_p50_s": serve_fp["fp_http_p50_s"],
        "fp_in_process_p50_s": serve_fp["fp_in_process_p50_s"],
        "cli_start_to_first_answer_s": cli["start_to_first_answer_s"],
        "launches": serve_counts}}), flush=True)
    print(card, flush=True)

    # 7. kernels line, then the result line
    rows = []
    for name in kernels.LAUNCHES:
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": "bytes",
                     "library_ms": t.get("library_ms")})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
