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
   its main-path shape, between events and back to back in a CUDA graph,
   beside its bound and its plain version. Hold
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
   2047}. Hold ``expand_positions`` bit-exact against its plain version
   at the 10M SparseBank's shape (S = 1, width 128, 65 slots with the
   zero slot and empty rows), on a 96-shard bank of width 2048, at a
   row of exactly one shared-memory tile and one word over, at S * W
   not a multiple of 4, with positions past the width, a garbage pad
   tail, the sparse upload's [cap, 1, W] form, n = 0, every slot
   transport (a range, the launch's parameters, pinned memory), and
   shuffled and repeated positions; and ``mega_interpret`` with expand
   registers (a
   sparse bank's rows moved into scratch by OP_EXPAND, then every
   opcode) against its plain version extended with the sparse banks.
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
   measure: on the same holder, through the port's server (an ``API``
   with an in-memory stats client and a span recorder, a coalescer, the
   HTTP routes): with the profiler's sampling off, the five queries and
   the burst take no ``_fence_device`` call, and one burst's whole
   launch (cost attribution and timeline events included) runs under
   ``set_sync_debug_mode("error")``; the roofline resolves this card's
   name, not estimated; ``?profile=true`` on the queries and on
   ``/batch/query`` gives every eval a device time, and the burst's
   ``launchBytes`` equals ``plan_cost`` of its plan; with sampling at 1,
   20 bursts, whose launch's device time must be at least 0.8 x the
   event-timed kernel on the same plan and at most the burst's wall;
   ``/metrics`` parses with the executor, roofline, idle-ratio and
   memory families and ``pilosa_roofline_gbps`` is the resolved figure;
   ``/debug/timeline`` is trace-event JSON with device slices; then the
   burst's p50 with the roofline and timeline recorders on and off, in
   turns (recorded, not asserted). No plain version may run; the sweeps
   and the interpreter must launch.
   serving (``run_serving``): on the same holder, the result cache, on
   by default in a new ``Executor``: the five queries as misses (the
   same kernels as the taxi phase launched, exact), then 200 hits and
   200 misses (the cache off) of each Count and of the burst's Row
   request in turns hit, miss, miss, hit (a Row answer timed to its
   columns, the copy a miss makes), every hit an eval-tier hit
   with no launch and no plain version, one more each under
   ``set_sync_debug_mode("error")``, each side's p50 with its p10 and
   p90 (``spread``); TopN and Sum move no cache counter. The burst
   misses in one ``mega_interpret`` launch, its repeat launches
   nothing (200 repeats timed), the miss overhead in 200 bursts a mode
   (every call a miss, the cache off, no identity walk) in turns A B C
   C B A; after a new ride's ``Set`` into
   cab_type=1 the burst relaunches once, for the twelve members that
   read cab_type, exact against numpy updated for the write (the ride
   is removed again after). ``execute_full`` twice is a request-tier
   hit, and a ``SetRowAttrs`` invalidates a Row answer embedding those
   attributes. Then the server ``cli server -c`` builds from
   ``SERVING_TOML`` over the holder: HTTP hit and miss (the cache off)
   p50s and spreads over 200 sequential requests a side in turns hit,
   miss, miss, hit, 200 reads
   of the burst's mix, ``/debug/hotspots`` (signatures, repeat ratios,
   ``estSavedS``, the result cache), ``/debug/history``,
   ``/debug/slo``, ``/internal/health``, the ``/metrics`` families, the
   shutdown's workload and sentinel dumps; and the CLI itself as a
   subprocess with that TOML, dumping both on SIGTERM. The
   ``result_cache`` ledger bytes are the caches' and within their
   budgets. Every earlier and later phase switches the cache off
   (``cache_off``, and ``PILOSA_TPU_RESULT_CACHE=0`` for the CLI
   subprocesses), so their timings and launch counts keep their meaning.
   cluster (``run_cluster``, right after serving): three nodes of a
   static cluster in this process on the one card (each its own
   ``Holder(device="cuda")``, ``API(cluster=...)`` with the result cache
   off, server on a free loopback port and heartbeat every 0.25 s),
   replica 2, loaded from the taxi holder as the reference client
   loads: each fragment's owners from node 0's
   ``/internal/fragment/nodes``, its ``write_bytes()`` POSTed to each
   owner's import-roaring route; each node must hold exactly the shards
   placement gives it and node 0's schema. The five taxi queries, the
   two-level GroupBy and the burst as one ``/batch/query`` through every
   node as coordinator, exact against numpy, TopN and GroupBy under the
   reference's merge (each leg's top-n summed in one pass, ties and
   groups ordered by ``str``, applied to numpy's per-leg counts); on
   the first pass through node 0, with the launch counts set to 0 just
   before, every sweep must launch on every node's leg (launches
   counted by the node whose request made them). p50 with p10-p90 of
   each read through node 0 (CLUSTER_SAMPLES requests) beside one node
   over HTTP in the same run; a ``?profile=true`` query must carry both
   remote nodes' fragments; a Set and a Clear through a node that does
   not own the column, read back from both owners with
   ``remote=true&shards=``. Then node 2's server stops: every read
   exact through node 0, node 2 marked down by the heartbeat within its
   window and sent no query RPC after, a Set read back from its live
   owner. Last, two ``cli server`` processes naming each other in
   ``cluster_peers`` (replica 2) answer a Count and a TopN over a
   4-shard index imported through the first one, exact, and exit 0 on
   SIGTERM. It prints a ``cluster`` line.
   groupby: on the same holder, through a new ``Executor``: four Rows
   queries (``previous``, ``limit``, ``column``) and five GroupBy
   queries (``GroupBy(Rows(passenger_count), Rows(cab_type))``, a
   ``filter=Row(dist > 100)`` one, its ``limit=5`` page and the page
   that resumes it with ``previous``, three levels), each exact against
   numpy, with its launches by kernel, its warm p50 and, for GroupBy,
   the device memory one warm call allocates at its peak; no plain
   version may run on that path. Then ``Store`` into a field it makes,
   ``Count``, ``ClearRow``, ``Count`` and ``Rows`` of it; TopN(cab_type)
   twice from the warm count caches (the first hit sweeps and
   compares); and a ``cacheType: "none"`` copy of cab_type imported
   shard by shard, whose TopN rebuilds, hits (with no sweep) and, after
   one Set, patches the device rank vector, then the hit's warm p50
   beside the sweep's.
   timefields: on the same holder, through a new ``Executor``: a time
   field ``pickup`` (quantum YMD, a January 2019 day for every ride),
   a mutex ``rate_code`` (rows 1-6, then 1M rides re-coded by a
   correction import with repeated columns) and a bool
   ``store_and_fwd`` (true for about 1 %) loaded through
   ``Field.import_bits`` one shard a call (``pickup``'s timestamps a
   list of datetimes, the form the API passes), each field's seconds
   printed; twelve reads (ranges of 7, 18 and one month view, Range,
   an Intersect, a filtered TopN, a Sum, Rows with from/to, mutex and
   bool rows, TopN(rate_code) from the warm count caches, a GroupBy)
   each exact against numpy with its launches by kernel and warm p50;
   a burst of twelve reads over 1-, 7- and 8-view ranges and mutex and
   bool rows in ONE megakernel launch with no fallback, and the same
   burst with an 18-view range, which must count one unlowered eval;
   a batch of two ranged reads over a period with no views, which must
   answer 0 and an empty row through the megakernel path with no kernel
   launch; the peak device memory of one warm ranged query; then a
   timestamped Set that makes a day view, a mutex Set that moves a
   ride, a Store into a time field and ClearRow on a time field and on
   the mutex field. No plain version may run on the card, in the
   reads or in the writes. Then row attributes on that holder: the TLC
   names of rate_code rows 1-6 and ``airport=true`` on 2 (JFK) and 3
   (Newark) through SetRowAttrs, ``TopN(rate_code, n=6, attrName="airport",
   attrValues=[true])`` exact at every ride, and a Row that carries the
   attributes.
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
   layout (``run_layout``, on that holder after its serve path): a burst
   of 68 reads (Count(Intersect) of the query molecule with 64
   candidates, the first 40 planted analogues among them, and Union,
   Difference, Xor and a row Union of those rows) through execute_batch
   in ONE launch over row-subset banks only (none over 2 x 65 rows);
   ``LayoutManager.demote`` of the view (the SparseBank's bytes,
   positions, build seconds and host peak beside the dense bank's bytes,
   the ledger's device bytes before and after); the burst again over
   the sparse layout, in ONE ``mega_interpret`` launch fed by
   ``expand_positions``, and once more with that launch (the
   expansion, the plan's upload and the interpreter) under
   ``set_sync_debug_mode("error")``: it must not synchronise the
   stream; the reads and the five queries one at a time, with no
   dense bank; a Set into a candidate row, after which the
   SparseBank rebuilds; ``relayout_once`` over a watermark just under
   the ledger's device bytes, then ``promote`` and a dense read; one
   admission over a budget set just under the resident total, which
   must evict the ranking's pick, keep the total within the budget and
   rebuild the evicted bank exactly on its next read. Every answer
   exact against numpy, no plain version on the card; then the
   expansion's time at the burst's shape, at the phase's largest
   sparse upload, at a 65,536-row upload chunk and at one row of a
   96-shard view, back to back in a CUDA graph and between events,
   beside an empty kernel's launch floor, its bound, its plain version
   and ``index_add_``.
6. serve: the port's HTTP server over the holders already loaded, each
   answer exact against numpy. On the taxi holder (``serve_taxi``): an
   ``API`` with a ``QueryCoalescer`` at its default window behind
   ``serve()`` on a free loopback port; ``GET /schema`` lists the taxi
   fields; the five taxi queries as raw-PQL POSTs (each response equal
   to the in-process answer too) and their warm HTTP p50s; one GroupBy
   and one Rows POST, equal to the groupby phase's answers; the burst as
   one ``POST /batch/query`` (warm p50) and as 18 concurrent POSTs
   released by a barrier, ten rounds, which must take megakernel
   launches with no fallback; then a ``set`` field made over HTTP, one
   shard of rides imported as JSON and one as a protobuf
   ``ImportRequest`` (seconds per request), one ``Set`` through the
   query route, and TopN, a Count(Intersect) and a ``?shards=0`` Row
   read back; then the timefields phase's ranged Count and mutex TopN,
   a time field made over HTTP with shard 0 imported as JSON with
   second timestamps and shard 1 as a protobuf ``ImportRequest`` with
   nanosecond timestamps, and a ranged Count over each shard exact
   against numpy. On the fingerprint holder (``serve_fingerprint``): the
   five queries over HTTP (the first also as a protobuf
   ``QueryRequest``), a second Set through the query route, the five
   again, still through the positions bank. Then ``python -m
   pilosa_tpu_torch.cli server`` as a subprocess (``serve_cli``): an
   index with a set and an int field made, imported and asked Count,
   TopN and Sum; the seconds from its start to the first answer.
7. keys: the star-trace getting-started index (``benches/startrace.py``,
   seed 3) with keys and attributes on a new holder: index
   ``repository`` (keys, existence) of 1,000,000 repositories with
   ``owner/name`` column keys; ``stargazer`` (keys) of 2,000 logins x
   2,000 stars drawn uniformly, 4,000,000 pairs imported through
   ``API.import_bits(row_keys=..., column_keys=...)`` in the bench's
   draw order; ``language`` (keys) of 40 languages with weights 1/rank;
   ``stars`` (int, log-normal, at most 500,000) through
   ``import_values(column_keys=...)``; row attributes on every user and
   language and column attributes on 100,000 repositories through PQL
   in requests of 1,000 calls (each field's seconds, the translation's
   share, the seconds per attribute call). Thirteen reads through
   ``execute_full`` (a keyed Row with its attributes, Count(Intersect),
   TopN, filtered and attribute-filtered TopN, columnAttrs,
   excludeColumns, excludeRowAttrs, Sum, a BSI Count, Rows, GroupBy, an
   unknown key, which allocates its id), each exact against numpy with
   its launches, warm p50 and device time; an 18-read keyed burst in ONE
   megakernel launch with no fallback; the serve path (the schema, the
   reads as JSON, ``?columnAttrs=true``, four as protobuf with keys and
   ColumnAttrSets, the burst as one ``/batch/query``, one 100,000-star
   slice imported with keys as JSON and as protobuf); then the writes: a
   keyed Set, SetRowAttrs after which the attribute-filtered TopN drops
   the user, SetColumnAttrs with a key, ClearRow and Store with key
   rows. No plain version may run on the card.
8. persist (``run_persist``, after the timefields phase and the row
   attributes, on a ``tempfile.mkdtemp()`` directory removed at the
   end): every view and shard of the taxi index's ``cab_type``,
   ``passenger_count``, ``dist``, ``amount``, ``_exists``, ``pickup``,
   ``rate_code`` and ``store_and_fwd`` goes into ``Holder(dir)``, each
   fragment's ``write_bytes()`` through ``API.import_roaring(view=)``
   (seconds, MB/s, bytes on disk); ``close()``, then a new
   ``Holder(dir)`` (open seconds, first-query seconds): the five taxi
   queries exact against numpy, TopN(passenger_count) a self-checked
   hit of the reloaded count caches and then a hit with no launch, the
   burst in ONE ``mega_interpret`` launch, the 7-view ranged Count and
   TopN(rate_code) equal to the in-memory holder's answers; then a Set,
   a Clear, a timestamped Set, a 1M-bit import of one shard and a Store
   (a snapshot a shard), the
   holder dropped without ``close()`` and the directory opened again:
   every write reads back and TopN(passenger_count) rebuilds its rank
   vector, no stale hit. Then ``python -m pilosa_tpu_torch.cli server
   --data-dir dir``: its start to the first answer (Count, TopN, Sum
   exact); a Set acknowledged, SIGKILL, a restart whose seconds to the
   Set read back are the time to recover; ``GET /export`` of one shard
   of cab_type exact; ``import-roaring`` of a shard as raw bytes and of
   another as a protobuf ``ImportRoaringRequest``, exact; SIGTERM, exit
   0; then ``GET /info`` of ``cli server --data-dir`` over a small
   directory whose op log lost its last bytes must carry the
   ``tailDroppedBytes`` of a holder reopened over a copy of it. After
   the keys phase (``persist_keys``): the keyed star-trace
   index at full size on a directory through ``load_keys``' API calls
   (load seconds beside the keys phase's), closed, reopened (open
   seconds), its thirteen reads equal to the keys phase's answers. Then
   (``persist_fingerprint``) a fingerprint index of 1M molecules
   (``PERSIST_MOLECULES``, cut from 10M; its TopN budgets cut to an
   eighth of its dense bank) written, closed, reopened, and its five
   queries exact through the positions bank. No plain version may run
   on the card; every kernel must launch on the persist path.

After every phase the memory ledger's bytes by category, the bank
budget's total, budget and evictions and the allocator's bytes are
logged; the ledger's device bytes may not exceed the allocator's.

Launch counts are set to 0 just before each path (taxi, burst,
groupby, timefields, persist, fingerprint, the layout's sparse steps,
keys, the serve path's taxi and fingerprint servers)
and read just after; every kernel must have launched on its path, and
on the serve and persist paths. The ``taxi``, ``groupby``,
``timefields``, ``burst``, ``tanimoto``, ``keys``, ``serve``,
``persist``, ``layout``, ``measure``, ``serving``, ``cluster`` and
``memory`` lines, the card's name
and power limit, the kernels JSON and the ``{"ok": true, "device":
{...}}`` line end the output. The script imports nothing of JAX or of the JAX
package.

``--burst-probe [--tree DIR]`` runs only the taxi load and the burst,
with the ``pilosa_tpu_torch`` package of DIR (default: beside this
script), and prints one ``probe`` JSON line: the burst's warm p50 (and
its ``spread`` over 200 more bursts), the
device memory one warm burst allocates at its peak, and its device time
by kernel under torch.profiler. Runs of two trees in turns compare them
on one card. ``--load-probe [--tree DIR]`` runs only the fingerprint
load (``--molecules``) with DIR's package and prints one ``probe`` line
with its seconds. ``--expand-probe [--tree DIR]`` runs only the
expansion's checks and timing rows with DIR's package and prints one
``probe`` line.
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
# A probe on another checkout (``--tree``), which may predate a module.
PROBE_TREE = False
SOURCES = {
    "bank_row_counts": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "bank_row_counts_masked": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "bsi_plane_counts": "pilosa_tpu_torch/csrc/bank_counts.cu",
    "mega_interpret": "pilosa_tpu_torch/csrc/mega_interpret.cu",
    "pbank_membership_counts": "pilosa_tpu_torch/csrc/pbank_membership.cu",
    "expand_positions": "pilosa_tpu_torch/csrc/sparse_expand.cu",
}
REPLACES = {
    "bank_row_counts": "pilosa_tpu/ops/pallas_kernels.py:143",
    "bank_row_counts_masked": "pilosa_tpu/ops/pallas_kernels.py:168",
    "bsi_plane_counts": "pilosa_tpu/ops/pallas_kernels.py:374",
    "mega_interpret": "pilosa_tpu/ops/pallas_kernels.py:337",
    "pbank_membership_counts": "pilosa_tpu/ops/pallas_kernels.py:250",
    # An XLA scatter in the JAX package, not a Pallas kernel.
    "expand_positions": "pilosa_tpu/ops/megakernel.py:106",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
SHARD_WIDTH = 1 << 20
WORDS = 32768
N_RIDES = 100_000_000  # 96 shards
ITERS = 5  # warm runs per taxi query for the p50
PROBE_ITERS = 21  # warm bursts for the p50 of --burst-probe
# Sequential requests a side for each latency the serving phase reports
# (hit and miss, each miss-overhead mode), spread over turns against
# host drift.
SERVING_SAMPLES = 200
PROBE_SAMPLES = 200  # warm bursts for its spread, after them
# The cluster phase (run_cluster): nodes, replicas, requests a p50, the
# heartbeat's period, suspect count and probe timeout, the cab_type row
# its writes use (no ride has it), the CLI cluster's shards and seed.
CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
CLUSTER_SAMPLES = 50  # sequential requests a query for each p50
CLUSTER_HB_INTERVAL = 0.25  # heartbeat period (s)
CLUSTER_HB_SUSPECT = 2  # failed probes in a row that mark a node down
CLUSTER_HB_TIMEOUT = 2.0  # a probe's timeout (s)
CLUSTER_COL_ROW = 7  # a cab_type row no ride has: the phase's writes
CLUSTER_CLI_SHARDS = 4
CLUSTER_CLI_SEED = 29

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


def cache_off(obj):
    """Switch the result cache off on an Executor (or an API's): every
    phase before ``serving`` times warm repeats and counts launches,
    which the cache would answer instead. A probe's ``--tree`` from
    before the result cache has none to switch off. Returns ``obj``."""
    rc = getattr(getattr(obj, "executor", obj), "result_cache", None)
    if rc is not None or not PROBE_TREE:
        rc.enabled = False
    return obj


def cache_off_env():
    """The environment of a ``cli server`` subprocess of a phase before
    ``serving``: the result cache's kill switch set."""
    return {**os.environ, "PILOSA_TPU_RESULT_CACHE": "0"}


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


class NoStreamSync:
    """While active, a stream synchronisation PyTorch makes raises
    (``torch.cuda.set_sync_debug_mode("error")``). ``bites`` shows that
    it does for a blocking copy from pageable memory, the kind of copy
    the expansion and the plan upload no longer make."""

    def __init__(self, torch):
        self.torch = torch

    @staticmethod
    def bites(torch, device):
        try:
            with NoStreamSync(torch):
                torch.ones(4, dtype=torch.int32).to(device)
        except RuntimeError:
            return
        raise AssertionError("set_sync_debug_mode(\"error\") let a "
                             "blocking copy through")

    def __enter__(self):
        self.torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")


def time_graph(torch, fn, launches=100, iters=10):
    """Device ms of one ``fn(stream)`` when ``launches`` of them run back
    to back: captured into one CUDA graph, whose replay is timed by
    ``time_cuda``, divided by ``launches``. A launch-bound kernel reads
    here at what the card spends on it, not at the host's enqueue gap."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if fn(side.cuda_stream) not in (0, None):
            raise RuntimeError("time_graph: the launch failed")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(launches):
            if fn(stream) not in (0, None):
                raise RuntimeError("time_graph: a captured launch failed")
    ms = time_cuda(torch, graph.replay, iters=iters, warmup=2) / launches
    del graph
    return ms


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

    def record(name, R, extra_in, n_out, kernel_at, plain_fn):
        nbytes = (R * n + extra_in) * 4 + n_out * R * 4

        def kernel_fn():
            return kernel_at(stream)

        if kernel_fn() != 0:
            raise RuntimeError(f"{name}: kernel launch failed")
        ms = time_cuda(torch, kernel_fn)
        # Back to back: 100 launches in one CUDA graph, no host gap.
        graph_ms = time_graph(torch, kernel_at)
        plain_ms = time_cuda(torch, plain_fn, iters=5, warmup=1)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, shape=[R, S, W])
        log(f"timing: {name} [{R},{S},{W}] kernel {ms:.4f} ms between "
            f"events, {graph_ms:.4f} ms back to back, bound "
            f"{bound_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms")

    bank = random_bank(torch, (8, S, W), gen, device)
    o1 = torch.zeros(8, dtype=torch.int32, device=device)
    record("bank_row_counts", 8, 0, 1,
           lambda st: lib.bank_row_counts(bank.data_ptr(), o1.data_ptr(), 8,
                                          n, st),
           lambda: kernels.bank_row_counts_ref(bank))
    bank4 = bank[:4]
    filt = random_bank(torch, (S, W), gen, device)
    oi = torch.zeros(4, dtype=torch.int32, device=device)
    orw = torch.zeros_like(oi)
    record("bank_row_counts_masked", 4, n, 2,
           lambda st: lib.bank_row_counts_masked(
               bank4.data_ptr(), filt.data_ptr(), oi.data_ptr(),
               orw.data_ptr(), 4, n, st),
           lambda: kernels.bank_row_counts_masked_ref(bank4, filt))
    planes = random_bank(torch, (10, S, W), gen, device)
    op = torch.zeros(10, dtype=torch.int32, device=device)
    record("bsi_plane_counts", 10, n, 1,
           lambda st: lib.bsi_plane_counts(planes.data_ptr(),
                                           filt.data_ptr(), op.data_ptr(),
                                           10, n, st),
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
    return holder, cache_off(Executor(holder, device=device)), \
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


def run_main(device, n_rides, iters=ITERS, profile=False,
             samples=SERVING_SAMPLES, cluster_samples=CLUSTER_SAMPLES):
    """Load the taxi index, then drive five paths on it: the five taxi
    queries one at a time, the eighteen-request burst through
    execute_batch, the groupby phase (``run_groupby``), the timefields
    phase (``run_timefields``) and the row attributes on rate_code
    (``run_taxi_attrs``), the serving and cluster phases
    (``run_serving``, ``run_cluster``), and the serve path's phases 1-3
    over HTTP (``serve_taxi``). Returns (report, taxi
    launches, burst launches, groupby launches, serve launches). Raises
    on any wrong answer."""
    import numpy as np
    import torch
    cab, pax, dist, amount = taxi_data(n_rides)
    want_taxi = taxi_expected(cab, pax, dist, amount)
    want_burst = burst_expected(cab, pax, dist, amount)
    want_gb = groupby_expected(cab, pax, dist)
    # cab_type of the first two shards' columns (255: no ride), for the
    # serve path's writes.
    cab_head = np.full(2 * SHARD_WIDTH, 255, np.uint64)
    cab_head[:min(n_rides, 2 * SHARD_WIDTH)] = cab[:2 * SHARD_WIDTH]
    holder, ex, load_s = load_taxi(device, cab, pax, dist, amount)
    pax_counts = np.bincount(pax.astype(np.int64), minlength=7)
    wants_cluster = cluster_wants(cab, pax, dist, want_gb)
    del pax, dist
    log(f"taxi: loaded {n_rides} rides in {load_s:.2f} s")
    report = {"rides": n_rides,
              "shards": (n_rides + SHARD_WIDTH - 1) // SHARD_WIDTH,
              "load_s": load_s}
    report["taxi"], taxi_launches = run_taxi(ex, want_taxi, device, iters,
                                             profile)
    memory_line("taxi", device)
    report["burst"], burst_launches = run_burst(ex, want_burst, device,
                                                iters, profile)
    memory_line("burst", device)
    report["measure"], report["measure_launches"] = run_measure(
        holder, want_taxi, want_burst, report["burst"], device, iters)
    memory_line("measure", device)
    report["serving"] = run_serving(holder, device, want_taxi, want_burst,
                                    taxi_launches, n_rides, samples)
    memory_line("serving", device)
    report["cluster"] = run_cluster(holder, device, want_taxi, want_burst,
                                    wants_cluster, cluster_samples)
    report["cluster"]["memory"] = memory_line("cluster", device)
    if device != "cpu":
        report["device_bytes"] = max(torch.cuda.max_memory_allocated(),
                                     report["burst"]["peak_before_bytes"])
    report["groupby"], gb_launches = run_groupby(holder, device, cab,
                                                 want_gb, iters)
    memory_line("groupby", device)
    report["timefields"], tf_launches, tf_http = run_timefields(
        holder, device, cab, amount, iters)
    report["timefields"]["launches"] = tf_launches
    memory_line("timefields", device)
    report["taxi_attrs"] = run_taxi_attrs(holder, device,
                                          tf_http["topn_rate"][1], iters)
    memory_line("taxi_attrs", device)
    if device != "cpu":
        torch.cuda.empty_cache()
    report["persist"], report["persist"]["launches"] = run_persist(
        holder, device, cab, amount, pax_counts, want_taxi, want_burst,
        tf_http)
    memory_line("persist_taxi", device)
    del cab, amount
    report["serve"], serve_launches = serve_taxi(
        holder, want_taxi, want_burst, cab_head,
        {"taxi": {k: v["p50_s"] for k, v in report["taxi"].items()
                  if k != "profile"},
         "burst": report["burst"]["p50_s"],
         "groupby": report["groupby"]["http"],
         "timefields": tf_http}, iters)
    memory_line("serve_taxi", device)
    # Close, so the bank budget lets go of the holder's banks.
    holder.close()
    del ex, holder
    return report, taxi_launches, burst_launches, gb_launches, \
        serve_launches


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


# -------------------------------------------------------------- groupby

# The reference's taxi walkthrough (docs/examples.md:28) and the GroupBy
# of benches/taxi.py, with a filter, a page and its resumption, and three
# levels; name, PQL. The resumed page's PQL is made from the first
# page's last group.
GB_QUERIES = [
    ("pax_by_cab", "GroupBy(Rows(passenger_count), Rows(cab_type))"),
    ("cab_by_pax_dist_gt_100",
     "GroupBy(Rows(cab_type), Rows(passenger_count), filter=Row(dist > 100))"),
    ("page1", "GroupBy(Rows(cab_type), Rows(passenger_count), "
              "filter=Row(dist > 100), limit=5)"),
    ("cab_pax_cab",
     "GroupBy(Rows(cab_type), Rows(passenger_count), Rows(cab_type))"),
]
GB_PAGE2 = ("GroupBy(Rows(cab_type), Rows(passenger_count), "
            "filter=Row(dist > 100), limit=5, previous=[{}, {}])")
STORE = "Store(Intersect(Row(cab_type=1), Row(passenger_count=2)), cab_pax=1)"


def gb_ride(n_rides):
    """The ride of Rows(cab_type, column=C)."""
    return n_rides * 5 // 8 + 3


def rows_queries(n_rides):
    return [("rows_cab", "Rows(cab_type)"),
            ("rows_pax", "Rows(passenger_count)"),
            ("rows_pax_page", "Rows(passenger_count, previous=2, limit=3)"),
            ("rows_cab_ride", f"Rows(cab_type, column={gb_ride(n_rides)})")]


def groups_json(fields, counts):
    """GroupBy's JSON answer from {row-id tuple: count}: nonzero groups
    in ascending tuple order."""
    return [{"group": [{"field": f, "rowID": int(r)}
                       for f, r in zip(fields, tup)], "count": int(n)}
            for tup, n in sorted(counts.items()) if n]


def groupby_expected(cab, pax, dist):
    """Exact JSON answers of the groupby phase, recomputed with numpy."""
    import numpy as np
    n = len(cab)
    cab64, pax64 = cab.astype(np.int64), pax.astype(np.int64)
    want = {"rows_cab": {"rows": np.unique(cab64).tolist()},
            "rows_pax": {"rows": np.unique(pax64).tolist()}}
    want["rows_pax_page"] = {"rows": [p for p in want["rows_pax"]["rows"]
                                      if p > 2][:3]}
    want["rows_cab_ride"] = {"rows": [int(cab[gb_ride(n)])]}
    cp = cab64 * 7 + pax64
    both = np.bincount(cp, minlength=21)
    want["pax_by_cab"] = groups_json(
        ["passenger_count", "cab_type"],
        {(p, c): both[c * 7 + p] for c in range(3) for p in range(1, 7)})
    filt = np.bincount(cp[dist > 100], minlength=21)
    full = groups_json(
        ["cab_type", "passenger_count"],
        {(c, p): filt[c * 7 + p] for c in range(3) for p in range(1, 7)})
    want["cab_by_pax_dist_gt_100"] = full
    want["page1"], want["page2"] = full[:5], full[5:10]
    want["cab_pax_cab"] = groups_json(
        ["cab_type", "passenger_count", "cab_type"],
        {(c, p, c): both[c * 7 + p] for c in range(3) for p in range(1, 7)})
    want["cab1_pax2"] = int(both[1 * 7 + 2])
    counts = np.bincount(cab64, minlength=3)
    want["cab_counts"] = counts.tolist()
    want["topn_cab"] = [{"id": int(r), "count": int(counts[r])}
                        for r in sorted(range(3),
                                        key=lambda r: (-counts[r], r))]
    # The column of the phase's Set into cab_rank row 0: a ride of
    # another cab type.
    want["set_col"] = int(np.flatnonzero(cab[:1000] != 0)[0])
    return want


class RefCalls:
    """Counts calls of the kernels' plain versions while it is active:
    on a CUDA tensor the wrappers must never reach them."""

    NAMES = ("bank_row_counts_ref", "bank_row_counts_masked_ref",
             "bsi_plane_counts_ref", "mega_interpret_ref",
             "pbank_membership_counts_ref", "expand_positions_ref")

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {}
        self.saved = {}

    def __enter__(self):
        for name in self.NAMES:
            real = self.saved[name] = getattr(self.kernels, name)

            def counted(*a, _real=real, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _real(*a, **k)
            setattr(self.kernels, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.kernels, name, real)


def run_groupby(holder, device, cab, want, iters=ITERS):
    """The groupby phase on the loaded taxi holder, through a new
    Executor: Rows and GroupBy (each answer exact, its launches by
    kernel, then its warm p50 and, on the card, the device memory one
    warm call allocates at its peak); Store into a new field, Count,
    ClearRow, Count and Rows; TopN(cab_type) twice through the warm
    count caches (the first hit sweeps and compares); a cacheType none
    copy of cab_type imported shard by shard, and TopN over it cold
    (rebuild), warm (hit, no sweep) and after one Set (patch), then the
    hit's warm p50 beside the sweep's. Launch counts are 0 just before
    the first pass and read just after it. Returns (report, launches)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import Executor, FieldOptions
    from pilosa_tpu_torch.executor.results import result_to_json
    from pilosa_tpu_torch.ops import kernels
    cuda = device != "cpu"
    ex = cache_off(Executor(holder, device=device))
    n_rides = len(cab)

    def one(pql):
        (res,) = ex.execute("taxi", pql)
        return result_to_json(res)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check(name, pql, got, expect):
        if got != expect:
            raise AssertionError(f"groupby {name}: {pql}: port "
                                 f"{str(got)[:300]} != numpy "
                                 f"{str(expect)[:300]}")

    def launched(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        sync()
        return out, {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]}

    report = {"queries": {}}
    queries = rows_queries(n_rides) + GB_QUERIES
    kernels.reset_launches()
    with RefCalls(kernels) as refs:
        # 1. Rows and GroupBy
        for name, pql in queries + [("page2", None)]:
            if pql is None:
                last = want["page1"][-1]["group"]
                pql = GB_PAGE2.format(*(g["rowID"] for g in last))
            t0 = time.perf_counter()
            got, delta = launched(lambda: one(pql))
            check(name, pql, got, want[name])
            report["queries"][name] = {
                "pql": pql, "first_s": time.perf_counter() - t0,
                "launches": delta}
        # 2. writes into a field the phase makes
        t0 = time.perf_counter()
        got, delta = launched(lambda: one(STORE))
        check("store", STORE, got, True)
        report["store"] = {"s": time.perf_counter() - t0, "launches": delta}
        check("store", "Count(Row(cab_pax=1))", one("Count(Row(cab_pax=1))"),
              want["cab1_pax2"])
        t0 = time.perf_counter()
        check("clear_row", "ClearRow(cab_pax=1)", one("ClearRow(cab_pax=1)"),
              True)
        report["clear_row_s"] = time.perf_counter() - t0
        check("clear_row", "Count(Row(cab_pax=1))",
              one("Count(Row(cab_pax=1))"), 0)
        check("clear_row", "Rows(cab_pax)", one("Rows(cab_pax)"),
              {"rows": []})
        # 3. the warm count caches: the first hit sweeps and compares
        pql = "TopN(cab_type, n=3)"
        c0 = (ex.topn_cache_hits, ex.topn_selfchecks)
        first, d1 = launched(lambda: one(pql))
        second, d2 = launched(lambda: one(pql))
        check("topn_warm", pql, [first, second], [want["topn_cab"]] * 2)
        c1 = (ex.topn_cache_hits, ex.topn_selfchecks)
        if c1 != (c0[0] + 2, c0[1] + 1) or ex.topn_selfcheck_mismatches \
                or (cuda and not d1.get("bank_row_counts")) or d2:
            raise AssertionError(f"groupby: warm TopN hits/self-checks {c0}"
                                 f" -> {c1}, mismatches "
                                 f"{ex.topn_selfcheck_mismatches}, "
                                 f"launches {d1} then {d2}")
        report["topn_warm_launches"] = [d1, d2]
        # 4. the device rank vector of a field without a count cache
        idx = holder.index("taxi")
        rank = idx.create_field("cab_rank", FieldOptions(cache_type="none"))
        t0 = time.perf_counter()
        for c0_ in range(0, n_rides, SHARD_WIDTH):
            rank.import_bits(cab[c0_:c0_ + SHARD_WIDTH],
                             np.arange(c0_, min(c0_ + SHARD_WIDTH, n_rides),
                                       dtype=np.uint64))
        report["cab_rank_import_s"] = time.perf_counter() - t0
        pql = "TopN(cab_rank, n=3)"
        want_rank = want["topn_cab"]
        steps = {}

        def rank_state():
            return (ex.rank_cache_hits, ex.rank_cache_patches,
                    ex.rank_cache_rebuilds)

        for step in ("rebuild", "hit", "patch"):
            if step == "patch":
                set_pql = f"Set({want['set_col']}, cab_rank=0)"
                check("rank", set_pql, one(set_pql), True)
                counts = list(want["cab_counts"])
                counts[0] += 1
                want_rank = [{"id": r, "count": counts[r]} for r in sorted(
                    range(3), key=lambda r: (-counts[r], r))]
            r0 = rank_state()
            t0 = time.perf_counter()
            got, delta = launched(lambda: one(pql))
            dt = time.perf_counter() - t0
            check(f"rank {step}", pql, got, want_rank)
            moved = tuple(b - a for a, b in zip(r0, rank_state()))
            expect = {"hit": (1, 0, 0), "patch": (0, 1, 0),
                      "rebuild": (0, 0, 1)}[step]
            if moved != expect or (step == "hit"
                                   and "bank_row_counts" in delta):
                raise AssertionError(f"groupby: rank {step}: counters moved "
                                     f"{moved}, launches {delta}")
            steps[step] = {"s": dt, "launches": delta}
        report["rank_steps"] = steps
    launches = dict(kernels.LAUNCHES)
    if cuda:
        if refs.calls:
            raise AssertionError(f"groupby: plain versions called on the "
                                 f"card: {refs.calls}")
        for name in ("bank_row_counts", "bank_row_counts_masked"):
            if launches[name] <= 0:
                raise AssertionError(f"groupby: {name} never launched")
    report["ref_calls"] = refs.calls
    # 5. warm p50s, and each GroupBy's peak device memory
    for name, q in report["queries"].items():
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            got = one(q["pql"])
            sync()
            times.append(time.perf_counter() - t0)
            check(name, q["pql"], got, want[name])
        q["p50_s"] = p50(times)
        if cuda and q["pql"].startswith("GroupBy"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one(q["pql"])
            torch.cuda.synchronize()
            q["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    rank_p50 = {}
    for mode in ("hit", "sweep"):
        holder.rank_cache.enabled = mode == "hit"
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            got = one("TopN(cab_rank, n=3)")
            sync()
            times.append(time.perf_counter() - t0)
            check(f"rank {mode}", "TopN(cab_rank, n=3)", got, want_rank)
        rank_p50[mode] = p50(times)
    holder.rank_cache.enabled = True
    report["rank_p50_s"] = rank_p50
    if cuda:
        # Where GroupBy's time goes: device time by kernel and the busy
        # share over warm runs, beside a warm rank-vector hit.
        report["profile"] = profile_queries(
            torch, ex, "taxi",
            [(n, q["pql"]) for n, q in report["queries"].items()
             if q["pql"].startswith("GroupBy")]
            + [("rank_hit", "TopN(cab_rank, n=3)")], iters)
    report["http"] = {"groupby": (GB_QUERIES[0][1], want["pax_by_cab"]),
                      "rows": (rows_queries(n_rides)[3][1],
                               want["rows_cab_ride"])}
    log(f"groupby: exact; GroupBy warm p50 "
        + ", ".join(f"{n} {q['p50_s']:.6f} s" for n, q in
                    report["queries"].items() if n in dict(GB_QUERIES))
        + f"; cab_rank import {report['cab_rank_import_s']:.2f} s; rank "
        f"hit p50 {rank_p50['hit']:.6f} s, sweep {rank_p50['sweep']:.6f} s")
    return report, launches


# ----------------------------------------------------------- timefields

# The time, mutex and bool fields on the taxi index: every ride's pickup
# day (January 2019, uniform over days 1-28, the draw benches/taxi.py:
# 79-86 makes for the rides it stamps), the TLC trip record's RatecodeID
# (rows 1-6) and store_and_fwd_flag (true for about 1 % of rides). Drawn
# from a generator of their own, so the other phases' data stay as
# they were.
TIME_SEED = 19
TIME_DAYS = 28
RATE_FIX = 1_000_000  # rides re-coded by the correction import
# Pickup ranges [from, to) and the day views they cover: 1, 7 (the
# bench's query, benches/taxi.py:168-174), 8 (the most that lowers), 18
# (an eager union) and the month view.
R1 = ("2019-01-05", "2019-01-06")
R7 = ("2019-01-05", "2019-01-12")
R8 = ("2019-01-03", "2019-01-11")
R18 = ("2019-01-02", "2019-01-20")
RMONTH = ("2019-01-01", "2019-02-01")
RA = ("2019-01-01", "2019-01-03")
RB = ("2019-01-20", "2019-01-22")
RC = ("2019-01-14", "2019-01-21")
R_EMPTY = ("2019-03-01", "2019-03-15")  # no view: every ride is in January


def pickup(r, field="pickup", row=0):
    """PQL of row ``row`` of time field ``field`` over the range ``r``."""
    return f"Row({field}={row}, from='{r[0]}', to='{r[1]}')"


TF_QUERIES = [
    ("count_7", f"Count({pickup(R7)})"),
    ("count_18", f"Count({pickup(R18)})"),
    ("count_month", f"Count({pickup(RMONTH)})"),
    ("count_range_7", f"Count(Range(pickup=0, from='{R7[0]}', "
                      f"to='{R7[1]}'))"),
    ("count_7_cab1", f"Count(Intersect({pickup(R7)}, Row(cab_type=1)))"),
    ("topn_cab_7", f"TopN(cab_type, {pickup(R7)}, n=3)"),
    ("sum_amount_7", f"Sum({pickup(R7)}, field=amount)"),
    ("rows_pickup_7", f"Rows(pickup, from='{R7[0]}', to='{R7[1]}')"),
    ("count_rate3", "Count(Row(rate_code=3))"),
    ("topn_rate", "TopN(rate_code, n=6)"),
    ("count_sf", "Count(Row(store_and_fwd=true))"),
    ("rate_by_sf", "GroupBy(Rows(rate_code), Rows(store_and_fwd))"),
]

# A dashboard refresh over the new fields: 1-, 7- and 8-view ranges,
# mutex and bool rows; one megakernel launch. TF_BURST_WIDE adds the
# 18-view range, which does not lower.
TF_BURST = [
    ("b_count_1", f"Count({pickup(R1)})"),
    ("b_count_7", f"Count({pickup(R7)})"),
    ("b_count_8", f"Count({pickup(R8)})"),
    ("b_7_cab1", f"Count(Intersect({pickup(R7)}, Row(cab_type=1)))"),
    ("b_8_rate2", f"Count(Intersect({pickup(R8)}, Row(rate_code=2)))"),
    ("b_rate1", "Count(Row(rate_code=1))"),
    ("b_rate5", "Count(Row(rate_code=5))"),
    ("b_sf", "Count(Row(store_and_fwd=true))"),
    ("b_sf_rate1",
     "Count(Intersect(Row(store_and_fwd=true), Row(rate_code=1)))"),
    ("b_a_or_b", f"Count(Union({pickup(RA)}, {pickup(RB)}))"),
    ("b_month_minus_7", f"Count(Difference({pickup(RMONTH)}, {pickup(R7)}))"),
    ("b_c_nosf_cab2", f"Count(Intersect({pickup(RC)}, "
                      "Row(store_and_fwd=false), Row(cab_type=2)))"),
]
TF_BURST_WIDE = TF_BURST + [("b_count_18", f"Count({pickup(R18)})")]


def time_data(n_rides):
    """(day index 0-27, rate code 1-6 after the correction import, the
    correction's columns and rows, store_and_fwd) from TIME_SEED. The
    correction draws columns with repeats; the last pair of a column
    wins, as the mutex import resolves it."""
    import numpy as np
    rng = np.random.default_rng(TIME_SEED)
    day = rng.integers(0, TIME_DAYS, n_rides, dtype=np.int8)
    rate0 = rng.integers(1, 7, n_rides, dtype=np.uint8)
    sf = rng.integers(0, 100, n_rides, dtype=np.int8) == 0
    n_fix = min(RATE_FIX, n_rides)
    fix_cols = rng.integers(0, n_rides, n_fix).astype(np.uint64)
    fix_rows = rng.integers(1, 7, n_fix).astype(np.uint64)
    rate = rate0.copy()
    _, last = np.unique(fix_cols[::-1], return_index=True)
    keep = n_fix - 1 - last
    rate[fix_cols[keep].astype(np.int64)] = fix_rows[keep]
    return day, rate0, rate, fix_cols, fix_rows, sf


def day_index(date):
    """Day index of a range bound in January 2019 (Feb 1 is 31)."""
    y, m, d = (int(x) for x in date.split("-"))
    return 31 if (y, m) == (2019, 2) else d - 1


def timefields_expected(cab, amount, day, rate, sf):
    """Exact JSON answers of TF_QUERIES and TF_BURST_WIDE, from numpy."""
    import numpy as np
    per_day = np.bincount(day, minlength=TIME_DAYS)
    day_cab = np.bincount(day.astype(np.int64) * 3 + cab.astype(np.int64),
                          minlength=3 * TIME_DAYS).reshape(TIME_DAYS, 3)
    day_rate = np.bincount(day.astype(np.int64) * 7 + rate,
                           minlength=7 * TIME_DAYS).reshape(TIME_DAYS, 7)
    key = (day.astype(np.int64) * 3 + cab.astype(np.int64)) * 2 + sf
    day_cab_sf = np.bincount(key, minlength=6 * TIME_DAYS).reshape(
        TIME_DAYS, 3, 2)

    def span(r):
        return slice(day_index(r[0]), min(day_index(r[1]), TIME_DAYS))

    def count(r):
        return int(per_day[span(r)].sum())

    rate_counts = np.bincount(rate, minlength=7)
    want = {"count_7": count(R7), "count_18": count(R18),
            "count_month": count(RMONTH), "count_range_7": count(R7),
            "count_7_cab1": int(day_cab[span(R7), 1].sum()),
            "rows_pickup_7": {"rows": [0]},
            "count_rate3": int(rate_counts[3]),
            "count_sf": int(sf.sum())}
    cabs = day_cab[span(R7)].sum(axis=0)
    want["topn_cab_7"] = [{"id": int(c), "count": int(cabs[c])} for c in
                          sorted(range(3), key=lambda c: (-cabs[c], c))
                          if cabs[c]]
    m7 = (day >= day_index(R7[0])) & (day < day_index(R7[1]))
    want["sum_amount_7"] = {"value": int(amount[m7].sum()),
                            "count": int(m7.sum())}
    del m7
    want["topn_rate"] = [{"id": r, "count": int(rate_counts[r])} for r in
                         sorted(range(1, 7),
                                key=lambda r: (-rate_counts[r], r))]
    both = np.bincount(rate.astype(np.int64) * 2 + sf, minlength=14)
    want["rate_by_sf"] = groups_json(
        ["rate_code", "store_and_fwd"],
        {(r, s): both[r * 2 + s] for r in range(1, 7) for s in (0, 1)})
    want["b_count_1"] = count(R1)
    want["b_count_7"] = count(R7)
    want["b_count_8"] = count(R8)
    want["b_7_cab1"] = want["count_7_cab1"]
    want["b_8_rate2"] = int(day_rate[span(R8), 2].sum())
    want["b_rate1"] = int(rate_counts[1])
    want["b_rate5"] = int(rate_counts[5])
    want["b_sf"] = want["count_sf"]
    want["b_sf_rate1"] = int(np.bincount(rate[sf], minlength=7)[1])
    want["b_a_or_b"] = count(RA) + count(RB)
    want["b_month_minus_7"] = count(RMONTH) - count(R7)
    want["b_c_nosf_cab2"] = int(day_cab_sf[span(RC), 2, 0].sum())
    want["b_count_18"] = count(R18)
    want["rate_counts"] = rate_counts
    return want


def day_times(day):
    """The pickup timestamps of ``day`` (indexes from 2019-01-01) as the
    list of datetimes ``Field.import_bits`` takes."""
    import numpy as np
    return (np.datetime64("2019-01-01", "D") + day.astype("timedelta64[D]")
            ).astype("datetime64[us]").tolist()


def load_timefields(holder, day, rate0, fix_cols, fix_rows, sf):
    """The three fields through ``Field.import_bits``, one shard a call
    (pickup with a list of datetimes, one a ride, made inside the timed
    loop), then the correction import of rate_code in one call across
    every shard. Returns the seconds of each."""
    import numpy as np
    from pilosa_tpu_torch import FieldOptions
    idx = holder.index("taxi")
    n = len(day)
    secs = {}
    fields = {"pickup": FieldOptions(type="time", time_quantum="YMD"),
              "rate_code": FieldOptions(type="mutex"),
              "store_and_fwd": FieldOptions(type="bool")}
    for name, opts in fields.items():
        f = idx.create_field(name, opts)
        t0 = time.perf_counter()
        for c0 in range(0, n, SHARD_WIDTH):
            c1 = min(c0 + SHARD_WIDTH, n)
            cols = np.arange(c0, c1, dtype=np.uint64)
            if name == "pickup":
                f.import_bits(np.zeros(c1 - c0, np.uint64), cols,
                              timestamps=day_times(day[c0:c1]))
            elif name == "rate_code":
                f.import_bits(rate0[c0:c1].astype(np.uint64), cols)
            else:
                f.import_bits(sf[c0:c1].astype(np.uint64), cols)
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.field("rate_code").import_bits(fix_rows, fix_cols)
    secs["rate_code_correction"] = time.perf_counter() - t0
    return secs


def run_timefields(holder, device, cab, amount, iters=ITERS):
    """The timefields phase on the loaded taxi holder, through a new
    Executor: load pickup, rate_code and store_and_fwd at every ride and
    re-code RATE_FIX rides; then TF_QUERIES one at a time (each exact,
    its launches by kernel; TopN(rate_code) once more from the warm
    count caches with no launch), the burst in ONE mega_interpret launch
    with no fallback, and the burst with an 18-view range, which must
    count one unlowered eval; warm p50s and the peak device memory of
    one warm ranged query; then the writes: a timestamped Set that makes
    a day view, a mutex Set that moves a ride, a Store into a time field
    and ClearRow on a time field and on the mutex field. Launch counts
    are 0 just before the reads and read just after the second burst;
    no plain version may run on the card. Returns (report, launches,
    what the serve path reads back over HTTP)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import Executor, FieldOptions
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.executor.results import result_to_json
    from pilosa_tpu_torch.ops import kernels
    cuda = device != "cpu"
    n_rides = len(cab)
    day, rate0, rate, fix_cols, fix_rows, sf = time_data(n_rides)
    want = timefields_expected(cab, amount, day, rate, sf)
    load_s = load_timefields(holder, day, rate0, fix_cols, fix_rows, sf)
    del rate0, fix_cols, fix_rows
    log("timefields: loaded pickup, rate_code and store_and_fwd at "
        f"{n_rides} rides: " + ", ".join(f"{k} {v:.2f} s"
                                          for k, v in load_s.items()))
    ex = cache_off(Executor(holder, device=device))

    def one(pql):
        (res,) = ex.execute("taxi", pql)
        return result_to_json(res)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check(name, pql, got, expect):
        if got != expect:
            raise AssertionError(f"timefields {name}: {pql}: port "
                                 f"{str(got)[:300]} != numpy "
                                 f"{str(expect)[:300]}")

    def launched(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        sync()
        return out, {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]}

    def mega():
        return (ex.mega_launches, ex.mega_fallbacks,
                ex.mega_budget_fallbacks, ex.mega_unlowered)

    def batch(burst):
        out = ex.execute_batch([("taxi", q, None) for _, q in burst])
        sync()
        for (name, pql), item in zip(burst, out):
            if isinstance(item, Exception):
                raise AssertionError(f"timefields {name}: {pql} raised "
                                     f"{item!r}")
            check(name, pql, result_to_json(item[0][0]), want[name])

    report = {"rides": n_rides, "load_s": load_s, "queries": {}}
    prev = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        # Rehearsal only: the megakernel defaults to off on the CPU.
        megamod.MEGAKERNEL_ENABLED = True
    kernels.reset_launches()
    try:
        with RefCalls(kernels) as refs:
            # 1. the reads one at a time
            for name, pql in TF_QUERIES:
                c0 = (ex.topn_cache_hits, ex.topn_selfchecks)
                t0 = time.perf_counter()
                got, delta = launched(lambda: one(pql))
                check(name, pql, got, want[name])
                report["queries"][name] = {
                    "pql": pql, "first_s": time.perf_counter() - t0,
                    "launches": delta}
                if name == "topn_rate" and (
                        ex.topn_cache_hits, ex.topn_selfchecks) != (
                        c0[0] + 1, c0[1] + 1):
                    raise AssertionError("timefields: TopN(rate_code) "
                                         "was not a self-checked cache hit")
            # The warm count caches again: a hit with no launch.
            c0 = ex.topn_cache_hits
            got, delta = launched(lambda: one("TopN(rate_code, n=6)"))
            check("topn_rate", "TopN(rate_code, n=6)", got,
                  want["topn_rate"])
            if ex.topn_cache_hits != c0 + 1 or delta:
                raise AssertionError(f"timefields: warm TopN(rate_code) "
                                     f"launched {delta}")
            # 2. the bursts
            for what, burst, expect in (
                    ("burst", TF_BURST, (1, 0, 0, 0)),
                    ("burst_wide", TF_BURST_WIDE, (1, 0, 0, 1))):
                m0 = mega()
                t0 = time.perf_counter()
                _, delta = launched(lambda: batch(burst))
                moved = tuple(b - a for a, b in zip(m0, mega()))
                if moved != expect or (cuda and delta.get(
                        "mega_interpret") != 1):
                    raise AssertionError(
                        f"timefields {what}: megakernel launches/fallbacks/"
                        f"budget fallbacks/unlowered moved {moved}, "
                        f"expected {expect}; kernel launches {delta}")
                report[what] = {"requests": len(burst),
                                "first_s": time.perf_counter() - t0,
                                "launches": delta,
                                "mega_launches": moved[0],
                                "fallbacks": moved[1] + moved[2],
                                "unlowered": moved[3]}
            # A batch of ranged reads over a period with no views: a plan
            # that reads no bank answers through the megakernel path,
            # counted as one launch, with no kernel launch and no error.
            empty = [("e_count", f"Count({pickup(R_EMPTY)})"),
                     ("e_row", pickup(R_EMPTY))]
            m0 = mega()
            out, delta = launched(lambda: ex.execute_batch(
                [("taxi", q, None) for _, q in empty]))
            got = [item if isinstance(item, Exception)
                   else result_to_json(item[0][0]) for item in out]
            moved = tuple(b - a for a, b in zip(m0, mega()))
            if got != [0, {"columns": []}] or moved != (1, 0, 0, 0) or delta:
                raise AssertionError(f"timefields empty cover: answers "
                                     f"{got}, megakernel moved {moved}, "
                                     f"kernel launches {delta}")
            report["empty_cover"] = {"answers": got, "mega_launches":
                                     moved[0], "launches": delta}
        launches = dict(kernels.LAUNCHES)
        if cuda:
            if refs.calls:
                raise AssertionError(f"timefields: plain versions called "
                                     f"on the card: {refs.calls}")
            for name in ("bank_row_counts", "bank_row_counts_masked",
                         "bsi_plane_counts", "mega_interpret"):
                if launches[name] <= 0:
                    raise AssertionError(f"timefields: {name} never "
                                         "launched")
        report["ref_calls"] = refs.calls
        # 3. warm p50s; peak device memory of one warm ranged query
        for name, q in report["queries"].items():
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                got = one(q["pql"])
                sync()
                times.append(time.perf_counter() - t0)
                check(name, q["pql"], got, want[name])
            q["p50_s"] = p50(times)
        for what, burst in (("burst", TF_BURST),
                            ("burst_wide", TF_BURST_WIDE)):
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                batch(burst)
                times.append(time.perf_counter() - t0)
            report[what]["p50_s"] = p50(times)
        if cuda:
            # Where a ranged query's time goes: device time and busy
            # share at 1, 7 and 18 views.
            report["profile"] = profile_queries(
                torch, ex, "taxi", [(n, report["queries"][n]["pql"]) for n
                                    in ("count_month", "count_7",
                                        "count_18")], iters)
            for name in ("count_7", "count_18"):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                one(report["queries"][name]["pql"])
                torch.cuda.synchronize()
                report["queries"][name]["peak_bytes"] = \
                    torch.cuda.max_memory_allocated() - base
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
    # 4. writes
    # The writes and the reads that check them run under a RefCalls
    # of their own: no plain version may run on the card here either.
    with RefCalls(kernels) as wrefs:
        idx = holder.index("taxi")
        writes = {}
        col = 7
        late = ("2019-01-29", "2019-02-01")  # no ride is drawn past Jan 28
        check("set_time", pickup(late), one(f"Count({pickup(late)})"), 0)
        t0 = time.perf_counter()
        check("set_time", "Set", one(f"Set({col}, pickup=0, "
                                     "2019-01-30T08:00)"), True)
        writes["set_time_s"] = time.perf_counter() - t0
        check("set_time", pickup(late), one(f"Count({pickup(late)})"), 1)
        check("set_time", "month", one(f"Count({pickup(RMONTH)})"),
              want["count_month"])
        # A mutex Set moves a ride between rows.
        old = int(rate[col])
        new = old % 6 + 1
        counts = want["rate_counts"].copy()
        counts[old] -= 1
        counts[new] += 1
        t0 = time.perf_counter()
        check("set_mutex", "Set", one(f"Set({col}, rate_code={new})"), True)
        writes["set_mutex_s"] = time.perf_counter() - t0
        vec = idx.field("rate_code").view().fragment(col // SHARD_WIDTH) \
            .mutex_vector(col)
        got = [one(f"Count(Row(rate_code={r}))") for r in (old, new)]
        if got != [int(counts[old]), int(counts[new])] or vec != new:
            raise AssertionError(f"timefields: mutex Set: counts {got}, "
                                 f"mutex_vector {vec}, numpy "
                                 f"{[counts[old], counts[new]]} and {new}")
        top = [{"id": r, "count": int(counts[r])}
               for r in sorted(range(1, 7), key=lambda r: (-counts[r], r))]
        check("set_mutex", "TopN(rate_code, n=6)",
              one("TopN(rate_code, n=6)"), top)
        # Store a range into a time field: the standard view only.
        idx.create_field("pickup_kept", FieldOptions(type="time",
                                                     time_quantum="YMD"))
        store = f"Store({pickup(R7)}, pickup_kept=0)"
        t0 = time.perf_counter()
        check("store", store, one(store), True)
        writes["store_s"] = time.perf_counter() - t0
        check("store", "kept", one("Count(Row(pickup_kept=0))"),
              want["count_7"])
        check("store", "kept range",
              one(f"Count({pickup(R7, 'pickup_kept')})"), 0)
        # ClearRow on a time field the phase makes: every view empties.
        drop = idx.create_field("dropoff", FieldOptions(type="time",
                                                        time_quantum="YMD"))
        n0 = min(SHARD_WIDTH, n_rides)
        drop.import_bits(np.zeros(n0, np.uint64),
                         np.arange(n0, dtype=np.uint64),
                         timestamps=day_times(day[:n0]))
        check("clear_row", "dropoff",
              one(f"Count({pickup(RMONTH, 'dropoff')})"), n0)
        t0 = time.perf_counter()
        check("clear_row", "ClearRow(dropoff=0)", one("ClearRow(dropoff=0)"),
              True)
        writes["clear_row_time_s"] = time.perf_counter() - t0
        left = sum(len(fr.row_ids()) for v in drop.views.values()
                   for fr in v.fragments.values())
        check("clear_row", "dropoff views", (left, len(drop.views)),
              (0, 3 + len(np.unique(day[:n0]))))
        check("clear_row", "dropoff",
              one(f"Count({pickup(R7, 'dropoff')})"), 0)
        # ClearRow on the mutex field.
        t0 = time.perf_counter()
        check("clear_row", "ClearRow(rate_code=6)",
              one("ClearRow(rate_code=6)"), True)
        writes["clear_row_mutex_s"] = time.perf_counter() - t0
        counts[6] = 0
        check("clear_row", "Rows(rate_code)", one("Rows(rate_code)"),
              {"rows": [1, 2, 3, 4, 5]})
        check("clear_row", "Count(Row(rate_code=6))",
              one("Count(Row(rate_code=6))"), 0)
    if cuda and wrefs.calls:
        raise AssertionError(f"timefields writes: plain versions called "
                             f"on the card: {wrefs.calls}")
    report["ref_calls_writes"] = wrefs.calls
    report["writes"] = writes
    top = [{"id": r, "count": int(counts[r])}
           for r in sorted(range(1, 6), key=lambda r: (-counts[r], r))]
    http = {"count_7": (TF_QUERIES[0][1], want["count_7"]),
            "topn_rate": ("TopN(rate_code)", top)}
    log("timefields: exact; warm p50 " + ", ".join(
        f"{n} {q['p50_s']:.6f} s" for n, q in report["queries"].items())
        + f"; burst {report['burst']['p50_s']:.6f} s in one launch, "
        f"with the 18-view range {report['burst_wide']['p50_s']:.6f} s")
    return report, launches, http


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


def burst_times(ex, reqs, want, device, iters):
    """Warm times (s) of the burst through execute_batch, each run
    checked."""
    import torch
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = ex.execute_batch(reqs)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        burst_answers(out, want)
    return times


def burst_p50(ex, reqs, want, device, iters):
    """Warm p50 (s) of the burst through execute_batch, each run checked."""
    return p50(burst_times(ex, reqs, want, device, iters))


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


def fingerprint_expected(pos, extra_cols=(), more=None):
    """Exact answers of FP_QUERIES from the positions array with numpy
    (distinct bits per row, the query row's bits as the filter), in 1M-row
    chunks. ``extra_cols`` adds columns (not among its bits) to the query
    molecule first; ``more`` maps other rows to columns (not among their
    bits) added to them."""
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
    for r, cols in (more or {}).items():
        raw[r] += len(cols)
        inter[r] += int(filt[list(cols)].sum())
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


def load_fingerprints(device, pos, path=None):
    """The fingerprint index on a port Holder through Field.import_bits,
    LOAD_CHUNK molecules a call; in memory, or on the data directory
    ``path``. Returns (holder, executor, field, seconds)."""
    import numpy as np
    from pilosa_tpu_torch import Executor, FieldOptions, Holder
    t0 = time.perf_counter()
    holder = Holder(path, device=device)
    if path is not None:
        holder.open()
    idx = holder.create_index("mole", track_existence=False)
    field = idx.create_field("fingerprint", FieldOptions(max_columns=FP_BITS))
    for c0 in range(0, len(pos), LOAD_CHUNK):
        chunk = pos[c0:c0 + LOAD_CHUNK]
        field.import_bits(
            np.repeat(np.arange(c0, c0 + len(chunk), dtype=np.uint64),
                      BITS_PER_MOL),
            chunk.reshape(-1).astype(np.uint64))
    return holder, cache_off(Executor(holder, device=device)), field, \
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
    memory_line("fingerprint", device)
    # The layout phase on the same holder; the query molecule holds the
    # two Sets (this phase's and the serve path's).
    col2 = next(c for c in range(FP_BITS) if c not in qbits and c != col)
    report["layout"], layout_launches, expand_in = run_layout(
        holder, ex, field, pos, {QUERY_MOL: [col, col2]}, device, iters)
    memory_line("layout", device)
    # The timing row's inputs, as the main path met them before the Set:
    # one fixed segment of the bank and the query's filter words at the
    # bank's width.
    seg = next(s[2] for s in pb.segments if s[2].dim() == 2)
    qpos = np.asarray(sorted(qbits), np.int16)
    timing_in = {
        "pos": seg,
        "filt": to_tensor(pack_positions(qpos.astype(np.uint64),
                                         width * 32), seg.device),
        "qpos": torch.from_numpy(qpos).to(seg.device),
        "expand": expand_in, "layout_launches": layout_launches}
    holder.close()
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

    def kernel_at(st):
        return lib.pbank_membership_counts(pos.data_ptr(), None,
                                           filt.data_ptr(), out.data_ptr(),
                                           R, L, filt.numel(), st)

    def kernel():
        return kernel_at(stream)

    if kernel() != 0:
        raise RuntimeError("pbank_membership_counts: kernel launch failed")
    want = kernels.pbank_membership_counts_ref(pos, filt)
    lib_out = torch.isin(pos, qpos).sum(1, dtype=torch.int32)
    torch.cuda.synchronize()
    if not torch.equal(out, want) or not torch.equal(out, lib_out):
        raise AssertionError("pbank_membership_counts differs on the "
                             "fingerprint segment")
    ms = time_cuda(torch, kernel)
    graph_ms = time_graph(torch, kernel_at)
    plain_ms = time_cuda(torch, lambda: kernels.pbank_membership_counts_ref(
        pos, filt), iters=5, warmup=1)
    library_ms = time_cuda(torch, lambda: torch.isin(pos, qpos).sum(
        1, dtype=torch.int32))
    nbytes = R * L * 2 + filt.numel() * 4 + R * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing: pbank_membership_counts [{R},{L}] W={filt.numel()} kernel "
        f"{ms:.4f} ms between events, {graph_ms:.4f} ms back to back, "
        f"bound {bound_ms:.4f} ms (bytes), plain "
        f"{plain_ms:.4f} ms, torch.isin + sum (two calls) "
        f"{library_ms:.4f} ms")
    return {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms, "shape": [R, L],
            "bound_bytes": nbytes}




# ------------------------------------------------------------ expansion


def expand_case(rng, n_rows, n_shards, width, widen=0, pad=1024,
                per_row=80, pad_fill=0):
    """Seeded sparse rows: each (row, shard) holds sorted unique bit
    positions (0 to per_row draws; every fifth row empty), encoded
    (shard << 16) | bitpos, row after row, with int32 offsets per row slot
    (slots past n_rows empty), ``widen`` words of positions past width *
    32 (a view widened after the build) and a pad tail of ``pad``
    positions filled with ``pad_fill``. Returns (pos int32, starts int32,
    cap) as numpy."""
    import numpy as np
    parts, lens = [], []
    for r in range(n_rows):
        row = [np.empty(0, np.uint32)]
        if r % 5 != 3:
            for sh in range(n_shards):
                bits = np.unique(rng.integers(
                    0, (width + widen) * 32, int(rng.integers(0, per_row))))
                row.append(bits.astype(np.uint32) | np.uint32(sh << 16))
        parts.append(np.concatenate(row))
        lens.append(len(parts[-1]))
    cap = 1 << n_rows.bit_length()
    starts = np.zeros(cap + 1, np.int64)
    np.cumsum(lens, out=starts[1:n_rows + 1])
    starts[n_rows + 1:] = starts[n_rows]
    pos = np.full(int(starts[-1]) + pad, pad_fill, np.uint32)
    pos[:starts[-1]] = np.concatenate(parts)
    return pos.view(np.int32), starts.astype(np.int32), cap


def fp_expand_input(rng, n_rows, cap, width, bits=BITS_PER_MOL):
    """Fingerprint rows for the expansion: rows 0..n_rows-1 of a cap-slot
    table hold ``bits`` sorted unique positions below width * 32 (a power
    of two) each, (base + step * i) mod width * 32 for a random base and
    a random odd step, the other slots none. Returns (pos int32, starts
    int32) as numpy."""
    import numpy as np
    span = width * 32
    base = rng.integers(0, span, (n_rows, 1))
    step = 2 * rng.integers(0, span // (2 * bits), (n_rows, 1)) + 1
    rows = np.sort((base + step * np.arange(bits)) % span, axis=1)
    starts = np.zeros(cap + 1, np.int64)
    starts[1:n_rows + 1] = np.arange(1, n_rows + 1) * bits
    starts[n_rows + 1:] = n_rows * bits
    return rows.astype(np.int32).ravel(), starts.astype(np.int32)


def check_expand(torch, kernels, device):
    """expand_positions bit-exact against its plain version: the 10M
    SparseBank's shape (S = 1, width 128, 65 slots with the zero slot and
    empty rows, in the launch's parameters), a 96-shard bank of width
    2048 (24 tiles a row), a row of exactly one tile (4 x 2048 words) and
    one word over (3 x 2731), S * W not a multiple of 4 (3 x 33, 1 x 5),
    positions past width * 32, a pad tail of garbage no row reaches, the
    sparse upload's [cap, 1, width] form over slots 0..cap-1 (a range),
    one slot (a range), a list longer than the parameters hold (copied
    through pinned memory), n = 0, every row's positions shuffled, and
    repeated positions, whose expected rows are the plain version's over
    the positions without the repeats. Each call must launch once (none
    for n = 0) and none may synchronise the stream (``NoStreamSync``,
    first shown to catch a blocking copy). Returns the max
    |kernel - plain| (0)."""
    import numpy as np
    rng = np.random.default_rng(23)
    NoStreamSync.bites(torch, device)

    def shuffled(pos, starts, cap):
        out = pos.copy()
        for r in range(cap):
            out[starts[r]:starts[r + 1]] = rng.permutation(
                pos[starts[r]:starts[r + 1]])
        return out

    cases = []

    def case(name, pos, starts, slots, n_shards, width, kind, ref=None):
        cases.append((name, pos, starts, np.asarray(slots, np.int32),
                      n_shards, width, kind, ref or (pos, starts)))

    pos, starts, cap = expand_case(rng, 500, 1, 128, per_row=97)
    slots = np.concatenate([rng.choice(500, 64, replace=False),
                            [cap - 1]])
    case("fp-10M shape", pos, starts, slots, 1, 128, "param")
    case("fp-10M shape, rows shuffled", shuffled(pos, starts, cap), starts,
         slots, 1, 128, "param", (pos, starts))
    case("fp-10M shape, one slot", pos, starts, slots[:1], 1, 128, "range")
    case("fp-10M shape, n = 0", pos, starts, slots[:0], 1, 128, "range")
    many = rng.integers(0, cap, kernels.EXPAND_PARAM_SLOTS + 100)
    case("fp-10M shape, a long list", pos, starts, many, 1, 128, "device")
    pos, starts, cap = expand_case(rng, 40, 96, 2048, per_row=30)
    case("S=96 W=2048", pos, starts, np.arange(cap), 96, 2048, "range")
    case("S=96 W=2048, shuffled list", shuffled(pos, starts, cap), starts,
         rng.permutation(cap), 96, 2048, "param", (pos, starts))
    case("S=96 W=2048, one slot", pos, starts, [7], 96, 2048, "range")
    for S, W, what in ((4, 2048, "one tile"), (3, 2731, "one tile + 1"),
                       (3, 33, "S*W % 4 = 3"), (1, 5, "S*W = 5")):
        pos, starts, cap = expand_case(rng, 30, S, W, per_row=200)
        case(f"{what} ({S} x {W})", pos, starts, np.arange(cap), S, W,
             "range")
        case(f"{what} ({S} x {W}), shuffled", shuffled(pos, starts, cap),
             starts, rng.permutation(cap), S, W, "param", (pos, starts))
    pos, starts, cap = expand_case(rng, 30, 3, 128, widen=64)
    case("widened", pos, starts, np.arange(cap)[::-1].copy(), 3, 128,
         "param")
    pos, starts, cap = expand_case(rng, 30, 2, 128, pad=1 << 16,
                                   pad_fill=0xFFFF)
    case("pad tail", pos, starts, np.arange(cap), 2, 128, "range")
    pos, starts, cap = expand_case(rng, 1000, 1, 128, per_row=60)
    case("sparse upload [cap, 1, W]", pos, starts, np.arange(cap), 1, 128,
         "range")
    # Repeats: every third position of a row once more, rows shuffled.
    pos, starts, cap = expand_case(rng, 30, 2, 128, pad=0)
    parts = [pos[starts[r]:starts[r + 1]] for r in range(cap)]
    parts = [rng.permutation(np.concatenate([p, p[::3]])) for p in parts]
    dstarts = np.zeros(cap + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=dstarts[1:])
    case("repeated positions", np.concatenate(parts).astype(np.int32),
         dstarts.astype(np.int32), rng.permutation(cap), 2, 128, "param",
         (pos, starts))
    for name, pos, starts, slots, n_shards, width, kind, (rpos, rst) \
            in cases:
        if kernels.expand_transport(slots)[0] != kind:
            raise AssertionError(f"expand_positions {name}: transport "
                                 f"{kernels.expand_transport(slots)}, "
                                 f"expected {kind}")
        p = torch.from_numpy(pos).to(device)
        st = torch.from_numpy(starts).to(device)
        before = kernels.LAUNCHES["expand_positions"]
        with NoStreamSync(torch):
            got = kernels.expand_positions(p, st, slots, n_shards, width)
        launched = kernels.LAUNCHES["expand_positions"] - before
        want = kernels.expand_positions_ref(
            torch.from_numpy(rpos).to(device),
            torch.from_numpy(rst).to(device), slots, n_shards, width)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or got.dtype != torch.int32 or \
                tuple(got.shape) != (len(slots), n_shards, width) or \
                not torch.equal(got, want) or \
                launched != (1 if len(slots) else 0):
            raise AssertionError(f"expand_positions {name}: kernel != "
                                 f"plain ({launched} launches)")
    log(f"kernels: expand_positions bit-exact over {len(cases)} cases "
        "(every slot transport, tile edges, shuffled and repeated "
        "positions)")
    return 0


def check_mega_expand(torch, kernels, device):
    """mega_interpret with expand registers against mega_interpret_ref
    extended with the sparse banks as build_program(...).run extends its
    slab: a random dense bank, a random sparse bank and random xslots
    (the zero slot among them), a plan that first moves every expand
    register into scratch with OP_EXPAND and then runs random rows of
    every opcode over all registers. The launch (the expansion, the
    plan's upload, the interpreter) may not synchronise the stream.
    Returns the max |kernel - plain| (0)."""
    import numpy as np
    rng = np.random.default_rng(31)
    # T leaves room for the dense slots, the expand registers and one
    # scratch register per expand register below the spare.
    cases = [(256, 1, 128, 20, 65), (32, 96, 2048, 6, 10),
             (32, 3, 128, 4, 9)]
    for T, S, W, n_dense, n_x in cases:
        (banks, slots, widths, _instrs, lanes, out_row, T, S, W) = \
            random_mega_case(rng, torch, device, T, S, W, (W,), n_dense, 8)
        pos, starts, cap = expand_case(rng, 60, S, W)
        xslots = np.concatenate([rng.integers(0, cap - 1, n_x - 1),
                                 [cap - 1]]).astype(np.int32)
        widths[n_dense:n_dense + n_x] = rng.integers(1, W + 1, n_x)
        rows = [(6, n_dense + n_x + k, n_dense + k, n_dense + k)
                for k in range(n_x)]
        body, _ = random_mega_plan(rng, T, 60)
        rows += [tuple(r) for r in body.tolist() if r != [4, T - 1, T - 1,
                                                         T - 1]]
        P = 1 << (len(rows) - 1).bit_length()
        rows += [(4, T - 1, T - 1, T - 1)] * (P - len(rows))
        instrs = torch.from_numpy(np.asarray(rows, np.int32))
        xbanks = ((torch.from_numpy(pos).to(device),
                   torch.from_numpy(starts).to(device)),)
        args = (banks, slots, widths, instrs, lanes, out_row, T, S, W,
                xbanks, (xslots,))
        want = kernels.mega_interpret_ref(*args)
        with NoStreamSync(torch):
            got = kernels.mega_interpret(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"mega_interpret with {n_x} expand "
                                 f"registers T={T} S={S} W={W}: kernel != "
                                 "plain")
    log(f"kernels: mega_interpret with expand registers bit-exact over "
        f"{len(cases)} plans")
    return 0


def expand_row(torch, kernels, lib, device, pos, starts, slots, S, W):
    """One shape's timing row of expand_positions, each output held equal
    to the plain version's and to ``index_add_``'s. The kernel is its C
    entry alone (one launch into an uninitialised output): ``ms`` back
    to back in a CUDA graph (``time_graph``),
    ``event_ms`` one launch between CUDA events (``time_cuda``, as the
    other kernels are timed). ``call_ms`` is the whole wrapper call
    between events; the byte bound counts the rows' positions, the
    slots and their two offsets read once and the output written once;
    ``plain_ms`` the plain version; ``library_ms`` (graph) and
    ``library_event_ms`` ``index_add_`` over word indexes and bit values
    computed beforehand, one call, the nearest PyTorch expression. A
    list that rides in the launch's parameters also gets
    ``wrapper_host_us``."""
    import numpy as np
    slots = np.asarray(slots, np.int32)
    host = torch.from_numpy(slots)
    n = len(slots)
    out = torch.empty((n, S, W), dtype=torch.int32, device=device)
    args, keep = kernels.expand_launch_args(pos, starts, host, S, W, out)

    def kernel(stream):
        return lib.expand_positions(*args[:-1], stream)
    transport = kernels.expand_transport(slots)[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    if kernel(stream) != 0:
        raise RuntimeError("expand_positions: kernel launch failed")
    want = kernels.expand_positions_ref(pos, starts, host, S, W)
    st = starts.to(torch.int64)
    sl = host.to(device=device, dtype=torch.int64)
    lo, hi = st[sl], st[sl + 1]
    lens = hi - lo
    k = torch.repeat_interleave(torch.arange(n, device=device), lens)
    j = torch.repeat_interleave(lo - (torch.cumsum(lens, 0) - lens), lens) \
        + torch.arange(int(lens.sum()), device=device)
    p = pos.to(torch.int64)[j] & 0xFFFFFFFF
    inside = ((p >> 16) < S) & ((p & 0xFFFF) < W * 32)
    p, k = p[inside], k[inside]
    word = (k * S + (p >> 16)) * W + ((p & 0xFFFF) >> 5)
    val = torch.ones_like(p) << (p & 31)
    acc = torch.zeros(n * S * W, dtype=torch.int64, device=device)
    acc.index_add_(0, word, val)
    lib_out = (acc - ((acc >> 31) << 32)).to(torch.int32).reshape(n, S, W)
    call = kernels.expand_positions(pos, starts, slots, S, W)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(out, lib_out)
            and torch.equal(call, want)):
        raise AssertionError(f"expand_positions differs at [{n}, {S}, {W}]")
    row = {"shape": [n, S, W], "transport": transport,
           "ms": time_graph(torch, kernel),
           "event_ms": time_cuda(torch, lambda: kernel(stream)),
           "call_ms": time_cuda(torch, lambda: kernels.expand_positions(
               pos, starts, slots, S, W)),
           "plain_ms": time_cuda(torch, lambda: kernels.expand_positions_ref(
               pos, starts, host, S, W), iters=5, warmup=1),
           "library_ms": time_graph(
               torch, lambda _s: (acc.index_add_(0, word, val), None)[1]),
           "library_event_ms": time_cuda(
               torch, lambda: acc.index_add_(0, word, val))}
    n_pos = int(lens.sum())
    nbytes = n_pos * 4 + n * 4 + 2 * n * 4 + n * S * W * 4
    row.update({"positions": n_pos, "bound_bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    if transport == "param":
        row.update(wrapper_host_us(torch, kernels, pos, starts, slots, S, W))
    return row


def wrapper_host_us(torch, kernels, pos, starts, slots, S, W, calls=500,
                    turns=3):
    """Host microseconds of one ``expand_positions`` call when ``calls``
    of them are enqueued back to back (the card keeps up), with the slot
    list in the launch's parameters (``param_call_us``) and through
    pinned memory and a non-blocking copy (``pinned_call_us``:
    ``EXPAND_PARAM_SLOTS`` set to 0 for the turn), in turns; the median
    turn of each."""
    limit = kernels.EXPAND_PARAM_SLOTS
    times = {"param": [], "pinned": []}
    try:
        for _ in range(turns):
            for kind, got in times.items():
                kernels.EXPAND_PARAM_SLOTS = limit if kind == "param" else 0
                kernels.expand_positions(pos, starts, slots, S, W)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    kernels.expand_positions(pos, starts, slots, S, W)
                torch.cuda.synchronize()
                got.append((time.perf_counter() - t0) / calls * 1e6)
    finally:
        kernels.EXPAND_PARAM_SLOTS = limit
    return {f"{kind}_call_us": sorted(got)[len(got) // 2]
            for kind, got in times.items()}


def expand_shapes(rng, torch, device, upload=None):
    """The expansion's timed shapes, as (name, pos, starts, slots, S, W)
    with pos and starts on the card: the layout burst's (a 10M-style
    SparseBank's 65 slots: 64 fingerprint rows and the zero slot), the
    sparse upload (``upload``, the fingerprint phase's largest as it
    called ``_expand_sparse_chunk``; else the 2 rows of a 4-slot table
    that phase uploads at its small size on the CPU), a 65,536-row upload
    chunk of fingerprint rows, and one row of a 96-shard view of width
    2048 (an eager Row leaf, 24 tiles)."""
    import numpy as np

    def dev(a):
        return torch.from_numpy(a).to(device)

    pos, starts = fp_expand_input(rng, 500, 512, 128)
    slots = np.concatenate([rng.choice(500, 64, replace=False), [511]])
    out = [("burst", dev(pos), dev(starts), slots, 1, 128)]
    if upload is None:
        pos, starts = fp_expand_input(rng, 2, 4, 128)
        out.append(("upload", dev(pos), dev(starts), np.arange(4), 1, 128))
    else:
        out.append(("upload", *upload))
    pos, starts = fp_expand_input(rng, 65536, 65536, 128)
    out.append(("upload_65536", dev(pos), dev(starts), np.arange(65536), 1,
                128))
    pos, starts, _ = expand_case(rng, 8, 96, 2048, per_row=48)
    out.append(("leaf_96x2048", dev(pos), dev(starts), [2], 96, 2048))
    return out


def time_expand(torch, kernels, device, tin, upload=None):
    """expand_positions on the card, after the main path: timing rows
    (``expand_row``) at the layout burst's shape (its SparseBank and the
    slots one burst expands), at the fingerprint phase's largest sparse
    upload and at ``expand_shapes``' other two, beside the launch floor:
    an empty kernel launched and timed the same way. The top level is
    the burst's row."""
    import numpy as np
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    pos, starts, S, W = tin["pos"], tin["starts"], tin["n_shards"], \
        tin["width"]
    slots = tin["slots"].numpy()
    out = launch_floor(torch, lib, device)
    out["shapes"] = {}
    rng = np.random.default_rng(29)
    shapes = [("burst", pos, starts, slots, S, W)] + \
        expand_shapes(rng, torch, device, upload)[1:]
    for name, p, st, sl, s, w in shapes:
        row = out["shapes"][name] = expand_row(torch, kernels, lib, device,
                                               p, st, sl, s, w)
        log(f"timing: expand_positions {name} {row['shape']} "
            f"({row['positions']} positions, {row['transport']} slots) "
            f"kernel {row['ms']:.5f} ms back to back (launch floor "
            f"{out['floor_ms']:.5f}), {row['event_ms']:.4f} ms a launch "
            f"between events (floor {out['floor_event_ms']:.4f}), call "
            f"{row['call_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"(bytes), plain {row['plain_ms']:.4f} ms, index_add_ "
            f"(indexes precomputed) {row['library_ms']:.5f} ms")
    out.update({k: out["shapes"]["burst"][k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "shape", "positions",
        "bound_bytes")})
    return out


def launch_floor(torch, lib, device):
    """An empty kernel (``launch_floor`` in csrc/sparse_expand.cu) timed
    as the expansion is: back to back in a CUDA graph (``floor_ms``) and
    one launch between events (``floor_event_ms``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if lib.launch_floor(stream) != 0:
        raise RuntimeError("launch_floor: kernel launch failed")
    return {"floor_ms": time_graph(torch, lib.launch_floor),
            "floor_event_ms": time_cuda(torch,
                                        lambda: lib.launch_floor(stream))}


class UploadRecorder:
    """Keeps the host arguments of the largest ``_expand_sparse_chunk``
    call (by output words, then positions) while it is active, and
    nothing else, so the phase it wraps runs as it would; ``largest()``
    turns them into the card's (pos, starts, slots, S, W) of
    ``expand_positions`` afterwards."""

    def __init__(self, view_mod):
        self.view_mod = view_mod
        self.calls, self.args, self.key = 0, None, None

    def __enter__(self):
        real = self.real = self.view_mod._expand_sparse_chunk

        def recorded(pos16, lens, rows_at, cap, width, device):
            self.calls += 1
            key = (cap * width, len(pos16))
            if self.key is None or key > self.key:
                self.key, self.args = key, (pos16, lens, rows_at, cap, width)
            return real(pos16, lens, rows_at, cap, width, device)
        self.view_mod._expand_sparse_chunk = recorded
        return self

    def __exit__(self, *exc):
        self.view_mod._expand_sparse_chunk = self.real

    def largest(self, torch, device):
        """The recorded call's inputs on ``device``, or None."""
        import numpy as np
        if self.args is None:
            return None
        pos16, lens, rows_at, cap, width = self.args
        starts = np.zeros(cap + 1, np.int64)
        starts[np.asarray(rows_at, np.int64) + 1] = lens
        np.cumsum(starts, out=starts)
        return (torch.from_numpy(np.asarray(pos16).astype(np.int32)).to(
                    device),
                torch.from_numpy(starts.astype(np.int32)).to(device),
                np.arange(cap, dtype=np.int32), 1, width)


def run_expand_probe(torch, device, tree):
    """``--expand-probe``: ``check_expand``, ``check_mega_expand`` and the
    expansion's timing rows at ``expand_shapes`` beside the launch
    floor, with the package of ``tree``. Returns the probe."""
    import numpy as np
    from pilosa_tpu_torch.ops import build, kernels
    build.build(verbose=True)
    lib = build.load()
    check_expand(torch, kernels, device)
    check_mega_expand(torch, kernels, device)
    out = {"tree": tree, **launch_floor(torch, lib, device)}
    rng = np.random.default_rng(29)
    out["shapes"] = {name: expand_row(torch, kernels, lib, device, p, st,
                                      sl, s, w)
                     for name, p, st, sl, s, w in expand_shapes(rng, torch,
                                                                device)}
    return out


# --------------------------------------------------------------- memory

# One record a phase: the ledger by category, the bank budget, and the
# allocator.
MEMORY = []


def memory_line(phase, device):
    """Log and keep the memory ledger's bytes by category, the bank
    budget's total, budget and evictions, and the allocator's bytes after
    a phase; the ledger's device bytes may not exceed the allocator's."""
    import torch
    from pilosa_tpu_torch.core.view import BANK_BUDGET
    from pilosa_tpu_torch.utils.memledger import HOST_CATEGORIES, LEDGER
    totals = LEDGER.totals()
    ledger_device = sum(t["bytes"] for c, t in totals.items()
                        if c not in HOST_CATEGORIES)
    cuda = str(device) != "cpu"
    allocated = torch.cuda.memory_allocated() if cuda else None
    rec = {"phase": phase,
           "ledger": {c: t["bytes"] for c, t in totals.items()
                      if t["count"]},
           "ledger_device_bytes": ledger_device,
           "budget_total": BANK_BUDGET.total, "budget": BANK_BUDGET.budget,
           "evictions": BANK_BUDGET.evictions, "allocated": allocated}
    MEMORY.append(rec)
    log(f"memory after {phase}: ledger {rec['ledger']} (device "
        f"{ledger_device}), budget total {BANK_BUDGET.total} of "
        f"{BANK_BUDGET.budget}, evictions {BANK_BUDGET.evictions}, "
        f"allocated {allocated}")
    if cuda and ledger_device > allocated:
        raise AssertionError(f"memory after {phase}: the ledger's "
                             f"{ledger_device} device bytes exceed the "
                             f"allocator's {allocated}")
    return rec


class RssPeak:
    """The peak resident set size of this process while active, sampled
    every 20 ms from /proc (host memory of a build)."""

    def __enter__(self):
        import threading
        self.peak = self.start = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except OSError:
            return 0

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


# --------------------------------------------------------------- layout


def analogue_ids(n, seed=FP_SEED):
    """The planted analogues of QUERY_MOL, in fingerprint_positions'
    draw order."""
    import numpy as np
    plant = np.random.default_rng(seed + 1)
    cand = plant.choice(n - 1, N_ANALOGUES, replace=False)
    return (cand + (cand >= QUERY_MOL)).tolist()


def layout_burst(n):
    """The layout phase's burst: Count(Intersect(query, c)) over 64
    candidates (the first 40 planted analogues and 24 seeded others),
    then Union, Difference and Xor counts and one row Union of those
    rows. Returns ([(name, pql)], candidates)."""
    import numpy as np
    an = analogue_ids(n)[:40]
    rng = np.random.default_rng(FP_SEED + 2)
    others = [int(x) for x in rng.choice(n, 64, replace=False)
              if int(x) != QUERY_MOL and int(x) not in an][:24]
    cands = an + others
    burst = [(f"q_and_{c}", f"Count(Intersect(Row(fingerprint={QUERY_MOL}), "
                            f"Row(fingerprint={c})))") for c in cands]
    a, b, c, d = cands[:4]
    burst += [
        ("union", f"Count(Union(Row(fingerprint={QUERY_MOL}), "
                  f"Row(fingerprint={a})))"),
        ("difference", f"Count(Difference(Row(fingerprint={b}), "
                       f"Row(fingerprint={QUERY_MOL})))"),
        ("xor", f"Count(Xor(Row(fingerprint={c}), Row(fingerprint={d})))"),
        ("row_union", f"Union(Row(fingerprint={a}), Row(fingerprint={b}))")]
    return burst, cands


def layout_expected(burst, cands, pos, extra):
    """numpy answers of the layout burst: each row's distinct bits and the
    columns ``extra[row]`` added by Sets (one shard, so a bit is its
    column)."""
    import numpy as np

    def bits(r):
        return set(np.unique(pos[r]).tolist()) | set(extra.get(r, ()))

    q = bits(QUERY_MOL)
    a, b, c, d = (bits(x) for x in cands[:4])
    want = {f"q_and_{x}": len(q & bits(x)) for x in cands}
    want.update(union=len(q | a), difference=len(b - q), xor=len(c ^ d),
                row_union=sorted(a | b))
    return [want[name] for name, _ in burst]


def run_layout(holder, ex, field, pos, extra, device, iters=ITERS):
    """The layout phase on the loaded fingerprint holder (``extra`` maps a
    row to the columns Sets added to it), every answer exact against
    numpy and no plain version on the card:

    a. the staged burst (layout_burst) through execute_batch: one
       mega_interpret launch, only row-subset banks (none over 2 x 65
       rows, no full view bank), its first-call seconds, warm p50 and the
       device memory it allocates at its peak;
    b. LayoutManager.demote(view): the SparseBank's bytes, positions,
       build seconds and host peak beside the dense bank it stands for,
       the ledger's device bytes before and after;
    c. the same burst over the sparse layout: one mega_interpret launch
       fed by expand_positions, its warm p50 and peak;
    d. the burst's reads and the five FP_QUERIES through execute, one at
       a time, with no dense bank;
    e. a Set into a candidate row: the SparseBank rebuilds with moved
       versions and the burst stays exact;
    f. the re-layout pass over a watermark just under the ledger's device
       bytes, its summary, then promote(view) and a dense read;
    g. one admission over a budget set just under the resident total:
       the evicted entry (highest demotion score, LRU among ties), the
       total within the budget, the evicted bank rebuilt exactly on its
       next read, the budget restored.

    Returns (report, launches of steps c-d, expand timing inputs)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.core.layout import LayoutManager
    from pilosa_tpu_torch.core.view import BANK_BUDGET, SparseBank, \
        ViewBank, bank_capacity
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils.memledger import LEDGER
    cuda = device != "cpu"
    t_phase = time.perf_counter()
    view = field.view()
    burst, cands = layout_burst(len(pos))
    reqs = [("mole", pql, None) for _, pql in burst]
    extra = {r: list(c) for r, c in extra.items()}
    want = layout_expected(burst, cands, pos, extra)
    report = {"requests": len(reqs)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def answer(res):
        return res if isinstance(res, int) else res.columns().tolist()

    def check(out, want, what):
        for (name, pql), item, w in zip(burst, out, want):
            if isinstance(item, Exception):
                raise AssertionError(f"layout {what} {name}: {item!r}")
            (res,), _ = item
            if answer(res) != w:
                raise AssertionError(f"layout {what} {name}: port != numpy")

    def one_burst(what):
        before = dict(kernels.LAUNCHES)
        m0 = mega_state(ex)
        if cuda:
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = ex.execute_batch(reqs)
        sync()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        check(out, want, what)
        m1 = mega_state(ex)
        if m1[0] != m0[0] + 1 or m1[1:] != m0[1:]:
            raise AssertionError(f"layout {what}: megakernel launches/"
                                 f"fallbacks {m0} -> {m1}, not one launch")
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before
                    if kernels.LAUNCHES[k] != before[k]}
        if cuda and launched.get("mega_interpret") != 1:
            raise AssertionError(f"layout {what}: launches {launched}")
        return {"s": secs, "peak_bytes": peak, "launches": launched}

    def p50():
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = ex.execute_batch(reqs)
            sync()
            times.append(time.perf_counter() - t0)
            check(out, want, "warm")
        times.sort()
        return times[len(times) // 2]

    def dense_banks():
        """(largest ViewBank's capacity, whether a full view bank is
        cached) of the fingerprint view."""
        caps = [b.array.shape[0] for b in view._bank_cache.values()
                if isinstance(b, ViewBank)]
        full = any(isinstance(b, ViewBank) and len(k) == 2
                   for k, b in view._bank_cache.items())
        return max(caps, default=0), full

    prev = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        megamod.MEGAKERNEL_ENABLED = True  # rehearsal: off by default
    refs = RefCalls(kernels)
    try:
        with refs:
            # a. staged row-subset banks
            a = one_burst("staged")
            a["p50_s"] = p50()
            cap, full = dense_banks()
            if cap > 2 * 65 or full:
                raise AssertionError(f"layout staged: a bank of {cap} rows "
                                     f"(full view bank: {full})")
            a["largest_bank_rows"] = cap
            report["staged"] = a
            log(f"layout: staged burst of {len(reqs)} in one launch, first "
                f"{a['s']:.4f} s, warm p50 {a['p50_s']:.6f} s, peak "
                f"{a['peak_bytes']} bytes, largest bank {cap} rows")
            memory_line("layout_staged", device)
            # b. demote
            mgr = LayoutManager(holder)
            dev0 = LEDGER.total_bytes(device_only=True)
            t0 = time.perf_counter()
            with RssPeak() as rss:
                if not mgr.demote(view):
                    raise AssertionError("layout: the demotion failed")
            demote_s = time.perf_counter() - t0
            width = view.trimmed_words()
            sb = view._bank_cache.get(("sbank", (0,), width))
            if not isinstance(sb, SparseBank):
                raise AssertionError("layout: no SparseBank after demote")
            dev1 = LEDGER.total_bytes(device_only=True)
            report["demote"] = {
                "s": demote_s, "sparse_bytes": sb.nbytes,
                "positions": int(LEDGER.entry_info(
                    ("sparse_bank",), (id(view), ("sbank", (0,), width)))
                    ["positions"]),
                "rows": sb.n_rows,
                "dense_bytes": bank_capacity(sb.n_rows) * sb.n_shards
                * sb.width * 4,
                "ledger_device_before": dev0, "ledger_device_after": dev1,
                "host_rss_start": rss.start, "host_rss_peak": rss.peak}
            log(f"layout: demoted in {demote_s:.2f} s (host RSS peak "
                f"{rss.peak} from {rss.start}): SparseBank {sb.nbytes} bytes"
                f", {report['demote']['positions']} positions, for a dense "
                f"bank of {report['demote']['dense_bytes']} bytes; ledger "
                f"device bytes {dev0} -> {dev1}")
            memory_line("layout_demote", device)
            # c. the same burst over the sparse layout
            kernels.reset_launches()
            c = one_burst("sparse")
            if cuda and c["launches"].get("expand_positions", 0) < 1:
                raise AssertionError(f"layout sparse: launches "
                                     f"{c['launches']}")
            c["p50_s"] = p50()
            if cuda:
                # Once more with the launch (its expansion, the plan's
                # upload, the interpreter) barred from syncing.
                real, strict_calls = kernels.mega_interpret, []

                def strict(*a, **k):
                    strict_calls.append(1)
                    with NoStreamSync(torch):
                        return real(*a, **k)
                kernels.mega_interpret = strict
                try:
                    one_burst("sparse, no stream sync")
                finally:
                    kernels.mega_interpret = real
                if len(strict_calls) != 1:
                    raise AssertionError(f"layout sparse: {strict_calls} "
                                         "launches under the sync check")
                c["sync_free"] = True
            report["sparse"] = c
            log(f"layout: sparse burst in one launch with "
                f"{c['launches'].get('expand_positions', 0)} expand "
                f"launch(es), first {c['s']:.4f} s, warm p50 "
                f"{c['p50_s']:.6f} s (staged {a['p50_s']:.6f} s), peak "
                f"{c['peak_bytes']} bytes"
                + (", its launch free of stream syncs" if cuda else ""))
            rows_read = []
            for _, pql in burst:
                for tok in pql.split("fingerprint=")[1:]:
                    r = int(tok.split(")")[0])
                    if r not in rows_read:
                        rows_read.append(r)
            timing_in = {"pos": sb.arrays[0], "starts": sb.arrays[1],
                         "slots": torch.tensor(
                             [sb.slot(r) for r in rows_read],
                             dtype=torch.int32),
                         "n_shards": 1, "width": width}
            # d. execute, one query at a time
            t0 = time.perf_counter()
            for (name, pql), w in zip(burst, want):
                (res,) = ex.execute("mole", pql)
                if answer(res) != w:
                    raise AssertionError(f"layout execute {name}: port != "
                                         "numpy")
            def fp_expected():
                return fingerprint_expected(
                    pos, extra_cols=tuple(extra.get(QUERY_MOL, ())),
                    more={r: c for r, c in extra.items() if r != QUERY_MOL})

            fp_want = fp_expected()
            for name, pql in FP_QUERIES:
                (got,) = ex.execute("mole", pql)
                if got.pairs != fp_want[name]:
                    raise AssertionError(f"layout execute {name}: port != "
                                         "numpy")
            cap, full = dense_banks()
            if cap or full:
                raise AssertionError("layout execute: a dense bank was "
                                     "built over the sparse layout")
            report["execute_s"] = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if cuda and launches["expand_positions"] <= 0:
                raise AssertionError("layout: expand_positions never "
                                     "launched")
            # e. a write
            target = cands[5]
            col = next(x for x in range(FP_BITS)
                       if x not in set(pos[target].tolist())
                       and x not in extra.get(target, ()))
            (changed,) = ex.execute("mole",
                                    f"Set({col}, fingerprint={target})")
            if not changed:
                raise AssertionError("layout: the Set changed nothing")
            extra.setdefault(target, []).append(col)
            want = layout_expected(burst, cands, pos, extra)
            fp_want = fp_expected()
            e = one_burst("after the Set")
            sb2 = view._bank_cache.get(("sbank", (0,), width))
            if not isinstance(sb2, SparseBank) or sb2 is sb or \
                    sb2.versions == sb.versions:
                raise AssertionError("layout: the SparseBank did not "
                                     "rebuild after the Set")
            report["write"] = {"rebuild_and_burst_s": e["s"],
                               "launches": e["launches"]}
            log(f"layout: Set({col}, fingerprint={target}); the SparseBank "
                f"rebuilt and the burst stayed exact ({e['s']:.2f} s)")
            del sb, sb2
            memory_line("layout_write", device)
            # f. pressure
            watermark = LEDGER.total_bytes(device_only=True) - 1
            mgr.configure(watermark_bytes=watermark)
            summary = mgr.relayout_once()
            promoted = mgr.promote(view)
            q = f"Count(Intersect(Row(fingerprint={QUERY_MOL}), " \
                f"Row(fingerprint={target})))"
            (got,) = ex.execute("mole", q)
            if got != want[cands.index(target)] or \
                    view.layout_mode != "dense":
                raise AssertionError("layout: the dense read after the "
                                     "promotion is wrong")
            report["pressure"] = {"watermark": watermark,
                                  "summary": summary,
                                  "promote_after": promoted}
            log(f"layout: relayout_once over a watermark of {watermark}: "
                f"{summary}; promote() after it: {promoted}; dense read "
                "exact")
            memory_line("layout_pressure", device)
            # g. the budget
            foreign = [(getattr(v, "index", "?"), getattr(v, "field", "?"))
                       for v, _ in BANK_BUDGET._entries.values()
                       if v is not view]
            if foreign:
                raise AssertionError(f"layout budget: banks of other views "
                                     f"are resident: {foreign[:8]}")
            saved, before = BANK_BUDGET.budget, dict(BANK_BUDGET._entries)
            expect = BANK_BUDGET._pick_victim(
                BANK_BUDGET._eviction_scores())
            BANK_BUDGET.budget = BANK_BUDGET.total - 1
            try:
                (got,) = ex.execute("mole", f"Count(Row(fingerprint="
                                            f"{cands[6]}))")
                evicted = [ek for ek in before
                           if ek not in BANK_BUDGET._entries]
                if expect not in evicted or \
                        BANK_BUDGET.total > BANK_BUDGET.budget:
                    raise AssertionError(f"layout budget: evicted "
                                         f"{evicted}, expected {expect}, "
                                         f"total {BANK_BUDGET.total} of "
                                         f"{BANK_BUDGET.budget}")
                if got != len(set(np.unique(pos[cands[6]]).tolist())
                              | set(extra.get(cands[6], ()))):
                    raise AssertionError("layout budget: the read is "
                                         "wrong")
                victims = [(getattr(before[ek][0], "field", "?"),
                            repr(ek[1])[:80], before[ek][1])
                           for ek in evicted]
                total_in_budget = BANK_BUDGET.total
            finally:
                BANK_BUDGET.budget = saved
            # The evicted bank rebuilds on its next read.
            vview, vkey = before[expect][0], expect[1]
            if vview is view and isinstance(vkey, tuple) and \
                    vkey and vkey[0] == "pbank":
                for name, pql in FP_QUERIES:
                    (res,) = ex.execute("mole", pql)
                    if res.pairs != fp_want[name]:
                        raise AssertionError(f"layout budget: {name} after "
                                             "the eviction")
            elif vview is view and len(vkey) == 3 and \
                    isinstance(vkey[2], tuple):
                for r in vkey[2]:
                    (res,) = ex.execute("mole", f"Count(Row(fingerprint="
                                                f"{r}))")
                    if res != len(set(np.unique(pos[r]).tolist())
                                  | set(extra.get(r, ()))):
                        raise AssertionError("layout budget: a row after "
                                             "the eviction")
            else:
                raise AssertionError(f"layout budget: the victim "
                                     f"{victims} is not this view's")
            if (id(vview), vkey) not in BANK_BUDGET._entries:
                raise AssertionError("layout budget: the evicted bank did "
                                     "not rebuild")
            report["budget"] = {"evicted": victims,
                                "total_within": total_in_budget,
                                "evictions": BANK_BUDGET.evictions}
            log(f"layout: budget set under the resident total evicted "
                f"{victims} (the ranking's pick); it rebuilt exactly on its "
                "next read; budget restored")
        report["ref_calls"] = refs.calls
        if cuda and refs.calls:
            raise AssertionError(f"layout: plain versions called on the "
                                 f"card: {refs.calls}")
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
    report["seconds"] = time.perf_counter() - t_phase
    report["launches"] = {k: v for k, v in launches.items() if v}
    log(f"layout: phase done in {report['seconds']:.1f} s")
    return report, launches, timing_in


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
              "p50_s": burst_p50(ex, reqs, want, device, iters),
              "spread_s": spread(burst_times(ex, reqs, want, device,
                                             PROBE_SAMPLES))}
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
    api = cache_off(API(holder))
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



# ------------------------------------------------------------- measure

MEASURE_BURSTS = 20  # sampled bursts of phase (d)
MEASURE_COST_ITERS = 21  # bursts a turn of phase (g)


def eval_nodes(tree):
    """Every ``eval:*`` node of a profile tree (its JSON form)."""
    out = []
    for op in tree.get("ops", []):
        stack = [op]
        while stack:
            node = stack.pop()
            if node.get("name", "").startswith("eval:"):
                out.append(node)
            stack.extend(node.get("children", []))
    return out


def parse_prometheus(text):
    """{family: TYPE} of Prometheus text, each sample checked to name a
    family declared before it and to carry a number."""
    families = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            families[name] = typ
        elif line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in families:
                    base = name[:-len(suffix)]
            if base not in families:
                raise AssertionError(f"measure: /metrics sample {line!r} "
                                     "has no TYPE line before it")
            float(line.rsplit(" ", 1)[1])
    return families


def run_measure(holder, want_taxi, want_burst, burst, device,
                iters=ITERS):
    """The measurement plane on the loaded taxi holder, through the
    port's server (API with a memory stats client and a span recorder, a
    coalescer, the HTTP routes):

    (a) sampling off: the five taxi queries and the burst over HTTP take
        no fence (``_fence_device`` calls counted), and one burst's whole
        launch, with cost attribution and timeline events, runs under
        ``set_sync_debug_mode("error")``;
    (b) the roofline resolves the card's own kind, not estimated;
    (c) ``?profile=true`` on the five queries and on ``/batch/query``:
        every eval has ``deviceS > 0``, the burst's ``launchBytes`` is
        ``plan_cost`` of its plan, the answers exact;
    (d) sampling at 1: MEASURE_BURSTS bursts, ``/debug/roofline`` read,
        the launch's sampled ``deviceS`` at least 0.8 x the event-timed
        kernel on the same plan (``burst["kernel_ms"]``) and at most the
        burst's wall time;
    (e) ``/metrics`` parses with the executor, roofline, idle-ratio and
        memory families, ``pilosa_roofline_gbps`` the resolved figure;
    (f) ``/debug/timeline`` is trace-event JSON with device slices;
    (g) the burst's p50 with the plane on and sampling off, beside the
        roofline and timeline recorders off (recorded, not asserted).

    Launch counts are set to 0 just before and read just after; no plain
    version may run on the card. Returns (report, launches)."""
    import torch
    from pilosa_tpu_torch.executor import executor as ex_mod
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.ops import megakernel as mk
    from pilosa_tpu_torch.server import API, serve
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    from pilosa_tpu_torch.utils.stats import MemStatsClient
    from pilosa_tpu_torch.utils.timeline import LANE_DEVICE, TIMELINE
    from pilosa_tpu_torch.utils.tracing import RecordingTracer
    cuda = device != "cpu"
    t_phase = time.perf_counter()
    api = cache_off(API(holder, stats=MemStatsClient(),
                        tracer=RecordingTracer()))
    api.coalescer = QueryCoalescer(api.executor, stats=api.stats,
                                   tracer=api.tracer)
    api.coalescer.start()
    srv = serve(api, "127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    ex = api.executor
    ROOFLINE.reset()
    ROOFLINE.configure(enabled=True, gbps=0)
    TIMELINE.reset()
    TIMELINE.configure(enabled=True, sample_every=1)
    fences = [0]
    fenced_s = []
    real_fence = ex_mod._fence_device

    def counted_fence(start):
        fences[0] += 1
        fenced_s.append(real_fence(start))
        return fenced_s[-1]

    plans = []
    build_fn = megamod._build

    def capture(cohort):
        plan, w_mega, lanes = build_fn(cohort)
        plans.append((plan, cohort[0].entries[0].n_shards, w_mega))
        return plan, w_mega, lanes

    prev_mega = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        megamod.MEGAKERNEL_ENABLED = True  # rehearsal: off by default
    items = [{"index": "taxi", "query": q} for _, q in BURST]
    want_items = [{"results": [burst_json(n, want_burst[n])]}
                  for n, _ in BURST]
    reqs = [("taxi", q, None) for _, q in BURST]
    report = {}

    def post_taxi(suffix=""):
        out = {}
        for name, pql in TAXI_QUERIES:
            got = http_json(base, "POST", f"/index/taxi/query{suffix}",
                            pql)
            if got["results"] != [taxi_json(name, want_taxi[name])]:
                raise AssertionError(f"measure: {name} != numpy")
            out[name] = got
        return out

    def post_burst(suffix=""):
        t0 = time.perf_counter()
        got = http_json(base, "POST", f"/batch/query{suffix}",
                        {"queries": items})["responses"]
        wall = time.perf_counter() - t0
        if [{"results": g["results"]} for g in got] != want_items:
            raise AssertionError("measure: /batch/query burst != numpy")
        return got, wall

    kernels.reset_launches()
    try:
        ex_mod._fence_device = counted_fence
        megamod._build = capture
        with RefCalls(kernels) as refs:
            # (a) sampling off: no fence, no sync.
            api.profiler.configure(sample_every=0)
            post_taxi()
            post_burst()
            if fences[0]:
                raise AssertionError(f"measure: {fences[0]} fences with "
                                     "sampling off")
            profs = [api.profiler.begin("taxi", q, None) for _, q in BURST]
            for p in profs:
                p.timeline = TIMELINE.begin(None, "taxi")
            before = mega_state(ex)
            if cuda:
                torch.cuda.synchronize()
                with NoStreamSync(torch):
                    flight = ex.execute_batch_begin(reqs, profiles=profs)
            else:
                flight = ex.execute_batch_begin(reqs, profiles=profs)
            burst_answers(ex.execute_batch_finish(flight), want_burst)
            check_mega_taken(ex, before, "the sync-checked burst")
            if fences[0] or any(p.sample_device for p in profs):
                raise AssertionError("measure: the unsampled burst fenced")
            if not all(eval_nodes(p.to_json()) and all(
                    "megaBatch" in n and "deviceS" not in n
                    for n in eval_nodes(p.to_json())) for p in profs):
                raise AssertionError("measure: the unsampled burst's evals "
                                     "lack their launch attribution")
            report["unsampled"] = {"fences": fences[0],
                                   "sync_checked_launch": bool(cuda)}
            # (b) the roofline of this card.
            gbps, kind, estimated = ROOFLINE.roofline_gbps()
            report["roofline"] = {"gbps": gbps, "kind": kind,
                                  "estimated": estimated}
            if cuda and (kind != torch.cuda.get_device_name(0)
                         or estimated):
                raise AssertionError(f"measure: roofline resolved "
                                     f"{report['roofline']}")
            log(f"measure: roofline {gbps} GB/s for {kind!r}"
                f"{' (estimate)' if estimated else ''}")
            # (c) forced profiles.
            forced = post_taxi("?profile=true")
            for name, got in forced.items():
                # TopN without a filter evaluates no tree: no eval node.
                evs = eval_nodes(got["profile"])
                if (not evs and name != "topn") or not all(
                        n.get("deviceS", 0) > 0 for n in evs):
                    raise AssertionError(f"measure: {name} profile evals "
                                         f"without deviceS: {evs}")
            n_plans = len(plans)
            got, _ = post_burst("?profile=true")
            plan, n_shards, w_mega = plans[n_plans]
            cost = mk.plan_cost(plan, n_shards, w_mega)
            for g in got:
                evs = eval_nodes(g["profile"])
                if len(evs) != 1 or evs[0].get("deviceS", 0) <= 0 or \
                        evs[0].get("launchBytes") != cost["totalBytes"]:
                    raise AssertionError(f"measure: burst profile {evs} "
                                         f"against plan_cost "
                                         f"{cost['totalBytes']}")
            report["forced"] = {
                "taxi_device_s": {k: [n["deviceS"] for n in eval_nodes(
                    v["profile"])] for k, v in forced.items()},
                "burst_device_s": eval_nodes(got[0]["profile"])[0][
                    "deviceS"],
                "launch_bytes": cost["totalBytes"], "cost": cost}
            # (d) sampling at 1.
            ROOFLINE.reset()
            api.profiler.configure(sample_every=1)
            walls = []
            first = len(fenced_s)
            for _ in range(MEASURE_BURSTS):
                n_plans = len(plans)
                got, wall = post_burst()
                walls.append(wall)
                if len(plans) != n_plans + 1:
                    raise AssertionError("measure: a sampled burst took "
                                         f"{len(plans) - n_plans} launches")
            stats_dev = api.stats.snapshot()["timings"].get(
                "executor.device{sampled:true}", {})
            roof = http_json(base, "GET", "/debug/roofline")
            fenced = roof["fencedLaunches"]
            if fenced < MEASURE_BURSTS:
                raise AssertionError(f"measure: {fenced} fenced launches "
                                     f"of {MEASURE_BURSTS} sampled bursts")
            dev_s = p50(fenced_s[first:])
            kernel_s = burst.get("kernel_ms", 0.0) / 1e3
            wall_p50 = p50(walls)
            if cuda and not (0.8 * kernel_s <= dev_s <= wall_p50):
                raise AssertionError(
                    f"measure: sampled deviceS {dev_s:.6f} s outside "
                    f"[0.8 x {kernel_s:.6f}, {wall_p50:.6f}]")
            report["sampled"] = {
                "bursts": MEASURE_BURSTS, "launches": roof["launches"],
                "fenced_launches": fenced,
                "device_s_p50": dev_s,
                "device_s_min": min(fenced_s[first:]),
                "device_s_mean": roof["deviceSecondsSampled"] / fenced,
                "kernel_event_s": kernel_s,
                "device_to_kernel": dev_s / kernel_s if kernel_s else None,
                "burst_wall_p50_s": wall_p50,
                "achieved_gbps": roof["achievedGbps"],
                "roofline_fraction": roof["rooflineFraction"],
                "unattributed_fences": roof["unattributedFences"],
                "cohorts": [{k: c[k] for k in (
                    "cohort", "launches", "fenced", "lastCostBytes",
                    "achievedGbpsEwma", "deviceSecondsEwma")}
                    for c in roof["cohorts"]],
                "executor_device_timing": stats_dev,
                "predicted_bytes": (roof["cohorts"][0]["predictedBytesEwma"]
                                    if roof["cohorts"] else None)}
            log(f"measure: {fenced} fenced launches, deviceS {dev_s:.6f} s "
                f"a launch (the event-timed kernel {kernel_s:.6f} s, the "
                f"burst's wall p50 {wall_p50:.6f} s), achieved "
                f"{roof['achievedGbps']:.1f} GB/s, rooflineFraction "
                f"{roof['rooflineFraction']:.3f}")
            # (e) /metrics.
            status, raw = http(base, "GET", "/metrics")
            if status != 200:
                raise AssertionError(f"measure: /metrics {status}")
            text = raw.decode()
            fams = parse_prometheus(text)
            for prefix in ("pilosa_executor_", "pilosa_roofline_",
                           "pilosa_device_idle_ratio", "pilosa_memory_"):
                if not any(f.startswith(prefix) for f in fams):
                    raise AssertionError(f"measure: /metrics lacks "
                                         f"{prefix}*")
            gline = [ln for ln in text.splitlines()
                     if ln.startswith("pilosa_roofline_gbps ")]
            if not gline or float(gline[0].split()[1]) != gbps:
                raise AssertionError(f"measure: pilosa_roofline_gbps "
                                     f"{gline} != {gbps}")
            idle = [float(ln.split()[1]) for ln in text.splitlines()
                    if ln.startswith("pilosa_device_idle_ratio ")]
            report["metrics"] = {"families": len(fams),
                                 "device_idle_ratio": idle[0],
                                 "roofline_gbps": gbps}
            # (f) /debug/timeline.
            doc = http_json(base, "GET", "/debug/timeline")
            evs = doc["traceEvents"]
            for ev in evs:
                if not all(k in ev for k in ("ph", "ts", "dur", "pid",
                                             "tid", "name")):
                    raise AssertionError(f"measure: trace event {ev}")
            device_slices = [e for e in evs if e["ph"] == "X"
                             and e["name"] == "device"
                             and e["tid"] == LANE_DEVICE]
            if not device_slices:
                raise AssertionError("measure: no device slices in "
                                     "/debug/timeline")
            report["timeline"] = {
                "events": len(evs), "device_slices": len(device_slices),
                "idle_ratio": doc["summary"]["deviceIdleRatio"],
                "dispatch_gap": doc["summary"]["dispatchGap"],
                "stage_median_s": doc["summary"]["stageMedianS"]}
            # (g) the plane's host cost with sampling off.
            api.profiler.configure(sample_every=0)
            cost_p50 = {"plane_on": [], "plane_off": []}
            for turn in ("plane_on", "plane_off", "plane_off",
                         "plane_on", "plane_on", "plane_off"):
                on = turn == "plane_on"
                ROOFLINE.configure(enabled=on)
                TIMELINE.configure(enabled=on)
                times = []
                for _ in range(MEASURE_COST_ITERS):
                    t0 = time.perf_counter()
                    out = api.query_batch(items)
                    times.append(time.perf_counter() - t0)
                    if [{"results": o["results"]} for o in out] != \
                            want_items:
                        raise AssertionError("measure: cost burst != numpy")
                cost_p50[turn].append(p50(times))
            ROOFLINE.configure(enabled=True)
            TIMELINE.configure(enabled=True)
            report["cost"] = {k: v for k, v in cost_p50.items()}
            log(f"measure: burst p50 with the plane on "
                f"{cost_p50['plane_on']} s, off {cost_p50['plane_off']} s "
                "(sampling off)")
        if cuda and refs.calls:
            raise AssertionError(f"measure: plain versions ran on the card: "
                                 f"{refs.calls}")
    finally:
        ex_mod._fence_device = real_fence
        megamod._build = build_fn
        megamod.MEGAKERNEL_ENABLED = prev_mega
        srv.shutdown()
        srv.server_close()
        api.coalescer.stop()
    launches = dict(kernels.LAUNCHES)
    if cuda:
        for name in ("bank_row_counts", "bank_row_counts_masked",
                     "bsi_plane_counts", "mega_interpret"):
            if launches[name] <= 0:
                raise AssertionError(f"measure: {name} never launched")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    log(f"measure: done in {report['seconds']:.1f} s; launches {launches}")
    return report, launches


# ------------------------------------------------------------- serving

SERVING_HTTP_READS = 200  # reads from the burst's mix over HTTP
SERVING_RIDE = 13  # the phase's new ride is rides + 13, removed after
# The phase's server config (``cli server -c``): an SLO, the result cache
# and workload keys, the sentinel's rings, a watchdog sample every 0.25 s
# (the sentinel's history), and no background layout pass.
SERVING_TOML = """bind = "127.0.0.1:0"
[slo]
query = "99% < 25ms"
[cache]
result_enabled = true
result_max_bytes = 268435456
[workload]
top_k = 5
max_signatures = 2048
[sentinel]
ring = 120
decimate = 4
[telemetry]
sample_every_s = 0.25
[layout]
interval_s = 0.0
"""


class LogLines:
    """A ``printf`` logger keeping its lines (the shutdown dumps)."""

    def __init__(self):
        self.lines = []

    def printf(self, fmt, *args):
        self.lines.append(fmt % args if args else fmt)


def spread(times):
    """The p50 (s) of ``times`` with its spread: p10, p90 and the count."""
    t = sorted(times)
    n = len(t)
    return {"p50": t[n // 2], "p10": t[n // 10],
            "p90": t[min(n - 1, 9 * n // 10)], "n": n}


def in_turns(order, samples, run):
    """``run(side)`` (one timed request, in s) ``samples`` times for each
    side of ``order``, in its turns (a side's samples split evenly over
    its turns, as in hit, miss, miss, hit: the host drifts across
    turns). Returns side -> ``spread``."""
    times = {}
    for side in order:
        for _ in range(samples // order.count(side)):
            times.setdefault(side, []).append(run(side))
    return {side: spread(t) for side, t in times.items()}


def serving_answer(name, got):
    """A TAXI_QUERIES or BURST answer as the checks compare it."""
    if name in dict(BURST):
        return got if isinstance(got, int) else got.columns().tolist()
    return taxi_answer(name, got)


def serving_wants(want_taxi, want_burst):
    """(name, PQL, want) of the phase's cached reads: the taxi queries
    that are Counts and the burst's Row request."""
    rows_name, rows_pql = BURST[-1]
    return [(n, q, want_taxi[n]) for n, q in TAXI_QUERIES
            if q.startswith("Count(")] + \
        [(rows_name, rows_pql, want_burst[rows_name])]


def serving_in_process(holder, device, want_taxi, want_burst,
                       taxi_launches, samples):
    """Steps (a)-(b) of ``run_serving``: the five taxi queries as misses
    on a new Executor (its cache on), then the cached reads' repeats as
    eval-tier hits with no launch and no plain version, one under
    ``set_sync_debug_mode("error")``; TopN and Sum never look up."""
    import torch
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.ops import kernels
    cuda = device != "cpu"
    ex = Executor(holder, device=device)
    rc = ex.result_cache
    if not rc.enabled:
        raise AssertionError("serving: the result cache is off by default")
    report = {}
    kernels.reset_launches()
    for name, pql in TAXI_QUERIES:
        (got,) = ex.execute("taxi", pql)
        if taxi_answer(name, got) != want_taxi[name]:
            raise AssertionError(f"serving: {name} miss differs")
    launched = sorted(k for k, v in kernels.LAUNCHES.items() if v)
    if launched != sorted(k for k, v in taxi_launches.items() if v):
        raise AssertionError(f"serving: the misses launched {launched}, "
                             f"the taxi phase {taxi_launches}")
    report["miss_launches"] = dict(kernels.LAUNCHES)
    cached = serving_wants(want_taxi, want_burst)
    (got,) = ex.execute("taxi", cached[-1][1])  # the Row request's miss
    if serving_answer(cached[-1][0], got) != cached[-1][2]:
        raise AssertionError("serving: the Row request's miss differs")
    # Each cached read hit and missed (the cache off) in turns hit, miss,
    # miss, hit: every hit answers from the eval tier with no launch and
    # no plain version (nor does a miss on the card), one more hit of
    # each under the sync check.
    hits0 = rc.hits["eval"]
    timed = {}
    with RefCalls(kernels) as refs:
        for name, pql, want in cached:
            def run(side):
                rc.enabled = side == "hit"
                h0, l0 = rc.hits["eval"], dict(kernels.LAUNCHES)
                r0 = sum(refs.calls.values())
                t0 = time.perf_counter()
                (got,) = ex.execute("taxi", pql)
                if not isinstance(got, int):
                    got.columns()  # a Row answer's copy (a miss) and unpack
                elif cuda:
                    torch.cuda.synchronize()
                s = time.perf_counter() - t0
                if serving_answer(name, got) != want:
                    raise AssertionError(f"serving: {name} {side} differs")
                if side == "hit" and (
                        rc.hits["eval"] != h0 + 1
                        or dict(kernels.LAUNCHES) != l0
                        or sum(refs.calls.values()) != r0
                        or not (type(got) is int
                                or getattr(got, "cached", False))):
                    raise AssertionError(
                        f"serving: {name}'s repeat is no clean eval-tier "
                        f"hit: a {type(got).__name__}, launches {l0} -> "
                        f"{dict(kernels.LAUNCHES)}, plain versions "
                        f"{refs.calls}")
                return s
            timed[name] = in_turns(("hit", "miss", "miss", "hit"),
                                   samples, run)
        rc.enabled = True
        if cuda:
            NoStreamSync.bites(torch, device)
            with NoStreamSync(torch):
                for name, pql, want in cached:
                    (got,) = ex.execute("taxi", pql)
                    if serving_answer(name, got) != want:
                        raise AssertionError(f"serving: {name} differs "
                                             "under the sync check")
    n_hits = rc.hits["eval"] - hits0
    want_hits = (samples + int(cuda)) * len(cached)
    if n_hits != want_hits or (cuda and refs.calls):
        raise AssertionError(f"serving: {n_hits} eval hits (want "
                             f"{want_hits}), plain versions {refs.calls}")
    hit_s = {n: t["hit"] for n, t in timed.items()}
    miss_s = {n: t["miss"] for n, t in timed.items()}
    # TopN and Sum are not eligible: no lookup, no counter moves.
    counters = (dict(rc.hits), dict(rc.misses))
    for name, pql in TAXI_QUERIES:
        if not pql.startswith("Count("):
            (got,) = ex.execute("taxi", pql)
            if taxi_answer(name, got) != want_taxi[name]:
                raise AssertionError(f"serving: {name} differs")
    if (dict(rc.hits), dict(rc.misses)) != counters:
        raise AssertionError("serving: TopN or Sum moved a result-cache "
                             "counter")
    report.update(hit_s=hit_s, miss_s=miss_s, eval_hits=n_hits,
                  hit_launches=0, hit_ref_calls=0,
                  sync_checked_hits=len(cached) if cuda else 0)
    log(f"serving: {n_hits} eval-tier hits, no launch, no plain version; "
        f"hit p50 {({n: t['p50'] for n, t in hit_s.items()})} s against "
        f"miss p50 {({n: t['p50'] for n, t in miss_s.items()})} s")
    return ex, report


def serving_burst(holder, device, want_burst, n_rides, samples):
    """Step (c) of ``run_serving``: the burst's miss in one launch, its
    repeat in none, the cache's miss overhead, then a new ride's Set
    into cab_type=1 and the relaunch of only the members that read
    cab_type; the ride is removed again (its Clear and its existence
    bit), so the later phases see the index they expect."""
    import torch
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils.hotspots import WORKLOAD
    cuda = device != "cpu"
    reqs = [("taxi", pql, None) for _, pql in BURST]
    n_cab = sum("cab_type" in pql for _, pql in BURST)
    prev = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        # Rehearsal only: the megakernel defaults to off on the CPU.
        megamod.MEGAKERNEL_ENABLED = True
    report = {}
    try:
        ex = Executor(holder, device=device)
        rc = ex.result_cache

        def run(want):
            t0 = time.perf_counter()
            out = ex.execute_batch(reqs)
            if cuda:
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
            burst_answers(out, want)
            return s

        kernels.reset_launches()
        m0 = mega_state(ex)
        report["miss_s"] = run(want_burst)
        if mega_state(ex) != (m0[0] + 1,) + m0[1:] or (
                cuda and kernels.LAUNCHES["mega_interpret"] != 1):
            raise AssertionError(f"serving: the burst's miss: mega "
                                 f"{m0} -> {mega_state(ex)}, launches "
                                 f"{kernels.LAUNCHES}")
        report["miss_launches"] = dict(kernels.LAUNCHES)
        l1, m1, h1 = dict(kernels.LAUNCHES), mega_state(ex), \
            rc.hits["eval"]
        with RefCalls(kernels) as refs:
            report["hit_s"] = run(want_burst)
        if mega_state(ex) != m1 or dict(kernels.LAUNCHES) != l1 \
                or rc.hits["eval"] != h1 + len(BURST) or refs.calls:
            raise AssertionError("serving: the burst's repeat launched or "
                                 "missed")
        report["hit_s"] = spread([run(want_burst)
                                  for _ in range(samples)])
        # The cache's miss overhead on the unsampled burst: every call a
        # miss (a cache of 0 bytes fills nothing), against the cache off
        # (the workload recorder still walks each eval), against no walk
        # at all (the recorder off too); in turns A B C C B A, since the
        # burst's host time drifts across turns.
        budget = rc.max_bytes
        modes = {"miss_path": (True, 0, True),
                 "off": (False, budget, True),
                 "off_no_walk": (False, budget, False)}

        def run_mode(key):
            enabled, max_bytes, walk = modes[key]
            if rc.max_bytes != max_bytes:
                rc.configure(max_bytes=max_bytes)
            rc.enabled, WORKLOAD.enabled = enabled, walk
            try:
                return run(want_burst)
            finally:
                WORKLOAD.enabled = True
        report["overhead_s"] = in_turns(
            list(modes) + list(modes)[::-1], samples, run_mode)
        rc.configure(max_bytes=budget)
        rc.enabled = True
        run(want_burst)  # refill
        col = n_rides + SERVING_RIDE
        (ok,) = ex.execute("taxi", f"Set({col}, cab_type=1)")
        if ok is not True:
            raise AssertionError(f"serving: the Set answered {ok}")
        # The new ride is in cab_type 1 and in no other field.
        want2 = dict(want_burst)
        want2["not_cab0"] += 1
        want2["cab1_minus_dist_gt_20"] += 1
        kernels.reset_launches()
        m2, q2, h2 = mega_state(ex), ex.mega_queries, rc.hits["eval"]
        report["after_write_s"] = run(want2)
        relaunched = ex.mega_queries - q2
        if mega_state(ex) != (m2[0] + 1,) + m2[1:] \
                or relaunched != n_cab \
                or rc.hits["eval"] != h2 + len(BURST) - n_cab \
                or (cuda and kernels.LAUNCHES["mega_interpret"] != 1):
            raise AssertionError(
                f"serving: after the write {relaunched} members relaunched"
                f" (want {n_cab}), hits {rc.hits['eval'] - h2}, mega "
                f"{m2} -> {mega_state(ex)}, launches {kernels.LAUNCHES}")
        report["after_write_launches"] = dict(kernels.LAUNCHES)
        report["relaunched_members"] = relaunched
        report["after_write_hits"] = len(BURST) - n_cab
        ex.execute("taxi", f"Clear({col}, cab_type=1)")
        holder.index("taxi").existence_field().clear_bit(0, col)
        run(want_burst)
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
    log(f"serving: the burst missed in one launch ({report['miss_s']:.4f}"
        f" s), hit in none (p50 {report['hit_s']['p50']:.6f} s); after a "
        f"write {report['relaunched_members']} members relaunched in one "
        f"launch, {report['after_write_hits']} hit")
    return ex, report


def serving_request_tier(holder, ex, want_taxi):
    """Step (d) of ``run_serving``: execute_full of a Count twice (a
    request-tier hit), and a SetRowAttrs invalidating a Row answer that
    embeds those attributes (on a field made and dropped here)."""
    import numpy as np
    rc = ex.result_cache
    pql = TAXI_QUERIES[0][1]
    want = {"results": [want_taxi[TAXI_QUERIES[0][0]]]}
    h0 = rc.hits["request"]
    if ex.execute_full("taxi", pql) != want or \
            ex.execute_full("taxi", pql) != want or \
            rc.hits["request"] != h0 + 1:
        raise AssertionError("serving: execute_full's repeat is no "
                             "request-tier hit")
    idx = holder.index("taxi")
    cols = np.arange(50, dtype=np.uint64) * 997
    idx.create_field("serving_tag").import_bits(
        np.ones(50, np.uint64), cols)
    try:
        answers = []
        for zone in ("a", "b"):
            ex.execute("taxi", f'SetRowAttrs(serving_tag, 1, zone="{zone}")')
            h = rc.hits["request"]
            first = ex.execute_full("taxi", "Row(serving_tag=1)")
            again = ex.execute_full("taxi", "Row(serving_tag=1)")
            answers.append((first, again, rc.hits["request"] - h))
        for (first, again, hits), zone in zip(answers, "ab"):
            row = first["results"][0]
            if again != first or row["attrs"] != {"zone": zone} or \
                    row["columns"] != cols.tolist() or hits != 1:
                raise AssertionError(f"serving: the Row answer after "
                                     f"SetRowAttrs: {row['attrs']}, "
                                     f"{hits} hits")
    finally:
        idx.delete_field("serving_tag")
    log("serving: execute_full's repeat hit the request tier; "
        "SetRowAttrs invalidated the embedding answer")
    return {"request_hits": rc.hits["request"] - h0}


def serving_http(holder, want_taxi, want_burst, samples):
    """Step (e) of ``run_serving``: the server ``cli server -c`` builds
    (``cli.main.build_server`` of SERVING_TOML) over the in-memory taxi
    holder: HTTP miss and hit p50s, 200 reads of the burst's mix (half
    of them spelled apart, so the eval tier serves what the request tier
    misses), the planes' routes and metric families, and the shutdown's
    dumps."""
    import tempfile
    import threading
    from pilosa_tpu_torch.cli.main import build_server, stop_server
    from pilosa_tpu_torch.utils.config import load_config
    from pilosa_tpu_torch.utils.hotspots import WORKLOAD
    from pilosa_tpu_torch.utils.sentinel import SENTINEL
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.toml")
        with open(path, "w") as f:
            f.write(SERVING_TOML)
        cfg = load_config(path)
    api, srv, watchdog = build_server(cfg, holder)
    api.logger = logs = LogLines()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    report = {}
    try:
        name, pql = TAXI_QUERIES[0]
        want = {"results": [want_taxi[name]]}
        rc = api.executor.result_cache
        http_json(base, "POST", "/index/taxi/query", pql)

        def run(side):
            rc.enabled = side == "hit"
            h0 = rc.hits["request"]
            t0 = time.perf_counter()
            got = http_json(base, "POST", "/index/taxi/query", pql)
            s = time.perf_counter() - t0
            if got != want or (side == "hit") != (rc.hits["request"] > h0):
                raise AssertionError(f"serving: HTTP {side} answered {got}"
                                     f", request hits {h0} -> "
                                     f"{rc.hits['request']}")
            return s
        timed = in_turns(("hit", "miss", "miss", "hit"), samples, run)
        rc.enabled = True
        report["http_hit_s"], report["http_miss_s"] = timed["hit"], \
            timed["miss"]
        sent = 0
        rounds = 0
        while sent < SERVING_HTTP_READS:
            batch = BURST[:SERVING_HTTP_READS - sent]
            spelled = [(n, q if rounds % 2 == 0 else q.replace("(", "( ", 1))
                       for n, q in batch]
            out, _ = concurrent_round(base, spelled)
            for n, _q in batch:
                if out[n] != {"results": [burst_json(n, want_burst[n])]}:
                    raise AssertionError(f"serving: HTTP {n} differs")
            sent += len(batch)
            rounds += 1
        deadline = time.time() + 60
        while api.watchdog.samples_taken < 3:
            if time.time() > deadline:
                raise AssertionError("serving: the watchdog took no sample")
            time.sleep(0.05)
        hot = http_json(base, "GET", "/debug/hotspots")
        saved = [s for s in hot["opportunity"]["signatures"]
                 if (s["estSavedS"] or 0) > 0]
        if not hot["signatures"] or not saved or \
                hot["queriesWindow"]["ratio"] <= 0 or \
                hot["requestsWindow"]["ratio"] <= 0 or \
                hot["resultCache"]["hits"] <= 0 or \
                "observed" not in hot["opportunity"]:
            raise AssertionError(f"serving: /debug/hotspots {hot}")
        history = http_json(base, "GET", "/debug/history")
        slo = http_json(base, "GET", "/debug/slo")
        health = http_json(base, "GET", "/internal/health")
        status, raw = http(base, "GET", "/metrics")
        metrics = raw.decode()
        if history["samples"] < 1 or "result_cache_hit_ratio" not in \
                history["series"] or \
                slo["objectives"]["query"]["thresholdS"] != 0.025 or \
                not any(e.get("alias") == "query" for e in slo["endpoints"]):
            raise AssertionError(f"serving: /debug/history or /debug/slo: "
                                 f"{history['samples']}, {slo}")
        missing = [k for k in ("resultCache", "workload", "slo", "layout",
                               "timeline") if k not in health]
        families = {fam: fam in metrics for fam in (
            "pilosa_result_cache_hits_total", "pilosa_result_cache_bytes",
            "pilosa_workload_tracked_signatures",
            "pilosa_sentinel_series")}
        if status != 200 or missing or not all(families.values()):
            raise AssertionError(f"serving: health lacks {missing}, "
                                 f"metrics {families}")
        report.update(
            reads=sent, rounds=rounds,
            tiers=hot["resultCache"]["tiers"],
            hit_ratio=hot["resultCache"]["hitRatio"],
            query_repeat_ratio=hot["queriesWindow"]["ratio"],
            request_repeat_ratio=hot["requestsWindow"]["ratio"],
            signatures=len(hot["signatures"]),
            est_saved_s=hot["opportunity"]["totalEstSavedS"],
            history_samples=history["samples"],
            slo_endpoints=[e["endpoint"] for e in slo["endpoints"]],
            health_stanzas=sorted(health), families=families)
    finally:
        srv.shutdown()
        stop_server(api, srv, watchdog)
        WORKLOAD.configure(top_k=10, max_signatures=1024)
        SENTINEL.configure(enabled=True, ring=720, decimate=10,
                           alert_ring=256, objectives={})
    dumps = {k: any(ln.startswith(k) for ln in logs.lines)
             for k in ("workload:", "sentinel:")}
    if not all(dumps.values()):
        raise AssertionError(f"serving: the shutdown dumps {dumps}")
    report["shutdown_dumps"] = dumps
    log(f"serving: over HTTP a hit p50 {report['http_hit_s']['p50']:.6f} s"
        f" against a miss p50 {report['http_miss_s']['p50']:.6f} s; "
        f"{sent} reads, tiers {report['tiers']}")
    return api, report


def serving_cli(device):
    """Step (f) of ``run_serving``: ``python -m pilosa_tpu_torch.cli
    server -c`` with SERVING_TOML as a subprocess on a small index made
    over HTTP: repeated reads hit the request tier, and on SIGTERM its
    log holds the workload recorder's and the sentinel's dumps."""
    import queue
    import signal
    import tempfile
    import threading
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.toml")
        with open(path, "w") as f:
            f.write(SERVING_TOML)
        cmd = [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
               "-c", path]
        if device == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines = queue.Queue()
        reader = threading.Thread(target=lambda: [lines.put(ln)
                                                  for ln in proc.stdout],
                                  daemon=True)
        reader.start()
        out = []
        try:
            # The config's log lines (objectives) come before the
            # listening line.
            while not out or "listening on " not in out[-1]:
                out.append(lines.get(timeout=300))
            base = out[-1].split("listening on ")[1].split()[0]
            for p, body in (("/index/sv", {}), ("/index/sv/field/f", {}),
                            ("/index/sv/field/f/import",
                             {"rowIDs": [1] * 100,
                              "columnIDs": list(range(0, 3000, 30))})):
                http_json(base, "POST", p, body)
            for _ in range(5):
                got = http_json(base, "POST", "/index/sv/query",
                                "Count(Row(f=1))")
                if got != {"results": [100]}:
                    raise AssertionError(f"serving: CLI answered {got}")
            deadline = time.time() + 60
            while http_json(base, "GET", "/internal/health")[
                    "watchdog"]["samples"] < 1:
                if time.time() > deadline:
                    raise AssertionError("serving: the CLI's watchdog "
                                         "took no sample")
                time.sleep(0.05)
            tiers = http_json(base, "GET",
                              "/debug/hotspots")["resultCache"]["tiers"]
            if tiers["request"]["hits"] < 4:
                raise AssertionError(f"serving: CLI cache tiers {tiers}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=30)  # the pipe's last lines
        while not lines.empty():
            out.append(lines.get())
    text = "".join(out)
    dumps = {k: k in text for k in ("workload:", "sentinel:")}
    if rc != 0 or not all(dumps.values()):
        raise AssertionError(f"serving: the CLI exited {rc}, dumps {dumps}")
    return {"start_to_sigterm_s": time.perf_counter() - t0,
            "tiers": tiers, "sigterm_dumps": dumps}


def run_serving(holder, device, want_taxi, want_burst, taxi_launches,
                n_rides, samples=SERVING_SAMPLES):
    """The serving phase on the taxi holder, after the measure phase: the
    result cache, on by default, in process (the taxi misses and their
    eval-tier hits, the burst's one launch, its repeat in none and its
    relaunch after a write, the request tier), then the serving planes
    over HTTP through the CLI's server wiring and the ``cli server -c``
    subprocess; last, the ``result_cache`` ledger bytes within the
    caches' budgets. Returns the report."""
    from pilosa_tpu_torch.utils.memledger import LEDGER
    t0 = time.perf_counter()
    ex1, report = serving_in_process(holder, device, want_taxi, want_burst,
                                     taxi_launches, samples)
    ex2, report["burst"] = serving_burst(holder, device, want_burst,
                                         n_rides, samples)
    report.update(serving_request_tier(holder, ex1, want_taxi))
    api, report["http"] = serving_http(holder, want_taxi, want_burst,
                                       samples)
    report["cli"] = serving_cli(device)
    caches = [ex1.result_cache, ex2.result_cache, api.executor.result_cache]
    ledgered = sum(e["bytes"] for e in LEDGER.entries("result_cache"))
    if ledgered != sum(c.bytes for c in caches) or any(
            c.bytes > c.max_bytes for c in caches):
        raise AssertionError(f"serving: result_cache ledger {ledgered} "
                             f"against {[c.bytes for c in caches]}")
    report["ledger_bytes"] = ledgered
    report["cache_bytes"] = [c.bytes for c in caches]
    for c in caches:
        c.clear()
    report["seconds"] = time.perf_counter() - t0
    log(f"serving: {report['seconds']:.1f} s, result_cache ledger "
        f"{ledgered} bytes")
    return report


# ------------------------------------------------------------- cluster

SWEEPS = ("bank_row_counts", "bank_row_counts_masked", "bsi_plane_counts")


def cluster_wants(cab, pax, dist, want_gb):
    """What the cluster phase checks besides the taxi and burst answers:
    the per-shard counts its TopN expectations merge (pax, and cab_type
    under passenger_count=2 and dist > 100), and the two-level GroupBy
    in the reference's merge order (groups sorted by ``str(group)``)."""
    import numpy as np
    n_shards = (len(cab) + SHARD_WIDTH - 1) // SHARD_WIDTH
    pax_s = np.zeros((n_shards, 7), np.int64)
    filt_s = np.zeros((n_shards, 3), np.int64)
    for s in range(n_shards):
        sl = slice(s * SHARD_WIDTH, (s + 1) * SHARD_WIDTH)
        pax_s[s] = np.bincount(pax[sl].astype(np.int64), minlength=7)
        m = (pax[sl] == 2) & (dist[sl] > 100)
        filt_s[s] = np.bincount(cab[sl][m].astype(np.int64), minlength=3)
    gb = sorted(want_gb["pax_by_cab"], key=lambda g: str(g["group"]))
    return {"topn": pax_s, "topn_filtered": filt_s, "groupby": gb}


def topn_merge(per_shard, legs, n):
    """The reference's TopN merge on numpy's counts: each leg's top-n of
    its shards ((-count, id), counts above 0), summed in one pass, ties
    ordered by ``str(id)``, cut to n."""
    acc = {}
    for shards in legs:
        counts = per_shard[list(shards)].sum(axis=0)
        top = sorted(((r, int(c)) for r, c in enumerate(counts) if c > 0),
                     key=lambda rc: (-rc[1], rc[0]))[:n]
        for r, c in top:
            acc[r] = acc.get(r, 0) + c
    ordered = sorted(acc.items(), key=lambda kv: (-kv[1], str(kv[0])))[:n]
    return [{"id": r, "count": c} for r, c in ordered]


def cluster_expected(want_taxi, want_burst, wants, legs):
    """(pql, JSON answer) of every read of the phase under ``legs``
    (the shard lists the coordinator sends out)."""
    out = {}
    for name, pql in TAXI_QUERIES:
        if name in ("topn", "topn_filtered"):
            want = topn_merge(wants[name], legs, 3)
        else:
            want = taxi_json(name, want_taxi[name])
        out[name] = (pql, want)
    out["groupby"] = (GB_QUERIES[0][1], wants["groupby"])
    return out


def cluster_batch():
    return {"queries": [{"index": "taxi", "query": pql}
                        for _, pql in BURST]}


def cluster_batch_want(want_burst):
    return {"responses": [{"results": [burst_json(name, want_burst[name])]}
                          for name, _ in BURST]}


class NodeLaunches:
    """Kernel launches by the node whose request launched them: each
    node's ``API.query`` (the coordinator's request and its local leg,
    and a remote leg) tags its thread, and the launch counter records
    the tag beside ``kernels.LAUNCHES``, which it still counts."""

    def __init__(self, kernels, nodes):
        import threading
        self.kernels = kernels
        self.tls = threading.local()
        self.lock = threading.Lock()
        self.counts = {}
        self._orig = kernels._count_launch

        def counted(name, t0):
            self._orig(name, t0)
            tag = getattr(self.tls, "node", None)
            with self.lock:
                per = self.counts.setdefault(tag, {})
                per[name] = per.get(name, 0) + 1

        kernels._count_launch = counted
        for nd in nodes:
            self._tag(nd["api"], nd["id"])

    def _tag(self, api, node_id):
        inner = api.query

        def query(*a, **kw):
            prev = getattr(self.tls, "node", None)
            self.tls.node = node_id
            try:
                return inner(*a, **kw)
            finally:
                self.tls.node = prev

        api.query = query

    def take(self):
        with self.lock:
            out, self.counts = self.counts, {}
        return out

    def close(self):
        self.kernels._count_launch = self._orig


def cluster_start(device, n):
    """``n`` nodes of a static cluster in this process: each its own
    ``Holder``, ``API(cluster=...)`` (result cache off) and server on a
    free loopback port, ids n0.. in order, replica CLUSTER_REPLICAS,
    and a heartbeat each."""
    from pilosa_tpu_torch import Holder
    from pilosa_tpu_torch.parallel.cluster import STATE_NORMAL, Cluster, \
        Node
    from pilosa_tpu_torch.parallel.heartbeat import Heartbeater
    from pilosa_tpu_torch.server import API, serve
    nodes = []
    for i in range(n):
        holder = Holder(device=device)
        srv = serve(API(holder), "127.0.0.1", 0, background=True)
        nodes.append({"id": f"n{i}", "holder": holder, "srv": srv,
                      "base": f"http://127.0.0.1:{srv.server_address[1]}"})
    for nd in nodes:
        cluster = Cluster(Node(nd["id"], nd["base"]),
                          replica_n=CLUSTER_REPLICAS)
        for other in nodes:
            if other is not nd:
                cluster.add_node(Node(other["id"], other["base"]))
        cluster.set_state(STATE_NORMAL)
        nd["api"] = cache_off(API(nd["holder"], cluster=cluster))
        nd["cluster"] = cluster
        nd["srv"].RequestHandlerClass.api = nd["api"]
    for nd in nodes:
        nd["hb"] = Heartbeater(nd["cluster"], interval=CLUSTER_HB_INTERVAL,
                               suspect_after=CLUSTER_HB_SUSPECT,
                               timeout=CLUSTER_HB_TIMEOUT)
        nd["hb"].start()
    return nodes


def cluster_stop(nodes):
    for nd in nodes:
        nd["hb"].stop()
        nd["api"].broadcaster.stop()
        if nd["srv"] is not None:
            nd["srv"].shutdown()
            nd["srv"].server_close()
        nd["holder"].close()


def cluster_load(src, nodes):
    """The reference client's import: for every fragment of the source
    holder's taxi fields, its owners from node 0's
    ``/internal/fragment/nodes``, then the fragment's bytes POSTed to
    each owner's import-roaring route, eight requests at a time.
    Returns (seconds, bytes sent, fragments, fragments by node)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    base = nodes[0]["base"]
    by_uri = {nd["base"]: nd["id"] for nd in nodes}
    idx = src.index("taxi")
    fields = [f for f in PERSIST_FIELDS if idx.field(f) is not None]
    t0 = time.perf_counter()
    http_json(base, "POST", "/index/taxi", {"options": {}})
    for fname in fields:
        if fname == "_exists":
            continue
        opts = {_OPTION_NAMES[k]: v for k, v in
                dataclasses.asdict(idx.field(fname).options).items()}
        http_json(base, "POST", f"/index/taxi/field/{fname}",
                  {"options": opts})
    owners = {}
    jobs = []
    for fname in fields:
        for vname, view in sorted(idx.field(fname).views.items()):
            for shard in sorted(view.fragments):
                if shard not in owners:
                    owners[shard] = [o["uri"] for o in http_json(
                        base, "GET", "/internal/fragment/nodes?index=taxi"
                                     f"&shard={shard}")]
                jobs += [(uri, fname, vname, shard) for uri in owners[shard]]
    per_node = {nd["id"]: 0 for nd in nodes}

    def send(job):
        uri, fname, vname, shard = job
        data = idx.field(fname).view(vname).fragment(shard).write_bytes()
        http_json(uri, "POST", f"/index/taxi/field/{fname}/import-roaring/"
                               f"{shard}?view={vname}", data)
        return uri, len(data)

    nbytes = 0
    with ThreadPoolExecutor(max_workers=8) as pool:
        for uri, size in pool.map(send, jobs):
            nbytes += size
            per_node[by_uri[uri]] += 1
    return time.perf_counter() - t0, nbytes, len(jobs), per_node


def cluster_reads(base, index, expected, want_burst, what):
    """Every read of the phase through the node at ``base``, each
    checked: the five taxi queries, the GroupBy and the burst as one
    ``/batch/query``."""
    for name, (pql, want) in expected.items():
        got = http_json(base, "POST", f"/index/{index}/query", pql)
        if got != {"results": [want]}:
            raise AssertionError(f"cluster {what}: {name} answered {got}, "
                                 f"want {want}")
    got = http_json(base, "POST", "/batch/query", cluster_batch())
    if got != cluster_batch_want(want_burst):
        raise AssertionError(f"cluster {what}: the burst answered "
                             f"{str(got)[:300]}")


def cluster_p50s(base, expected, want_burst, samples):
    """p50 with p10-p90 (s) of each read through ``base``, ``samples``
    sequential requests each, every answer checked."""
    out = {}
    reqs = [(name, f"/index/taxi/query", pql, {"results": [want]})
            for name, (pql, want) in expected.items()]
    reqs.append(("burst_batch", "/batch/query", cluster_batch(),
                 cluster_batch_want(want_burst)))
    for name, path, body, want in reqs:
        times = []
        for _ in range(samples):
            t0 = time.perf_counter()
            got = http_json(base, "POST", path, body)
            times.append(time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"cluster: {name} answer changed")
        out[name] = spread(times)
    return out


def cluster_write(nodes, coord, shard, down=()):
    """A Set and a Clear of one column of ``shard`` through ``coord``,
    each read back from every live owner with ``remote=true&shards=``."""
    col = shard * SHARD_WIDTH + 7
    pql = f"Row(cab_type={CLUSTER_COL_ROW})"
    owners = [nd for nd in nodes if nd["id"] not in down
              and nd["cluster"].owns_shard("taxi", shard)]
    seen = {}
    for op, want in (("Set", [col]), ("Clear", [])):
        got = http_json(coord["base"], "POST", "/index/taxi/query",
                        f"{op}({col}, cab_type={CLUSTER_COL_ROW})")
        if got != {"results": [True]}:
            raise AssertionError(f"cluster: {op} answered {got}")
        for nd in owners:
            back = http_json(nd["base"], "POST",
                             f"/index/taxi/query?remote=true&shards={shard}",
                             pql)["results"][0]["columns"]
            if back != want:
                raise AssertionError(f"cluster: {op} on {nd['id']} read "
                                     f"back {back}")
        seen[op] = [nd["id"] for nd in owners]
    return {"column": col, "owners_read": seen, "through": coord["id"]}


def cluster_cli(device):
    """Two ``cli server`` processes that name each other in
    ``cluster_peers`` (replica 2): a 4-shard index made and imported
    through the first node's ``/import``, a Count and a TopN through
    each node, exact under the reference's merge. Returns the report."""
    import signal
    import socket
    import tempfile
    import numpy as np
    from pilosa_tpu_torch.parallel.hashing import shard_nodes
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    uris = [f"http://127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    rng = np.random.default_rng(CLUSTER_CLI_SEED)
    n = 20_000
    cols = (rng.integers(0, CLUSTER_CLI_SHARDS, n) * SHARD_WIDTH
            + rng.integers(0, SHARD_WIDTH, n)).astype(np.uint64)
    rows = rng.integers(0, 5, n).astype(np.uint64)
    pairs = np.unique(np.stack([rows, cols]), axis=1)
    rows, cols = pairs[0], pairs[1]
    per_shard = np.zeros((CLUSTER_CLI_SHARDS, 5), np.int64)
    np.add.at(per_shard, ((cols // SHARD_WIDTH).astype(np.int64),
                          rows.astype(np.int64)), 1)
    order = sorted(uris)
    legs = {}
    for s in range(CLUSTER_CLI_SHARDS):
        primary = order[shard_nodes("cl", s, 2, 2)[0]]
        legs.setdefault(primary, []).append(s)
    want = {"results": [int(per_shard[:, 1].sum()),
                        topn_merge(per_shard, list(legs.values()), 2)]}
    procs = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        peers = ", ".join(f'"{u}"' for u in uris)
        for i, uri in enumerate(uris):
            path = os.path.join(tmp, f"node{i}.toml")
            with open(path, "w") as f:
                f.write(f'bind = "{uri.split("//")[1]}"\n'
                        f"cluster_peers = [{peers}]\n"
                        f"cluster_replicas = 2\n"
                        "heartbeat_interval = 0.5\n")
            cmd = [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
                   "-c", path]
            if device == "cpu":
                cmd += ["--device", "cpu"]
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=cache_off_env()))
        try:
            for proc, uri in zip(procs, uris):
                line = ""
                while "listening on " not in line:
                    line = proc.stdout.readline()
                    if not line:
                        raise AssertionError(f"cluster cli: {uri} exited "
                                             f"{proc.wait()}")
                if "cluster=2 nodes" not in line:
                    raise AssertionError(f"cluster cli: {uri} printed "
                                         f"{line!r}")
            up_s = time.perf_counter() - t0
            base = uris[0]
            http_json(base, "POST", "/index/cl", {"options": {}})
            http_json(base, "POST", "/index/cl/field/f", {"options": {}})
            http_json(base, "POST", "/index/cl/field/f/import",
                      {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()})
            answers = {}
            for uri in uris:
                got = http_json(uri, "POST", "/index/cl/query",
                                "Count(Row(f=1)) TopN(f, n=2)")
                if got != want:
                    raise AssertionError(f"cluster cli: {uri} answered "
                                         f"{got}, want {want}")
                answers[uri] = got["results"]
            held = [http_json(u, "GET", "/internal/local-shards")["cl"]
                    for u in uris]
        finally:
            rcs = []
            for proc in procs:
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            for proc in procs:
                try:
                    rcs.append(proc.wait(timeout=120))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rcs.append(proc.wait())
    if rcs != [0, 0]:
        raise AssertionError(f"cluster cli: exit codes {rcs}")
    return {"start_s": up_s, "bits": int(len(rows)),
            "answers": answers[uris[0]], "shards_held": held,
            "seconds": time.perf_counter() - t0}


def run_cluster(src, device, want_taxi, want_burst, wants,
                samples=CLUSTER_SAMPLES):
    """The cluster phase: three nodes of a static cluster in this process
    (replica 2, a heartbeat each), loaded from the taxi holder by the
    reference client's import-roaring path; every read through every
    node as coordinator exact, each sweep launched by every node's leg;
    the coordinator's p50s beside one node's over HTTP; a profiled
    query's remote fragments; a Set and a Clear read back from both
    owners; node 2's server stopped: the reads exact through node 0,
    node 2 marked down by the heartbeat and sent no query RPC, a Set read
    back from its live owner; then two ``cli server`` processes as a
    cluster. Returns the report."""
    from pilosa_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    nodes = cluster_start(device, CLUSTER_NODES)
    n0 = nodes[0]
    report = {"nodes": CLUSTER_NODES, "replicas": CLUSTER_REPLICAS}
    tagger = None
    try:
        report["load_s"], report["bytes"], report["fragments"], \
            report["fragments_by_node"] = cluster_load(src, nodes)
        n_shards = len(src.index("taxi").available_shards())
        all_shards = list(range(n_shards))
        held = {}
        for nd in nodes:
            got = nd["holder"].index("taxi").available_shards()
            want = [s for s in all_shards
                    if nd["cluster"].owns_shard("taxi", s)]
            if got != want:
                raise AssertionError(f"cluster: {nd['id']} holds {got}, "
                                     f"placement gives {want}")
            held[nd["id"]] = len(got)
        report["shards_by_node"] = held
        log(f"cluster: loaded {report['fragments']} fragments "
            f"({report['bytes']} bytes) in {report['load_s']:.2f} s; "
            f"shards by node {held}")
        # The schema made through node 0 is every node's (each lists its
        # own shards).
        schemas = {}
        for nd in nodes:
            doc = http_json(nd["base"], "GET", "/schema")
            for ix in doc["indexes"]:
                ix.pop("shards", None)
            schemas[nd["id"]] = doc
        if any(d != schemas["n0"] for d in schemas.values()):
            raise AssertionError(f"cluster: schemas differ: {schemas}")
        legs = list(n0["cluster"].shards_by_node("taxi", all_shards)
                    .values())
        expected = cluster_expected(want_taxi, want_burst, wants, legs)
        # Every read through node 0 first, on fresh nodes, launches
        # counted by node; then through the others.
        tagger = NodeLaunches(kernels, nodes)
        kernels.reset_launches()
        per_query = {}
        for name, (pql, want) in expected.items():
            got = http_json(n0["base"], "POST", "/index/taxi/query", pql)
            if got != {"results": [want]}:
                raise AssertionError(f"cluster: {name} answered {got}, "
                                     f"want {want}")
            per_query[name] = tagger.take()
        got = http_json(n0["base"], "POST", "/batch/query", cluster_batch())
        if got != cluster_batch_want(want_burst):
            raise AssertionError("cluster: the burst answered wrong")
        per_query["burst_batch"] = tagger.take()
        report["launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                              if v}
        report["launches_by_query"] = per_query
        if device != "cpu":
            for k in SWEEPS:
                by_node = {nd["id"]: sum(q.get(nd["id"], {}).get(k, 0)
                                         for q in per_query.values())
                           for nd in nodes}
                if min(by_node.values()) <= 0:
                    raise AssertionError(f"cluster: {k} launched by node "
                                         f"{by_node}")
            for name, q in per_query.items():
                for k in SWEEPS:
                    ran = {nid for nid, c in q.items() if c.get(k)}
                    if ran and ran != {nd["id"] for nd in nodes}:
                        raise AssertionError(f"cluster: {name} launched {k}"
                                             f" on {sorted(ran)} only")
        for nd in nodes[1:]:
            cluster_reads(nd["base"], "taxi", expected, want_burst,
                          f"through {nd['id']}")
        # p50s through node 0, beside one node over HTTP (the source
        # holder behind the port's server, result cache off).
        report["p50_s"] = cluster_p50s(n0["base"], expected, want_burst,
                                       samples)
        api, srv, base = start_server(src)
        try:
            single = {k: (pql, taxi_json(k, want_taxi[k]) if k in want_taxi
                          else want)
                      for k, (pql, want) in expected.items()}
            single["groupby"] = (GB_QUERIES[0][1],
                                 sorted(wants["groupby"],
                                        key=lambda g: [x["rowID"] for x in
                                                       g["group"]]))
            report["single_node_p50_s"] = cluster_p50s(
                base, single, want_burst, samples)
        finally:
            stop_server(api, srv)
        log("cluster: p50 ms through n0 / one node: " + ", ".join(
            f"{k} {v['p50'] * 1e3:.2f}/"
            f"{report['single_node_p50_s'][k]['p50'] * 1e3:.2f}"
            for k, v in report["p50_s"].items()))
        # A forced profile carries both remote nodes' fragments.
        got = http_json(n0["base"], "POST", "/index/taxi/query?profile=true",
                        TAXI_QUERIES[0][1])
        frags = got["profile"].get("nodes", {})
        if not {"n1", "n2"} <= set(frags) or \
                not all(f.get("ops") for f in frags.values()):
            raise AssertionError(f"cluster: profile nodes {sorted(frags)}")
        report["profile_nodes"] = sorted(frags)
        # Writes through a node that does not own the column.
        shard = next(s for s in all_shards
                     if not n0["cluster"].owns_shard("taxi", s))
        report["write"] = cluster_write(nodes, n0, shard)
        # Failover: node 2's server stops.
        attempts = []
        ce = n0["api"].cluster_executor
        real = ce.client.query_node_full

        def counting(uri, *a, **kw):
            attempts.append(uri)
            return real(uri, *a, **kw)

        ce.client.query_node_full = counting
        victim = nodes[2]
        victim["srv"].shutdown()
        victim["srv"].server_close()
        victim["srv"] = None
        t_stop = time.time()
        f_legs = list(n0["cluster"].shards_by_node(
            "taxi", all_shards, exclude_ids={victim["id"]}).values())
        f_expected = cluster_expected(want_taxi, want_burst, wants, f_legs)
        t0 = time.perf_counter()
        cluster_reads(n0["base"], "taxi", f_expected, want_burst,
                      "after node 2 stopped")
        report["failover_reads_s"] = time.perf_counter() - t0
        report["failover_answers"] = {
            k: v[1] for k, v in f_expected.items()
            if k in ("topn", "topn_filtered", "count_intersect")}
        deadline = time.time() + 30
        while victim["id"] not in n0["cluster"].down_ids:
            if time.time() > deadline:
                raise AssertionError("cluster: node 2 never marked down")
            time.sleep(0.01)
        down_ev = next(e for e in reversed(n0["cluster"].recent_events())
                       if e["type"] == "node-down")
        report["time_to_down_s"] = down_ev["time"] - t_stop
        # The detector's bound: a probe round every interval, each of
        # the SUSPECT failing rounds probing at most both peers, each
        # probe within its timeout.
        window = CLUSTER_HB_SUSPECT * (CLUSTER_HB_INTERVAL
                                       + 2 * CLUSTER_HB_TIMEOUT) \
            + CLUSTER_HB_INTERVAL
        report["down_window_s"] = window
        if report["time_to_down_s"] > window:
            raise AssertionError(f"cluster: node 2 down after "
                                 f"{report['time_to_down_s']:.2f} s, past "
                                 f"its window {window} s")
        del attempts[:]
        cluster_reads(n0["base"], "taxi", f_expected, want_burst,
                      "with node 2 down")
        to_victim = sum(1 for u in attempts if u == victim["base"])
        if to_victim:
            raise AssertionError(f"cluster: node 2 got {to_victim} query "
                                 "RPCs while marked down")
        report["rpcs_to_down_node"] = to_victim
        report["state_with_node_down"] = n0["cluster"].state
        shard = next(s for s in all_shards
                     if victim["id"] in [n.id for n in
                                         n0["cluster"].shard_nodes("taxi",
                                                                   s)])
        report["write_with_node_down"] = cluster_write(
            nodes, n0, shard, down=(victim["id"],))
        ce.client.query_node_full = real
    finally:
        if tagger is not None:
            tagger.close()
        cluster_stop(nodes)
    report["cli"] = cluster_cli(device)
    report["seconds"] = time.perf_counter() - t_phase
    log(f"cluster: {report['seconds']:.1f} s, node 2 down after "
        f"{report.get('time_to_down_s', float('nan')):.2f} s")
    return report


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
        for name, typ, lo, hi, tq in (
                ("cab_type", "set", 0, 0, ""),
                ("passenger_count", "set", 0, 0, ""),
                ("dist", "int", 0, 300, ""), ("amount", "int", 0, 1000, ""),
                ("pickup", "time", 0, 0, "YMD"),
                ("rate_code", "mutex", 0, 0, ""),
                ("store_and_fwd", "bool", 0, 0, "")):
            o = got.get(name, {})
            if (o.get("type"), o.get("min"), o.get("max"),
                    o.get("timeQuantum")) != (typ, lo, hi, tq):
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
        # GroupBy and Rows over HTTP: the in-process JSON answers.
        for what, (pql, want) in in_process["groupby"].items():
            got = http_json(base, "POST", "/index/taxi/query", pql)
            if got != {"results": [want]}:
                raise AssertionError(f"serve: {what} {pql} over HTTP "
                                     f"{str(got)[:300]} != in-process")
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
        report.update(serve_timefields(base, cab_head,
                                       in_process["timefields"]))
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
        stop_server(api, srv)
    launches = dict(kernels.LAUNCHES)
    return report, launches


def serve_timefields(base, cab_head, reads):
    """Phase 3 of the serve path: the timefields phase's ranged Count
    and mutex TopN over HTTP, then a time field made over HTTP, shard 0
    imported as JSON with second timestamps and shard 1 as a protobuf
    ImportRequest with nanosecond timestamps (January 2019, local time:
    the expected days come from the same local reading the API makes),
    and a ranged Count over each shard checked against numpy. Returns
    the import seconds."""
    from datetime import datetime
    import numpy as np
    from pilosa_tpu_torch.server import proto_compat
    for name, (pql, want) in reads.items():
        got = http_json(base, "POST", "/index/taxi/query", pql)
        if got != {"results": [want]}:
            raise AssertionError(f"serve: {name} {pql} over HTTP "
                                 f"{str(got)[:300]} != numpy")
    http_json(base, "POST", "/index/taxi/field/pickup_http",
              {"options": {"type": "time", "timeQuantum": "YMD"}})
    rng = np.random.default_rng(TIME_SEED + 1)
    lo = int(datetime(2019, 1, 1).timestamp())
    secs = lo + rng.integers(0, 31 * 86400, 2 * SHARD_WIDTH)
    rows = cab_head
    cols = np.arange(2 * SHARD_WIDTH, dtype=np.uint64)
    report = {}
    t0 = time.perf_counter()
    http_json(base, "POST", "/index/taxi/field/pickup_http/import",
              {"rowIDs": rows[:SHARD_WIDTH].tolist(),
               "columnIDs": cols[:SHARD_WIDTH].tolist(),
               "timestamps": secs[:SHARD_WIDTH].tolist()})
    report["import_time_json_s"] = time.perf_counter() - t0
    msg = (proto_compat._str_field(1, "taxi")
           + proto_compat._str_field(2, "pickup_http")
           + proto_compat._packed_uint64(4, rows[SHARD_WIDTH:].tolist())
           + proto_compat._packed_uint64(5, cols[SHARD_WIDTH:].tolist())
           + proto_compat._packed_uint64(
               6, (secs[SHARD_WIDTH:] * 10 ** 9).tolist()))
    t0 = time.perf_counter()
    http_json(base, "POST", "/index/taxi/field/pickup_http/import", msg,
              proto_compat.CONTENT_TYPE)
    report["import_time_proto_s"] = time.perf_counter() - t0
    # A second's day is the day datetime.fromtimestamp gives it.
    starts = [datetime(2019, 1, d).timestamp() for d in range(1, 32)]
    day = np.searchsorted(np.asarray(starts), secs, "right") - 1
    for shard in (0, 1):
        sl = slice(shard * SHARD_WIDTH, (shard + 1) * SHARD_WIDTH)
        for row in (0, 1):
            m = (rows[sl] == row) & (day[sl] >= day_index(R7[0])) \
                & (day[sl] < day_index(R7[1]))
            pql = f"Count({pickup(R7, 'pickup_http', row)})"
            got = http_json(base, "POST",
                            f"/index/taxi/query?shards={shard}", pql)
            if got != {"results": [int(m.sum())]}:
                raise AssertionError(f"serve: {pql} on shard {shard} "
                                     f"answered {got}, numpy {int(m.sum())}")
    log(f"serve: time field over HTTP exact; imports with timestamps: "
        f"JSON {report['import_time_json_s']:.3f} s, protobuf "
        f"{report['import_time_proto_s']:.3f} s")
    return report


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
                            stderr=subprocess.STDOUT, text=True,
                            env=cache_off_env())
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


# ----------------------------------------------------------------- keys

# The star-trace getting-started index (benches/startrace.py, BASELINE
# config 1: users star repositories) with keys and attributes: every
# repository has an "owner/name" column key, every user login and
# language is a row key.
KEY_SEED = 3  # benches/startrace.py's seed
KEY_REPOS = 1_000_000
KEY_USERS = 2000
KEY_STARS = 2000  # stars a user, drawn uniformly over the repositories
KEY_ATTR_COLS = 100_000  # repositories with column attributes
KEY_CALLS = 1000  # attribute writes a request
KEY_HTTP_PAIRS = 100_000  # stars in each keyed import over HTTP
KEY_SUFFIX = "-abcdefghijk"  # repository names vary in length
KEY_NEW_REPO = "neworg/brand-new-repo"
# Languages by rank; a repository draws one with weight 1/rank.
LANGUAGES = (
    "JavaScript", "Python", "Java", "Go", "TypeScript", "C++", "Ruby", "PHP",
    "C#", "C", "Shell", "Rust", "Swift", "Kotlin", "Scala", "Objective-C",
    "HTML", "CSS", "Dart", "R", "Perl", "Lua", "Haskell", "Elixir",
    "Clojure", "Erlang", "Julia", "OCaml", "F#", "Groovy", "PowerShell",
    "Vim script", "Emacs Lisp", "MATLAB", "Fortran", "Zig", "Nim", "Crystal",
    "Solidity", "Assembly")
_FUNCTIONAL = {"Haskell", "Elixir", "Clojure", "Erlang", "OCaml", "F#",
               "Emacs Lisp"}
_SYSTEMS = {"Go", "C++", "C", "Rust", "Zig", "Nim", "Assembly", "Fortran"}
_MARKUP = {"HTML", "CSS"}
PARADIGM = {x: ("functional" if x in _FUNCTIONAL else "systems"
                if x in _SYSTEMS else "markup" if x in _MARKUP
                else "multi-paradigm") for x in LANGUAGES}
# The TLC data dictionary's rate codes.
RATE_NAMES = {1: "Standard rate", 2: "JFK", 3: "Newark",
              4: "Nassau or Westchester", 5: "Negotiated fare",
              6: "Group ride"}


def keys_data(n_repos, n_users, n_stars, n_attr_cols):
    """The star-trace data from KEY_SEED: the stars in the bench's draw
    order, each repository's name-length variation, language and star
    count, each user's attributes, and the repositories that carry
    column attributes."""
    import numpy as np
    rng = np.random.default_rng(KEY_SEED)
    users = np.repeat(np.arange(n_users, dtype=np.int64), n_stars)
    repos = rng.integers(0, n_repos, n_users * n_stars,
                         dtype=np.uint64).astype(np.int64)
    name_len = rng.integers(0, len(KEY_SUFFIX) + 1, n_repos)
    w = 1.0 / np.arange(1, len(LANGUAGES) + 1)
    lang = rng.choice(len(LANGUAGES), n_repos, p=w / w.sum())
    stars = np.minimum(np.floor(rng.lognormal(2.0, 2.0, n_repos)),
                       500_000).astype(np.int64)
    active = rng.random(n_users) < 0.5
    followers = rng.integers(0, 100_000, n_users)
    attr_cols = np.sort(rng.choice(n_repos, n_attr_cols, replace=False))
    col_active = rng.random(n_attr_cols) < 0.3
    repo_keys = [f"org{i % 50_000}/repo{i}{KEY_SUFFIX[:k]}"
                 for i, k in enumerate(name_len.tolist())]
    logins = [f"user{u}" for u in range(n_users)]
    return {"users": users, "repos": repos, "lang": lang, "stars": stars,
            "active": active, "followers": followers,
            "attr_cols": attr_cols, "col_active": col_active,
            "repo_keys": repo_keys, "logins": logins, "n_stars": n_stars}


def repo_url(key):
    return f"https://github.com/{key}"


class KeyOracle:
    """Numpy answers of the star-trace index. Column ids are allocated as
    the keys first appear in the imports (the stars in draw order, then
    every repository in order), row ids likewise; a keyed answer lists
    its columns by id."""

    def __init__(self, d):
        import numpy as np
        self.d = d
        n = len(d["repo_keys"])
        seq = np.concatenate([d["repos"], np.arange(n)])
        uniq, first = np.unique(seq, return_index=True)
        self.col_id = np.empty(n, np.int64)
        self.col_id[uniq[np.argsort(first)]] = np.arange(1, len(uniq) + 1)
        self.repo_of = np.empty(n + 1, np.int64)
        self.repo_of[self.col_id] = np.arange(n)
        lu, lf = np.unique(d["lang"], return_index=True)
        self.lang_id = np.zeros(len(LANGUAGES), np.int64)
        self.lang_id[lu[np.argsort(lf)]] = np.arange(1, len(lu) + 1)
        s = d["n_stars"]
        per_user = np.sort(d["repos"].reshape(-1, s), axis=1)
        self.distinct = 1 + (np.diff(per_user, axis=1) != 0).sum(1)
        self.starred = {}
        self.col_attrs = {int(r): {"url": repo_url(d["repo_keys"][r]),
                                   "active": bool(a)}
                          for r, a in zip(d["attr_cols"].tolist(),
                                          d["col_active"].tolist())}

    def stars_of(self, u):
        import numpy as np
        if u not in self.starred:
            s = self.d["n_stars"]
            self.starred[u] = np.unique(self.d["repos"][u * s:(u + 1) * s])
        return self.starred[u]

    def user_attrs(self, u):
        return {"active": bool(self.d["active"][u]),
                "followers": int(self.d["followers"][u])}

    def row(self, repos, attrs=None, extra=()):
        """A keyed Row answer of repositories ``repos`` and the columns
        ``extra`` ((id, key) pairs past every repository's id)."""
        import numpy as np
        cols = np.sort(self.col_id[repos])
        keys = [self.d["repo_keys"][r] for r in self.repo_of[cols].tolist()]
        out = {"columns": cols.tolist() + [c for c, _ in extra]}
        if attrs:
            out["attrs"] = attrs
        out["keys"] = keys + [k for _, k in extra]
        return out

    def column_attrs(self, repos):
        import numpy as np
        cols = np.sort(self.col_id[repos])
        return [{"key": self.d["repo_keys"][r], "attrs": self.col_attrs[r]}
                for r in self.repo_of[cols].tolist() if r in self.col_attrs]

    @staticmethod
    def top(ids, counts, keys, n):
        import numpy as np
        ids, counts = np.asarray(ids), np.asarray(counts)
        order = [o for o in np.lexsort((ids, -counts)) if counts[o] > 0]
        return [{"key": keys[o], "count": int(counts[o])}
                for o in order[:n or None]]

    def topn_users(self, n, distinct=None, active=None, extra=()):
        import numpy as np
        distinct = self.distinct if distinct is None else distinct
        ids = np.arange(1, len(distinct) + 1)
        keep = np.ones(len(ids), bool) if active is None else active
        keys = [k for k, m in zip(self.d["logins"], keep) if m]
        ids, counts = ids[keep], distinct[keep]
        if extra:
            ids = np.concatenate([ids, [i for i, _, _ in extra]])
            counts = np.concatenate([counts, [c for _, _, c in extra]])
            keys = keys + [k for _, k, _ in extra]
        return self.top(ids, counts, keys, n)

    def lang_counts(self, repos):
        import numpy as np
        return np.bincount(self.d["lang"][repos], minlength=len(LANGUAGES))

    def lang_repos(self, name):
        import numpy as np
        return np.flatnonzero(self.d["lang"] == LANGUAGES.index(name))


def key_users(o):
    """(a, b, c): a is the first active user of the active TopN, whom the
    writes make inactive; b is the bench's user 19 (14 when a is 19); c
    is another user."""
    import numpy as np
    active = o.d["active"]
    ids = np.flatnonzero(active)
    a = int(ids[np.lexsort((ids, -o.distinct[ids]))[0]])
    b = 19 if a != 19 else 14
    c = next(u for u in (7, 8, 9) if u not in (a, b))
    return a, b, c


def key_reads(o, a, b):
    """(name, PQL, expected execute_full response) of the reads."""
    import numpy as np
    d, L = o.d, o.d["logins"]
    sa, sb = o.stars_of(a), o.stars_of(b)
    go, rust = o.lang_repos("Go"), o.lang_repos("Rust")
    lc = o.lang_counts(sa)
    by_id = np.argsort(o.lang_id)
    row_a = o.row(sa, o.user_attrs(a))
    reads = [
        ("row_a", f"Row(stargazer='{L[a]}')", row_a),
        ("count_ab", f"Count(Intersect(Row(stargazer='{L[a]}'), "
                     f"Row(stargazer='{L[b]}')))",
         int(len(np.intersect1d(sa, sb)))),
        ("topn", "TopN(stargazer, n=5)", o.topn_users(5)),
        ("topn_lang_a", f"TopN(language, Row(stargazer='{L[a]}'), n=5)",
         o.top(o.lang_id, lc, LANGUAGES, 5)),
        ("topn_active",
         "TopN(stargazer, n=10, attrName='active', attrValues=[true])",
         o.topn_users(10, active=d["active"])),
        ("column_attrs_a",
         f"Options(Row(stargazer='{L[a]}'), columnAttrs=true)",
         {"results": [row_a], "columnAttrs": o.column_attrs(sa)}),
        ("go_no_columns", "Options(Row(language='Go'), excludeColumns=true)",
         {"columns": [], "attrs": {"paradigm": PARADIGM["Go"]},
          "keys": []}),
        ("go_no_attrs",
         "Options(Row(language='Go'), excludeRowAttrs=true)", o.row(go)),
        ("sum_rust", "Sum(Row(language='Rust'), field=stars)",
         {"value": int(d["stars"][rust].sum()), "count": int(len(rust))}),
        ("count_popular", "Count(Row(stars > 10000))",
         int((d["stars"] > 10000).sum())),
        ("rows_language", "Rows(language)",
         {"keys": [LANGUAGES[x] for x in by_id if o.lang_id[x]]}),
        ("groupby_a", f"GroupBy(Rows(language), filter=Row(stargazer="
                      f"'{L[a]}'))",
         [{"group": [{"field": "language", "rowKey": LANGUAGES[x]}],
           "count": int(lc[x])} for x in by_id if o.lang_id[x] and lc[x]]),
        ("unknown_key", "Row(stargazer='nobody-at-all')",
         {"columns": [], "keys": []}),
    ]
    return [(n, q, w if n == "column_attrs_a" else {"results": [w]})
            for n, q, w in reads]


def key_burst(o, a, b, c):
    """(name, PQL, expected answer) of the 18-read keyed burst."""
    import numpy as np
    d, L = o.d, o.d["logins"]
    sa, sb, sc = o.stars_of(a), o.stars_of(b), o.stars_of(c)
    lang, stars = d["lang"], d["stars"]
    ra, rb, rc = (f"Row(stargazer='{L[u]}')" for u in (a, b, c))
    asm = o.lang_repos("Assembly")
    rust_pop = np.flatnonzero((lang == LANGUAGES.index("Rust"))
                              & (stars > 10000))
    langs = np.isin(lang, [LANGUAGES.index(x) for x in ("Rust", "Go",
                                                         "Zig")])
    return [
        ("b_row_a", ra, o.row(sa, o.user_attrs(a))),
        ("b_row_b", rb, o.row(sb, o.user_attrs(b))),
        ("b_count_a", f"Count({ra})", int(len(sa))),
        ("b_count_ab", f"Count(Intersect({ra}, {rb}))",
         int(len(np.intersect1d(sa, sb)))),
        ("b_count_abc", f"Count(Intersect({ra}, {rb}, {rc}))",
         int(len(np.intersect1d(np.intersect1d(sa, sb), sc)))),
        ("b_union_ab", f"Count(Union({ra}, {rb}))",
         int(len(np.union1d(sa, sb)))),
        ("b_difference_ab", f"Count(Difference({ra}, {rb}))",
         int(len(np.setdiff1d(sa, sb)))),
        ("b_xor_ab", f"Count(Xor({ra}, {rb}))",
         int(len(np.setxor1d(sa, sb)))),
        ("b_count_go", "Count(Row(language='Go'))",
         int(len(o.lang_repos("Go")))),
        ("b_row_assembly", "Row(language='Assembly')",
         o.row(asm, {"paradigm": PARADIGM["Assembly"]})),
        ("b_count_popular", "Count(Row(stars > 10000))",
         int((stars > 10000).sum())),
        ("b_a_starred", f"Count(Intersect({ra}, Row(stars > 100)))",
         int((stars[sa] > 100).sum())),
        ("b_a_go", f"Count(Intersect({ra}, Row(language='Go')))",
         int((lang[sa] == LANGUAGES.index("Go")).sum())),
        ("b_not_python", "Count(Not(Row(language='Python')))",
         int((lang != LANGUAGES.index("Python")).sum())),
        ("b_row_c", rc, o.row(sc, o.user_attrs(c))),
        ("b_three_languages", "Count(Union(Row(language='Rust'), "
         "Row(language='Go'), Row(language='Zig')))", int(langs.sum())),
        ("b_rust_popular", "Intersect(Row(language='Rust'), "
         "Row(stars > 10000))", o.row(rust_pop)),
        ("b_unknown_key", "Count(Row(stargazer='nobody-in-a-burst'))", 0),
    ]


def timed_translation():
    """A context that adds the seconds spent in
    ``TranslateStore.translate_keys`` to ``spent[0]``."""
    import contextlib
    from pilosa_tpu_torch.core.translate import TranslateStore
    spent = [0.0]

    @contextlib.contextmanager
    def ctx():
        real = TranslateStore.translate_keys

        def counted(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        TranslateStore.translate_keys = counted
        try:
            yield spent
        finally:
            TranslateStore.translate_keys = real
    return ctx()


def load_keys(device, d, path=None):
    """The star-trace holder through the API: the index and fields, the
    keyed imports (stars in the bench's draw order, then each
    repository's language and star count), then the row and column
    attributes through PQL, KEY_CALLS calls a request; in memory, or on
    the data directory ``path``. Returns (holder, API, load seconds)."""
    from pilosa_tpu_torch import Holder
    from pilosa_tpu_torch.server import API
    holder = Holder(path, device=device)
    if path is not None:
        holder.open()
    api = cache_off(API(holder))
    api.create_index("repository", keys=True, track_existence=True)
    api.create_field("repository", "stargazer", {"keys": True})
    api.create_field("repository", "language", {"keys": True})
    api.create_field("repository", "stars",
                     {"type": "int", "min": 0, "max": 500_000})
    keys, L = d["repo_keys"], d["logins"]
    load = {}
    for field, kw in (
            ("stargazer", lambda: {
                "row_keys": [L[u] for u in d["users"].tolist()],
                "column_keys": [keys[r] for r in d["repos"].tolist()]}),
            ("language", lambda: {
                "row_keys": [LANGUAGES[x] for x in d["lang"].tolist()],
                "column_keys": keys}),
            ("stars", lambda: {"column_keys": keys, "values": d["stars"]})):
        args = kw()
        with timed_translation() as spent:
            t0 = time.perf_counter()
            if field == "stars":
                api.import_values("repository", field, **args)
            else:
                api.import_bits("repository", field, **args)
            load[f"{field}_s"] = time.perf_counter() - t0
        load[f"{field}_translate_s"] = spent[0]
        del args
    ex = api.executor
    calls = [f"SetRowAttrs(stargazer, '{L[u]}', "
             f"active={str(bool(d['active'][u])).lower()}, "
             f"followers={int(d['followers'][u])})" for u in range(len(L))]
    calls += [f"SetRowAttrs(language, '{x}', paradigm='{PARADIGM[x]}')"
              for x in LANGUAGES]
    t0 = time.perf_counter()
    for i in range(0, len(calls), KEY_CALLS):
        ex.execute("repository", " ".join(calls[i:i + KEY_CALLS]))
    load["row_attrs_s"] = time.perf_counter() - t0
    load["row_attrs_per_call_s"] = load["row_attrs_s"] / len(calls)
    calls = [f"SetColumnAttrs('{keys[r]}', url='{repo_url(keys[r])}', "
             f"active={str(bool(a)).lower()})"
             for r, a in zip(d["attr_cols"].tolist(),
                             d["col_active"].tolist())]
    t0 = time.perf_counter()
    for i in range(0, len(calls), KEY_CALLS):
        ex.execute("repository", " ".join(calls[i:i + KEY_CALLS]))
    load["column_attrs_s"] = time.perf_counter() - t0
    load["column_attrs_per_call_s"] = load["column_attrs_s"] / max(
        1, len(calls))
    return api.holder, api, load


def run_keys(device, n_repos=KEY_REPOS, n_users=KEY_USERS,
             n_stars=KEY_STARS, n_attr_cols=KEY_ATTR_COLS,
             http_pairs=KEY_HTTP_PAIRS, iters=ITERS):
    """The keys phase: load the keyed star-trace index, then with the
    launch counts set to 0 just before and read just after: the reads
    one at a time through ``execute_full`` (each exact against numpy,
    its launches by kernel, its warm p50 and device time), the 18-read
    keyed burst in ONE mega_interpret launch with no fallback, the serve
    path (``serve_keys``), and the writes (a keyed Set, SetRowAttrs that
    changes the attribute-filtered TopN, SetColumnAttrs with a key,
    ClearRow and Store with key rows). No plain version may run on the
    card. Returns (report, launches)."""
    import torch
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.executor.results import result_to_json
    from pilosa_tpu_torch.ops import kernels
    cuda = device != "cpu"
    t0 = time.perf_counter()
    d = keys_data(n_repos, n_users, n_stars, n_attr_cols)
    o = KeyOracle(d)
    a, b, c = key_users(o)
    reads = key_reads(o, a, b)
    burst = key_burst(o, a, b, c)
    gen_s = time.perf_counter() - t0
    holder, api, load = load_keys(device, d)
    ex = api.executor
    idx = holder.index("repository")
    log(f"keys: {n_repos} repositories, {n_users * n_stars} stars "
        f"generated in {gen_s:.2f} s, loaded: " + ", ".join(
            f"{k} {v:.4g}" for k, v in load.items()))
    if idx.column_translator.size() != n_repos:
        raise AssertionError(f"keys: {idx.column_translator.size()} column "
                             f"keys for {n_repos} repositories")
    report = {"repositories": n_repos, "stars": n_users * n_stars,
              "gen_s": gen_s, "load_s": load, "queries": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check(name, pql, got, want):
        if got != want:
            raise AssertionError(f"keys {name}: {pql}: port "
                                 f"{str(got)[:300]} != numpy "
                                 f"{str(want)[:300]}")

    def full(pql):
        resp = ex.execute_full("repository", pql)
        sync()
        return resp

    def launched(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        sync()
        return out, {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] != before[k]}

    def mega():
        return (ex.mega_launches, ex.mega_fallbacks,
                ex.mega_budget_fallbacks, ex.mega_unlowered)

    def batch(items):
        out = ex.execute_batch([("repository", q, None)
                                for _, q, _ in items])
        sync()
        for (name, pql, want), item in zip(items, out):
            if isinstance(item, Exception):
                raise AssertionError(f"keys {name}: {pql} raised {item!r}")
            check(name, pql, result_to_json(item[0][0]), want)

    prev = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        # Rehearsal only: the megakernel defaults to off on the CPU.
        megamod.MEGAKERNEL_ENABLED = True
    kernels.reset_launches()
    L = d["logins"]
    try:
        with RefCalls(kernels) as refs:
            # 1. the reads one at a time
            rows0 = idx.field("stargazer").row_translator.size()
            for name, pql, want in reads:
                t0 = time.perf_counter()
                got, delta = launched(lambda: full(pql))
                check(name, pql, got, want)
                report["queries"][name] = {
                    "pql": pql, "first_s": time.perf_counter() - t0,
                    "launches": delta}
            # A read of an unknown key allocated its id.
            check("unknown_key", "row keys",
                  idx.field("stargazer").row_translator.size(), rows0 + 1)
            # 2. the keyed burst
            m0 = mega()
            t0 = time.perf_counter()
            _, delta = launched(lambda: batch(burst))
            moved = tuple(y - x for x, y in zip(m0, mega()))
            if moved != (1, 0, 0, 0) or (cuda and delta.get(
                    "mega_interpret") != 1):
                raise AssertionError(
                    f"keys burst: megakernel launches/fallbacks/budget "
                    f"fallbacks/unlowered moved {moved}; kernel launches "
                    f"{delta}")
            report["burst"] = {"requests": len(burst),
                               "first_s": time.perf_counter() - t0,
                               "launches": delta, "mega_launches": moved[0],
                               "fallbacks": moved[1] + moved[2]}
            # 3. warm p50s and device times
            for name, pql, want in reads:
                times = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    got = full(pql)
                    times.append(time.perf_counter() - t0)
                    check(name, pql, got, want)
                report["queries"][name]["p50_s"] = p50(times)
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                batch(burst)
                times.append(time.perf_counter() - t0)
            report["burst"]["p50_s"] = p50(times)
            if cuda:
                report["profile"] = profile_queries(
                    torch, ex, "repository",
                    [(n, q) for n, q, _ in reads], iters)
            # 4. the serve path
            report["serve"] = serve_keys(api, o, reads, burst, a,
                                         http_pairs, iters)
            # 5. the writes
            writes = {}
            sa = o.stars_of(a)
            new_id = n_repos + 1
            t0 = time.perf_counter()
            check("set_key", "Set", full(f"Set('{KEY_NEW_REPO}', "
                                         f"stargazer='{L[a]}')"),
                  {"results": [True]})
            writes["set_key_s"] = time.perf_counter() - t0
            check("set_key", "column keys", idx.column_translator.size(),
                  new_id)
            check("set_key", "count", full(f"Count(Row(stargazer='{L[a]}'))"),
                  {"results": [int(len(sa)) + 1]})
            distinct = o.distinct.copy()
            distinct[a] += 1
            active = d["active"].copy()
            topn_active = "TopN(stargazer, n=10, attrName='active', " \
                          "attrValues=[true])"
            check("set_row_attrs", "before", full(topn_active), {
                "results": [o.topn_users(10, distinct, active)]})
            t0 = time.perf_counter()
            check("set_row_attrs", "SetRowAttrs", full(
                f"SetRowAttrs(stargazer, '{L[a]}', active=false)"),
                {"results": [None]})
            writes["set_row_attrs_s"] = time.perf_counter() - t0
            active[a] = False
            want = o.topn_users(10, distinct, active)
            if any(p["key"] == L[a] for p in want):
                raise AssertionError("keys: the oracle still ranks a")
            check("set_row_attrs", "after", full(topn_active),
                  {"results": [want]})
            new_attrs = {"url": repo_url(KEY_NEW_REPO), "active": True}
            t0 = time.perf_counter()
            check("set_column_attrs", "SetColumnAttrs", full(
                f"SetColumnAttrs('{KEY_NEW_REPO}', "
                f"url='{repo_url(KEY_NEW_REPO)}', active=true)"),
                {"results": [None]})
            writes["set_column_attrs_s"] = time.perf_counter() - t0
            attrs_a = dict(o.user_attrs(a), active=False)
            check("set_column_attrs", "columnAttrs", full(
                f"Options(Row(stargazer='{L[a]}'), columnAttrs=true)"),
                {"results": [o.row(sa, attrs_a,
                                   extra=[(new_id, KEY_NEW_REPO)])],
                 "columnAttrs": o.column_attrs(sa)
                 + [{"key": KEY_NEW_REPO, "attrs": new_attrs}]})
            t0 = time.perf_counter()
            check("clear_row", "ClearRow", full(
                f"ClearRow(stargazer='{L[b]}')"), {"results": [True]})
            writes["clear_row_s"] = time.perf_counter() - t0
            distinct[b] = 0
            check("clear_row", "count", full(
                f"Count(Row(stargazer='{L[b]}'))"), {"results": [0]})
            check("clear_row", "TopN", full("TopN(stargazer, n=5)"),
                  {"results": [o.topn_users(5, distinct)]})
            go = o.lang_repos("Go")
            t0 = time.perf_counter()
            check("store", "Store", full(
                "Store(Row(language='Go'), stargazer='go-fans')"),
                {"results": [True]})
            writes["store_s"] = time.perf_counter() - t0
            fans = idx.field("stargazer").row_translator.translate_key(
                "go-fans", create=False)
            check("store", "Row", full("Row(stargazer='go-fans')"),
                  {"results": [o.row(go)]})
            check("store", "TopN", full("TopN(stargazer, n=5)"), {
                "results": [o.topn_users(5, distinct, extra=[
                    (fans, "go-fans", len(go))])]})
            report["writes"] = writes
            log("keys: reads exact; warm p50 " + ", ".join(
                f"{n} {q['p50_s']:.6f} s"
                for n, q in report["queries"].items())
                + f"; burst {report['burst']['p50_s']:.6f} s in one "
                "launch; writes " + ", ".join(
                    f"{k} {v:.6f}" for k, v in writes.items()))
        launches = dict(kernels.LAUNCHES)
        report["ref_calls"] = refs.calls
        if cuda:
            if refs.calls:
                raise AssertionError(f"keys: plain versions called on the "
                                     f"card: {refs.calls}")
            for name in ("bank_row_counts", "bank_row_counts_masked",
                         "bsi_plane_counts", "mega_interpret"):
                if launches[name] <= 0:
                    raise AssertionError(f"keys: {name} never launched")
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
    report["launches"] = {k: v for k, v in launches.items() if v}
    return report, launches


def serve_keys(api, o, reads, burst, a, http_pairs, iters):
    """The serve path of the keys phase on the star-trace holder: the
    schema; the reads as JSON (and ``?columnAttrs=true``) and some as
    protobuf, with keys in the results and ColumnAttrSets; the keyed
    burst as one /batch/query; then one slice of ``http_pairs`` stars
    imported with keys as JSON into one new field and as protobuf into
    another, and read back. Every answer exact. Returns the report."""
    import numpy as np
    from pilosa_tpu_torch.server import proto_compat
    from pilosa_tpu_torch.server.coalescer import QueryCoalescer
    from pilosa_tpu_torch.server.http import serve
    api.coalescer = QueryCoalescer(api.executor)
    api.coalescer.start()
    srv = serve(api, "127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    d, L = o.d, o.d["logins"]
    q = "/index/repository/query"
    report = {}
    try:
        schema = http_json(base, "GET", "/schema")
        got = {i["name"]: (i["options"]["keys"],
                           {f["name"]: f["options"]["keys"]
                            for f in i["fields"]})
               for i in schema["indexes"]}
        if got.get("repository") != (True, {"stargazer": True,
                                            "language": True,
                                            "stars": False}):
            raise AssertionError(f"serve keys: /schema lists {got}")
        report["http_p50_s"] = {}
        for name, pql, want in reads:
            got = http_json(base, "POST", q, pql)
            if got != want:
                raise AssertionError(f"serve keys: {name} over HTTP "
                                     f"{str(got)[:300]} != numpy")
            report["http_p50_s"][name] = http_p50(
                base, "repository", pql, want, iters)
        by_name = {n: w for n, _, w in reads}
        pql_of = {n: p for n, p, _ in reads}
        want_a = by_name["column_attrs_a"]
        got = http_json(base, "POST", q + "?columnAttrs=true",
                        f"Row(stargazer='{L[a]}')")
        if got != want_a:
            raise AssertionError("serve keys: ?columnAttrs=true != numpy")
        # Protobuf: the bytes of the oracle's response.
        pb = [(pql_of["row_a"], True, want_a),
              ("TopN(stargazer, n=5) Rows(language)", False,
               {"results": by_name["topn"]["results"]
                + by_name["rows_language"]["results"]}),
              (pql_of["groupby_a"], False, by_name["groupby_a"]),
              (pql_of["go_no_columns"], False, by_name["go_no_columns"])]
        for pql, col_attrs, want in pb:
            msg = proto_compat._str_field(1, pql)
            if col_attrs:
                msg += proto_compat._varint_field(3, 1)
            status, raw = http(base, "POST", q, msg,
                               proto_compat.CONTENT_TYPE)
            expect = proto_compat.encode_query_response(
                want["results"], column_attr_sets=want.get("columnAttrs"))
            if status != 200 or raw != expect:
                raise AssertionError(f"serve keys: protobuf {pql} answered "
                                     f"{status}, {len(raw)} bytes, not the "
                                     f"{len(expect)} expected")
        # The keyed burst as one /batch/query.
        ex = api.executor
        before = mega_state(ex)
        body = {"queries": [{"index": "repository", "query": p}
                            for _, p, _ in burst]}
        want_items = [{"results": [w]} for _, _, w in burst]
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            got = http_json(base, "POST", "/batch/query", body)
            times.append(time.perf_counter() - t0)
            if got["responses"] != want_items:
                bad = [n for (n, _, _), g, w in zip(
                    burst, got["responses"], want_items) if g != w]
                raise AssertionError(f"serve keys: /batch/query {bad}")
        report["batch_http_p50_s"] = p50(times)
        report["burst_mega_launches"] = check_mega_taken(
            ex, before, "keyed /batch/query")
        # Keyed imports: one slice of stars as JSON and as protobuf.
        n = min(http_pairs, len(d["users"]))
        users, repos = d["users"][:n].tolist(), d["repos"][:n].tolist()
        rk = [L[u] for u in users]
        ck = [d["repo_keys"][r] for r in repos]
        for field in ("star_json", "star_pb"):
            http_json(base, "POST", f"/index/repository/field/{field}",
                      {"options": {"keys": True}})
        t0 = time.perf_counter()
        http_json(base, "POST", "/index/repository/field/star_json/import",
                  {"rowKeys": rk, "columnKeys": ck})
        report["import_json_s"] = time.perf_counter() - t0
        msg = (proto_compat._str_field(1, "repository")
               + proto_compat._str_field(2, "star_pb")
               + b"".join(proto_compat._str_field(7, k) for k in rk)
               + b"".join(proto_compat._str_field(8, k) for k in ck))
        t0 = time.perf_counter()
        http_json(base, "POST", "/index/repository/field/star_pb/import",
                  msg, proto_compat.CONTENT_TYPE)
        report["import_proto_s"] = time.perf_counter() - t0
        report["import_pairs"] = n
        s = d["n_stars"]
        whole = n // s  # users whose stars the slice holds whole
        counts = o.distinct[:whole]
        ids = np.arange(1, whole + 1)
        want_top = o.top(ids, counts, L[:whole], 5)
        for field in ("star_json", "star_pb"):
            for pql, want in ((f"TopN({field}, n=5)", want_top),
                              (f"Row({field}='{L[0]}')",
                               o.row(o.stars_of(0)))):
                got = http_json(base, "POST", q, pql)
                if got != {"results": [want]}:
                    raise AssertionError(f"serve keys: {pql} after the "
                                         "keyed import != numpy")
        log(f"serve keys: reads exact over JSON and protobuf; "
            f"/batch/query p50 {report['batch_http_p50_s']:.6f} s; keyed "
            f"imports of {n} stars: JSON {report['import_json_s']:.3f} s, "
            f"protobuf {report['import_proto_s']:.3f} s")
    finally:
        srv.shutdown()
        srv.server_close()
        api.coalescer.stop()
    return report


def run_taxi_attrs(holder, device, rate_top, iters=ITERS):
    """Row attributes on the loaded taxi index (after the timefields
    phase): the TLC names of rate_code rows 1-6 and airport=true on 2
    and 3 through SetRowAttrs, then the attribute-filtered TopN (exact:
    the rows of ``rate_top`` that are airports) and a Row that carries
    the attributes. No plain version may run on the card. Returns the
    report."""
    import torch
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.ops import kernels
    ex = cache_off(Executor(holder, device=device))
    report = {}
    calls = " ".join(
        f"SetRowAttrs(rate_code, {r}, name='{n}'"
        + (", airport=true)" if r in (2, 3) else ")")
        for r, n in RATE_NAMES.items())
    with RefCalls(kernels) as refs:
        t0 = time.perf_counter()
        got = ex.execute_full("taxi", calls)
        report["set_row_attrs_s"] = time.perf_counter() - t0
        if got != {"results": [None] * len(RATE_NAMES)}:
            raise AssertionError(f"taxi attrs: SetRowAttrs answered {got}")
        checks = [
            ("topn_airport",
             "TopN(rate_code, n=6, attrName='airport', attrValues=[true])",
             [p for p in rate_top if p["id"] in (2, 3)]),
            ("jfk_attrs", "Options(Row(rate_code=2), excludeColumns=true)",
             {"columns": [], "attrs": {"name": "JFK", "airport": True}})]
        for name, pql, want in checks:
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                got = ex.execute_full("taxi", pql)
                if device != "cpu":
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if got != {"results": [want]}:
                    raise AssertionError(f"taxi attrs: {pql}: port {got} "
                                         f"!= numpy {want}")
            report[f"{name}_p50_s"] = p50(times)
    if device != "cpu" and refs.calls:
        raise AssertionError(f"taxi attrs: plain versions called on the "
                             f"card: {refs.calls}")
    log("taxi attrs: the airport TopN and the JFK row exact; p50 "
        f"{report['topn_airport_p50_s']:.6f} s and "
        f"{report['jfk_attrs_p50_s']:.6f} s")
    return report


# -------------------------------------------------------------- persist

# The fields of the taxi index that go to disk (every view and shard).
PERSIST_FIELDS = ("cab_type", "passenger_count", "dist", "amount", "_exists",
                  "pickup", "rate_code", "store_and_fwd")
PERSIST_SEED = 23
PERSIST_SHARD = 1  # the shard exported and imported over HTTP
PERSIST_DAY = ("2019-01-31", "2019-02-01")  # no ride is drawn there
# The fingerprint index on disk: cut from the fingerprint phase's 10M
# molecules to 1M (one shard) so the phase stays within its time; its
# TopN budget is cut with it so the positions bank serves it.
PERSIST_MOLECULES = 1_000_000

_OPTION_NAMES = {"type": "type", "cache_type": "cacheType",
                 "cache_size": "cacheSize", "min": "min", "max": "max",
                 "time_quantum": "timeQuantum", "keys": "keys",
                 "no_standard_view": "noStandardView",
                 "max_columns": "maxColumns"}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def open_holder(path, device):
    """``Holder(path).open()`` and its seconds."""
    from pilosa_tpu_torch import Holder
    t0 = time.perf_counter()
    holder = Holder(path, device=device)
    holder.open()
    return holder, time.perf_counter() - t0


def copy_taxi(mem, path, device):
    """Holder(path) gets every view and shard of PERSIST_FIELDS of the
    in-memory taxi index, each fragment's ``write_bytes()`` through
    ``API.import_roaring(view=)`` (one snapshot a fragment). Returns
    (holder, seconds, bytes imported, fragments)."""
    import dataclasses
    from pilosa_tpu_torch.server import API
    holder, _ = open_holder(path, device)
    api = cache_off(API(holder))
    api.create_index("taxi")
    src = mem.index("taxi")
    t0 = time.perf_counter()
    nbytes = nfrags = 0
    for fname in PERSIST_FIELDS:
        f = src.field(fname)
        if fname != "_exists":
            api.create_field("taxi", fname, {
                _OPTION_NAMES[k]: v
                for k, v in dataclasses.asdict(f.options).items()})
        for vname, view in sorted(f.views.items()):
            for shard, frag in sorted(view.fragments.items()):
                data = frag.write_bytes()
                api.import_roaring("taxi", fname, shard, data, view=vname)
                nbytes += len(data)
                nfrags += 1
    return holder, time.perf_counter() - t0, nbytes, nfrags


def persist_expect(cab, amount, pax_counts, n_rides, want_taxi, want_burst,
                   mem_answers):
    """The answers the reopened directory must give after the phase's
    writes: a Set of a new ride into passenger_count 2 and a pickup day,
    a Clear of ride 3's cab_type, then (over HTTP) a Set of another new
    ride into cab_type 2. The 1M-bit import fills all of shard
    PERSIST_SHARD, so below (PERSIST_SHARD + 1) * 2^20 rides it adds
    existence bits past the last ride: ``fresh`` counts them (new1 is
    one of them, counted already)."""
    import numpy as np
    new1, new2 = n_rides + 11, n_rides + 12
    lo, hi = PERSIST_SHARD * SHARD_WIDTH, (PERSIST_SHARD + 1) * SHARD_WIDTH
    fresh = max(0, hi - max(n_rides, lo)) - int(lo <= new1 < hi)
    c3 = int(cab[3])
    pax = pax_counts.copy()
    pax[2] += 1
    cab_counts = np.bincount(cab.astype(np.int64), minlength=3)
    s, n = want_taxi["sum_filtered"]
    if c3 == 1:
        s, n = s - int(amount[3]), n - 1
    return {
        "new1": new1, "new2": new2, "c3": c3,
        "pax2": int(pax[2]), "cab3": int(cab_counts[c3]) - 1,
        "cab1": int(cab_counts[1]) - (c3 == 1),
        "cab2_after": int(cab_counts[2]) + 1 - (c3 == 2),
        "not_cab0": want_burst["not_cab0"] + 1 + (c3 == 0) + fresh,
        "topn_pax": [{"id": r, "count": int(pax[r])} for r in sorted(
            range(1, 7), key=lambda r: (-pax[r], r))[:3]],
        "bsi_range_count": want_taxi["bsi_range_count"],
        "sum_cab1": {"value": s, "count": n},
        "mem": mem_answers}


def persist_reads(ex, want_taxi, want_burst, mem_answers, cuda):
    """The reopened taxi directory's reads: the five queries, TopN
    (passenger_count) from the reloaded count caches, the burst in ONE
    mega_interpret launch, the 7-view ranged Count and TopN(rate_code)
    as the in-memory holder answers them. Returns the report."""
    from pilosa_tpu_torch.ops import kernels
    report = {}
    for name, pql in TAXI_QUERIES:
        c0 = (ex.topn_cache_hits, ex.topn_selfchecks)
        t0 = time.perf_counter()
        (got,) = ex.execute("taxi", pql)
        report.setdefault("first_query_s", time.perf_counter() - t0)
        if taxi_answer(name, got) != want_taxi[name]:
            raise AssertionError(f"persist {name}: port {taxi_answer(name, got)}"
                                 f" != numpy {want_taxi[name]}")
        if name == "topn":
            hit = (ex.topn_cache_hits - c0[0], ex.topn_selfchecks - c0[1])
            if hit != (1, 1):
                raise AssertionError(f"persist: TopN(passenger_count) was "
                                     f"not a reloaded cache hit: {hit}")
    before = dict(kernels.LAUNCHES)
    c0 = ex.topn_cache_hits
    (got,) = ex.execute("taxi", "TopN(passenger_count, n=3)")
    moved = {k: kernels.LAUNCHES[k] - before[k] for k in before
             if kernels.LAUNCHES[k] != before[k]}
    if taxi_answer("topn", got) != want_taxi["topn"] or \
            ex.topn_cache_hits != c0 + 1 or moved:
        raise AssertionError(f"persist: the warm TopN(passenger_count) "
                             f"launched {moved}")
    report["topn_cache"] = {"hits": ex.topn_cache_hits,
                            "selfchecks": ex.topn_selfchecks,
                            "mismatches": ex.topn_selfcheck_mismatches}
    m0 = mega_state(ex)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    burst_answers(ex.execute_batch([("taxi", q, None) for _, q in BURST]),
                  want_burst)
    report["burst_s"] = time.perf_counter() - t0
    moved = tuple(b - a for a, b in zip(m0, mega_state(ex)))
    launched = kernels.LAUNCHES["mega_interpret"] - before["mega_interpret"]
    if moved != (1, 0, 0) or (cuda and launched != 1):
        raise AssertionError(f"persist burst: megakernel launches/fallbacks"
                             f" moved {moved}, mega_interpret {launched}")
    report["burst_mega_launches"] = launched
    for name, pql in mem_answers["queries"]:
        got = ex.execute_full("taxi", pql)
        if got != mem_answers[pql]:
            raise AssertionError(f"persist {name}: {pql}: {str(got)[:200]} "
                                 f"!= in memory {str(mem_answers[pql])[:200]}")
    return report


def persist_writes(ex, api, expect, n_rides):
    """The writes on the reopened holder: a Set, a Clear, a timestamped
    Set, a 1M-bit import of one shard and a Store of a cab_type row into
    a new field. Returns (seconds by write, the import's rows)."""
    import numpy as np
    out = {}
    new1 = expect["new1"]
    for name, pql in (
            ("set_s", f"Set({new1}, passenger_count=2)"),
            ("clear_s", f"Clear(3, cab_type={expect['c3']})"),
            ("set_time_s", f"Set({new1}, pickup=0, {PERSIST_DAY[0]}T09:00)")):
        t0 = time.perf_counter()
        (got,) = ex.execute("taxi", pql)
        out[name] = time.perf_counter() - t0
        if got is not True:
            raise AssertionError(f"persist: {pql} answered {got}")
    rows = np.random.default_rng(PERSIST_SEED).integers(
        0, 4, SHARD_WIDTH).astype(np.uint64)
    api.create_field("taxi", "persist_fill")
    t0 = time.perf_counter()
    api.import_bits("taxi", "persist_fill", rows=rows,
                    columns=np.arange(SHARD_WIDTH, dtype=np.uint64)
                    + np.uint64(PERSIST_SHARD * SHARD_WIDTH))
    out["import_1m_s"] = time.perf_counter() - t0
    # Store rewrites a snapshot a shard.
    t0 = time.perf_counter()
    (got,) = ex.execute("taxi", "Store(Row(cab_type=1), persist_store=1)")
    out["store_s"] = time.perf_counter() - t0
    if got is not True:
        raise AssertionError(f"persist: Store answered {got}")
    return out, rows


def persist_check_writes(ex, expect, fill_rows):
    """Every write of ``persist_writes`` reads back, and TopN
    (passenger_count) is exact without a stale cache hit. Returns the
    cache counters."""
    import numpy as np
    day = f"Row(pickup=0, from='{PERSIST_DAY[0]}T00:00', " \
          f"to='{PERSIST_DAY[1]}T00:00')"
    checks = [("Count(Row(passenger_count=2))", expect["pax2"]),
              (f"Count(Row(cab_type={expect['c3']}))", expect["cab3"]),
              (f"Count({day})", 1),
              ("Count(Row(persist_store=1))", expect["cab1"]),
              ("Count(Not(Row(cab_type=0)))", expect["not_cab0"])]
    counts = np.bincount(fill_rows.astype(np.int64), minlength=4)
    checks += [(f"Count(Row(persist_fill={r}))", int(counts[r]))
               for r in range(4)]
    for pql, want in checks:
        (got,) = ex.execute("taxi", pql)
        if got != want:
            raise AssertionError(f"persist after the crash: {pql}: {got} "
                                 f"!= {want}")
    c0 = (ex.topn_cache_hits, ex.rank_cache_rebuilds)
    got = ex.execute_full("taxi", "TopN(passenger_count, n=3)")
    if got != {"results": [expect["topn_pax"]]}:
        raise AssertionError(f"persist after the crash: TopN {got} != "
                             f"{expect['topn_pax']}")
    moved = (ex.topn_cache_hits - c0[0], ex.rank_cache_rebuilds - c0[1])
    if moved != (0, 1):
        raise AssertionError(f"persist after the crash: a stale sidecar "
                             f"served TopN (hits, rebuilds moved {moved})")
    return {"topn_cache_hits": moved[0], "rank_rebuilds": moved[1]}


def cli_start(args):
    """``python -m pilosa_tpu_torch.cli server ARGS`` on a free loopback
    port: (process, base URL, seconds to its listening line)."""
    import queue
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "--bind", "127.0.0.1:0", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=cache_off_env())
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    first = lines.get(timeout=600)
    if "listening on " not in first:
        proc.kill()
        raise AssertionError(f"the CLI server printed {first!r}")
    return proc, first.split("listening on ")[1].split()[0], \
        time.perf_counter() - t0


def cli_stop(proc):
    """SIGTERM; the server must exit 0."""
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    if rc != 0:
        raise AssertionError(f"the CLI server exited {rc}")


def persist_cli(path, device, cab, expect):
    """``cli server --data-dir`` over the taxi directory: its start to
    the first answer (Count, TopN, Sum exact); a Set acknowledged, then
    SIGKILL and a restart, whose seconds to the first answer are the
    time to recover, and the Set reads back; GET /export of one shard of
    cab_type exact; import-roaring of a shard as raw bytes and of
    another as a protobuf ImportRoaringRequest, exact; SIGTERM, exit
    0. Returns the report."""
    import numpy as np
    from pilosa_tpu_torch.server import proto_compat
    from pilosa_tpu_torch.storage.roaring import Bitmap
    args = ["--data-dir", path] + (["--device", "cpu"] if device == "cpu"
                                   else [])
    report = {}
    reads = ("Count(Row(dist < 50)) TopN(passenger_count, n=3) "
             "Sum(Row(cab_type=1), field=amount)")
    want = {"results": [expect["bsi_range_count"], expect["topn_pax"],
                        expect["sum_cab1"]]}
    t0 = time.perf_counter()
    proc, base, _ = cli_start(args)
    try:
        got = http_json(base, "POST", "/index/taxi/query", reads)
        report["start_to_first_answer_s"] = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"persist cli: {got} != {want}")
        got = http_json(base, "POST", "/index/taxi/query",
                        f"Set({expect['new2']}, cab_type=2)")
        if got != {"results": [True]}:
            raise AssertionError(f"persist cli: the Set answered {got}")
    finally:
        proc.kill()
        proc.wait()
    t0 = time.perf_counter()
    proc, base, report["restart_listen_s"] = cli_start(args)
    try:
        got = http_json(base, "POST", "/index/taxi/query",
                        "Count(Row(cab_type=2))")
        report["recover_s"] = time.perf_counter() - t0
        if got != {"results": [expect["cab2_after"]]}:
            raise AssertionError(f"persist cli: after SIGKILL the Set is "
                                 f"lost: {got} != {expect['cab2_after']}")
        # The export of one shard of cab_type, with new2's Set over HTTP
        # when it falls in that shard (below 2^21 rides).
        lo = PERSIST_SHARD * SHARD_WIDTH
        seg = cab[lo:lo + SHARD_WIDTH]
        by_row = {r: (np.flatnonzero(seg == r) + lo).tolist()
                  for r in range(3)}
        if lo <= expect["new2"] < lo + SHARD_WIDTH:
            by_row[2].append(expect["new2"])
        want_csv = "".join("".join(f"{r},{c}\n" for c in cols)
                           for r, cols in by_row.items())
        t0 = time.perf_counter()
        status, raw = http(base, "GET", "/export?index=taxi&field=cab_type"
                           f"&shard={PERSIST_SHARD}")
        report["export_s"] = time.perf_counter() - t0
        if status != 200 or raw.decode() != want_csv:
            raise AssertionError(f"persist cli: the export differs "
                                 f"({status}, {len(raw)} bytes, "
                                 f"{len(want_csv)} expected)")
        report["export_lines"] = want_csv.count("\n")
        # import-roaring: shard 0 as raw bytes, shard PERSIST_SHARD as
        # a protobuf ImportRoaringRequest.
        http_json(base, "POST", "/index/taxi/field/roar", {})
        rng = np.random.default_rng(PERSIST_SEED + 1)
        for shard, proto in ((0, False), (PERSIST_SHARD, True)):
            rows = rng.integers(0, 3, 300_000).astype(np.uint64)
            cols = rng.integers(0, SHARD_WIDTH, 300_000).astype(np.uint64)
            bm = Bitmap()
            bm.direct_add_n(np.unique(rows * np.uint64(SHARD_WIDTH) + cols))
            data = bm.write_bytes()
            body, ctype = data, None
            if proto:
                body = proto_compat._len_field(
                    2, proto_compat._str_field(1, "")
                    + proto_compat._len_field(2, data))
                ctype = proto_compat.CONTENT_TYPE
            t0 = time.perf_counter()
            http_json(base, "POST", f"/index/taxi/field/roar/import-roaring/"
                      f"{shard}", body, ctype)
            report["import_roaring_" + ("proto" if proto else "raw") +
                   "_s"] = time.perf_counter() - t0
            uniq = np.unique(rows * np.uint64(SHARD_WIDTH) + cols)
            counts = np.bincount((uniq // np.uint64(SHARD_WIDTH)).astype(
                np.int64), minlength=3)
            got = http_json(base, "POST", f"/index/taxi/query?shards={shard}",
                            "Count(Row(roar=0)) Count(Row(roar=1)) "
                            "Count(Row(roar=2))")
            if got != {"results": counts.tolist()}:
                raise AssertionError(f"persist cli: import-roaring shard "
                                     f"{shard}: {got} != {counts.tolist()}")
    finally:
        cli_stop(proc)
    return report


def persist_torn_info(device):
    """``GET /info`` of ``cli server --data-dir`` over a directory whose
    fragment lost the end of its last op record: ``tailDroppedBytes``
    must equal what a holder reopened over a copy of that directory
    reports, and be above 0. Returns the report."""
    import shutil
    import tempfile
    from pilosa_tpu_torch.server import API
    path = tempfile.mkdtemp(prefix="pilosa-torn-")
    try:
        holder, _ = open_holder(path, device)
        api = cache_off(API(holder))
        api.create_index("torn")
        api.create_field("torn", "f", {})
        for c in range(12):
            api.executor.execute("torn", f"Set({c * 7}, f={c % 3})")
        holder.close()
        frag = os.path.join(path, "torn", "f", "views", "standard",
                            "fragments", "0")
        with open(frag, "rb") as f:
            data = f.read()
        with open(frag, "wb") as f:
            f.write(data[:-7])
        shutil.copytree(path, path + "-copy")
        holder, _ = open_holder(path + "-copy", device)
        want = holder.tail_dropped_bytes()
        holder.close()
        proc, base, _ = cli_start(["--data-dir", path] + (
            ["--device", "cpu"] if device == "cpu" else []))
        try:
            info = http_json(base, "GET", "/info")
        finally:
            cli_stop(proc)
        if not want > 0 or info.get("tailDroppedBytes") != want:
            raise AssertionError(f"persist torn tail: /info {info}, the "
                                 f"reopened holder dropped {want} bytes")
        return {"tail_dropped_bytes": want, "info_device": info["device"]}
    finally:
        shutil.rmtree(path, ignore_errors=True)
        shutil.rmtree(path + "-copy", ignore_errors=True)


def run_persist(mem, device, cab, amount, pax_counts, want_taxi, want_burst,
                tf_http):
    """The persist phase on the taxi index (after the timefields phase):
    copy it to a data directory, close, reopen and read; write, drop the
    holder without close and reopen; then the CLI server over the
    directory. Launch counts are 0 just before the reopened holder's
    reads and read just after the crash's; no plain version may run on
    the card. Returns (report, launches)."""
    import gc
    import resource
    import shutil
    import tempfile
    import torch
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.executor import megakernel as megamod
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import API
    cuda = device != "cpu"
    n_rides = len(cab)
    mex = cache_off(Executor(mem, device=device))
    queries = [("count_7", tf_http["count_7"][0]),
               ("topn_rate", "TopN(rate_code)")]
    mem_answers = {"queries": queries}
    for _, pql in queries:
        mem_answers[pql] = mex.execute_full("taxi", pql)
    del mex
    expect = persist_expect(cab, amount, pax_counts, n_rides, want_taxi,
                            want_burst, mem_answers)
    path = tempfile.mkdtemp(prefix="pilosa-persist-")
    report = {}
    prev = megamod.MEGAKERNEL_ENABLED
    if not cuda:
        megamod.MEGAKERNEL_ENABLED = True
    try:
        # 1. the copy
        holder, report["copy_s"], nbytes, report["fragments"] = copy_taxi(
            mem, path, device)
        holder.close()
        del holder
        report["imported_bytes"] = nbytes
        report["copy_mb_s"] = nbytes / 1e6 / report["copy_s"]
        report["disk_bytes"] = dir_bytes(path)
        report["nofile_limit"] = list(resource.getrlimit(
            resource.RLIMIT_NOFILE))
        log(f"persist: copied {report['fragments']} fragments, "
            f"{nbytes / 1e6:.1f} MB, in {report['copy_s']:.2f} s "
            f"({report['copy_mb_s']:.1f} MB/s); "
            f"{report['disk_bytes'] / 1e6:.1f} MB on disk")
        # 2. reopen and read
        kernels.reset_launches()
        with RefCalls(kernels) as refs:
            holder, report["open_s"] = open_holder(path, device)
            ex = cache_off(Executor(holder, device=device))
            report.update(persist_reads(ex, want_taxi, want_burst,
                                        mem_answers, cuda))
            log(f"persist: reopened in {report['open_s']:.2f} s, first "
                f"query {report['first_query_s']:.2f} s; five queries, "
                f"the burst in one launch and the ranged reads exact; "
                f"TopN(passenger_count) from the reloaded caches "
                f"{report['topn_cache']}")
            # 3. writes, then a drop without close
            api = cache_off(API(holder))
            report["writes"], fill_rows = persist_writes(
                api.executor, api, expect, n_rides)
            # The drop: nothing is closed or saved. The process-wide bank
            # budget holds the holder's views, so let go of their device
            # banks, as a crash would.
            for idx in holder.indexes.values():
                for f in idx.fields.values():
                    f.drop_banks()
            del ex, api, holder
            gc.collect()
            holder, report["crash_open_s"] = open_holder(path, device)
            ex = cache_off(Executor(holder, device=device))
            report["after_crash"] = persist_check_writes(ex, expect,
                                                         fill_rows)
            holder.close()
            del ex, holder
            gc.collect()
        launches = dict(kernels.LAUNCHES)
        report["ref_calls"] = refs.calls
        if cuda and refs.calls:
            raise AssertionError(f"persist: plain versions called on the "
                                 f"card: {refs.calls}")
        if cuda:
            torch.cuda.empty_cache()
        log(f"persist: writes {report['writes']}; dropped without close, "
            f"reopened in {report['crash_open_s']:.2f} s, every write read "
            f"back, stale sidecars cold {report['after_crash']}")
        # 4. the CLI server over the directory
        report["cli"] = persist_cli(path, device, cab, expect)
        log(f"persist: cli {report['cli']}")
        report["torn_info"] = persist_torn_info(device)
        log(f"persist: /info of the CLI server over a torn op log "
            f"{report['torn_info']}")
    finally:
        megamod.MEGAKERNEL_ENABLED = prev
        shutil.rmtree(path, ignore_errors=True)
    return report, launches


def persist_keys(device, mem_load, n_repos=KEY_REPOS, n_users=KEY_USERS,
                 n_stars=KEY_STARS, n_attr_cols=KEY_ATTR_COLS):
    """The keyed star-trace index on a data directory, through the same
    API calls as the keys phase (``load_keys``); close, reopen, and the
    thirteen reads must give the keys phase's (numpy-checked) answers.
    Returns the report."""
    import shutil
    import tempfile
    d = keys_data(n_repos, n_users, n_stars, n_attr_cols)
    o = KeyOracle(d)
    a, b, _ = key_users(o)
    reads = key_reads(o, a, b)
    path = tempfile.mkdtemp(prefix="pilosa-persist-keys-")
    report = {"repositories": n_repos, "in_memory_load_s": mem_load}
    try:
        holder, _, report["load_s"] = load_keys(device, d, path=path)
        holder.close()
        del holder
        report["disk_bytes"] = dir_bytes(path)
        holder, report["open_s"] = open_holder(path, device)
        from pilosa_tpu_torch import Executor
        ex = cache_off(Executor(holder, device=device))
        t0 = time.perf_counter()
        for name, pql, want in reads:
            got = ex.execute_full("repository", pql)
            # The first read loads the translators' logs.
            report.setdefault("first_read_s", time.perf_counter() - t0)
            if got != want:
                raise AssertionError(f"persist keys {name}: {pql}: "
                                     f"{str(got)[:300]} != "
                                     f"{str(want)[:300]}")
        report["reads_s"] = time.perf_counter() - t0
        holder.close()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    log(f"persist keys: {n_repos} repositories loaded on disk "
        f"{report['load_s']} (in memory {mem_load}); reopened in "
        f"{report['open_s']:.2f} s, first read {report['first_read_s']:.2f}"
        " s; thirteen reads exact")
    return report


def persist_fingerprint(device, n_molecules=PERSIST_MOLECULES):
    """A fingerprint index of ``n_molecules`` on a data directory
    (``load_fingerprints`` with a path), closed, reopened, and the five
    queries exact through the positions bank (no dense bank; the TopN
    budgets cut to an eighth of its dense bank). Launch counts are 0
    just before the queries and read just after. Returns (report,
    launches)."""
    import shutil
    import tempfile
    from pilosa_tpu_torch import Executor
    from pilosa_tpu_torch.core.view import PositionsBank, ViewBank
    from pilosa_tpu_torch.executor import executor as executor_mod
    from pilosa_tpu_torch.ops import kernels
    pos = fingerprint_positions(n_molecules)
    want = fingerprint_expected(pos)
    path = tempfile.mkdtemp(prefix="pilosa-persist-fp-")
    report = {"molecules": n_molecules}
    budget = (executor_mod.TOPN_MAX_BANK_BYTES,
              executor_mod.Executor.BANK_MAX_BYTES)
    cut = n_molecules * FP_BITS // 8 // 8
    executor_mod.TOPN_MAX_BANK_BYTES = executor_mod.Executor.BANK_MAX_BYTES \
        = cut
    try:
        holder, _, _, report["load_s"] = load_fingerprints(device, pos,
                                                           path=path)
        holder.close()
        del holder
        report["disk_bytes"] = dir_bytes(path)
        holder, report["open_s"] = open_holder(path, device)
        ex = cache_off(Executor(holder, device=device))
        kernels.reset_launches()
        with RefCalls(kernels) as refs:
            for name, pql in FP_QUERIES:
                t0 = time.perf_counter()
                (got,) = ex.execute("mole", pql)
                report.setdefault("first_query_s", time.perf_counter() - t0)
                if got.pairs != want[name]:
                    raise AssertionError(f"persist fingerprint {name}: "
                                         f"{got.pairs[:5]} != "
                                         f"{want[name][:5]}")
        launches = dict(kernels.LAUNCHES)
        view = holder.index("mole").field("fingerprint").view()
        pb = [b for b in view._bank_cache.values()
              if isinstance(b, PositionsBank)]
        dense = [k for k, b in view._bank_cache.items()
                 if isinstance(b, ViewBank) and b.array.shape[0] > 2]
        if not pb or dense or (device != "cpu" and (
                launches["pbank_membership_counts"] <= 0 or refs.calls)):
            raise AssertionError(f"persist fingerprint: not through the "
                                 f"positions bank ({len(pb)} banks, dense "
                                 f"{dense}, launches {launches}, plain "
                                 f"{refs.calls})")
        holder.close()
    finally:
        executor_mod.TOPN_MAX_BANK_BYTES, \
            executor_mod.Executor.BANK_MAX_BYTES = budget
        shutil.rmtree(path, ignore_errors=True)
    log(f"persist fingerprint: {n_molecules} molecules on disk in "
        f"{report['load_s']:.2f} s, reopened in {report['open_s']:.2f} s, "
        "five queries exact through the positions bank")
    return report, launches


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
    ap.add_argument("--load-probe", action="store_true",
                    help="run only the fingerprint load and print one "
                         "probe line (seconds)")
    ap.add_argument("--expand-probe", action="store_true",
                    help="run only the expansion kernel's checks and "
                         "timing rows and print one probe line")
    ap.add_argument("--tree", metavar="DIR", default=REPO,
                    help="with a probe: the checkout whose "
                         "pilosa_tpu_torch runs (default: this script's)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the GPU only")
        return 1
    probing = args.burst_probe or args.load_probe or args.expand_probe
    tree = os.path.abspath(args.tree if probing else REPO)
    global PROBE_TREE
    PROBE_TREE = tree != REPO
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
    if args.expand_probe:
        card = card_line()
        print(card, flush=True)
        probe = run_expand_probe(torch, device, tree)
        print(json.dumps({"probe": {"card": card, **probe}}), flush=True)
        return 0
    if args.load_probe:
        card = card_line()
        pos = fingerprint_positions(args.molecules)
        load_s = load_fingerprints("cuda", pos)[3]
        print(json.dumps({"probe": {"tree": tree, "card": card,
                                    "molecules": args.molecules,
                                    "load_s": load_s}}), flush=True)
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
    errs["mega_interpret"] = max(check_mega(torch, kernels, device),
                                 check_mega_expand(torch, kernels, device))
    errs["pbank_membership_counts"] = check_pbank(torch, kernels, device)
    errs["expand_positions"] = check_expand(torch, kernels, device)
    n_shards = (N_RIDES + SHARD_WIDTH - 1) // SHARD_WIDTH
    timing = time_kernels(torch, kernels, device, n_shards)
    log("timing: torch has no single popcount call, so there is no "
        "library yardstick (library_ms null)")
    memory_line("kernels", device)

    # 3-4, 6. the taxi paths: queries one at a time, the burst, and the
    # serve path's taxi phases
    report, taxi_launches, burst_launches, gb_launches, serve_launches = \
        run_main("cuda", N_RIDES, ITERS, profile=args.profile)
    torch.cuda.empty_cache()
    # 5-6. the fingerprint path and the serve path's fingerprint phase
    torch.cuda.reset_peak_memory_stats()
    from pilosa_tpu_torch.core import view as view_mod
    with UploadRecorder(view_mod) as uploads:
        fp, fp_launches, timing_in, serve_fp_launches = run_fingerprint(
            "cuda", args.molecules, profile=args.profile)
    timing["pbank_membership_counts"] = time_pbank(torch, kernels, device,
                                                   timing_in)
    timing["expand_positions"] = time_expand(
        torch, kernels, device, timing_in["expand"],
        uploads.largest(torch, device))
    timing["expand_positions"]["uploads"] = uploads.calls
    layout_launches = timing_in["layout_launches"]
    del timing_in
    # 7. the keys phase: the keyed star-trace index and its serve path
    torch.cuda.empty_cache()
    keys, keys_launches = run_keys("cuda")
    torch.cuda.empty_cache()
    memory_line("keys", device)
    # 8. the persist phase's keyed and fingerprint directories
    persist = report["persist"]
    persist["keys"] = persist_keys("cuda", keys["load_s"])
    memory_line("persist_keys", device)
    persist["fingerprint"], pfp_launches = persist_fingerprint("cuda")
    torch.cuda.empty_cache()
    memory_line("persist_fingerprint", device)
    # 6. the serve path's CLI phase
    cli = serve_cli("cuda")
    memory_line("cli", device)
    launches = {name: taxi_launches[name] for name in (
        "bank_row_counts", "bank_row_counts_masked", "bsi_plane_counts")}
    launches["mega_interpret"] = burst_launches["mega_interpret"]
    launches["pbank_membership_counts"] = \
        fp_launches["pbank_membership_counts"]
    # The sparse layout's path: the layout phase's sparse burst and its
    # reads one at a time (steps c and d).
    launches["expand_positions"] = layout_launches["expand_positions"]
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
    # The persist path runs every kernel: the sweeps and the interpreter
    # on the reopened taxi directory, the membership kernel on the
    # reopened fingerprint directory.
    persist_counts = {name: persist["launches"][name] for name in (
        "bank_row_counts", "bank_row_counts_masked", "bsi_plane_counts",
        "mega_interpret")}
    persist_counts["pbank_membership_counts"] = \
        pfp_launches["pbank_membership_counts"]
    for name, n in persist_counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "persist path")
    burst = report["burst"]
    timing["mega_interpret"] = {"ms": burst["kernel_ms"],
                                "plain_ms": burst["plain_ms"],
                                "bound_ms": burst["bound_ms"]}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"card": card, "report": report, "fingerprint": fp,
                       "keys": keys, "cli": cli, "timing": timing,
                       "memory": MEMORY}, f, indent=1, default=str)
    taxi = report["taxi"]
    print(json.dumps({"taxi": {
        "rides": report["rides"], "shards": report["shards"],
        "load_s": report["load_s"],
        "p50_s": {k: v["p50_s"] for k, v in taxi.items()
                  if k != "profile"},
        "launches": {k: v["launches"] for k, v in taxi.items()
                     if k != "profile"}}}), flush=True)
    gb = report["groupby"]
    print(json.dumps({"groupby": {
        "queries": {k: {f: v.get(f) for f in (
            "pql", "first_s", "p50_s", "launches", "peak_bytes")}
            for k, v in gb["queries"].items()},
        "store": gb["store"], "clear_row_s": gb["clear_row_s"],
        "topn_warm_launches": gb["topn_warm_launches"],
        "cab_rank_import_s": gb["cab_rank_import_s"],
        "rank_steps": gb["rank_steps"], "rank_p50_s": gb["rank_p50_s"],
        "profile": {k: {f: v[f] for f in ("wall_ms", "device_ms",
                                          "busy_share")}
                    for k, v in gb.get("profile", {}).items()},
        "launches": {k: v for k, v in gb_launches.items() if v}}}),
        flush=True)
    tf = report["timefields"]
    print(json.dumps({"timefields": {
        "rides": tf["rides"], "load_s": tf["load_s"],
        "queries": {k: {f: v.get(f) for f in (
            "pql", "first_s", "p50_s", "launches", "peak_bytes")}
            for k, v in tf["queries"].items()},
        "burst": tf["burst"], "burst_wide": tf["burst_wide"],
        "empty_cover": tf["empty_cover"],
        "writes": tf["writes"],
        "profile": {k: {f: v[f] for f in ("wall_ms", "device_ms",
                                          "busy_share", "kernels_ms")}
                    for k, v in tf.get("profile", {}).items()},
        "launches": {k: v for k, v in tf["launches"].items() if v}}}),
        flush=True)
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
    print(json.dumps({"keys": {
        "repositories": keys["repositories"], "stars": keys["stars"],
        "load_s": keys["load_s"],
        "queries": {k: {"pql": v["pql"], "first_s": v["first_s"],
                        "p50_s": v["p50_s"], "launches": v["launches"],
                        "device_ms": keys.get("profile", {}).get(
                            k, {}).get("device_ms")}
                    for k, v in keys["queries"].items()},
        "burst": keys["burst"], "writes": keys["writes"],
        "serve": keys["serve"], "taxi_attrs": report["taxi_attrs"],
        "launches": {k: v for k, v in keys_launches.items() if v}}}),
        flush=True)
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
        "import_time_json_s": serve["import_time_json_s"],
        "import_time_proto_s": serve["import_time_proto_s"],
        "fp_http_p50_s": serve_fp["fp_http_p50_s"],
        "fp_in_process_p50_s": serve_fp["fp_in_process_p50_s"],
        "cli_start_to_first_answer_s": cli["start_to_first_answer_s"],
        "launches": serve_counts}}), flush=True)
    print(json.dumps({"persist": {
        "codec": "native", "card": card,
        **{k: persist[k] for k in (
            "fragments", "imported_bytes", "copy_s", "copy_mb_s",
            "disk_bytes", "nofile_limit", "open_s", "first_query_s",
            "topn_cache", "burst_s", "writes", "crash_open_s",
            "after_crash", "cli", "torn_info", "keys", "fingerprint")},
        "launches": persist_counts}}), flush=True)
    lay = fp["layout"]
    print(json.dumps({"layout": {
        "card": card, "molecules": fp["molecules"],
        **{k: lay[k] for k in ("requests", "staged", "demote", "sparse",
                               "execute_s", "write", "pressure", "budget",
                               "seconds", "launches")},
        "expand_timing": timing["expand_positions"]}}, default=str),
        flush=True)
    measure = report["measure"]
    print(json.dumps({"measure": {
        "card": card,
        **{k: measure[k] for k in ("unsampled", "roofline", "sampled",
                                   "metrics", "timeline", "cost",
                                   "seconds")},
        "forced": {k: v for k, v in measure["forced"].items()
                   if k != "cost"},
        "launches": report["measure_launches"],
        "sweeps_back_to_back": {
            name: {"events_ms": timing[name]["ms"],
                   "graph_ms": timing[name]["graph_ms"],
                   "bound_ms": timing[name]["bound_ms"],
                   "graph_share_of_bound":
                       timing[name]["bound_ms"] / timing[name]["graph_ms"]}
            for name in ("bank_row_counts", "bank_row_counts_masked",
                         "bsi_plane_counts", "pbank_membership_counts")}}},
        default=str), flush=True)
    serving = report["serving"]
    print(json.dumps({"serving": {"card": card, **serving}}, default=str),
          flush=True)
    print(json.dumps({"cluster": {"card": card, **report["cluster"]}},
                     default=str), flush=True)
    print(json.dumps({"memory": MEMORY}), flush=True)
    print(card, flush=True)

    # 9. kernels line, then the result line
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
