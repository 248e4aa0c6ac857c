"""PQL executor: eager evaluation of call trees on the holder's device.

Operands live in per-view device banks shaped ``[rows, shards, words]``
(``core/view.py``). A row leaf is a slice of its bank; the tree combines
``[S, W]`` rows with torch elementwise ops; every popcount on a CUDA
tensor goes through a kernel of ``ops/kernels.py``:

- ``Count(Intersect(a, b))`` counts ``a ∧ b`` with
  ``bank_row_counts_masked`` at R = 1, never materialising ``a ∧ b``;
- any other ``Count`` materialises its row and calls ``bank_row_counts``;
- TopN sweeps the trimmed full-view bank with ``bank_row_counts`` (no
  filter) or ``bank_row_counts_masked`` (filter, tanimoto) while it fits
  ``TOPN_MAX_BANK_BYTES``; beyond it a narrow single-shard view answers
  from its device-resident positions bank through
  ``pbank_membership_counts``, and any other view streams its rows
  through chunk banks. An unfiltered TopN first tries two caches: the
  fragments' count caches (no device work; one hit in
  ``TOPN_SELFCHECK_EVERY`` also sweeps and compares), then the view
  bank's device rank vector (``core/cache.py``), reused, patched with
  ``bank_row_counts`` over the written rows, or rebuilt by one sweep;
- GroupBy counts with ``bank_row_counts`` (depth 0 and the intermediate
  expansions, a torch ``&`` of every prefix with every row) and
  ``bank_row_counts_masked`` (the last depth, one launch a prefix);
- Sum counts bit planes with ``bsi_plane_counts``.

A Row leaf reads one slot of its view's bank; a view whose full bank
would pass ``Executor.BANK_MAX_BYTES`` serves it from a cached bank of
just the rows the leaf needs (staging asks for every row the tree reads
from the view, ``_Plan.rows_for``, as the JAX package does). A view in
the sparse layout (``core/layout.py``) serves its Row leaves from its
``SparseBank``: the eager leaf expands its one row with the
``expand_positions`` kernel, and a staged leaf lowers to an ``xslot``
whose row the megakernel launch expands before the plan runs; BSI views
stay dense. A sparse build that bails (the view grew too dense) heals the
view to dense and the tree restages with that key dense. Staged and
eager reads, TopN, Rows and GroupBy are recorded in the workload
recorder (``utils/hotspots.py``), whose read rates the layout pass and
the bank budget's eviction rank by.

Banks of different views may differ in width (they are trimmed to their
data); operands are zero-padded to a common width before they combine,
which never changes a bit of the result.

``execute_batch`` runs N requests as one batch, in two halves that may
run on different threads: ``execute_batch_begin`` parses, stages,
flushes and launches; ``execute_batch_finish`` resolves the results,
which is where the host syncs happen. Under the begin's collector
(``executor/fusion.py``) a read request's ``Count`` and top-level bitmap
calls do not evaluate at once but stage: a host walk of the tree records
its shape signature, operand banks, gather slots, BSI predicate values
and a postfix IR. At the flush, heterogeneous staged evals lower into one
plan buffer and run in ONE ``mega_interpret`` launch
(``executor/megakernel.py``); what the megakernel does not take runs
through the eager path above.

A time range (``Row(f=r, from=…, to=…)``, and ``Range`` of the same
form) reads the views of its cover that exist (``Field.views_for_range``):
none is the zero row; up to ``MAX_STATIC_RANGE_VIEWS`` are one slot each
and an OR fold, which the batch lowers into ``mega_interpret``; more are
a torch ``|`` fold of the one row in each view, read from a cached bank
of that row alone, which does not lower (``mega_unlowered``), as the
JAX package's literal operand does not.

Covered calls: Set (with a timestamp on a time field), Clear, ClearRow,
Store, Row (set, time, mutex and bool fields, BSI conditions, time
ranges), Range, Intersect, Union, Difference, Xor, Not, Shift,
Threshold, Count, TopN (with attrName/attrValues), Rows (with
from/to), GroupBy, Sum, Min, Max, SetRowAttrs, SetColumnAttrs, and
Options around any of them. ``execute_full`` and
``execute_batch_shaped[_finish]`` give the JSON-shaped responses the
server sends, with ``columnAttrs`` when an Options asked for them.

Measurement (``utils/profile.py``, ``utils/timeline.py``,
``utils/roofline.py``): ``execute(..., profile=)`` and the batch entry
points' ``profiles=`` attach a ``QueryProfile`` a request fills in, one
op node a call and an ``eval:count``/``eval:row`` node for each tree the
call evaluates (the JAX package's ``_eval_tree`` sites: Count, the
bitmap calls, and the filters of TopN, GroupBy, Sum/Min/Max and Store).
A sampled profile also reads the card's time of each evaluation between
two CUDA events (``_device_mark``/``_fence_device``); an unsampled one
records no event and takes no sync. ``stats`` is the server's stats
client, fed the launch, plan and cost counters.

Result cache (``executor/result_cache.py``, ``Executor.result_cache``,
on by default): every evaluation first walks its tree into an
``_EvalIdent`` (the plan, a fingerprint of its tree, rows and predicate
values, and its views' fragment versions over its shards, read before
any bank is), which the workload recorder records. A terminal eval
(Count, a top-level bitmap call) then looks it up in the eval tier; a
hit answers the cached count, or a Row result over the cached host
words, with no staging, launch or copy, so a batch whose evals all hit
forms no cohort. A miss runs or stages and fills from the host copy its
answer makes (the count's fetch, the Row result's column copy).
``execute_full`` and ``execute_batch_shaped[_begin]`` put the request
tier before all of it: an eligible request (Count and bitmap calls)
answers its cached response while the dependency snapshot its fill
recorded (views' version stamps, row-attribute generations, the column
translator's size) is current.

Keys: a keyed index translates column keys and a keyed field row keys
to ids before a call runs (``_translate_call``, get-or-create: a read
of an unknown key allocates its id, as in the JAX package), request by
request in order, also in a batch; plans and banks see only ids. The
results carry keys again (``_translate_result``): a Row result's
columns, TopN's and Rows' rows and GroupBy's group rows. A Row or Range
result of one row carries that row's attributes, read when the call
runs.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass
from dataclasses import field as dc_field
from datetime import datetime
from typing import Any, Callable, Dict, Iterator, List, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch

from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.cache import CACHE_TYPE_NONE, RankEntry
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, FIELD_TYPE_SET, \
    FIELD_TYPE_TIME, Field
from pilosa_tpu_torch.core.fragment import CONTAINER_BITS
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core import layout as layout_mod
from pilosa_tpu_torch.core.view import VIEW_STANDARD, PositionsBank, \
    SparseBank, ViewBank, bank_capacity, view_bsi_name
from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.executor import bsi
from pilosa_tpu_torch.executor.result_cache import ResultCache, \
    approx_nbytes
from pilosa_tpu_torch.executor.results import FieldRow, GroupCount, \
    PairsResult, RowIdentifiers, RowResult, ValCount, result_to_json
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, WORDS_PER_SHARD, \
    b_and, b_andnot, b_not, b_or, b_xor, shift_bits, to_numpy
from pilosa_tpu_torch.parallel.mesh import MeshTensor
from pilosa_tpu_torch.pql import Call, Condition, Query, parse_string_cached
from pilosa_tpu_torch.pql.ast import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ
from pilosa_tpu_torch.utils.fingerprint import request_key
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.timeline import (
    LANE_CACHE, LANE_DEVICE, LANE_DISPATCH, LANE_FETCH, LANE_PLAN, TIMELINE,
)
from pilosa_tpu_torch.utils.tracing import span

_BITMAP_CALLS = {"Row", "Range", "Intersect", "Union", "Difference", "Xor",
                 "Not", "Shift", "Threshold"}
_FOLDS = {"Intersect": b_and, "Union": b_or, "Xor": b_xor,
          "Difference": b_andnot}
_CONTAINER_WORDS = CONTAINER_BITS // 32
_LOG = logging.getLogger(__name__)

# A time range over at most this many existing views lowers to one slot
# a view and an OR fold; a wider one is an eager union that does not
# lower (the JAX package's MAX_STATIC_RANGE_VIEWS).
MAX_STATIC_RANGE_VIEWS = 8

# TopN sweeps the cached full view bank while it fits this many device
# bytes (banks are width-trimmed); beyond it the positions bank or the
# chunk stream below take the view. Module attributes, so tests can
# move a small index past them.
TOPN_MAX_BANK_BYTES = 2 << 30
# Rows per transient chunk bank on the over-budget TopN stream.
TOPN_CHUNK_ROWS = 1024
# Device-resident positions bank for over-budget TopN over a narrow
# single-shard view (core/view.py PositionsBank); off = the chunk stream,
# which the tests hold the positions bank against.
PBANK_ENABLED = True
# The JAX package's PBANK_SPARSE_FILTER_BITS and PBANK_MEMBERSHIP choose
# between jnp membership forms (a compare against the filter's first
# positions, a binary search, a gather) by filter density; the port's
# membership kernel tests each position against the whole filter in
# shared memory, exact at any density, so it has neither. Nor does it
# have PBANK_INFLIGHT_SEGMENTS: that bounds coexisting XLA workspaces,
# and the kernel allocates only its [R] int32 output, so segments run
# back to back with no wave sync.

# One warm TopN cache hit in this many also runs the exact sweep and
# compares (the first hit always does): the shortcut is exact only while
# every write path refreshes the cached counts, and the sample turns a
# missed path into a counted mismatch and a cache repair. 0 disables.
TOPN_SELFCHECK_EVERY = int(os.environ.get("PILOSA_TPU_TOPN_SELFCHECK",
                                          256))


def _device_mark(device: torch.device) -> Any:
    """Start of one sampled device reading: a timing CUDA event recorded
    on the device's current stream, or the host clock on the CPU (where
    torch runs each op before it returns). Only a sampled profile calls
    it; the unsampled path records nothing."""
    if device.type == "cuda":
        return kernels.device_mark(device)
    return time.perf_counter()


def _fence_device(start: Any) -> float:
    """Seconds of device time since ``start`` (``_device_mark``, or the
    first kernel's event of a megakernel launch): an end event on the
    same stream, waited on with ``synchronize``, then the two events'
    elapsed time. The reading includes whatever the stream waited on the
    host for between the two records: a launch's enqueue gap, and an
    eager evaluation's host work between its kernels. The one fencing
    site of the port: reached only for a sampled profile
    (``?profile=true`` or the profiler's 1-in-N)."""
    if isinstance(start, float):
        return time.perf_counter() - start
    event, stream = start
    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    end.synchronize()
    return event.elapsed_time(end) / 1e3


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the copy waits for the card's work on it."""
    with span("Executor.fetch", bytes=t.numel() * t.element_size()):
        return t.cpu()


def _result_d2h(result: Any) -> int:
    """Device bytes a result still holds for the host to fetch: a Row
    result's words (its columns are read when it is shaped)."""
    if isinstance(result, RowResult) and not result.cached:
        words = getattr(result, "words", None)
        if isinstance(words, (torch.Tensor, MeshTensor)):
            return int(words.nbytes)
    return 0


class ExecutionError(ValueError):
    pass


@dataclass
class ExecOptions:
    """Per-query options that Options() sets: the exclude flags apply
    to the call inside it; ``column_attrs`` shapes the whole response."""
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    column_attrs: bool = False


def column_attr_sets(idx: Index, ids: Sequence[int],
                     resolve: Optional[Callable[[List[int]],
                                                List[Optional[str]]]] = None
                     ) -> List[Dict[str, Any]]:
    """The non-empty column attribute sets of ``ids``, named by key on a
    keyed index (by id where a column has no key), as the JAX package's
    ``column_attr_sets`` gives them; ``resolve`` looks the keys up (the
    local column translator by default)."""
    withattrs = list(idx.column_attr_store.get_many(ids).items())
    if not idx.keys:
        return [{"id": c, "attrs": a} for c, a in withattrs]
    keys = (resolve or idx.column_translator.translate_ids)(
        [c for c, _ in withattrs])
    return [({"key": k, "attrs": a} if k is not None
             else {"id": c, "attrs": a})
            for (c, a), k in zip(withattrs, keys)]


def _peel_options(call: Call) -> Call:
    while call.name == "Options" and call.children:
        call = call.children[0]
    return call


def _parse(query: Union[str, Call, Query]) -> Query:
    if isinstance(query, str):
        with span("PQL.parse"):
            query = parse_string_cached(query)
    if isinstance(query, Call):
        query = Query([query])
    return query


def _query_writes(query: Query) -> bool:
    return any(_peel_options(c).writes() for c in query.calls)


def write_call_count(query: Query) -> int:
    return sum(1 for c in query.calls if _peel_options(c).writes())


def query_is_write(query: Union[str, Call, Query]) -> bool:
    """True when ``query`` holds a write call (inside Options too). The
    serving coalescer flushes its window on a write and dedups nothing
    around it. A parse error reads as False: the request reports it."""
    try:
        return _query_writes(_parse(query))
    except Exception:
        return False


def _topn_order(rows_arr: np.ndarray, counts_arr: np.ndarray, n: int,
                min_threshold: int) -> List[Tuple[int, int]]:
    """The TopN answer from every candidate row's count: counts of at
    least ``max(1, min_threshold)``, in (-count, row) order, the first
    ``n`` (all when 0)."""
    keep = counts_arr > max(0, min_threshold - 1)
    rows_arr, counts_arr = rows_arr[keep], counts_arr[keep]
    rows_arr, counts_arr = _topn_candidates(rows_arr, counts_arr, n)
    order = np.lexsort((rows_arr, -counts_arr))
    if n:
        order = order[:n]
    return [(int(rows_arr[o]), int(counts_arr[o])) for o in order]


def _topn_candidates(rows_arr: np.ndarray, counts_arr: np.ndarray,
                     n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shrink (rows, counts) to the rows that can appear in an exact
    top-n: every count >= the n-th largest (boundary ties kept, so the
    later (-count, row) lexsort still breaks them exactly)."""
    if not n or len(counts_arr) <= max(4096, 4 * n):
        return rows_arr, counts_arr
    kth = np.partition(counts_arr, len(counts_arr) - n)[len(counts_arr) - n]
    sel = counts_arr >= kth
    return rows_arr[sel], counts_arr[sel]


def _pbank_topk(c: torch.Tensor, raw: torch.Tensor, k: int,
                min_threshold: int, tanimoto: int, src
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of one positions-bank segment on the device: membership
    counts ``c`` and row lengths ``raw`` (int32 [R]), rows kept when
    ``c >= max(1, min_threshold)`` and, with ``tanimoto``,
    ``c * 100 >= tanimoto * (raw + src - c)`` with a positive
    denominator. Returns (scores, row indexes), int64 [k]; dropped rows
    score -1. Ties break by the lower index, which is the (-count, row)
    order because a segment's rows are stored ascending: the order is
    made explicit in one int64 key, ``score << 32 | (2^32 - 1 - index)``,
    since torch.topk promises no tie order."""
    c = c.to(torch.int64)
    # A count is at most 2^16 and c <= denominator, so clamping the
    # arguments keeps every comparison as it was and int64 from wrapping.
    keep = c >= max(1, min(min_threshold, 1 << 20))
    if tanimoto:
        denom = raw.to(torch.int64) + src - c
        keep &= (denom > 0) & (c * 100 >= min(tanimoto, 101) * denom)
    score = torch.where(keep, c, torch.full_like(c, -1))
    idx = torch.arange(c.numel(), dtype=torch.int64, device=c.device)
    top = torch.topk((score << 32) | (0xFFFFFFFF - idx), k,
                     sorted=False).values
    return top >> 32, 0xFFFFFFFF - (top & 0xFFFFFFFF)


def _align_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """Slice or zero-pad the trailing word axis to exactly ``width``.
    Both are safe for intersection-style consumers: a bank row has no
    bits past its width, and zeros intersect nothing."""
    w = words.shape[-1]
    if w == width:
        return words
    if w > width:
        return words[..., :width]
    return torch.nn.functional.pad(words, (0, width - w))


def _align_all(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    width = max(r.shape[-1] for r in rows)
    return [_align_words(r, width) for r in rows]


def _thermometer(subs: List[torch.Tensor], k: int) -> torch.Tensor:
    """Columns set in at least k of the (aligned) operand rows: t[j]
    holds "at least j+1 of the operands seen so far"."""
    t = [torch.zeros_like(subs[0]) for _ in range(k)]
    for x in subs:
        for j in range(k - 1, 0, -1):
            t[j] = b_or(t[j], b_and(t[j - 1], x))
        t[0] = b_or(t[0], x)
    return t[k - 1]


@dataclass
class _Plan:
    """One host walk of a call tree for staging: the shape signature,
    the operand banks by (field, view) key, the gather slots (resolved
    once the banks exist), the BSI predicate values as two u32 limbs each,
    the operand widths and a postfix IR for the megakernel lowering.
    ``ir_ok=False`` (Shift, a time range over more than
    MAX_STATIC_RANGE_VIEWS views) means the tree is not lowerable;
    ``literal`` marks the wide time range.
    ``rows_for[key]`` is every row the tree reads from a bank, so an
    over-budget view stages a bank of just those rows. ``bank_sparse``
    snapshots each key's layout once per plan; ``force_dense`` holds keys
    whose sparse build bailed; ``sparse_widths`` the built SparseBanks'
    expansion widths by bank position."""
    sig_parts: List[str] = dc_field(default_factory=list)
    bank_keys: List[Tuple[str, str]] = dc_field(default_factory=list)
    bank_pos: Dict[Tuple[str, str], int] = dc_field(default_factory=dict)
    idxs: List[int] = dc_field(default_factory=list)
    params: List[int] = dc_field(default_factory=list)
    widths: List[int] = dc_field(default_factory=list)
    # (position in idxs, bank key, row id), resolved once banks exist.
    slot_refs: List[Tuple[int, Tuple[str, str], int]] = \
        dc_field(default_factory=list)
    rows_for: Dict[Tuple[str, str], set] = dc_field(default_factory=dict)
    shift_bits: int = 0    # total Shift() distance; widens the plan
    width: int = 0
    ir: List[tuple] = dc_field(default_factory=list)
    ir_ok: bool = True
    bank_sparse: Dict[Tuple[str, str], bool] = \
        dc_field(default_factory=dict)
    force_dense: set = dc_field(default_factory=set)
    sparse_widths: Dict[int, int] = dc_field(default_factory=dict)
    # A time range over more than MAX_STATIC_RANGE_VIEWS views: the eager
    # union's operand is named by no bank key, so the result cache must
    # neither serve nor fill such a tree (the JAX package's literals).
    literal: bool = False

    def bank(self, key: Tuple[str, str]) -> int:
        pos = self.bank_pos.get(key)
        if pos is None:
            pos = len(self.bank_keys)
            self.bank_pos[key] = pos
            self.bank_keys.append(key)
        return pos

    def resolve_width(self) -> int:
        w = max(self.widths, default=_CONTAINER_WORDS)
        if self.shift_bits:
            # Shifted bits may cross the trim boundary; widen to cover.
            extra = (self.shift_bits + CONTAINER_BITS - 1) // CONTAINER_BITS
            w += extra * _CONTAINER_WORDS
        self.width = min(WORDS_PER_SHARD, w)
        return self.width


@dataclass
class _StagedEval:
    """One planned-but-not-run terminal eval: everything the megakernel
    lowering needs (``ir`` is None when the tree does not lower), and
    ``run_eager`` for the per-group path, which returns the count (int)
    or the row words (int32 [S, W])."""
    mode: str              # "count" | "row"
    sig: str
    width: int
    n_shards: int
    bank_arrays: tuple
    idxs: List[int]
    params: List[int]
    ir: Optional[tuple]
    run_eager: Callable[[], Any]
    # The workload recorder's fingerprint (``_EvalIdent.fp``), for the
    # eval seconds the batch's attribution notes; None when not recorded.
    fp: Any = None


class _EvalIdent:
    """The identity of one evaluation, from one host walk of its tree
    and no device touch: the plan, the signature (mode, tree, shard
    count), the fingerprint (signature, row ids, predicate values: the
    workload recorder's signature key) and the generation (each operand
    view's fragment versions over the shards, read before any bank is,
    so a write racing the evaluation leaves the stamp stale). ``key`` is
    the result cache's eval-tier key, None when the eval may not be
    served from or fill the cache. ``t0``/``plan_s``: when the walk
    started and how long it took (the profile's planning time)."""

    __slots__ = ("plan", "sig", "fp", "gen", "key", "t0", "plan_s")

    def __init__(self, plan: _Plan, sig: str, fp: Any, gen: Any,
                 key: Any, t0: float, plan_s: float) -> None:
        self.plan = plan
        self.sig = sig
        self.fp = fp
        self.gen = gen
        self.key = key
        self.t0 = t0
        self.plan_s = plan_s


class _BatchInFlight:
    """A batch between its begin and its finish: per request its
    position, index name, results (``_Deferred`` where staged) and
    options, the per-request errors so far, and each request's
    dependency-capture dict (None where the request tier does not
    fill)."""

    __slots__ = ("staged", "out", "deps_l")

    def __init__(self, staged: List[Tuple[int, str, List[Any],
                                          ExecOptions]],
                 out: List[Any],
                 deps_l: Optional[List[Optional[dict]]] = None) -> None:
        self.staged = staged
        self.out = out
        self.deps_l = deps_l


class _ShapedInFlight:
    """``execute_batch_shaped_begin``'s flight: the batch of the
    requests the request tier did not answer (``run``: their positions),
    the answers so far, and the keys and dependency captures of the
    requests that fill after shaping."""

    __slots__ = ("flight", "out", "keys", "deps_l", "run", "names")

    def __init__(self, flight: _BatchInFlight, out: List[Any],
                 keys: List[Optional[tuple]],
                 deps_l: List[Optional[dict]], run: List[int],
                 names: List[str]) -> None:
        self.flight = flight
        self.out = out
        self.keys = keys
        self.deps_l = deps_l
        self.run = run
        self.names = names


class _Deferred:
    """A result staged under execute_batch's collector; ``resolve()``
    after the flush gives the call's result."""

    __slots__ = ("finish",)

    def __init__(self, finish: Callable[[], Any]) -> None:
        self.finish = finish

    def resolve(self) -> Any:
        return self.finish()


class Executor:
    """Runs PQL against a Holder on the holder's device. ``device``
    defaults to CUDA (raising where there is none) and must match the
    holder's.

    With a ``mesh`` (``parallel/mesh.MeshContext`` of devices of the
    executor's type) the shard list is padded onto the mesh and banks
    are sharded over its shard axis: the tree's row operations run part
    by part, each kernel once a part, and counts and rows are reduced on
    the mesh's first device (the JAX package's SPMD executor with its
    XLA-inserted collectives). The result cache, the positions bank and
    the hybrid layout are off under a mesh, as in the JAX package."""

    def __init__(self, holder: Holder,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Any = None):
        self.device = resolve_device(device)
        if self.device != holder.device:
            raise ValueError(f"executor device {self.device} does not "
                             f"match holder device {holder.device}")
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"mesh devices {mesh.devices} are not of the "
                             f"executor's type {self.device.type}")
        self.holder = holder
        self.mesh = mesh
        self._empty_banks: Dict[int, ViewBank] = {}
        self._tls = threading.local()
        # Megakernel accounting ('+=' is not atomic; batches may run
        # from several threads).
        self._stats_lock = threading.Lock()
        self.mega_launches = 0
        self.mega_queries = 0
        self.mega_plan_entries = 0
        self.mega_fallbacks = 0
        self.mega_budget_fallbacks = 0
        # Staged evals whose tree does not lower (Shift, a time range
        # over more than MAX_STATIC_RANGE_VIEWS views), run eagerly.
        self.mega_unlowered = 0
        # TopN cache tiers: warm shortcut hits and their sampled
        # self-checks, and the device rank vector's hits, patches and
        # rebuilds.
        self.topn_cache_hits = 0
        self.topn_selfchecks = 0
        self.topn_selfcheck_mismatches = 0
        self.rank_cache_hits = 0
        self.rank_cache_patches = 0
        self.rank_cache_rebuilds = 0
        # GroupBy frontiers that outgrew GROUPBY_CHUNK_BYTES and went to
        # host memory.
        self.groupby_spill_events = 0
        # GroupBy calls run, and the counting kernels they launched.
        self.groupby_calls = 0
        self.groupby_launches = 0
        # Plan signatures whose first launch passed verify_plan (the
        # "auto" gate), bounded; the gate's passes and rejects.
        self._verified_sigs: Dict[str, None] = {}
        self.plan_verify_passes = 0
        self.plan_verify_rejects = 0
        # The megakernel's uploaded plan bytes, and each launch's memory
        # traffic by kind and instructions by opcode
        # (ops/megakernel.plan_cost), as the JAX package counts them.
        self.mega_plan_bytes = 0
        # Mesh cohort launches (executor/megakernel.py under a mesh,
        # PILOSA_TPU_MESH): one plan buffer run on every part, the
        # reductions finished by the collective epilogue;
        # collective_bytes is plan_cost's model of what the collectives
        # move (psum + all-gather).
        self.mesh_launches = 0
        self.mesh_collective_bytes = 0
        self.launch_bytes_gather = 0
        self.launch_bytes_compute = 0
        self.launch_bytes_expand = 0
        self.launch_bytes_pad = 0
        self.opcode_counts: Dict[str, int] = {}
        # Plan optimizer (ops/plan_opt.py): plans rewritten, CSE hits,
        # instructions eliminated, fold chains reordered, bytes saved.
        self.opt_plans = 0
        self.opt_cse_hits = 0
        self.opt_entries_eliminated = 0
        self.opt_folds_reordered = 0
        self.opt_bytes_saved = 0
        # Evaluations that had to build or load the kernel library
        # (ops/build.py) on the card: the JAX package's retraces.
        self.jit_compiles = 0
        # The stats client the API attaches (utils/stats.py); None
        # records nothing.
        self.stats: Any = None
        # The cross-request result cache (executor/result_cache.py): the
        # request tier keyed on the coalescer's request identity, the
        # eval tier on the eval's fingerprint and shards under its
        # operand views' generation. On unless PILOSA_TPU_RESULT_CACHE=0.
        self.result_cache = ResultCache()
        # Requests with more write calls than this fail; 0 is no limit
        # (the server sets its config's max_writes_per_request).
        self.max_writes_per_request = 0
        # In a cluster the API sets these to allocate keys on the
        # translate primary (``key_resolver(index, field, keys) -> ids``)
        # and to look up an id the local replica has not replayed yet
        # there (``id_resolver(index, field, ids) -> keys``); None uses
        # the local stores. ``field`` is None for column keys.
        self.key_resolver: Optional[Callable[..., List[int]]] = None
        self.id_resolver: Optional[Callable[..., List[Optional[str]]]] = None

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query: Union[str, Call, Query],
                shards: Optional[Sequence[int]] = None,
                profile: Any = None) -> List[Any]:
        """Execute every call in ``query`` in order; one result each.
        ``profile`` is an optional ``utils/profile.QueryProfile`` the
        run fills in."""
        return self._execute_query(index_name, query, shards,
                                   profile=profile)[0]

    def _execute_query(self, index_name: str,
                       query: Union[str, Call, Query],
                       shards: Optional[Sequence[int]], profile: Any = None
                       ) -> Tuple[List[Any], ExecOptions]:
        """(results, options) of one request: each call's keys are
        translated just before it runs, and its result's ids turned
        back into keys once it resolves (a staged result when it is
        resolved). A profile gets one op node a call: its dispatch time
        (the call's run, or its staging in a batch) and its materialize
        time (the translation back, and the resolution of a staged
        result)."""
        with self._profiled(profile):
            query = _parse(query)
            if self.max_writes_per_request > 0 and \
                    write_call_count(query) > self.max_writes_per_request:
                raise ExecutionError("too many write commands")
            idx = self.holder.index(index_name)
            if idx is None:
                raise ExecutionError(f"index not found: {index_name}")
            opts = ExecOptions()
            out = []
            prof = profile
            if prof is not None:
                prof.mark_dispatch()
            for i, call in enumerate(query.calls):
                op = prof.begin_op(call.name) if prof is not None else None
                t0 = time.perf_counter() if prof is not None else 0.0
                try:
                    self._translate_call(idx, call)
                    res = self._execute_call(idx, call, shards, opts)
                finally:
                    if op is not None:
                        prof.end_op(op, time.perf_counter() - t0)
                if isinstance(res, _Deferred):
                    res = _Deferred(functools.partial(
                        self._resolve_translated, idx, call, res, i, prof))
                else:
                    t0 = time.perf_counter() if prof is not None else 0.0
                    self._translate_result(idx, call, res)
                    if prof is not None:
                        self._finish_op(prof, i, t0, res, call)
                out.append(res)
            return out, opts

    @staticmethod
    def _finish_op(prof: Any, i: int, t0: float, result: Any,
                   call: Call) -> None:
        mat_s = time.perf_counter() - t0
        d2h = _result_d2h(result)
        prof.finish_op(i, mat_s, d2h)
        if prof.timeline is not None:
            TIMELINE.event(prof.timeline, "materialize", LANE_FETCH, t0,
                           mat_s, op=call.name, d2hBytes=d2h)

    def _resolve_translated(self, idx: Index, call: Call, res: _Deferred,
                            i: int = 0, prof: Any = None) -> Any:
        t0 = time.perf_counter() if prof is not None else 0.0
        got = res.resolve()
        self._translate_result(idx, call, got)
        if prof is not None:
            self._finish_op(prof, i, t0, got, call)
        return got

    def execute_full(self, index_name: str, query: Union[str, Call, Query],
                     shards: Optional[Sequence[int]] = None,
                     profile: Any = None) -> Dict[str, Any]:
        """``execute`` shaped as the server's JSON response.

        An eligible request (PQL text of Count and bitmap calls only)
        rides the request tier of the result cache: a repeat whose
        dependency snapshot is still current returns the cached
        response with no parse, plan, launch or copy; a miss runs under
        dependency capture and fills after shaping. A forced profile
        (``?profile=true``) skips the lookup, so its tree describes a
        real run, but still fills."""
        key = self._request_cache_key(index_name, query, shards)
        forced = profile is not None and getattr(profile, "forced", False)
        if key is not None and not forced:
            hit = self._request_cache_get(key, profile)
            if hit is not None:
                return hit
        deps: Optional[dict] = {} if key is not None else None
        with self._dep_capture(deps):
            results, opts = self._execute_query(index_name, query, shards,
                                                profile=profile)
            with span("Executor.shape"):
                resp = self.shape_response(index_name, results, opts)
        if deps is not None:
            self._request_cache_fill(key, deps, resp, opts)
        return resp

    # ------------------------------------------------ request-tier cache

    @contextlib.contextmanager
    def _dep_capture(self, deps: Optional[dict]) -> Iterator[None]:
        """Attach a request-tier dependency collector to this thread
        while a request runs (None: no capture). Staging and the
        attribute and translation reads stamp into it."""
        if deps is None:
            yield
            return
        prev = getattr(self._tls, "deps", None)
        self._tls.deps = deps
        try:
            yield
        finally:
            self._tls.deps = prev

    def _request_cache_key(self, index_name: str, query: Any,
                           shards: Optional[Sequence[int]]
                           ) -> Optional[tuple]:
        """The request tier's key, or None when the request is not
        eligible: the cache is off, the executor is a cluster node's
        (its remote legs cache through the eval tier, as in the JAX
        package) or runs over a mesh, the query is not PQL text or does
        not parse, or a call is not Count or a bitmap call (TopN rides
        the rank cache; writes never cache)."""
        if not self.result_cache.enabled or not isinstance(query, str) \
                or self.key_resolver is not None or self.mesh is not None:
            return None
        try:
            q = _parse(query)
        except Exception:
            return None
        for c in q.calls:
            if c.name != "Count" and c.name not in _BITMAP_CALLS:
                return None
        return ("req",) + request_key(index_name, query, shards)

    def _request_deps_current(self, deps: dict) -> bool:
        """Whether a request-tier dependency snapshot is still current:
        host dict reads only (views' version stamps, the row attribute
        stores' generations, the column translator's size)."""
        for dk, val in deps.items():
            if not isinstance(dk, tuple):
                return False
            kind = dk[0]
            if kind == "view":
                _, iname, fname, vname = dk
                idx = self.holder.index(iname)
                f = idx.field(fname) if idx is not None else None
                view = f.view(vname) if f is not None else None
                cur = view.version_stamp() if view is not None else ()
            elif kind == "rattr":
                _, iname, fname = dk
                idx = self.holder.index(iname)
                f = idx.field(fname) if idx is not None else None
                cur = f.row_attr_store.gen if f is not None else -1
            elif kind == "ctrans":
                _, iname = dk
                idx = self.holder.index(iname)
                cur = idx.column_translator.size() \
                    if idx is not None else -1
            else:
                return False
            if cur != val:
                return False
        return True

    def _request_cache_get(self, key: tuple, profile: Any = None
                           ) -> Optional[Dict[str, Any]]:
        """Request-tier lookup; a hit gets a ``cache`` op with
        ``cacheHit`` in the profile and a ``cache`` lane slice on the
        timeline."""
        t0 = time.perf_counter()
        val = self.result_cache.lookup_request(
            key, self._request_deps_current)
        if val is None:
            return None
        if profile is not None:
            dur = time.perf_counter() - t0
            op = profile.begin_op("cache")
            op.attrs["cacheHit"] = True
            profile.end_op(op, dur)
            if profile.timeline is not None:
                TIMELINE.event(profile.timeline, "cache", LANE_CACHE, t0,
                               dur, hit=True)
        return val

    def _request_cache_fill(self, key: tuple, deps: dict,
                            resp: Dict[str, Any],
                            opts: Optional[ExecOptions] = None) -> None:
        """Fill the request tier after shaping; refused when the capture
        met a dependency it cannot name, or the response embeds
        ``columnAttrs`` (shaped outside the capture's stamps)."""
        if "uncacheable" in deps or not deps:
            return
        if opts is not None and opts.column_attrs:
            return
        self.result_cache.fill(key, dict(deps), resp, approx_nbytes(resp),
                               tier="request")

    def _capture_deps(self, idx: Index, plan: _Plan) -> None:
        """Stamp every operand view of ``plan`` into the request's
        dependency capture, before any bank is read: a write racing the
        read then leaves the stored stamp behind, and the fill can never
        validate (stamp, then read; the first stamp of a view wins)."""
        cap = getattr(self._tls, "deps", None)
        if cap is None:
            return
        for key in plan.bank_keys:
            dk = ("view", idx.name, key[0], key[1])
            if dk not in cap:
                f = idx.field(key[0])
                view = f.view(key[1]) if f is not None else None
                cap[dk] = view.version_stamp() if view is not None else ()
        if plan.literal:
            cap["uncacheable"] = True

    def shape_response(self, index_name: str, results: Sequence[Any],
                       opts: Optional[ExecOptions] = None
                       ) -> Dict[str, Any]:
        """``{"results": [...]}`` of one request's results, with
        ``columnAttrs`` (the attributes of every Row result's columns)
        when an Options asked for them. A Row result fetches its columns
        here, the request's last host sync."""
        resp: Dict[str, Any] = {"results": [result_to_json(r)
                                            for r in results]}
        if opts is not None and opts.column_attrs:
            idx = self.holder.index(index_name)
            ids = sorted({int(c) for r in results
                          if isinstance(r, RowResult)
                          for c in r.columns().tolist()})
            resp["columnAttrs"] = column_attr_sets(idx, ids) \
                if idx is not None else []
        return resp

    def execute_batch(self, requests: Sequence[Tuple[str, Any, Optional[
            Sequence[int]]]], profiles: Optional[Sequence[Any]] = None,
            deps: Optional[Sequence[Optional[dict]]] = None
            ) -> List[Any]:
        """Execute N independent requests as one batch. Each element of
        ``requests`` is ``(index_name, query, shards)``. Returns one
        entry per request: a ``(results, opts)`` tuple (``opts`` is the
        request's ``ExecOptions``: ``column_attrs`` shapes its response)
        or the exception instance for that request; one request's error
        never fails another. Keys translate request by request in
        order, so ids are allocated as one-by-one execution would. The
        two halves are ``execute_batch_begin`` and
        ``execute_batch_finish``. ``profiles`` (optional, aligned with
        ``requests``) carries a ``QueryProfile`` or None per request;
        ``deps`` (aligned too) a request-tier dependency-capture dict or
        None per request, attached while that request runs and
        resolves."""
        return self.execute_batch_finish(
            self.execute_batch_begin(requests, profiles, deps))

    def execute_batch_begin(self, requests: Sequence[Tuple[str, Any,
            Optional[Sequence[int]]]],
            profiles: Optional[Sequence[Any]] = None,
            deps: Optional[Sequence[Optional[dict]]] = None
            ) -> _BatchInFlight:
        """The dispatch half of ``execute_batch``: parse, stage, flush
        and launch every request's device work, and return with the
        results still on the device.

        Read requests run under a collector: their Count and top-level
        bitmap calls stage, and the flush answers heterogeneous staged
        evals with one megakernel launch per shard-count cohort. A
        request that writes is a fence: the collector flushes before
        it, and it runs uncollected, so every read sees exactly the
        state that executing the requests one by one would show it.
        Every staged eval has run when this returns, on banks captured
        here; a write never changes a bank in place (it makes a new
        one), so a write that lands before the finish cannot change
        what the finish reads."""
        from pilosa_tpu_torch.executor.fusion import FusionCollector
        out: List[Any] = [None] * len(requests)
        profs = list(profiles) if profiles is not None \
            else [None] * len(requests)
        deps_l = list(deps) if deps is not None else [None] * len(requests)
        parsed: List[Optional[Query]] = [None] * len(requests)
        has_writes = [False] * len(requests)
        for j, (_, q, _) in enumerate(requests):
            try:
                parsed[j] = _parse(q)
                has_writes[j] = _query_writes(parsed[j])
            except Exception as e:
                out[j] = e  # parse error: reported for this item only
        fuser = FusionCollector(self)
        staged: List[Tuple[int, str, List[Any], ExecOptions]] = []
        try:
            for j, (index_name, _, shards) in enumerate(requests):
                if parsed[j] is None:
                    continue
                try:
                    if has_writes[j]:
                        fuser.flush()
                        with self._dep_capture(deps_l[j]):
                            results, opts = self._execute_query(
                                index_name, parsed[j], shards, profs[j])
                    else:
                        with self._fusing(fuser), \
                                self._dep_capture(deps_l[j]):
                            results, opts = self._execute_query(
                                index_name, parsed[j], shards, profs[j])
                    staged.append((j, index_name, results, opts))
                except Exception as e:
                    out[j] = e
        finally:
            # Staged evals must run before any result resolves.
            fuser.flush()
        return _BatchInFlight(staged, out, deps_l)

    def execute_batch_finish(self, flight: _BatchInFlight) -> List[Any]:
        """The drain half of ``execute_batch``: resolve every staged
        result (the host syncs of the megakernel's counts happen here).
        Safe on another thread than the begin's."""
        out = flight.out
        deps_l = flight.deps_l or [None] * len(out)
        for j, _, results, opts in flight.staged:
            try:
                with self._dep_capture(deps_l[j]):
                    out[j] = ([r.resolve() if isinstance(r, _Deferred)
                               else r for r in results], opts)
            except Exception as e:
                out[j] = e
        return out

    def execute_batch_shaped(self, requests: Sequence[Tuple[
            str, Any, Optional[Sequence[int]]]],
            profiles: Optional[Sequence[Any]] = None) -> List[Any]:
        """``execute_batch`` with each request's response shaped: one
        ``{"results": [...]}`` dict or exception per request (the
        ``/batch/query`` route and the coalescer).

        The batch seam of the request tier: eligible requests answer
        from the cache before anything runs, and misses run under
        dependency capture and fill after shaping. A request after a
        batchmate that writes never looks up: it must see that write."""
        return self.execute_batch_shaped_finish(
            self.execute_batch_shaped_begin(requests, profiles))

    def execute_batch_shaped_begin(self, requests: Sequence[Tuple[
            str, Any, Optional[Sequence[int]]]],
            profiles: Optional[Sequence[Any]] = None) -> _ShapedInFlight:
        """The request tier's lookups, then ``execute_batch_begin`` of
        the requests it did not answer."""
        n = len(requests)
        profs = list(profiles) if profiles is not None else [None] * n
        out: List[Any] = [None] * n
        keys: List[Optional[tuple]] = [None] * n
        deps_l: List[Optional[dict]] = [None] * n
        run: List[int] = []
        write_seen = False
        for j, (index_name, q, shards) in enumerate(requests):
            forced = profs[j] is not None and getattr(
                profs[j], "forced", False)
            key = None
            if not write_seen and not forced:
                key = self._request_cache_key(index_name, q, shards)
            if not write_seen and query_is_write(q):
                write_seen = True
            if key is not None:
                hit = self._request_cache_get(key, profs[j])
                if hit is not None:
                    out[j] = hit
                    continue
                keys[j] = key
                deps_l[j] = {}
            run.append(j)
        flight = self.execute_batch_begin(
            [requests[j] for j in run], profiles=[profs[j] for j in run],
            deps=[deps_l[j] for j in run])
        return _ShapedInFlight(flight, out, keys, deps_l, run,
                               [r[0] for r in requests])

    def execute_batch_shaped_finish(self, flight: _ShapedInFlight
                                    ) -> List[Any]:
        """``execute_batch_finish`` of ``execute_batch_shaped_begin``'s
        flight, then each request's response shaped, and the request tier
        filled for its misses."""
        out = flight.out
        res = self.execute_batch_finish(flight.flight)
        for j, r in zip(flight.run, res):
            if isinstance(r, Exception):
                out[j] = r
                continue
            results, opts = r
            try:
                with span("Executor.shape"):
                    shaped = self.shape_response(flight.names[j], results,
                                                 opts)
            except Exception as e:
                out[j] = e
                continue
            if flight.deps_l[j] is not None:
                self._request_cache_fill(flight.keys[j], flight.deps_l[j],
                                         shaped, opts)
            out[j] = shaped
        return out

    @contextlib.contextmanager
    def _fusing(self, fuser: Any) -> Iterator[None]:
        prev = getattr(self._tls, "fuser", None)
        self._tls.fuser = fuser
        try:
            yield
        finally:
            self._tls.fuser = prev

    # ------------------------------------------------------ profiling hooks

    def _profile(self) -> Any:
        """The QueryProfile of the current thread's request, or None."""
        return getattr(self._tls, "profile", None)

    @contextlib.contextmanager
    def _profiled(self, profile: Any) -> Iterator[None]:
        """Attach ``profile`` (may be None) to this thread while a
        request runs; the evaluation sites read it through
        ``_profile()``."""
        prev = getattr(self._tls, "profile", None)
        self._tls.profile = profile
        try:
            yield
        finally:
            self._tls.profile = prev

    def _kernels_loaded(self) -> bool:
        """The profile's jit hit: the CPU path always hits; on the card
        a launch hits when the kernel library is already loaded."""
        if self.device.type != "cuda":
            return True
        from pilosa_tpu_torch.ops import build
        return build.loaded()

    def _note_jit(self, hit: bool) -> None:
        if not hit:
            with self._stats_lock:
                self.jit_compiles += 1

    def _eval_node(self, idx: Index, call: Call, shards: List[int],
                   mode: str, run: Callable[[], Any],
                   ident: Optional[_EvalIdent] = None) -> Any:
        """Run one evaluation of a call tree (``run()``: the eager tree
        and its kernels) with the measurement plane around it: the
        dispatch-gap analyzer sees its host interval, the workload
        recorder its signature and reads, and a profiled request gets an
        ``eval:<mode>`` node. The node's ``planS`` is the host walk that
        names the tree's signature (``ident``'s, when the caller walked
        it already), ``dispatchS`` the evaluation's host time (bank
        builds and launches), and ``deviceS``, on a sampled profile
        only, the card's time between a CUDA event before the
        evaluation and one after it. A profiled evaluation's seconds
        feed the signature's cache-opportunity estimate."""
        with span("Executor.eval", mode=mode):
            prof = self._profile()
            if ident is None:
                ident = self._eval_ident(idx, call, shards, mode)
                if ident is not None:
                    self._record_eval(idx, ident, mode, shards)
            if prof is None or ident is None:
                # Unprofiled, or a tree whose walk failed (the evaluation
                # raises its error; the JAX package opens no node for it).
                t0 = time.perf_counter()
                out = run()
                TIMELINE.note_dispatch(t0, time.perf_counter() - t0)
                return out
            t_plan0, plan_s, sig = ident.t0, ident.plan_s, ident.sig
            hit = self._kernels_loaded()
            self._note_jit(hit)
            node = prof.tree(mode, sig, hit, plan_s, 0, len(shards))
            tl = prof.timeline
            if tl is not None:
                TIMELINE.event(tl, "plan", LANE_PLAN, t_plan0, plan_s,
                               jit="hit" if hit else "miss")
            start = _device_mark(self.device) if prof.sample_device else None
            t_disp = time.perf_counter()
            out = run()
            dispatch_s = time.perf_counter() - t_disp
            TIMELINE.note_dispatch(t_disp, dispatch_s)
            prof.tree_dispatch(node, dispatch_s)
            if tl is not None:
                TIMELINE.event(tl, "dispatch", LANE_DISPATCH, t_disp,
                               dispatch_s, shards=len(shards))
            device_s = 0.0
            if start is not None:
                t_dev = time.perf_counter()
                device_s = _fence_device(start)
                prof.tree_device(node, device_s)
                if tl is not None:
                    TIMELINE.event(tl, "device", LANE_DEVICE, t_dev, device_s)
            if ident is not None:
                WORKLOAD.note_eval_seconds(ident.fp, dispatch_s + device_s)
            return out

    # ------------------------------------------------------ eval identity

    def _eval_ident(self, idx: Index, call: Call, shards: List[int],
                    mode: str, terminal: bool = False
                    ) -> Optional[_EvalIdent]:
        """The identity of one evaluation (``_EvalIdent``), from a plan
        walk and the views' version maps: no bank is built or read. Also
        stamps the tree's views into the request's dependency capture.
        None when nothing asks for it (the result cache, the workload
        recorder, a profile and the capture all off) or the walk fails
        (the evaluation then raises its own error; under a capture the
        request's fill is refused). ``terminal``: the eval's answer is
        the call's result (Count, a top-level bitmap call), so the eval
        tier may key it."""
        rc = self.result_cache
        cap = getattr(self._tls, "deps", None)
        prof = self._profile()
        if not (rc.enabled or WORKLOAD.enabled or prof is not None
                or cap is not None):
            return None
        t0 = time.perf_counter()
        plan = _Plan()
        try:
            self._plan_call(idx, call, plan)
        except Exception:
            if cap is not None:
                cap["uncacheable"] = True
            return None
        self._capture_deps(idx, plan)
        sig = f"{mode}|{''.join(plan.sig_parts)}|S{len(shards)}"
        fp = (sig, tuple((key, row) for _, key, row in plan.slot_refs),
              tuple(plan.params))
        gen = tuple(self._view_versions(idx, key, shards)
                    for key in plan.bank_keys) \
            if rc.enabled or WORKLOAD.enabled else None
        key = None
        if terminal and rc.enabled and not plan.literal \
                and self.mesh is None \
                and not (prof is not None and prof.forced):
            key = ("eval", idx.name, fp, tuple(int(s) for s in shards))
        return _EvalIdent(plan, sig, fp, gen, key, t0,
                          time.perf_counter() - t0)

    @staticmethod
    def _view_versions(idx: Index, key: Tuple[str, str], shards) -> tuple:
        field = idx.field(key[0])
        view = field.view(key[1]) if field is not None else None
        return view.shard_versions(shards) if view is not None else ()

    def _record_eval(self, idx: Index, ident: _EvalIdent, mode: str,
                     shards: List[int]) -> None:
        """Record one evaluation in the workload recorder: its signature
        under its generation (the repeat tracking the opportunity
        estimate reads) and its reads."""
        if not WORKLOAD.enabled:
            return
        WORKLOAD.record_query(ident.fp, ident.gen, index=idx.name,
                              mode=mode, n_shards=len(shards),
                              sig=ident.sig)
        self._record_plan_reads(idx, ident.plan, shards)

    def _eval_cache_hit(self, ident: _EvalIdent, mode: str,
                        n_shards: int) -> Any:
        """The eval tier's answer for ``ident``, or None. A hit runs,
        stages and copies nothing; a profiled request gets an
        ``eval:<mode>`` node with ``cacheHit`` and a ``cache`` lane
        slice."""
        if ident is None or ident.key is None:
            return None
        hit = self.result_cache.lookup(ident.key, ident.gen)
        if hit is None:
            return None
        prof = self._profile()
        if prof is not None:
            plan_s = time.perf_counter() - ident.t0
            node = prof.tree(mode, ident.sig, None, plan_s, 0, n_shards)
            node.attrs["cacheHit"] = True
            if prof.timeline is not None:
                TIMELINE.event(prof.timeline, "cache", LANE_CACHE,
                               ident.t0, plan_s, hit=True)
        return hit

    def _fill_count(self, ident: Optional[_EvalIdent], count: int) -> int:
        """Fill the eval tier with a count the evaluation already has on
        the host."""
        if ident is not None and ident.key is not None:
            self.result_cache.fill(ident.key, ident.gen, count,
                                   approx_nbytes(count))
        return count

    def _row_filler(self, ident: Optional[_EvalIdent]
                    ) -> Optional[Callable[[np.ndarray], None]]:
        """The hook a Row result calls with its words when it copies
        them to the host for its columns: the eval tier fills from that
        one copy."""
        if ident is None or ident.key is None:
            return None
        rc, key, gen = self.result_cache, ident.key, ident.gen

        def fill(host: np.ndarray) -> None:
            # Every hit of the entry shares these words: a write into
            # them must fail, not change later answers.
            host.setflags(write=False)
            rc.fill(key, gen, host, host.nbytes)
        return fill

    def _count(self, name: str, n: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, n)

    def _note_mega(self, queries: int, plan_entries: int,
                   plan_bytes: int = 0) -> None:
        """Account one megakernel launch covering `queries` staged evals
        through `plan_entries` interpreted instructions and `plan_bytes`
        of uploaded plan."""
        with self._stats_lock:
            self.mega_launches += 1
            self.mega_queries += queries
            self.mega_plan_entries += plan_entries
            self.mega_plan_bytes += plan_bytes
        if self.stats is not None:
            self.stats.count("executor.mega_launches", 1)
            self.stats.count("executor.mega_queries", queries)
            self.stats.count("executor.mega_plan_entries", plan_entries)
            self.stats.count("executor.mega_plan_bytes", plan_bytes)
            self.stats.histogram("executor.mega_batch_size", queries)

    def _note_mesh(self, n_devices: int, collective_bytes: int) -> None:
        """Account one mesh cohort launch: the plan ran on every part of
        the shard axis and the epilogue's collectives moved
        ``collective_bytes`` (plan_cost's model)."""
        with self._stats_lock:
            self.mesh_launches += 1
            self.mesh_collective_bytes += collective_bytes
        if self.stats is not None:
            self.stats.count("executor.mesh_launches", 1)
            self.stats.count("executor.mesh_collective_bytes",
                             collective_bytes)
            self.stats.histogram("executor.mesh_devices", n_devices)

    def _note_launch_cost(self, cost: Dict[str, Any]) -> None:
        """Account one launch's memory traffic by kind and its
        instructions by opcode (``ops/megakernel.plan_cost``)."""
        with self._stats_lock:
            self.launch_bytes_gather += cost["gatherBytes"]
            self.launch_bytes_compute += cost["computeBytes"]
            self.launch_bytes_expand += cost["expandBytes"]
            self.launch_bytes_pad += cost["padBytes"]
            for name, n in cost["opcodeHist"].items():
                self.opcode_counts[name] = \
                    self.opcode_counts.get(name, 0) + n
        if self.stats is not None:
            for kind in ("gather", "compute", "expand", "pad"):
                self.stats.with_tags(f"kind:{kind}").count(
                    "executor.launch_bytes", cost[f"{kind}Bytes"])
            for name, n in cost["opcodeHist"].items():
                self.stats.with_tags(f"op:{name}").count(
                    "executor.opcode", n)

    def _note_opt(self, opt: Any) -> None:
        """Account one launch of a rewritten plan
        (``ops/plan_opt.OptStats``)."""
        with self._stats_lock:
            self.opt_plans += 1
            self.opt_cse_hits += opt.cse_hits
            self.opt_entries_eliminated += opt.entries_eliminated
            self.opt_folds_reordered += opt.folds_reordered
            self.opt_bytes_saved += opt.bytes_saved
        if self.stats is not None:
            self.stats.count("executor.opt_plans", 1)
            self.stats.count("executor.opt_cse_hits", opt.cse_hits)
            self.stats.count("executor.opt_entries_eliminated",
                             opt.entries_eliminated)
            self.stats.count("executor.opt_folds_reordered",
                             opt.folds_reordered)
            self.stats.count("executor.opt_bytes_saved", opt.bytes_saved)

    def _note_mega_fallback(self, groups: int) -> None:
        """A cohort whose lowering failed ran per group."""
        with self._stats_lock:
            self.mega_fallbacks += groups

    def _note_mega_unlowered(self, evals: int) -> None:
        """Staged evals whose tree has no megakernel IR ran eagerly."""
        with self._stats_lock:
            self.mega_unlowered += evals

    def _note_mega_budget_fallback(self, groups: int) -> None:
        """A cohort over the register budget or the tile limit ran per
        group."""
        with self._stats_lock:
            self.mega_budget_fallbacks += groups

    _VERIFIED_SIGS_MAX = 1024

    def _plan_verified(self, sig: str) -> bool:
        with self._stats_lock:
            return sig in self._verified_sigs

    def _note_plan_verify(self, sig: str, ok: bool) -> None:
        """One pre-launch verification: a pass remembers the signature
        for the "auto" gate; a reject is a lowering bug surfacing as the
        requests' error."""
        with self._stats_lock:
            if ok:
                self.plan_verify_passes += 1
                if len(self._verified_sigs) >= self._VERIFIED_SIGS_MAX:
                    self._verified_sigs.pop(
                        next(iter(self._verified_sigs)))
                self._verified_sigs[sig] = None
            else:
                self.plan_verify_rejects += 1
        self._count("executor.plan_verify_passes" if ok
                    else "executor.plan_verify_rejects")

    def _execute_call(self, idx: Index, call: Call,
                      shards: Optional[Sequence[int]],
                      opts: Optional[ExecOptions] = None) -> Any:
        with span("Executor.call", call=call.name):
            name = call.name
            cap = getattr(self._tls, "deps", None)
            if cap is not None and name != "Count" \
                    and name not in _BITMAP_CALLS:
                # The request key admits only these calls; any other read
                # under a capture would cache with dependencies unnamed.
                cap["uncacheable"] = True
            if name == "Options":
                return self._execute_options(idx, call, shards, opts)
            if name == "Count":
                return self._execute_count(idx, call, shards)
            if name in _BITMAP_CALLS:
                return self._execute_bitmap(idx, call, shards, opts)
            if name == "TopN":
                return self._execute_topn(idx, call, shards)
            if name == "Rows":
                return self._execute_rows(idx, call, shards)
            if name == "GroupBy":
                return self._execute_group_by(idx, call, shards)
            if name in ("Sum", "Min", "Max"):
                return self._execute_val_count(idx, call, shards, name)
            if name == "Set":
                return self._execute_set(idx, call)
            if name == "Clear":
                return self._execute_clear(idx, call)
            if name == "ClearRow":
                return self._execute_clear_row(idx, call, shards)
            if name == "Store":
                return self._execute_store(idx, call, shards)
            if name == "SetRowAttrs":
                return self._execute_set_row_attrs(idx, call)
            if name == "SetColumnAttrs":
                return self._execute_set_column_attrs(idx, call)
            raise ExecutionError(f"unknown call: {name}")

    # ------------------------------------------------------ key translation

    def _row_key(self, idx: Index, field: Optional[Field], fname: Any,
                 key: str, msg: Optional[str] = None) -> int:
        """The id of row key ``key`` of ``field`` (allocated when new,
        on the translate primary in a cluster); refused with ``msg`` (by
        default the JAX package's message) when the field is missing or
        not keyed."""
        if field is None or not field.options.keys:
            raise ExecutionError(
                msg or f"string row value not allowed on field {fname}")
        if self.key_resolver is not None:
            return int(self.key_resolver(idx.name, field.name, [key])[0])
        return int(field.row_translator.translate_key(key))

    def _col_key(self, idx: Index, key: str) -> int:
        """The id of column key ``key`` (allocated when new, on the
        translate primary in a cluster)."""
        if not idx.keys:
            raise ExecutionError(f"index {idx.name} does not use column keys")
        if self.key_resolver is not None:
            return int(self.key_resolver(idx.name, None, [key])[0])
        return int(idx.column_translator.translate_key(key))

    def col_keys(self, idx: Index, keys: Sequence[str]) -> np.ndarray:
        """uint64 ids of column keys, allocated when new (on the
        translate primary in a cluster)."""
        if self.key_resolver is not None:
            return np.asarray(self.key_resolver(idx.name, None, list(keys)),
                              dtype=np.uint64)
        return idx.column_translator.translate_keys(keys)

    def row_keys(self, idx: Index, field: Field,
                 keys: Sequence[str]) -> np.ndarray:
        """uint64 ids of a keyed field's row keys, allocated when new (on
        the translate primary in a cluster)."""
        if self.key_resolver is not None:
            return np.asarray(self.key_resolver(idx.name, field.name,
                                                list(keys)), dtype=np.uint64)
        return field.row_translator.translate_keys(keys)

    def _col_ids(self, idx: Index, ids: Sequence[int]
                 ) -> List[Optional[str]]:
        """Keys of column ids (None where an id has none); in a cluster
        a miss asks the translate primary."""
        if self.id_resolver is not None:
            return self.id_resolver(idx.name, None, [int(i) for i in ids])
        return idx.column_translator.translate_ids(ids)

    def _row_ids(self, idx: Index, field: Field,
                 ids: Sequence[int]) -> List[Optional[str]]:
        if self.id_resolver is not None:
            return self.id_resolver(idx.name, field.name,
                                    [int(i) for i in ids])
        return field.row_translator.translate_ids(ids)

    def _translate_call(self, idx: Index, call: Call) -> None:
        """String keys to ids in place, as the JAX package's
        ``_translate_call``: only the row and column arguments of each
        call form are read, so a string attribute value passes through.
        A new key is allocated its id, by a read too. A string where
        the index or field takes no keys is refused with the JAX
        package's message."""
        col = call.args.get("_col")
        if isinstance(col, str):
            call.args["_col"] = self._col_key(idx, col)
        row = call.args.get("_row")
        fname = call.args.get("_field")
        if isinstance(row, str):
            field = idx.field(fname) if fname else None
            call.args["_row"] = self._row_key(idx, field, fname, row)
        # The one field=row argument of these calls.
        if call.name in ("Row", "Range", "Set", "Clear", "ClearRow",
                         "Store"):
            try:
                k, v = self._row_call_field(call)
            except ExecutionError:
                k, v = None, None
            if isinstance(v, str):
                call.args[k] = self._row_key(idx, idx.field(k), k, v)
        if call.name in ("Rows", "TopN"):
            field = idx.field(fname) if fname else None
            prev = call.args.get("previous")
            if isinstance(prev, str):
                call.args["previous"] = self._row_key(
                    idx, field, fname, prev,
                    f"string previous not allowed on field {fname}")
            column = call.args.get("column")
            if isinstance(column, str):
                call.args["column"] = self._col_key(idx, column)
        if call.name == "GroupBy":
            # previous=[...]: one entry a Rows child, in its field.
            prev = call.args.get("previous")
            if prev is not None:
                if not isinstance(prev, list):
                    raise ExecutionError("'previous' argument must be a list")
                if len(prev) != len(call.children):
                    raise ExecutionError(
                        f"mismatched lengths for previous: {len(prev)} "
                        f"and children: {len(call.children)}")
                for i, (p, child) in enumerate(zip(prev, call.children)):
                    if isinstance(p, str):
                        prev[i] = self._row_key(
                            idx, idx.field(child.args.get("_field")), None, p,
                            "prev value must be a row id (int) when field "
                            "doesn't have keys")
        filt = call.args.get("filter")
        if isinstance(filt, Call):
            self._translate_call(idx, filt)
        for child in call.children:
            self._translate_call(idx, child)

    def _translate_result(self, idx: Index, call: Call, result: Any
                          ) -> None:
        """Ids back to keys on a result, as the JAX package's
        ``_translate_result``: a keyed index's Row result gets one key a
        column (its decimal id where the column has no key), a keyed
        field's TopN pairs and Rows ids their keys, and a GroupBy group
        row of a keyed field its ``rowKey``."""
        call = _peel_options(call)
        if isinstance(result, RowResult):
            if idx.keys:
                cap = getattr(self._tls, "deps", None)
                if cap is not None:
                    # The response embeds column keys; an id without a key
                    # may gain one later, which the translator's size
                    # stamp (taken before the read) invalidates.
                    cap.setdefault(("ctrans", idx.name),
                                   idx.column_translator.size())
                cols = result.columns()
                keys = self._col_ids(idx, cols)
                if None in keys:
                    keys = [k if k is not None else str(c)
                            for c, k in zip(cols.tolist(), keys)]
                result.keys = keys
            return
        fname = call.args.get("_field")
        field = idx.field(fname) if isinstance(fname, str) else None
        keyed = field is not None and field.options.keys
        if isinstance(result, PairsResult) and keyed:
            ids = [r for r, _ in result.pairs]
            result.keys = [k or str(r) for r, k in zip(
                ids, self._row_ids(idx, field, ids))]
        elif isinstance(result, RowIdentifiers) and keyed:
            result.keys = [k or str(r) for r, k in zip(
                result.rows, self._row_ids(idx, field, result.rows))]
        elif isinstance(result, list):
            for gc in result:
                if isinstance(gc, GroupCount):
                    for fr in gc.group:
                        gf = idx.field(fr.field)
                        if gf is not None and gf.options.keys:
                            fr.row_key = gf.row_translator.translate_id(
                                fr.row_id)

    def _execute_options(self, idx: Index, call: Call, shards,
                         opts: Optional[ExecOptions]) -> Any:
        """Options(child, columnAttrs=…, excludeColumns=…,
        excludeRowAttrs=…, shards=[…]) around one call, as the JAX
        package's ``_execute_options``: ``columnAttrs`` sets the outer
        options (it shapes the whole response), the exclude flags a copy
        for the child only."""
        if len(call.children) != 1:
            raise ExecutionError("Options() takes exactly one child call")
        child_opts = ExecOptions(**vars(opts)) if opts is not None \
            else ExecOptions()
        for arg in ("columnAttrs", "excludeRowAttrs", "excludeColumns"):
            if arg in call.args and not isinstance(call.args[arg], bool):
                raise ExecutionError(f"Query(): {arg} must be a bool")
        if call.args.get("columnAttrs") and opts is not None:
            opts.column_attrs = True
        if "excludeRowAttrs" in call.args:
            child_opts.exclude_row_attrs = call.args["excludeRowAttrs"]
        if "excludeColumns" in call.args:
            child_opts.exclude_columns = call.args["excludeColumns"]
        if "shards" in call.args:
            arg = call.args["shards"]
            if not isinstance(arg, (list, tuple)) or not all(
                    isinstance(s, int) and not isinstance(s, bool)
                    and s >= 0 for s in arg):
                raise ExecutionError(
                    "Query(): shards must be a list of unsigned integers")
            shards = [int(s) for s in arg]
        return self._execute_call(idx, call.children[0], shards, child_opts)

    # --------------------------------------------------------------- shards

    def _shards(self, idx: Index, shards, pad: bool = True) -> List[int]:
        available = idx.available_shards()
        out = list(shards) if shards is not None else (available or [0])
        if pad and self.mesh is not None:
            # Pad ids must be absent from the whole index, not only from
            # the requested subset.
            floor = (max(available) + 1) if available else 0
            out = self.mesh.pad_shards(out, floor=floor)
        return out

    def _referenced_fields(self, idx: Index, call: Call, out: set) -> bool:
        """Collect every field a row-call tree reads; False when the walk
        cannot tell (the caller then keeps every shard)."""
        name = call.name
        if name in ("Row", "Range"):
            try:
                fname, _ = self._row_call_field(call)
            except ExecutionError:
                return False
            f = idx.field(fname)
            if f is None:
                return False
            out.add(f)
            return True
        if name == "Not":
            ef = idx.existence_field()
            if ef is None:
                return False
            out.add(ef)
            return all(self._referenced_fields(idx, c, out)
                       for c in call.children)
        if name in ("Intersect", "Union", "Difference", "Xor", "Shift",
                    "Threshold"):
            return bool(call.children) and all(
                self._referenced_fields(idx, c, out) for c in call.children)
        return False

    def _restrict_shards(self, idx: Index, call: Call,
                         shards: List[int]) -> List[int]:
        """Drop shards where no referenced field has data: absent
        fragments are all zeros, and zeros stay zeros through any tree."""
        fields: set = set()
        if not self._referenced_fields(idx, call, fields) or not fields:
            return shards
        covered: set = set()
        for f in fields:
            covered.update(f.available_shards())
        return [s for s in shards if s in covered] or shards[:1]

    # ------------------------------------------------------------ bitmaps

    def _fuser(self) -> Any:
        if self.mesh is not None and not self._mesh_fusion_enabled():
            return None
        return getattr(self._tls, "fuser", None)

    def _mesh_fusion_enabled(self) -> bool:
        """Mesh requests enter the batch collector exactly when the mesh
        cohort launch can take their staged evals (the megakernel on and
        ``PILOSA_TPU_MESH`` not 0); groups the launch does not take run
        per group, byte-identical to the unfused mesh path. Otherwise
        they skip the collector, the path before the mesh cohort."""
        from pilosa_tpu_torch.executor import megakernel as megamod
        return megamod.enabled_for(self) and megamod.MESH_ENABLED

    def _execute_bitmap(self, idx: Index, call: Call, shards,
                        opts: Optional[ExecOptions] = None
                        ) -> Union[RowResult, _Deferred]:
        """A top-level bitmap call. Its eval identity comes first: an
        eval-tier hit answers from the host words the miss copied, with
        no staging, launch or copy; a miss runs (or stages) and fills
        when its Row result copies its words for its columns."""
        shards = self._shards(idx, self._restrict_shards(
            idx, call, self._shards(idx, shards, pad=False)))
        opts = opts or ExecOptions()
        ident = self._eval_ident(idx, call, shards, "row", terminal=True)
        # Read now, not when a staged result resolves: a later write of
        # the same batch must not show in this answer.
        attrs = {} if opts.exclude_row_attrs \
            else self._row_attrs(idx, call)

        def result(words: Optional[torch.Tensor],
                   host: Optional[np.ndarray] = None) -> RowResult:
            res = RowResult(shards, words, host)
            res.attrs = attrs
            if host is None:
                res.on_host = self._row_filler(ident)
            if opts.exclude_columns:
                res.clear_columns()
            return res

        if ident is not None:
            self._record_eval(idx, ident, "row", shards)
            hit = self._eval_cache_hit(ident, "row", len(shards))
            if hit is not None:
                return result(None, hit)
        fuser = self._fuser()
        if fuser is not None:
            handle = self._stage_into(fuser, idx, call, shards, "row",
                                      ident)
            return _Deferred(lambda: result(handle.value()))
        words = self._eval_node(idx, call, shards, "row",
                                lambda: self._eval(idx, call, shards), ident)
        return result(words)

    def _execute_count(self, idx: Index, call: Call, shards
                       ) -> Union[int, _Deferred]:
        """Count(tree): an eval-tier hit answers the cached int; a miss
        runs (or stages) and fills with the count it fetched."""
        if len(call.children) != 1:
            raise ExecutionError("Count() takes exactly one row argument")
        child = call.children[0]
        shards = self._shards(idx, self._restrict_shards(
            idx, child, self._shards(idx, shards, pad=False)))
        ident = self._eval_ident(idx, child, shards, "count", terminal=True)
        if ident is not None:
            self._record_eval(idx, ident, "count", shards)
            hit = self._eval_cache_hit(ident, "count", len(shards))
            if hit is not None:
                return hit
        fuser = self._fuser()
        if fuser is not None:
            handle = self._stage_into(fuser, idx, child, shards, "count",
                                      ident)
            if ident is not None and ident.key is not None:
                return _Deferred(
                    lambda: self._fill_count(ident, handle.value()))
            return _Deferred(handle.value)
        count = self._eval_node(
            idx, child, shards, "count",
            lambda: self._count_eager(idx, child, shards), ident)
        return self._fill_count(ident, count)

    def _stage_into(self, fuser: Any, idx: Index, call: Call,
                    shards: List[int], mode: str,
                    ident: Optional[_EvalIdent] = None) -> Any:
        """Stage a terminal eval into the batch's collector; a profiled
        request's eval node opens here with its planning time (from the
        identity walk on, which also recorded its reads)."""
        prof = self._profile()
        t_plan0 = (ident.t0 if ident is not None else time.perf_counter()) \
            if prof is not None else 0.0
        staged = self._stage_tree(idx, call, shards, mode,
                                  ident.plan if ident is not None else None)
        if ident is not None:
            staged.fp = ident.fp
        return fuser.add(staged, prof, t_plan0)

    def _record_plan_reads(self, idx: Index, plan: _Plan, shards) -> None:
        prof = self._profile()
        for key in plan.bank_keys:
            WORKLOAD.record_read(idx.name, key[0], key[1], shards,
                                 rows=plan.rows_for.get(key))
            if prof is not None:
                prof.touch_fragments(idx.name, key[0], key[1], shards)

    def _count_eager(self, idx: Index, child: Call, shards: List[int]
                     ) -> int:
        if child.name == "Intersect" and len(child.children) >= 2:
            subs = _align_all([self._eval(idx, c, shards)
                               for c in child.children])
            a = functools.reduce(b_and, subs[:-1])
            inter, _ = kernels.bank_row_counts_masked(
                a.contiguous().unsqueeze(0), subs[-1].contiguous())
            return int(inter[0])
        row = self._eval(idx, child, shards)
        return int(kernels.bank_row_counts(row.contiguous().unsqueeze(0))[0])

    def _eval_row(self, idx: Index, call: Call, shards: List[int]
                  ) -> torch.Tensor:
        """``_eval`` of a tree another call consumes (a filter, Store's
        source), through the measurement plane."""
        return self._eval_node(idx, call, shards, "row",
                               lambda: self._eval(idx, call, shards))

    def _eval(self, idx: Index, call: Call, shards: List[int]
              ) -> torch.Tensor:
        """Evaluate a row-call tree to int32 words [S, W]."""
        name = call.name
        if name in ("Row", "Range"):
            return self._row_leaf(idx, call, shards)
        if name in ("Not", "Shift") and len(call.children) != 1:
            raise ExecutionError(f"{name}() takes exactly one row argument")
        if name == "Not":
            ef = idx.existence_field()
            if ef is None:
                raise ExecutionError(
                    f"index {idx.name} does not support existence (Not)")
            ex, sub = _align_all([self._slot_leaf(ef, VIEW_STANDARD, 0,
                                                  shards),
                                  self._eval(idx, call.children[0], shards)])
            return b_not(sub, ex)
        if name == "Shift":
            n = self._shift_n(call)
            sub = self._eval(idx, call.children[0], shards)
            # Widen first so shifted bits cannot fall off a trimmed row.
            extra = (n + CONTAINER_BITS - 1) // CONTAINER_BITS
            width = min(WORDS_PER_SHARD, sub.shape[-1]
                        + extra * _CONTAINER_WORDS)
            return shift_bits(_align_words(sub, width), n)
        if name in _FOLDS:
            if not call.children:
                raise ExecutionError(f"{name}() requires row arguments")
            subs = _align_all([self._eval(idx, c, shards)
                               for c in call.children])
            return functools.reduce(_FOLDS[name], subs)
        if name == "Threshold":
            k, n = self._threshold_k(call)
            subs = _align_all([self._eval(idx, c, shards)
                               for c in call.children])
            if k > n:
                return torch.zeros_like(subs[0])
            if k == 1:
                return functools.reduce(b_or, subs)
            if k == n:
                return functools.reduce(b_and, subs)
            return _thermometer(subs, k)
        raise ExecutionError(f"{name} is not a row query")

    @staticmethod
    def _shift_n(call: Call) -> int:
        """Shift(row, n=N)'s distance, 1 when absent or 0. A negative N
        is refused with the reference's message."""
        n = call.uint_arg("n") or 1
        if n < 0:
            raise ExecutionError("index can't contain negative values")
        return n

    @staticmethod
    def _between(cond: Condition) -> Tuple[int, int]:
        """(lo, hi) of a ``><`` condition: its first two values, as the
        reference reads them. One value is refused (the reference fails
        with an internal IndexError there)."""
        vals = cond.int_slice()
        if len(vals) < 2:
            raise ExecutionError(
                f"between condition needs two values, got {len(vals)}")
        return vals[0], vals[1]

    @staticmethod
    def _threshold_k(call: Call) -> Tuple[int, int]:
        """(k, n) of Threshold(k=K, r1, ..., rN): columns set in at least
        K of the N operand rows. K must be a strict integer >= 1 (a k of
        1.5 must not truncate to 1)."""
        if not call.children:
            raise ExecutionError("Threshold() requires row arguments")
        k = call.args.get("k")
        if isinstance(k, bool) or not isinstance(k, int) or k < 1:
            raise ExecutionError(
                "Threshold() requires an integer argument k >= 1")
        return k, len(call.children)

    def _row_leaf(self, idx: Index, call: Call, shards) -> torch.Tensor:
        field_name, row_ref = self._row_call_field(call)
        field = idx.field(field_name)
        if field is None:
            raise ExecutionError(f"field not found: {field_name}")
        if isinstance(row_ref, Condition):
            return self._bsi_leaf(field, row_ref, shards)
        if field.options.type == FIELD_TYPE_INT:
            raise ExecutionError(
                f"int field {field_name} requires a comparison, not =")
        row_id = self._row_id(field, row_ref)
        views = self._range_views(field, call)
        if views is None:
            return self._slot_leaf(field, VIEW_STANDARD, row_id, shards)
        if not views:
            return torch.zeros((len(shards), _CONTAINER_WORDS),
                               dtype=torch.int32, device=self.device)
        if len(views) <= MAX_STATIC_RANGE_VIEWS:
            return functools.reduce(b_or, _align_all(
                [self._slot_leaf(field, v, row_id, shards) for v in views]))
        # A wide cover reads a bank of the one row in each view: a
        # multi-year hourly range must not build every row of every view.
        shards = tuple(shards)
        rows = []
        for v in views:
            bank = field.view(v).device_bank(shards, rows=[row_id],
                                             trim=True, cache_rows=True,
                                             mesh=self.mesh)
            rows.append(bank.array[bank.slot(row_id)])
        return functools.reduce(b_or, _align_all(rows))

    @staticmethod
    def _range_views(field: Field, call: Call) -> Optional[List[str]]:
        """The existing views of a Row/Range call's time range, in cover
        order; None when the call names no range. A range on a field of
        another type is refused with the reference's message; an open
        end is the earliest or the latest datetime, as in the JAX
        package."""
        frm, to = call.arg("from"), call.arg("to")
        if frm is None and to is None:
            return None
        if field.options.type != FIELD_TYPE_TIME:
            raise ExecutionError(f"from/to on non-time field {field.name}")
        start = timeq.parse_timestamp(frm) if frm else datetime.min
        end = timeq.parse_timestamp(to) if to else datetime.max
        return [v for v in field.views_for_range(start, end)
                if field.view(v) is not None]

    def _slot_leaf(self, field: Field, view_name: str, row_id: int,
                   shards) -> torch.Tensor:
        if self._leaf_sparse(field, view_name):
            sb = self._get_sparse_bank(field, view_name, shards)
            if sb is not None:
                # One row expanded from the positions: a dense bank would
                # undo the layout's memory.
                pos, starts = sb.arrays
                return kernels.expand_positions(
                    pos, starts, np.asarray([sb.slot(row_id)], np.int32),
                    len(shards), sb.width)[0]
        bank = self._get_bank_for(field, view_name, shards,
                                  rows_needed={row_id})
        return bank.array[bank.slot(row_id)]

    def _bsi_planes(self, bank: ViewBank, depth: int) -> torch.Tensor:
        """Planes 0..depth-1 and the not-null plane, [depth+1, S, W]: a
        view of the bank when the planes sit in slots 0..depth (the usual
        case), else a gather."""
        slots = [bank.slot(r) for r in range(depth + 1)]
        if slots == list(range(depth + 1)):
            return bank.array[:depth + 1]
        sel = torch.tensor(slots, dtype=torch.long, device=self.device)
        return bank.array.index_select(0, sel)

    def _bsi_leaf(self, field: Field, cond: Condition, shards
                  ) -> torch.Tensor:
        bsig = field.bsi_groups.get(field.name)
        if bsig is None:
            raise ExecutionError(f"field {field.name} is not an int field")
        depth = bsig.bit_depth
        bank = self._get_bank_for(field, view_bsi_name(field.name), shards)
        planes = self._bsi_planes(bank, depth)
        op = cond.op

        def zeros():
            return torch.zeros_like(planes[-1])

        if op == BETWEEN:
            lo_v, hi_v = self._between(cond)
            lo, ok_lo = bsig.base_value_clamped(lo_v, ">=")
            hi, ok_hi = bsig.base_value_clamped(hi_v, "<=")
            if not (ok_lo and ok_hi) or lo > hi:
                return zeros()
            return bsi.between(planes, lo, hi)
        value = int(cond.value)
        base, in_range = bsig.base_value_clamped(value, op)
        if op in (EQ, NEQ) and not in_range:
            return zeros() if op == EQ else bsi.not_null(planes)
        if op in (LT, LTE, GT, GTE) and not in_range:
            return zeros()
        if op == EQ:
            return bsi.eq(planes, base)
        if op == NEQ:
            return bsi.neq(planes, base)
        if op in (LT, LTE):
            allow_eq = op == LTE or value > bsig.max
            return bsi.lt(planes, base, allow_eq=allow_eq)
        allow_eq = op == GTE or value < bsig.min
        return bsi.gt(planes, base, allow_eq=allow_eq)

    # ------------------------------------------------------------ staging

    def _stage_tree(self, idx: Index, call: Call, shards: List[int],
                    mode: str, plan: Optional[_Plan] = None
                    ) -> _StagedEval:
        """Plan a terminal eval without running it: walk the tree (or
        take ``plan``, the eval identity's walk of it), build its banks
        (SparseBanks for sparse-planned keys, dense banks of the rows
        the tree reads for the rest), resolve slots, widths and the
        shape signature. A sparse build that bails forces its key dense
        and replans: each retry adds a key that was planned sparse, so
        the loop ends."""
        force_dense: set = set()
        while True:
            if plan is None:
                plan = _Plan(force_dense=force_dense)
                self._plan_call(idx, call, plan)
            banks, retry = self._stage_banks(idx, plan, shards, force_dense)
            if not retry:
                break
            plan = None
        for i, key, row in plan.slot_refs:
            plan.idxs[i] = banks[plan.bank_pos[key]].slot(row)
        # The plan width resolves after the banks are built, so it covers
        # every bank's actual width (a SparseBank's is the width its rows
        # expand to).
        plan.widths.extend(b.width if isinstance(b, SparseBank)
                           else b.array.shape[-1] for b in banks)
        plan.resolve_width()
        bank_arrays = tuple(b.arrays if isinstance(b, SparseBank)
                            else b.array for b in banks)
        # A sparse operand shows as its (pos, starts) shapes and its
        # expansion width, so the two layouts never share a signature.
        bshapes = [tuple(tuple(x.shape) for x in a) if isinstance(a, tuple)
                   else tuple(a.shape) for a in bank_arrays]
        xw = sorted(plan.sparse_widths.items())
        sig = (f"{mode}|{''.join(plan.sig_parts)}|W{plan.width}"
               f"|B{bshapes}{f'|XW{xw}' if xw else ''}|LNone"
               f"|S{len(shards)}")
        if mode == "count":
            def run_eager() -> Any:
                return self._count_eager(idx, call, shards)
        else:
            def run_eager() -> Any:
                return self._eval(idx, call, shards)
        return _StagedEval(mode=mode, sig=sig, width=plan.width,
                           n_shards=len(shards), bank_arrays=bank_arrays,
                           idxs=list(plan.idxs), params=list(plan.params),
                           ir=tuple(plan.ir) if plan.ir_ok else None,
                           run_eager=run_eager)

    def _plan_call(self, idx: Index, call: Call, plan: _Plan) -> None:
        """Append one call subtree to the plan (signature parts, leaves,
        postfix IR); raises what the eager path raises."""
        name = call.name
        if name in ("Row", "Range"):
            self._plan_row_leaf(idx, call, plan)
            return
        if name in ("Not", "Shift") and len(call.children) != 1:
            raise ExecutionError(f"{name}() takes exactly one row argument")
        if name == "Not":
            ef = idx.existence_field()
            if ef is None:
                raise ExecutionError(
                    f"index {idx.name} does not support existence (Not)")
            self._plan_slot_leaf(ef, VIEW_STANDARD, 0, plan)
            self._plan_call(idx, call.children[0], plan)
            plan.sig_parts.append("!")
            # Not(x) IS existence \ x: the Difference fold.
            plan.ir.append(("fold", "diff", 2))
            return
        if name == "Shift":
            n = self._shift_n(call)
            self._plan_call(idx, call.children[0], plan)
            plan.sig_parts.append(f"S{n}")
            plan.shift_bits += n
            plan.ir_ok = False  # word-carry shifts have no opcode
            return
        if name in _FOLDS:
            if not call.children:
                raise ExecutionError(f"{name}() requires row arguments")
            for c in call.children:
                self._plan_call(idx, c, plan)
            plan.sig_parts.append(f"{name[0]}{len(call.children)}")
            fold = {"Intersect": "and", "Union": "or", "Xor": "xor",
                    "Difference": "diff"}[name]
            plan.ir.append(("fold", fold, len(call.children)))
            return
        if name == "Threshold":
            k, n = self._threshold_k(call)
            for c in call.children:
                self._plan_call(idx, c, plan)
            plan.sig_parts.append(f"T{k}n{n}")
            # k == 1 is Union and k == n Intersect: the fold nodes, so
            # they CSE with real folds of the same operands; k > n is
            # the empty row (the thresh node lowers it to a zeroed
            # register).
            if k == 1:
                plan.ir.append(("fold", "or", n))
            elif k == n:
                plan.ir.append(("fold", "and", n))
            else:
                plan.ir.append(("thresh", k, n))
            return
        raise ExecutionError(f"{name} is not a row query")

    def _stage_banks(self, idx: Index, plan: _Plan, shards,
                     force_dense: set) -> Tuple[List[Any], bool]:
        """Every operand bank the plan names. Returns (banks, retry):
        retry means a sparse build bailed and its key is now in
        ``force_dense``."""
        banks: List[Any] = []
        for key in plan.bank_keys:
            field = idx.field(key[0])
            if plan.bank_sparse.get(key):
                bank = self._get_sparse_bank(field, key[1], shards)
                if bank is None:
                    force_dense.add(key)
                    return banks, True
                plan.sparse_widths[plan.bank_pos[key]] = bank.width
                banks.append(bank)
            else:
                banks.append(self._get_bank_for(
                    field, key[1], shards,
                    rows_needed=plan.rows_for.get(key)))
        return banks, False

    @staticmethod
    def _get_sparse_bank(field: Field, view_name: str, shards
                         ) -> Optional[SparseBank]:
        """The SparseBank of a sparse-planned leaf, or None when the build
        bails (too dense, or the view is gone); then the view heals to
        dense so staging stops asking."""
        view = field.view(view_name) if field is not None else None
        if view is None:
            return None
        bank = view.sparse_bank(tuple(shards))
        if bank is None:
            view.set_layout("dense")
        return bank

    def _leaf_sparse(self, field: Field, view_name: str,
                     force_dense: set = frozenset()) -> bool:
        """Whether a Row leaf of this view serves from its SparseBank: the
        view is in the sparse layout, its width fits the bit-position
        encoding, its key is not forced dense, and there is no mesh."""
        if not layout_mod.HYBRID_LAYOUT_ENABLED or self.mesh is not None \
                or (field.name, view_name) in force_dense:
            return False
        view = field.view(view_name)
        if view is None or view.layout_mode != "sparse":
            return False
        return view.trimmed_words() * 32 <= CONTAINER_BITS

    def _view_width(self, field: Field, view_name: str) -> int:
        """Bank word width without building the bank."""
        view = field.view(view_name)
        if view is None:
            return _CONTAINER_WORDS
        return view.trimmed_words()

    def _plan_slot_leaf(self, field: Field, view_name: str, row_id: int,
                        plan: _Plan) -> None:
        key = (field.name, view_name)
        pos = plan.bank(key)
        sparse = plan.bank_sparse.get(key)
        if sparse is None:
            sparse = self._leaf_sparse(field, view_name, plan.force_dense)
            plan.bank_sparse[key] = sparse
        plan.widths.append(self._view_width(field, view_name))
        i = len(plan.idxs)
        plan.idxs.append(0)
        plan.slot_refs.append((i, key, row_id))
        plan.rows_for.setdefault(key, set()).add(row_id)
        if sparse:
            plan.sig_parts.append(f"x{pos}")
            plan.ir.append(("xslot", pos, i))
            return
        plan.sig_parts.append(f"r{pos}")
        plan.ir.append(("slot", pos, i))

    def _plan_row_leaf(self, idx: Index, call: Call, plan: _Plan) -> None:
        field_name, row_ref = self._row_call_field(call)
        field = idx.field(field_name)
        if field is None:
            raise ExecutionError(f"field not found: {field_name}")
        if isinstance(row_ref, Condition):
            self._plan_bsi_leaf(field, row_ref, plan)
            return
        if field.options.type == FIELD_TYPE_INT:
            raise ExecutionError(
                f"int field {field_name} requires a comparison, not =")
        row_id = self._row_id(field, row_ref)
        views = self._range_views(field, call)
        if views is None:
            self._plan_slot_leaf(field, VIEW_STANDARD, row_id, plan)
        elif not views:
            plan.sig_parts.append("z")
            plan.ir.append(("zero",))
        elif len(views) <= MAX_STATIC_RANGE_VIEWS:
            for v in views:
                self._plan_slot_leaf(field, v, row_id, plan)
            plan.sig_parts.append(f"U{len(views)}")
            plan.ir.append(("fold", "or", len(views)))
        else:
            # The eager union answers; nothing is staged for it.
            plan.sig_parts.append(f"L{len(views)}")
            plan.ir_ok = False
            plan.literal = True

    def _plan_bsi_leaf(self, field: Field, cond: Condition, plan: _Plan
                       ) -> None:
        """BSI comparison leaf: depth+1 plane slots of the field's bsig
        bank; the predicate values ride in params as two u32 limbs."""
        bsig = field.bsi_groups.get(field.name)
        if bsig is None:
            raise ExecutionError(f"field {field.name} is not an int field")
        depth = bsig.bit_depth
        view_name = view_bsi_name(field.name)
        key = (field.name, view_name)
        pos = plan.bank(key)
        # BSI plane banks stay dense: a leaf gathers depth + 1 rows.
        plan.bank_sparse.setdefault(key, False)
        plan.widths.append(self._view_width(field, view_name))
        i0 = len(plan.idxs)
        rows_set = plan.rows_for.setdefault(key, set())
        for r in range(depth + 1):
            plan.idxs.append(0)
            plan.slot_refs.append((i0 + r, key, r))
            rows_set.add(r)

        def zeros() -> None:
            plan.sig_parts.append("z")
            plan.ir.append(("zero",))

        def push_value(base: int) -> int:
            j = len(plan.params)
            plan.params.extend([base & 0xFFFFFFFF, (base >> 32) & 0xFFFFFFFF])
            return j

        op = cond.op
        if op == BETWEEN:
            lo_v, hi_v = self._between(cond)
            lo, ok_lo = bsig.base_value_clamped(lo_v, ">=")
            hi, ok_hi = bsig.base_value_clamped(hi_v, "<=")
            if not (ok_lo and ok_hi) or lo > hi:
                zeros()
                return
            j = push_value(lo)
            k = push_value(hi)
            plan.sig_parts.append(f"c><{pos}d{depth}")
            plan.ir.append(("bsi", "between", pos, i0, depth, j, k, True))
            return
        value = int(cond.value)
        base, in_range = bsig.base_value_clamped(value, op)
        if op in (EQ, NEQ) and not in_range:
            if op == EQ:
                zeros()
                return
            plan.sig_parts.append(f"cn{pos}d{depth}")
            plan.ir.append(("bsi", "notnull", pos, i0, depth, 0, 0, False))
            return
        if op in (LT, LTE, GT, GTE) and not in_range:
            zeros()
            return
        if op in (LT, LTE):
            allow_eq = (op == LTE) or (value > bsig.max)
        elif op in (GT, GTE):
            allow_eq = (op == GTE) or (value < bsig.min)
        else:
            allow_eq = False
        j = push_value(base)
        ir_kind = {EQ: "eq", NEQ: "neq", LT: "lt", LTE: "lt",
                   GT: "gt", GTE: "gt"}[op]
        ir_allow = allow_eq if op in (LT, GT) else op in (LTE, GTE)
        plan.ir.append(("bsi", ir_kind, pos, i0, depth, j, 0, ir_allow))
        plan.sig_parts.append(f"c{op}{int(allow_eq)}{pos}d{depth}")

    # ---------------------------------------------------------- bank fetch

    # A view whose full bank would pass this many device bytes serves
    # a leaf from a cached bank of just the rows it needs: one Row of a
    # 10M-row field must not upload the whole field.
    BANK_MAX_BYTES = 2 << 30

    def _get_bank_for(self, field: Field, view_name: str, shards,
                      rows_needed: Optional[set] = None) -> ViewBank:
        view = field.view(view_name)
        if view is None:
            # Reads never create views; an absent view is all-zero rows.
            return self._empty_bank(len(shards))
        shards = tuple(shards)
        if rows_needed is not None:
            # The sum of the fragments' row counts bounds the full bank's
            # rows without a union: if even the bound fits, the bank does.
            # Over many shards it counts a row once a fragment, so where
            # it does not fit, the union's size (memoized by the
            # fragments' versions) decides.
            def over(n_rows: int) -> bool:
                return bank_capacity(n_rows) * len(shards) \
                    * view.trimmed_words() * 4 > self.BANK_MAX_BYTES \
                    and len(rows_needed) < n_rows
            if over(view.row_count_bound(shards)) and (
                    len(shards) == 1
                    or over(len(view.merged_row_ids(shards)))):
                return view.device_bank(shards, rows=sorted(rows_needed),
                                        trim=True, cache_rows=True,
                                        mesh=self.mesh)
        return view.device_bank(shards, trim=True, mesh=self.mesh)

    def _empty_bank(self, n_shards: int) -> ViewBank:
        bank = self._empty_banks.get(n_shards)
        if bank is None:
            arr = torch.zeros((1, n_shards, _CONTAINER_WORDS),
                              dtype=torch.int32, device=self.device)
            if self.mesh is not None:
                arr = self.mesh.put_bank(arr)
            bank = ViewBank(arr, {}, 0, {})
            self._empty_banks[n_shards] = bank
        return bank

    def _row_call_field(self, call: Call) -> Tuple[str, Any]:
        """(field, row-or-condition) of a Row() call."""
        for k, v in call.args.items():
            if k in ("from", "to") or k.startswith("_"):
                continue
            return k, v
        raise ExecutionError(f"{call.name}() requires a field argument")

    def _row_id(self, field: Field, row_ref) -> int:
        if isinstance(row_ref, bool):
            return 1 if row_ref else 0
        if isinstance(row_ref, int):
            return row_ref
        if isinstance(row_ref, str):
            # Translation runs first, so only a field that is not keyed
            # gets here.
            raise ExecutionError(
                f"string row value not allowed on field {field.name}")
        raise ExecutionError(f"invalid row reference {row_ref!r}")

    def _row_attrs(self, idx: Index, call: Call) -> Dict[str, Any]:
        """The attributes of the one row a Row or Range call names (none
        for a condition, a tree or a missing field)."""
        if call.name not in ("Row", "Range"):
            return {}
        try:
            fname, row_ref = self._row_call_field(call)
        except ExecutionError:
            return {}
        field = idx.field(fname)
        if field is None or isinstance(row_ref, bool) \
                or not isinstance(row_ref, int):
            return {}
        cap = getattr(self._tls, "deps", None)
        if cap is not None:
            # Attribute writes bump no fragment version: the request tier
            # stamps the store's own generation, before the read.
            cap.setdefault(("rattr", idx.name, field.name),
                           field.row_attr_store.gen)
        return field.row_attr_store.get(row_ref)

    def _write_row_id(self, field: Field, row_ref) -> int:
        """The row id a write names, refused outside [0, 2^64) before
        anything is written: a stored negative row would break every
        later read of the field."""
        row_id = self._row_id(field, row_ref)
        if not 0 <= row_id < 1 << 64:
            raise ExecutionError(
                f"row id {row_id} out of range [0, 2^64) on field "
                f"{field.name}")
        return row_id

    # ---------------------------------------------------------------- TopN

    def _execute_topn(self, idx: Index, call: Call, shards) -> PairsResult:
        """Exact TopN: every row's count, then the (-count, row) order on
        the host. Without a filter or tanimoto, two caches come first:

        - the fragments' count caches, while every one provably holds
          every present row (``_topn_cached_counts``): no device work.
          One hit in TOPN_SELFCHECK_EVERY (the first always) falls
          through to the sweep below and compares;
        - the view bank's device rank vector (``_topn_rank_cached``).

        Otherwise the counts come from one of three places:

        - the trimmed full-view bank while it fits TOPN_MAX_BANK_BYTES:
          one popcount sweep;
        - past it, for a narrow single-shard view with ``n`` and no
          ``ids``, the device-resident positions bank: the membership
          kernel per segment, the keep mask and a top-k on the device
          (``_topn_positions``);
        - otherwise transient chunk banks of TOPN_CHUNK_ROWS rows, one
          sweep each."""
        field_name = call.arg("_field")
        field = idx.field(field_name)
        if field is None:
            raise ExecutionError(f"field not found: {field_name}")
        n = call.uint_arg("n") or 0
        shards = self._shards(idx, shards)
        view = field.view(VIEW_STANDARD)
        if view is None:
            return PairsResult([])
        # Sweep only shards the view covers: absent fragments add zero.
        covered = [s for s in shards if view.fragment(s) is not None]
        if not covered:
            return PairsResult([])
        if len(covered) < len(shards):
            shards = self._shards(idx, covered)
        filter_words = None
        if call.children:
            filter_words = self._eval_row(idx, call.children[0], shards)
        # attrName/attrValues restrict the candidates to the rows whose
        # attribute matches, read afresh each call: an attribute write
        # changes no fragment version, so no cached answer may hold
        # them. The count caches and the rank vector still give the
        # counts (attributes do not change a count).
        attr_name = call.arg("attrName")
        allowed_rows = None
        if attr_name is not None:
            allowed_rows = set(field.row_attr_store.ids_matching(
                attr_name, call.arg("attrValues", [])))
        tanimoto = call.uint_arg("tanimotoThreshold") or 0
        ids_arg = call.arg("ids")
        min_threshold = call.uint_arg("threshold") or 0

        with span("Executor.rows") as sp:
            view_rows = view.merged_row_ids(shards)
            all_rows = view_rows
            if allowed_rows is not None:
                all_rows = [r for r in all_rows if r in allowed_rows]
            if ids_arg:
                wanted = {int(i) for i in ids_arg}
                all_rows = [r for r in all_rows if r in wanted]
            if sp is not None:
                sp.set("rows", len(all_rows))
        if not all_rows:
            return PairsResult([])
        # Before the warm caches: a cached answer is still a read.
        WORKLOAD.record_read(idx.name, field_name, VIEW_STANDARD, shards,
                             rows=all_rows)
        prof = self._profile()
        if prof is not None:
            prof.touch_fragments(idx.name, field_name, VIEW_STANDARD,
                                 shards)

        selfcheck_pairs = None  # a warm answer this sweep verifies
        if filter_words is None and not tanimoto:
            cached = self._topn_cached_counts(view, shards)
            if cached is not None:
                with self._stats_lock:
                    self.topn_cache_hits += 1
                    hits = self.topn_cache_hits
                warm = _topn_order(
                    np.asarray(all_rows, dtype=np.uint64),
                    np.fromiter((cached.get(r, 0) for r in all_rows),
                                dtype=np.int64, count=len(all_rows)),
                    n, min_threshold)
                # == 1 % EVERY: at EVERY = 1 every hit checks.
                if not (TOPN_SELFCHECK_EVERY and hits % TOPN_SELFCHECK_EVERY
                        == 1 % TOPN_SELFCHECK_EVERY):
                    return PairsResult(warm)
                with self._stats_lock:
                    self.topn_selfchecks += 1
                selfcheck_pairs = warm
            # The self-check's exact leg must be the real sweep, so it
            # passes the rank vector by.
            elif self.holder.rank_cache.enabled:
                res = self._topn_rank_cached(view, shards, view_rows,
                                             all_rows, n, min_threshold)
                if res is not None:
                    return res

        # The budget is the full bank's size (every view row), whatever
        # the ids subset.
        width = view.trimmed_words()
        bank_bytes = bank_capacity(len(view_rows)) * len(shards) * width * 4
        if bank_bytes <= TOPN_MAX_BANK_BYTES:
            parts = [self._topn_sweep(
                all_rows, view.device_bank(tuple(shards), trim=True,
                                           mesh=self.mesh),
                filter_words)]
        else:
            if PBANK_ENABLED and self.mesh is None and len(shards) == 1 \
                    and not ids_arg and n \
                    and allowed_rows is None and selfcheck_pairs is None:
                pb = view.positions_bank(shards[0], width)
                if pb is not None:
                    return self._topn_positions(pb, filter_words, width, n,
                                                tanimoto, min_threshold)
            parts = [self._topn_sweep(
                rows, view.device_bank(tuple(shards), rows=rows, trim=True,
                                       mesh=self.mesh),
                filter_words)
                for rows in (all_rows[c0:c0 + TOPN_CHUNK_ROWS]
                             for c0 in range(0, len(all_rows),
                                             TOPN_CHUNK_ROWS))]
        rows_arr = np.concatenate([p[0] for p in parts])
        counts_arr = np.concatenate([p[1] for p in parts])
        raws_arr = np.concatenate([p[2] for p in parts])
        if tanimoto and filter_words is not None:
            src_total = int(self._row_popcount(filter_words)[0])
            denom = raws_arr + src_total - counts_arr
            keep = (denom > 0) & (
                (counts_arr * 100) // np.maximum(denom, 1) >= tanimoto)
            rows_arr, counts_arr = rows_arr[keep], counts_arr[keep]
        pairs = _topn_order(rows_arr, counts_arr, n, min_threshold)
        if selfcheck_pairs is not None and selfcheck_pairs != pairs:
            with self._stats_lock:
                self.topn_selfcheck_mismatches += 1
            _LOG.error("TopN warm-cache self-check mismatch on %s/%s: "
                       "cached %r != exact %r; repairing the count caches",
                       idx.name, field_name, selfcheck_pairs[:5], pairs[:5])
            self._repair_topn_caches(view, shards)
        return PairsResult(pairs)

    def _topn_cached_counts(self, view, shards) -> Optional[Dict[int, int]]:
        """Per-row counts summed over the fragments' count caches, or
        None when any fragment's cache cannot prove it is complete (no
        cache, a saturated one, or a present row missing)."""
        total: Dict[int, int] = {}
        for s in shards:
            frag = view.fragment(s)
            if frag is None:
                continue
            if frag.cache_type == CACHE_TYPE_NONE \
                    or getattr(frag.cache, "saturated", False):
                return None
            counts = frag.cache.counts
            rows = frag.row_ids()
            if len(counts) < len(rows):
                return None
            for r in rows:
                c = counts.get(r)
                if c is None:
                    return None
                total[r] = total.get(r, 0) + c
        return total

    @staticmethod
    def _repair_topn_caches(view, shards) -> None:
        """Rebuild every fragment's count cache from storage, after a
        self-check caught stale counts."""
        for s in shards:
            frag = view.fragment(s)
            if frag is not None:
                frag.recalculate_cache()

    # Changed rows past which a rank vector is rebuilt, not patched.
    RANK_PATCH_MAX = int(os.environ.get("PILOSA_TPU_RANK_PATCH_MAX", 4096))

    def _note_rank(self, kind: str) -> None:
        with self._stats_lock:
            if kind == "hit":
                self.rank_cache_hits += 1
            elif kind == "patch":
                self.rank_cache_patches += 1
            else:
                self.rank_cache_rebuilds += 1
        names = {"hit": "hits", "patch": "patches", "rebuild": "rebuilds"}
        self._count(f"rank_cache.{names.get(kind, 'rebuilds')}")

    def _rank_counts(self, view, bank: ViewBank, shards) -> torch.Tensor:
        """The device per-row count vector of ``bank`` (int64
        ``[row_capacity]``, by slot), from the holder's rank store:
        reused while the bank's fragment versions are the entry's;
        patched when the slot layout is the same and at most
        RANK_PATCH_MAX rows were written (``bank_row_counts`` over those
        rows' slots, scattered into a copy); else rebuilt by one
        ``bank_row_counts`` sweep of the bank."""
        store = self.holder.rank_cache
        key = (tuple(int(s) for s in shards), int(bank.array.shape[-1]))
        # Slot-ordered rows: equality proves the same slot layout.
        bank_rows = tuple(bank.slots)
        cap = int(bank.array.shape[0])
        entry = store.get(view, key)
        same_layout = entry is not None and entry.row_ids == bank_rows \
            and int(entry.counts.shape[0]) == cap
        if same_layout and entry.versions == bank.versions:
            self._note_rank("hit")
            return entry.counts
        counts = None
        if same_layout:
            changed: set = set()
            for s, newv in bank.versions.items():
                old = entry.versions.get(s)
                if old == newv:
                    continue
                frag = view.fragment(s)
                ch = frag.rows_changed_since(old) if frag is not None \
                    and old is not None and old >= 0 else None
                if not ch:
                    # No record of which rows moved: rebuild.
                    changed = set()
                    break
                changed.update(ch)
            if changed and len(changed) <= self.RANK_PATCH_MAX \
                    and all(r in bank.slots for r in changed):
                sel = torch.tensor(sorted(bank.slots[r] for r in changed),
                                   dtype=torch.long, device=self.device)
                counts = entry.counts.clone()
                counts[sel] = kernels.bank_row_counts(
                    bank.array.index_select(0, sel))
                self._note_rank("patch")
        if counts is None:
            counts = kernels.bank_row_counts(bank.array)
            self._note_rank("rebuild")
        store.put(view, key, RankEntry(dict(bank.versions), bank_rows,
                                       counts))
        return counts

    def _topn_rank_cached(self, view, shards, view_rows, all_rows,
                          n: int, min_threshold: int
                          ) -> Optional[PairsResult]:
        """Unfiltered TopN over the device rank vector, or None when the
        bank is over budget (the positions bank and the chunk stream own
        that). An unrestricted TopN with ``n`` whose slots ascend with
        the row ids takes a device top-k; an ids subset, ``n`` = 0 or
        any other layout fetches the vector and merges on the host."""
        width = view.trimmed_words()
        if bank_capacity(len(view_rows)) * len(shards) * width * 4 \
                > TOPN_MAX_BANK_BYTES:
            return None
        bank = view.device_bank(tuple(shards), trim=True, mesh=self.mesh)
        counts = self._rank_counts(view, bank, shards)
        slot_rows = np.fromiter(bank.slots, np.uint64, len(bank.slots))
        # The top-k breaks count ties by the lower slot, which is the
        # (-count, row) order only while slots ascend with the rows; a
        # patched bank appends new rows at the end.
        ascending = slot_rows.size < 2 \
            or bool(np.all(slot_rows[1:] > slot_rows[:-1]))
        if n and all_rows is view_rows and ascending:
            k = min(n, len(bank.slots))
            # Unused slots and rows under the threshold score -1; one
            # int64 key makes the tie order explicit, since torch.topk
            # promises none: score * cap + (cap - 1 - slot), exact while
            # a count (< 2^32) times the capacity fits 63 bits.
            cap = counts.numel()
            floor = max(1, min(min_threshold, 1 << 40))
            score = torch.where(counts >= floor, counts,
                                torch.full_like(counts, -1))
            slot = torch.arange(cap, dtype=torch.int64, device=counts.device)
            top = torch.topk(score * cap + (cap - 1 - slot), k).values
            got = _fetch(torch.stack([
                torch.div(top, cap, rounding_mode="floor"),
                cap - 1 - torch.remainder(top, cap)])).tolist()
            return PairsResult([(int(slot_rows[i]), v)
                                for v, i in zip(*got) if v > 0])
        c = _fetch(counts).numpy()
        slot_idx = np.fromiter(
            map(bank.slots.get, all_rows, itertools.repeat(bank.zero_slot)),
            dtype=np.int64, count=len(all_rows))
        return PairsResult(_topn_order(np.asarray(all_rows, dtype=np.uint64),
                                       c[slot_idx], n, min_threshold))

    @staticmethod
    def _row_popcount(words: torch.Tensor) -> torch.Tensor:
        """|row| of one [S, W] row as an int64 [1] tensor on its device."""
        return kernels.bank_row_counts(words.contiguous().unsqueeze(0))

    @staticmethod
    def _topn_sweep(rows: Sequence[int], bank: ViewBank,
                    filter_words: Optional[torch.Tensor]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, |row ∧ filter| or |row|, |row|) of ``rows`` from one
        popcount sweep over ``bank``, as host arrays."""
        with span("Executor.launch"):
            if filter_words is not None:
                filt = _align_words(filter_words, bank.array.shape[-1])
                counts, raws = kernels.bank_row_counts_masked(
                    bank.array, filt.contiguous())
            else:
                counts = raws = kernels.bank_row_counts(bank.array)
        # map(dict.get, ...) keeps the per-row probe loop in C.
        slot_idx = np.fromiter(
            map(bank.slots.get, rows, itertools.repeat(bank.zero_slot)),
            dtype=np.int64, count=len(rows))
        counts_arr = _fetch(counts).numpy()[slot_idx]
        raws_arr = counts_arr if raws is counts \
            else _fetch(raws).numpy()[slot_idx]
        return np.asarray(rows, dtype=np.uint64), counts_arr, raws_arr

    def _topn_positions(self, pb: PositionsBank,
                        filter_words: Optional[torch.Tensor], width: int,
                        n: int, tanimoto: int, min_threshold: int
                        ) -> PairsResult:
        """TopN over a device-resident PositionsBank: per segment the
        membership counts (or, unfiltered, the row lengths), the keep
        mask and a top-k on the device; one transfer of every segment's
        candidates; the merge on the host.

        The filter is cut to the bank's width: a filter row can be wider
        than the bank (Not() over the existence view, a wider sibling
        field), and a real position is below ``width * 32``, so no real
        count changes. The Tanimoto denominator keeps the full filter
        row's popcount, as the dense path does. Tanimoto applies only
        with a filter."""
        fw = None
        src = 0
        outs = []
        with span("Executor.launch", segments=len(pb.segments)):
            if filter_words is not None:
                fw = filter_words[0, :width].contiguous()
                if tanimoto:
                    src = self._row_popcount(filter_words)
            else:
                tanimoto = 0
            for row_lo, n_rows, pos, aux, _p in pb.segments:
                k = min(n, n_rows)
                if k == 0:
                    continue
                fixed = pos.dim() == 2
                raw = aux if fixed else aux[1:] - aux[:-1]
                c = raw if fw is None else kernels.pbank_membership_counts(
                    pos, fw, None if fixed else aux)
                outs.append((row_lo, _pbank_topk(c, raw, k, min_threshold,
                                                 tanimoto, src)))
        if not outs:
            return PairsResult([])
        got = _fetch(torch.cat([t for _, vi in outs for t in vi])).tolist()
        pairs = []
        at = 0
        for row_lo, (v, _) in outs:
            k = v.numel()
            vals, ixs = got[at:at + k], got[at + k:at + 2 * k]
            at += 2 * k
            pairs.extend((pb.row_ids[row_lo + i], val)
                         for val, i in zip(vals, ixs) if val > 0)
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        return PairsResult(pairs[:n])

    # ----------------------------------------------------------------- Rows

    def _execute_rows(self, idx: Index, call: Call, shards
                      ) -> RowIdentifiers:
        """Row ids of a field, ascending, with ``previous`` (ids after
        it), ``limit`` and ``column`` (rows holding that column). Host
        work only: the fragments know their rows. A time field with
        ``from``/``to`` (or with no standard view) reads the views
        covering the range clamped to its earliest and latest views at
        the quantum's coarsest unit, as the reference does
        (executor.go:1160-1218)."""
        field_name = call.arg("_field")
        field = idx.field(field_name)
        if field is None:
            raise ExecutionError(f"field not found: {field_name}")
        shards = self._shards(idx, shards)
        previous = call.arg("previous")
        limit = call.uint_arg("limit")
        column = call.arg("column")
        frm, to = call.arg("from"), call.arg("to")
        ranged = frm is not None or to is not None
        if ranged and field.options.type != FIELD_TYPE_TIME:
            raise ExecutionError(f"from/to on non-time field {field_name}")
        view_names = [VIEW_STANDARD]
        if field.options.type == FIELD_TYPE_TIME and (
                ranged or field.options.no_standard_view):
            q = field.options.time_quantum
            vmin, vmax = timeq.min_max_views(list(field.views), q)
            if not vmin or not vmax:
                return RowIdentifiers([])
            min_t = timeq.time_of_view(vmin, False)
            max_t = timeq.time_of_view(vmax, True)
            start = timeq.parse_timestamp(frm) if frm else min_t
            end = timeq.parse_timestamp(to) if to else max_t
            view_names = field.views_for_range(max(start, min_t),
                                               min(end, max_t))
        rows: set = set()
        for vname in view_names:
            view = field.view(vname)
            if view is None:
                continue
            if column is None:
                rows.update(view.merged_row_ids(shards))
                continue
            frag = view.fragment(column // SHARD_WIDTH) \
                if column // SHARD_WIDTH in shards else None
            if frag is not None:
                rows.update(r for r in frag.row_ids() if frag.bit(r, column))
        out = sorted(rows)
        if previous is not None:
            out = [r for r in out if r > previous]
        if limit is not None:
            out = out[:limit]
        for vname in view_names:
            if field.view(vname) is not None:
                WORKLOAD.record_read(idx.name, field_name, vname, shards,
                                     rows_scanned=len(out))
        return RowIdentifiers(out)

    # -------------------------------------------------------------- GroupBy

    # Device bytes one GroupBy expansion chunk may materialise, and the
    # most a depth's surviving frontier may hold on the device before it
    # moves to host memory (an instance attribute may change it).
    GROUPBY_CHUNK_BYTES = int(os.environ.get(
        "PILOSA_TPU_GROUPBY_CHUNK_BYTES", 256 << 20))

    def _execute_group_by(self, idx: Index, call: Call, shards
                          ) -> List[GroupCount]:
        """``_group_by`` inside an ``Executor.groupBy`` span, whose
        attributes say what the call did: ``children``, ``prefixes`` (a
        depth's prefixes expanded against its child's rows, 1 at depth 0:
        the filter or the whole column space), ``launches`` (counting
        kernels, each in an ``Executor.launch`` span with ``kernel=``),
        ``frontier_bytes`` (the largest surviving frontier) and
        ``spilled``. Counted in ``groupby_calls`` and
        ``groupby_launches``."""
        with self._stats_lock:
            self.groupby_calls += 1
        self._count("executor.groupby_calls")
        note = {"prefixes": [], "launches": 0, "frontier_bytes": 0,
                "spilled": False}
        with span("Executor.groupBy", children=len(call.children)) as sp:
            try:
                return self._group_by(idx, call, shards, note)
            finally:
                with self._stats_lock:
                    self.groupby_launches += note["launches"]
                self._count("executor.groupby_launches", note["launches"])
                if sp is not None:
                    for k, v in note.items():
                        sp.set(k, v)

    def _group_by(self, idx: Index, call: Call, shards, note: dict
                  ) -> List[GroupCount]:
        """Counts of every combination of the Rows() children's rows,
        in ascending order of the row-id tuple, level by level as the
        JAX package runs it: all prefixes of a depth expand against all
        rows of the next child in one batch, chunked by
        GROUPBY_CHUNK_BYTES, and empty prefixes are pruned between
        depths.

        Every popcount goes through a kernel: depth 0 sweeps the first
        child's ``[R, S, W]`` row stack with ``bank_row_counts``; an
        intermediate depth forms ``prefix & row`` for every pair with a
        torch ``&`` and counts it with ``bank_row_counts``; the last
        depth counts each prefix against the last child's stack with
        ``bank_row_counts_masked``, one launch a prefix, never
        materialising the pairs. A frontier that outgrows
        GROUPBY_CHUNK_BYTES at a depth moves to host memory and comes
        back chunk by chunk (``groupby_spill_events``). The filter is an
        eager row evaluation, also under execute_batch's collector."""
        if not call.children or any(c.name != "Rows" for c in call.children):
            raise ExecutionError("GroupBy requires Rows() arguments")
        shards = self._shards(idx, shards, pad=False)
        # Groups only intersect, so a shard some child field does not
        # cover counts zero: keep the children's common shards.
        child_fields = [idx.field(c.arg("_field")) for c in call.children]
        if all(f is not None for f in child_fields):
            covered = set(child_fields[0].available_shards())
            for f in child_fields[1:]:
                covered &= set(f.available_shards())
            shards = [s for s in shards if s in covered]
            if not shards:
                return []
        shards = self._shards(idx, shards)
        limit = call.uint_arg("limit") or 0
        previous = call.arg("previous")
        if previous is not None:
            # A list of one id a child: _translate_call has held it to
            # that.
            previous = tuple(int(p) for p in previous)
        filter_call = call.arg("filter")
        filter_words = None
        if isinstance(filter_call, Call):
            filter_words = self._eval_row(idx, filter_call, shards)

        child_rows: List[Tuple[str, List[int]]] = []
        for child in call.children:
            ids = self._execute_rows(idx, child, shards).rows
            child_rows.append((child.arg("_field"), ids))
            if not ids:
                return []
        for fname, ids_ in child_rows:
            WORKLOAD.record_read(idx.name, fname, VIEW_STANDARD, shards,
                                 rows=ids_)
        # One bank per child (not per field): GroupBy(Rows(f), Rows(f))
        # is legal, and the two children may need different rows.
        banks = [self._get_bank_for(idx.field(fname), VIEW_STANDARD, shards,
                                    rows_needed=set(ids_))
                 for fname, ids_ in child_rows]
        # Bits past the narrowest operand AND to zero.
        wmin = min(b.array.shape[-1] for b in banks)
        if filter_words is not None:
            wmin = min(wmin, filter_words.shape[-1])
            filter_words = filter_words[..., :wmin].contiguous()

        def stacks_at(depth: int) -> torch.Tensor:
            """[R, S, wmin] rows of child ``depth``, contiguous: a view of
            the bank when they fill consecutive slots at its full width,
            else a gathered copy."""
            ids_ = child_rows[depth][1]
            bank = banks[depth]
            slots = [bank.slot(r) for r in ids_]
            lo = slots[0]
            if slots == list(range(lo, lo + len(slots))) \
                    and bank.array.shape[-1] == wmin:
                return bank.array[lo:lo + len(slots)]
            sel = torch.tensor(slots, dtype=torch.long, device=self.device)
            return bank.array.index_select(0, sel)[..., :wmin].contiguous()

        def keep(rows: torch.Tensor, keep_idx: np.ndarray) -> torch.Tensor:
            """The rows at ``keep_idx``: all of them without a copy."""
            if len(keep_idx) == rows.shape[0]:
                return rows
            return rows.index_select(0, torch.as_tensor(keep_idx,
                                                        device=self.device))

        def frontier_chunk(frontier: torch.Tensor, c0: int, c1: int
                           ) -> torch.Tensor:
            return frontier[c0:c1].to(self.device)

        def launch(kernel: str, *args: torch.Tensor):
            note["launches"] += 1
            with span("Executor.launch", kernel=kernel):
                return getattr(kernels, kernel)(*args)

        def frontier(words: Optional[torch.Tensor], n: int) -> None:
            note["prefixes"].append(n)
            if words is not None:
                note["frontier_bytes"] = max(note["frontier_bytes"],
                                             words.numel() * 4)

        n_shards, depth_n = len(shards), len(child_rows)
        # The surviving frontier [P, S, wmin]: on the device while it
        # fits GROUPBY_CHUNK_BYTES, else in host memory. None is the
        # whole column space. prefix_rows[i] is its row-id tuple.
        prefixes = filter_words[None] if filter_words is not None else None
        prefix_rows: List[tuple] = [()]
        for depth in range(depth_n - 1):
            frontier(prefixes, len(prefix_rows))
            stacks = stacks_at(depth)
            R = stacks.shape[0]
            ids = child_rows[depth][1]
            if prefixes is None:
                nz = launch("bank_row_counts", stacks).cpu().numpy() > 0
                keep_idx = np.flatnonzero(nz)
                prefixes = keep(stacks, keep_idx)
                prefix_rows = [(int(ids[i]),) for i in keep_idx]
                continue
            chunk_p = max(1, self.GROUPBY_CHUNK_BYTES
                          // (n_shards * wmin * 4 * R))
            kept_words: List[torch.Tensor] = []
            kept_rows: List[tuple] = []
            kept_bytes = 0
            spilled = False
            for c0 in range(0, len(prefix_rows), chunk_p):
                sub = frontier_chunk(prefixes, c0, c0 + chunk_p)
                new = torch.bitwise_and(sub[:, None], stacks[None]).reshape(
                    -1, n_shards, wmin)
                nz = launch("bank_row_counts", new).cpu().numpy() > 0
                keep_idx = np.flatnonzero(nz)
                if not len(keep_idx):
                    continue
                kept = keep(new, keep_idx)
                del new
                kept_bytes += kept.numel() * 4
                if not spilled and kept_bytes > self.GROUPBY_CHUNK_BYTES:
                    # The survivors pass the device budget: the rest of
                    # this depth's frontier collects in host memory.
                    spilled = note["spilled"] = True
                    with self._stats_lock:
                        self.groupby_spill_events += 1
                    self._count("executor.groupby_spill_events")
                    kept_words = [w.cpu() for w in kept_words]
                kept_words.append(kept.cpu() if spilled else kept)
                # Spilled, these survivors now live on the host: their
                # device copy must not stay alive through the next
                # chunk's expansion (a chunk more of device peak).
                del kept
                kept_rows.extend(prefix_rows[c0 + int(k) // R]
                                 + (int(ids[k % R]),) for k in keep_idx)
            if not kept_words:
                return []
            prefixes = kept_words[0] if len(kept_words) == 1 \
                else torch.cat(kept_words)
            prefix_rows = kept_rows

        # Last depth: every (prefix, row) pair's count.
        frontier(prefixes, len(prefix_rows))
        stacks = stacks_at(depth_n - 1)
        R = stacks.shape[0]
        ids = child_rows[depth_n - 1][1]
        fields = [f for f, _ in child_rows]
        results: List[GroupCount] = []
        counts = None
        if prefixes is None:
            counts = launch("bank_row_counts", stacks).cpu().numpy()[None, :]
        chunk_p = max(1, self.GROUPBY_CHUNK_BYTES
                      // max(1, n_shards * wmin * 4 * R))
        for c0 in range(0, len(prefix_rows), chunk_p):
            if limit and len(results) >= limit:
                break
            if counts is None:
                sub = frontier_chunk(prefixes, c0, c0 + chunk_p)
                chunk_counts = torch.stack([
                    launch("bank_row_counts_masked", stacks, sub[i])[0]
                    for i in range(sub.shape[0])]).cpu().numpy()
            else:
                chunk_counts = counts[c0:c0 + chunk_p]
            for pi in range(chunk_counts.shape[0]):
                row_pre = prefix_rows[c0 + pi]
                # Results are in ascending tuple order, so a prefix below
                # previous's prefix has nothing after ``previous``.
                if previous is not None and \
                        row_pre < previous[:len(row_pre)]:
                    continue
                crow = chunk_counts[pi]
                for ri in np.nonzero(crow)[0]:
                    if limit and len(results) >= limit:
                        break
                    tup = row_pre + (int(ids[ri]),)
                    if previous is not None and tup <= previous:
                        continue
                    results.append(GroupCount(
                        [FieldRow(f, rid) for f, rid in zip(fields, tup)],
                        int(crow[ri])))
        return results

    # ------------------------------------------------------- Sum, Min, Max

    def _execute_val_count(self, idx: Index, call: Call, shards, op: str
                           ) -> ValCount:
        field_name = call.arg("field") or call.arg("_field")
        if field_name is None:
            raise ExecutionError(f"{op}() requires a field argument")
        field = idx.field(field_name)
        if field is None:
            raise ExecutionError(f"field not found: {field_name}")
        bsig = field.bsi_groups.get(field_name)
        if bsig is None:
            raise ExecutionError(f"field {field_name} is not an int field")
        shards = self._shards(idx, shards)
        depth = bsig.bit_depth
        bank = self._get_bank_for(field, view_bsi_name(field_name), shards)
        planes = self._bsi_planes(bank, depth)
        filt = None
        if call.children:
            filt = _align_words(self._eval_row(idx, call.children[0],
                                               shards),
                                bank.array.shape[-1])
        if op == "Sum":
            counts, cnt = bsi.sum_count(planes, filt)
            count = int(cnt[0])
            total = sum(int(c) << i for i, c in enumerate(counts.tolist()))
            return ValCount(total + bsig.min * count, count)
        descend = bsi.min_mask if op == "Min" else bsi.max_mask
        bits, cand = descend(planes, filt)
        count = int(kernels.bank_row_counts(cand.contiguous().unsqueeze(0))[0])
        if count == 0:
            return ValCount(0, 0)
        base = sum(int(v) << i for i, v in enumerate(bits.tolist()))
        return ValCount(base + bsig.min, count)

    # --------------------------------------------------------------- writes

    def _set_args(self, idx: Index, call: Call) -> Tuple[Field, int, Any]:
        col = call.arg("_col")
        if not isinstance(col, int):
            raise ExecutionError("column keys require keys=True (API layer)")
        fname, row_ref = self._row_call_field(call)
        field = idx.field(fname)
        if field is None:
            raise ExecutionError(f"field not found: {fname}")
        return field, col, row_ref

    def _execute_set(self, idx: Index, call: Call) -> bool:
        field, col, row_ref = self._set_args(idx, call)
        if field.options.type == FIELD_TYPE_INT:
            changed = field.set_value(col, int(row_ref))
        else:
            ts = call.arg("_timestamp")
            changed = field.set_bit(
                self._write_row_id(field, row_ref), col,
                timestamp=timeq.parse_timestamp(ts) if ts else None)
        idx.add_existence(np.array([col], dtype=np.uint64))
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        field, col, row_ref = self._set_args(idx, call)
        if field.options.type == FIELD_TYPE_INT:
            return field.clear_value(col)
        return field.clear_bit(self._write_row_id(field, row_ref), col)

    def _execute_clear_row(self, idx: Index, call: Call, shards) -> bool:
        """ClearRow(f=row): clear every bit of the row in every view (a
        time field's time views too) and shard; True when a bit was
        cleared. Set, time, mutex and bool fields take it."""
        fname, row_ref = self._row_call_field(call)
        field = idx.field(fname)
        if field is None:
            raise ExecutionError(f"field not found: {fname}")
        if field.options.type == FIELD_TYPE_INT:
            raise ExecutionError(
                f"ClearRow() is not supported on {field.options.type} fields")
        row_id = self._write_row_id(field, row_ref)
        shards = self._shards(idx, shards, pad=False)  # host-side write
        changed = False
        for view in list(field.views.values()):
            for shard in shards:
                frag = view.fragment(shard)
                if frag is not None and frag.clear_row(row_id):
                    changed = True
        return changed

    def _execute_store(self, idx: Index, call: Call, shards) -> bool:
        """Store(row call, f=row): write the child's row into row ``row``
        of the standard view of set or time field ``f`` (a set field is
        made when missing), replacing it wholesale on every shard. The
        child evaluates on the device and its [S, W] words come to the
        host in one copy."""
        if len(call.children) != 1:
            raise ExecutionError("Store() takes exactly one row argument")
        fname, row_ref = self._row_call_field(call)
        field = idx.field(fname)
        if field is None:
            field = idx.create_field(fname)
        elif field.options.type not in (FIELD_TYPE_SET, FIELD_TYPE_TIME):
            raise ExecutionError(
                f"Store() is not supported on {field.options.type} fields")
        row_id = self._write_row_id(field, row_ref)
        real_shards = self._shards(idx, shards, pad=False)
        padded = self._shards(idx, shards)
        words = to_numpy(self._eval_row(idx, call.children[0], padded))
        view = field.create_view_if_not_exists(VIEW_STANDARD)
        # Only real shards: the mesh's pad shards sit at the tail and
        # must never become fragments.
        for i, shard in enumerate(real_shards):
            view.create_fragment_if_not_exists(shard).set_row(row_id,
                                                              words[i])
        return True

    def _execute_set_row_attrs(self, idx: Index, call: Call) -> None:
        """SetRowAttrs(f, row, name=value, ...): merge into the row's
        attributes (a null value deletes the name)."""
        fname = call.arg("_field")
        field = idx.field(fname)
        if field is None:
            raise ExecutionError(f"field not found: {fname}")
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        field.row_attr_store.set(int(call.arg("_row")), attrs)

    def _execute_set_column_attrs(self, idx: Index, call: Call) -> None:
        """SetColumnAttrs(column, name=value, ...): the same for a
        column."""
        attrs = {k: v for k, v in call.args.items() if not k.startswith("_")}
        idx.column_attr_store.set(int(call.arg("_col")), attrs)
