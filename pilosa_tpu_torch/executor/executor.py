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
  through chunk banks;
- Sum counts bit planes with ``bsi_plane_counts``.

A Row leaf reads one slot of its view's bank; a view whose full bank
would pass ``Executor.BANK_MAX_BYTES`` serves it from a cached bank of
just the rows the leaf needs.

Banks of different views may differ in width (they are trimmed to their
data); operands are zero-padded to a common width before they combine,
which never changes a bit of the result.

``execute_batch`` runs N requests as one batch: under its collector
(``executor/fusion.py``) a read request's ``Count`` and top-level bitmap
calls do not evaluate at once but stage: a host walk of the tree records
its shape signature, operand banks, gather slots, BSI predicate values
and a postfix IR. At the flush, heterogeneous staged evals lower into one
plan buffer and run in ONE ``mega_interpret`` launch
(``executor/megakernel.py``); what the megakernel does not take runs
through the eager path above.

Covered calls: Set, Clear, Row (set fields and BSI conditions),
Intersect, Union, Difference, Xor, Not, Shift, Threshold, Count, TopN,
Sum, Min, Max. The other calls of the JAX package's executor are not part
of this port yet.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from dataclasses import dataclass
from dataclasses import field as dc_field
from typing import Any, Callable, Dict, Iterator, List, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch

from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, Field
from pilosa_tpu_torch.core.fragment import CONTAINER_BITS
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.view import VIEW_STANDARD, PositionsBank, \
    ViewBank, bank_capacity, view_bsi_name
from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.executor import bsi
from pilosa_tpu_torch.executor.results import PairsResult, RowResult, ValCount
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitset import WORDS_PER_SHARD, b_and, b_andnot, \
    b_not, b_or, b_xor, shift_bits
from pilosa_tpu_torch.pql import Call, Condition, Query, parse_string_cached
from pilosa_tpu_torch.pql.ast import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ

_BITMAP_CALLS = {"Row", "Intersect", "Union", "Difference", "Xor", "Not",
                 "Shift", "Threshold"}
_FOLDS = {"Intersect": b_and, "Union": b_or, "Xor": b_xor,
          "Difference": b_andnot}
_CONTAINER_WORDS = CONTAINER_BITS // 32

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


class ExecutionError(ValueError):
    pass


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
    ``ir_ok=False`` (Shift) means the tree is not lowerable."""
    sig_parts: List[str] = dc_field(default_factory=list)
    bank_keys: List[Tuple[str, str]] = dc_field(default_factory=list)
    bank_pos: Dict[Tuple[str, str], int] = dc_field(default_factory=dict)
    idxs: List[int] = dc_field(default_factory=list)
    params: List[int] = dc_field(default_factory=list)
    widths: List[int] = dc_field(default_factory=list)
    # (position in idxs, bank key, row id), resolved once banks exist.
    slot_refs: List[Tuple[int, Tuple[str, str], int]] = \
        dc_field(default_factory=list)
    shift_bits: int = 0    # total Shift() distance; widens the plan
    width: int = 0
    ir: List[tuple] = dc_field(default_factory=list)
    ir_ok: bool = True

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
    holder's."""

    def __init__(self, holder: Holder,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if self.device != holder.device:
            raise ValueError(f"executor device {self.device} does not "
                             f"match holder device {holder.device}")
        self.holder = holder
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
        # Plan signatures whose first launch passed verify_plan (the
        # "auto" gate), bounded.
        self._verified_sigs: Dict[str, None] = {}

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query: Union[str, Call, Query],
                shards: Optional[Sequence[int]] = None) -> List[Any]:
        """Execute every call in ``query`` in order; one result each."""
        if isinstance(query, str):
            query = parse_string_cached(query)
        if isinstance(query, Call):
            query = Query([query])
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecutionError(f"index not found: {index_name}")
        return [self._execute_call(idx, call, shards)
                for call in query.calls]

    def execute_batch(self, requests: Sequence[Tuple[str, Any, Optional[
            Sequence[int]]]]) -> List[Any]:
        """Execute N independent requests as one batch. Each element of
        ``requests`` is ``(index_name, query, shards)``. Returns one
        entry per request: a ``(results, opts)`` tuple (``opts`` is
        always None: ``Options()`` is not ported) or the exception
        instance for that request; one request's error never fails
        another.

        Read requests run under a collector: their Count and top-level
        bitmap calls stage, and the flush answers heterogeneous staged
        evals with one megakernel launch per shard-count cohort. A
        request that writes is a fence: the collector flushes before
        it, and it runs uncollected, so every read sees exactly the
        state that executing the requests one by one would show it."""
        from pilosa_tpu_torch.executor.fusion import FusionCollector
        out: List[Any] = [None] * len(requests)
        parsed: List[Optional[Query]] = [None] * len(requests)
        has_writes = [False] * len(requests)
        for j, (_, q, _) in enumerate(requests):
            try:
                if isinstance(q, str):
                    q = parse_string_cached(q)
                if isinstance(q, Call):
                    q = Query([q])
                parsed[j] = q
                has_writes[j] = bool(q.write_calls())
            except Exception as e:
                out[j] = e  # parse error: reported for this item only
        fuser = FusionCollector(self)
        staged: List[Tuple[int, List[Any]]] = []
        try:
            for j, (index_name, _, shards) in enumerate(requests):
                if parsed[j] is None:
                    continue
                try:
                    if has_writes[j]:
                        fuser.flush()
                        results = self.execute(index_name, parsed[j], shards)
                    else:
                        with self._fusing(fuser):
                            results = self.execute(index_name, parsed[j],
                                                   shards)
                    staged.append((j, results))
                except Exception as e:
                    out[j] = e
        finally:
            # Staged evals must run before any result resolves.
            fuser.flush()
        for j, results in staged:
            try:
                out[j] = ([r.resolve() if isinstance(r, _Deferred) else r
                           for r in results], None)
            except Exception as e:
                out[j] = e
        return out

    @contextlib.contextmanager
    def _fusing(self, fuser: Any) -> Iterator[None]:
        prev = getattr(self._tls, "fuser", None)
        self._tls.fuser = fuser
        try:
            yield
        finally:
            self._tls.fuser = prev

    def _note_mega(self, queries: int, plan_entries: int) -> None:
        """Account one megakernel launch covering `queries` staged evals
        through `plan_entries` interpreted instructions."""
        with self._stats_lock:
            self.mega_launches += 1
            self.mega_queries += queries
            self.mega_plan_entries += plan_entries

    def _note_mega_fallback(self, groups: int) -> None:
        """A cohort whose lowering failed ran per group."""
        with self._stats_lock:
            self.mega_fallbacks += groups

    def _note_mega_budget_fallback(self, groups: int) -> None:
        """A cohort over the register budget or the tile limit ran per
        group."""
        with self._stats_lock:
            self.mega_budget_fallbacks += groups

    _VERIFIED_SIGS_MAX = 1024

    def _plan_verified(self, sig: str) -> bool:
        with self._stats_lock:
            return sig in self._verified_sigs

    def _note_plan_verified(self, sig: str) -> None:
        with self._stats_lock:
            if len(self._verified_sigs) >= self._VERIFIED_SIGS_MAX:
                self._verified_sigs.pop(next(iter(self._verified_sigs)))
            self._verified_sigs[sig] = None

    def _execute_call(self, idx: Index, call: Call,
                      shards: Optional[Sequence[int]]) -> Any:
        name = call.name
        if name == "Count":
            return self._execute_count(idx, call, shards)
        if name in _BITMAP_CALLS:
            return self._execute_bitmap(idx, call, shards)
        if name == "TopN":
            return self._execute_topn(idx, call, shards)
        if name in ("Sum", "Min", "Max"):
            return self._execute_val_count(idx, call, shards, name)
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        raise ExecutionError(f"call {name} is not supported by the port")

    # --------------------------------------------------------------- shards

    def _shards(self, idx: Index, shards) -> List[int]:
        if shards is not None:
            return list(shards)
        return idx.available_shards() or [0]

    def _referenced_fields(self, idx: Index, call: Call, out: set) -> bool:
        """Collect every field a row-call tree reads; False when the walk
        cannot tell (the caller then keeps every shard)."""
        name = call.name
        if name == "Row":
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
        return getattr(self._tls, "fuser", None)

    def _execute_bitmap(self, idx: Index, call: Call, shards
                        ) -> Union[RowResult, _Deferred]:
        shards = self._restrict_shards(idx, call, self._shards(idx, shards))
        fuser = self._fuser()
        if fuser is not None:
            handle = fuser.add(self._stage_tree(idx, call, shards, "row"))
            return _Deferred(lambda: RowResult(shards, handle.value()))
        return RowResult(shards, self._eval(idx, call, shards))

    def _execute_count(self, idx: Index, call: Call, shards
                       ) -> Union[int, _Deferred]:
        if len(call.children) != 1:
            raise ExecutionError("Count() takes exactly one row argument")
        child = call.children[0]
        shards = self._restrict_shards(idx, child, self._shards(idx, shards))
        fuser = self._fuser()
        if fuser is not None:
            handle = fuser.add(self._stage_tree(idx, child, shards, "count"))
            return _Deferred(handle.value)
        return self._count_eager(idx, child, shards)

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

    def _eval(self, idx: Index, call: Call, shards: List[int]
              ) -> torch.Tensor:
        """Evaluate a row-call tree to int32 words [S, W]."""
        name = call.name
        if name == "Row":
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
            n = call.uint_arg("n") or 1
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
        if name == "Range":
            raise ExecutionError(f"{name}() is not supported by the port")
        raise ExecutionError(f"{name} is not a row query")

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
        if call.arg("from") is not None or call.arg("to") is not None:
            raise ExecutionError("time ranges are not supported by the port")
        return self._slot_leaf(field, VIEW_STANDARD,
                               self._row_id(field, row_ref), shards)

    def _slot_leaf(self, field: Field, view_name: str, row_id: int,
                   shards) -> torch.Tensor:
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
            lo_v, hi_v = cond.int_slice()
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
                    mode: str) -> _StagedEval:
        """Plan a terminal eval without running it: walk the tree, build
        its banks, resolve slots, widths and the shape signature."""
        plan = _Plan()
        self._plan_call(idx, call, plan)
        banks = [self._get_bank_for(idx.field(f), v, shards)
                 for f, v in plan.bank_keys]
        for i, key, row in plan.slot_refs:
            plan.idxs[i] = banks[plan.bank_pos[key]].slot(row)
        # The plan width resolves after the banks are built, so it covers
        # every bank's actual width.
        plan.widths.extend(b.array.shape[-1] for b in banks)
        plan.resolve_width()
        bank_arrays = tuple(b.array for b in banks)
        bshapes = [tuple(a.shape) for a in bank_arrays]
        sig = (f"{mode}|{''.join(plan.sig_parts)}|W{plan.width}"
               f"|B{bshapes}|LNone|S{len(shards)}")
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
        if name == "Row":
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
            n = call.uint_arg("n") or 1
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
        if name == "Range":
            raise ExecutionError(f"{name}() is not supported by the port")
        raise ExecutionError(f"{name} is not a row query")

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
        plan.widths.append(self._view_width(field, view_name))
        i = len(plan.idxs)
        plan.idxs.append(0)
        plan.slot_refs.append((i, key, row_id))
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
        if call.arg("from") is not None or call.arg("to") is not None:
            raise ExecutionError("time ranges are not supported by the port")
        self._plan_slot_leaf(field, VIEW_STANDARD,
                             self._row_id(field, row_ref), plan)

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
        plan.widths.append(self._view_width(field, view_name))
        i0 = len(plan.idxs)
        for r in range(depth + 1):
            plan.idxs.append(0)
            plan.slot_refs.append((i0 + r, key, r))

        def zeros() -> None:
            plan.sig_parts.append("z")
            plan.ir.append(("zero",))

        def push_value(base: int) -> int:
            j = len(plan.params)
            plan.params.extend([base & 0xFFFFFFFF, (base >> 32) & 0xFFFFFFFF])
            return j

        op = cond.op
        if op == BETWEEN:
            lo_v, hi_v = cond.int_slice()
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
            bound = sum(len(f.row_ids()) for s in shards
                        for f in [view.fragment(s)] if f is not None)
            full_bytes = bank_capacity(bound) * len(shards) \
                * view.trimmed_words() * 4
            if full_bytes > self.BANK_MAX_BYTES and \
                    len(rows_needed) < bound:
                return view.device_bank(shards, rows=sorted(rows_needed),
                                        trim=True, cache_rows=True)
        return view.device_bank(shards, trim=True)

    def _empty_bank(self, n_shards: int) -> ViewBank:
        bank = self._empty_banks.get(n_shards)
        if bank is None:
            arr = torch.zeros((1, n_shards, _CONTAINER_WORDS),
                              dtype=torch.int32, device=self.device)
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
            raise ExecutionError(
                f"field {field.name}: row keys are not supported by the port")
        raise ExecutionError(f"invalid row reference {row_ref!r}")

    # ---------------------------------------------------------------- TopN

    def _execute_topn(self, idx: Index, call: Call, shards) -> PairsResult:
        """Exact TopN: every row's count, then the (-count, row) order on
        the host. The counts come from one of three places:

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
        if call.arg("attrName") is not None:
            raise ExecutionError("TopN attrName is not supported by the port")
        n = call.uint_arg("n") or 0
        shards = self._shards(idx, shards)
        view = field.view(VIEW_STANDARD)
        if view is None:
            return PairsResult([])
        # Sweep only shards the view covers: absent fragments add zero.
        shards = [s for s in shards if view.fragment(s) is not None]
        if not shards:
            return PairsResult([])
        filter_words = None
        if call.children:
            filter_words = self._eval(idx, call.children[0], shards)
        tanimoto = call.uint_arg("tanimotoThreshold") or 0
        ids_arg = call.arg("ids")
        min_threshold = call.uint_arg("threshold") or 0

        view_rows = view.merged_row_ids(shards)
        all_rows = view_rows
        if ids_arg:
            wanted = {int(i) for i in ids_arg}
            all_rows = [r for r in all_rows if r in wanted]
        if not all_rows:
            return PairsResult([])

        # The budget is the full bank's size (every view row), whatever
        # the ids subset.
        width = view.trimmed_words()
        bank_bytes = bank_capacity(len(view_rows)) * len(shards) * width * 4
        if bank_bytes <= TOPN_MAX_BANK_BYTES:
            parts = [self._topn_sweep(
                all_rows, view.device_bank(tuple(shards), trim=True),
                filter_words)]
        else:
            if PBANK_ENABLED and len(shards) == 1 and not ids_arg and n:
                pb = view.positions_bank(shards[0], width)
                if pb is not None:
                    return self._topn_positions(pb, filter_words, width, n,
                                                tanimoto, min_threshold)
            parts = [self._topn_sweep(
                rows, view.device_bank(tuple(shards), rows=rows, trim=True),
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
        keep = counts_arr > max(0, min_threshold - 1)
        rows_arr, counts_arr = rows_arr[keep], counts_arr[keep]
        rows_arr, counts_arr = _topn_candidates(rows_arr, counts_arr, n)
        order = np.lexsort((rows_arr, -counts_arr))
        if n:
            order = order[:n]
        return PairsResult([(int(rows_arr[o]), int(counts_arr[o]))
                            for o in order])

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
        counts_arr = counts.cpu().numpy()[slot_idx]
        raws_arr = counts_arr if raws is counts \
            else raws.cpu().numpy()[slot_idx]
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
        if filter_words is not None:
            fw = filter_words[0, :width].contiguous()
            if tanimoto:
                src = self._row_popcount(filter_words)
        else:
            tanimoto = 0
        outs = []
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
        got = torch.cat([t for _, vi in outs for t in vi]).cpu().tolist()
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
            filt = _align_words(self._eval(idx, call.children[0], shards),
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
            raise ExecutionError("column keys are not supported by the port")
        if call.arg("_timestamp"):
            raise ExecutionError("timestamps are not supported by the port")
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
            changed = field.set_bit(self._row_id(field, row_ref), col)
        idx.add_existence(np.array([col], dtype=np.uint64))
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        field, col, row_ref = self._set_args(idx, call)
        if field.options.type == FIELD_TYPE_INT:
            return field.clear_value(col)
        return field.clear_bit(self._row_id(field, row_ref), col)

