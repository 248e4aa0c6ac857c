"""Cost-based optimizer for finished megakernel plans.

This package's own copy of the JAX package's ``ops/plan_opt.py``. The
passes rewrite a finished ``Plan`` before it launches; every rewrite
computes the same bits, and the optimized plan still goes through the
executor's pre-launch ``verify_plan`` gate:

1. **Density-ordered fold reordering**: commutative AND/OR/XOR operand
   chains sort cheapest-first by the per-bank live density fed through
   ``note_bank_density``; ANDNOT tails subtract densest-first. Order only
   affects cost, and the canonical order lets the CSE pass match equal
   subtrees that arrived in different operand order.
2. **Cross-request common-subexpression elimination**: value numbering
   over the whole batch, with algebraic identities (``x AND 0 = 0``,
   ``x OR 0 = x``, ``x ANDNOT x = 0``, a THRESH step over a still-zero
   accumulator is a plain AND).
3. **Dead-register elimination and linear-scan re-allocation**: only
   values an output lane reads are re-emitted, scratch registers are
   re-assigned lowest-free-first and freed at their last read, so the
   slab drops whole pow2 capacity buckets.
4. **Width narrowing**: output-lane plan widths tighten to the proven
   nonzero spans; gathered slot width masks are never touched.

Everything here is host Python on the finished Plan. The executor treats
the whole pipeline as best-effort: any surprise keeps the unoptimized
plan. ``core/view.py`` feeds ``note_bank_density`` with each cached dense
bank's sampled live density when it ledgers the bank, and expand
registers (sparse operands) sort at ``SPARSE_DENSITY``; both change only
the order of operations, never a bit. ``predict_cost_bytes`` prices the
emitted plan body with the same weights; ``OptStats.predicted_bytes``
carries it to the roofline plane (``utils/roofline.py``), which records
it beside the measured cost of each launch.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.ops import megakernel as mk

# --------------------------------------------------------- density feed
#
# A bounded id()->density map: the optimizer only needs a relative
# ordering. Staleness (or an id() reused after GC) can only produce a
# suboptimal ORDER, never wrong bits.

_DENSITY_CAP = 4096
_density_lock = threading.Lock()
_density: "OrderedDict[int, float]" = OrderedDict()

# Sparse (hybrid-layout) banks exist only for rows far below the dense
# break-even, so their expanded operands sort as very cheap.
SPARSE_DENSITY = 0.02
# Unknown dense operands sort between sparse rows and computed
# intermediates (scratch), which are assumed dense.
DEFAULT_DENSITY = 0.5
SCRATCH_DENSITY = 1.0


def note_bank_density(array: Any, density: Optional[float]) -> None:
    """Record a device bank's sampled live density (best-effort,
    bounded)."""
    if density is None or array is None:
        return
    with _density_lock:
        _density[id(array)] = float(density)
        _density.move_to_end(id(array))
        while len(_density) > _DENSITY_CAP:
            _density.popitem(last=False)


def bank_density(array: Any) -> float:
    with _density_lock:
        return _density.get(id(array), DEFAULT_DENSITY)


# ------------------------------------------------------------ statistics


class OptStats:
    """One plan's before/after accounting."""

    __slots__ = ("entries_before", "entries_after", "cse_hits",
                 "folds_reordered", "regs_before", "regs_after",
                 "slab_bytes_before", "slab_bytes_after",
                 "plan_bytes_before", "plan_bytes_after",
                 "narrowed_lanes", "predicted_bytes",
                 "fold_order_densities")

    def __init__(self) -> None:
        self.entries_before = 0
        self.entries_after = 0
        self.cse_hits = 0
        self.folds_reordered = 0
        self.regs_before = 0
        self.regs_after = 0
        self.slab_bytes_before = 0
        self.slab_bytes_after = 0
        self.plan_bytes_before = 0
        self.plan_bytes_after = 0
        self.narrowed_lanes = 0
        # Calibration feed (utils/roofline.py): the density-weighted
        # traffic this model predicts for the plan it emitted.
        self.predicted_bytes = 0
        # The sort weights of the first reordered fold chains (bounded):
        # the predicted fold order a roofline reader compares against.
        self.fold_order_densities: List[Tuple[float, ...]] = []

    @property
    def entries_eliminated(self) -> int:
        return max(0, self.entries_before - self.entries_after)

    @property
    def bytes_saved(self) -> int:
        """Slab and plan-buffer bytes the rewrite dropped."""
        return max(0, (self.slab_bytes_before - self.slab_bytes_after)
                   + (self.plan_bytes_before - self.plan_bytes_after))

    def as_dict(self) -> Dict[str, int]:
        return {
            "entriesBefore": self.entries_before,
            "entriesAfter": self.entries_after,
            "entriesEliminated": self.entries_eliminated,
            "cseHits": self.cse_hits,
            "foldsReordered": self.folds_reordered,
            "regsBefore": self.regs_before,
            "regsAfter": self.regs_after,
            "slabBytesBefore": self.slab_bytes_before,
            "slabBytesAfter": self.slab_bytes_after,
            "bytesSaved": self.bytes_saved,
            "narrowedLanes": self.narrowed_lanes,
            "predictedBytes": self.predicted_bytes,
        }


class _Bail(Exception):
    """Internal: the plan has a shape this optimizer does not model; the
    caller keeps the original plan."""


# ------------------------------------------------------- fold reordering

_COMMUTATIVE = (mk.OP_AND, mk.OP_OR, mk.OP_XOR)


def _register_densities(plan: mk.Plan,
                        rows: List[List[int]]) -> Dict[int, float]:
    """Per-register sort weight: dense slots carry their bank's sampled
    live density, OP_EXPAND results the sparse discount, everything else
    the dense-intermediate default."""
    dens: Dict[int, float] = {}
    r = 0
    for bank, slots in zip(plan.banks, plan.slots):
        d = bank_density(bank)
        for _ in range(len(slots)):
            dens[r] = d
            r += 1
    for op, dst, _a, _b in rows:
        if op == mk.OP_EXPAND:
            dens[dst] = SPARSE_DENSITY
    return dens


def _reorder_folds(rows: List[List[int]], dens: Dict[int, float],
                   stats: OptStats) -> None:
    """Sort the operand chains the Lowering's left folds emit.

    A chain is the consecutive run ``(op, r, x0, x1), (op, r, r, x2),
    ... (op, r, r, xm)`` writing one scratch accumulator ``r``; only
    ``r`` is written inside the run, so any permutation of commutative
    operands computes the same value. AND/OR/XOR chains sort ascending by
    density; ANDNOT keeps its pinned left operand and subtracts the
    densest negatives first."""
    def weight(r: int) -> float:
        return dens.get(r, SCRATCH_DENSITY)

    i, n = 0, len(rows)
    while i < n:
        op, r, x0, x1 = rows[i]
        if (op not in _COMMUTATIVE and op != mk.OP_ANDNOT) \
                or x0 == r or x1 == r:
            i += 1
            continue
        j = i + 1
        operands = [x0, x1]
        while j < n:
            op2, r2, a2, b2 = rows[j]
            if op2 != op or r2 != r or a2 != r or b2 == r:
                break
            operands.append(b2)
            j += 1
        if op in _COMMUTATIVE:
            ordered = [x for _, x in sorted(
                enumerate(operands), key=lambda t: (weight(t[1]), t[0]))]
        else:
            head, tail = operands[0], operands[1:]
            ordered = [head] + [x for _, x in sorted(
                enumerate(tail), key=lambda t: (-weight(t[1]), t[0]))]
        if len(stats.fold_order_densities) < 8:
            stats.fold_order_densities.append(
                tuple(round(weight(x), 4) for x in ordered))
        if ordered != operands:
            stats.folds_reordered += 1
            rows[i] = [op, r, ordered[0], ordered[1]]
            for m, x in enumerate(ordered[2:]):
                rows[i + 1 + m] = [op, r, r, x]
        i = j


def predict_cost_bytes(rows: List[List[int]], dens: Dict[int, float],
                       n_shards: int, w_mega: int) -> int:
    """The optimizer's own density-weighted traffic prediction for a
    plan body, in bytes: each instruction reads its operands at their
    sampled live density and writes one dense row (the weights
    ``_reorder_folds`` sorts by), priced in the megakernel's row unit so
    the roofline plane can set it beside ``plan_cost``'s model and the
    fenced device time of each cohort."""
    row = int(n_shards) * int(w_mega) * 4

    def weight(r: int) -> float:
        return dens.get(r, SCRATCH_DENSITY)

    total = 0.0
    for op, dst, a, b in rows:
        reads = 0.0
        if op == mk.OP_EXPAND:
            reads = SPARSE_DENSITY
        else:
            if op in mk._READS_A:
                reads += weight(a)
            if op in mk._READS_B:
                reads += weight(b)
            if op in mk._READS_DST:
                reads += weight(dst)
        total += (reads + 1.0) * row
    return int(total)


# ------------------------------------------------- value numbering / CSE
#
# Node forms: ("zero",) | ("in", reg) | ("expand", xreg)
#           | ("bin", op, va, vb) | ("thresh", vd, va, vb)
# Operand vns are always created before their consumers, so node index
# order IS a valid emission order.

_ZERO_VN = 0


def _value_number(rows: List[List[int]], n_slots: int, n_gathered: int,
                  widths: List[int], stats: OptStats
                  ) -> Tuple[List[tuple], List[int], Dict[int, int]]:
    nodes: List[tuple] = [("zero",)]
    spans: List[int] = [0]
    key2vn: Dict[tuple, int] = {("zero",): _ZERO_VN}
    reg_vn: Dict[int, int] = {}

    def new_node(node: tuple, span: int, key: Optional[tuple]) -> int:
        vn = len(nodes)
        nodes.append(node)
        spans.append(int(span))
        if key is not None:
            key2vn[key] = vn
        return vn

    def read(r: int) -> int:
        if r < n_gathered:
            if r >= n_slots:
                # A direct expand-register read is ill-typed (the
                # verifier's contract); the Lowering never emits one.
                raise _Bail(f"direct expand read r={r}")
            key = ("in", r)
            vn = key2vn.get(key)
            if vn is None:
                vn = new_node(key, widths[r], key)
            return vn
        vn = reg_vn.get(r)
        if vn is None:
            raise _Bail(f"read of undefined scratch r={r}")
        return vn

    for op, dst, a, b in rows:
        if op == mk.OP_ZERO:
            reg_vn[dst] = _ZERO_VN
        elif op == mk.OP_COPY:
            reg_vn[dst] = read(a)
        elif op == mk.OP_EXPAND:
            key = ("expand", a)
            vn = key2vn.get(key)
            if vn is None:
                vn = new_node(key, widths[a], key)
            else:
                stats.cse_hits += 1
            reg_vn[dst] = vn
        elif op == mk.OP_THRESH:
            vd = reg_vn.get(dst)
            if vd is None and dst < n_gathered:
                raise _Bail("thresh into gathered register")
            if vd is None:
                raise _Bail("thresh over undefined accumulator")
            va, vb = read(a), read(b)
            if va == _ZERO_VN or vb == _ZERO_VN:
                reg_vn[dst] = vd        # dst | (x & 0) == dst
                continue
            if vd == _ZERO_VN:
                # 0 | (a & b) == a & b: key it as an AND so it CSEs with
                # real intersections.
                reg_vn[dst] = _bin(mk.OP_AND, va, vb, nodes, spans,
                                   key2vn, stats)
                continue
            lo, hi = (va, vb) if va <= vb else (vb, va)
            key = ("thresh", vd, lo, hi)
            vn = key2vn.get(key)
            if vn is None:
                vn = new_node(("thresh", vd, lo, hi),
                              max(spans[vd], min(spans[va], spans[vb])),
                              key)
            else:
                stats.cse_hits += 1
            reg_vn[dst] = vn
        else:
            va, vb = read(a), read(b)
            reg_vn[dst] = _bin(op, va, vb, nodes, spans, key2vn, stats)

    return nodes, spans, reg_vn


def _bin(op: int, va: int, vb: int, nodes: List[tuple],
         spans: List[int], key2vn: Dict[tuple, int],
         stats: OptStats) -> int:
    """Algebraic simplification and hash-consing for the two-operand
    bitwise opcodes."""
    if op == mk.OP_AND:
        if va == _ZERO_VN or vb == _ZERO_VN:
            return _ZERO_VN
        if va == vb:
            return va
    elif op == mk.OP_OR:
        if va == _ZERO_VN:
            return vb
        if vb == _ZERO_VN or va == vb:
            return va
    elif op == mk.OP_XOR:
        if va == vb:
            return _ZERO_VN
        if va == _ZERO_VN:
            return vb
        if vb == _ZERO_VN:
            return va
    elif op == mk.OP_ANDNOT:
        if va == _ZERO_VN or va == vb:
            return _ZERO_VN
        if vb == _ZERO_VN:
            return va
    else:
        raise _Bail(f"unmodeled opcode {op}")
    if op in _COMMUTATIVE and vb < va:
        va, vb = vb, va
    key = ("bin", op, va, vb)
    vn = key2vn.get(key)
    if vn is not None:
        stats.cse_hits += 1
        return vn
    if op == mk.OP_AND:
        span = min(spans[va], spans[vb])
    elif op == mk.OP_ANDNOT:
        span = spans[va]
    else:
        span = max(spans[va], spans[vb])
    vn = len(nodes)
    nodes.append(key)
    spans.append(int(span))
    key2vn[key] = vn
    return vn


# ------------------------------------------- DCE + linear-scan emission


def _operands(node: tuple) -> Tuple[int, ...]:
    if node[0] == "bin":
        return (node[2], node[3])
    if node[0] == "thresh":
        return (node[1], node[2], node[3])
    return ()


def _emit(nodes: List[tuple], out_vns: List[int], n_gathered: int
          ) -> Tuple[List[List[int]], Dict[int, int], int]:
    """Re-emit the live value-number graph as an instruction list with
    linear-scan scratch allocation (lowest free register first, freed at
    last read). Returns (rows, vn->register, scratch high water)."""
    live = set(out_vns)
    worklist = list(live)
    while worklist:
        for o in _operands(nodes[worklist.pop()]):
            if o not in live:
                live.add(o)
                worklist.append(o)

    last_use: Dict[int, int] = {vn: len(nodes) + 1 for vn in out_vns}
    for vn in sorted(live):
        for o in _operands(nodes[vn]):
            last_use[o] = max(last_use.get(o, -1), vn)

    rows: List[List[int]] = []
    loc: Dict[int, int] = {}
    free: List[int] = []
    high = n_gathered

    def alloc() -> int:
        nonlocal high
        if free:
            free.sort()
            return free.pop(0)
        high += 1
        return high - 1

    def release(vn: int, at: int) -> None:
        r = loc[vn]
        if r >= n_gathered and last_use.get(vn, -1) <= at \
                and r not in free:
            free.append(r)

    for vn in sorted(live):
        node = nodes[vn]
        kind = node[0]
        if kind == "in":
            loc[vn] = node[1]
            continue
        if kind == "zero":
            r = alloc()
            rows.append([mk.OP_ZERO, r, r, r])
            loc[vn] = r
            continue
        if kind == "expand":
            r = alloc()
            rows.append([mk.OP_EXPAND, r, node[1], node[1]])
            loc[vn] = r
            continue
        if kind == "thresh":
            vd, va, vb = node[1], node[2], node[3]
            rd, ra, rb = loc[vd], loc[va], loc[vb]
            # Accumulate in place when this step is the accumulator's
            # last reader; otherwise the accumulator is still live and
            # the new version needs its own register seeded by a COPY.
            in_place = (rd >= n_gathered and last_use.get(vd, -1) <= vn)
            if in_place:
                release(va, vn)
                release(vb, vn)
                r = rd
            else:
                # Allocate BEFORE releasing: the seeding COPY writes r
                # ahead of the THRESH read, so r must not alias a
                # still-needed operand register.
                r = alloc()
                rows.append([mk.OP_COPY, r, rd, rd])
                release(vd, vn)
                release(va, vn)
                release(vb, vn)
            rows.append([mk.OP_THRESH, r, ra, rb])
            loc[vn] = r
            continue
        # ("bin", op, va, vb)
        op, va, vb = node[1], node[2], node[3]
        ra, rb = loc[va], loc[vb]
        release(va, vn)
        release(vb, vn)
        r = alloc()
        rows.append([op, r, ra, rb])
        loc[vn] = r
    return rows, loc, high


# ---------------------------------------------------------- entry point


def optimize_plan(plan: mk.Plan, n_shards: int,
                  w_mega: int) -> Tuple[mk.Plan, OptStats]:
    """Run the pass pipeline over one finished plan. Returns the
    optimized plan (or the original, untouched, when the rewrite cannot
    help or the plan has an unmodeled shape) plus the before/after
    accounting."""
    stats = OptStats()
    n_slots = int(plan.n_slots)
    n_gathered = n_slots + int(plan.n_xslots)
    n_instrs = int(plan.n_instrs)
    stats.entries_before = n_instrs
    stats.entries_after = n_instrs
    stats.regs_before = int(plan.n_regs)
    stats.regs_after = int(plan.n_regs)
    stats.slab_bytes_before = mk.slab_nbytes(plan.n_regs, n_shards, w_mega)
    stats.slab_bytes_after = stats.slab_bytes_before
    stats.plan_bytes_before = plan.plan_nbytes
    stats.plan_bytes_after = stats.plan_bytes_before

    widths = [int(w) for w in plan.widths.tolist()]
    rows = [[int(x) for x in r] for r in plan.instrs[:n_instrs].tolist()]
    nc = len(plan.lane_count_widths)
    nr = len(plan.lane_row_widths)
    try:
        dens = _register_densities(plan, rows)
        _reorder_folds(rows, dens, stats)
        # Priced even when a later pass bails, so the calibration loop
        # always has the heuristic's number.
        stats.predicted_bytes = predict_cost_bytes(rows, dens, n_shards,
                                                   w_mega)
        nodes, spans, reg_vn = _value_number(rows, n_slots, n_gathered,
                                             widths, stats)

        out_vns: List[int] = []
        for r in plan.out_count[:nc].tolist() + plan.out_row[:nr].tolist():
            out_vns.append(_lane_vn(int(r), reg_vn, n_slots, n_gathered))

        # Lanes reading a gathered slot directly need its input vn to
        # exist even when no instruction read it.
        in_vns: Dict[int, int] = {}
        for i, node in enumerate(nodes):
            if node[0] == "in":
                in_vns[node[1]] = i
        for j, vn in enumerate(out_vns):
            if vn < 0:
                r = -vn - 1
                got = in_vns.get(r)
                if got is None:
                    got = len(nodes)
                    nodes.append(("in", r))
                    spans.append(widths[r])
                    in_vns[r] = got
                out_vns[j] = got

        new_rows, loc, high = _emit(nodes, out_vns, n_gathered)
    except _Bail:
        return plan, stats

    if len(new_rows) > n_instrs:
        # The THRESH copy-seeding can in principle outgrow the input; a
        # rewrite that got bigger is not an optimization.
        return plan, stats

    t_pad = mk.pow2_at_least(high + 1)
    spare = t_pad - 1
    p_pad = mk.pow2_at_least(len(new_rows))
    instrs = list(new_rows) + [[mk.OP_ZERO, spare, spare, spare]] \
        * (p_pad - len(new_rows))

    out_count = [loc[vn] for vn in out_vns[:nc]]
    out_row = [loc[vn] for vn in out_vns[nc:]]
    out_count += [spare] * (mk.pow2_at_least(nc) - nc)
    out_row += [spare] * (mk.pow2_at_least(nr) - nr)

    def narrow(lane_widths: Tuple[int, ...], vns: List[int]) -> List[int]:
        out = []
        for w, vn in zip(lane_widths, vns):
            nw = min(int(w), max(1, int(spans[vn])))
            if nw < int(w):
                stats.narrowed_lanes += 1
            out.append(nw)
        return out

    new_plan = mk.Plan(
        banks=plan.banks,
        slots=plan.slots,
        widths=np.asarray(widths[:n_gathered] + [0] * (t_pad - n_gathered),
                          np.int32),
        instrs=np.asarray(instrs, np.int32).reshape(p_pad, 4),
        out_count=np.asarray(out_count, np.int32),
        out_row=np.asarray(out_row, np.int32),
        n_slots=n_slots, n_regs=t_pad, n_instrs=len(new_rows),
        lane_count_widths=tuple(narrow(plan.lane_count_widths,
                                       out_vns[:nc])),
        lane_row_widths=tuple(narrow(plan.lane_row_widths, out_vns[nc:])),
        xbanks=plan.xbanks, xslots=plan.xslots,
        n_xslots=int(plan.n_xslots))
    stats.entries_after = len(new_rows)
    stats.regs_after = t_pad
    stats.slab_bytes_after = mk.slab_nbytes(t_pad, n_shards, w_mega)
    stats.plan_bytes_after = new_plan.plan_nbytes
    # The rewritten plan is the one that launches: price it (slot
    # registers keep their numbers, so the density map still applies).
    stats.predicted_bytes = predict_cost_bytes(new_rows, dens, n_shards,
                                               w_mega)
    new_plan.opt_stats = stats
    return new_plan, stats


def _lane_vn(r: int, reg_vn: Dict[int, int], n_slots: int,
             n_gathered: int) -> int:
    """Output lane register -> value number; gathered-slot lanes that no
    instruction read are flagged negative for the caller to materialize
    an input vn."""
    if r < n_gathered:
        if r >= n_slots:
            raise _Bail(f"output lane reads expand register {r}")
        return -r - 1
    vn = reg_vn.get(r)
    if vn is None:
        raise _Bail(f"output lane reads undefined register {r}")
    return vn
