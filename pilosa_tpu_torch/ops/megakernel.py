"""Heterogeneous staged-query megakernel: N different staged query trees
in ONE device launch.

A mixed burst of Count/Row queries pays one launch (and one Python tree
walk of torch elementwise ops) per query on the eager path. Here the
query plan is data instead: every staged eval lowers to a few register
instructions, and one hand-written CUDA interpreter (``mega_interpret``,
``csrc/mega_interpret.cu``) runs the concatenated instruction streams of
the whole batch in a single launch.

Execution model
---------------
* A *register* is one ``[S, W]`` word slab (S shards, W words, int32
  words holding the bits).
* Registers ``0..n_slots-1`` are gathered operand rows: per distinct
  bank, ``bank[slots]`` fitted to the launch width and masked down to
  each owning entry's plan width (bit-identical to the eager path's
  per-leaf alignment; zero-extension commutes with every opcode, so pad
  words stay zero end to end).
* Registers ``n_slots..n_slots+n_xslots-1`` are *expand* registers
  (hybrid layout): rows of device-resident sparse banks
  (``core/view.SparseBank``, encoded set positions instead of dense
  words), expanded to dense ``[S, W]`` rows by ``expand_positions``
  before the plan runs and readable ONLY through the ``OP_EXPAND``
  opcode (``verify_plan``'s expand typing).
* Registers above the gathered and expanded operands are scratch,
  allocated by the lowering, zero-filled before the interpreter runs.
* On the card the kernel holds the registers of one column tile at a
  time in shared memory and reads the slot rows straight from the banks:
  no ``[T, S, W]`` slab is allocated. The slab stays only in the plain
  version (``kernels.mega_interpret_ref``), which the CPU runs.
* The plan buffer is an int32 ``[P, 4]`` array of ``(opcode, dst, a,
  b)`` rows, executed in order.
* Outputs: one popcount per count lane (fused into the kernel) and
  ``slab[out_row]`` for row lanes; each entry takes its lane and its
  plan width.

BSI comparison predicates lower too: the ``executor/bsi.py`` scans are
AND/OR/ANDNOT folds whose per-bit branches depend only on the host-known
predicate value, so ``v > 300`` becomes about 2·depth plan rows.

The host half (``Lowering``, ``Plan``, ``verify_plan``, the mesh
epilogue) is this package's own copy of the JAX package's
``ops/megakernel.py``. On the card ``OP_EXPAND`` is the identity
after the width mask, as in the JAX interpreter: the expansion happened
before the plan, and the opcode is the typed boundary.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# A token-space register name while the Lowering accumulates: slot
# tokens are ("s", bank, k) until finish() resolves bank-grouped
# numbering, scratch tokens are plain ints counted from 0.
Token = Union[Tuple[str, int, int], int]

# Opcodes (plan-buffer rows are (opcode, dst, a, b); ZERO/COPY ignore b).
OP_AND = 0
OP_OR = 1
OP_XOR = 2
OP_ANDNOT = 3   # dst = a & ~b  (Difference, Not-via-existence)
OP_ZERO = 4     # dst = 0
OP_COPY = 5     # dst = a
# Sparse-expand: dst = the dense [S, W] expansion of expand register `a`
# (slab index in [n_slots, n_slots + n_xslots)). Only OP_EXPAND may read
# an expand register: the expansion and its width mask are what make it
# bit-identical to the dense bank row it replaces.
OP_EXPAND = 6
# Threshold accumulate: dst = dst | (a & b), the thermometer step of the
# N-of-M counter. THRESH is the one opcode that READS its dst.
OP_THRESH = 7

OP_NAMES = ("and", "or", "xor", "andnot", "zero", "copy", "expand",
            "thresh")

_FOLD_OPS = {"and": OP_AND, "or": OP_OR, "xor": OP_XOR, "diff": OP_ANDNOT}


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= max(n, 1): the capacity buckets every
    plan axis is padded to."""
    return 1 << max(0, int(n) - 1).bit_length()


class Lowering:
    """Accumulates one launch's plan across N staged evals.

    Slot registers are discovered in IR order but must land bank-grouped
    in the slab (the gather concatenates per bank), so instructions are
    emitted in a token space and remapped by ``finish()`` once every
    bank's slot list is complete. A Lowering lives for one flush.
    """

    def __init__(self) -> None:
        self.bank_order: List[Any] = []      # bank tensors, launch order
        self.bank_slots: List[List[int]] = []
        self.bank_widths: List[List[int]] = []
        self._bank_pos: Dict[int, int] = {}
        # (bank, slot, width) -> token: entries reading the SAME operand
        # row share one slab register (slot registers are read-only).
        self._slot_pos: Dict[Tuple[int, int, int], Tuple[str, int, int]] = {}
        # Sparse operands: per sparse bank a (pos, starts) device pair and
        # its ordered slot list; expand registers are numbered after the
        # dense slots in finish().
        self.xbank_order: List[Any] = []     # (pos, starts) pairs
        self.xbank_slots: List[List[int]] = []
        self.xbank_widths: List[List[int]] = []
        self._xbank_pos: Dict[int, int] = {}
        # (xbank, slot, width) -> the scratch token holding its OP_EXPAND
        # result: entries sharing a sparse row share one expansion.
        self._xslot_expanded: Dict[Tuple[int, int, int], int] = {}
        self.instrs: List[Tuple[int, Token, Token, Token]] = []
        self.n_scratch = 0
        self.out_count: List[Token] = []  # token per count-mode entry
        self.out_row: List[Token] = []    # token per row-mode entry
        # Per-output-lane plan widths (real lanes only, lane order): the
        # verifier's targets for the masking invariant.
        self.out_count_widths: List[int] = []
        self.out_row_widths: List[int] = []

    # ------------------------------------------------------------ building

    def _bank(self, array: Any) -> int:
        pos = self._bank_pos.get(id(array))
        if pos is None:
            pos = len(self.bank_order)
            self._bank_pos[id(array)] = pos
            self.bank_order.append(array)
            self.bank_slots.append([])
            self.bank_widths.append([])
        return pos

    def _slot(self, array: Any, slot: int, width: int) -> Tuple[str, int, int]:
        b = self._bank(array)
        key = (b, int(slot), int(width))
        token = self._slot_pos.get(key)
        if token is None:
            self.bank_slots[b].append(int(slot))
            self.bank_widths[b].append(int(width))
            token = ("s", b, len(self.bank_slots[b]) - 1)
            self._slot_pos[key] = token
        return token

    def _xbank(self, pair: Any) -> int:
        pos = self._xbank_pos.get(id(pair))
        if pos is None:
            pos = len(self.xbank_order)
            self._xbank_pos[id(pair)] = pos
            self.xbank_order.append(pair)
            self.xbank_slots.append([])
            self.xbank_widths.append([])
        return pos

    def _xslot(self, pair: Any, slot: int, width: int) -> int:
        """Sparse operand row: the scratch token holding its OP_EXPAND
        result (one expand register and one expansion per distinct
        (bank, slot, width), however many entries share it)."""
        b = self._xbank(pair)
        key = (b, int(slot), int(width))
        token = self._xslot_expanded.get(key)
        if token is None:
            self.xbank_slots[b].append(int(slot))
            self.xbank_widths[b].append(int(width))
            xtok = ("x", b, len(self.xbank_slots[b]) - 1)
            token = self._scratch()
            self._emit(OP_EXPAND, token, xtok, xtok)
            self._xslot_expanded[key] = token
        return token

    def _scratch(self) -> int:
        self.n_scratch += 1
        return self.n_scratch - 1

    def _emit(self, op: int, dst: Any, a: Any, b: Any) -> None:
        self.instrs.append((op, dst, a, b))

    def add_entry(self, ir: Sequence[tuple], bank_arrays: Sequence[Any],
                  idxs: Sequence[int], params: Sequence[int],
                  width: int, mode: str) -> int:
        """Lower one staged eval's postfix IR; returns the entry's lane
        in its mode's output array."""
        stack: List[Any] = []
        for node in ir:
            kind = node[0]
            if kind == "slot":
                _, pos, i = node
                stack.append(self._slot(bank_arrays[pos], idxs[i], width))
            elif kind == "xslot":
                # Sparse leaf: bank_arrays[pos] is the SparseBank's (pos,
                # starts) pair; the operand is its OP_EXPAND scratch.
                _, pos, i = node
                stack.append(self._xslot(bank_arrays[pos], idxs[i], width))
            elif kind == "zero":
                r = self._scratch()
                self._emit(OP_ZERO, r, r, r)
                stack.append(r)
            elif kind == "fold":
                _, opname, n = node
                ops = stack[-n:]
                del stack[-n:]
                acc = ops[0]
                if n > 1:
                    # Left fold into a scratch register: slot registers
                    # may be shared across entries, so they are read-only.
                    r = self._scratch()
                    self._emit(_FOLD_OPS[opname], r, acc, ops[1])
                    for operand in ops[2:]:
                        self._emit(_FOLD_OPS[opname], r, r, operand)
                    acc = r
                stack.append(acc)
            elif kind == "thresh":
                _, kval, n = node
                ops = stack[-n:]
                del stack[-n:]
                stack.append(self._lower_thresh(int(kval), ops))
            elif kind == "bsi":
                _, bkind, pos, i0, depth, j, k, allow_eq = node
                planes = [self._slot(bank_arrays[pos], idxs[i0 + d], width)
                          for d in range(depth + 1)]
                stack.append(self._lower_bsi(
                    bkind, planes, depth, params, j, k, allow_eq))
            else:  # the planner and the lowering move together
                raise ValueError(f"unknown megakernel IR node {node!r}")
        if len(stack) != 1:
            raise ValueError(f"unbalanced megakernel IR ({len(stack)})")
        root = stack[0]
        if mode == "count":
            self.out_count.append(root)
            self.out_count_widths.append(int(width))
            return len(self.out_count) - 1
        self.out_row.append(root)
        self.out_row_widths.append(int(width))
        return len(self.out_row) - 1

    def _lower_thresh(self, k: int, ops: List[Any]) -> Any:
        """Thermometer N-of-M counter: after folding every operand,
        ``t_j`` holds the columns where at least ``j`` operands are set;
        the answer is ``t_k``. k > n (more votes than operands) is the
        empty row. Descending ``j`` order is load-bearing: each step must
        read the PREVIOUS operand's t_{j-1}."""
        n = len(ops)
        if k < 1:
            raise ValueError(f"thresh k={k} must be >= 1")
        if k > n:
            r = self._scratch()
            self._emit(OP_ZERO, r, r, r)
            return r
        regs = []
        for _ in range(k):
            r = self._scratch()
            self._emit(OP_ZERO, r, r, r)
            regs.append(r)
        for x in ops:
            for j in range(k - 1, 0, -1):
                self._emit(OP_THRESH, regs[j], regs[j - 1], x)
            self._emit(OP_OR, regs[0], regs[0], x)
        return regs[k - 1]

    # ------------------------------------------------------ BSI expansion

    @staticmethod
    def _value(params: Sequence[int], j: int) -> int:
        """Reassemble the two u32 limbs the executor's params carry."""
        return int(params[j]) | (int(params[j + 1]) << 32)

    def _lower_bsi(self, kind: str, planes: List[Any], depth: int,
                   params: Sequence[int], j: int, k: int,
                   allow_eq: bool) -> Any:
        """Expand one comparison into the exact bit-plane scan of
        ``executor/bsi.py``, each per-bit branch taken on the host
        value."""
        nn = planes[depth]  # not-null plane
        if kind == "notnull":
            return nn
        if kind == "eq" or kind == "neq":
            value = self._value(params, j)
            m = self._scratch()
            self._emit(OP_COPY, m, nn, nn)
            for i in range(depth):
                op = OP_AND if (value >> i) & 1 else OP_ANDNOT
                self._emit(op, m, m, planes[i])
            if kind == "eq":
                return m
            r = self._scratch()
            self._emit(OP_ANDNOT, r, nn, m)
            return r
        if kind == "between":
            lo = self._lower_scan(planes, depth, self._value(params, j),
                                  "gt", True)
            hi = self._lower_scan(planes, depth, self._value(params, k),
                                  "lt", True)
            self._emit(OP_AND, lo, lo, hi)
            return lo
        return self._lower_scan(planes, depth, self._value(params, j),
                                kind, allow_eq)

    def _lower_scan(self, planes: List[Any], depth: int, value: int,
                    kind: str, allow_eq: bool) -> Any:
        """The MSB-first lt/gt scan: `matched` accumulates, `eq_prefix`
        narrows, strictly in source order."""
        matched = self._scratch()
        self._emit(OP_ZERO, matched, matched, matched)
        eqp = self._scratch()
        self._emit(OP_COPY, eqp, planes[depth], planes[depth])
        tmp = self._scratch()
        for i in reversed(range(depth)):
            vb = (value >> i) & 1
            grows = vb if kind == "lt" else (1 - vb)
            if grows:
                # lt: values with 0 under a predicate 1-bit are smaller;
                # gt: values with 1 under a predicate 0-bit are larger.
                op = OP_ANDNOT if kind == "lt" else OP_AND
                self._emit(op, tmp, eqp, planes[i])
                self._emit(OP_OR, matched, matched, tmp)
            self._emit(OP_AND if vb else OP_ANDNOT, eqp, eqp, planes[i])
        if allow_eq:
            self._emit(OP_OR, matched, matched, eqp)
        return matched

    # ------------------------------------------------------------ finish

    def finish(self) -> "Plan":
        """Resolve tokens to bank-grouped register numbers and pad every
        axis to its pow2 capacity bucket. Slab layout: dense slot
        registers, then expand registers (sparse operands), then scratch,
        then the pow2 pad with its spare register on top."""
        offsets: List[int] = []
        total = 0
        for slots in self.bank_slots:
            offsets.append(total)
            total += len(slots)
        n_slots = total
        xoffsets: List[int] = []
        xtotal = 0
        for slots in self.xbank_slots:
            xoffsets.append(xtotal)
            xtotal += len(slots)
        n_xslots = xtotal

        def reg(token: Any) -> int:
            if isinstance(token, tuple):
                kind, b, kth = token
                if kind == "x":
                    return n_slots + xoffsets[b] + kth
                return offsets[b] + kth
            return n_slots + n_xslots + int(token)

        n_regs = n_slots + n_xslots + self.n_scratch
        # +1 spare register: pad instructions and pad output lanes need a
        # dead destination that no real lane reads.
        t_pad = pow2_at_least(n_regs + 1)
        spare = t_pad - 1
        instrs = [(op, reg(d), reg(a), reg(b))
                  for op, d, a, b in self.instrs]
        p_pad = pow2_at_least(len(instrs))
        n_instrs = len(instrs)
        instrs += [(OP_ZERO, spare, spare, spare)] * (p_pad - n_instrs)
        widths = [w for ws in self.bank_widths for w in ws]
        widths += [w for ws in self.xbank_widths for w in ws]
        out_count = [reg(t) for t in self.out_count]
        out_row = [reg(t) for t in self.out_row]
        nc, nr = len(out_count), len(out_row)
        out_count += [spare] * (pow2_at_least(nc) - nc)
        out_row += [spare] * (pow2_at_least(nr) - nr)
        return Plan(
            banks=tuple(self.bank_order),
            slots=tuple(np.asarray(s, np.int32) for s in self.bank_slots),
            widths=np.asarray(
                widths + [0] * (t_pad - n_slots - n_xslots), np.int32),
            instrs=np.asarray(instrs, np.int32).reshape(p_pad, 4),
            out_count=np.asarray(out_count, np.int32),
            out_row=np.asarray(out_row, np.int32),
            n_slots=n_slots, n_regs=t_pad, n_instrs=n_instrs,
            lane_count_widths=tuple(self.out_count_widths),
            lane_row_widths=tuple(self.out_row_widths),
            xbanks=tuple(self.xbank_order),
            xslots=tuple(np.asarray(s, np.int32) for s in self.xbank_slots),
            n_xslots=n_xslots)


class Plan:
    """One launch's finished plan buffers (host numpy; ``run_program``
    uploads them)."""

    __slots__ = ("banks", "slots", "widths", "instrs", "out_count",
                 "out_row", "n_slots", "n_regs", "n_instrs",
                 "lane_count_widths", "lane_row_widths",
                 "xbanks", "xslots", "n_xslots", "opt_stats")

    def __init__(self, banks: Tuple[Any, ...],
                 slots: Tuple[np.ndarray, ...], widths: np.ndarray,
                 instrs: np.ndarray, out_count: np.ndarray,
                 out_row: np.ndarray, n_slots: int, n_regs: int,
                 n_instrs: int,
                 lane_count_widths: Tuple[int, ...] = (),
                 lane_row_widths: Tuple[int, ...] = (),
                 xbanks: Tuple[Any, ...] = (),
                 xslots: Tuple[np.ndarray, ...] = (),
                 n_xslots: int = 0) -> None:
        self.banks = banks
        self.slots = slots
        self.widths = widths
        self.instrs = instrs
        self.out_count = out_count
        self.out_row = out_row
        self.n_slots = n_slots
        self.n_regs = n_regs
        self.n_instrs = n_instrs
        # Real (unpadded) output-lane plan widths, lane order; their
        # lengths are the real lane counts.
        self.lane_count_widths = lane_count_widths
        self.lane_row_widths = lane_row_widths
        # Sparse operands: per sparse bank a (pos, starts) device pair and
        # its slot list; the expand registers are [n_slots, n_slots +
        # n_xslots), readable only through OP_EXPAND.
        self.xbanks = xbanks
        self.xslots = xslots
        self.n_xslots = n_xslots
        # Set by ops/plan_opt.optimize_plan on the plan it rewrote (None
        # otherwise): the before/after accounting the executor reports.
        self.opt_stats = None

    @property
    def plan_nbytes(self) -> int:
        """Bytes of plan data uploaded per launch."""
        return int(self.instrs.nbytes + self.widths.nbytes
                   + self.out_count.nbytes + self.out_row.nbytes
                   + sum(int(s.nbytes) for s in self.slots)
                   + sum(int(s.nbytes) for s in self.xslots))

    def sig(self, n_shards: int, w_mega: int) -> str:
        """Shape key of the launch: capacities, operand bank shapes and
        per-bank slot-list lengths (instruction content is data). The
        executor verifies the first launch of every key."""
        bshapes = [(tuple(getattr(a, "shape", ())), len(s))
                   for a, s in zip(self.banks, self.slots)]
        xshapes = [(tuple(tuple(getattr(p, "shape", ())) for p in pair),
                    len(s))
                   for pair, s in zip(self.xbanks, self.xslots)]
        return (f"mega|S{n_shards}|W{w_mega}|T{self.n_regs}"
                f"|P{self.instrs.shape[0]}|C{len(self.out_count)}"
                f"|R{len(self.out_row)}|B{bshapes}|X{xshapes}")


def slab_nbytes(n_regs: int, n_shards: int, w_mega: int) -> int:
    """Bytes of the launch's T x S x W working set: the registers the
    kernel holds a column tile at a time in shared memory. The card never
    allocates it (only the plain version builds a slab of this size)."""
    return int(n_regs) * int(n_shards) * int(w_mega) * 4


# ------------------------------------------------------- mesh epilogue
#
# A mesh launch runs the same [P, 4] plan buffer on every part of the
# shard axis (banks sharded by MeshContext.put_bank, the plan copied to
# each part's device), so the instruction loop needs no change: each
# part's registers are its [S/D, W] slice. What changes is the output
# stage: count lanes are summed over the parts on the mesh's first
# device (the psum), and row lanes are concatenated along S there (the
# all-gather), so the caller reads one count per lane and whole rows.
# The epilogue is typed data, one collective opcode per real output
# lane, verified before the launch (verify_plan's mesh rules) so a
# mis-built mesh plan fails loudly instead of double-counting.

EPI_NONE = 0
# Count lane: sum the parts' counts (the psum over the shard axis).
EPI_PSUM = 1
# Row lane: concatenate the parts' [S/D, W] rows along S (the
# all-gather).
EPI_ALL_GATHER = 2

EPI_NAMES = ("none", "psum", "all_gather")


class Epilogue:
    """Typed collective plan for one mesh launch: the named mesh axes
    the epilogue reduces over, and one collective opcode per real
    output lane (count lanes and row lanes apart; pad lanes never reach
    a collective). Pure host data, verified before the launch."""

    __slots__ = ("axes", "count_ops", "row_ops")

    def __init__(self, axes: Sequence[str], count_ops: Sequence[int],
                 row_ops: Sequence[int]):
        self.axes = tuple(str(a) for a in axes)
        self.count_ops = np.asarray(list(count_ops), dtype=np.int32)
        self.row_ops = np.asarray(list(row_ops), dtype=np.int32)


class MeshSpec:
    """Host-side description of the mesh a plan is verified against:
    axis names, device counts and the collective epilogue. Not
    ``parallel.mesh.MeshContext``: ``verify_plan`` and ``plan_cost``
    stay pure host numpy with no device handle."""

    __slots__ = ("shard_axis", "replica_axis", "n_devices", "replicas",
                 "epilogue")

    def __init__(self, shard_axis: str, replica_axis: str,
                 n_devices: int, replicas: int = 1,
                 epilogue: Optional[Epilogue] = None):
        self.shard_axis = str(shard_axis)
        self.replica_axis = str(replica_axis)
        self.n_devices = int(n_devices)
        self.replicas = int(replicas)
        self.epilogue = epilogue


def mesh_epilogue(plan: Plan, shard_axis: str = "shards") -> Epilogue:
    """The canonical epilogue of a finished plan: every real count lane
    a shard-axis psum, every real row lane an all-gather (pad lanes
    excluded)."""
    nc = len(plan.lane_count_widths)
    nr = len(plan.lane_row_widths)
    return Epilogue((shard_axis,), [EPI_PSUM] * nc,
                    [EPI_ALL_GATHER] * nr)


# --------------------------------------------------------- verification
#
# The plan buffer is data handed to one interpreter, so a lowering bug
# would produce wrong bits silently: read a register nothing wrote,
# clobber a shared operand row another entry still needs, or popcount
# words past an entry's plan width. verify_plan() is the pre-launch type
# checker for that machine; on the card it also keeps every register
# index inside the slab.


class PlanVerifyError(ValueError):
    """A plan buffer failed pre-launch verification; the message names
    the instruction or lane and the invariant it broke."""


_READS_A = (OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_COPY, OP_THRESH)
_READS_B = (OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_THRESH)
# THRESH is the accumulate opcode: dst = dst | (a & b), so dst is a READ
# operand too and must be defined before the instruction runs.
_READS_DST = (OP_THRESH,)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def verify_plan(plan: Plan, n_shards: int, w_mega: int,
                mesh: Optional[MeshSpec] = None) -> None:
    """Validate one launch's plan buffers against the interpreter's
    execution model; raise :class:`PlanVerifyError` on the first
    violation, return ``None`` when every invariant holds.

    * **Structural**: ``instrs`` is int32 ``[P, 4]`` with ``P`` a pow2
      capacity >= ``n_instrs``; ``n_regs`` pow2 with room for the spare
      register above ``n_slots + n_xslots``; output-lane arrays
      pow2-padded; the per-bank slot lists sum to ``n_slots`` and the
      per-sparse-bank lists to ``n_xslots``.
    * **Gather bounds**: every slot index addresses a real row of its
      bank, 3-d banks carry exactly ``n_shards`` shards, and every sparse
      slot a real row of its ``(pos, starts)`` pair (``starts`` has rows
      + 1 offsets).
    * **Width masks**: slot and expand registers carry a plan width in
      ``[1, w_mega]``; pad registers carry 0.
    * **Opcodes** in the table; **register bounds**; no instruction
      writes a slot or expand register (gathered rows are shared across
      entries).
    * **Expand typing**: only ``OP_EXPAND`` reads an expand register, its
      ``a`` must be one, and its result enters the width lattice at that
      register's width; no output lane reads an expand register.
    * **Def-before-use**: a scratch operand an instruction reads (THRESH
      reads its dst too) was written by an earlier instruction.
    * **Pad-tail no-ops**: instructions past ``n_instrs`` are ``ZERO``
      into a non-gathered register no real output lane reads.
    * **Masking invariant**: each register is abstracted to the least
      upper bound on its nonzero word span (AND takes ``min``, OR/XOR
      ``max``, ANDNOT/COPY the left span, ZERO 0, EXPAND the expand
      register's width, THRESH ``max(dst, min(a, b))``); every real
      output lane must prove a span <= its plan width.
    * **Mesh collectives** (``mesh`` given): the shard axis splits
      evenly over the mesh's shard devices, the epilogue reduces over
      exactly the shard axis and never the replica axis (a sum over
      replicas would count every bit R times), and every real output
      lane carries its typed collective: count lanes ``psum``, row
      lanes ``all_gather``.
    """
    instrs = plan.instrs
    if instrs.ndim != 2 or instrs.shape[1] != 4:
        raise PlanVerifyError(
            f"instrs must be [P, 4], got shape {instrs.shape}")
    if instrs.dtype != np.int32:
        raise PlanVerifyError(f"instrs must be int32, got {instrs.dtype}")
    T = int(plan.n_regs)
    P = int(instrs.shape[0])
    n_slots = int(plan.n_slots)
    n_xslots = int(getattr(plan, "n_xslots", 0))
    n_gathered = n_slots + n_xslots
    n_instrs = int(plan.n_instrs)
    if not _is_pow2(T) or T <= n_gathered:
        raise PlanVerifyError(
            f"n_regs={T} must be a pow2 capacity > n_slots={n_slots} "
            f"+ n_xslots={n_xslots} (the pad/spare register lives "
            f"above the gathered/expanded operands)")
    if not _is_pow2(P) or not 0 <= n_instrs <= P:
        raise PlanVerifyError(
            f"instr capacity P={P} must be pow2 >= n_instrs={n_instrs}")
    if len(plan.banks) != len(plan.slots):
        raise PlanVerifyError(
            f"{len(plan.banks)} banks but {len(plan.slots)} slot lists")
    if sum(len(s) for s in plan.slots) != n_slots:
        raise PlanVerifyError(
            f"per-bank slot lists sum to "
            f"{sum(len(s) for s in plan.slots)} != n_slots={n_slots}")
    if len(plan.xbanks) != len(plan.xslots):
        raise PlanVerifyError(
            f"{len(plan.xbanks)} sparse banks but {len(plan.xslots)} "
            f"sparse slot lists")
    if sum(len(s) for s in plan.xslots) != n_xslots:
        raise PlanVerifyError(
            f"per-sparse-bank slot lists sum to "
            f"{sum(len(s) for s in plan.xslots)} != "
            f"n_xslots={n_xslots}")
    if plan.widths.shape != (T,):
        raise PlanVerifyError(
            f"widths must be [n_regs]={T}, got {plan.widths.shape}")
    nc = len(plan.lane_count_widths)
    nr = len(plan.lane_row_widths)
    if len(plan.out_count) != pow2_at_least(nc) or nc > len(plan.out_count):
        raise PlanVerifyError(
            f"out_count holds {len(plan.out_count)} lanes for {nc} "
            f"real count entries (pow2 pad expected)")
    if len(plan.out_row) != pow2_at_least(nr) or nr > len(plan.out_row):
        raise PlanVerifyError(
            f"out_row holds {len(plan.out_row)} lanes for {nr} "
            f"real row entries (pow2 pad expected)")

    # Gather bounds: slot indices inside each bank, shard axis aligned.
    for b, (bank, slots) in enumerate(zip(plan.banks, plan.slots)):
        shape = getattr(bank, "shape", None)
        if not isinstance(shape, tuple) or not shape:
            continue  # opaque bank (tests stub them); widths still check
        rows = int(shape[0])
        for j, s in enumerate(np.asarray(slots).tolist()):
            if not 0 <= int(s) < rows:
                raise PlanVerifyError(
                    f"bank {b} slot[{j}]={int(s)} outside its "
                    f"{rows}-row bank")
        if len(shape) == 3 and int(shape[1]) != int(n_shards):
            raise PlanVerifyError(
                f"bank {b} carries {int(shape[1])} shards, launch "
                f"expects {int(n_shards)}")

    # Sparse gather bounds: each sparse slot addresses a real row of its
    # (pos, starts) pair.
    for b, (pair, slots) in enumerate(zip(plan.xbanks, plan.xslots)):
        starts = pair[1] if isinstance(pair, (tuple, list)) \
            and len(pair) == 2 else None
        sshape = getattr(starts, "shape", None)
        if not isinstance(sshape, tuple) or not sshape:
            continue  # opaque pair (tests stub them)
        rows = int(sshape[0]) - 1
        for j, s in enumerate(np.asarray(slots).tolist()):
            if not 0 <= int(s) < rows:
                raise PlanVerifyError(
                    f"sparse bank {b} slot[{j}]={int(s)} outside its "
                    f"{rows}-row starts table")

    widths = plan.widths.tolist()
    for k in range(n_gathered):
        if not 1 <= int(widths[k]) <= int(w_mega):
            kind = "slot" if k < n_slots else "expand"
            raise PlanVerifyError(
                f"{kind} register {k} width {int(widths[k])} outside "
                f"[1, w_mega={int(w_mega)}]")
    for k in range(n_gathered, T):
        if int(widths[k]) != 0:
            raise PlanVerifyError(
                f"pad register {k} carries width {int(widths[k])} "
                f"(must be 0: its mask row is never gathered)")

    # span[r] = least upper bound on r's nonzero word span; None = never
    # written (reads of it are RAW violations).
    span: List[Optional[int]] = [int(widths[k]) for k in range(n_gathered)]
    span += [None] * (T - n_gathered)
    rows_list = instrs.tolist()
    for i in range(n_instrs):
        op, dst, a, b = (int(x) for x in rows_list[i])
        if not 0 <= op < len(OP_NAMES):
            raise PlanVerifyError(
                f"instr {i}: opcode {op} not in the table "
                f"(0..{len(OP_NAMES) - 1})")
        for nm, r in (("dst", dst), ("a", a), ("b", b)):
            if not 0 <= r < T:
                raise PlanVerifyError(
                    f"instr {i} ({OP_NAMES[op]}): {nm}={r} outside "
                    f"the {T}-register slab")
        if dst < n_gathered:
            kind = ("slot" if dst < n_slots else "expand")
            raise PlanVerifyError(
                f"instr {i} ({OP_NAMES[op]}): writes {kind} register "
                f"{dst} — gathered/expanded operand rows are shared "
                f"across entries and read-only")
        if op == OP_EXPAND:
            if not n_slots <= a < n_gathered:
                raise PlanVerifyError(
                    f"instr {i} (expand): a={a} is not an expand "
                    f"register (expected [{n_slots}, {n_gathered}))")
            span[dst] = int(widths[a])
            continue
        reads = []
        if op in _READS_A:
            reads.append(("a", a))
        if op in _READS_B:
            reads.append(("b", b))
        if op in _READS_DST:
            reads.append(("dst", dst))
        for nm, r in reads:
            if n_slots <= r < n_gathered:
                raise PlanVerifyError(
                    f"instr {i} ({OP_NAMES[op]}): reads expand "
                    f"register {r} ({nm}) directly — sparse operands "
                    f"are readable only through OP_EXPAND")
            if r >= n_gathered and span[r] is None:
                raise PlanVerifyError(
                    f"instr {i} ({OP_NAMES[op]}): reads scratch "
                    f"register {r} ({nm}) before any instruction "
                    f"defines it (RAW chain broken — the machine "
                    f"would silently read zeros)")
        za = span[a] if op in _READS_A else 0
        zb = span[b] if op in _READS_B else 0
        za = 0 if za is None else int(za)
        zb = 0 if zb is None else int(zb)
        if op == OP_ZERO:
            span[dst] = 0
        elif op in (OP_COPY, OP_ANDNOT):
            span[dst] = za
        elif op == OP_AND:
            span[dst] = min(za, zb)
        elif op == OP_THRESH:
            zd = span[dst]
            zd = 0 if zd is None else int(zd)
            span[dst] = max(zd, min(za, zb))
        else:  # OR / XOR
            span[dst] = max(za, zb)

    # Real output lanes: in-bounds, defined, and width-masked.
    out_count = plan.out_count.tolist()
    out_row = plan.out_row.tolist()
    for mode, lanes, lane_widths in (
            ("count", out_count, plan.lane_count_widths),
            ("row", out_row, plan.lane_row_widths)):
        for j, r in enumerate(lanes):
            if not 0 <= int(r) < T:
                raise PlanVerifyError(
                    f"{mode} lane {j}: register {int(r)} outside the "
                    f"{T}-register slab")
        for j, w in enumerate(lane_widths):
            r = int(lanes[j])
            if n_slots <= r < n_gathered:
                raise PlanVerifyError(
                    f"{mode} lane {j}: reads expand register {r} "
                    f"directly — sparse operands are readable only "
                    f"through OP_EXPAND")
            sv = span[r]
            if sv is None:
                raise PlanVerifyError(
                    f"{mode} lane {j}: reads register {r} that no "
                    f"instruction defines")
            z = int(sv)
            if not 1 <= int(w) <= int(w_mega):
                raise PlanVerifyError(
                    f"{mode} lane {j}: plan width {int(w)} outside "
                    f"[1, w_mega={int(w_mega)}]")
            if z > int(w):
                raise PlanVerifyError(
                    f"{mode} lane {j}: register {r} may carry "
                    f"nonzero words up to {z}, past the entry's plan "
                    f"width {int(w)} — the masking invariant "
                    f"(zero-extension commutes with every opcode) "
                    f"does not hold")

    # Pad tail: provably no-ops (ZERO into a dead non-gathered register).
    real_out = {int(out_count[j]) for j in range(nc)}
    real_out |= {int(out_row[j]) for j in range(nr)}
    for i in range(n_instrs, P):
        op, dst, a, b = (int(x) for x in rows_list[i])
        if op != OP_ZERO:
            name = OP_NAMES[op] if 0 <= op < len(OP_NAMES) else op
            raise PlanVerifyError(
                f"pad instr {i}: opcode {name} — pad-tail "
                f"instructions must be ZERO")
        for nm, r in (("dst", dst), ("a", a), ("b", b)):
            if not 0 <= r < T:
                raise PlanVerifyError(
                    f"pad instr {i}: {nm}={r} outside the "
                    f"{T}-register slab")
        if dst < n_gathered:
            raise PlanVerifyError(
                f"pad instr {i}: zeroes slot/expand register {dst} — "
                f"pads must write a dead register")
        if dst in real_out:
            raise PlanVerifyError(
                f"pad instr {i}: zeroes register {dst} that a real "
                f"output lane reads — the pad tail would corrupt a "
                f"result")

    if mesh is not None:
        _verify_mesh(mesh, n_shards, nc, nr)


def _verify_mesh(mesh: MeshSpec, n_shards: int, nc: int,
                 nr: int) -> None:
    """The mesh rules of verify_plan: shard-axis agreement, the
    replica-axis no-op proof, and per-lane collective typing."""
    D = int(mesh.n_devices)
    if D < 1:
        raise PlanVerifyError(f"mesh: n_devices={D} must be >= 1")
    if int(n_shards) % D != 0:
        raise PlanVerifyError(
            f"mesh: n_shards={int(n_shards)} does not split evenly "
            f"over {D} shard devices — shard-axis agreement requires "
            f"identical local register shapes on every chip")
    if not mesh.shard_axis or mesh.shard_axis == mesh.replica_axis:
        raise PlanVerifyError(
            f"mesh: shard axis {mesh.shard_axis!r} must be a named "
            f"axis distinct from replica axis {mesh.replica_axis!r}")
    epi = mesh.epilogue
    if epi is None:
        raise PlanVerifyError(
            "mesh: launch has no collective epilogue — a mesh plan "
            "without typed collectives would return per-device "
            "partials")
    if epi.axes != (mesh.shard_axis,):
        raise PlanVerifyError(
            f"mesh: epilogue reduces over axes {epi.axes}, expected "
            f"exactly ({mesh.shard_axis!r},)")
    if mesh.replica_axis in epi.axes:
        raise PlanVerifyError(
            f"mesh: epilogue reduces over the replica axis "
            f"{mesh.replica_axis!r} — replicated operands would be "
            f"counted {int(mesh.replicas)}x (the replica-axis no-op "
            f"proof fails)")
    if len(epi.count_ops) != nc or len(epi.row_ops) != nr:
        raise PlanVerifyError(
            f"mesh: epilogue types {len(epi.count_ops)} count / "
            f"{len(epi.row_ops)} row lanes, plan has {nc} / {nr} real "
            f"lanes")
    for j, op in enumerate(epi.count_ops.tolist()):
        if op != EPI_PSUM:
            name = EPI_NAMES[op] if 0 <= op < len(EPI_NAMES) else op
            raise PlanVerifyError(
                f"mesh: count lane {j} typed {name!r}, must be "
                f"'psum' — anything else ships per-shard partials "
                f"to the host")
    for j, op in enumerate(epi.row_ops.tolist()):
        if op != EPI_ALL_GATHER:
            name = EPI_NAMES[op] if 0 <= op < len(EPI_NAMES) else op
            raise PlanVerifyError(
                f"mesh: row lane {j} typed {name!r}, must be "
                f"'all_gather' — the coordinator reads whole rows, "
                f"not per-device slices")


# ------------------------------------------------------ cost attribution
#
# plan_cost() is the measured half of the roofline plane's calibration
# loop (utils/roofline.py): the [P, 4] plan the verifier types also
# states the launch's memory traffic, so the executor attributes bytes to
# every launch from host numpy alone, and the profiler's sampled device
# fences turn them into achieved GB/s. It is the JAX package's model,
# kept as it is: the same dict, keys and values for the same plan. It
# prices the TPU interpreter (a [T, S, W] register slab in device memory,
# one register row read and written per instruction); the port's kernel
# keeps its registers in shared memory and reads each slot row once, so
# the model counts more bytes than the card moves.


def _buf_nbytes(a: Any) -> int:
    """Byte size of a (possibly device-resident) buffer without reading
    it: ``.nbytes``/``.shape`` are host metadata on numpy arrays and
    torch tensors alike; opaque stubs fall back to 0."""
    n = getattr(a, "nbytes", None)
    if n is not None:
        return int(n)
    shape = getattr(a, "shape", None)
    if isinstance(shape, tuple) and shape:
        item = getattr(getattr(a, "dtype", None), "itemsize", 4) or 4
        return int(np.prod(shape)) * int(item)
    return 0


def plan_cost(plan: Plan, n_shards: int, w_mega: int,
              mesh: Optional[MeshSpec] = None) -> Dict[str, Any]:
    """Per-launch memory traffic model over one finished plan, split by
    kind, plus the per-opcode instruction histogram.

    The model (``row`` = one padded ``[S, W]`` register row =
    ``n_shards * w_mega * 4`` bytes; ``live(r)`` = the masked words =
    ``n_shards * widths[r] * 4``):

    * ``gatherBytes``: per dense slot, ``live(r)`` read from the bank
      plus one ``row`` written into the slab.
    * ``expandBytes``: per expand register, its sparse bank's whole
      ``(pos, starts)`` buffers read plus one ``row`` written; per
      ``OP_EXPAND`` instruction one ``row`` read and one written.
    * ``computeBytes``: per real non-EXPAND instruction one ``row`` per
      register read (the verifier's read sets; ZERO reads nothing) plus
      one ``row`` written; plus the output stage: each real count lane
      reads one ``row`` and writes ``S * 4`` bytes, each real row lane
      moves ``2 * row``.
    * ``padBytes``: the pow2 capacity waste: slab registers above the
      high-water mark (the spare included), pad OP_ZERO writes and pad
      output lanes.

    ``totalBytes`` is the sum of the four. ``slabBytes`` /
    ``liveSlabBytes`` / ``planBytes`` restate the slab and plan sizes.
    ``opcodeHist`` counts real instructions only, by ``OP_NAMES``,
    zero counts omitted. It reads only the plan's host numpy buffers and
    the banks' shapes: never a device buffer.

    With a ``mesh``: ``meshDevices`` (D), ``deviceBytes`` (the total
    split over the D parts, rounded up: the slowest part),
    ``psumBytes`` = 2(D-1)·nc·4, ``allGatherBytes`` = (D-1)·nr·row and
    ``collectiveBytes``, their sum (the JAX package's ring model of the
    collectives)."""
    S, W = int(n_shards), int(w_mega)
    row = S * W * 4
    n_slots = int(plan.n_slots)
    n_xslots = int(getattr(plan, "n_xslots", 0))
    n_gathered = n_slots + n_xslots
    n_instrs = int(plan.n_instrs)
    P = int(plan.instrs.shape[0])
    widths = [int(w) for w in plan.widths.tolist()]

    gather = sum(S * widths[r] * 4 + row for r in range(n_slots))

    hist: Dict[str, int] = {}
    compute = 0
    n_expand_instrs = 0
    used_high = n_gathered  # slab high-water mark (exclusive)
    for op, dst, a, b in plan.instrs[:n_instrs].tolist():
        op, dst, a, b = int(op), int(dst), int(a), int(b)
        name = OP_NAMES[op] if 0 <= op < len(OP_NAMES) else str(op)
        hist[name] = hist.get(name, 0) + 1
        used_high = max(used_high, dst + 1)
        if op == OP_EXPAND:
            n_expand_instrs += 1
            used_high = max(used_high, a + 1)
            continue
        reads = 0
        if op in _READS_A:
            reads += 1
            used_high = max(used_high, a + 1)
        if op in _READS_B:
            reads += 1
            used_high = max(used_high, b + 1)
        if op in _READS_DST:
            reads += 1
        compute += (reads + 1) * row

    expand = n_expand_instrs * 2 * row
    for pair, slots in zip(plan.xbanks, plan.xslots):
        pair_bytes = 0
        if isinstance(pair, (tuple, list)) and len(pair) == 2:
            pair_bytes = _buf_nbytes(pair[0]) + _buf_nbytes(pair[1])
        expand += len(slots) * (pair_bytes + row)

    nc = len(plan.lane_count_widths)
    nr = len(plan.lane_row_widths)
    for j in range(nc):
        used_high = max(used_high, int(plan.out_count[j]) + 1)
    for j in range(nr):
        used_high = max(used_high, int(plan.out_row[j]) + 1)
    compute += nc * (row + S * 4) + nr * 2 * row

    n_regs = int(plan.n_regs)
    pad = ((n_regs - used_high) * row
           + (P - n_instrs) * row
           + (len(plan.out_count) - nc) * (row + S * 4)
           + (len(plan.out_row) - nr) * 2 * row)

    total = gather + compute + expand + pad
    out = {
        "gatherBytes": int(gather),
        "computeBytes": int(compute),
        "expandBytes": int(expand),
        "padBytes": int(pad),
        "totalBytes": int(total),
        "slabBytes": slab_nbytes(n_regs, S, W),
        "liveSlabBytes": slab_nbytes(n_gathered, S, W),
        "planBytes": int(plan.plan_nbytes),
        "opcodeHist": hist,
        "nInstrs": n_instrs,
    }
    if mesh is not None:
        D = max(1, int(mesh.n_devices))
        psum = 2 * (D - 1) * nc * 4
        ag = (D - 1) * nr * row
        out["meshDevices"] = D
        out["deviceBytes"] = int(-(-total // D))
        out["psumBytes"] = int(psum)
        out["allGatherBytes"] = int(ag)
        out["collectiveBytes"] = int(psum + ag)
    return out


# ------------------------------------------------------------- program


def run_program(plan: Plan, n_shards: int, w_mega: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run one finished plan: one ``expand_positions`` launch per sparse
    bank, then one ``mega_interpret`` launch (or their plain versions for
    CPU banks) with the plan's buffers. Returns ``(counts int64[Nc], rows
    int32[Nr, S, w_mega])`` on the banks' device, pow2 pad lanes
    included. On the card the launch reads the slot rows from the banks
    itself; the ``[T, S, W]`` slab exists only in the plain version."""
    from pilosa_tpu_torch.ops import kernels
    return kernels.mega_interpret(plan.banks, plan.slots, plan.widths,
                                  plan.instrs, plan.out_count, plan.out_row,
                                  plan.n_regs, n_shards, w_mega,
                                  plan.xbanks, plan.xslots)
