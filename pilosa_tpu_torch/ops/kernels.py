"""The port's CUDA kernels: wrappers, launch counts, plain versions.

The kernels of the JAX package's ``ops/pallas_kernels.py`` that the
query paths run, as hand-written CUDA for Hopper. Three bank sweeps
(``csrc/bank_counts.cu``):

- ``bank_row_counts``: per-row popcount of an ``[R, S, W]`` bank, for
  unfiltered TopN and for Count of a materialised row;
- ``bank_row_counts_masked``: ``(|row ∧ filt|, |row|)`` in one pass, for
  filtered TopN, the tanimoto denominator, and ``Count(Intersect(a, b))``
  at R = 1;
- ``bsi_plane_counts``: masked popcount of each BSI bit plane, for Sum.

and the plan-buffer interpreter of the batch path
(``csrc/mega_interpret.cu``):

- ``mega_interpret``: the whole of one plan launch in one kernel: gathers
  the slot rows straight from their banks (fitted and width-masked),
  runs an ``[P, 4]`` (opcode, dst, a, b) plan over T registers held a
  column tile at a time in shared memory, and writes the row lanes and
  the count lanes' popcounts. No ``[T, S, W]`` slab is allocated.

and the positions-bank membership count of filtered TopN
(``csrc/pbank_membership.cu``):

- ``pbank_membership_counts``: ``|row ∧ filter|`` per row of a
  positions-bank segment (``core/view.py`` PositionsBank), fixed or
  flat layout.

Banks are width-trimmed, so W is any width >= 1 (the Pallas versions
required W = 32768). Each wrapper takes a CUDA tensor to its kernel and
a CPU tensor to the plain version beside it (``*_ref``), and nothing
else: no fallback. Counts come back as ``int64`` on the input's device
(membership counts, at most 2^16 a row, as ``int32``).
``LAUNCHES[name]`` counts kernel launches.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops.bitset import popcount

# Interpreter opcodes (ops/megakernel.py): AND, OR, XOR, ANDNOT, ZERO,
# COPY, EXPAND (the identity here), THRESH (dst | (a & b)).
N_OPCODES = 8

LAUNCHES: Dict[str, int] = {
    "bank_row_counts": 0,
    "bank_row_counts_masked": 0,
    "bsi_plane_counts": 0,
    "mega_interpret": 0,
    "pbank_membership_counts": 0,
}

# A row's count must fit the kernel's u32 accumulator: S*W*32 < 2^32.
MAX_ROW_WORDS = (1 << 32) // 32 - 1
# mega_interpret holds all T registers of a column tile in one block's
# shared memory (at most 227 KB), beside up to MEGA_SLOT_CAP slot
# descriptors, MEGA_PLAN_CAP plan rows and MEGA_LANE_CAP count-lane and
# row-lane indexes; the narrowest tile is MEGA_MIN_TILE_WORDS columns. T
# above MEGA_MAX_REGS fits no tile (1704; pow2 plans stop at 1024).
MEGA_BLOCK_SMEM = 232448
MEGA_MIN_TILE_WORDS = 32
MEGA_SLOT_CAP = 256
MEGA_PLAN_CAP = 512
MEGA_LANE_CAP = 256
MEGA_MAX_REGS = ((MEGA_BLOCK_SMEM - 16 * (MEGA_SLOT_CAP + MEGA_PLAN_CAP)
                  - 4 * 2 * MEGA_LANE_CAP) // (4 * MEGA_MIN_TILE_WORDS))
_OP_ZERO = 4
# Widest filter the membership kernel takes: the pad position 0xFFFF
# lies in word 2047, which must be past the filter.
PBANK_MAX_WORDS = 2047


_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count_launch(name: str) -> None:
    # Server threads launch concurrently; '+=' alone could lose a count.
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------- plain


def bank_row_counts_ref(bank: torch.Tensor) -> torch.Tensor:
    """[R, S, W] int32 -> int64[R] per-row popcount."""
    return popcount(bank, axis=(-2, -1))


def bank_row_counts_masked_ref(bank: torch.Tensor, filt: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([R, S, W], [S, W]) -> (|row ∧ filt|, |row|), int64[R] each."""
    return (popcount(torch.bitwise_and(bank, filt), axis=(-2, -1)),
            popcount(bank, axis=(-2, -1)))


def bsi_plane_counts_ref(planes: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """([D, S, W], [S, W]) -> int64[D] masked popcount per plane."""
    return popcount(torch.bitwise_and(planes, mask), axis=(-2, -1))


def _fit(rows: torch.Tensor, w_mega: int) -> torch.Tensor:
    """Slice or zero-pad the word axis to the launch width."""
    w = rows.shape[-1]
    if w > w_mega:
        return rows[..., :w_mega]
    if w < w_mega:
        return torch.nn.functional.pad(rows, (0, w_mega - w))
    return rows


def _gather_slab(banks: Sequence[torch.Tensor], slots: Sequence[Any],
                 widths: Any, n_regs: int, n_shards: int, w_mega: int
                 ) -> torch.Tensor:
    """The plain version's prologue: a fresh ``[n_regs, S, w_mega]`` int32
    slab holding each bank's slot rows fitted to ``w_mega`` and masked to
    their entry's plan width, then zeros (scratch and pad registers)."""
    device = banks[0].device
    slab = torch.empty((n_regs, n_shards, w_mega), dtype=torch.int32,
                       device=device)
    off = 0
    widths = torch.as_tensor(widths).tolist()
    for bank, sl in zip(banks, slots):
        idx = torch.as_tensor(sl).to(device=device, dtype=torch.int64)
        k = idx.numel()
        if bank.shape[-1] == w_mega and bank.is_contiguous():
            torch.index_select(bank, 0, idx, out=slab[off:off + k])
        else:
            slab[off:off + k] = _fit(bank.index_select(0, idx), w_mega)
        copied = min(int(bank.shape[-1]), w_mega)
        for r in range(off, off + k):
            if widths[r] < copied:
                slab[r, :, widths[r]:copied] = 0
        off += k
    slab[off:].zero_()
    return slab


def mega_interpret_ref(banks: Sequence[torch.Tensor], slots: Sequence[Any],
                       widths: Any, instrs: torch.Tensor,
                       out_count: torch.Tensor, out_row: torch.Tensor,
                       n_regs: int, n_shards: int, w_mega: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``mega_interpret``: the ``[n_regs, S, w_mega]``
    slab gathered from the banks, every plan row in order over it, then
    int64[Nc] popcounts of the count lanes and the int32 [Nr, S,
    w_mega] row lanes."""
    slab = _gather_slab(banks, slots, widths, n_regs, n_shards, w_mega)
    for op, d, a, b in torch.as_tensor(instrs).tolist():
        va, vb = slab[a], slab[b]
        if op == 0:
            res = torch.bitwise_and(va, vb)
        elif op == 1:
            res = torch.bitwise_or(va, vb)
        elif op == 2:
            res = torch.bitwise_xor(va, vb)
        elif op == 3:
            res = torch.bitwise_and(va, torch.bitwise_not(vb))
        elif op == 4:
            res = torch.zeros_like(va)
        elif op in (5, 6):
            res = va.clone()
        else:
            res = torch.bitwise_or(slab[d], torch.bitwise_and(va, vb))
        slab[d] = res
    lanes = torch.as_tensor(out_count).to(device=slab.device,
                                          dtype=torch.int64)
    row_lanes = torch.as_tensor(out_row).to(device=slab.device,
                                            dtype=torch.int64)
    return (popcount(slab.index_select(0, lanes), axis=(-2, -1)),
            slab.index_select(0, row_lanes))


def pbank_membership_counts_ref(pos: torch.Tensor, filt: torch.Tensor,
                                starts: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version of ``pbank_membership_counts``: the filter padded
    with zeros to 2048 words, each position's bit looked up, then summed
    per row (fixed) or a cumsum differenced at ``starts`` (flat)."""
    fw = torch.zeros(PBANK_MAX_WORDS + 1, dtype=torch.int32,
                     device=pos.device)
    fw[:filt.numel()] = filt
    p = pos.to(torch.int32) & 0xFFFF
    bits = (fw[p >> 5] >> (p & 31)) & 1
    if starts is None:
        return bits.sum(dim=1, dtype=torch.int32)
    cs = torch.zeros(bits.numel() + 1, dtype=torch.int64, device=pos.device)
    torch.cumsum(bits, 0, out=cs[1:])
    s = starts.to(torch.int64)
    return (cs[s[1:]] - cs[s[:-1]]).to(torch.int32)


# -------------------------------------------------------------- checks


def _check_bank(name: str, bank: torch.Tensor) -> None:
    if bank.dtype != torch.int32:
        raise TypeError(f"{name}: bank must be int32, got {bank.dtype}")
    if bank.dim() != 3:
        raise ValueError(f"{name}: bank must be [R, S, W], got "
                         f"{tuple(bank.shape)}")
    if bank.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {bank.device}")


def _check_filter(name: str, bank: torch.Tensor, filt: torch.Tensor
                  ) -> None:
    if filt.dtype != torch.int32:
        raise TypeError(f"{name}: filter must be int32, got {filt.dtype}")
    if tuple(filt.shape) != tuple(bank.shape[1:]):
        raise ValueError(f"{name}: filter shape {tuple(filt.shape)} does "
                         f"not match bank {tuple(bank.shape)}")
    if filt.device != bank.device:
        raise ValueError(f"{name}: filter on {filt.device}, bank on "
                         f"{bank.device}")


def _cuda_args(name: str, *tensors: torch.Tensor) -> int:
    """Validate CUDA operands; returns the words per row n = S*W."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    bank = tensors[0]
    n = int(bank.shape[1]) * int(bank.shape[2])
    if n > MAX_ROW_WORDS:
        raise ValueError(f"{name}: S*W = {n} words per row overflows the "
                         "kernel's 32-bit counts")
    return n


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with "
                           f"cudaError_t {err}")


def _as_counts(out: torch.Tensor) -> torch.Tensor:
    """u32 counts held in an int32 buffer -> int64."""
    return out.to(torch.int64) & 0xFFFFFFFF


# ------------------------------------------------------------ wrappers


def bank_row_counts(bank: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of an [R, S, W] int32 bank -> int64[R]."""
    name = "bank_row_counts"
    _check_bank(name, bank)
    if bank.device.type == "cpu":
        return bank_row_counts_ref(bank)
    n = _cuda_args(name, bank)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    out = torch.zeros(bank.shape[0], dtype=torch.int32, device=bank.device)
    if out.numel() and n:
        _raise_on(name, lib.bank_row_counts(
            bank.data_ptr(), out.data_ptr(), bank.shape[0], n,
            _stream(bank.device)))
        _count_launch(name)
    return _as_counts(out)


def bank_row_counts_masked(bank: torch.Tensor, filt: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([R, S, W] bank, [S, W] filter) -> (|row ∧ filt|, |row|), each
    int64[R], in one pass over the bank."""
    name = "bank_row_counts_masked"
    _check_bank(name, bank)
    _check_filter(name, bank, filt)
    if bank.device.type == "cpu":
        return bank_row_counts_masked_ref(bank, filt)
    n = _cuda_args(name, bank, filt)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    inter = torch.zeros(bank.shape[0], dtype=torch.int32, device=bank.device)
    raw = torch.zeros_like(inter)
    if inter.numel() and n:
        _raise_on(name, lib.bank_row_counts_masked(
            bank.data_ptr(), filt.data_ptr(), inter.data_ptr(),
            raw.data_ptr(), bank.shape[0], n, _stream(bank.device)))
        _count_launch(name)
    return _as_counts(inter), _as_counts(raw)


def bsi_plane_counts(planes: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """([D, S, W] bit planes, [S, W] column mask) -> int64[D] masked
    popcounts; the caller weights plane d by 2^d."""
    name = "bsi_plane_counts"
    _check_bank(name, planes)
    _check_filter(name, planes, mask)
    if planes.device.type == "cpu":
        return bsi_plane_counts_ref(planes, mask)
    n = _cuda_args(name, planes, mask)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    out = torch.zeros(planes.shape[0], dtype=torch.int32,
                      device=planes.device)
    if out.numel() and n:
        _raise_on(name, lib.bsi_plane_counts(
            planes.data_ptr(), mask.data_ptr(), out.data_ptr(),
            planes.shape[0], n, _stream(planes.device)))
        _count_launch(name)
    return _as_counts(out)


def _host_i32(name: str, what: str, x: Any) -> torch.Tensor:
    """A host int32 copy of an index array (numpy or a tensor)."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be an int32 array, got "
                        f"{type(x).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: {what} on {t.device}")
    return t.cpu().contiguous()


def _check_plan(name: str, banks: Sequence[torch.Tensor],
                slots: Sequence[Any], widths: Any, instrs: Any,
                out_count: Any, out_row: Any, n_regs: int, n_shards: int,
                w_mega: int) -> Tuple[List[torch.Tensor], torch.Tensor,
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Validate one launch; returns host int32 copies of the slot lists,
    the slot registers' widths, instrs, out_count and out_row. Banks are
    int32 [R, n_shards, W] and contiguous on one device, every slot lies
    in its bank, every slot width in [1, w_mega], every opcode in the
    table and every register and lane index below T, and T fits the
    kernel's shared-memory tile: on the card an index outside them would
    be an out-of-bounds access."""
    banks = tuple(banks)
    if not banks:
        raise ValueError(f"{name}: a plan needs at least one bank")
    if len(slots) != len(banks):
        raise ValueError(f"{name}: {len(banks)} banks but {len(slots)} "
                         "slot lists")
    device = banks[0].device
    for bank in banks:
        _check_bank(name, bank)
        if bank.device != device:
            raise ValueError(f"{name}: banks on {bank.device} and {device}")
        if not bank.is_contiguous():
            raise ValueError(f"{name}: banks must be contiguous")
        if int(bank.shape[1]) != int(n_shards):
            raise ValueError(f"{name}: bank of {int(bank.shape[1])} shards, "
                             f"launch of {int(n_shards)}")
    T = int(n_regs)
    if not 1 <= T <= MEGA_MAX_REGS:
        raise ValueError(f"{name}: T = {T} registers outside [1, "
                         f"{MEGA_MAX_REGS}], what one block's shared "
                         "memory holds at the narrowest column tile")
    if int(w_mega) < 1 or int(n_shards) < 0:
        raise ValueError(f"{name}: w_mega = {w_mega}, n_shards = "
                         f"{n_shards}")
    host_slots = []
    for b, (bank, sl) in enumerate(zip(banks, slots)):
        sl = _host_i32(name, f"slots[{b}]", sl)
        if sl.dim() != 1:
            raise ValueError(f"{name}: slots[{b}] must be 1-d")
        if sl.numel() and (int(sl.min()) < 0
                           or int(sl.max()) >= int(bank.shape[0])):
            raise ValueError(f"{name}: slots[{b}] outside its "
                             f"{int(bank.shape[0])}-row bank")
        host_slots.append(sl)
    n_slots = sum(int(sl.numel()) for sl in host_slots)
    if n_slots > T:
        raise ValueError(f"{name}: {n_slots} slot registers exceed T = {T}")
    host_widths = _host_i32(name, "widths", widths)
    if host_widths.dim() != 1 or host_widths.numel() < n_slots:
        raise ValueError(f"{name}: widths must be 1-d with at least "
                         f"{n_slots} entries")
    host_widths = host_widths[:n_slots]
    if n_slots and (int(host_widths.min()) < 1
                    or int(host_widths.max()) > int(w_mega)):
        raise ValueError(f"{name}: slot width outside [1, w_mega = "
                         f"{int(w_mega)}]")
    host_instrs = _host_i32(name, "instrs", instrs)
    if host_instrs.dim() != 2 or host_instrs.shape[1] != 4:
        raise ValueError(f"{name}: instrs must be [P, 4], got "
                         f"{tuple(host_instrs.shape)}")
    if host_instrs.numel():
        ops = host_instrs[:, 0]
        if int(ops.min()) < 0 or int(ops.max()) >= N_OPCODES:
            raise ValueError(f"{name}: opcode outside 0..{N_OPCODES - 1}")
        regs = host_instrs[:, 1:]
        if int(regs.min()) < 0 or int(regs.max()) >= T:
            raise ValueError(f"{name}: register index outside the "
                             f"{T} registers")
    lanes = []
    for what, x in (("out_count", out_count), ("out_row", out_row)):
        t = _host_i32(name, what, x)
        if t.dim() != 1:
            raise ValueError(f"{name}: {what} must be 1-d, got "
                             f"{tuple(t.shape)}")
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= T):
            raise ValueError(f"{name}: {what} lane outside the {T} "
                             "registers")
        lanes.append(t)
    return host_slots, host_widths, host_instrs, lanes[0], lanes[1]


def mega_live_rows(instrs: np.ndarray, n_slots: int) -> int:
    """How many leading plan rows the kernel must run for every output to
    match running all of them: a trailing run of ZERO rows into scratch
    registers (>= n_slots, which start at 0) that no earlier row writes
    changes nothing. The pow2 pad rows (ZERO into the spare register) are
    such a run unless a real row writes the spare."""
    P = len(instrs)
    tail = P
    while tail > 0 and instrs[tail - 1, 0] == _OP_ZERO \
            and instrs[tail - 1, 1] >= n_slots:
        tail -= 1
    if tail == P:
        return P
    live = np.flatnonzero(np.isin(instrs[tail:, 1], instrs[:tail, 1]))
    return tail + (int(live[-1]) + 1 if live.size else 0)


def mega_launch_args(banks: Sequence[torch.Tensor], slots: Sequence[Any],
                     widths: Any, instrs: Any, out_count: Any, out_row: Any,
                     n_regs: int, n_shards: int, w_mega: int
                     ) -> Tuple[tuple, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Check a launch on CUDA banks and upload its plan in one buffer.
    Returns ``(args, counts, rows, buf)``: ``args`` are the C entry's
    arguments up to ``counts`` (slot descriptors, live plan rows, lanes,
    T, S, w_mega), ``counts`` the zeroed int32 [Nc] and ``rows`` the int32
    [Nr, S, w_mega] outputs, ``buf`` the device buffer the pointers in
    ``args`` point into. Each slot descriptor is 16 bytes: the slot row's
    address, then the bank's W and min(W, plan width) as int32."""
    name = "mega_interpret"
    host_slots, host_widths, host_instrs, host_count, host_row = \
        _check_plan(name, banks, slots, widths, instrs, out_count, out_row,
                    n_regs, n_shards, w_mega)
    device = banks[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: banks on {device}, not on the card")
    if int(n_shards) * int(w_mega) > MAX_ROW_WORDS:
        raise ValueError(f"{name}: S*W = {int(n_shards) * int(w_mega)} "
                         "words per row overflows the kernel's 32-bit "
                         "counts")
    desc = []
    for bank, sl in zip(banks, host_slots):
        R, S, W = (int(x) for x in bank.shape)
        rows_at = sl.numpy().astype(np.int64)
        d = np.empty((len(rows_at), 2), np.int64)
        d[:, 0] = bank.data_ptr() + rows_at * (S * W * 4)
        d[:, 1] = W
        desc.append(d)
    desc = np.concatenate(desc) if desc else np.zeros((0, 2), np.int64)
    n_slots = len(desc)
    valid = np.minimum(desc[:, 1], host_widths.numpy().astype(np.int64))
    desc[:, 1] |= valid << 32
    plan = host_instrs.numpy()
    n_run = mega_live_rows(plan, n_slots)
    packed = np.concatenate([desc.view(np.int32).ravel(),
                             plan[:n_run].ravel(), host_count.numpy(),
                             host_row.numpy()])
    buf = torch.from_numpy(packed).to(device)
    at = buf.data_ptr()
    p_instrs = at + n_slots * 16
    p_count = p_instrs + n_run * 16
    p_row = p_count + host_count.numel() * 4
    args = (at, n_slots, p_instrs, n_run, p_count, host_count.numel(),
            p_row, host_row.numel(), int(n_regs), int(n_shards),
            int(w_mega))
    counts = torch.zeros(host_count.numel(), dtype=torch.int32,
                         device=device)
    rows = torch.empty((host_row.numel(), int(n_shards), int(w_mega)),
                       dtype=torch.int32, device=device)
    return args, counts, rows, buf


def mega_interpret(banks: Sequence[torch.Tensor], slots: Sequence[Any],
                   widths: Any, instrs: Any, out_count: Any, out_row: Any,
                   n_regs: int, n_shards: int, w_mega: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One plan launch, in the argument order of the JAX package's
    ``build_program(...).run``. Register k < n_slots is row
    ``slots[b][i]`` of ``banks[b]`` (bank-grouped, in order), its word
    axis fitted to ``w_mega`` and masked to ``widths[k]``; the other
    registers start at zero; the int32 [P, 4] plan of (opcode, dst, a, b)
    rows runs in order. Returns ``(counts, rows)``: int64[Nc] with
    ``counts[j] = |reg[out_count[j]]|`` and int32 [Nr, S, w_mega] with
    ``rows[j] = reg[out_row[j]]``, on the banks' device. The index arrays
    are int32, numpy or tensors on either device (checked on the host)."""
    name = "mega_interpret"
    if banks and banks[0].device.type == "cpu":
        return mega_interpret_ref(banks, *_check_plan(
            name, banks, slots, widths, instrs, out_count, out_row, n_regs,
            n_shards, w_mega), n_regs, n_shards, w_mega)
    args, counts, rows, buf = mega_launch_args(
        banks, slots, widths, instrs, out_count, out_row, n_regs, n_shards,
        w_mega)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    if (counts.numel() or rows.numel()) and n_shards:
        _raise_on(name, lib.mega_interpret(
            *args, counts.data_ptr(), rows.data_ptr(), None,
            _stream(banks[0].device)))
        _count_launch(name)
    del buf  # the stream orders its reuse after the launch
    return _as_counts(counts), rows


def _check_pbank(name: str, pos: torch.Tensor, filt: torch.Tensor,
                 starts: Optional[torch.Tensor]) -> int:
    """Validate a membership call; returns the row count."""
    if pos.dtype != torch.int16 or filt.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int16 and the filter "
                        f"int32, got {pos.dtype} and {filt.dtype}")
    if filt.dim() != 1 or filt.numel() > PBANK_MAX_WORDS:
        raise ValueError(f"{name}: filter must be 1-d with at most "
                         f"{PBANK_MAX_WORDS} words, got {tuple(filt.shape)}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {pos.device}")
    tensors = [pos, filt]
    if starts is None:
        if pos.dim() != 2:
            raise ValueError(f"{name}: fixed positions must be [R, L], got "
                             f"{tuple(pos.shape)}")
        rows = int(pos.shape[0])
    else:
        if pos.dim() != 1 or starts.dim() != 1 or starts.numel() < 1:
            raise ValueError(f"{name}: flat positions must be [P] with "
                             "starts [R + 1]")
        if starts.dtype != torch.int32:
            raise TypeError(f"{name}: starts must be int32, got "
                            f"{starts.dtype}")
        tensors.append(starts)
        rows = int(starts.numel()) - 1
    for t in tensors:
        if t.device != pos.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return rows


def pbank_membership_counts(pos: torch.Tensor, filt: torch.Tensor,
                            starts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``|row ∧ filt|`` per row of a positions-bank segment, as int32[R]
    on the positions' device. ``pos`` holds u16 positions as int16:
    fixed ``[R, L]`` rows padded with 0xFFFF (``starts`` None), or flat
    ``[P]`` with int32 ``starts`` [R + 1] (the segment build guarantees
    0 <= starts[r] <= starts[r + 1] <= P; they are not re-read here).
    ``filt`` is the filter's int32 words, at most 2047 of them."""
    name = "pbank_membership_counts"
    rows = _check_pbank(name, pos, filt, starts)
    if pos.device.type == "cpu":
        return pbank_membership_counts_ref(pos, filt, starts)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    out = torch.empty(rows, dtype=torch.int32, device=pos.device)
    if rows:
        L = int(pos.shape[1]) if starts is None else 0
        _raise_on(name, lib.pbank_membership_counts(
            pos.data_ptr(), starts.data_ptr() if starts is not None else None,
            filt.data_ptr(), out.data_ptr(), rows, L, filt.numel(),
            _stream(pos.device)))
        _count_launch(name)
    return out
