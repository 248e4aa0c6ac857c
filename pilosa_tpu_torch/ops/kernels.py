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

- ``mega_interpret``: runs an ``[P, 4]`` (opcode, dst, a, b) plan over a
  ``[T, S, W]`` register slab in place and popcounts the count lanes.

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

from typing import Dict, Optional, Tuple

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
# Widest filter the membership kernel takes: the pad position 0xFFFF
# lies in word 2047, which must be past the filter.
PBANK_MAX_WORDS = 2047


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def mega_interpret_ref(slab: torch.Tensor, instrs: torch.Tensor,
                       out_count: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``mega_interpret``: the plan rows in order over
    the [T, S, W] int32 slab (updated in place), then int64[Nc]
    popcounts of the count lanes."""
    for op, d, a, b in instrs.tolist():
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
    lanes = out_count.to(device=slab.device, dtype=torch.int64)
    return slab, popcount(slab.index_select(0, lanes), axis=(-2, -1))


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
        LAUNCHES[name] += 1
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
        LAUNCHES[name] += 1
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
        LAUNCHES[name] += 1
    return _as_counts(out)


def _check_plan(name: str, slab: torch.Tensor, instrs: torch.Tensor,
                out_count: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Validate the slab and the plan; returns host copies of instrs and
    out_count. Every opcode must be in the table and every register
    index below T: on the card an index outside the slab would be an
    out-of-bounds access."""
    _check_bank(name, slab)
    if not slab.is_contiguous():
        raise ValueError(f"{name}: slab must be contiguous")
    for what, t in (("instrs", instrs), ("out_count", out_count)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if t.device.type not in ("cpu", slab.device.type):
            raise ValueError(f"{name}: {what} on {t.device}, slab on "
                             f"{slab.device}")
    if instrs.dim() != 2 or instrs.shape[1] != 4:
        raise ValueError(f"{name}: instrs must be [P, 4], got "
                         f"{tuple(instrs.shape)}")
    if out_count.dim() != 1:
        raise ValueError(f"{name}: out_count must be 1-d, got "
                         f"{tuple(out_count.shape)}")
    host_instrs = instrs.cpu().contiguous()
    host_lanes = out_count.cpu().contiguous()
    T = int(slab.shape[0])
    if host_instrs.numel():
        ops = host_instrs[:, 0]
        if int(ops.min()) < 0 or int(ops.max()) >= N_OPCODES:
            raise ValueError(f"{name}: opcode outside 0..{N_OPCODES - 1}")
        regs = host_instrs[:, 1:]
        if int(regs.min()) < 0 or int(regs.max()) >= T:
            raise ValueError(f"{name}: register index outside the "
                             f"{T}-register slab")
    if host_lanes.numel() and (int(host_lanes.min()) < 0
                               or int(host_lanes.max()) >= T):
        raise ValueError(f"{name}: count lane outside the {T}-register "
                         "slab")
    return host_instrs, host_lanes


def mega_interpret(slab: torch.Tensor, instrs: torch.Tensor,
                   out_count: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run an int32 [P, 4] plan of (opcode, dst, a, b) rows over an int32
    [T, S, W] register slab, rows in order, updating the slab in place;
    returns ``(slab, counts)`` with ``counts[j] = |slab[out_count[j]]|``
    as int64[Nc] on the slab's device. ``instrs`` and ``out_count`` may
    lie on the CPU (they are checked there and uploaded)."""
    name = "mega_interpret"
    host_instrs, host_lanes = _check_plan(name, slab, instrs, out_count)
    if slab.device.type == "cpu":
        return mega_interpret_ref(slab, host_instrs, host_lanes)
    n = _cuda_args(name, slab)
    from pilosa_tpu_torch.ops import build
    lib = build.load()
    dev_instrs = host_instrs.to(slab.device)
    dev_lanes = host_lanes.to(slab.device)
    counts = torch.zeros(host_lanes.numel(), dtype=torch.int32,
                         device=slab.device)
    if slab.numel():
        _raise_on(name, lib.mega_interpret(
            slab.data_ptr(), dev_instrs.data_ptr(), dev_lanes.data_ptr(),
            counts.data_ptr(), slab.shape[0], n, host_instrs.shape[0],
            host_lanes.numel(), _stream(slab.device)))
        LAUNCHES[name] += 1
    return slab, _as_counts(counts)


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
        LAUNCHES[name] += 1
    return out
