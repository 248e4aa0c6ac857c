"""Dense packed-bitset algebra on torch tensors.

A shard row is one row of one fragment restricted to a 2^20-column shard,
stored as 32768 words of 32 bits. Bit p (0 <= p < 2^20) lives in word
p >> 5, bit p & 31 — the layout of the JAX package's ``ops/bitset.py``,
so a host ``uint32`` word array and a device tensor hold the same bits.

Words are ``torch.int32``: a bit-identical view of ``uint32`` (torch's
``uint32`` lacks ``~``, ``>>`` and ``<<``). ``>>`` on ``int32`` is
arithmetic, so every right shift here is followed by a mask. Counts are
returned as ``int64``.

All functions take tensors whose last axis is words; leading axes (rows,
shards) batch. On a CUDA tensor, whole-row counts belong to the kernels
of ``ops/kernels.py``; ``popcount`` here is the plain version they are
held against.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

SHARD_WIDTH_EXP = 20
SHARD_WIDTH = 1 << SHARD_WIDTH_EXP  # 1,048,576 columns per shard
WORD_BITS = 32
WORDS_PER_SHARD = SHARD_WIDTH // WORD_BITS  # 32,768 words (128 KiB)

# ---------------------------------------------------------------------------
# Elementwise set algebra. Last axis = words; leading axes batch.
# ---------------------------------------------------------------------------


def b_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersect."""
    return torch.bitwise_and(a, b)


def b_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union."""
    return torch.bitwise_or(a, b)


def b_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric difference."""
    return torch.bitwise_xor(a, b)


def b_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference a \\ b."""
    return torch.bitwise_and(a, torch.bitwise_not(b))


def b_not(a: torch.Tensor, existence: torch.Tensor) -> torch.Tensor:
    """Not(a) relative to an existence row: existence \\ a."""
    return torch.bitwise_and(existence, torch.bitwise_not(a))


def union_many(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """N-way union over a stacked axis."""
    parts = torch.unbind(stack, dim=axis)
    if not parts:
        shape = list(stack.shape)
        del shape[axis]
        return torch.zeros(shape, dtype=stack.dtype, device=stack.device)
    return functools.reduce(torch.bitwise_or, parts)


def intersect_many(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """N-way intersection over a stacked axis."""
    parts = torch.unbind(stack, dim=axis)
    if not parts:
        shape = list(stack.shape)
        del shape[axis]
        return torch.full(shape, -1, dtype=stack.dtype, device=stack.device)
    return functools.reduce(torch.bitwise_and, parts)


# ---------------------------------------------------------------------------
# Counting: the plain SWAR popcount.
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of an ``int32`` tensor (values 0..32, int32).

    SWAR with a mask after every right shift, since ``>>`` on int32
    copies the sign bit; the additions wrap in two's complement, which
    keeps each bit field exact."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def popcount(a: torch.Tensor,
             axis: Union[int, Tuple[int, ...]] = -1) -> torch.Tensor:
    """Total set bits reduced over ``axis``, as int64."""
    return torch.sum(popcount32(a), dim=axis, dtype=torch.int64)


def count_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a ∧ b|."""
    return popcount(torch.bitwise_and(a, b))


def count_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(torch.bitwise_or(a, b))


def count_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(torch.bitwise_xor(a, b))


def count_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(b_andnot(a, b))


# ---------------------------------------------------------------------------
# Shifts and masks.
# ---------------------------------------------------------------------------


def _pad_low(a: torch.Tensor, k: int) -> torch.Tensor:
    """Move the word axis up by k words, zero-filling the low end and
    dropping the top k words."""
    w = a.shape[-1]
    out = torch.zeros_like(a)
    if k < w:
        out[..., k:] = a[..., :w - k]
    return out


def shift_bits(a: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift every bit position up by n within the word axis. Bits
    shifted past the top are dropped: shards do not carry into each
    other."""
    if n == 0:
        return a
    word_shift, bit_shift = divmod(n, WORD_BITS)
    if word_shift:
        a = _pad_low(a, word_shift)
    if bit_shift:
        hi = a << bit_shift
        carry = (a >> (WORD_BITS - bit_shift)) & ((1 << bit_shift) - 1)
        a = torch.bitwise_or(hi, _pad_low(carry, 1))
    return a


# ---------------------------------------------------------------------------
# Host helpers (numpy).
# ---------------------------------------------------------------------------


def range_mask_np(start: int, end: int,
                  words: int = WORDS_PER_SHARD) -> np.ndarray:
    """Host-built uint32 mask with bits [start, end) set."""
    mask = np.zeros(words, dtype=np.uint32)
    start = max(0, start)
    end = min(end, words * WORD_BITS)
    if end <= start:
        return mask
    w0, b0 = divmod(start, WORD_BITS)
    w1, b1 = divmod(end, WORD_BITS)
    if w0 == w1:
        mask[w0] = (np.uint64((1 << b1) - (1 << b0))).astype(np.uint32)
    else:
        mask[w0] = np.uint32(((1 << WORD_BITS) - (1 << b0)) & 0xFFFFFFFF)
        mask[w0 + 1: w1] = np.uint32(0xFFFFFFFF)
        if b1:
            mask[w1] = np.uint32((1 << b1) - 1)
    return mask


def pack_positions(positions: Union[Sequence[int], np.ndarray],
                   width: int = SHARD_WIDTH) -> np.ndarray:
    """Pack bit positions (< width) into a uint32 word array."""
    words = np.zeros(width // WORD_BITS, dtype=np.uint32)
    if len(positions) == 0:
        return words
    pos = np.asarray(positions, dtype=np.uint64)
    w = (pos >> np.uint64(5)).astype(np.int64)
    b = (pos & np.uint64(31)).astype(np.uint32)
    np.bitwise_or.at(words, w, np.left_shift(np.uint32(1), b))
    return words


def unpack_positions(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_positions: word array -> sorted uint64 positions.
    A sparse row (under one word in eight set) unpacks only its set
    words: a served Row of 96 shards is mostly zero words, and
    unpacking all of them costs hundreds of ms on the host."""
    words = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
    nz = np.flatnonzero(words)
    if len(nz) * 8 >= len(words):
        bits = np.unpackbits(words.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0].astype(np.uint64)
    bits = np.unpackbits(words[nz].view(np.uint8),
                         bitorder="little").reshape(-1, 32)
    word, bit = np.nonzero(bits)
    return nz[word].astype(np.uint64) * np.uint64(32) + bit.astype(np.uint64)


def to_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host words -> int32 tensor on ``device`` (same bits)."""
    host = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(host).to(device)


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 host words (same bits)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)
