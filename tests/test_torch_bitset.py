"""Differential tests: pilosa_tpu_torch.ops.bitset against the JAX
package's ops/bitset on the same seeded words, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitset as jb
from pilosa_tpu_torch.ops import bitset as tb

SPECIAL = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0xAAAAAAAA, 0x55555555,
                    0x12345678, 0xDEADBEEF, 0x7FFFFFFF, 0x80000001],
                   np.uint32)


def _words(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    w.reshape(-1)[:len(SPECIAL)] = SPECIAL
    return w


def _t(words):
    return tb.to_tensor(words, torch.device("cpu"))


def test_layout_constants_match():
    assert tb.SHARD_WIDTH == jb.SHARD_WIDTH
    assert tb.WORDS_PER_SHARD == jb.WORDS_PER_SHARD
    assert tb.WORD_BITS == jb.WORD_BITS


def test_popcount32_special_words():
    got = tb.popcount32(_t(SPECIAL)).numpy()
    want = [bin(int(w)).count("1") for w in SPECIAL]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["b_and", "b_or", "b_xor", "b_andnot",
                                "b_not"])
def test_pairwise_ops_match(op):
    a, b = _words(1, (3, 96)), _words(2, (3, 96))
    got = tb.to_numpy(getattr(tb, op)(_t(a), _t(b)))
    want = np.asarray(getattr(jb, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["union_many", "intersect_many"])
@pytest.mark.parametrize("axis", [0, 1, -2])
def test_reductions_match(op, axis):
    stack = _words(3, (4, 3, 64))
    got = tb.to_numpy(getattr(tb, op)(_t(stack), axis=axis))
    want = np.asarray(getattr(jb, op)(jnp.asarray(stack), axis=axis))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["count_and", "count_or", "count_xor",
                                "count_andnot"])
def test_counts_match(op):
    a, b = _words(4, (2, 3, 128)), _words(5, (2, 3, 128))
    got = getattr(tb, op)(_t(a), _t(b)).numpy()
    want = np.asarray(getattr(jb, op)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("axis", [-1, (-2, -1), 0])
def test_popcount_matches(axis):
    a = _words(6, (3, 2, 2048))
    got = tb.popcount(_t(a), axis=axis).numpy()
    want = np.asarray(jb.popcount(jnp.asarray(a), axis=axis))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 63, 64, 65, 100, 1000,
                               64 * 32 - 1, 64 * 32, 5000])
def test_shift_bits_across_word_boundaries(n):
    a = _words(7, (2, 64))
    got = tb.to_numpy(tb.shift_bits(_t(a), n))
    want = np.asarray(jb.shift_bits(jnp.asarray(a), n))
    np.testing.assert_array_equal(got, want)


def test_shift_bits_moves_single_bits():
    for p in (0, 31, 32, 63, 100, 2047):
        for n in (1, 31, 32, 33):
            row = tb.pack_positions([p], width=4096)
            got = tb.unpack_positions(tb.to_numpy(tb.shift_bits(_t(row), n)))
            want = [p + n] if p + n < 4096 else []
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,end", [(0, 0), (0, 1), (3, 40), (31, 33),
                                       (64, 1000), (5, 4096), (4000, 9999)])
def test_range_mask_matches(start, end):
    np.testing.assert_array_equal(tb.range_mask_np(start, end, 128),
                                  jb.range_mask_np(start, end, 128))


def test_pack_unpack_match():
    rng = np.random.default_rng(8)
    pos = np.unique(rng.integers(0, 1 << 16, 3000)).astype(np.uint64)
    w = tb.pack_positions(pos, width=1 << 16)
    np.testing.assert_array_equal(w, jb.pack_positions(pos, width=1 << 16))
    np.testing.assert_array_equal(tb.unpack_positions(w),
                                  jb.unpack_positions(w))
    np.testing.assert_array_equal(tb.unpack_positions(w), pos)


@pytest.mark.parametrize("n_bits", [0, 1, 40, 700, 20000, 1 << 16])
def test_unpack_matches_at_every_density(n_bits):
    """Sparse rows take the set-words path, dense ones the full unpack;
    both give the JAX package's positions."""
    rng = np.random.default_rng(n_bits)
    pos = np.unique(rng.integers(0, 1 << 16, n_bits)).astype(np.uint64)
    if n_bits == 1 << 16:
        pos = np.arange(1 << 16, dtype=np.uint64)
    w = tb.pack_positions(pos, width=1 << 16)
    np.testing.assert_array_equal(tb.unpack_positions(w),
                                  jb.unpack_positions(w))
    np.testing.assert_array_equal(tb.unpack_positions(w), pos)


def test_tensor_roundtrip_keeps_bits():
    a = _words(9, (3, 33))
    t = _t(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tb.to_numpy(t), a)
