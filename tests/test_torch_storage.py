"""The port's container store and fragment against the JAX package's.

The same seeded imports go into ``pilosa_tpu.storage.roaring.Bitmap`` /
``pilosa_tpu.core.fragment.Fragment`` and the port's ``Bitmap`` /
``Fragment``; every read must agree exactly: positions, counts, the
container keys and (where the JAX package's native import build is
available, whose dense-or-array choice the port copies) each container's
encoding; ``row_ids``, ``rows_dense``, ``rows_positions`` (with its
refusal of dense fields), ``max_column_offset`` and
``rows_changed_since``."""

import numpy as np
import pytest

from pilosa_tpu import native
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.storage.roaring import Bitmap as JaxBitmap
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.storage.roaring import Bitmap

SW_EXP = 20


def _batch(kind, seed):
    """(rows, cols) of one import shape."""
    rng = np.random.default_rng(seed)
    if kind == "dense_narrow":    # a few rows, many bits: dense masks
        rows = rng.integers(0, 3, 300_000).astype(np.uint64)
        cols = rng.integers(0, SHARD_WIDTH, len(rows)).astype(np.uint64)
    elif kind == "dense_span":    # 80 rows, dense enough for masks
        rows = rng.integers(10, 90, 400_000).astype(np.uint64)
        cols = rng.integers(0, 1 << 17, len(rows)).astype(np.uint64)
    elif kind == "fingerprint":   # 5000 one-container rows, sorted
        pos = np.sort(rng.integers(0, 4096, (5000, 48)), axis=1)
        rows = np.repeat(np.arange(5000, dtype=np.uint64), 48)
        cols = pos.reshape(-1).astype(np.uint64)
    elif kind == "sparse_wide":   # unsorted, a few bits in many rows
        rows = rng.integers(0, 20000, 30_000).astype(np.uint64)
        cols = rng.integers(0, SHARD_WIDTH, len(rows)).astype(np.uint64)
    elif kind == "heavy_rows":    # rows with > 4096 bits in one container
        rows = rng.integers(0, 200, 1_200_000).astype(np.uint64)
        cols = rng.integers(0, 1 << 16, len(rows)).astype(np.uint64)
    else:
        raise KeyError(kind)
    return rows, cols


KINDS = ["dense_narrow", "dense_span", "fingerprint", "sparse_wide",
         "heavy_rows"]


def _same_store(got, want):
    assert sorted(got.containers) == sorted(want.containers)
    for k, c in want.containers.items():
        g = got.containers[k]
        if native.available():
            assert g.dtype == c.dtype, k
        np.testing.assert_array_equal(got._positions(g), want._positions(c))
        assert got.container_count(k) == want.container_count(k)
    np.testing.assert_array_equal(got.slice(), want.slice())
    assert got.count() == want.count()


@pytest.mark.parametrize("kind", KINDS)
def test_import_batch_matches_jax(kind):
    rows, cols = _batch(kind, 3)
    want, got = JaxBitmap(), Bitmap()
    wk = want.import_batch(rows, cols, SW_EXP)
    gk = got.import_batch(rows, cols, SW_EXP)
    np.testing.assert_array_equal(gk, wk)
    _same_store(got, want)
    # A second batch over the same rows merges into existing containers.
    rows2, cols2 = _batch(kind, 4)
    want.import_batch(rows2, cols2, SW_EXP)
    got.import_batch(rows2, cols2, SW_EXP)
    _same_store(got, want)
    assert got.max() == want.max()
    for start, end in ((0, 1 << 20), (5, 70_000), (3 << 20, (3 << 20) + 99),
                       (1 << 16, 1 << 17)):
        assert got.count_range(start, end) == want.count_range(start, end)
    np.testing.assert_array_equal(got.dense_range(0, 1 << 20),
                                  want.dense_range(0, 1 << 20))


def test_point_ops_and_optimize_match_jax():
    """add into an array container densifies it; remove of the last bit
    drops the container; no-op removes keep arrays; optimize re-encodes
    sparse dense containers as arrays."""
    rows, cols = _batch("fingerprint", 5)
    want, got = JaxBitmap(), Bitmap()
    want.import_batch(rows, cols, SW_EXP)
    got.import_batch(rows, cols, SW_EXP)
    rng = np.random.default_rng(6)
    for p in rng.integers(0, 5000 << SW_EXP, 300).tolist() + [7, 7]:
        assert got.add(p) == want.add(p)
        assert got.contains(p) and want.contains(p)
    for p in (rng.integers(0, 5000 << SW_EXP, 300).tolist()
              + got.slice()[:50].tolist()):
        assert got.remove(p) == want.remove(p)
        assert got.contains(p) == want.contains(p)
    _same_store(got, want)
    assert got.optimize() == want.optimize()
    _same_store(got, want)
    positions = np.unique(rng.integers(0, 1 << 22, 20_000).astype(np.uint64))
    assert got.direct_add_n(positions) == want.direct_add_n(positions)
    _same_store(got, want)
    assert got.direct_remove_n(positions[::3]) == \
        want.direct_remove_n(positions[::3])
    _same_store(got, want)


@pytest.fixture
def fragments(tmp_path):
    """A JAX fragment (opened on a temporary file) and a port fragment of
    shard 2, each given the same 3000 fingerprint rows and four wide
    rows."""
    jf = JaxFragment(str(tmp_path / "frag"), "i", "f", "standard", 2)
    jf.open()
    tf = Fragment(2)
    base = 2 * SHARD_WIDTH
    rng = np.random.default_rng(9)
    pos = np.sort(rng.integers(0, 4096, (3000, 30)), axis=1)
    rows = np.repeat(np.arange(100, 3100, dtype=np.uint64), 30)
    cols = (pos.reshape(-1) + base).astype(np.uint64)
    wrows = rng.integers(5000, 5004, 50_000).astype(np.uint64)
    wcols = (rng.integers(0, 300_000, len(wrows)) + base).astype(np.uint64)
    for f in (jf, tf):
        (f.bulk_import if f is jf else f.import_bits)(rows, cols)
        (f.bulk_import if f is jf else f.import_bits)(wrows, wcols)
    yield jf, tf
    jf.close()


def test_fragment_reads_match_jax(fragments):
    jf, tf = fragments
    assert tf.row_ids() == jf.row_ids()
    assert tf.max_column_offset() == jf.max_column_offset()
    for r in (100, 1777, 3099, 5002, 6000):
        assert tf.row_count(r) == jf.row_count(r)
        np.testing.assert_array_equal(tf.row_dense(r), jf.row_dense(r))
    rows = [100, 101, 555, 6000, 3099, 5001]
    for width in (128, 256, 2048, 4096, 32768):
        np.testing.assert_array_equal(tf.rows_dense(rows, width),
                                      jf.rows_dense(rows, width))
    fp_rows = list(range(100, 3100))
    for width in (128, 64, 2048):
        got, want = tf.rows_positions(fp_rows, width), \
            jf.rows_positions(fp_rows, width)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # The wide rows span several containers: no positions form.
    assert tf.rows_positions([5000, 5001], 4096) is None
    assert jf.rows_positions([5000, 5001], 4096) is None
    assert tf.rows_positions(fp_rows, 4096) is None  # 2^17 bits


def test_rows_positions_refuses_dense_fields(fragments):
    """A few point writes densify their rows' containers and stay in
    the positions form; past a quarter of the rows the form is refused
    in both packages."""
    jf, tf = fragments
    base = 2 * SHARD_WIDTH
    rows = list(range(100, 140))
    for r in rows[:10]:
        assert tf.set_bit(r, base + 4095) == jf.set_bit(r, base + 4095)
    for width in (128, 2048):
        got, want = tf.rows_positions(rows, width), \
            jf.rows_positions(rows, width)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    tf.set_bit(rows[10], base + 1)
    jf.set_bit(rows[10], base + 1)
    assert tf.rows_positions(rows, 128) is None
    assert jf.rows_positions(rows, 128) is None


def test_rows_changed_since_matches_jax(fragments):
    jf, tf = fragments
    jv, tv = jf.version, tf.version
    base = 2 * SHARD_WIDTH
    free = next(c for c in range(4096) if not tf.bit(777, base + c))
    gone = int(tf.storage.containers[778 * 16][0])
    for f in (jf, tf):
        assert f.set_bit(777, base + free)
        assert f.clear_bit(778, base + gone)
        assert not f.set_bit(777, base + free)  # no change, no version
    assert sorted(tf.rows_changed_since(tv)) == \
        sorted(jf.rows_changed_since(jv)) == [777, 778]
    jv, tv = jf.version, tf.version
    rows = np.array([9, 9, 4000], np.uint64)
    cols = np.array([base + 1, base + 2, base + 3], np.uint64)
    jf.bulk_import(rows, cols)
    tf.import_bits(rows, cols)
    assert sorted(tf.rows_changed_since(tv)) == \
        sorted(jf.rows_changed_since(jv)) == [9, 4000]
    assert tf.row_ids() == jf.row_ids()
    tf.import_bits(rows, cols, clear=True)
    jf.bulk_import(rows, cols, clear=True)
    assert tf.row_ids() == jf.row_ids()
    assert 9 not in tf.row_ids()


def test_row_ids_carry_over_a_point_write(fragments):
    """A point write into a present row keeps the cached row list (the
    same tuple object) under the new version; one that adds a row
    rebuilds it."""
    _, tf = fragments
    before = tf.row_ids()
    tf.set_bit(100, 2 * SHARD_WIDTH + 4000)
    assert tf.row_ids() is before
    tf.set_bit(99, 2 * SHARD_WIDTH + 4000)
    assert tf.row_ids() == (99,) + before


def test_import_values_matches_jax(fragments):
    jf, tf = fragments
    rng = np.random.default_rng(12)
    base = 2 * SHARD_WIDTH
    for n, seed in ((200_000, 1), (50, 2), (150_000, 3)):
        cols = (rng.integers(0, 400_000, n) + base).astype(np.uint64)
        vals = rng.integers(0, 1 << 9, n).astype(np.uint64)
        jf.import_values(cols, vals, 9)
        tf.import_values(cols, vals, 9)
    for r in range(10):
        np.testing.assert_array_equal(tf.row_dense(r), jf.row_dense(r))
    assert tf.row_ids() == jf.row_ids()
    cols = np.array([base + 5, base + 6], np.uint64)
    jf.import_values(cols, np.zeros(2, np.uint64), 9, clear=True)
    tf.import_values(cols, np.zeros(2, np.uint64), 9, clear=True)
    for r in range(10):
        np.testing.assert_array_equal(tf.row_dense(r), jf.row_dense(r))
