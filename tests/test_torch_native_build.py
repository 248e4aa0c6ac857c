"""The port's bulk import builder in its C++ codec
(``csrc/roaring_codec.cpp``: ``rc_import_build``,
``rc_serialize_groups``, ``rc_serialize_import``, ``rc_build_masks``,
``rc_scatter_rows``, ``rc_dense_positions_ptrs``) against the JAX
package's native library (``pilosa_tpu.native``) and against the port's
numpy builder (the plain version).

For each batch, ``Bitmap.import_batch`` writes the OP_ADD_ROARING record
the JAX package writes with its native library on, byte for byte, and
leaves the same containers in the same encodings with the same cached
counts of its dense containers (an array container's count is its
length, which the port does not cache); ``import_batch_plain`` does the
same. Under ``native.force_python()`` the JAX package takes its grouped
path for every batch: the bits and counts still agree. Batches: dense
and sparse, a wide row span, runs, duplicates, an empty batch, BSI and
mutex imports through fragments; then the builder's helpers one by
one."""

import io

import numpy as np
import pytest

from pilosa_tpu import native
from pilosa_tpu.core import fragment as jfrag
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu.storage import roaring as jr
from pilosa_tpu_torch.core import fragment as tfrag
from pilosa_tpu_torch.storage import roaring as tr

def batch(name, rng):
    r = lambda n, hi: rng.integers(0, hi, n).astype(np.uint64)  # noqa: E731
    if name == "dense_few_rows":      # span <= 64 containers: dense
        return r(40000, 3), r(40000, SHARD_WIDTH)
    if name == "dense_many_rows":     # 100 rows, >= 256 bits a container
        return r(100 * 16 * 300, 100), r(100 * 16 * 300, SHARD_WIDTH)
    if name == "sparse_wide":         # grouped: a bit or two a container
        return r(3000, 5000), r(3000, SHARD_WIDTH)
    if name == "wide_span":           # rows past the 2^17-container span
        rows = r(60000, 4)
        rows[::2] += np.uint64(10_000)
        return rows, r(60000, SHARD_WIDTH)
    if name == "runs":                # runs win a snapshot, never a record
        return (np.full(70000, 2, np.uint64),
                np.arange(70000, dtype=np.uint64))
    if name == "duplicates":
        rows, cols = r(5000, 2), r(5000, 1 << 16)
        return np.concatenate([rows] * 3), np.concatenate([cols] * 3)
    if name == "sorted_sparse":       # presorted positions, grouped
        cols = np.sort(r(20000, SHARD_WIDTH))
        return np.full(20000, 9, np.uint64) + (cols >> np.uint64(18)), cols
    if name == "high_rows":
        return r(4096, 2) + np.uint64(1 << 30), r(4096, SHARD_WIDTH)
    if name == "empty":
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    raise KeyError(name)


BATCHES = ["dense_few_rows", "dense_many_rows", "sparse_wide", "wide_span",
           "runs", "duplicates", "sorted_sparse", "high_rows", "empty"]


def state(b):
    """(encodings, every container's count, the dense containers' cached
    counts, sorted positions) of either package's Bitmap."""
    enc = {int(k): str(c.dtype) for k, c in b.containers.items()}
    counts = {int(k): b.container_count(k) for k in b.containers}
    cached = {int(k): int(v) for k, v in b._counts.items()
              if k in b.containers and b.containers[k].dtype == np.uint64}
    return enc, counts, cached, b.slice()


def imported(make, call, rows, cols, pre=None):
    b = make()
    if pre is not None:
        call(b, *pre)
    buf = io.BytesIO()
    b.op_writer = buf
    keys = call(b, rows, cols)
    return b, buf.getvalue(), np.asarray(keys)


@pytest.mark.parametrize("existing", [False, True])
@pytest.mark.parametrize("name", BATCHES)
def test_import_batch_matches_jax_native(name, existing):
    """Payload bytes, touched keys, containers, encodings and cached
    counts equal the JAX package's with its native library; over a
    store that already holds part of the batch's containers too."""
    assert native.available(), "the JAX package's native library must build"
    rng = np.random.default_rng(BATCHES.index(name))
    rows, cols = batch(name, rng)
    pre = batch("dense_few_rows", np.random.default_rng(99)) \
        if existing else None
    want = imported(jr.Bitmap, lambda b, r, c: b.import_batch(r, c, 20),
                    rows, cols, pre)
    for call in (lambda b, r, c: b.import_batch(r, c, 20),
                 lambda b, r, c: b.import_batch_plain(r, c, 20)):
        got = imported(tr.Bitmap, call, rows, cols, pre)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        g, w = state(got[0]), state(want[0])
        assert g[:3] == w[:3]
        np.testing.assert_array_equal(g[3], w[3])
        assert (got[0].op_n, got[0].oplog_bytes) == \
            (want[0].op_n, len(want[1]) if len(rows) else 0)


@pytest.mark.parametrize("name", BATCHES)
def test_import_batch_bits_match_jax_python_path(name):
    rows, cols = batch(name, np.random.default_rng(BATCHES.index(name)))
    with native.force_python():
        want = imported(jr.Bitmap, lambda b, r, c: b.import_batch(r, c, 20),
                        rows, cols)[0]
        jbits, jcounts = want.slice(), state(want)[1]
    got = imported(tr.Bitmap, lambda b, r, c: b.import_batch(r, c, 20),
                   rows, cols)[0]
    np.testing.assert_array_equal(got.slice(), jbits)
    assert state(got)[1] == jcounts


def test_payload_without_a_writer_is_not_built(monkeypatch):
    """With no op writer the builder skips the payload: nothing is
    logged and only the op count moves."""
    rows, cols = batch("dense_few_rows", np.random.default_rng(0))
    b = tr.Bitmap()
    b.import_batch(rows, cols, 20)
    got = tr.import_build(rows, cols, 20, want_payload=False)
    assert got[3] is None and b.oplog_bytes == 0
    assert b.op_n == got[4] == len(np.unique(rows * np.uint64(SHARD_WIDTH)
                                             + cols))


@pytest.mark.parametrize("threads", ["1", "3"])
def test_builder_output_does_not_depend_on_threads(tmp_path, threads):
    """PILOSA_NATIVE_THREADS splits the scatter past 2^20 pairs; a child
    process with 1 and with 3 threads writes the JAX bytes."""
    import subprocess
    import sys
    rows, cols = batch("dense_few_rows", np.random.default_rng(5))
    rows = np.tile(rows, 27)
    cols = np.tile(cols, 27) ^ np.repeat(np.arange(27, dtype=np.uint64),
                                         len(cols))
    np.save(tmp_path / "r.npy", rows)
    np.save(tmp_path / "c.npy", cols)
    code = ("import sys, numpy as np\n"
            "from pilosa_tpu_torch.storage import roaring as tr\n"
            "d = sys.argv[1]\n"
            "got = tr.import_build(np.load(d + '/r.npy'), "
            "np.load(d + '/c.npy'), 20)\n"
            "open(d + '/p.bin', 'wb').write(got[3])\n")
    import os
    env = dict(os.environ, PILOSA_NATIVE_THREADS=threads)
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True,
                   env=env, cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
    want = native.import_build(rows, cols, 20)
    assert (tmp_path / "p.bin").read_bytes() == want[3]


# ----------------------------------------------------------- fragments


def frag_pair(tmp_path):
    jf = jfrag.Fragment(str(tmp_path / "j"), "i", "f", "standard", 0)
    jf.open()
    tf = tfrag.Fragment(0, path=str(tmp_path / "t"))
    tf.open()
    return jf, tf


@pytest.mark.parametrize("depth,n", [(2, 3000), (10, 3000), (10, 300000),
                                     (21, 40000)])
def test_bsi_import_records_match_jax_native(tmp_path, depth, n):
    """A BSI import through both packages' fragments writes the same
    file with the JAX native library on (one record, or the chunked
    records past IMPORT_CHUNK_PAIRS), and a second import over the
    first (zero planes cleared) does too."""
    rng = np.random.default_rng(depth + n)
    cols = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
    vals = rng.integers(0, 1 << depth, n).astype(np.uint64)
    jf, tf = frag_pair(tmp_path)
    for f in (jf, tf):
        f.import_values(cols, vals, depth)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    cols2 = np.concatenate([cols[:n // 3],
                            rng.integers(0, SHARD_WIDTH, 500).astype(
                                np.uint64)])
    vals2 = rng.integers(0, 1 << depth, len(cols2)).astype(np.uint64)
    for f in (jf, tf):
        f.import_values(cols2, vals2, depth)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for c in cols2[:50].tolist():
        assert tf.value(int(c), depth) == jf.value(int(c), depth)
    jf.close()
    tf.close()


@pytest.mark.parametrize("n", [4000, 70000])
def test_mutex_import_records_match_jax_native(tmp_path, n):
    rng = np.random.default_rng(n)
    rows = rng.integers(1, 6, n).astype(np.uint64)
    cols = rng.integers(0, 1 << 17, n).astype(np.uint64)
    jf, tf = frag_pair(tmp_path)
    for f in (jf, tf):
        f.bulk_import_mutex(rows, cols)
        f.bulk_import_mutex(rows[: n // 2] + np.uint64(1), cols[: n // 2])
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    jf.close()
    tf.close()


def test_bulk_import_files_match_jax_native(tmp_path):
    """Set imports of every shape through both fragments, with their
    snapshots, give byte-equal files with the JAX native library on."""
    jf, tf = frag_pair(tmp_path)
    for i, name in enumerate(BATCHES[:-1]):
        rows, cols = batch(name, np.random.default_rng(40 + i))
        rows = rows % np.uint64(64)
        jf.bulk_import(rows, cols)
        tf.import_bits(rows, cols)
        assert (tmp_path / "t").read_bytes() == \
            (tmp_path / "j").read_bytes(), name
    jf.close()
    tf.close()
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


# ------------------------------------------------------------- helpers


def test_serialize_groups_matches_jax():
    rng = np.random.default_rng(3)
    sizes = [1, 2, 4095, 4096, 4097, 65536, 30, 3]
    keys = np.sort(rng.choice(1 << 30, len(sizes), replace=False)).astype(
        np.uint64)
    groups = [np.sort(rng.choice(65536, s, replace=False)).astype(np.uint16)
              for s in sizes]
    groups[-1] = np.array([5, 6, 7], np.uint16)  # a run, written as array
    lows = np.concatenate(groups)
    bounds = np.concatenate(([0], np.cumsum(sizes))).astype(np.uint64)
    want = native.serialize_groups(keys, lows, bounds)
    assert tr.serialize_groups(keys, lows, bounds) == want
    assert tr.serialize_groups_plain(keys, lows, bounds) == want
    assert tr.serialize_groups(keys[:0], lows[:0], bounds[:1]) == \
        native.serialize_groups(keys[:0], lows[:0], bounds[:1])
    with pytest.raises(ValueError, match="bounds"):
        tr.serialize_groups(keys[:2], lows, np.array([0, 0, 3], np.uint64))


def test_serialize_import_and_masks_match_jax_payloads():
    """The payload of dense masks is the JAX builder's for the same
    bits."""
    rows, cols = batch("dense_many_rows", np.random.default_rng(4))
    keys, words, _, payload, _ = native.import_build(rows, cols, 20)
    assert tr.serialize_import(keys, words) == payload
    assert tr.serialize_import_plain(keys, words) == payload
    pos = np.unique(rows * np.uint64(SHARD_WIDTH) + cols)
    assert tr.serialize_positions(pos) == payload


@pytest.mark.parametrize("impl", [tr.build_masks, tr.build_masks_plain])
def test_build_masks_matches_jax(impl):
    rng = np.random.default_rng(6)
    pos = np.unique(rng.integers(0, 1 << 24, 200000).astype(np.uint64))
    m = len(np.unique(pos >> np.uint64(16)))
    wk, ww = native.build_masks(pos, m)
    gk, gw = impl(pos, m)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gw, ww)
    with pytest.raises(ValueError, match="groups"):
        impl(pos, m - 1)


@pytest.mark.parametrize("impl", [tr.dense_positions_of,
                                  tr.dense_positions_of_plain])
def test_dense_positions_of_matches_jax(impl):
    rng = np.random.default_rng(7)
    cs = [rng.integers(0, 2 ** 63, 1024, dtype=np.uint64)
          & rng.integers(0, 2 ** 63, 1024, dtype=np.uint64)
          for _ in range(5)] + [np.zeros(1024, np.uint64)]
    bases = (np.arange(6, dtype=np.uint64) * np.uint64(7)) << np.uint64(16)
    np.testing.assert_array_equal(impl(cs, bases),
                                  native.dense_positions_of(cs, bases))
    assert len(impl([], np.empty(0, np.uint64))) == 0


@pytest.mark.parametrize("impl", [tr.scatter_rows, tr.scatter_rows_plain])
@pytest.mark.parametrize("words64", [1024, 100, 3])
def test_scatter_rows_matches_jax(impl, words64):
    rng = np.random.default_rng(words64)
    lens = rng.integers(0, 40, 30).astype(np.uint64)
    pos = np.concatenate([np.sort(rng.choice(65536, int(n), replace=False))
                          for n in lens]).astype(np.uint16)
    row_index = rng.permutation(40)[:30].astype(np.uint64)
    want = np.zeros((40, words64), np.uint64)
    assert native.scatter_rows(pos, lens, row_index, words64, want)
    got = np.zeros((40, words64), np.uint64)
    impl(pos, lens, row_index, words64, got)
    np.testing.assert_array_equal(got, want)


def test_rows_dense_gathers_through_scatter_rows(tmp_path):
    """The fragment's one-container row block (the fingerprint bank's
    gather) equals the JAX fragment's."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 500, 20000).astype(np.uint64)
    cols = rng.integers(0, 1 << 14, 20000).astype(np.uint64)
    jf, tf = frag_pair(tmp_path)
    jf.bulk_import(rows, cols)
    tf.import_bits(rows, cols)
    tf.set_bit(3, 70)  # a dense container among the arrays
    jf.set_bit(3, 70)
    ids = list(range(0, 510, 3))
    for u32 in (512, 2048):
        np.testing.assert_array_equal(tf.rows_dense(ids, u32),
                                      np.asarray(jf.rows_dense(ids, u32)))
    jf.close()
    tf.close()
