"""A fragment's first load through the import builder's batch path
(``Fragment.import_bits`` > ``Bitmap.import_pairs``: every new container
taken whole, the count cache fed from the builder's per-container
counts) against the recount it replaces: every touched row recounted,
as ``import_bits`` ran it before, on the C++ builder and on the plain
one (``import_batch_plain``); and against the JAX package's fragment
with its native library on, which merges key by key.

Each case checks the same container keys, encodings, bits, cached
dense counts, ``row_ids()``, ranked-cache counts, threshold and
saturation, and how the fragment's import counters moved. Batches that
meet rows the store holds, under a cache that wants counts, recount."""

import numpy as np
import pytest

from pilosa_tpu import native
from pilosa_tpu.core import fragment as jfrag
from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import fragment as tfrag
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.storage import roaring as tr

W = 1 << 20  # shard width
# Pairs a chunk (an import record) in these tests, in both packages.
CHUNK = 1 << 20


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(tfrag, "IMPORT_CHUNK_PAIRS", CHUNK)
    monkeypatch.setattr(jfrag, "IMPORT_CHUNK_PAIRS", CHUNK)


class RecountFragment(tfrag.Fragment):
    """The port's fragment with the set import's rows recounted, as
    before the batch path: every chunk through ``import_batch`` (or its
    plain version), every touched row's count read from the store."""

    plain = False

    def _import_set(self, rows, offs):
        call = self.storage.import_batch_plain if self.plain \
            else self.storage.import_batch
        keys = np.concatenate([
            call(rows[i:i + tfrag.IMPORT_CHUNK_PAIRS],
                 offs[i:i + tfrag.IMPORT_CHUNK_PAIRS], tfrag.SHARD_WIDTH_EXP)
            for i in range(0, len(rows), tfrag.IMPORT_CHUNK_PAIRS)])
        return np.unique(keys // np.uint64(tfrag.CONTAINERS_PER_ROW)), \
            False, None


class PlainRecountFragment(RecountFragment):
    plain = True


def zipf_rows(rng, n, cells=10_000, s=1.1):
    """``n`` grid cells drawn Zipf(s) over ``cells`` cells in a seeded
    ranking: the taxi configuration's grid field."""
    w = 1.0 / np.arange(1, cells + 1) ** s
    cdf = np.cumsum(w) / w.sum()
    rank = rng.permutation(cells)
    return rank[np.searchsorted(cdf, rng.random(n), side="right").clip(
        max=cells - 1)].astype(np.uint64)


def batches(case):
    """The case's list of (rows, column offsets) imports, in order."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in ("zipf", "zipf_path"):
        # Four containers' columns a ride: the top cells pass 4,096
        # bits a container.
        cols = np.arange(4 << 16, dtype=np.uint64)
        return [(zipf_rows(rng, len(cols)), cols)]
    if case == "all_small":
        n = 20_000
        return [(rng.integers(0, 3000, n).astype(np.uint64),
                 rng.integers(0, W, n).astype(np.uint64))]
    if case == "reimport":
        cols = np.arange(2 << 16, dtype=np.uint64)
        rows = zipf_rows(rng, len(cols))
        return [(rows, cols), (rows[::3], cols[::3] + np.uint64(5))]
    if case == "half_present":
        n = 12_000
        first = rng.integers(0, 600, n).astype(np.uint64)
        cols = rng.integers(0, W, n).astype(np.uint64)
        second = np.where(np.arange(n) % 2 == 0, first, first + np.uint64(
            600))
        return [(first, cols), (second,
                                rng.integers(0, W, n).astype(np.uint64))]
    if case == "fingerprint":
        # 100k one-container rows a batch, 24 bits each, rows new to the
        # fragment in each: the ranked cache saturates on the first. A
        # chunk of CHUNK pairs ends inside a row, so the next chunk ORs
        # into that row's container.
        out = []
        for b in range(2):
            rows = np.repeat(np.arange(b * 100_000, (b + 1) * 100_000,
                                       dtype=np.uint64), 24)
            cols = rng.integers(0, 4096, len(rows)).astype(np.uint64)
            out.append((rows, cols))
        return out
    if case == "saturated_reimport":
        # Under a cache that saturates on the first load: a second load
        # that ORs into containers the store holds and brings new ones
        # past 4,096 bits, adopted beside them.
        cols = np.arange(4 << 16, dtype=np.uint64)
        return [(zipf_rows(rng, len(cols)), cols),
                (zipf_rows(rng, len(cols)), cols + np.uint64(2 << 16))]
    if case == "new_keys_live_cache":
        cols = np.arange(2 << 16, dtype=np.uint64)
        rows = zipf_rows(rng, len(cols), cells=2000)
        return [(rows, cols), (rows + np.uint64(2000), cols)]
    raise KeyError(case)


# case -> (set calls the dense builder declined, those that recounted
# no row)
COUNTERS = {"zipf": (1, 1), "zipf_path": (1, 1), "all_small": (1, 1),
            "reimport": (2, 1), "half_present": (2, 1),
            "fingerprint": (2, 2), "new_keys_live_cache": (2, 1),
            "saturated_reimport": (2, 2)}
# The ranked cache's size where a case sets one.
CACHE_SIZE = {"saturated_reimport": 1000}


def state(f):
    """What a fragment of either package holds: encodings by key, bits,
    the dense containers' cached counts, row ids, the ranked cache."""
    b = f.storage
    enc = {int(k): str(c.dtype) for k, c in b.containers.items()}
    cached = {int(k): int(v) for k, v in b._counts.items()
              if k in b.containers and b.containers[k].dtype == np.uint64}
    cache = f.cache
    return {"enc": enc, "cached": cached, "rows": tuple(f.row_ids()),
            "cache": dict(cache.counts), "threshold": cache._threshold,
            "saturated": cache.saturated}, b.slice()


def assert_same(got, want, with_cached=True):
    g, gbits = got
    w, wbits = want
    np.testing.assert_array_equal(gbits, wbits)
    for k in ("enc", "rows", "cache", "threshold", "saturated") + (
            ("cached",) if with_cached else ()):
        assert g[k] == w[k], k


def load(frag, case):
    for rows, cols in batches(case):
        if isinstance(frag, jfrag.Fragment):
            frag.bulk_import(rows, cols)
        else:
            frag.import_bits(rows, cols)
    return frag


@pytest.mark.parametrize("case", sorted(COUNTERS))
def test_batch_path_matches_the_merge_and_jax(case, tmp_path):
    """The fragment ends as the recount leaves it (C++ and plain
    builders) and as the JAX package's fragment does, and its counters
    say which imports took the batch path."""
    assert native.available(), "the JAX package's native library must build"
    size = CACHE_SIZE.get(case, cache_mod.DEFAULT_CACHE_SIZE)
    got = load(tfrag.Fragment(0, cache_size=size), case)
    assert (got.import_sorted_calls, got.import_batch_calls) == \
        COUNTERS[case]
    assert got.import_seconds > 0
    want = state(load(RecountFragment(0, cache_size=size), case))
    assert_same(state(got), want)
    assert all(n == tr._popcount_words(got.storage.containers[k])
               for k, n in got.storage._counts.items())
    assert_same(state(load(PlainRecountFragment(0, cache_size=size), case)),
                want)
    jf = jfrag.Fragment(str(tmp_path / "j"), "i", "f", "standard", 0,
                        cache_size=size)
    jf.open()
    # The JAX fragment caches the counts its own recount read.
    assert_same(state(load(jf, case)), want, with_cached=False)
    jf.close()


def merged_by_key(rows, cols):
    """({key: (encoding, sorted lows)}, positions): what a key-by-key
    merge into an empty store gives the pairs, each key's bits a sorted
    u16 array, dense above ARRAY_MAX_SIZE."""
    pos = np.unique((rows << np.uint64(20)) | cols)
    keys, starts = np.unique(pos >> np.uint64(16), return_index=True)
    groups = np.split((pos & np.uint64(0xFFFF)).astype(np.uint16),
                      starts[1:])
    return {k: ("uint16" if len(g) <= tr.ARRAY_MAX_SIZE else "uint64", g)
            for k, g in zip(keys.tolist(), groups)}, pos


@pytest.mark.parametrize("impl", ["CODEC", "PLAIN"])
def test_new_containers_taken_as_a_key_by_key_merge_would(impl):
    """A sorted batch on the C++ builder and on the plain one (numpy)
    leaves the containers and encodings a key-by-key merge gives, the
    dense ones' counts cached, writes the JAX package's record bytes,
    and returns each key's bits; a second batch ORs into the keys held
    and returns -1 for them."""
    import io
    from pilosa_tpu.storage import roaring as jr
    rows, cols = batches("zipf")[0]
    want, pos = merged_by_key(rows, cols)
    jb, got = jr.Bitmap(), tr.Bitmap()
    jb.op_writer, got.op_writer = io.BytesIO(), io.BytesIO()
    jb.import_batch(rows, cols, 20)
    keys, counts = got._import(rows, cols, 20, getattr(tr, impl))
    assert got.op_writer.getvalue() == jb.op_writer.getvalue()
    assert keys.tolist() == sorted(want)
    assert counts.tolist() == [len(want[k][1]) for k in keys.tolist()]
    assert {k: str(c.dtype) for k, c in got.containers.items()} == \
        {k: e for k, (e, _) in want.items()}
    assert any(e == "uint64" for e, _ in want.values())
    assert got._counts == {k: len(g) for k, (e, g) in want.items()
                           if e == "uint64"}
    np.testing.assert_array_equal(got.slice(), pos)
    more = cols[::5] + np.uint64(1 << 16)
    k2, c2 = got._import(rows[::5], more, 20, getattr(tr, impl))
    held = np.isin(k2, keys)
    assert held.any() and not held.all()
    assert (c2[held] == -1).all() and (c2[~held] > 0).all()
    want2, pos2 = merged_by_key(np.concatenate([rows, rows[::5]]),
                                np.concatenate([cols, more]))
    np.testing.assert_array_equal(got.slice(), pos2)
    assert all(got.container_count(k) == len(g)
               for k, (_, g) in want2.items())


def test_first_load_with_a_path_logs_the_same_record(tmp_path):
    """A fragment with a path: the batch path writes the op-log record
    of the recount and of the JAX package byte for byte, and the fragment
    reopened from its file (and its count-cache sidecar) reads back as
    it was."""
    got = tfrag.Fragment(0, path=str(tmp_path / "t"))
    got.open()
    want = RecountFragment(0, path=str(tmp_path / "m"))
    want.open()
    jf = jfrag.Fragment(str(tmp_path / "j"), "i", "f", "standard", 0)
    jf.open()
    for f in (got, want, jf):
        load(f, "zipf_path")
    assert got.import_batch_calls == 1
    data = (tmp_path / "t").read_bytes()
    assert data == (tmp_path / "m").read_bytes() == \
        (tmp_path / "j").read_bytes()
    before = state(got)
    assert_same(before, state(want))
    for f in (got, want, jf):
        f.close()
    again = tfrag.Fragment(0, path=str(tmp_path / "t"))
    again.open()
    after = state(again)
    # A reopened store caches no count until one is read.
    assert_same(after, before, with_cached=False)
    again.close()


def test_saturated_cache_takes_no_counts(monkeypatch):
    """Two 100k-row fingerprint-shaped batches under a ranked cache that
    saturates on the first: both on the batch path, with no row count
    taken and no walk over the store's rows."""
    def refuse(*a, **k):
        raise AssertionError("no row count or row walk on this path")
    monkeypatch.setattr(tfrag.Fragment, "_batch_row_counts", refuse)
    monkeypatch.setattr(tfrag.Fragment, "row_count", refuse)
    monkeypatch.setattr(tfrag.Fragment, "row_ids", refuse)
    f = load(tfrag.Fragment(0), "fingerprint")
    assert f.cache.saturated
    assert (f.import_sorted_calls, f.import_batch_calls) == (2, 2)
    assert len(f.storage.containers) == 200_000


@pytest.mark.parametrize("cache_type", [cache_mod.CACHE_TYPE_LRU,
                                        cache_mod.CACHE_TYPE_NONE])
def test_other_caches_fed_as_by_the_merge(cache_type):
    """An LRU cache gets each row's count in ascending row order from
    the builder's counts, as the recount gave it; no cache gets none."""
    got = load(tfrag.Fragment(0, cache_type=cache_type, cache_size=3000),
               "zipf")
    want = load(RecountFragment(0, cache_type=cache_type,
                                cache_size=3000), "zipf")
    assert got.import_batch_calls == 1
    assert list(got.cache.top()) == list(want.cache.top())
    if cache_type == cache_mod.CACHE_TYPE_LRU:
        assert list(got.cache.counts.items()) == \
            list(want.cache.counts.items())
    np.testing.assert_array_equal(got.storage.slice(), want.storage.slice())


def test_chunks_of_one_first_load_sum_into_row_counts(monkeypatch):
    """A first load past one chunk: each chunk adopts its new
    containers and ORs into those an earlier chunk adopted, and every
    row's count sums its containers' last counts."""
    monkeypatch.setattr(tfrag, "IMPORT_CHUNK_PAIRS", 50_000)
    monkeypatch.setattr(jfrag, "IMPORT_CHUNK_PAIRS", 50_000)
    rng = np.random.default_rng(11)
    n = 180_000
    # Each chunk a band of columns; a band's edges split containers.
    cols = np.sort(rng.integers(0, W, n)).astype(np.uint64)
    rows = zipf_rows(rng, n, cells=3000)
    got = tfrag.Fragment(0)
    got.import_bits(rows, cols)
    want = RecountFragment(0)
    want.import_bits(rows, cols)
    assert (got.import_sorted_calls, got.import_batch_calls) == (1, 1)
    assert_same(state(got), state(want))


def test_holder_sums_the_import_counters():
    """``Holder.import_stats`` sums every fragment's counters: two
    shards' first loads, the dense builder's narrow field uncounted."""
    h = Holder(device="cpu")
    idx = h.create_index("i")
    grid, narrow = idx.create_field("grid"), idx.create_field("narrow")
    rng = np.random.default_rng(2)
    cols = np.arange(2 * W, dtype=np.uint64)[::4]
    grid.import_bits(zipf_rows(rng, len(cols)), cols)
    narrow.import_bits(rng.integers(0, 8, len(cols)).astype(np.uint64), cols)
    stats = h.import_stats()
    assert (stats["sorted_calls"], stats["batch_calls"]) == (2, 2)
    assert stats["seconds"] > 0
