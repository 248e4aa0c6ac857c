"""The port's anti-entropy unit (``core/fragment.py`` block checksums,
``block_data``, ``merge_block`` and ``replace_with_bytes``;
``core/attrs.py`` ``blocks`` and ``block_data``) and the drop of a
fragment a resize leaves a node without (``View.remove_fragment``,
``RankCacheStore.invalidate_shards``) against the
JAX package's, on the CPU: the same seeded writes go into a JAX holder
and a port holder, and digests, block pairs, merge deltas and the reads
after a replace or a drop must be equal, exactly. The port's
incremental digests must equal a cold pass after writes through every
write path a fragment has."""

import numpy as np
import pytest

from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor.results import result_to_json as jax_json

from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.core import fragment as pfrag
from pilosa_tpu_torch.core.fragment import HASH_BLOCK_SIZE, Fragment
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.executor.results import result_to_json
from pilosa_tpu_torch.storage.roaring import Bitmap

SW = 1 << 20
N_SHARDS = 3

FIELDS = [("f", {}), ("m", {"type": "mutex"}), ("b", {"type": "bool"}),
          ("t", {"type": "time", "time_quantum": "YMD"}),
          ("v", {"type": "int", "min": -1000, "max": 1000})]


@pytest.fixture(autouse=True)
def _reset_rooflines():
    """The roofline recorders are process-wide: a drift flag raised here
    must not reach a later test's sentinel."""
    from pilosa_tpu.utils.roofline import ROOFLINE as JAX_ROOFLINE
    from pilosa_tpu_torch.utils.roofline import ROOFLINE
    yield
    JAX_ROOFLINE.reset()
    ROOFLINE.reset()


def _load(h, seed, n=3000):
    """Seeded set, mutex, bool, time and int fields over N_SHARDS shards,
    rows past one checksum block; column and row attributes."""
    from datetime import datetime
    if isinstance(h, JaxHolder):
        from pilosa_tpu.core.field import FieldOptions as Opts
    else:
        from pilosa_tpu_torch.core.field import FieldOptions as Opts
    rng = np.random.default_rng(seed)
    idx = h.create_index("i")
    for name, kw in FIELDS:
        idx.create_field(name, Opts(**kw))
    cols = (rng.integers(0, N_SHARDS, n) * SW
            + rng.integers(0, 70000, n)).astype(np.uint64)
    idx.field("f").import_bits(
        rng.integers(0, 3 * HASH_BLOCK_SIZE, n).astype(np.uint64), cols)
    idx.field("m").import_bits(rng.integers(0, 5, n).astype(np.uint64),
                               cols)
    idx.field("b").import_bits(rng.integers(0, 2, n).astype(np.uint64),
                               cols)
    days = rng.integers(1, 28, n)
    idx.field("t").import_bits(
        rng.integers(0, 4, n).astype(np.uint64), cols,
        timestamps=[datetime(2019, 1, int(d)) for d in days])
    idx.field("v").import_values(cols, rng.integers(-900, 900, n))
    for i in rng.integers(0, 400, 40).tolist():
        idx.column_attr_store.set(int(i), {"k": int(i) % 7,
                                           "s": f"x{i % 3}"})
        idx.field("f").row_attr_store.set(int(i) % 250,
                                          {"w": [int(i), "y"]})
    return idx


def _same(pex, jex, q):
    """One query through both executors; the JSON answers must be
    equal. Returns the port's."""
    got = [result_to_json(r) for r in pex.execute("i", q)]
    assert got == [jax_json(r) for r in jex.execute("i", q)], q
    return got


def _frags(h):
    idx = h.index("i")
    for fname in sorted(idx.fields):
        for vname in sorted(idx.field(fname).views):
            view = idx.field(fname).view(vname)
            for shard in sorted(view.fragments):
                yield (fname, vname, shard), view.fragment(shard)


@pytest.fixture
def pair(tmp_path):
    jh = JaxHolder(str(tmp_path / "j"))
    jh.open()
    ph = Holder(device="cpu")
    for h in (jh, ph):
        _load(h, 5)
    yield jh, ph
    jh.close()


def test_fragment_digests_equal_jax(pair):
    jh, ph = pair
    jf, pf = dict(_frags(jh)), dict(_frags(ph))
    assert sorted(jf) == sorted(pf)
    assert {k[1] for k in pf} >= {"standard", "bsig_v", "standard_2019"}
    blocks = 0
    for key in sorted(pf):
        got = pf[key].checksum_blocks()
        assert got == jf[key].checksum_blocks(), key
        assert [b for b, _ in got] == sorted(b for b, _ in got)
        blocks += len(got)
    assert blocks > len(pf)  # some fragment spans several blocks


def test_attr_digests_equal_jax(pair):
    jh, ph = pair
    for get in (lambda h: h.index("i").column_attr_store,
                lambda h: h.index("i").field("f").row_attr_store):
        got, want = get(ph).blocks(), get(jh).blocks()
        assert got == want and len(got) >= 2
        for blk, _ in got:
            assert get(ph).block_data(blk) == get(jh).block_data(blk)
        assert get(ph).block_data(99) == get(jh).block_data(99) == {}


def test_block_data_and_merge_deltas_equal_jax(pair):
    """``block_data`` of every block, then ``merge_block`` of a seeded
    peer block into each fragment: the (here, there) deltas, the bits
    afterwards and the digests are the JAX package's."""
    jh, ph = pair
    jf, pf = dict(_frags(jh)), dict(_frags(ph))
    rng = np.random.default_rng(11)
    for key in sorted(pf):
        for blk, _ in pf[key].checksum_blocks():
            got, want = pf[key].block_data(blk), jf[key].block_data(blk)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        blk = int(rng.integers(0, 3))
        rows, cols = pf[key].block_data(blk)
        keep = rng.random(len(rows)) < 0.7
        extra = int(rng.integers(0, 30))
        their_r = np.concatenate([
            rows[keep], rng.integers(blk * HASH_BLOCK_SIZE,
                                     (blk + 1) * HASH_BLOCK_SIZE,
                                     extra).astype(np.uint64)])
        their_c = np.concatenate([
            cols[keep], (key[2] * SW + rng.integers(0, 90000, extra))
            .astype(np.uint64)])
        got = pf[key].merge_block(blk, their_r, their_c)
        want = jf[key].merge_block(blk, their_r, their_c)
        for (a, b), (c, d) in zip(got, want):
            assert np.array_equal(a, c) and np.array_equal(b, d), key
        assert pf[key].checksum_blocks() == jf[key].checksum_blocks(), key
        assert pf[key].write_bytes() == jf[key].write_bytes(), key


def _cold(frag):
    return sorted(frag._checksum_all_blocks().items())


def test_incremental_digests_equal_cold_through_every_write_path():
    """After each write of every kind a fragment takes (point writes,
    bulk and clearing imports, mutex imports, ClearRow, Store's row
    overwrite, roaring unions and clears, BSI values one at a time and
    in bulk, the layout's row words, a replace and a merge), the cached
    digests equal a cold pass over the whole store."""
    rng = np.random.default_rng(3)
    frag = Fragment(1)
    peer = Fragment(1)
    assert frag.checksum_blocks() == []

    def r(k, hi=3 * HASH_BLOCK_SIZE):
        return rng.integers(0, hi, k).astype(np.uint64)

    def c(k):
        return (SW + rng.integers(0, 200000, k)).astype(np.uint64)

    def roaring(rows, cols):
        b = Fragment(1)
        b.import_bits(rows, cols)
        return b.write_bytes()

    words = np.zeros((pfrag.CONTAINERS_PER_ROW, 1024), np.uint64)
    words[2, 5] = 0b1011
    ops = [
        lambda: frag.set_bit(7, SW + 3),
        lambda: frag.import_bits(r(500), c(500)),
        lambda: frag.clear_bit(int(frag.row_ids()[0]), SW + 3),
        lambda: frag.import_bits(r(200), c(200), clear=True),
        lambda: frag.bulk_import_mutex(r(50, 5), c(50)),
        lambda: frag.clear_row(int(frag.row_ids()[-1])),
        lambda: frag.set_row(150, rng.integers(0, 2**32, 64,
                                               dtype=np.uint64)
                             .astype(np.uint32)),
        lambda: frag.import_roaring(roaring(r(300), c(300))),
        lambda: frag.import_roaring(roaring(r(300), c(300)), clear=True),
        lambda: frag.set_value(SW + 9, 10, 777),
        lambda: frag.clear_value(SW + 9, 10),
        lambda: frag.import_values(c(100), rng.integers(0, 1000, 100), 10),
        lambda: frag.import_values(c(40), rng.integers(0, 1000, 40), 10,
                                   clear=True),
        lambda: frag.import_row_words(222, words),
        lambda: frag.replace_with_bytes(roaring(r(400), c(400))),
        lambda: frag.merge_block(1, *peer.block_data(1)),
        lambda: frag.replace_with_bytes(Bitmap().write_bytes()),
    ]
    peer.import_bits(r(300), c(300))
    for i, op in enumerate(ops):
        op()
        assert frag.checksum_blocks() == _cold(frag), i
        assert frag._dirty_blocks == set()
    # A forced cold pass and the cache agree on a warm store too.
    frag.import_bits(r(100), c(100))
    frag._invalidate_block_checksums()
    assert frag.checksum_blocks() == _cold(frag)


def test_replace_with_bytes_drops_bits_exactly(pair):
    """A replace drops the bits the bytes lack and adds theirs; a Count,
    a TopN, a Row and a range over the replaced shard (through warm
    banks and count caches) answer as the JAX package's after the same
    replace, and the union-only import would have kept the dropped
    bits."""
    jh, ph = pair
    jex, pex = JaxExecutor(jh), Executor(ph, device="cpu")
    reads = ["Count(Row(f=1))", "TopN(f, n=5)", "Row(f=2)",
             "Count(Row(v > 100))", "Sum(field=v)", "TopN(m)"]

    def answers():
        return [_same(pex, jex, q) for q in reads]

    before = answers()
    src = Fragment(1)
    src.import_roaring(ph.index("i").field("f").view().fragment(1)
                       .write_bytes())
    src.clear_row(1)
    src.clear_row(2)
    src.import_bits(np.array([1, 4], np.uint64),
                    np.array([SW + 5, SW + 6], np.uint64))
    vsrc = Fragment(1)
    vsrc.import_roaring(ph.index("i").field("v").view("bsig_v")
                        .fragment(0).write_bytes())
    vsrc.import_bits(np.arange(12, dtype=np.uint64),
                     np.full(12, 99, np.uint64), clear=True)
    for h in (jh, ph):
        h.index("i").field("f").view().fragment(1).replace_with_bytes(
            src.write_bytes())
        h.index("i").field("v").view("bsig_v").fragment(0) \
            .replace_with_bytes(vsrc.write_bytes())
    after = answers()
    assert after != before
    frag = ph.index("i").field("f").view().fragment(1)
    assert frag.row_offsets(1).tolist() == [5]
    assert not len(frag.row_offsets(2))
    # The bank the reads built covers the replaced shard exactly.
    bank = ph.index("i").field("f").view().device_bank([0, 1, 2])
    row2 = bank.array[bank.slot(2)] if 2 in bank.slots else None
    if row2 is not None:
        assert int(row2[1].count_nonzero()) == 0


def test_remove_fragment_forgets_banks_ledger_and_epoch(pair, monkeypatch):
    """Dropping a shard's fragment: the epoch moves (no version memo
    outlives it), every cached bank, host block and merged row list
    over that shard leaves the view with its budget entry and ledger
    row, the rank vectors over it go, and the reads after the drop
    answer as the JAX package's after the JAX cleaner's pop."""
    from pilosa_tpu_torch.core.view import BANK_BUDGET
    from pilosa_tpu_torch.utils.memledger import LEDGER
    jh, ph = pair
    # TopN past the count caches, so it keeps rank vectors.
    for cls in (JaxExecutor, Executor):
        monkeypatch.setattr(cls, "_topn_cached_counts",
                            lambda self, view, shards: None)
    jex, pex = JaxExecutor(jh), Executor(ph, device="cpu")
    reads = ["Count(Row(f=1))", "TopN(f, n=4)", "Row(m=3)",
             "Count(Intersect(Row(f=1), Row(b=1)))"]
    for q in reads:
        _same(pex, jex, q)
    view = ph.index("i").field("f").view()
    view.device_bank([0, 1], rows=[1, 2], cache_rows=True)
    assert any(1 in (k[1] if k[0] in ("sbank", "pbank") else k[0])
               for k in view._bank_cache)
    assert any(1 in k[0] for k in view._host_blocks)
    held = [k for (vid, k) in BANK_BUDGET._entries if vid == id(view)]
    assert held
    ranks = [e for (vid, _k), (_v, e) in ph.rank_cache._entries.items()
             if vid == id(view)]
    assert any(1 in e.versions for e in ranks)
    covering = [k for k in view._bank_cache
                if 1 in (k[1] if k[0] in ("sbank", "pbank") else k[0])]
    assert any(LEDGER.entry_info(("bank", "sparse_bank"), (id(view), k))
               for k in covering)
    epoch = pfrag.version_epoch()
    versions = view.shard_versions([0, 1, 2])
    frag = view.remove_fragment(1)
    assert frag is not None and view.remove_fragment(1) is None
    assert ph.rank_cache.invalidate_shards({("i", 1)}) >= 1
    assert pfrag.version_epoch() > epoch
    assert view.shard_versions([0, 1, 2]) != versions
    assert 1 not in view.fragments
    for key in view._bank_cache:
        assert 1 not in (key[1] if key[0] in ("sbank", "pbank")
                         else key[0]), key
    assert all(1 not in k[0] for k in view._host_blocks)
    assert all(1 not in k for k in view._merged_rows)
    left = {k for (vid, k) in BANK_BUDGET._entries if vid == id(view)}
    assert all(1 not in (k[1] if k[0] in ("sbank", "pbank") else k[0])
               for k in left)
    for key in covering:
        assert LEDGER.entry_info(("bank", "sparse_bank"),
                                 (id(view), key)) is None, key
    assert not any(1 in e.versions for (vid, _k), (_v, e)
                   in ph.rank_cache._entries.items() if vid == id(view))
    # The JAX cleaner's drop of the same fragment, then the same reads.
    jh.index("i").field("f").view().fragments.pop(1).close()
    for q in reads:
        _same(pex, jex, q)


def test_rank_cache_invalidate_shards_unit():
    """``invalidate_shards`` against the JAX package's store: the
    entries over a moved shard of their index go, counted."""
    from pilosa_tpu.core.cache import RankCacheStore as JaxStore
    from pilosa_tpu.core.cache import RankEntry as JaxEntry
    from pilosa_tpu_torch.core.cache import RankCacheStore, RankEntry
    import torch

    class _View:
        index = "ci"
        field = "f"
        name = "standard"

    out = []
    for store, entry in ((JaxStore(max_entries=8),
                          lambda v, r, n: JaxEntry(v, r, None, n)),
                         (RankCacheStore(max_entries=8),
                          lambda v, r, n: RankEntry(
                              v, r, torch.zeros(n // 8, dtype=torch.int64)))):
        v1, v2 = _View(), _View()
        v2.index = "other"
        store.put(v1, ("k1",), entry({0: 1, 3: 2}, (1, 2), 16))
        store.put(v2, ("k2",), entry({0: 1}, (1,), 8))
        out.append((store.invalidate_shards(set()),
                    store.invalidate_shards({("ci", 7)}),
                    store.invalidate_shards({("ci", 3)}), len(store),
                    store.invalidate_shards({("other", 0)}), len(store),
                    store.snapshot()["placementInvalidations"]))
    assert out[1] == out[0] == (0, 0, 1, 1, 1, 0, 2)
