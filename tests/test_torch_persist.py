"""Differential tests of the port's persistence against the JAX package's.

- the codec: the port's numpy writer gives the JAX package's
  Python-path bytes over the array/bitmap/run lattice, its C++ writer
  the numpy writer's bytes; each package reads the other's bytes to the
  same positions; op records are byte-identical; every file of
  ``tests/fuzz_corpus/`` is accepted or refused, with the same
  positions, op counts and torn-tail bytes, by the JAX Python reader and
  both of the port's readers;
- fragments: one write script through a JAX fragment and a port
  fragment, the files byte-identical and the snapshot points equal after
  every step, each package opening the other's file to the same bits;
  a torn tail's sidecar; the cache sidecar's stamp;
- data directories both ways: a JAX ``Holder(path)`` builds and closes
  an index of every field type, keys and attributes; the port opens it
  and answers a read script as the JAX executor does over the same
  directory, cache counters step for step; the port writes and closes;
  the JAX package reopens and agrees again. The metadata, key and
  attribute files of the two packages hold the same content;
- the translate log's torn tail: the port cuts it, the JAX store
  appends after it (a reference fault recorded in ROADMAP.md);
- ``tailDroppedBytes`` of ``API.info()`` and ``GET /info`` after a torn
  op log and a reopen, equal to the JAX server's.

The JAX side runs as its own tests run it on the CPU; its Python codec
through ``pilosa_tpu.native.force_python()``. Exact equality throughout.
"""

import json
import os
import shutil
import struct
import urllib.request
from datetime import datetime

import numpy as np
import pytest

from pilosa_tpu import native
from pilosa_tpu.core import fragment as jfrag
from pilosa_tpu.core.cache import RANK_CACHE as JAX_RANK_CACHE
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.core.translate import TranslateStore as JaxTranslateStore
from pilosa_tpu.executor import executor as jax_executor_mod
from pilosa_tpu.ops.bitset import SHARD_WIDTH
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.server import serve as jax_serve
from pilosa_tpu.storage import roaring as jr
from pilosa_tpu.utils.stats import MemStatsClient
from pilosa_tpu_torch import Holder
from pilosa_tpu_torch.core import fragment as tfrag
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.executor import executor as executor_mod
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.server import API, serve
from pilosa_tpu_torch.storage import roaring as tr

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fuzz_corpus")


# ------------------------------------------------------------------ codec

def lattice(seed):
    """Positions over a few containers, each straddling an encoding
    boundary: singletons, u16 edges, full, at and past ARRAY_MAX_SIZE,
    one long run, many runs, dense random."""
    rng = np.random.default_rng(seed)
    parts = [
        np.array([0]), np.array([0, 65535]), np.arange(65536),
        np.sort(rng.choice(65536, 4096, replace=False)),
        np.sort(rng.choice(65536, 4097, replace=False)),
        np.arange(100, 5000),
        np.concatenate([np.arange(i, i + 9) for i in range(0, 60000, 100)]),
        np.sort(rng.choice(65536, 30000, replace=False)),
        np.sort(rng.choice(65536, 2047, replace=False)),
        np.arange(0, 65536, 2),
    ]
    keys = np.sort(rng.choice(1 << 20, len(parts), replace=False))
    return np.concatenate([np.uint64(k << 16) + p.astype(np.uint64)
                           for k, p in zip(keys.tolist(), parts)])


def port_bitmap(positions, optimize):
    b = tr.Bitmap()
    b.direct_add_n(np.asarray(positions, dtype=np.uint64))
    if optimize:
        b.optimize()
    return b


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_bytes_match_jax_python_path(seed, optimize):
    """Both of the port's writers give the JAX package's bytes for the
    same containers: its Python path's (the smallest encoding a
    container) while at most a quarter of them are arrays; past that,
    the groups writer's (array or bitmap, never run) that the JAX
    package with its native library takes there."""
    pos = lattice(seed)
    jb = jr.Bitmap(pos)
    if optimize:
        jb.optimize()
    with native.force_python():
        want = jb.write_bytes()
    b = port_bitmap(pos, optimize)
    assert {k: c.dtype for k, c in b.containers.items()} == \
        {k: c.dtype for k, c in jb.containers.items()}
    if b._groups_heavy(list(b.containers.values())):
        assert jb.write_bytes() != want  # the lattice has run containers
        want = jb.write_bytes()
    assert b.write_bytes_plain() == want
    assert b.write_bytes() == want
    assert jb.write_bytes() == want


@pytest.mark.parametrize("seed", [3, 4])
def test_each_package_reads_the_others_bytes(seed):
    pos = lattice(seed)
    mine = port_bitmap(pos, True).write_bytes()
    jax_native = jr.Bitmap(pos).write_bytes()  # the groups writer, no runs
    for data in (mine, jax_native):
        for read in (tr.Bitmap.from_bytes, tr.Bitmap.from_bytes_plain):
            np.testing.assert_array_equal(read(data).slice(), pos)
        np.testing.assert_array_equal(jr.Bitmap.from_bytes(data).slice(), pos)
        with native.force_python():
            np.testing.assert_array_equal(
                jr.Bitmap.from_bytes(data).slice(), pos)


def test_op_records_match_jax():
    rng = np.random.default_rng(7)
    vals = np.unique(rng.integers(0, 1 << 40, 300).astype(np.uint64))
    payload = port_bitmap(vals, True).write_bytes()
    for typ in (tr.OP_ADD, tr.OP_REMOVE):
        for value in (0, 12345, (1 << 64) - 1):
            rec = tr.encode_op(typ, value)
            assert rec == jr.encode_op(typ, value)
            assert tr.decode_op(rec) == jr.decode_op(rec)
    for typ in (tr.OP_ADD_BATCH, tr.OP_REMOVE_BATCH):
        rec = tr.encode_op(typ, values=vals)
        assert rec == jr.encode_op(typ, values=vals)
        got, want = tr.decode_op(rec), jr.decode_op(rec)
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_array_equal(got[2], want[2])
    rec = tr.encode_op_roaring(payload)
    assert rec == jr.encode_op_roaring(payload)
    assert tr.decode_op(rec) == jr.decode_op(rec)
    for chunks in ((b"",), (b"abc",), (payload, b"x" * 9)):
        assert tr.fnv1a32(*chunks) == tr.fnv1a32_plain(*chunks) \
            == jr.fnv1a32(*chunks)
    with pytest.raises(tr.OpTruncatedError):
        tr.decode_op(rec[:20])


def test_import_records_match_jax_python_path(tmp_path):
    """An import's OP_ADD_ROARING record through both of the port's
    import branches (dense masks and sorted groups) is the record the
    JAX package's Python path writes for the same pairs."""
    rng = np.random.default_rng(8)
    cases = [  # dense: a few rows, many bits; grouped: wide sparse rows
        (rng.integers(0, 3, 40000), rng.integers(0, SHARD_WIDTH, 40000)),
        (rng.integers(0, 5000, 3000), rng.integers(0, SHARD_WIDTH, 3000)),
        (np.full(5000, 7), np.arange(5000) * 3 + 100)]
    for rows, cols in cases:
        rows = rows.astype(np.uint64)
        cols = cols.astype(np.uint64)
        with open(tmp_path / "j", "wb") as jf, \
                open(tmp_path / "t", "wb", buffering=0) as tf:
            jb, tb = jr.Bitmap(), tr.Bitmap()
            jb.op_writer, tb.op_writer = jf, tf
            with native.force_python():
                jb.import_batch(rows, cols, 20)
            tb.import_batch(rows, cols, 20)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
        assert (tb.op_n, tb.oplog_bytes) == (jb.op_n, jb.oplog_bytes)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_op_logs_read_the_same_through_both_readers(tmp_path, seed):
    """A snapshot, then a random log of every record type over new and
    existing containers (arrays, bitmaps, runs): both of the port's
    readers give the writer's bits and accounting."""
    rng = np.random.default_rng(seed)
    b = port_bitmap(lattice(seed), seed % 2 == 0)
    path = tmp_path / "f"
    with open(path, "wb") as f:
        f.write(b.write_bytes())
    with open(path, "ab", buffering=0) as f:
        b.op_writer = f
        b.op_n = b.op_n_small = b.oplog_bytes = 0
        keys = list(b.containers) + rng.integers(0, 1 << 20, 5).tolist()
        for _ in range(40):
            k = int(rng.choice(keys))
            pos = (np.uint64(k << 16) + rng.integers(
                0, 65536, int(rng.integers(1, 3000))).astype(np.uint64))
            op = rng.integers(0, 4)
            if op == 0:
                b.add(*pos[:3].tolist())
            elif op == 1:
                b.remove(*pos[:3].tolist())
            elif op == 2:
                b.remove_batch(np.unique(pos))
            else:
                b.import_batch(pos >> np.uint64(20),
                               pos & np.uint64(SHARD_WIDTH - 1), 20)
    data = path.read_bytes()
    for read in (tr.Bitmap.from_bytes, tr.Bitmap.from_bytes_plain):
        got = read(data)
        np.testing.assert_array_equal(got.slice(), b.slice())
        assert (got.op_n, got.op_n_small, got.oplog_bytes) == \
            (b.op_n, b.op_n_small, b.oplog_bytes)
    with native.force_python():
        np.testing.assert_array_equal(jr.Bitmap.from_bytes(data).slice(),
                                      b.slice())


def corpus_verdict(load):
    try:
        b = load()
    except (ValueError, OverflowError, IndexError, struct.error):
        return ("error",)
    return ("ok", b.slice().tolist(), b.op_n, b.tail_dropped)


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(CORPUS) if n.endswith(".bin")))
def test_fuzz_corpus_verdicts_match_jax(name):
    with open(os.path.join(CORPUS, name), "rb") as f:
        data = f.read()
    for tolerate in (True, False):
        with native.force_python():
            want = corpus_verdict(lambda: jr.Bitmap.from_bytes(
                data, tolerate_torn_tail=tolerate))
        assert corpus_verdict(lambda: tr.Bitmap.from_bytes(
            data, tolerate_torn_tail=tolerate)) == want, tolerate
        assert corpus_verdict(lambda: tr.Bitmap.from_bytes_plain(
            data, tolerate_torn_tail=tolerate)) == want, tolerate


# -------------------------------------------------------------- fragments

def jax_frag(path, **kw):
    f = jfrag.Fragment(str(path), "i", "f", "standard", 0, **kw)
    with native.force_python():
        f.open()
    return f


def port_frag(path, **kw):
    f = tfrag.Fragment(0, path=str(path), **kw)
    f.open()
    return f


def jax_clear_row(f, row):
    """The JAX executor's ClearRow on one fragment."""
    cols = f.row_columns(row)
    if len(cols):
        f.bulk_import(np.full(len(cols), row, np.uint64), cols, clear=True)


def fragment_script(rng):
    """(name, JAX step, port step) of one write script over every write
    path; a step takes the fragment."""
    r = lambda n, hi: rng.integers(0, hi, n).astype(np.uint64)  # noqa: E731
    rows, cols = r(9000, 6), r(9000, SHARD_WIDTH)
    vcols, vals = r(3000, SHARD_WIDTH), r(3000, 1000)
    vcols2, vals2 = r(2000, SHARD_WIDTH), r(2000, 1000)
    mrows, mcols = r(4000, 4) + np.uint64(20), r(4000, 5000)
    mrows2, mcols2 = r(3000, 4) + np.uint64(20), r(3000, 5000)
    words = rng.integers(0, 2 ** 32, SHARD_WIDTH // 32 // 4,
                         dtype=np.uint64).astype(np.uint32)
    roar = port_bitmap(np.unique(r(20000, 8 * SHARD_WIDTH)), True)
    roar_clear = port_bitmap(np.unique(r(6000, 8 * SHARD_WIDTH)), False)
    singles = [(int(a), int(b)) for a, b in zip(r(14, 3), r(14, 70000))]
    out = []
    for i, (a, b) in enumerate(singles):
        out.append((f"set{i}", lambda f, a=a, b=b: f.set_bit(a, b),
                    lambda f, a=a, b=b: f.set_bit(a, b)))
    out += [
        ("clear", lambda f: f.clear_bit(*singles[0]),
         lambda f: f.clear_bit(*singles[0])),
        ("import", lambda f: f.bulk_import(rows, cols),
         lambda f: f.import_bits(rows, cols)),
        ("import_clear", lambda f: f.bulk_import(rows[:500], cols[:500],
                                                 clear=True),
         lambda f: f.import_bits(rows[:500], cols[:500], clear=True)),
        ("values", lambda f: f.import_values(vcols, vals, 10),
         lambda f: f.import_values(vcols, vals, 10)),
        ("values_again", lambda f: f.import_values(
            np.concatenate([vcols[:700], vcols2]),
            np.concatenate([vals[:700] ^ np.uint64(5), vals2]), 10),
         lambda f: f.import_values(
            np.concatenate([vcols[:700], vcols2]),
            np.concatenate([vals[:700] ^ np.uint64(5), vals2]), 10)),
        ("values_clear", lambda f: f.import_values(vcols[:100], vals[:100],
                                                   10, clear=True),
         lambda f: f.import_values(vcols[:100], vals[:100], 10, clear=True)),
        ("set_value", lambda f: f.set_value(77, 10, 513),
         lambda f: f.set_value(77, 10, 513)),
        ("clear_value", lambda f: f.clear_value(int(vcols[5]), 10),
         lambda f: f.clear_value(int(vcols[5]), 10)),
        ("mutex", lambda f: f.bulk_import_mutex(mrows, mcols),
         lambda f: f.bulk_import_mutex(mrows, mcols)),
        ("mutex_again", lambda f: f.bulk_import_mutex(mrows2, mcols2),
         lambda f: f.bulk_import_mutex(mrows2, mcols2)),
        ("store", lambda f: f.set_row(3, words), lambda f: f.set_row(3, words)),
        ("clear_row", lambda f: jax_clear_row(f, 2),
         lambda f: f.clear_row(2)),
        ("roaring", lambda f: f.import_roaring(roar.write_bytes()),
         lambda f: f.import_roaring(roar.write_bytes())),
        ("roaring_clear", lambda f: f.import_roaring(
            roar_clear.write_bytes(), clear=True),
         lambda f: f.import_roaring(roar_clear.write_bytes(), clear=True)),
        ("import_after", lambda f: f.bulk_import(rows[:3000] + np.uint64(1),
                                                 cols[:3000]),
         lambda f: f.import_bits(rows[:3000] + np.uint64(1), cols[:3000])),
    ]
    return out


def fragment_state(f):
    return {r: f.row_count(r) for r in f.row_ids()}, f.storage.slice()


def test_fragment_write_script_matches_jax(tmp_path, monkeypatch):
    """After every step of the script the two fragments' files are
    byte-identical and their snapshot points equal (single-bit records
    fold after 5, batch records past 4000 bytes, imports chunk
    at 2048 pairs); each package then opens the other's file to the
    same bits and row counts."""
    for mod in (jfrag, tfrag):
        monkeypatch.setattr(mod, "IMPORT_CHUNK_PAIRS", 2048)
        monkeypatch.setattr(mod, "OPLOG_FOLD_MIN_BYTES", 4000)
    monkeypatch.setattr(tfrag, "DEFAULT_MAX_OP_N", 5)
    jpath, tpath = tmp_path / "jax", tmp_path / "port"
    jf = jax_frag(jpath, max_op_n=5)
    tf = port_frag(tpath)
    snapshots = set()
    with native.force_python():
        for name, jstep, tstep in fragment_script(np.random.default_rng(1)):
            jstep(jf)
            tstep(tf)
            assert tpath.read_bytes() == jpath.read_bytes(), name
            assert tf._last_snapshot_bytes == jf._last_snapshot_bytes, name
            snapshots.add(tf._last_snapshot_bytes)
            jrows, jbits = fragment_state(jf)
            trows, tbits = fragment_state(tf)
            assert trows == jrows, name
            np.testing.assert_array_equal(tbits, jbits, err_msg=name)
    assert len(snapshots) > 5  # single-bit, batch and rewrite folds
    want = fragment_state(jf)
    jf.close()
    tf.close()
    shutil.copy(jpath, tmp_path / "jax_copy")
    shutil.copy(tpath, tmp_path / "port_copy")
    cross = [port_frag(tmp_path / "jax_copy"), jax_frag(tmp_path / "port_copy")]
    for f in cross:
        rows, bits = fragment_state(f)
        assert rows == want[0]
        np.testing.assert_array_equal(bits, want[1])
        f.close()


def test_torn_tail_goes_to_the_same_sidecar(tmp_path, monkeypatch):
    """A record torn at the end moves to ``.torn`` with the same bytes in
    both packages and the file is cut at the same point; a dangling tail
    past the bound is refused by both."""
    rng = np.random.default_rng(2)
    data = None
    for name, make in (("jax", jax_frag), ("port", port_frag)):
        f = make(tmp_path / name)
        f.set_bit(1, 5)
        rows = rng.integers(0, 3, 500).astype(np.uint64)
        f.bulk_import(rows, rows * 77) if name == "jax" \
            else f.import_bits(rows, rows * 77)
        f.close()
        data = (tmp_path / name).read_bytes() if data is None else data
    assert (tmp_path / "port").read_bytes() == data
    for cut in (7, 40):
        for name, make in (("jax", jax_frag), ("port", port_frag)):
            path = tmp_path / f"{name}{cut}"
            path.write_bytes(data[:-cut])
            f = make(path)
            assert f.tail_dropped_bytes > 0
            assert f.storage.contains(1 * SHARD_WIDTH + 5)
            f.close()
        assert (tmp_path / f"port{cut}").read_bytes() == \
            (tmp_path / f"jax{cut}").read_bytes()
        assert (tmp_path / f"port{cut}.torn").read_bytes() == \
            (tmp_path / f"jax{cut}.torn").read_bytes()
    for mod in (jfrag, tfrag):
        monkeypatch.setattr(mod, "MAX_TORN_TAIL_BYTES", 10)
    for name, make in (("jax", jax_frag), ("port", port_frag)):
        path = tmp_path / f"{name}big"
        path.write_bytes(data[:-40])
        with pytest.raises(ValueError, match="torn-append bound"):
            make(path)


def test_an_empty_fragment_file_opens_as_empty(tmp_path):
    """A file emptied by a crash before its header opens as an empty
    fragment that takes writes and reopens with them (the JAX fragment
    appends records to the empty file, which its next open refuses)."""
    path = tmp_path / "f"
    path.write_bytes(b"")
    f = port_frag(path)
    assert f.row_ids() == ()
    f.set_bit(2, 9)
    f.close()
    g = port_frag(path)
    assert g.row_ids() == (2,) and g.bit(2, 9)
    g.close()


def test_cache_sidecar_goes_cold_after_a_later_write(tmp_path):
    """A closed fragment's cache sidecar loads warm; a write after
    flush_cache (with no close) makes it load cold, in both."""
    for name, make in (("jax", jax_frag), ("port", port_frag)):
        f = make(tmp_path / name)
        for c in range(40):
            f.set_bit(c % 3, c)
        f.close()
        g = make(tmp_path / name)
        assert dict(g.cache.counts) == {0: 14, 1: 13, 2: 13}, name
        g.flush_cache()
        g.set_bit(4, 100)  # reaches the file, not the sidecar
        g.storage.op_writer = g._file = None  # dropped without close
        h = make(tmp_path / name)
        assert dict(h.cache.counts) == {}, name
        assert h.row_count(4) == 1
        h.close()
    assert (tmp_path / "port.cache").read_bytes() == \
        (tmp_path / "jax.cache").read_bytes()


# ---------------------------------------------------- data directory

DAY = datetime(2019, 1, 5, 10, 0)


def build_jax_dir(path):
    """A JAX Holder(path) with every field type, a keyed index, row and
    column attributes, and a write script; closed."""
    JAX_RANK_CACHE.clear()
    jh = JaxHolder(str(path))
    jh.open()
    api = JaxAPI(jh, stats=MemStatsClient())
    api.create_index("i")
    for name, opts in (("s", {}), ("l", {"cacheType": "lru"}),
                       ("n", {"cacheType": "none"}),
                       ("v", {"type": "int", "min": -50, "max": 5000}),
                       ("t", {"type": "time", "timeQuantum": "YMD"}),
                       ("m", {"type": "mutex"}), ("b", {"type": "bool"})):
        api.create_field("i", name, opts)
    rng = np.random.default_rng(21)
    cols = (rng.integers(0, 3, 4000) * SHARD_WIDTH
            + rng.integers(0, 50000, 4000)).astype(np.uint64)
    for name in ("s", "l", "n"):
        api.import_bits("i", name, rows=rng.integers(0, 7, 4000)
                        .astype(np.uint64), columns=cols)
    api.import_values("i", "v", columns=cols[:2000],
                      values=rng.integers(-50, 5001, 2000))
    days = rng.integers(0, 20, 1500)
    api.import_bits("i", "t", rows=rng.integers(0, 3, 1500).astype(np.uint64),
                    columns=cols[:1500],
                    timestamps=[datetime(2019, 1, 1 + int(d), 3).timestamp()
                                for d in days])
    api.import_bits("i", "m", rows=rng.integers(0, 4, 3000).astype(np.uint64),
                    columns=cols[:3000])
    api.import_bits("i", "b", rows=rng.integers(0, 2, 3000).astype(np.uint64),
                    columns=cols[1000:4000])
    api.create_index("k", keys=True)
    api.create_field("k", "kf", {"keys": True})
    api.import_bits("k", "kf", row_keys=[f"r{i % 5}" for i in range(300)],
                    column_keys=[f"c{i % 97}" for i in range(300)])
    for pql in WRITE_SCRIPT_1:
        api.executor.execute("i", pql)
    api.executor.execute("k", "Set('c3', kf='r9') "
                              "SetColumnAttrs('c5', tag='five')")
    api.executor.execute("k", "SetRowAttrs(kf, 'r2', grp='even')")
    jh.close()


WRITE_SCRIPT_1 = [
    "Set(5, s=1) Set(6, s=1) Clear(5, s=1)",
    f"Set({SHARD_WIDTH + 9}, t=2, 2019-01-07T04:00)",
    "Set(70001, v=4999) Clear(70001, v=4999) Set(70002, v=-3)",
    "Set(12, m=3) Set(12, m=1) Set(13, b=true)",
    "Store(Intersect(Row(s=1), Row(l=2)), s=9)", "ClearRow(l=3)",
    "SetRowAttrs(s, 1, cat='x', w=3) SetRowAttrs(s, 2, cat='y')",
    "SetRowAttrs(s, 4, cat='x') SetColumnAttrs(6, note='six')",
]

WRITE_SCRIPT_2 = [
    "Set(7, s=2) Clear(6, s=1)", f"Set({2 * SHARD_WIDTH + 3}, n=6)",
    "Set(77, t=1, 2019-01-12T01:00) Set(78, m=0) Set(79, b=false)",
    "Set(90, v=1234) ClearRow(s=5) Store(Row(l=1), l=8)",
    "SetRowAttrs(s, 2, cat='x') SetColumnAttrs(7, note='seven')",
]

READS = [
    "Count(Row(s=1))", "Row(s=2)", "TopN(s, n=3)", "TopN(s, n=3)",
    "TopN(l, n=3)", "TopN(n, n=3)", "TopN(n, n=3)", "TopN(s, Row(m=1), n=2)",
    "Row(t=1, from='2019-01-02T00:00', to='2019-01-09T00:00')",
    "Count(Row(t=0, from='2019-01-01T00:00', to='2019-02-01T00:00'))",
    "Sum(field=v)", "Sum(Row(s=3), field=v)", "Count(Row(v > 100))",
    "Rows(s)", "GroupBy(Rows(s), Rows(m))", "Row(b=true)", "Row(m=1)",
    "Options(Row(s=1), columnAttrs=true)", "Row(s=1)",
    "TopN(s, n=5, attrName='cat', attrValues=['x'])", "Not(Row(s=1))",
    "TopN(s, n=3)",
]
KEY_READS = ["Row(kf='r2')", "Count(Row(kf='r9'))", "TopN(kf, n=3)",
             "Options(Row(kf='r1'), columnAttrs=true)"]


def counters(ex):
    return (ex.topn_cache_hits, ex.topn_selfchecks, ex.rank_cache_hits,
            ex.rank_cache_patches, ex.rank_cache_rebuilds)


def read_both(jex, tex):
    """The read scripts through execute_full on both, answers and cache
    counters equal after every read; then one batch of them all."""
    for index, pqls in (("i", READS), ("k", KEY_READS)):
        for pql in pqls:
            want = jex.execute_full(index, pql)
            assert tex.execute_full(index, pql) == want, pql
            assert counters(tex) == counters(jex), pql
    reqs = [("i", q, None) for q in READS] + [("k", q, None)
                                             for q in KEY_READS]
    got = tex.execute_batch_shaped(reqs)
    assert got == jex.execute_batch_shaped(reqs)
    return got


def open_jax(path):
    JAX_RANK_CACHE.clear()
    jh = JaxHolder(str(path))
    jh.open()
    api = JaxAPI(jh, stats=MemStatsClient())
    api.executor.result_cache.enabled = False
    return jh, api.executor


def open_port(path):
    th = Holder(str(path), device="cpu")
    th.open()
    ex = API(th).executor
    ex.result_cache.enabled = False
    return th, ex


def test_directories_open_both_ways(tmp_path, monkeypatch):
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    monkeypatch.setattr(executor_mod, "TOPN_SELFCHECK_EVERY", 2)
    monkeypatch.setattr(jax_executor_mod, "TOPN_SELFCHECK_EVERY", 2)
    build_jax_dir(tmp_path)
    node_id = (tmp_path / ".id").read_text()
    jh, jex = open_jax(tmp_path)
    th, tex = open_port(tmp_path)
    assert th.node_id == node_id
    assert th.schema() == jh.schema()
    first = read_both(jex, tex)
    assert tex.topn_cache_hits > 0 and tex.rank_cache_rebuilds > 0
    assert tex.topn_selfcheck_mismatches == 0
    jh.close()
    for pql in WRITE_SCRIPT_2:
        tex.execute("i", pql)
    tex.execute("k", "Set('c200', kf='r0') SetRowAttrs(kf, 'r0', grp='x')")
    th.close()
    jh, jex = open_jax(tmp_path)
    th, tex = open_port(tmp_path)
    second = read_both(jex, tex)
    assert second != first
    jh.close()
    th.close()
    assert (tmp_path / ".id").read_text() == node_id


def test_written_files_hold_the_same_content(tmp_path, monkeypatch):
    """The same schema, keyed imports and attribute writes through both
    APIs: the .meta files hold the same JSON, the key logs and the
    attribute logs and snapshots the same bytes, .id a 32-digit hex."""
    monkeypatch.setattr(jfrag, "OPLOG_FOLD_MIN_BYTES", 1 << 30)
    outs = {}
    for name, api in (("jax", None), ("port", None)):
        path = tmp_path / name
        if name == "jax":
            h = JaxHolder(str(path))
            h.open()
            api = JaxAPI(h, stats=MemStatsClient())
        else:
            h = Holder(str(path), device="cpu")
            h.open()
            api = API(h)
        api.create_index("k", keys=True, track_existence=False)
        api.create_index("p")
        api.create_field("k", "kf", {"keys": True, "cacheType": "lru"})
        api.create_field("p", "v", {"type": "int", "min": 0, "max": 9})
        api.create_field("p", "t", {"type": "time", "timeQuantum": "YM"})
        api.import_bits("k", "kf", row_keys=["b", "a", "b", "ü"],
                        column_keys=["x", "y", "z", "x"])
        api.executor.execute("k", "Set('w', kf='c') SetRowAttrs(kf, 'a', n=1)"
                                  " SetColumnAttrs('y', s='t')")
        api.executor.execute("p", "SetColumnAttrs(3, q=[1, 2])")
        h.close()
        outs[name] = {
            os.path.relpath(os.path.join(root, f), path):
                open(os.path.join(root, f), "rb").read()
            for root, _, files in os.walk(path) for f in files
            if not f.isdigit() and not f.endswith(".cache")}
    jax_files, port_files = outs["jax"], outs["port"]
    assert sorted(port_files) == sorted(jax_files)
    for rel, want in jax_files.items():
        got = port_files[rel]
        if rel == ".id":
            assert len(got) == 32 and int(got, 16) >= 0
        elif rel.endswith(".meta"):
            assert json.loads(got) == json.loads(want), rel
        else:
            assert got == want, rel
    assert jax_files["k/.keys"].startswith(b"PTLT")


def test_translate_log_torn_tail(tmp_path):
    """A record torn at the end: the port cuts it at open, so keys
    allocated after it survive the next open; the JAX store appends
    after the torn bytes and its next open misreads them (a reference
    fault, ROADMAP.md)."""
    for name, cls in (("jax", JaxTranslateStore), ("port", TranslateStore)):
        path = str(tmp_path / name)
        s = cls(path)
        s.open()
        for k in ("alpha", "beta", "gamma"):
            s.translate_key(k)
        s.close()
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        s = cls(path)
        s.open()
        assert [s.translate_key(k) for k in ("alpha", "beta")] == [1, 2]
        assert s.translate_key("delta") == 3
        assert s.translate_key("epsilon") == 4
        s.close()
        s = cls(path)
        s.open()
        got = sorted(s.entries(), key=lambda kv: kv[1])
        s.close()
        if name == "port":
            assert got == [("alpha", 1), ("beta", 2), ("delta", 3),
                           ("epsilon", 4)]
        else:  # the reference fault: delta and epsilon are lost
            assert ("delta", 3) not in got and ("epsilon", 4) not in got
            assert got[:2] == [("alpha", 1), ("beta", 2)]


def test_translate_batch_log_is_the_jax_log(tmp_path):
    """A batch of new keys is one write of the bytes the JAX store
    writes a key at a time; log_bytes, apply_log and apply_entries as
    the JAX store has them."""
    keys = [f"k{i % 37}-{'x' * (i % 5)}" for i in range(200)]
    j = JaxTranslateStore(str(tmp_path / "j"))
    j.open()
    t = TranslateStore(str(tmp_path / "t"))
    t.open()
    np.testing.assert_array_equal(t.translate_keys(keys),
                                  j.translate_keys(keys))
    t.apply_entries([("far", 5000)])
    j.apply_entries([("far", 5000)])
    assert t.translate_key("next") == j.translate_key("next")
    j.close()
    t.close()
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert t.log_bytes() == j.log_bytes()
    fresh = TranslateStore()
    assert fresh.apply_log(j.log_bytes()) == j.size()
    assert fresh.entries() == j.entries()


def test_attr_log_torn_line_and_compaction(tmp_path, monkeypatch):
    """A torn last log line is cut at open; past LOG_COMPACT_ENTRIES the
    log folds into the snapshot, in both packages, to the same files."""
    from pilosa_tpu.core import attrs as jattrs
    from pilosa_tpu_torch.core import attrs as tattrs
    monkeypatch.setattr(jattrs, "LOG_COMPACT_ENTRIES", 7)
    monkeypatch.setattr(tattrs, "LOG_COMPACT_ENTRIES", 7)
    for name, mod in (("jax", jattrs), ("port", tattrs)):
        path = str(tmp_path / name)
        s = mod.AttrStore(path)
        s.open()
        for i in range(10):
            s.set(i % 4, {"n": i, "drop": None if i % 3 else True})
        s.close()
        with open(path + ".log", "ab") as f:
            f.write(b'{"1":{"n":')
        s = mod.AttrStore(path)
        s.open()
        s.set_bulk({9: {"z": [1]}})
        s.close()
    for suffix in ("", ".log"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()


def _get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("cut", [0, 7, 40])
def test_info_reports_torn_tail_bytes_like_jax(tmp_path, cut):
    """A data directory whose fragment op log lost its last ``cut``
    bytes: after a reopen, ``API.info()`` and ``GET /info`` carry
    ``tailDroppedBytes``, equal to the JAX package's over a copy of the
    same directory (0 when nothing was cut)."""
    src = tmp_path / "src"
    jh = JaxHolder(str(src))
    jh.open()
    api = JaxAPI(jh, stats=MemStatsClient())
    api.create_index("i")
    api.create_field("i", "s", {})
    for c in range(12):
        api.executor.execute("i", f"Set({c * 7}, s={c % 3})")
    jh.close()
    frags = sorted(os.path.join(root, f) for root, _, files in os.walk(src)
                   for f in files if f.isdigit())
    assert frags
    if cut:
        data = open(frags[0], "rb").read()
        with open(frags[0], "wb") as f:
            f.write(data[:-cut])
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    JAX_RANK_CACHE.clear()
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "port"), device="cpu")
    th.open()
    japi, tapi = JaxAPI(jh, stats=MemStatsClient()), API(th)
    want = japi.info()["tailDroppedBytes"]
    assert (want > 0) == (cut > 0)
    assert tapi.info()["tailDroppedBytes"] == want == th.tail_dropped_bytes()
    servers = [jax_serve(japi, "localhost", 0, background=True),
               serve(tapi, "localhost", 0, background=True)]
    try:
        got = [_get_json(f"http://localhost:{s.server_address[1]}", "/info")
               for s in servers]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        jh.close()
        th.close()
    assert got[1]["tailDroppedBytes"] == got[0]["tailDroppedBytes"] == want
    assert got[1]["device"] == "cpu"
