"""The port's memory budget, memory ledger and hybrid sparse layout
against the JAX package, on the same seeded inputs, exact equality
unless stated:

- the expansion's plain version (``kernels.expand_positions_ref``)
  against the JAX ``expand_positions`` and the sparse upload against
  ``_expand_sparse_chunk``; the Hopper kernel's tiled algorithm,
  emulated on the CPU with its launch geometry and slot transports, at
  tile-boundary shapes, with shuffled and repeated positions;
- ``SparseBank`` arrays against the JAX ``sparse_bank`` on the index of
  ``tests/test_layout.py``;
- that file's fourteen queries through ``execute`` and ``execute_batch``
  (megakernel on and off), dense and sparse, against the JAX executor in
  both layouts;
- the staged banks of a fingerprint-shaped burst (row-subset banks of an
  over-budget view), and the staging of sparse leaves;
- ``Lowering`` of ``xslot`` nodes, ``verify_plan``'s expand typing (the
  same verdicts and messages) and ``plan_opt`` over expand registers;
- ``BankBudget`` eviction order, ``relayout_once`` summaries and ledger
  deltas, ``MemoryLedger`` bookkeeping and ``WorkloadRecorder`` rates
  under a synthetic clock;
- the too-dense self-heal and a write after demotion."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.core import layout as jlayout_mod
from pilosa_tpu.core import view as jview_mod
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import executor as jex_mod
from pilosa_tpu.executor import megakernel as jmegamod
from pilosa_tpu.ops import megakernel as jmk
from pilosa_tpu.ops import plan_opt as jplan_opt
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.utils import hotspots as jhotspots
from pilosa_tpu.utils import memledger as jmemledger
from pilosa_tpu.utils.hotspots import WORKLOAD as JWORKLOAD
from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.core import layout as layout_mod
from pilosa_tpu_torch.core import view as view_mod
from pilosa_tpu_torch.core.layout import LayoutManager
from pilosa_tpu_torch.core.view import BankBudget, SparseBank, ViewBank
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops import megakernel as mk
from pilosa_tpu_torch.ops import plan_opt
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.utils import hotspots, memledger
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from tools.planverify import PLAN_MUTATIONS, clone_plan, mutate_plan, \
    synthetic_plans

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_workload():
    WORKLOAD.reset()
    JWORKLOAD.reset()
    yield
    WORKLOAD.reset()
    JWORKLOAD.reset()


@pytest.fixture
def clock(monkeypatch):
    """One synthetic clock for both packages' process-wide recorders."""
    now = [1000.0]
    monkeypatch.setattr(WORKLOAD, "clock", lambda: now[0])
    monkeypatch.setattr(JWORKLOAD, "clock", lambda: now[0])
    return now


# ------------------------------------------------------------ expansion


def _encoded_case(rng, n_rows, n_shards, width, widen=0):
    """Sorted unique positions per (row, shard), encoded (shard << 16) |
    bitpos and laid out row by row, shard-ascending, with offsets per row
    slot; ``widen`` words of positions beyond width * 32 (a view widened
    after the build). Some rows are empty."""
    parts, lens = [], []
    for r in range(n_rows):
        row = []
        if r % 5 != 3:
            for sh in range(n_shards):
                k = int(rng.integers(0, 40))
                bits = np.unique(rng.integers(
                    0, (width + widen) * 32, k)).astype(np.uint32)
                row.append(bits | np.uint32(sh << 16))
        cat = np.concatenate(row) if row else np.empty(0, np.uint32)
        parts.append(cat)
        lens.append(len(cat))
    cap = 1
    while cap < n_rows + 1:
        cap *= 2
    starts = np.zeros(cap + 1, np.int64)
    np.cumsum(lens, out=starts[1:n_rows + 1])
    starts[n_rows + 1:] = starts[n_rows]
    total = int(starts[n_rows])
    pos = np.zeros(max(1024, 1 << max(0, total - 1).bit_length()),
                   np.uint32)
    pos[:total] = np.concatenate(parts) if parts else []
    return pos, starts.astype(np.int32), cap


@pytest.mark.parametrize("n_shards,width,widen", [
    (1, 128, 0), (1, 128, 64), (2, 128, 0), (2, 2048, 0), (1, 2048, 0),
    (2, 128, 32)])
def test_expand_ref_matches_jax(n_shards, width, widen):
    rng = np.random.default_rng(n_shards * 1000 + width + widen)
    pos, starts, cap = _encoded_case(rng, 13, n_shards, width, widen)
    slots = np.asarray([0, 3, 12, cap - 1, 5, 3], np.int32)  # zero slot
    want = np.asarray(jax.vmap(lambda r: jmk.expand_positions(
        jnp.asarray(pos), jnp.asarray(starts), r, n_shards, width))(
            jnp.asarray(slots)))
    got = kernels.expand_positions_ref(
        torch.from_numpy(pos.view(np.int32)), torch.from_numpy(starts),
        torch.from_numpy(slots), n_shards, width)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (len(slots), n_shards, width)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The wrapper takes the plain path on the CPU and launches nothing.
    before = dict(kernels.LAUNCHES)
    via = kernels.expand_positions(
        torch.from_numpy(pos.view(np.int32)), torch.from_numpy(starts),
        slots, n_shards, width)
    assert torch.equal(via, got) and kernels.LAUNCHES == before


@pytest.mark.parametrize("width", [128, 2048])
def test_sparse_upload_matches_jax(width):
    """The sparse upload's [cap, 1, width] bank: present rows (some
    absent) with their sorted unique u16 positions back to back."""
    rng = np.random.default_rng(width)
    rows, cap = 37, 64
    per = [np.unique(rng.integers(0, width * 32, int(rng.integers(1, 60))))
           for _ in range(rows)]
    present = np.asarray([r for r in range(rows) if r not in (0, 7, 8)],
                         np.int64)
    pos16 = np.concatenate([per[r] for r in present]).astype(np.uint16)
    lens = np.asarray([len(per[r]) for r in present], np.int64)
    want = np.asarray(jview_mod._expand_sparse_chunk(pos16, lens, present,
                                                     cap, width))
    got = view_mod._expand_sparse_chunk(pos16, lens, present, cap, width,
                                        CPU)
    assert tuple(got.shape) == (cap, 1, width)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("case", ["dtype", "rank", "slot", "width"])
def test_expand_wrapper_refuses_bad_operands(case):
    pos = torch.zeros(1024, dtype=torch.int32)
    starts = torch.zeros(5, dtype=torch.int32)
    slots = np.asarray([0, 1], np.int32)
    n, width = 1, 128
    if case == "dtype":
        pos = pos.to(torch.int64)
    elif case == "rank":
        starts = starts.reshape(1, 5)
    elif case == "slot":
        slots = np.asarray([4], np.int32)
    else:
        width = -1
    with pytest.raises((TypeError, ValueError)):
        kernels.expand_positions(pos, starts, slots, n, width)


def _emulate_tiled(pos, starts, slots, n_shards, width):
    """``csrc/sparse_expand.cu``'s algorithm on the CPU, block by block,
    with ``kernels.expand_geometry`` and ``kernels.expand_transport``:
    each unit (row, tile) zeroes its tile, ORs in the row's positions
    that fall inside it, and stores it as the kernel does (scalar words
    up to a 16-byte boundary, 4-word stores, a scalar tail) into an
    output of garbage. Every output word must be stored exactly once and
    the 4-word stores must be aligned; returns int32 [n, n_shards,
    width]."""
    slots = np.asarray(slots, np.int32)
    n = len(slots)
    geo = kernels.expand_geometry(n, n_shards, width)
    kind, first = kernels.expand_transport(slots)
    rw, tw = geo["row_words"], geo["tile_words"]
    tiles, units = geo["tiles_per_row"], geo["units_per_block"]
    assert tw % 4 == 0 and units * tw <= kernels.EXPAND_TILE_WORDS
    assert kernels.EXPAND_THREADS // units >= 8
    assert (tiles - 1) * tw < max(rw, 1) <= tiles * tw
    if kind == "param":
        assert 1 < n <= kernels.EXPAND_PARAM_SLOTS
    pos = pos.view(np.uint32)
    out = np.full(n * rw, 0xA5A5A5A5, np.uint32)
    stores = np.zeros(n * rw, np.int64)
    for block in range(geo["blocks"]):
        for group in range(units):
            unit = block * units + group
            if unit >= n * tiles:
                continue
            k, t = divmod(unit, tiles)
            t0 = t * tw
            length = min(tw, rw - t0)
            s = first + k if kind == "range" else int(slots[k])
            tile = np.zeros(tw, np.uint32)
            p = pos[starts[s]:starts[s + 1]]
            shard, bit = p >> 16, p & 0xFFFF
            keep = (shard < n_shards) & (bit < width * 32)
            shard, bit = shard[keep].astype(np.int64), bit[keep]
            w = shard * width + (bit >> 5) - t0
            inside = (w >= 0) & (w < length)
            np.bitwise_or.at(tile, w[inside],
                             np.left_shift(np.uint32(1),
                                           bit[inside] & np.uint32(31)))
            at = k * rw + t0
            head = min(length, (-at) % 4)
            body_end = head + ((length - head) & ~3)
            assert (at + head) % 4 == 0 or body_end == head
            for lo, hi in ((0, head), (head, body_end), (body_end, length)):
                out[at + lo:at + hi] = tile[lo:hi]
                stores[at + lo:at + hi] += 1
    assert (stores == 1).all()
    return out.view(np.int32).reshape(n, n_shards, width)


def _jax_expand(pos, starts, slots, n_shards, width):
    if len(slots) == 0:
        return np.zeros((0, n_shards, width), np.uint32)
    return np.asarray(jax.vmap(lambda r: jmk.expand_positions(
        jnp.asarray(pos), jnp.asarray(starts), r, n_shards, width))(
            jnp.asarray(slots)))


def _shuffled_rows(rng, pos, starts, cap):
    """The same rows with each row's positions in a random order."""
    out = pos.copy()
    for r in range(cap):
        out[starts[r]:starts[r + 1]] = rng.permutation(
            pos[starts[r]:starts[r + 1]])
    return out


# (rows, n_shards, width, slots kind): tile-boundary shapes and each
# slot transport. 8192 words is exactly one tile, 8193 one word over;
# 99 and 5 words are not multiples of 4.
TILED = [
    (70, 1, 128, "param"), (40, 1, 128, "range"), (3, 4, 2048, "range"),
    (3, 4, 2048, "param"), (3, 3, 2731, "param"), (3, 3, 2731, "range"),
    (3, 96, 2048, "param"), (1, 96, 2048, "one"), (30, 3, 33, "param"),
    (30, 1, 5, "range"), (20, 2, 128, "device"), (20, 1, 7, "device"),
    (20, 1, 128, "none"), (600, 1, 64, "range"), (12, 1, 2048, "param"),
]


@pytest.mark.parametrize("rows,n_shards,width,kind", TILED,
                         ids=[f"{r}x{s}x{w}-{k}" for r, s, w, k in TILED])
def test_tiled_expansion_matches_ref_and_jax(rows, n_shards, width, kind):
    """The kernel's tiled algorithm, emulated, against the plain version
    and the JAX ``expand_positions``, in the builds' sorted order and
    with each row's positions shuffled (the kernel does not rely on the
    order)."""
    rng = np.random.default_rng(rows * 7 + n_shards * 13 + width)
    pos, starts, cap = _encoded_case(rng, rows, n_shards, width,
                                     widen=32 if width == 128 else 0)
    if kind == "range":
        slots = np.arange(cap, dtype=np.int32)
    elif kind == "one":
        slots = np.asarray([cap - 1], np.int32)
    elif kind == "none":
        slots = np.zeros(0, np.int32)
    elif kind == "param":
        slots = np.concatenate([rng.permutation(cap), [cap - 1, 0]]) \
            .astype(np.int32)
    else:
        slots = rng.integers(0, cap, kernels.EXPAND_PARAM_SLOTS + 40) \
            .astype(np.int32)
    want_kind = {"one": "range", "none": "range"}.get(kind, kind)
    assert kernels.expand_transport(slots)[0] == want_kind
    want = _jax_expand(pos, starts, slots, n_shards, width)
    ref = kernels.expand_positions_ref(
        torch.from_numpy(pos.view(np.int32)), torch.from_numpy(starts),
        torch.from_numpy(slots), n_shards, width)
    np.testing.assert_array_equal(ref.numpy().view(np.uint32), want)
    for p in (pos, _shuffled_rows(rng, pos, starts, cap)):
        got = _emulate_tiled(p, starts, slots, n_shards, width)
        np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("rows,n_shards,width,kind", [
    (70, 1, 128, "param"), (100, 1, 5, "range"), (40, 3, 33, "device"),
    (40, 2, 2048, "range")])
def test_tiled_expansion_packs_rows(monkeypatch, rows, n_shards, width,
                                    kind):
    """With the grid target lowered, rows of one tile share blocks (up
    to EXPAND_MAX_UNITS, 8 threads each): the emulated kernel still
    equals the plain version and the JAX ``expand_positions``."""
    monkeypatch.setattr(kernels, "EXPAND_TARGET_BLOCKS", 2)
    rng = np.random.default_rng(rows + width)
    pos, starts, cap = _encoded_case(rng, rows, n_shards, width)
    slots = {"range": np.arange(cap),
             "param": np.concatenate([rng.permutation(cap), [cap - 1, 0]]),
             "device": rng.integers(0, cap, kernels.EXPAND_PARAM_SLOTS + 9)
             }[kind].astype(np.int32)
    geo = kernels.expand_geometry(len(slots), n_shards, width)
    assert geo["units_per_block"] > 1
    want = _jax_expand(pos, starts, slots, n_shards, width)
    got = _emulate_tiled(_shuffled_rows(rng, pos, starts, cap), starts,
                         slots, n_shards, width)
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_tiled_expansion_sets_a_duplicated_bit_once():
    """A position repeated within a row sets its bit once (the kernel
    ORs); the sum-based versions would carry, so the expected rows are
    the plain version's over the positions without the repeats."""
    rng = np.random.default_rng(4)
    pos, starts, cap = _encoded_case(rng, 9, 2, 128)
    dup = np.concatenate([np.concatenate([
        pos[starts[r]:starts[r + 1]],
        pos[starts[r]:starts[r + 1]][::3]]) for r in range(cap)])
    lens = [(starts[r + 1] - starts[r]) + len(range(0, starts[r + 1]
                                                    - starts[r], 3))
            for r in range(cap)]
    dstarts = np.zeros(cap + 1, np.int32)
    np.cumsum(lens, out=dstarts[1:])
    slots = rng.permutation(cap).astype(np.int32)
    want = kernels.expand_positions_ref(
        torch.from_numpy(pos.view(np.int32)), torch.from_numpy(starts),
        torch.from_numpy(slots), 2, 128)
    got = _emulate_tiled(_shuffled_rows(rng, dup, dstarts, cap), dstarts,
                         slots, 2, 128)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n,n_shards,width", [
    (65, 1, 128), (1, 1, 128), (3, 1, 128), (4, 1, 2048), (9, 1, 2048),
    (2, 4, 2048), (2, 3, 2731), (1, 96, 2048), (5, 3, 33), (7, 1, 1),
    (0, 1, 128), (100000, 1, 128), (65536, 1, 128), (8192, 1, 128),
    (600, 1, 2048), (3000, 1, 2048)])
def test_expand_geometry_fits_the_block(n, n_shards, width):
    """Tiles are multiples of 4 words; a block's tiles fit its shared
    memory; every unit has at least 8 threads; rows of one tile are
    packed only while the grid keeps EXPAND_TARGET_BLOCKS blocks, wider
    rows cut into EXPAND_TILE_WORDS tiles one a block; the grid covers
    every unit."""
    g = kernels.expand_geometry(n, n_shards, width)
    rw = n_shards * width
    assert g["row_words"] == rw and g["tile_words"] % 4 == 0
    assert g["units_per_block"] * g["tile_words"] <= kernels.EXPAND_TILE_WORDS
    assert kernels.EXPAND_THREADS // g["units_per_block"] >= 8
    assert g["tiles_per_row"] * g["tile_words"] >= rw
    assert (g["tiles_per_row"] - 1) * g["tile_words"] < max(rw, 1)
    assert g["blocks"] * g["units_per_block"] >= n * g["tiles_per_row"]
    assert (g["blocks"] - 1) * g["units_per_block"] < max(
        n * g["tiles_per_row"], 1)
    if rw <= kernels.EXPAND_TILE_WORDS:
        assert g["tiles_per_row"] == 1 and g["tile_words"] < rw + 4
        units = g["units_per_block"]
        assert units == 1 or g["blocks"] >= kernels.EXPAND_TARGET_BLOCKS
        assert units == min(kernels.EXPAND_MAX_UNITS, 1 << (
            (kernels.EXPAND_TILE_WORDS // g["tile_words"]).bit_length()
            - 1)) or -(-n // (2 * units)) < kernels.EXPAND_TARGET_BLOCKS
    else:
        assert g["units_per_block"] == 1
        assert g["tile_words"] == kernels.EXPAND_TILE_WORDS


# ------------------------------------------------ the test_layout index


def _layout_data(sparse_rows=600, seed=5, two_shards=True):
    """tests/test_layout.py's _build, as numpy arrays: a narrow sparse
    field "s", a dense field "f" and the existence columns."""
    rng = np.random.default_rng(seed)
    s_rows = np.repeat(np.arange(sparse_rows, dtype=np.uint64), 2)
    s_cols = rng.integers(0, 4096, 2 * sparse_rows).astype(np.uint64)
    if two_shards:
        half = len(s_cols) // 2
        s_cols[half:] += SHARD_WIDTH
    f_rows = rng.integers(0, 8, 6000).astype(np.uint64)
    f_cols = rng.integers(0, 2 * SHARD_WIDTH, 6000).astype(np.uint64)
    return s_rows, s_cols, f_rows, f_cols


def _pair(tmp_path, **kw):
    s_rows, s_cols, f_rows, f_cols = _layout_data(**kw)
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(device="cpu")
    for h in (jh, th):
        idx = h.create_index("i")
        idx.create_field("s").import_bits(s_rows, s_cols)
        idx.create_field("f").import_bits(f_rows, f_cols)
        idx.add_existence(np.concatenate([s_cols, f_cols]))
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    return jh, th, jex, tex


QUERIES = (
    ["Count(Row(s={r}))".format(r=r) for r in range(6)]
    + ["Row(s=2)", "Row(s=999)", "Count(Row(s=9999))",
       "Count(Intersect(Row(s=1), Row(f=1)))",
       "Count(Union(Row(s=2), Row(s=3), Row(f=2)))",
       "Count(Difference(Row(f=3), Row(s=3)))",
       "Count(Xor(Row(s=4), Row(f=4)))",
       "Count(Not(Row(s=5)))"]
)


def _results(ex, queries):
    out = []
    for q in queries:
        (res,) = ex.execute("i", q)
        out.append(np.asarray(res.columns(), np.uint64).tolist()
                   if hasattr(res, "columns") else int(res))
    return out


@pytest.mark.parametrize("two_shards", [True, False])
def test_sparse_bank_arrays_match_jax(tmp_path, two_shards):
    jh, th, _, _ = _pair(tmp_path, two_shards=two_shards)
    try:
        shards = (0, 1) if two_shards else (0,)
        want = jh.index("i").field("s").view("standard").sparse_bank(shards)
        got = th.index("i").field("s").view("standard").sparse_bank(shards)
        assert isinstance(got, SparseBank)
        pos, starts = got.arrays
        assert pos.dtype == torch.int32 and starts.dtype == torch.int32
        np.testing.assert_array_equal(pos.numpy().view(np.uint32),
                                      np.asarray(want.arrays[0]))
        np.testing.assert_array_equal(starts.numpy(),
                                      np.asarray(want.arrays[1]))
        assert (got.zero_slot, got.nbytes, got.width, got.n_shards,
                got.n_rows) == (want.zero_slot, want.nbytes, want.width,
                                want.n_shards, want.n_rows)
        assert dict(got.slots) == dict(want.slots)
        assert got.slot(10 ** 6) == want.slot(10 ** 6) == got.zero_slot
        view = th.index("i").field("s").view("standard")
        assert view.sparse_bank(shards) is got  # cached while unchanged
        info = memledger.LEDGER.entry_info(
            ("sparse_bank",), (id(view), ("sbank", shards, got.width)))
        jinfo = jmemledger.LEDGER.entry_info(
            ("sparse_bank",), (id(jh.index("i").field("s").view("standard")),
                               ("sbank", shards, want.width)))
        assert info == jinfo
    finally:
        jh.close()


def test_sparse_bank_gathers_in_chunks_like_one_call(tmp_path, monkeypatch):
    """The chunked gather builds the same arrays as the whole-view one."""
    jh, th, _, _ = _pair(tmp_path, two_shards=False)
    try:
        want = jh.index("i").field("s").view("standard").sparse_bank((0,))
        monkeypatch.setattr(view_mod, "PBANK_GATHER_ROWS", 64)
        got = th.index("i").field("s").view("standard").sparse_bank((0,))
        np.testing.assert_array_equal(got.arrays[0].numpy().view(np.uint32),
                                      np.asarray(want.arrays[0]))
        np.testing.assert_array_equal(got.arrays[1].numpy(),
                                      np.asarray(want.arrays[1]))
    finally:
        jh.close()


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_queries_match_jax_in_both_layouts(tmp_path, monkeypatch, layout):
    jh, th, jex, tex = _pair(tmp_path)
    try:
        dense = _results(tex, QUERIES)
        assert dense == _results(jex, QUERIES)
        for h in (jh, th):
            h.index("i").field("s").view("standard").set_layout(layout)
        launches = kernels.LAUNCHES["expand_positions"]
        assert _results(tex, QUERIES) == dense
        assert _results(jex, QUERIES) == dense
        assert kernels.LAUNCHES["expand_positions"] == launches  # CPU
        reqs = [("i", q, None) for q in QUERIES]
        for mega in (True, False):
            monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", mega)
            monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", mega)
            launched = tex.mega_launches
            assert tex.execute_batch_shaped(reqs) == \
                jex.execute_batch_shaped(reqs)
            assert (tex.mega_launches > launched) == mega
        view = th.index("i").field("s").view("standard")
        assert view.layout_mode == layout
        kinds = {type(b).__name__ for b in view._bank_cache.values()}
        assert kinds == ({"SparseBank"} if layout == "sparse"
                         else {"ViewBank"})
    finally:
        jh.close()


def _staged(ex, idx, pql, parse):
    call = parse(pql).calls[0]
    mode = "row"
    if call.name == "Count":
        call, mode = call.children[0], "count"
    return ex._stage_tree(idx, call, [0, 1], mode)


@pytest.mark.parametrize("pql", [
    "Count(Row(s=1))", "Count(Intersect(Row(s=1), Row(f=1)))",
    "Union(Row(s=2), Row(s=3), Row(f=2))", "Count(Not(Row(s=5)))"])
def test_sparse_staging_matches_jax(tmp_path, pql):
    jh, th, jex, tex = _pair(tmp_path)
    try:
        for h in (jh, th):
            h.index("i").field("s").view("standard").set_layout("sparse")
        want = _staged(jex, jh.index("i"), pql, jax_parse)
        got = _staged(tex, th.index("i"), pql, parse_string)
        assert got.sig == want.sig and "x" in got.sig
        assert got.ir == want.ir
        assert got.idxs == list(want.idxs)
        shapes = [tuple(tuple(x.shape) for x in a) if isinstance(a, tuple)
                  else tuple(a.shape) for a in got.bank_arrays]
        jshapes = [tuple(tuple(x.shape) for x in a) if isinstance(a, tuple)
                   else tuple(a.shape) for a in want.bank_arrays]
        assert shapes == jshapes
    finally:
        jh.close()


def test_kill_switch_plans_dense(tmp_path, monkeypatch):
    _, th, _, tex = _pair(tmp_path, two_shards=False)
    view = th.index("i").field("s").view("standard")
    view.set_layout("sparse")
    monkeypatch.setattr(layout_mod, "HYBRID_LAYOUT_ENABLED", False)
    staged = _staged(tex, th.index("i"), "Row(s=1)", parse_string)
    assert not any(isinstance(a, tuple) for a in staged.bank_arrays)
    assert LayoutManager(th).relayout_once() == {"ran": False,
                                                 "reason": "disabled"}
    monkeypatch.setattr(layout_mod, "HYBRID_LAYOUT_ENABLED", True)
    staged = _staged(tex, th.index("i"), "Row(s=1)", parse_string)
    assert any(isinstance(a, tuple) for a in staged.bank_arrays)


# ------------------------------------------- the staged row-subset banks


FP = {"max_columns": 4096, "cache_type": "none"}


def _fingerprint_pair(tmp_path, n=3000, seed=9):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.uint64), 12)
    cols = rng.integers(0, 4096, n * 12).astype(np.uint64)
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(device="cpu")
    jh.create_index("fp").create_field(
        "fingerprint", JaxFieldOptions(**FP)).import_bits(rows, cols)
    th.create_index("fp").create_field(
        "fingerprint", FieldOptions(**FP)).import_bits(rows, cols)
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    jex.result_cache.enabled = False
    tex.result_cache.enabled = False
    return jh, th, jex, tex


BURST = ([f"Count(Intersect(Row(fingerprint=7), Row(fingerprint={c})))"
          for c in (1, 2, 3, 500, 2999, 7)]
         + ["Count(Union(Row(fingerprint=1), Row(fingerprint=2)))",
            "Count(Difference(Row(fingerprint=7), Row(fingerprint=3)))",
            "Count(Xor(Row(fingerprint=500), Row(fingerprint=1)))"])


def _bank_shapes(staged):
    return [tuple(tuple(x.shape) for x in a) if isinstance(a, tuple)
            else tuple(a.shape) for a in staged.bank_arrays]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_burst_stages_row_subset_banks_like_jax(tmp_path, monkeypatch,
                                                layout):
    """The repair: over an over-budget view a burst stages banks of the
    rows each tree reads, never the full view bank."""
    monkeypatch.setattr(ex_mod.Executor, "BANK_MAX_BYTES", 1 << 16)
    monkeypatch.setattr(jex_mod.Executor, "BANK_MAX_BYTES", 1 << 16)
    jh, th, jex, tex = _fingerprint_pair(tmp_path)
    try:
        for h in (jh, th):
            h.index("fp").field("fingerprint").view().set_layout(layout)
        got = [_bank_shapes(_staged(tex, th.index("fp"), q, parse_string))
               for q in BURST]
        want = [_bank_shapes(_staged(jex, jh.index("fp"), q, jax_parse))
                for q in BURST]
        assert got == want
        if layout == "dense":
            assert all(s[0][0] <= 4 for s in got), got
        view = th.index("fp").field("fingerprint").view()
        assert all(b.array.shape[0] <= 4 for b in view._bank_cache.values()
                   if isinstance(b, ViewBank))
        reqs = [("fp", q, None) for q in BURST]
        monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
        monkeypatch.setattr(jmegamod, "MEGAKERNEL_ENABLED", True)
        launched = tex.mega_launches
        assert tex.execute_batch_shaped(reqs) == \
            jex.execute_batch_shaped(reqs)
        assert tex.mega_launches == launched + 1
    finally:
        jh.close()


# ------------------------------------------------- lowering and verify


def _xpair_np(rows, positions=1024):
    return (np.zeros(positions, np.int32), np.zeros(rows + 1, np.int32))


def _sparse_entries(seed):
    """Random entries over two dense banks and two sparse pairs, with
    shared rows, every fold and a threshold."""
    rng = np.random.default_rng(seed)
    banks = [np.zeros((8, 2, 16), np.uint32), np.zeros((8, 2, 8),
                                                       np.uint32)]
    pairs = [_xpair_np(16), _xpair_np(6)]
    operands = banks + pairs
    entries = []
    for _ in range(int(rng.integers(3, 9))):
        n = int(rng.integers(1, 5))
        ir, idxs = [], []
        for i in range(n):
            pos = int(rng.integers(0, 4))
            kind = "slot" if pos < 2 else "xslot"
            rows = 8 if pos < 2 else (16 if pos == 2 else 6)
            ir.append((kind, pos, i))
            idxs.append(int(rng.integers(0, rows)))
        if n > 1:
            op = ["and", "or", "xor", "diff"][int(rng.integers(0, 4))]
            ir.append(("fold", op, n) if rng.random() < 0.8
                      else ("thresh", 2, n))
        entries.append((tuple(ir), operands, idxs, [], 16,
                        "count" if rng.random() < 0.7 else "row"))
    return entries


def _lower(module, entries):
    low = module.Lowering()
    lanes = [low.add_entry(*e) for e in entries]
    return low.finish(), lanes


def _assert_same_plan(got, want):
    for name in ("instrs", "widths", "out_count", "out_row"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("n_slots", "n_xslots", "n_regs", "n_instrs",
                 "lane_count_widths", "lane_row_widths"):
        assert getattr(got, name) == getattr(want, name), name
    for a, b in ((got.slots, want.slots), (got.xslots, want.xslots)):
        assert len(a) == len(b)
        for g, w in zip(a, b):
            np.testing.assert_array_equal(g, w)
    assert [id(b) for b in got.banks] == [id(b) for b in want.banks]
    assert [id(b) for b in got.xbanks] == [id(b) for b in want.xbanks]


@pytest.fixture
def no_densities(monkeypatch):
    from collections import OrderedDict
    monkeypatch.setattr(jplan_opt, "_density", OrderedDict())
    monkeypatch.setattr(plan_opt, "_density", OrderedDict())


@pytest.mark.parametrize("seed", range(6))
def test_xslot_lowering_and_optimizer_match_jax(seed, no_densities):
    entries = _sparse_entries(seed)
    got, got_lanes = _lower(mk, entries)
    want, want_lanes = _lower(jmk, entries)
    assert got_lanes == want_lanes and got.n_xslots > 0
    _assert_same_plan(got, want)
    assert got.sig(2, 16) == want.sig(2, 16)
    mk.verify_plan(got, 2, 16)
    got_opt, got_stats = plan_opt.optimize_plan(got, 2, 16)
    want_opt, want_stats = jplan_opt.optimize_plan(want, 2, 16)
    _assert_same_plan(got_opt, want_opt)
    assert (got_stats.cse_hits, got_stats.folds_reordered,
            got_stats.narrowed_lanes) == (want_stats.cse_hits,
                                          want_stats.folds_reordered,
                                          want_stats.narrowed_lanes)
    mk.verify_plan(got_opt, 2, 16)


def _to_port(plan):
    return mk.Plan(banks=plan.banks, slots=plan.slots, widths=plan.widths,
                   instrs=plan.instrs, out_count=plan.out_count,
                   out_row=plan.out_row, n_slots=plan.n_slots,
                   n_regs=plan.n_regs, n_instrs=plan.n_instrs,
                   lane_count_widths=plan.lane_count_widths,
                   lane_row_widths=plan.lane_row_widths,
                   xbanks=plan.xbanks, xslots=plan.xslots,
                   n_xslots=plan.n_xslots)


def _message(verify, plan, n_shards, w_mega):
    try:
        verify(plan, n_shards, w_mega)
    except (mk.PlanVerifyError, jmk.PlanVerifyError) as e:
        return str(e)
    return None


def _expand_typing_plans():
    """tests/test_layout.py's accept and its four rejects."""
    low = jmk.Lowering()
    xp = (np.zeros(256, np.uint32), np.zeros(17, np.int32))
    bank = np.zeros((8, 2, 8), np.uint32)
    low.add_entry((("slot", 0, 0), ("xslot", 1, 1), ("fold", "and", 2)),
                  [bank, xp], [1, 3], [], 8, "count")
    plan = low.finish()
    out = [("clean", plan)]
    p = clone_plan(plan)
    for i in range(p.n_instrs):
        if int(p.instrs[i, 0]) == jmk.OP_EXPAND:
            p.instrs[i, 2] = 0
            break
    out.append(("not-an-expand", p))
    p = clone_plan(plan)
    for i in range(p.n_instrs):
        if int(p.instrs[i, 0]) == jmk.OP_AND:
            p.instrs[i, 2] = p.n_slots
            break
    out.append(("direct-read", p))
    p = clone_plan(plan)
    p.xslots[0][0] = 99
    out.append(("starts-table", p))
    p = clone_plan(plan)
    p.instrs[0, 1] = p.n_slots
    out.append(("write-expand", p))
    return out


@pytest.mark.parametrize("name,plan", _expand_typing_plans(),
                         ids=[n for n, _ in _expand_typing_plans()])
def test_verify_expand_typing_messages_match_jax(name, plan):
    want = _message(jmk.verify_plan, plan, 2, 8)
    got = _message(mk.verify_plan, _to_port(plan), 2, 8)
    assert got == want
    assert (got is None) == (name == "clean")


_SPARSE_PLANS = [p for p in synthetic_plans() if p[1].xbanks]


@pytest.mark.parametrize("case", range(len(_SPARSE_PLANS)),
                         ids=[p[0] for p in _SPARSE_PLANS])
def test_verifier_matches_jax_on_sparse_plans(case):
    _, plan, n_shards, w_mega = _SPARSE_PLANS[case]
    assert _message(mk.verify_plan, _to_port(plan), n_shards, w_mega) is None
    applied = 0
    for ki, kind in enumerate(PLAN_MUTATIONS):
        for trial in range(2):
            rng = np.random.default_rng([case, ki, trial])
            mutated = mutate_plan(rng, plan, kind, w_mega=w_mega)
            if mutated is None:
                continue
            applied += 1
            assert _message(mk.verify_plan, _to_port(mutated), n_shards,
                            w_mega) == _message(jmk.verify_plan, mutated,
                                                n_shards, w_mega), kind
    assert applied


def test_interpreter_with_expand_registers_matches_jax():
    """The plain mega_interpret with sparse banks against the JAX
    interpreter (build_program(...).run) on the same plan."""
    rng = np.random.default_rng(4)
    S, W = 2, 16
    dense = rng.integers(0, 1 << 32, (8, S, W), dtype=np.uint32)
    pos, starts, cap = _encoded_case(rng, 9, S, W)
    entries = [
        ((("slot", 0, 0), ("xslot", 1, 1), ("fold", "and", 2)), None,
         [1, 3], [], W, "count"),
        ((("xslot", 1, 0), ("xslot", 1, 1), ("xslot", 1, 2),
          ("fold", "or", 3)), None, [2, 3, cap - 1], [], 12, "row"),
        ((("xslot", 1, 0), ("slot", 0, 1), ("fold", "diff", 2)), None,
         [4, 5], [], W, "count"),
        ((("slot", 0, 0), ("xslot", 1, 1), ("slot", 0, 2),
          ("thresh", 2, 3)), None, [6, 8, 7], [], W, "row"),
        ((("xslot", 1, 0), ("slot", 0, 1), ("fold", "xor", 2)), None,
         [0, 2], [], 9, "count"),
    ]
    jbank, jpair = jnp.asarray(dense), (jnp.asarray(pos),
                                        jnp.asarray(starts))
    tbank = torch.from_numpy(dense.view(np.int32))
    tpair = (torch.from_numpy(pos.view(np.int32)),
             torch.from_numpy(starts))
    jplan, _ = _lower(jmk, [(e[0], [jbank, jpair]) + e[2:]
                            for e in entries])
    tplan, _ = _lower(mk, [(e[0], [tbank, tpair]) + e[2:]
                           for e in entries])
    mk.verify_plan(tplan, S, W)
    run = jmk.build_program(S, W, jplan.n_regs)
    jc, jr = run(jplan.banks, tuple(jnp.asarray(s) for s in jplan.slots),
                 jnp.asarray(jplan.widths), jnp.asarray(jplan.instrs),
                 jnp.asarray(jplan.out_count), jnp.asarray(jplan.out_row),
                 jplan.xbanks, tuple(jnp.asarray(s) for s in jplan.xslots))
    tc, tr = mk.run_program(tplan, S, W)
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jc).sum(axis=-1))
    np.testing.assert_array_equal(tr.numpy().view(np.uint32),
                                  np.asarray(jr))


# ------------------------------------------------- budget and layout


def test_bank_budget_eviction_order_matches_jax(tmp_path, clock):
    """Under a small budget both packages evict the same banks in the
    same order: the sparsest, coldest first, LRU among ties."""
    jh, th, jex, tex = _pair(tmp_path, sparse_rows=1200, two_shards=False)
    try:
        for ex in (jex, tex):
            ex.execute("i", "Count(Row(f=1))")
            ex.execute("i", "Count(Row(s=1))")
            ex.execute("i", "Count(Row(f=2))")
        WORKLOAD.reset()
        JWORKLOAD.reset()
        for _ in range(50):
            WORKLOAD.record_read("i", "f", "standard", [0, 1])
            JWORKLOAD.record_read("i", "f", "standard", [0, 1])
        evicted = []
        for h, Budget, ledger in ((jh, jview_mod.BankBudget,
                                   jmemledger.LEDGER),
                                  (th, BankBudget, memledger.LEDGER)):
            views = {n: h.index("i").field(n).view("standard")
                     for n in ("f", "s")}
            keys = {n: next(iter(v._bank_cache)) for n, v in views.items()}
            nb = {n: ledger.entry_info(("bank",), (id(views[n]),
                                                   keys[n]))["bytes"]
                  for n in views}
            budget = Budget(nb["f"] + nb["s"])
            budget.admit(views["f"], keys["f"], nbytes=nb["f"])
            budget.admit(views["s"], keys["s"], nbytes=nb["s"])
            budget.admit(views["f"], ("trigger",), nbytes=16)
            first = [n for n in views if keys[n] not in
                     views[n]._bank_cache]
            budget.admit(views["f"], ("big",), nbytes=nb["f"] + nb["s"])
            second = [n for n in views if keys[n] not in
                      views[n]._bank_cache]
            evicted.append((first, second, budget.evictions,
                            budget.total))
        assert evicted[0] == evicted[1]
        assert evicted[1][0] == ["s"]
    finally:
        jh.close()


def test_relayout_demotion_and_promotion_match_jax(tmp_path, clock):
    jh, th, jex, tex = _pair(tmp_path, sparse_rows=1500)
    try:
        want = _results(jex, QUERIES[:4])
        assert _results(tex, QUERIES[:4]) == want
        gc.collect()
        WORKLOAD.reset()
        JWORKLOAD.reset()
        jm = jlayout_mod.LayoutManager(jh, min_bytes=1024)
        tm = LayoutManager(th, min_bytes=1024)
        keys = ("ran", "overWatermark", "demoted", "promoted",
                "deltaBytes")
        js, ts = jm.relayout_once(), tm.relayout_once()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert ts["demoted"] >= 1 and ts["deltaBytes"] < 0
        snap = tm.snapshot()
        assert snap["sparseViews"] == jm.snapshot()["sparseViews"] >= 1
        assert snap["bytesReclaimed"] == -ts["deltaBytes"]
        assert _results(tex, QUERIES[:4]) == want == \
            _results(jex, QUERIES[:4])
        for _ in range(30):
            clock[0] += 1.0
            tex.execute("i", "Count(Row(s=1))")
            jex.execute("i", "Count(Row(s=1))")
        js, ts = jm.relayout_once(), tm.relayout_once()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert ts["promoted"] >= 1
        assert th.index("i").field("s").view("standard").layout_mode == \
            "dense"
        assert _results(tex, QUERIES[:4]) == want == \
            _results(jex, QUERIES[:4])
        # Pressure: a watermark below the device bytes demotes top-down.
        for m in (jm, tm):
            m.configure(watermark_bytes=1)
        js, ts = jm.relayout_once(), tm.relayout_once()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert ts["overWatermark"] and ts["demoted"] >= 1
        assert _results(tex, QUERIES[:4]) == want
    finally:
        jh.close()


def test_demote_compacts_point_written_storage(tmp_path):
    """A view built from point Sets (each written container dense for
    mutation) still demotes: the pass compacts the storage first."""
    th = Holder(device="cpu")
    f = th.create_index("i").create_field("sp")
    for r in range(300):
        f.set_bit(r, (r * 7) % 4096)
        f.set_bit(r, (r * 13) % 4096)
    tex = Executor(th, device="cpu")
    want = tex.execute("i", "Count(Row(sp=5))")[0]
    tex.execute("i", "Count(Row(sp=1))")
    WORKLOAD.reset()
    mgr = LayoutManager(th, min_bytes=1024)
    assert mgr.relayout_once()["demoted"] == 1
    assert mgr.demote_failures == 0
    view = f.view("standard")
    assert view.layout_mode == "sparse"
    assert tex.execute("i", "Count(Row(sp=5))")[0] == want
    # A write after the demotion: the SparseBank rebuilds, no stale hit.
    before = view.sparse_bank((0,))
    f.set_bit(5, 4000)
    assert tex.execute("i", "Count(Row(sp=5))")[0] == want + 1
    after = view.sparse_bank((0,))
    assert after is not before and after.versions != before.versions
    f.clear_bit(5, 4000)
    assert tex.execute("i", "Count(Row(sp=5))")[0] == want


def test_write_after_demotion_matches_jax(tmp_path):
    jh, th, jex, tex = _pair(tmp_path, two_shards=False)
    try:
        for h in (jh, th):
            assert h.index("i").field("s").view("standard").set_layout(
                "sparse")
        for ex, h in ((jex, jh), (tex, th)):
            ex.execute("i", "Count(Row(s=1))")
            h.index("i").field("s").set_bit(1, 4000)
            h.index("i").field("s").set_bit(900, 17)  # a new row
        queries = ["Count(Row(s=1))", "Row(s=900)",
                   "Count(Union(Row(s=1), Row(s=900)))"]
        assert _results(tex, queries) == _results(jex, queries)
        reqs = [("i", q, None) for q in queries]
        assert tex.execute_batch_shaped(reqs) == \
            jex.execute_batch_shaped(reqs)
    finally:
        jh.close()


def test_sparse_bank_too_dense_self_heals():
    """A sparse-marked view whose rows are dense: the build bails, the
    view heals to dense and the answer comes from the dense path. No
    threads: one query at a time."""
    rng = np.random.default_rng(2)
    th = Holder(device="cpu")
    idx = th.create_index("i")
    f = idx.create_field("d")
    for r in range(4):
        cols = rng.choice(4096, size=2500, replace=False).astype(np.uint64)
        f.import_bits(np.full(2500, r, np.uint64), cols)
    idx.add_existence(np.arange(4096, dtype=np.uint64))
    tex = Executor(th, device="cpu")
    # Each repeat must stage the sparse leaf: a result-cache hit stages
    # nothing, so it would never reach the build that heals the view.
    tex.result_cache.enabled = False
    view = f.view("standard")
    dense = tex.execute("i", "Count(Row(d=1))")[0]
    assert view.sparse_bank((0,)) is None
    for run in (lambda: tex.execute("i", "Count(Row(d=1))")[0],
                lambda: tex.execute_batch_shaped(
                    [("i", "Count(Row(d=1))", None)])[0]["results"][0]):
        view.set_layout("sparse")
        assert run() == dense
        assert view.layout_mode == "dense"
    # The demotion compacts the storage first: 2500-bit rows fit arrays,
    # so the view then demotes and answers the same.
    assert LayoutManager(th).demote(view)
    assert tex.execute("i", "Count(Row(d=1))")[0] == dense


# ------------------------------------------------- ledger and workload


def _ledger_script(mod):
    class Owner:
        pass

    led = mod.MemoryLedger()
    a, b = Owner(), Owner()
    led.register("bank", "k1", 1000, padded_bytes=200, owner=a, view="v")
    led.register("bank", "k2", 500, owner=a, view="w")
    led.register("pbank", "k1", 300, padded_bytes=10, owner=b)
    led.register("bank", "k1", 1200, padded_bytes=100, owner=a, view="v")
    led.register("host_block", "h", 4096, owner=b)
    led.register("telemetry", "ring", 64)
    led.unregister("bank", "k2", owner=a)
    led.unregister("bank", "k2", owner=a)  # idempotent
    tracked = Owner()
    led.track(tracked, "pending", 77, padded_bytes=7)
    steps = [(led.totals(), led.total_bytes(), led.total_bytes(True),
              led.top(3), led.top(3, device_only=True),
              sorted(map(repr, led.entries("bank", "pbank"))),
              led.entry_info(("pbank", "bank"), (id(a), "k1")) is not None)]
    del tracked
    gc.collect()
    steps.append((led.totals(), led.snapshot(2)["totalBytes"],
                  led.snapshot(2)["deviceBytes"]))
    led.unregister("bank", (id(a), "k1"))  # an eviction's scoped key
    del a
    gc.collect()
    steps.append((led.totals(), led.snapshot()))
    del b
    gc.collect()
    steps.append(led.totals())
    return steps


def test_memory_ledger_matches_jax():
    got, want = _ledger_script(memledger), _ledger_script(jmemledger)
    assert len(got) == len(want)
    # The top lists carry the owners' ids only through keys, never
    # through their values, so the two scripts compare whole.
    assert got == want


def test_watchdog_ring_and_watermark(caplog):
    led = memledger.MemoryLedger()
    led.register("bank", "b", 900)
    led.register("host_block", "h", 5000)
    dog = memledger.MemoryWatchdog(led, ring=2, watermark_bytes=1000,
                                   extra_gauges=lambda: {"queueDepth": 3})
    s1 = dog.sample_once()
    assert (s1["deviceBytes"], s1["totalBytes"], s1["queueDepth"]) == \
        (900, 5900, 3)
    led.register("bank", "c", 200)
    with caplog.at_level("WARNING"):
        dog.sample_once()
        dog.sample_once()  # still over: one warning, not one a sample
    assert sum("pressure" in r.message for r in caplog.records) == 1
    assert len(dog.snapshots()) == 2 and dog.samples_taken == 3


def test_view_read_rates_match_jax():
    now = [0.0]
    got = hotspots.WorkloadRecorder(half_life_s=60.0, max_fragments=3,
                                    clock=lambda: now[0])
    want = jhotspots.WorkloadRecorder(half_life_s=60.0, max_fragments=3,
                                      clock=lambda: now[0])
    script = [
        (0.0, "read", ("i", "f", "standard", [0, 1], [1, 2, 3])),
        (5.0, "read", ("i", "f", "standard", [0], None)),
        (30.0, "write", ("i", "f", "standard", 1, 9, 4)),
        (61.0, "read", ("i", "g", "standard", [0], list(range(100)))),
        (90.0, "inval", ("i", "f", "standard", [0, 1])),
        (200.0, "read", ("j", "h", "bsig_h", [2], None)),
        (400.0, "read", ("i", "f", "standard", [1], [7])),
    ]
    for t, kind, args in script:
        now[0] = t
        for rec in (got, want):
            if kind == "read":
                rec.record_read(*args[:4], rows=args[4])
            elif kind == "write":
                rec.record_write(*args[:4], generation=args[4], n=args[5])
            else:
                rec.record_invalidation(*args)
        assert got.view_read_rates() == want.view_read_rates()
    now[0] = 1000.0
    assert got.view_read_rates() == want.view_read_rates()
    s, w = got.summary(), want.summary()
    for k in ("enabled", "fragmentReads", "fragmentWrites",
              "trackedFragments", "trackedRows"):
        assert s[k] == w[k], k
    got.reset()
    assert got.view_read_rates() == {} and got.summary()["fragmentReads"] \
        == 0
