"""Positions-bank TopN of the port against the JAX package.

The membership kernel's plain version against the Pallas kernel
(interpret mode); PositionsBank segments bit for bit against the JAX
package's under the same PBANK_* settings, fixed and flat; TopN over the
positions bank against JAX ``Executor`` TopN and against the port's own
chunk stream, on the cases of the JAX package's positions-bank tests
(the five variants, a dense filter, a filter wider than the bank,
multi-segment and mixed-layout banks, the incremental patch) and on a
bank where many rows tie at the n-th count; the row-subset bank of an
eager Row leaf over an over-budget view. Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.core import view as jax_view_mod
from pilosa_tpu.core.field import FieldOptions as JaxFieldOptions
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.executor import executor as jax_ex_mod
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch import Executor, FieldOptions, Holder
from pilosa_tpu_torch.core import view as view_mod
from pilosa_tpu_torch.core.view import PositionsBank, ViewBank
from pilosa_tpu_torch.executor import executor as ex_mod
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.bitset import pack_positions, to_tensor

CPU = torch.device("cpu")
FP = {"max_columns": 4096, "cache_type": "none"}


# ------------------------------------------------------------- the kernel


def _pallas_case():
    """The Pallas kernel's own test case: [2048, 48] sorted rows with
    0xFFFF pads and 48 query positions."""
    rng = np.random.default_rng(5)
    R, L, qk = 2048, 48, 48
    pos = np.sort(rng.integers(0, 4096, (R, L), dtype=np.uint16), axis=1)
    lens = rng.integers(10, L + 1, R)
    pos[np.arange(L)[None, :] >= lens[:, None]] = 0xFFFF
    q = np.unique(rng.integers(0, 4096, qk * 2, dtype=np.uint16))[:qk]
    return pos, q


def _pos_tensor(pos):
    return torch.from_numpy(np.ascontiguousarray(pos).view(np.int16))


def test_membership_ref_matches_pallas_interpret():
    pos, q = _pallas_case()
    qtop_pad = np.full((8, 128), -1, np.int32)
    qtop_pad.reshape(-1)[:len(q)] = q.astype(np.int32)
    grouped = pos.view(np.uint32).reshape(len(pos) // 16, 16 * (48 // 2))
    want = np.asarray(pk.pbank_membership_counts(
        jnp.asarray(grouped), jnp.asarray(qtop_pad), qk=len(q),
        interpret=True))
    filt = to_tensor(pack_positions(q.astype(np.uint64), 4096), CPU)
    got = kernels.pbank_membership_counts_ref(_pos_tensor(pos), filt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _flat_of(pos):
    """The same rows in the flat layout: real positions back to back,
    0xFFFF after the last, int32 starts."""
    real = pos != 0xFFFF
    lens = real.sum(axis=1)
    starts = np.zeros(len(pos) + 1, np.int32)
    np.cumsum(lens, out=starts[1:])
    buf = np.full(int(starts[-1]) + 64, 0xFFFF, np.uint16)
    buf[:starts[-1]] = pos[real]
    return _pos_tensor(buf), torch.from_numpy(starts)


@pytest.mark.parametrize("W", [1, 4, 128, 2047])
def test_membership_ref_layouts_agree_with_numpy(W):
    """Fixed and flat layouts give numpy's |row ∧ filter| for filters of
    any width up to 2047 words; pads and positions past the filter count
    0, bits at word 2046 count."""
    rng = np.random.default_rng(W)
    R, L = 300, 40
    pos = np.sort(rng.integers(0, 65535, (R, L)), axis=1).astype(np.uint16)
    pos[:, :3] = [[5, 65472, 65503]]  # words 0 and 2046
    lens = rng.integers(0, L + 1, R)
    pos[np.arange(L)[None, :] >= lens[:, None]] = 0xFFFF
    words = rng.integers(0, 1 << 32, W, dtype=np.uint32)
    if W == 2047:
        words[2046] = np.uint32(0x80000001)
    full = np.zeros(2048, np.uint32)
    full[:W] = words
    bit = (full[pos >> 5] >> (pos & 31)) & 1
    want = np.where(pos != 0xFFFF, bit, 0).sum(axis=1)
    filt = to_tensor(words, CPU)
    fixed = kernels.pbank_membership_counts(_pos_tensor(pos), filt)
    flat_pos, starts = _flat_of(pos)
    flat = kernels.pbank_membership_counts(flat_pos, filt, starts)
    np.testing.assert_array_equal(fixed.numpy(), want)
    np.testing.assert_array_equal(flat.numpy(), want)


def test_membership_wrapper_takes_plain_path_on_cpu():
    pos, q = _pallas_case()
    filt = to_tensor(pack_positions(q.astype(np.uint64), 4096), CPU)
    before = dict(kernels.LAUNCHES)
    got = kernels.pbank_membership_counts(_pos_tensor(pos), filt)
    assert torch.equal(got, kernels.pbank_membership_counts_ref(
        _pos_tensor(pos), filt))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("case", ["pos_dtype", "filt_dtype", "wide_filter",
                                  "fixed_rank", "starts_dtype",
                                  "meta_device"])
def test_membership_wrapper_refuses_bad_operands(case):
    pos = torch.zeros((4, 8), dtype=torch.int16)
    filt = torch.zeros(128, dtype=torch.int32)
    starts = torch.zeros(5, dtype=torch.int32)
    if case == "pos_dtype":
        with pytest.raises(TypeError):
            kernels.pbank_membership_counts(pos.to(torch.int32), filt)
    elif case == "filt_dtype":
        with pytest.raises(TypeError):
            kernels.pbank_membership_counts(pos, filt.to(torch.int64))
    elif case == "wide_filter":
        with pytest.raises(ValueError):
            kernels.pbank_membership_counts(
                pos, torch.zeros(2048, dtype=torch.int32))
    elif case == "fixed_rank":
        with pytest.raises(ValueError):
            kernels.pbank_membership_counts(pos.reshape(-1), filt)
    elif case == "starts_dtype":
        with pytest.raises(TypeError):
            kernels.pbank_membership_counts(pos.reshape(-1), filt,
                                            starts.to(torch.int64))
    else:
        with pytest.raises(ValueError):
            kernels.pbank_membership_counts(pos.to("meta"), filt.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 128, 2047])
def test_cuda_membership_matches_plain(W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(W)
    pos = np.sort(rng.integers(0, 65535, (4096, 48)), axis=1).astype(
        np.uint16)
    pos[:, 40:] = 0xFFFF
    filt = to_tensor(rng.integers(0, 1 << 32, W, dtype=np.uint32), dev)
    flat, starts = _flat_of(pos)
    for args in ((_pos_tensor(pos).to(dev), filt, None),
                 (flat.to(dev), filt, starts.to(dev))):
        before = kernels.LAUNCHES["pbank_membership_counts"]
        got = kernels.pbank_membership_counts(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.pbank_membership_counts_ref(*args))
        assert kernels.LAUNCHES["pbank_membership_counts"] == before + 1


# ----------------------------------------------------------- the datasets


def _fp_data(seed, n_rows, lo=5, hi=40):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64),
                     rng.integers(lo, hi, n_rows))
    cols = rng.integers(0, 4096, len(rows)).astype(np.uint64)
    return rng, rows, cols


def _dataset(name):
    """(fields {name: (options, rows, cols)}, queries) of one case."""
    if name == "variants":  # tests/test_executor.py positions-bank cases
        _, rows, cols = _fp_data(13, 700)
        return {"fp": (FP, rows, cols)}, [
            "TopN(fp, n=7)", "TopN(fp, Row(fp=3), n=7)",
            "TopN(fp, Row(fp=3), n=9, tanimotoThreshold=20)",
            "TopN(fp, n=5, threshold=25)",
            "TopN(fp, n=6, tanimotoThreshold=50)"]
    if name == "dense_filter":
        rng, rows, cols = _fp_data(29, 300)
        dense_cols = rng.choice(4096, 200, replace=False).astype(np.uint64)
        return {"fp": (FP, np.concatenate([rows, np.zeros(200, np.uint64)]),
                       np.concatenate([cols, dense_cols]))}, [
            "TopN(fp, Row(fp=0), n=7)",
            "TopN(fp, Row(fp=0), n=9, tanimotoThreshold=10)",
            "TopN(fp, Row(fp=5), n=7)"]
    if name == "wide_filter":
        _, rows, cols = _fp_data(31, 120)
        wcols = np.array([7, 11, 599, 65535], dtype=np.uint64)
        return {"fp": (FP, rows, cols),
                "wide": ({"cache_type": "none"},
                         np.zeros(len(wcols), np.uint64), wcols)}, [
            "TopN(fp, Row(wide=0), n=10)",
            "TopN(fp, Row(wide=0), n=10, tanimotoThreshold=1)"]
    if name == "ties":
        # 400 rows hold exactly 5 of the query row's 20 bits (and other
        # bits outside them), 100 rows 6: every n below cuts a tie.
        rng = np.random.default_rng(41)
        q = rng.choice(4096, 20, replace=False)
        outside = np.setdiff1d(np.arange(4096), q)
        rows, cols = [np.zeros(20, np.uint64)], [q.astype(np.uint64)]
        for r in range(1, 501):
            k = 6 if r % 5 == 0 else 5
            mine = np.concatenate([rng.choice(q, k, replace=False),
                                   rng.choice(outside, 10, replace=False)])
            rows.append(np.full(len(mine), r, np.uint64))
            cols.append(mine.astype(np.uint64))
        return {"fp": (FP, np.concatenate(rows), np.concatenate(cols))}, [
            "TopN(fp, Row(fp=0), n=7)", "TopN(fp, Row(fp=0), n=150)",
            "TopN(fp, Row(fp=0), n=300, tanimotoThreshold=20)",
            "TopN(fp, n=9)", "TopN(fp, Row(fp=0), n=40, threshold=6)"]
    raise KeyError(name)


def _build(tmp_path, fields):
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    jidx = jh.create_index("pb")
    th = Holder(device="cpu")
    tidx = th.create_index("pb")
    for fname, (opts, rows, cols) in fields.items():
        jidx.create_field(fname, JaxFieldOptions(**opts)).import_bits(
            rows, cols)
        tidx.create_field(fname, FieldOptions(**opts)).import_bits(rows, cols)
    return jh, th


# Segment caps per dataset: one segment, many fixed segments, and (for
# the dense filter's 200-position row) a mixed fixed/flat bank.
CAPS = {"one": (1 << 27, 1 << 20), "multi": (512, 128), "mixed": (1024, 128)}


def _set_caps(monkeypatch, caps):
    seg, gather = CAPS[caps]
    for mod in (view_mod, jax_view_mod):
        monkeypatch.setattr(mod, "PBANK_SEGMENT_POSITIONS", seg)
        monkeypatch.setattr(mod, "PBANK_GATHER_ROWS", gather)


def _answers(tmp_path, monkeypatch, name, caps):
    """JAX pbank answers, port pbank answers and port chunk-stream
    answers of one dataset's queries, with both packages forced past
    their TopN bank budget."""
    _set_caps(monkeypatch, caps)
    monkeypatch.setattr(jax_ex_mod, "TOPN_MAX_BANK_BYTES", 1)
    monkeypatch.setattr(ex_mod, "TOPN_MAX_BANK_BYTES", 1)
    monkeypatch.setattr(ex_mod, "TOPN_CHUNK_ROWS", 64)
    fields, queries = _dataset(name)
    jh, th = _build(tmp_path, fields)
    jex, tex = JaxExecutor(jh), Executor(th, device="cpu")
    out = []
    for q in queries:
        (want,) = jex.execute("pb", q)
        (got,) = tex.execute("pb", q)
        monkeypatch.setattr(ex_mod, "PBANK_ENABLED", False)
        (streamed,) = tex.execute("pb", q)
        monkeypatch.setattr(ex_mod, "PBANK_ENABLED", True)
        out.append((q, want.pairs, got.pairs, streamed.pairs))
    view = th.index("pb").field("fp").view()
    pb = view._bank_cache.get(("pbank", 0, view.trimmed_words()))
    jh.close()
    return out, pb


@pytest.mark.parametrize("name,caps", [
    ("variants", "one"), ("variants", "multi"), ("dense_filter", "one"),
    ("dense_filter", "mixed"), ("wide_filter", "one"), ("ties", "one"),
    ("ties", "multi")])
def test_topn_positions_matches_jax_and_stream(tmp_path, monkeypatch, name,
                                               caps):
    out, pb = _answers(tmp_path, monkeypatch, name, caps)
    assert isinstance(pb, PositionsBank)
    for q, want, got, streamed in out:
        assert got == want, q
        assert streamed == want, q
        assert want, q
    kinds = {"fixed" if s[2].dim() == 2 else "flat" for s in pb.segments}
    if caps == "mixed":
        assert kinds == {"fixed", "flat"}
    if caps == "multi":
        assert len(pb.segments) > 3
        assert all(p <= CAPS["multi"][0] for *_x, p in pb.segments)
    if name == "wide_filter":
        assert kinds == {"fixed"}
    assert sum(s[1] for s in pb.segments) == len(pb.row_ids)


def test_ties_break_by_lower_row():
    """Many rows tie at the n-th count: the answer keeps the lowest rows
    of the tie, the (-count, row) order numpy gives."""
    fields, _ = _dataset("ties")
    _, rows, cols = fields["fp"]
    th = Holder(device="cpu")
    th.create_index("pb").create_field("fp", FieldOptions(**FP)).import_bits(
        rows, cols)
    q = set(cols[rows == 0].tolist())
    counts = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        if c in q:
            counts[r] = counts.get(r, 0) + 1
    want = sorted(counts.items(), key=lambda rc: (-rc[1], rc[0]))
    saved = ex_mod.TOPN_MAX_BANK_BYTES
    ex_mod.TOPN_MAX_BANK_BYTES = 1
    try:
        tex = Executor(th, device="cpu")
        for n in (3, 101, 150):
            (got,) = tex.execute("pb", f"TopN(fp, Row(fp=0), n={n})")
            assert got.pairs == want[:n]
    finally:
        ex_mod.TOPN_MAX_BANK_BYTES = saved
    assert want[101][1] == want[150][1] == 5  # the cuts fall in a tie


# ------------------------------------------------------------- the banks


@pytest.mark.parametrize("name,caps,fixed_slots", [
    ("variants", "one", 128), ("variants", "multi", 128),
    ("variants", "one", 8), ("dense_filter", "mixed", 128)])
def test_positions_bank_segments_match_jax(tmp_path, monkeypatch, name,
                                           caps, fixed_slots):
    """Segments bit for bit: row ranges, real position counts, the
    positions (fixed matrix or flat buffer, pads included) and the aux
    arrays. A small PBANK_FIXED_ROW_SLOTS makes every segment flat."""
    _set_caps(monkeypatch, caps)
    for mod in (view_mod, jax_view_mod):
        monkeypatch.setattr(mod, "PBANK_FIXED_ROW_SLOTS", fixed_slots)
    fields, _ = _dataset(name)
    jh, th = _build(tmp_path, fields)
    jv = jh.index("pb").field("fp").view()
    tv = th.index("pb").field("fp").view()
    width = tv.trimmed_words()
    assert width == jv.trimmed_words()
    want = jv.positions_bank(0, width)
    got = tv.positions_bank(0, width)
    assert got.row_ids == want.row_ids
    assert got.nbytes == want.nbytes
    assert len(got.segments) == len(want.segments)
    kinds = set()
    for (g_lo, g_n, g_pos, g_aux, g_p), (w_lo, w_n, w_pos, w_aux, w_p) in \
            zip(got.segments, want.segments):
        assert (g_lo, g_n, g_p) == (w_lo, w_n, w_p)
        assert g_pos.dtype == torch.int16 and g_aux.dtype == torch.int32
        np.testing.assert_array_equal(g_pos.numpy().view(np.uint16),
                                      np.asarray(w_pos))
        np.testing.assert_array_equal(g_aux.numpy(), np.asarray(w_aux))
        kinds.add("fixed" if g_pos.dim() == 2 else "flat")
    if fixed_slots == 8:
        assert kinds == {"flat"}
    jh.close()


def test_positions_bank_incremental_patch(tmp_path, monkeypatch):
    """A point write regathers only the segment holding the written
    row; the others keep their device arrays; answers stay equal to the
    JAX package's and the stream's; a new row rebuilds whole."""
    monkeypatch.setattr(view_mod, "PBANK_SEGMENT_POSITIONS", 2048)
    monkeypatch.setattr(view_mod, "PBANK_GATHER_ROWS", 256)
    monkeypatch.setattr(jax_view_mod, "PBANK_SEGMENT_POSITIONS", 2048)
    monkeypatch.setattr(jax_view_mod, "PBANK_GATHER_ROWS", 256)
    rng = np.random.default_rng(17)
    rows = np.repeat(np.arange(1200, dtype=np.uint64), 15)
    cols = rng.integers(0, 4096, len(rows)).astype(np.uint64)
    jh, th = _build(tmp_path, {"fp": (FP, rows, cols)})
    jf, tf = jh.index("pb").field("fp"), th.index("pb").field("fp")
    view = tf.view()
    w = view.trimmed_words()
    pb1 = view.positions_bank(0, w)
    assert len(pb1.segments) >= 4
    jf.set_bit(2, 4000)
    tf.set_bit(2, 4000)
    pb2 = view.positions_bank(0, w)
    assert pb2 is not pb1
    assert pb2.segments[0][2] is not pb1.segments[0][2]
    assert all(b[2] is a[2] for a, b in zip(pb1.segments[1:],
                                             pb2.segments[1:]))
    assert sum(s[1] for s in pb2.segments) == len(pb2.row_ids)
    monkeypatch.setattr(jax_ex_mod, "TOPN_MAX_BANK_BYTES", 1)
    monkeypatch.setattr(ex_mod, "TOPN_MAX_BANK_BYTES", 1)
    monkeypatch.setattr(ex_mod, "TOPN_CHUNK_ROWS", 64)
    q = "TopN(fp, Row(fp=2), n=6, tanimotoThreshold=5)"
    (want,) = JaxExecutor(jh).execute("pb", q)
    tex = Executor(th, device="cpu")
    (got,) = tex.execute("pb", q)
    assert got.pairs == want.pairs and want.pairs
    assert view.positions_bank(0, w) is pb2  # the query reused the patch
    monkeypatch.setattr(ex_mod, "PBANK_ENABLED", False)
    (streamed,) = tex.execute("pb", q)
    assert streamed.pairs == want.pairs
    tf.set_bit(5000, 1)
    pb3 = view.positions_bank(0, w)
    assert len(pb3.row_ids) == 1201
    assert all(b[2] is not a[2] for a, b in zip(pb2.segments, pb3.segments))
    jh.close()


def test_row_leaf_of_over_budget_view_builds_subset_bank(tmp_path,
                                                         monkeypatch):
    """An eager Row leaf over a view whose full bank is past
    BANK_MAX_BYTES builds and caches a bank of just its row (at most 2
    slots), and answers as the JAX package does."""
    _, rows, cols = _fp_data(13, 700)
    jh, th = _build(tmp_path, {"fp": (FP, rows, cols)})
    monkeypatch.setattr(JaxExecutor, "BANK_MAX_BYTES", 1)
    monkeypatch.setattr(Executor, "BANK_MAX_BYTES", 1)
    tex = Executor(th, device="cpu")
    for q in ("Row(fp=3)", "Count(Row(fp=3))", "Row(fp=9999)"):
        (want,) = JaxExecutor(jh).execute("pb", q)
        (got,) = tex.execute("pb", q)
        if isinstance(want, int):
            assert got == want
        else:
            np.testing.assert_array_equal(got.columns(), want.columns())
    banks = th.index("pb").field("fp").view()._bank_cache
    assert banks and all(isinstance(b, ViewBank) and b.array.shape[0] <= 2
                         for b in banks.values())
    assert all(len(k) == 3 for k in banks)  # keyed by their rows
    jh.close()
