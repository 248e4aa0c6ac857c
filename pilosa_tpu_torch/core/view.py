"""View: a named collection of fragments, one per shard, and its device
banks.

View names: ``standard``, the BSI views ``bsig_<field>`` and a time
field's views, one per unit of time (``standard_2019``,
``standard_201901``, ``standard_20190105``). Fragments are created on
first write; a time view has fragments, banks and patches like any
other. ``device_bank`` stacks the view's rows
across shards into one ``[capacity, S, W]`` int32 tensor on the view's
device — the executor's operand format and the kernels' input; a row
subset of a view too large for a full bank gets a bank of its own.
``positions_bank`` keeps a narrow single-shard view's set positions
resident on the device instead (``PositionsBank``), for TopN over views
whose dense bank would not fit.

Every bank is cached in ``_bank_cache`` by key and stamped with the
fragment versions it was built from. Builds run under the view's lock,
so two threads asking for the same bank build it once; a positions bank
also holds its fragment's lock while it gathers, so a concurrent write
lands wholly before or after it. The JAX package's HBM budget
(``BankBudget``), memory ledger, host block cache and sparse upload are
not part of this port yet, so nothing evicts a cached bank: a stale one
is replaced when its key is asked for again. A full dense bank whose
fragments changed is patched where the writes were few (``_patch_bank``:
the written rows' cells, new rows appended at the end, emptied rows
kept in their slots), else rebuilt whole; a positions bank is patched
segment by segment.

A view with a ``path`` keeps its fragments at
``<path>/fragments/<shard>`` (the JAX package's layout): ``open`` loads
each, skipping the ``.cache``, ``.snapshotting`` and ``.torn``
sidecars, and ``close`` drops the banks and closes the fragments.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.fragment import CONTAINER_BITS, Fragment
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, WORDS_PER_SHARD

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"

# Positions per device segment. A segment's starts are int32, so its
# position count must stay well under 2^31; the build enforces the cap
# exactly by splitting gather chunks on row boundaries (a row holds at
# most 2^16 positions). Module attributes, so tests can shrink them.
PBANK_SEGMENT_POSITIONS = 1 << 27
# Rows per host gather of a segment build (bounds its temporaries).
PBANK_GATHER_ROWS = 1 << 20
# Fixed-width segments: every row must fit this many position slots,
# and real positions must fill at least this share of the padded matrix.
PBANK_FIXED_ROW_SLOTS = 128
PBANK_FIXED_MIN_DENSITY = 0.5
# Segment row counts round up to a multiple of at most this (see
# _flush_segment).
PBANK_FIXED_ROW_PAD = 1 << 16
# The pad position of both layouts: its word index is past any filter
# the membership kernel is given (W <= 2047), so it matches nothing.
PBANK_PAD = 0xFFFF


class ViewBank:
    """A view's rows stacked across shards as one device tensor
    ``[row_capacity, n_shards, W]`` (int32). The last slot is all zeros:
    rows absent from the view resolve there. Capacity is a power of two."""

    def __init__(self, array: torch.Tensor, slots: Dict[int, int],
                 zero_slot: int, versions: Dict[int, int]):
        self.array = array
        self.slots = slots          # row id -> slot
        self.zero_slot = zero_slot
        self.versions = versions    # {shard: fragment.version} at build

    def slot(self, row_id: int) -> int:
        return self.slots.get(row_id, self.zero_slot)


class PositionsBank:
    """A single-shard narrow view kept on the device as its rows' sorted
    u16 set positions (as int16 bits): about 2 bytes per set bit where
    the dense bank costs 4 bytes per 32 columns of every row slot.
    ``segments`` is a list of ``(row_lo, n_rows, pos, aux, p_real)``:
    rows ``row_ids[row_lo:row_lo + n_rows]`` in one of two layouts,
    told apart by the rank of ``pos``:

    - fixed: ``pos`` int16 [n_pad, L], each row padded with 0xFFFF to L
      slots; ``aux`` int32 [n_pad] the row lengths;
    - flat: ``pos`` int16 [P_pad] all rows back to back, 0xFFFF after
      the last; ``aux`` int32 [n_pad + 1] the row starts.

    ``n_pad >= n_rows``: pad rows have length 0. ``p_real`` counts the
    real positions."""

    __slots__ = ("segments", "row_ids", "versions", "nbytes")

    def __init__(self, segments, row_ids, versions, nbytes):
        self.segments = segments
        self.row_ids = row_ids      # global sorted row ids
        self.versions = versions
        self.nbytes = nbytes


def view_bsi_name(field: str) -> str:
    return VIEW_BSI_PREFIX + field


def bank_capacity(n_rows: int) -> int:
    """Slot capacity for n_rows: the next power of two above n_rows + 1
    (one all-zero slot)."""
    cap = 1
    while cap < n_rows + 1:
        cap *= 2
    return cap


def _row_pad(n: int) -> int:
    """Pad rows for a segment of n rows: up to the largest power-of-two
    multiple in 1024..PBANK_FIXED_ROW_PAD whose padding stays within
    n / 8, so segments at scale share shapes without near-2x padding."""
    row_pad = min(1024, PBANK_FIXED_ROW_PAD)
    cand = row_pad * 2
    while cand <= PBANK_FIXED_ROW_PAD:
        if -n % cand <= n // 8:
            row_pad = cand
        cand *= 2
    return -n % row_pad


class View:
    # Word granularity of declared-bound trims (4096 bits).
    TRIM_GRANULE = 128

    def __init__(self, field: str, name: str, device: torch.device,
                 max_columns: int = 0,
                 cache_type: str = cache_mod.CACHE_TYPE_RANKED,
                 cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
                 path: Optional[str] = None):
        self.path = path
        self.field = field
        self.name = name
        self.device = device
        self.max_columns = max_columns
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.fragments: Dict[int, Fragment] = {}
        self._lock = threading.RLock()
        self._bank_cache: Dict[tuple, object] = {}
        self._merged_rows: Dict[tuple, tuple] = {}

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(shard, cache_type=self.cache_type,
                        cache_size=self.cache_size,
                        path=None if self.path is None else os.path.join(
                            self.path, "fragments", str(shard)))

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = self._new_fragment(shard)
                frag.open()
                self.fragments[shard] = frag
            return frag

    def open(self) -> None:
        """Load every fragment file under ``<path>/fragments``."""
        frag_dir = os.path.join(self.path, "fragments")
        if not os.path.isdir(frag_dir):
            return
        for name in os.listdir(frag_dir):
            if not name.isdigit():
                continue  # the .cache, .snapshotting and .torn sidecars
            frag = self._new_fragment(int(name))
            frag.open()
            self.fragments[int(name)] = frag

    def close(self) -> None:
        """Drop the banks, then close every fragment (which saves its
        count cache)."""
        with self._lock:
            self.drop_banks()
            for frag in self.fragments.values():
                frag.close()

    def available_shards(self) -> List[int]:
        return sorted(self.fragments)

    def drop_banks(self) -> None:
        """Forget every cached bank (the view's field or index was
        deleted); the device memory goes when no query holds it."""
        with self._lock:
            self._bank_cache.clear()
            self._merged_rows.clear()

    def set_bit(self, row_id: int, column_id: int) -> bool:
        return self.create_fragment_if_not_exists(
            column_id // SHARD_WIDTH).set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SHARD_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False

    def merged_row_ids(self, shards: Sequence[int]) -> tuple:
        """Sorted union of row_ids() across ``shards``, cached per shard
        set and fragment versions."""
        key = tuple(shards)
        frags = [f for s in key for f in [self.fragment(s)] if f is not None]
        versions = tuple(f.version for f in frags)
        with self._lock:
            ent = self._merged_rows.get(key)
            if ent is not None and ent[0] == versions:
                return ent[1]
        per = [p for p in (f.row_ids() for f in frags) if p]
        if not per:
            merged: tuple = ()
        elif len(per) == 1:
            merged = per[0]
        else:
            merged = tuple(np.unique(np.concatenate(
                [np.asarray(p, dtype=np.uint64) for p in per])).tolist())
        with self._lock:
            self._merged_rows[key] = (versions, merged)
        return merged

    def trimmed_words(self) -> int:
        """Bank word width covering every set column of every fragment:
        exact to a 128-word granule with a declared max_columns, else
        whole 2048-word containers."""
        if self.max_columns:
            words = (self.max_columns + 31) // 32
            g = self.TRIM_GRANULE
            return min(WORDS_PER_SHARD, (words + g - 1) // g * g)
        cwords = CONTAINER_BITS // 32
        with self._lock:
            frags = list(self.fragments.values())
        max_off = max((f.max_column_offset() for f in frags), default=-1)
        if max_off < 0:
            return cwords
        words = (max_off // 32) + 1
        return min(WORDS_PER_SHARD,
                   ((words + cwords - 1) // cwords) * cwords)

    # -- dense banks ---------------------------------------------------------

    def device_bank(self, shards: Sequence[int],
                    rows: Optional[Sequence[int]] = None,
                    trim: bool = False, cache_rows: bool = False
                    ) -> ViewBank:
        """Bank for ``shards`` covering ``rows`` (default: every row present
        in any of the shards). The full bank is cached per (shards, trim)
        and rebuilt when any fragment's version moved. A ``rows`` subset
        builds a transient bank, or with ``cache_rows=True`` one cached
        under a key that includes the rows: the executor's Row leaf uses
        it for views whose full bank is over budget. ``trim=True``
        narrows the word axis to trimmed_words(), valid for whole-row
        consumers since the dropped tail is all-zero. A stale full bank
        of the same width is patched when it can be (``_patch_bank``),
        so its slots keep their rows; consumers map rows to slots
        through ``slots`` and never assume them ascending."""
        shards = tuple(shards)
        with self._lock:
            frags = {s: self.fragments.get(s) for s in shards}
            versions = {s: (f.version if f else -1) for s, f in frags.items()}
            width = self.trimmed_words() if trim else WORDS_PER_SHARD
            if rows is None:
                cache_key: Optional[Tuple] = (shards, trim)
                row_set = None
            else:
                row_set = sorted(set(rows))
                cache_key = (shards, trim, tuple(row_set)) if cache_rows \
                    else None
            if cache_key is not None:
                cached = self._bank_cache.get(cache_key)
                if cached is not None and cached.versions == versions \
                        and cached.array.shape[-1] == width:
                    return cached
                # Drop the stale bank before the build, so the old and
                # the new bank are never both held by the cache.
                self._bank_cache.pop(cache_key, None)
            if row_set is None:
                row_set = sorted({r for f in frags.values() if f
                                  for r in f.row_ids()})
                if cached is not None and cached.array.shape[-1] == width:
                    patched = self._patch_bank(cached, frags, versions,
                                               row_set, shards, width)
                    if patched is not None:
                        self._bank_cache[cache_key] = patched
                        return patched
            bank = self._build_bank(frags, shards, row_set, width, versions)
            if cache_key is not None:
                self._bank_cache[cache_key] = bank
            return bank

    def _build_bank(self, frags: Dict[int, Optional[Fragment]],
                    shards: Tuple[int, ...], row_set: List[int], width: int,
                    versions: Dict[int, int]) -> ViewBank:
        cap = bank_capacity(len(row_set))
        host = np.zeros((cap, len(shards), width), dtype=np.uint32)
        for si, s in enumerate(shards):
            f = frags[s]
            if f is not None:
                host[:len(row_set), si] = f.rows_dense(row_set, width)
        array = torch.from_numpy(host.view(np.int32)).to(self.device)
        slots = {r: i for i, r in enumerate(row_set)}
        return ViewBank(array, slots, cap - 1, versions)

    @staticmethod
    def _patch_bank(cached: ViewBank, frags: Dict[int, Optional[Fragment]],
                    versions: Dict[int, int], row_set: List[int],
                    shards: Tuple[int, ...], width: int
                    ) -> Optional[ViewBank]:
        """A new bank from a stale one: the (row, shard) cells of rows
        written since it was built are regathered, rows new to the view
        take the free slots after the last one, and every other slot
        keeps its row (an emptied row keeps its slot, now zero). None
        when a rebuild is needed: the new rows do not fit, a fragment
        appeared or has no record of its writes, or the patch would
        touch half the bank. The cached tensor is never written: a
        batch may still read it."""
        new_rows = [r for r in row_set if r not in cached.slots]
        if len(cached.slots) + len(new_rows) + 1 > cached.array.shape[0]:
            return None
        patches = []  # (slot, shard index, words)
        for si, s in enumerate(shards):
            f = frags[s]
            old = cached.versions.get(s, -1)
            if f is None or f.version == old:
                continue
            if old < 0:
                return None
            for r in f.rows_changed_since(old):
                if r in cached.slots:
                    patches.append((cached.slots[r], si,
                                    f.rows_dense([r], width)[0]))
        slots = dict(cached.slots)
        for r in new_rows:
            slot = len(slots)
            slots[r] = slot
            for si, s in enumerate(shards):
                f = frags[s]
                if f is not None:
                    patches.append((slot, si, f.rows_dense([r], width)[0]))
        total_cells = cached.array.shape[0] * cached.array.shape[1]
        if len(patches) > max(16, total_cells // 2):
            return None
        array = cached.array
        if patches:
            dev = array.device
            rows_idx = torch.tensor([p[0] for p in patches], device=dev)
            shard_idx = torch.tensor([p[1] for p in patches], device=dev)
            words = torch.from_numpy(
                np.stack([p[2] for p in patches]).view(np.int32)).to(dev)
            array = array.clone()
            array[rows_idx, shard_idx] = words
        return ViewBank(array, slots, cached.zero_slot, versions)

    # -- positions banks -----------------------------------------------------

    def _flush_segment(self, pos16: np.ndarray, lens: np.ndarray,
                       row_lo: int):
        """One device segment of rows with positions ``pos16`` (back to
        back) and lengths ``lens``: fixed when every row fits
        PBANK_FIXED_ROW_SLOTS and the padded matrix is at least
        PBANK_FIXED_MIN_DENSITY full, else flat. Row counts pad by
        _row_pad so segment shapes repeat. Returns (segment, nbytes)."""
        p, n = len(pos16), len(lens)
        n_pad = _row_pad(n)
        L = int(lens.max()) if n else 0
        if 0 < L <= PBANK_FIXED_ROW_SLOTS \
                and p >= PBANK_FIXED_MIN_DENSITY * n * L:
            mat = np.full((n + n_pad, L), PBANK_PAD, np.uint16)
            mat[:n][np.arange(L)[None, :] < lens[:, None]] = pos16
            lens32 = np.zeros(n + n_pad, np.int32)
            lens32[:n] = lens
            seg = (row_lo, n, torch.from_numpy(mat.view(np.int16)).to(
                self.device), torch.from_numpy(lens32).to(self.device), p)
            return seg, (n + n_pad) * L * 2 + (n + n_pad) * 4
        starts = np.zeros(n + n_pad + 1, np.int64)
        np.cumsum(lens, out=starts[1:n + 1])
        starts[n + 1:] = starts[n]  # pad rows: empty ranges
        # Positions pad to a 1M multiple, not a power of two (which could
        # nearly double a large bank).
        padded = max(1 << 20, -(-p // (1 << 20)) * (1 << 20))
        buf = np.full(padded, PBANK_PAD, np.uint16)
        buf[:p] = pos16
        seg = (row_lo, n, torch.from_numpy(buf.view(np.int16)).to(
            self.device), torch.from_numpy(starts.astype(np.int32)).to(
            self.device), p)
        return seg, padded * 2 + (n + n_pad + 1) * 4

    def _build_pbank_segments(self, frag: Fragment, rows: Sequence[int],
                              width: int, row_lo0: int):
        """Gather ``rows`` (sorted) into device segments starting at global
        row index ``row_lo0``: (segments, nbytes), or None when the rows
        are too dense for positions (see Fragment.rows_positions)."""
        segments: list = []
        nbytes = 0
        pos_parts: list = []
        lens_parts: list = []
        cur_p = 0
        row_lo = row_lo0

        def flush():
            nonlocal pos_parts, lens_parts, cur_p, row_lo, nbytes
            if not lens_parts:
                return
            pos16 = (np.concatenate(pos_parts) if pos_parts
                     else np.empty(0, np.uint16))
            lens = np.concatenate(lens_parts)
            seg, nb = self._flush_segment(pos16, lens, row_lo)
            segments.append(seg)
            nbytes += nb
            pos_parts, lens_parts = [], []
            cur_p = 0
            row_lo += len(lens)

        for c0 in range(0, len(rows), PBANK_GATHER_ROWS):
            chunk = rows[c0:c0 + PBANK_GATHER_ROWS]
            rp = frag.rows_positions(chunk, width)
            if rp is None:
                return None
            pos16, lens, rows_at = rp
            if len(rows_at) != len(chunk):
                full = np.zeros(len(chunk), np.int64)
                full[rows_at] = lens
                lens = full
            # Enforce the segment cap exactly, splitting this chunk on
            # row boundaries where it does not fit.
            ends = np.cumsum(lens)
            taken = 0
            while taken < len(lens):
                room = PBANK_SEGMENT_POSITIONS - cur_p
                hi = int(np.searchsorted(ends, ends[taken - 1] + room
                                         if taken else room, "right"))
                if hi <= taken:
                    flush()
                    continue
                lo_p = int(ends[taken - 1]) if taken else 0
                hi_p = int(ends[hi - 1])
                pos_parts.append(pos16[lo_p:hi_p])
                lens_parts.append(lens[taken:hi])
                cur_p += hi_p - lo_p
                taken = hi
                if cur_p >= PBANK_SEGMENT_POSITIONS:
                    flush()
        flush()
        return segments, nbytes

    def positions_bank(self, shard: int, width: int
                       ) -> Optional[PositionsBank]:
        """Device-resident PositionsBank of one shard at ``width`` words,
        or None when the layout does not qualify: no fragment, a width
        reaching the pad position's word, or rows too dense for
        positions. Cached per (shard, width) and stamped with the
        fragment's version. A write makes it stale; when the row set is
        unchanged the rebuild regathers only the segments holding rows
        written since (``_patch_pbank``), the rest keep their device
        arrays."""
        if width * 32 >= CONTAINER_BITS:
            return None
        key = ("pbank", shard, width)
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                return None
            with frag._lock:
                versions = {shard: frag.version}
                cached = self._bank_cache.get(key)
                if cached is not None and cached.versions == versions:
                    return cached
                row_ids = frag.row_ids()
                built = None
                if cached is not None and cached.row_ids == row_ids:
                    built = self._patch_pbank(cached, frag, width)
                if built is None:
                    # Drop the stale bank before the build, so the two
                    # are never both held.
                    self._bank_cache.pop(key, None)
                    built = self._build_pbank_segments(frag, row_ids,
                                                       width, 0)
                if built is None:
                    return None
                segments, nbytes = built
                bank = PositionsBank(segments, row_ids, versions, nbytes)
                self._bank_cache[key] = bank
                return bank

    def _patch_pbank(self, cached: PositionsBank, frag: Fragment,
                     width: int):
        """Regather only the segments whose rows were written since the
        cached build; clean segments carry over with their device arrays.
        Returns (segments, nbytes), or None to force a full rebuild
        (nothing known, too much changed, or a dirty range no longer
        rebuilds to the same row count)."""
        changed = np.asarray(frag.rows_changed_since(
            next(iter(cached.versions.values()))), dtype=np.int64)
        if not len(changed) or len(changed) > len(cached.row_ids) // 4:
            return None
        row_ids = cached.row_ids
        segments: list = []
        nbytes = 0
        row_lo = 0
        for seg in cached.segments:
            s_lo, n_rows, pos_dev, aux_dev, p_real = seg
            # The row set is unchanged and sorted, so a written row lies
            # in this segment exactly when it lies in its id range.
            first, last = row_ids[s_lo], row_ids[s_lo + n_rows - 1]
            if not np.any((changed >= first) & (changed <= last)):
                segments.append((row_lo, n_rows, pos_dev, aux_dev, p_real))
                nbytes += pos_dev.numel() * 2 + aux_dev.numel() * 4
                row_lo += n_rows
                continue
            rebuilt = self._build_pbank_segments(
                frag, row_ids[s_lo:s_lo + n_rows], width, row_lo)
            if rebuilt is None:
                return None
            new_segs, nb = rebuilt
            if sum(s[1] for s in new_segs) != n_rows:
                return None
            segments.extend(new_segs)
            nbytes += nb
            row_lo += n_rows
        return segments, nbytes
