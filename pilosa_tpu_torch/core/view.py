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
whose dense bank would not fit, and ``sparse_bank`` keeps a sparse
view's set positions as the hybrid layout's query operand
(``SparseBank``, read through the ``expand_positions`` kernel).

Every bank is cached in ``_bank_cache`` by key and stamped with the
fragment versions it was built from. Builds run under the view's lock,
so two threads asking for the same bank build it once; a positions bank
also holds its fragment's lock while it gathers, so a concurrent write
lands wholly before or after it. A stale bank is dropped before its
rebuild, so the old and the new one are never both cached. A full dense
bank whose fragments changed is patched where the writes were few
(``_patch_bank``: the written rows' cells, new rows appended at the end,
emptied rows kept in their slots), else rebuilt whole; a positions bank
is patched segment by segment.

Memory. Every cached bank is admitted to the process-wide
``BANK_BUDGET`` and registered with the memory ledger
(``utils/memledger.py``): dense banks as ``bank`` rows with their
padding and sampled live density (which also feeds the plan optimizer's
operand order), positions banks as ``pbank`` and sparse banks as
``sparse_bank`` rows. An admission past the budget evicts the entry with
the highest demotion score (``core/layout.py``), the least recently used
among ties. The host blocks of row-subset banks are cached under
``HOST_BLOCK_BUDGET``, so a bank evicted from the card re-uploads
without a regather. A single-shard narrow build ships the rows' set
positions and expands them on the card (the sparse upload) instead of
uploading the dense block. ``set_layout`` moves the view between the
dense and the sparse layout (``layout_mode``), dropping the other
representation's banks. The bank width (``trimmed_words``) and the
full bank's row-count bound (``row_count_bound``) are memoized by the
fragments' versions: staging asks for them for every view an eval reads.

A view with a ``path`` keeps its fragments at
``<path>/fragments/<shard>`` (the JAX package's layout): ``open`` loads
each, skipping the ``.cache``, ``.snapshotting`` and ``.torn``
sidecars, and ``close`` drops the banks and closes the fragments.
"""

from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.fragment import CONTAINER_BITS, Fragment, \
    bump_epoch, version_epoch
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.memledger import LEDGER
from pilosa_tpu_torch.utils.tracing import span

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"

# Sparse upload: a single-shard narrow build ships its rows' u16
# positions (about 2 B a set bit) and expands them on the card instead of
# uploading the dense block (the JAX package's PILOSA_TPU_SPARSE_UPLOAD).
SPARSE_UPLOAD = True
# Demotion-ranked eviction: under pressure the sparsest, coldest bank
# goes first; False evicts by LRU alone (PILOSA_TPU_LAYOUT_EVICT).
SMART_EVICT = True
# The device budget's share of the card's memory: the rest is left to
# transient banks, expansions, filter rows and the kernels' outputs.
BANK_BUDGET_SHARE = 0.75
# Shard tuples a view keeps version answers for (View._memo_versions).
VERSIONS_MEMO_MAX = 64


class BankBudget:
    """Process-wide accounting of cached banks against a byte budget.
    Evicted banks drop out of their view's cache (the tensor frees once
    the last query holding it is done).

    Eviction is demotion-ranked: the victim is the entry with the
    highest demotion score ((1 - live density) * bytes / (1 + read
    rate), ``core/layout.demotion_scores``), so the sparsest, coldest
    bank goes first; entries the ledger cannot price score 0, and ties
    go to the least recently used. ``SMART_EVICT = False`` is plain LRU.

    ``budget`` None means: the card's own, resolved at the first
    admission from a CUDA view (``BANK_BUDGET_SHARE`` of its memory);
    on the CPU, unbounded until set."""

    # Ledger categories a view registers its cached entries under; an
    # eviction clears whichever one the key belongs to.
    LEDGER_CATEGORIES = ("bank", "pbank", "sparse_bank", "host_block")

    def __init__(self, budget_bytes: Optional[int] = None,
                 cache_attr: str = "_bank_cache"):
        self.budget = budget_bytes
        self.cache_attr = cache_attr
        self._lock = threading.Lock()
        # (id(view), key) -> (view, nbytes), oldest first.
        self._entries: "OrderedDict" = OrderedDict()
        self.total = 0
        self.evictions = 0

    def resolve(self, device: torch.device) -> Optional[int]:
        """Set an unset budget to the card's own for a CUDA ``device``;
        returns the budget (None: unbounded)."""
        if self.budget is None and device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            self.budget = int(BANK_BUDGET_SHARE * props.total_memory)
        return self.budget

    def limit(self, view: Optional["View"] = None) -> float:
        """The budget in bytes (the card's own resolved on the first CUDA
        view); unbounded while unset."""
        if view is not None:
            self.resolve(view.device)
        return math.inf if self.budget is None else self.budget

    def _eviction_scores(self) -> Dict[Any, float]:
        """Demotion scores of the current entries, once per admission's
        eviction run (under the lock; the ledger and workload locks are
        taken strictly after it)."""
        if not SMART_EVICT or len(self._entries) < 2:
            return {}
        try:
            from pilosa_tpu_torch.core.layout import demotion_scores
            return demotion_scores(self._entries)
        except Exception:
            return {}

    def _pick_victim(self, scores: Dict[Any, float]) -> Any:
        """Highest demotion score wins; ties and unscored entries go to
        the least recently used."""
        if scores:
            best_ek, best = None, -1.0
            for ek in self._entries:  # oldest first: LRU breaks ties
                sc = scores.get(ek, 0.0)
                if sc > best:
                    best_ek, best = ek, sc
            if best_ek is not None and best > 0.0:
                return best_ek
        return next(iter(self._entries))

    def admit(self, view: "View", key, nbytes: Optional[int] = None
              ) -> None:
        cache = getattr(view, self.cache_attr)
        if nbytes is None:
            bank = cache.get(key)
            if bank is None:
                return
            nbytes = int(bank.array.numel()) * 4
        limit = self.limit(view)
        ek = (id(view), key)
        with self._lock:
            old = self._entries.pop(ek, None)
            if old is not None:
                self.total -= old[1]
            scores = None
            while self._entries and self.total + nbytes > limit:
                if scores is None:
                    scores = self._eviction_scores()
                vid, vkey = self._pick_victim(scores)
                scores.pop((vid, vkey), None)
                v, nb = self._entries.pop((vid, vkey))
                self.total -= nb
                self.evictions += 1
                getattr(v, self.cache_attr).pop(vkey, None)
                for cat in self.LEDGER_CATEGORIES:
                    LEDGER.unregister(cat, (vid, vkey))
            self._entries[ek] = (view, nbytes)
            self.total += nbytes

    def touch(self, view: "View", key) -> None:
        ek = (id(view), key)
        with self._lock:
            if ek in self._entries:
                self._entries.move_to_end(ek)

    def forget(self, view: "View", key) -> None:
        with self._lock:
            old = self._entries.pop((id(view), key), None)
            if old is not None:
                self.total -= old[1]
        for cat in self.LEDGER_CATEGORIES:
            LEDGER.unregister(cat, (id(view), key))


# The device budget of every cached bank (the card's own by default, see
# BankBudget), and the host-memory budget of cached row-subset blocks.
BANK_BUDGET = BankBudget()
HOST_BLOCK_BUDGET = BankBudget(1 << 30, cache_attr="_host_blocks")

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


class _RowSlots(Mapping):
    """Row id -> slot over a sorted row-id array (slot = index): the
    mapping a ViewBank keeps as a dict, without a dict of millions of
    entries."""

    __slots__ = ("rows",)

    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def __getitem__(self, row_id: int) -> int:
        if not 0 <= row_id < (1 << 64):
            raise KeyError(row_id)
        i = int(np.searchsorted(self.rows, np.uint64(row_id)))
        if i < len(self.rows) and int(self.rows[i]) == row_id:
            return i
        raise KeyError(row_id)

    def __iter__(self):
        return iter(self.rows.tolist())

    def __len__(self) -> int:
        return len(self.rows)


class SparseBank:
    """A view's rows as their set positions on the device, the hybrid
    layout's query operand: about 4 bytes a set bit where a dense row
    costs ``4 * width`` bytes per shard. ``arrays`` is the stable pair
    ``(pos, starts)``: ``pos`` int32 [P_pad] holds ``(shard_idx << 16) |
    bitpos`` (the JAX package's uint32 bits), each row's positions back
    to back by shard; ``starts`` int32 [capacity + 1] the row slots'
    offsets, rows past the real ones empty, so an absent row resolves to
    the empty ``zero_slot`` as in a dense bank. ``expand_positions``
    turns slots of it into the dense rows they stand for."""

    __slots__ = ("arrays", "slots", "zero_slot", "versions", "nbytes",
                 "width", "n_shards", "n_rows")

    def __init__(self, arrays, slots, zero_slot, versions, nbytes,
                 width, n_shards, n_rows):
        self.arrays = arrays        # (pos int32 [P_pad], starts [cap + 1])
        self.slots = slots          # row id -> slot
        self.zero_slot = zero_slot
        self.versions = versions    # {shard: fragment.version} at build
        self.nbytes = nbytes
        self.width = width          # the dense width its rows expand to
        self.n_shards = n_shards
        self.n_rows = n_rows

    def slot(self, row_id: int) -> int:
        return self.slots.get(row_id, self.zero_slot)


def _expand_sparse_chunk(pos16: np.ndarray, lens: np.ndarray,
                         rows_at: np.ndarray, cap: int, width: int,
                         device: torch.device) -> torch.Tensor:
    """The int32 [cap, 1, width] bank of rows ``rows_at`` (slots) with
    positions ``pos16`` back to back (``lens`` each), expanded on the
    device by ``expand_positions`` over slots 0..cap-1."""
    from pilosa_tpu_torch.ops import kernels
    starts = np.zeros(cap + 1, np.int64)
    starts[np.asarray(rows_at, np.int64) + 1] = lens
    np.cumsum(starts, out=starts)
    pos = torch.from_numpy(pos16.astype(np.int32)).to(device)
    st = torch.from_numpy(starts.astype(np.int32)).to(device)
    return kernels.expand_positions(pos, st, np.arange(cap, dtype=np.int32),
                                    1, width)


def _row_union(frags) -> List[int]:
    """Sorted union of the fragments' row ids."""
    per = [f.row_ids() for f in frags if f is not None]
    per = [p for p in per if p]
    if not per:
        return []
    if len(per) == 1:
        return list(per[0])
    return np.unique(np.concatenate(
        [np.asarray(p, dtype=np.uint64) for p in per])).tolist()


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


def _note_build(sp: Any, rows: int, nbytes: int, patched: bool) -> None:
    """A ``Bank.build`` span's attributes: its rows, its device bytes and
    whether it patched a stale bank."""
    if sp is not None:
        sp.set("rows", rows)
        sp.set("bytes", int(nbytes))
        sp.set("patched", patched)


def _bank_nbytes(array: Any) -> int:
    """Device bytes of a dense bank (int32 words, [R, S, W])."""
    return math.prod(int(x) for x in array.shape) * 4


def _key_shards(key: tuple) -> tuple:
    """The shards a bank cache key covers: ``(shards, trim[, rows]
    [, mesh])``, ``("sbank", shards, width)`` or ``("pbank", shard,
    width)``."""
    if key[0] == "sbank":
        return key[1]
    if key[0] == "pbank":
        return (key[1],)
    return key[0]


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
                 path: Optional[str] = None, index: str = ""):
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.device = device
        self.max_columns = max_columns
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.fragments: Dict[int, Fragment] = {}
        self._lock = threading.RLock()
        # version_stamp/shard_versions answers by shard tuple, each with
        # the fragment epoch read before it was computed.
        self._versions_memo: Dict[Any, Tuple[int, tuple]] = {}
        # "dense" serves Row leaves from ViewBanks, "sparse" from the
        # SparseBank (core/layout.py). Staging reads it once per bank key,
        # and both layouts hold the same bits, so a flip mid-query only
        # changes which representation the next staging picks.
        self.layout_mode = "dense"
        self._bank_cache: Dict[tuple, object] = {}
        # Host blocks of row-subset banks: key -> (block, versions,
        # slots), bounded process-wide by HOST_BLOCK_BUDGET.
        self._host_blocks: Dict[tuple, tuple] = {}
        self._merged_rows: Dict[tuple, tuple] = {}
        # (fragment versions, value) of trimmed_words / row_count_bound.
        self._trim_memo: Optional[Tuple[tuple, int]] = None
        self._bound_memo: Optional[Tuple[tuple, int]] = None

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)


    def value(self, column_id: int, bit_depth: int) -> Tuple[int, bool]:
        """The BSI base value of a column (``Fragment.value``); (0,
        False) without its shard's fragment."""
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(column_id, bit_depth)
    def version_stamp(self) -> tuple:
        """Every fragment's write version as one tuple: the stamp the
        result cache's request tier validates against. Any write in the
        view changes it (versions are never reused, a new fragment's
        too)."""
        return self._memo_versions(None, lambda: tuple(sorted(
            (s, f.version) for s, f in self.fragments.items())))

    def shard_versions(self, shards: Sequence[int]) -> tuple:
        """``((shard, version or -1), ...)`` over ``shards``: the version
        map a bank over them is stamped with, read without building it
        (the result cache's eval-tier generation)."""
        frags = self.fragments
        return self._memo_versions(tuple(shards), lambda: tuple(sorted(
            (s, f.version if f is not None else -1)
            for s, f in ((s, frags.get(s)) for s in set(shards)))))

    def _memo_versions(self, key: Any, compute: Any) -> tuple:
        """``compute()`` under the view's lock, or its memo while no
        fragment has moved since: the epoch is read first, so a write
        that lands during the computation leaves the memo stale."""
        epoch = version_epoch()
        memo = self._versions_memo.get(key)
        if memo is not None and memo[0] == epoch:
            return memo[1]
        with self._lock:
            out = compute()
        if len(self._versions_memo) >= VERSIONS_MEMO_MAX:
            self._versions_memo.clear()
        self._versions_memo[key] = (epoch, out)
        return out

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(shard, cache_type=self.cache_type,
                        cache_size=self.cache_size,
                        path=None if self.path is None else os.path.join(
                            self.path, "fragments", str(shard)),
                        owner=(self.index, self.field, self.name))

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = self._new_fragment(shard)
                frag.open()
                self.fragments[shard] = frag
                bump_epoch()
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
            bump_epoch()

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
        """Forget every cached bank and host block, with their budget
        entries and ledger rows (the view closes, or its field or index
        was deleted); the device memory goes when no query holds it."""
        with self._lock:
            for key in list(self._bank_cache):
                BANK_BUDGET.forget(self, key)
            self._bank_cache.clear()
            for key in list(self._host_blocks):
                HOST_BLOCK_BUDGET.forget(self, key)
            self._host_blocks.clear()
            self._merged_rows.clear()

    def remove_fragment(self, shard: int) -> Optional[Fragment]:
        """Drop the shard's fragment (a resize left this node without
        it): close it, delete its file and count-cache sidecar, move the
        write epoch (so no version memo outlives it), and forget every
        cached bank, host block and merged row list whose shards include
        it, with their budget entries and ledger rows. Returns the
        fragment, or None when the view had none."""
        with self._lock:
            frag = self.fragments.pop(shard, None)
            if frag is None:
                return None
            bump_epoch()
            for key in list(self._bank_cache):
                if shard in _key_shards(key):
                    self._bank_cache.pop(key, None)
                    BANK_BUDGET.forget(self, key)
            for key in list(self._host_blocks):
                if shard in key[0]:
                    self._host_blocks.pop(key, None)
                    HOST_BLOCK_BUDGET.forget(self, key)
            for key in list(self._merged_rows):
                if shard in key:
                    self._merged_rows.pop(key, None)
            frag.close()
        if frag.path is not None:
            for p in (frag.path, frag.cache_path()):
                if os.path.exists(p):
                    os.remove(p)
        return frag

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
        # Every write takes a new process-unique version, so an equal
        # version tuple means an unchanged view: staging asks for the
        # width of each view several times an eval.
        versions = tuple(f.version for f in frags)
        memo = self._trim_memo
        if memo is not None and memo[0] == versions:
            return memo[1]
        max_off = max((f.max_column_offset() for f in frags), default=-1)
        words = (max_off // 32) + 1
        width = cwords if max_off < 0 else min(
            WORDS_PER_SHARD, ((words + cwords - 1) // cwords) * cwords)
        self._trim_memo = (versions, width)
        return width

    def row_count_bound(self, shards: Sequence[int]) -> int:
        """The sum of the shards' fragments' row counts: an upper bound
        on the full bank's rows with no union, memoized by the fragments'
        versions."""
        frags = [f for f in map(self.fragments.get, shards) if f is not None]
        key = (tuple(shards), tuple(f.version for f in frags))
        memo = self._bound_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        bound = sum(len(f.row_ids()) for f in frags)
        self._bound_memo = (key, bound)
        return bound

    # -- dense banks ---------------------------------------------------------

    def _ledger_bank(self, cache_key, bank: ViewBank, n_rows: int,
                     live_density: Optional[float] = None) -> None:
        """Register a cached dense bank with the ledger: its bytes, the
        pow2 padding (capacity rows past the real ones and the zero
        slot), and the sampled live density of its real rows, which also
        feeds the plan optimizer's operand order. Keyed as the budget
        entry, which unregisters it on eviction."""
        cap, n_sh, w = (int(x) for x in bank.array.shape)
        row_bytes = n_sh * w * 4
        meta = dict(index=self.index, field=self.field, view=self.name,
                    nShards=n_sh, rows=n_rows)
        if live_density is not None:
            meta["liveDensity"] = round(float(live_density), 6)
            from pilosa_tpu_torch.ops import plan_opt
            plan_opt.note_bank_density(bank.array, live_density)
        LEDGER.register("bank", cache_key, cap * row_bytes,
                        padded_bytes=max(0, cap - n_rows - 1) * row_bytes,
                        owner=self, **meta)

    # Rows popcounted per bank build for the live density.
    DENSITY_SAMPLE_ROWS = 256

    def _sampled_live_density(self, frags, row_set, width: int,
                              shards) -> Optional[float]:
        """Share of the real row slots' bits that are set, from an even
        sample of rows (host popcounts only); None with nothing to
        sample."""
        if not row_set or not shards or width <= 0:
            return None
        step = max(1, len(row_set) // self.DENSITY_SAMPLE_ROWS)
        sample = row_set[::step][:self.DENSITY_SAMPLE_ROWS]
        try:
            bits = 0
            for sh in shards:
                f = frags.get(sh)
                if f is None:
                    continue
                for r in sample:
                    bits += f.row_count(r)
            denom = len(sample) * len(shards) * width * 32
            return min(1.0, bits / denom) if denom else None
        except Exception:
            return None  # density is a hint; it never fails a build

    def device_bank(self, shards: Sequence[int],
                    rows: Optional[Sequence[int]] = None,
                    trim: bool = False, cache_rows: bool = False,
                    mesh: Any = None) -> ViewBank:
        """Bank for ``shards`` covering ``rows`` (default: every row present
        in any of the shards). The full bank is cached per (shards, trim)
        and rebuilt when any fragment's version moved. A ``rows`` subset
        builds a transient bank, or with ``cache_rows=True`` one cached
        under a key that includes the rows: the executor's Row leaf uses
        it for views whose full bank is over budget. Either way the
        subset's host block is cached (``HOST_BLOCK_BUDGET``), so a
        rebuild after an eviction re-uploads without a regather.
        ``trim=True`` narrows the word axis to trimmed_words(), valid for
        whole-row consumers since the dropped tail is all-zero. A stale
        full bank of the same width is patched when it can be
        (``_patch_bank``), so its slots keep their rows; consumers map
        rows to slots through ``slots`` and never assume them ascending.
        Cached banks are admitted to ``BANK_BUDGET`` and ledgered.

        With a ``mesh`` (``parallel/mesh.MeshContext``) the bank is
        sharded over the mesh's shard axis (``put_bank``: one contiguous
        ``[R, S/D, W]`` part a shard device), ``shards`` being the
        padded list whose absent shards are all-zero columns; the cache
        key gains the mesh's key. A sharded bank is rebuilt, never
        patched, and never takes the sparse upload."""
        shards = tuple(shards)
        mesh_key = (mesh.cache_key(),) if mesh is not None else ()
        with self._lock:
            frags = {sh: self.fragments.get(sh) for sh in shards}
            versions = {sh: (f.version if f else -1)
                        for sh, f in frags.items()}
            width = self.trimmed_words() if trim else WORDS_PER_SHARD
            cached = None
            if rows is None:
                cache_key: Optional[Tuple] = (shards, trim) + mesh_key
                row_set = None
            else:
                row_set = sorted(set(rows))
                cache_key = (shards, trim, tuple(row_set)) + mesh_key \
                    if cache_rows else None
            if cache_key is not None:
                cached = self._bank_cache.get(cache_key)
                if cached is not None and cached.versions == versions \
                        and cached.array.shape[-1] == width:
                    BANK_BUDGET.touch(self, cache_key)
                    if row_set is not None:
                        HOST_BLOCK_BUDGET.touch(
                            self, (shards, width, tuple(row_set)))
                    return cached
            prior = None
            if cached is not None:
                if row_set is None:
                    # Writes just cost a patch or a rebuild: record which
                    # fragments moved, for the workload recorder.
                    moved = [sh for sh, v in versions.items()
                             if cached.versions.get(sh) != v]
                    WORKLOAD.record_invalidation(
                        self.index, self.field, self.name,
                        moved or list(shards))
                    prior = LEDGER.entry_info(("bank",),
                                              (id(self), cache_key))
                # Drop the stale bank before the build, so the old and
                # the new bank are never both held by the cache.
                self._bank_cache.pop(cache_key, None)
                BANK_BUDGET.forget(self, cache_key)
            with span("Bank.build", kind="device_bank") as sp:
                if row_set is None:
                    row_set = _row_union(frags.values())
                    if cached is not None and mesh is None \
                            and cached.array.shape[-1] == width:
                        patched = self._patch_bank(cached, frags,
                                                   versions, row_set,
                                                   shards, width)
                        if patched is not None:
                            # A patch moves the density little: keep the
                            # prior estimate instead of resampling.
                            self._bank_cache[cache_key] = patched
                            BANK_BUDGET.admit(self, cache_key)
                            self._ledger_bank(
                                cache_key, patched, len(row_set),
                                live_density=(prior or {}).get(
                                    "liveDensity"))
                            _note_build(sp, len(row_set),
                                        _bank_nbytes(patched.array), True)
                            return patched
                subset = rows is not None
                bank = self._build_bank(frags, shards, row_set, width,
                                        versions, subset, mesh)
                if cache_key is not None:
                    self._bank_cache[cache_key] = bank
                    BANK_BUDGET.admit(self, cache_key)
                    self._ledger_bank(
                        cache_key, bank, len(row_set),
                        live_density=self._sampled_live_density(
                            frags, row_set, width, shards))
                _note_build(sp, len(row_set), _bank_nbytes(bank.array),
                            False)
                return bank

    def _build_bank(self, frags: Dict[int, Optional[Fragment]],
                    shards: Tuple[int, ...], row_set: List[int], width: int,
                    versions: Dict[int, int], subset: bool,
                    mesh: Any = None) -> ViewBank:
        """A new bank of ``row_set``: from a cached host block of the
        subset, else by the sparse upload (one shard, a width within one
        container), else from a gathered dense host block, which a subset
        caches under HOST_BLOCK_BUDGET."""
        cap = bank_capacity(len(row_set))
        hb_key = (shards, width, tuple(row_set)) if subset else None
        host = slots = None
        if hb_key is not None:
            entry = self._host_blocks.get(hb_key)
            if entry is not None:
                if entry[1] == versions:
                    host, _v, slots = entry
                    HOST_BLOCK_BUDGET.touch(self, hb_key)
                else:
                    self._host_blocks.pop(hb_key, None)
                    HOST_BLOCK_BUDGET.forget(self, hb_key)
        array = None
        if host is None and SPARSE_UPLOAD and mesh is None \
                and len(shards) == 1 \
                and width * 32 <= CONTAINER_BITS and cap * width < (1 << 31):
            f = frags[shards[0]]
            with span("Fragment.rowsPositions", rows=len(row_set)):
                sp = (f.rows_positions(row_set, width) if f is not None else
                      (np.empty(0, np.uint16), np.empty(0, np.int64),
                       np.empty(0, np.int64)))
            if sp is not None:
                with span("Bank.upload"):
                    array = _expand_sparse_chunk(*sp, cap, width,
                                                 self.device)
                slots = {r: i for i, r in enumerate(row_set)}
        if array is None:
            if host is None:
                host = np.zeros((cap, len(shards), width), dtype=np.uint32)
                with span("Fragment.rowsDense", rows=len(row_set)):
                    for si, sh in enumerate(shards):
                        f = frags[sh]
                        if f is not None:
                            host[:len(row_set), si] = f.rows_dense(row_set,
                                                                   width)
                slots = {r: i for i, r in enumerate(row_set)}
                # The slots dict is host memory too (about 100 B an
                # entry): counted with the block.
                entry_bytes = host.nbytes + 100 * len(row_set)
                if hb_key is not None and \
                        0 < entry_bytes <= HOST_BLOCK_BUDGET.limit():
                    self._host_blocks[hb_key] = (host, versions, slots)
                    HOST_BLOCK_BUDGET.admit(self, hb_key, nbytes=entry_bytes)
                    LEDGER.register(
                        "host_block", hb_key, entry_bytes,
                        padded_bytes=max(0, cap - len(row_set) - 1)
                        * len(shards) * width * 4,
                        owner=self, index=self.index, field=self.field,
                        view=self.name, nShards=len(shards),
                        rows=len(row_set))
            with span("Bank.upload"):
                array = mesh.put_bank(host) if mesh is not None else \
                    torch.from_numpy(host.view(np.int32)).to(self.device)
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
            with span("Bank.upload", rows=len(lens)):
                seg, nb = self._flush_segment(pos16, lens, row_lo)
            segments.append(seg)
            nbytes += nb
            pos_parts, lens_parts = [], []
            cur_p = 0
            row_lo += len(lens)

        for c0 in range(0, len(rows), PBANK_GATHER_ROWS):
            chunk = rows[c0:c0 + PBANK_GATHER_ROWS]
            with span("Fragment.rowsPositions", rows=len(chunk)):
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
                    BANK_BUDGET.touch(self, key)
                    return cached
                with span("Bank.build", kind="positions_bank") as sp:
                    row_ids = frag.row_ids()
                    built = None
                    if cached is not None and cached.row_ids == row_ids:
                        built = self._patch_pbank(cached, frag, width)
                    patched = built is not None
                    if built is None:
                        # Drop the stale bank before the build, so the two
                        # are never both held.
                        if self._bank_cache.pop(key, None) is not None:
                            BANK_BUDGET.forget(self, key)
                        built = self._build_pbank_segments(frag, row_ids,
                                                           width, 0)
                    if built is None:
                        return None
                    segments, nbytes = built
                    _note_build(sp, len(row_ids), nbytes, patched)
                bank = PositionsBank(segments, row_ids, versions, nbytes)
                self._bank_cache[key] = bank
                BANK_BUDGET.admit(self, key, nbytes=nbytes)
                # Ideal footprint: 2 B a real position and one int32 a
                # row (+1); the rest is padding.
                ideal = sum(p * 2 + (n + 1) * 4
                            for _, n, _, _, p in segments)
                LEDGER.register(
                    "pbank", key, nbytes, padded_bytes=max(0, nbytes - ideal),
                    owner=self, index=self.index, field=self.field,
                    view=self.name, shard=shard, rows=len(row_ids))
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

    # -- hybrid layout (driven by core/layout.py) ----------------------------

    def set_layout(self, mode: str) -> bool:
        """Flip the view's serving layout ("dense" | "sparse"); True when
        it changed. The flip drops the other representation's cached
        device banks (the positions bank stays with the sparse layout),
        so their memory frees at once; host blocks stay. Data is never
        touched: a query staged before the flip serves from the
        representation it planned against, and both hold the same
        bits."""
        if mode not in ("dense", "sparse"):
            raise ValueError(f"unknown layout mode {mode!r}")
        with self._lock:
            if self.layout_mode == mode:
                return False
            self.layout_mode = mode
            drop = []
            for key in list(self._bank_cache):
                tagged = isinstance(key, tuple) and key \
                    and isinstance(key[0], str)
                sparse_key = tagged and key[0] == "sbank"
                pbank_key = tagged and key[0] == "pbank"
                if mode == "sparse" and not (sparse_key or pbank_key):
                    drop.append(key)
                elif mode == "dense" and sparse_key:
                    drop.append(key)
            for key in drop:
                self._bank_cache.pop(key, None)
                BANK_BUDGET.forget(self, key)
        return True

    def _sparse_rows(self, frag: Fragment, row_set: List[int], width: int):
        """``frag.rows_positions(row_set, width)`` gathered in chunks of
        PBANK_GATHER_ROWS rows (bounding the host temporaries), with
        ``lens`` aligned to every row of ``row_set``: (pos16, lens), or
        None when the rows are too dense. A chunk that bails falls back
        to the one whole call, whose density rule is the JAX package's."""
        pos_parts, lens_parts = [], []
        for c0 in range(0, len(row_set), PBANK_GATHER_ROWS):
            chunk = row_set[c0:c0 + PBANK_GATHER_ROWS]
            rp = frag.rows_positions(chunk, width)
            if rp is None:
                if len(chunk) == len(row_set):
                    return None
                rp = frag.rows_positions(row_set, width)
                if rp is None:
                    return None
                pos_parts, lens_parts, chunk = [], [], row_set
            pos16, lens, rows_at = rp
            full = np.zeros(len(chunk), np.int64)
            full[rows_at] = lens
            pos_parts.append(pos16)
            lens_parts.append(full)
            if len(chunk) == len(row_set):
                break
        pos16 = (np.concatenate(pos_parts) if len(pos_parts) > 1 else
                 pos_parts[0] if pos_parts else np.empty(0, np.uint16))
        lens = (np.concatenate(lens_parts) if lens_parts
                else np.zeros(0, np.int64))
        return pos16, lens

    def sparse_bank(self, shards: Sequence[int]) -> Optional[SparseBank]:
        """The device-resident SparseBank of ``shards`` covering every
        present row, or None when the layout does not qualify: a width
        past one container (bit positions are u16), rows too dense for
        positions, or 2^31 positions or more (the offsets are int32). A
        None makes the caller heal the view to dense. Cached per (shards,
        width) and stamped with the fragment versions read before the
        gather, so a racing write makes it stale, never wrong. The arrays
        are the JAX package's ``sparse_bank`` arrays, element for
        element: one shard's positions are stored in row order as they
        come; several shards' are interleaved row by row."""
        shards = tuple(shards)
        with self._lock:
            frags = {sh: self.fragments.get(sh) for sh in shards}
            versions = {sh: (f.version if f else -1)
                        for sh, f in frags.items()}
            width = self.trimmed_words()
            if width * 32 > CONTAINER_BITS:
                return None
            key = ("sbank", shards, width)
            cached = self._bank_cache.get(key)
            if isinstance(cached, SparseBank) and cached.versions == versions:
                BANK_BUDGET.touch(self, key)
                return cached
            if cached is not None:
                self._bank_cache.pop(key, None)
                BANK_BUDGET.forget(self, key)
            row_set = _row_union(frags.values())
            n_rows = len(row_set)
            per_shard = []
            for si, sh in enumerate(shards):
                f = frags[sh]
                if f is None:
                    per_shard.append((np.empty(0, np.uint16),
                                      np.zeros(n_rows, np.int64)))
                    continue
                sp = self._sparse_rows(f, row_set, width)
                if sp is None:
                    return None
                per_shard.append(sp)
            cap = bank_capacity(n_rows)
            if per_shard and n_rows:
                lens_mat = np.stack([ls for _, ls in per_shard])
            else:
                lens_mat = np.zeros((len(shards), n_rows), np.int64)
            row_tot = lens_mat.sum(axis=0)
            total = int(row_tot.sum())
            if total >= (1 << 31):
                return None
            starts = np.zeros(cap + 1, np.int64)
            np.cumsum(row_tot, out=starts[1:n_rows + 1])
            starts[n_rows + 1:] = starts[n_rows]
            p_pad = 1 << max(10, (total - 1).bit_length() if total else 0)
            pos = np.zeros(p_pad, np.uint32)
            if len(shards) == 1:
                # One shard: its positions, in row order, are the array.
                pos[:total] = per_shard[0][0]
            else:
                # Row r's positions go to starts[r] on, shard-ascending.
                prior = np.cumsum(lens_mat, axis=0) - lens_mat
                for si, (pos16, ls) in enumerate(per_shard):
                    if not len(pos16):
                        continue
                    first = np.cumsum(ls) - ls
                    dst = np.repeat(starts[:n_rows] + prior[si] - first,
                                    ls) + np.arange(len(pos16))
                    pos[dst] = pos16.astype(np.uint32) | np.uint32(si << 16)
            starts32 = starts.astype(np.int32)
            arrays = (torch.from_numpy(pos.view(np.int32)).to(self.device),
                      torch.from_numpy(starts32).to(self.device))
            nbytes = int(pos.nbytes + starts32.nbytes)
            slots = _RowSlots(np.asarray(row_set, dtype=np.uint64))
            bank = SparseBank(arrays, slots, cap - 1, versions, nbytes,
                              width, len(shards), n_rows)
            self._bank_cache[key] = bank
            BANK_BUDGET.admit(self, key, nbytes=nbytes)
            # Ideal footprint: 4 B a real position and one int32 offset a
            # real row (+1); the rest is the pow2 pad.
            ideal = total * 4 + (n_rows + 1) * 4
            LEDGER.register(
                "sparse_bank", key, nbytes,
                padded_bytes=max(0, nbytes - ideal), owner=self,
                index=self.index, field=self.field, view=self.name,
                nShards=len(shards), rows=n_rows, positions=total,
                liveDensity=1.0, width=width)
            return bank
