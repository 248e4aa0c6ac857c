"""Fragment: one shard of one view, held in host memory.

Bit (row r, column c) lives at position ``r * 2^20 + (c mod 2^20)`` of
one roaring container store (``storage/roaring.py``): sixteen 2^16-bit
containers per row, each dense or a sorted u16 array. A fingerprint row
of 48 bits costs one 96-byte array container. Every write bumps
``version`` to a value no fragment has held before and stamps the rows
it touched with it (``rows_changed_since``); device banks and caches
compare versions to decide whether they are stale.

Each fragment keeps a TopN count cache (``core/cache.py``) of the type
its field names; every bit write refreshes the written rows' counts
(``_cache_update``), unless a ranked cache has saturated. A fragment's
first bulk load takes them from the import builder's per-container
counts instead of recounting its rows (``_import_set``).

A fragment with a ``path`` keeps its bits in the roaring file format
there (``storage/roaring.py``), as the JAX package's fragment does: a
snapshot, then an op log that every write appends to through an
unbuffered handle before it returns, so a killed process loses no
acknowledged write. Single-bit writes log OP_ADD / OP_REMOVE records,
bulk imports one OP_ADD_ROARING record a chunk of IMPORT_CHUNK_PAIRS
pairs, clears (ClearRow, clearing imports, BSI zero planes) one
OP_REMOVE_BATCH a chunk. The log folds into a new snapshot (written to
``<path>.snapshotting``, fsynced, renamed) after DEFAULT_MAX_OP_N
single-bit records, or once its batch records outgrow
max(OPLOG_FOLD_MIN_BYTES, half the last snapshot); Store and a roaring
import rewrite the snapshot at once. ``open`` moves a record torn by a
crash into a ``.torn`` sidecar and truncates it away, and refuses a
dangling tail larger than any record could be (MAX_TORN_TAIL_BYTES).
The count cache persists in a ``.cache`` sidecar stamped with the
storage file's size and the checksum of its last 64 bytes; a sidecar
whose stamp no longer matches loads cold. Without a path a fragment
lives in memory and writes no records.

Anti-entropy compares fragments a block of HASH_BLOCK_SIZE rows at a
time (``checksum_blocks``): a block's digest is blake2b (16 bytes) over
its sorted absolute positions as little-endian u64, byte for byte the
JAX package's digest, so a port node and a JAX node diff each other.
Digests are cached and every write marks its rows' blocks dirty in
``_touch_rows``, so a pass re-hashes only what changed. ``block_data``
and ``merge_block`` (a union) move one block's bits between replicas;
``replace_with_bytes`` overwrites the whole fragment (the resize pull).

BSI layout: rows 0..bit_depth-1 hold value bits LSB-first; row bit_depth
is the not-null marker.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, SHARD_WIDTH_EXP
from pilosa_tpu_torch.storage.roaring import ARRAY_MAX_SIZE, \
    CONTAINER_BITS, CONTAINER_WORDS, OP_REMOVE_BATCH, Bitmap, \
    _dense_to_array, _popcount_rows, _popcount_words, dense_scatter, \
    fnv1a32, scatter_rows, serialize_import, serialize_positions, \
    sort_unique
from pilosa_tpu_torch.utils.hotspots import WORKLOAD
from pilosa_tpu_torch.utils.logger import default_logger
from pilosa_tpu_torch.utils.tracing import span

# Containers per shard row: 2^20 / 2^16.
CONTAINERS_PER_ROW = SHARD_WIDTH // CONTAINER_BITS

# Snapshot after this many logged single-bit records.
DEFAULT_MAX_OP_N = 10000
# Batch records fold by size: once the log since the snapshot reaches
# max(this, half the last snapshot).
OPLOG_FOLD_MIN_BYTES = 32 << 20
# (row, column) pairs per import record.
IMPORT_CHUNK_PAIRS = 4 << 20
# The largest dangling tail open() treats as a torn append: twice the
# worst legitimate record (a chunk with every pair in its own container,
# 18 bytes a container).
MAX_TORN_TAIL_BYTES = 2 * (18 * IMPORT_CHUNK_PAIRS + (1 << 16))
# Rows an anti-entropy checksum block covers (reference HashBlockSize,
# fragment.go:76).
HASH_BLOCK_SIZE = 100
# Containers a checksum block spans.
_BLOCK_CONTAINERS = HASH_BLOCK_SIZE * CONTAINERS_PER_ROW

_VERSIONS = itertools.count(1)
# Moves after every version a fragment takes and every fragment a view
# adds: a value derived from fragment versions after the epoch was read
# holds while the epoch stays (the views' version memos).
_EPOCH = [0]
_EPOCH_LOCK = threading.Lock()


def _next_version() -> int:
    return next(_VERSIONS)


def version_epoch() -> int:
    return _EPOCH[0]


def bump_epoch() -> None:
    with _EPOCH_LOCK:
        _EPOCH[0] += 1


def _strictly_increasing(a: np.ndarray) -> bool:
    return len(a) < 2 or bool(np.all(a[1:] > a[:-1]))


class Fragment:
    def __init__(self, shard: int,
                 cache_type: str = cache_mod.CACHE_TYPE_RANKED,
                 cache_size: int = cache_mod.DEFAULT_CACHE_SIZE,
                 path: Optional[str] = None,
                 owner: Optional[Tuple[str, str, str]] = None):
        self.shard = shard
        self.path = path
        # (index, field, view) the writes are recorded under in the
        # workload recorder; None records nothing.
        self.owner = owner
        self.storage = Bitmap()
        self._file = None
        self._last_snapshot_bytes = 0
        # Torn-tail bytes moved to the .torn sidecar by open().
        self.tail_dropped_bytes = 0
        self.cache = cache_mod.new_cache(cache_type, cache_size)
        self.cache_type = cache_type
        self.version = _next_version()
        # row id -> version of the last write that touched it.
        self._row_versions: Dict[int, int] = {}
        self._lock = threading.RLock()
        self._row_ids_cache: Tuple[int, Tuple[int, ...]] = (-1, ())
        self._max_col_cache: Tuple[int, int] = (-1, -1)
        # Block digests (None: cold, the next checksum_blocks hashes
        # every block) and the blocks written since they were taken.
        self._block_digests: Optional[Dict[int, bytes]] = None
        self._dirty_blocks: set = set()
        # Set imports the dense builder declined (sorted and grouped),
        # those of them that recounted no row (their counts came from
        # the builder, or the cache wanted none), and seconds in
        # import_bits.
        self.import_sorted_calls = 0
        self.import_batch_calls = 0
        self.import_seconds = 0.0

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> None:
        """Load the file at ``path`` (replaying its op log), or create it
        holding an empty snapshot; then open the append handle, load the
        count cache if its stamp matches, and fold an over-limit log.
        The C++ reader leaves every container in the encoding
        ``optimize`` would choose, so no optimize pass follows."""
        if self.path is None:
            return
        with self._lock:
            data = b""
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    data = f.read()
            if data:
                self.storage.read_bytes(data, tolerate_torn_tail=True)
                nd = self.storage.tail_dropped
                if nd > MAX_TORN_TAIL_BYTES:
                    raise ValueError(
                        f"{self.path}: {nd}-byte dangling op tail exceeds "
                        "the torn-append bound; refusing to truncate")
                if nd:
                    # Keep the torn bytes, then cut them so the next
                    # append starts on a record boundary.
                    self.tail_dropped_bytes += nd
                    default_logger.printf(
                        "%s: moving %d-byte torn op-log tail to sidecar",
                        self.path, nd)
                    with open(self.path + ".torn", "ab") as f:
                        f.write(data[len(data) - nd:])
                    with open(self.path, "r+b") as f:
                        f.truncate(len(data) - nd)
            else:
                # Missing, or empty after a crash before its header: no
                # record can be in it.
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                data = self.storage.write_bytes()
                with open(self.path, "wb") as f:
                    f.write(data)
                self.storage.snapshot_bytes = len(data)
            self._last_snapshot_bytes = self.storage.snapshot_bytes
            self._file = open(self.path, "ab", buffering=0)
            self.storage.op_writer = self._file
            cache_mod.load_cache(self.cache, self.cache_path(),
                                 stamp=self._storage_stamp())
            self._maybe_snapshot()

    def optimize_storage(self) -> int:
        """Re-encode sparse dense containers as arrays (the host
        compaction the layout's demotion runs first: a point write leaves
        its row's container dense); returns the number converted."""
        with self._lock:
            return self.storage.optimize()

    def close(self) -> None:
        """Save the count cache and close the append handle."""
        with self._lock:
            self.flush_cache()
            if self._file is not None:
                self._file.close()
                self._file = None
            self.storage.op_writer = None

    def cache_path(self) -> str:
        return self.path + ".cache"

    def _storage_stamp(self) -> bytes:
        """The storage file's size and the fnv1a32 of its last 64 bytes:
        any write that reached the file after a sidecar was saved
        changes it."""
        try:
            size = os.path.getsize(self.path)
            with open(self.path, "rb") as f:
                f.seek(max(0, size - 64))
                tail = f.read(64)
        except OSError:
            return b""
        return struct.pack("<QI", size, fnv1a32(tail))

    def flush_cache(self) -> None:
        """Write the count cache's sidecar, stamped with the storage
        file as it stands."""
        if self.path is None or self.cache_type == cache_mod.CACHE_TYPE_NONE:
            return
        try:
            cache_mod.save_cache(self.cache, self.cache_path(),
                                 stamp=self._storage_stamp())
        except OSError:
            pass

    def _snapshot(self) -> None:
        """Rewrite the file as one snapshot with no op log: written to
        ``.snapshotting``, fsynced and renamed over the file."""
        if self.path is None:
            return
        tmp = self.path + ".snapshotting"
        if self._file is not None:
            self._file.close()
            self._file = None
            self.storage.op_writer = None
        try:
            data = self.storage.write_bytes()
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.storage.op_n = 0
            self.storage.op_n_small = 0
            self.storage.oplog_bytes = 0
            self._last_snapshot_bytes = self.storage.snapshot_bytes = \
                len(data)
        finally:
            # The old file stands if the snapshot failed; appends go on.
            self._file = open(self.path, "ab", buffering=0)
            self.storage.op_writer = self._file

    def _oplog_over_limit(self) -> bool:
        s = self.storage
        if s.op_n_small >= DEFAULT_MAX_OP_N:
            return True
        return s.oplog_bytes >= max(OPLOG_FOLD_MIN_BYTES,
                                    self._last_snapshot_bytes // 2)

    def _maybe_snapshot(self) -> None:
        if self.path is not None and self._oplog_over_limit():
            self._snapshot()

    def write_bytes(self) -> bytes:
        """The fragment's bits as one snapshot (no op log)."""
        with self._lock:
            return self.storage.write_bytes()

    # -- helpers -----------------------------------------------------------

    def pos(self, row_id: int, column_id: int) -> int:
        """Bit position of (row, column) in the store."""
        if not (self.shard * SHARD_WIDTH <= column_id
                < (self.shard + 1) * SHARD_WIDTH):
            raise ValueError(
                f"column {column_id} out of shard {self.shard} bounds")
        return row_id * SHARD_WIDTH + (column_id % SHARD_WIDTH)

    def _row_present(self, row_id: int) -> bool:
        k0 = row_id * CONTAINERS_PER_ROW
        containers = self.storage.containers
        return any(k in containers for k in range(k0, k0 + CONTAINERS_PER_ROW))

    def _touch_rows(self, row_ids, same_row_set: bool = False) -> None:
        """One version bump for a whole batch of written rows, stamped
        on each of them. ``same_row_set`` says the write left the set of
        present rows as it was, so the cached row_ids carry over."""
        rows = [int(r) for r in row_ids]
        if not rows:
            return
        prev = self.version
        self.version = v = _next_version()
        bump_epoch()
        self._row_versions.update(zip(rows, itertools.repeat(v)))
        # Every mutation funnels through here: the checksum pass
        # re-hashes only these blocks.
        self._dirty_blocks.update(r // HASH_BLOCK_SIZE for r in rows)
        if same_row_set and self._row_ids_cache[0] == prev:
            self._row_ids_cache = (v, self._row_ids_cache[1])
        if self.owner is not None:
            # Every mutation funnels through here: one record of the
            # batch's writes at the new version.
            WORKLOAD.record_write(*self.owner, self.shard, generation=v,
                                  n=len(rows))

    def rows_changed_since(self, version: int) -> List[int]:
        return [r for r, v in self._row_versions.items() if v > version]

    # -- TopN count cache --------------------------------------------------

    def _cache_update(self, row_ids) -> None:
        """Refresh the count cache for written rows. Skipped when there
        is no cache or a ranked cache has saturated: the warm read can
        never fire again, so neither the recount nor the upkeep buys
        anything."""
        if not self._cache_needs_counts():
            return
        for r in row_ids:
            self.cache.add(int(r), self.row_count(int(r)))

    def recalculate_cache(self) -> None:
        """Rebuild the count cache from storage (a saturated ranked
        cache starts over)."""
        with self._lock:
            self.cache.invalidate()
            for r in self.row_ids():
                self.cache.add(r, self.row_count(r))

    def _prelatch_cache_saturation(self, touched: np.ndarray) -> None:
        """Latch a ranked cache's saturation up front when this batch's
        rows will pass its bound anyway: a 10M-row load must not recount
        every row for a cache that can never serve a read."""
        cache = self.cache
        if not isinstance(cache, cache_mod.RankedCache) or cache.saturated:
            return
        total = len(cache.counts.keys() | set(touched.tolist()))
        if total > cache.size * cache_mod.THRESHOLD_FACTOR:
            cache.saturated = True

    # -- single-bit writes -------------------------------------------------

    def set_bit(self, row_id: int, column_id: int) -> bool:
        p = self.pos(row_id, column_id)
        with self._lock:
            present = self._row_present(row_id)
            changed = self.storage.add(p)
            if changed:
                self._touch_rows((row_id,), same_row_set=present)
                self._cache_update((row_id,))
                self._maybe_snapshot()
            return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        p = self.pos(row_id, column_id)
        with self._lock:
            changed = self.storage.remove(p)
            if changed:
                self._touch_rows((row_id,),
                                 same_row_set=self._row_present(row_id))
                self._cache_update((row_id,))
                self._maybe_snapshot()
            return changed

    def bit(self, row_id: int, column_id: int) -> bool:
        return self.storage.contains(self.pos(row_id, column_id))

    # -- bulk writes -------------------------------------------------------

    def import_bits(self, row_ids: np.ndarray, offsets: np.ndarray,
                    clear: bool = False) -> None:
        """Set (or clear) every (row, column) pair; columns are taken
        modulo the shard width. Sets go in chunks of IMPORT_CHUNK_PAIRS
        pairs, one OP_ADD_ROARING record each; clears as one
        OP_REMOVE_BATCH record a chunk of sorted positions."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        offs = np.asarray(offsets, dtype=np.uint64)
        if len(rows) == 0:
            return
        t0 = time.perf_counter()
        with span("Fragment.import", shard=self.shard, pairs=len(rows)), \
                self._lock:
            sorted_, counted = False, None
            if clear:
                positions = np.unique(
                    rows * np.uint64(SHARD_WIDTH)
                    + offs % np.uint64(SHARD_WIDTH))
                for i in range(0, len(positions), IMPORT_CHUNK_PAIRS):
                    self.storage.remove_batch(
                        positions[i:i + IMPORT_CHUNK_PAIRS])
                touched = np.unique(positions >> np.uint64(SHARD_WIDTH_EXP))
            else:
                touched, sorted_, counted = self._import_set(rows, offs)
            self._prelatch_cache_saturation(touched)
            touched_rows = touched.tolist()
            with span("Fragment.touchRows", rows=len(touched_rows)):
                self._touch_rows(touched_rows)
            needs = self._cache_needs_counts()
            with span("Fragment.cacheUpdate", rows=len(touched_rows)):
                if needs and counted is not None:
                    counts = self._batch_row_counts(*counted).tolist()
                    if isinstance(self.cache, cache_mod.RankedCache):
                        self.cache.add_many(touched_rows, counts)
                    else:
                        for r, n in zip(touched_rows, counts):
                            self.cache.add(r, n)
                else:
                    self._cache_update(touched_rows)
            if sorted_:
                self.import_sorted_calls += 1
                self.import_batch_calls += int(counted is not None
                                               or not needs)
            self._maybe_snapshot()
            self.import_seconds += time.perf_counter() - t0

    def _import_set(self, rows: np.ndarray, offs: np.ndarray):
        """The set half of ``import_bits``: the pairs in chunks of
        IMPORT_CHUNK_PAIRS, one ``Bitmap.import_pairs`` each. Returns
        the touched rows, ascending; whether the dense builder declined
        any chunk (it was sorted and grouped); and, where it declined
        every chunk and the store held no container before the call (a
        fragment's first load, in which each touched row's count is the
        sum of its containers'), the chunks' keys and per-key counts,
        else None."""
        fresh = not self.storage.containers
        parts = [self.storage.import_pairs(
                     rows[i:i + IMPORT_CHUNK_PAIRS],
                     offs[i:i + IMPORT_CHUNK_PAIRS], SHARD_WIDTH_EXP)
                 for i in range(0, len(rows), IMPORT_CHUNK_PAIRS)]
        keys = parts[0][0] if len(parts) == 1 \
            else np.concatenate([k for k, _ in parts])
        touched = sort_unique(keys // np.uint64(CONTAINERS_PER_ROW))
        counts = [c for _, c in parts if c is not None]
        if not fresh or len(counts) < len(parts):
            return touched, bool(counts), None
        return touched, True, (keys, counts[0] if len(counts) == 1
                               else np.concatenate(counts))

    def _batch_row_counts(self, keys: np.ndarray,
                          counts: np.ndarray) -> np.ndarray:
        """Each touched row's bits, ascending by row, after a first load
        whose chunks gave container ``keys`` and their ``counts``: a
        key's last chunk holds its count, or -1 where that chunk ORed
        into the key's container (a row split across chunks), whose
        count is then read; then one segmented sum over the keys."""
        if not _strictly_increasing(keys):
            _, last = np.unique(keys[::-1], return_index=True)
            at = len(keys) - 1 - last
            keys, counts = keys[at], counts[at]
        ored = np.flatnonzero(counts < 0)
        if len(ored):
            counts = counts.copy()
            counts[ored] = list(map(self.storage.container_count,
                                    keys[ored].tolist()))
        k_rows = keys // np.uint64(CONTAINERS_PER_ROW)
        starts = np.flatnonzero(np.concatenate(
            ([True], k_rows[1:] != k_rows[:-1])))
        return np.add.reduceat(counts, starts)

    def _cache_needs_counts(self) -> bool:
        """Whether a write must feed the count cache its rows' counts:
        not for no cache, nor a ranked cache that has saturated."""
        return self.cache_type != cache_mod.CACHE_TYPE_NONE \
            and not getattr(self.cache, "saturated", False)

    def bulk_import_mutex(self, row_ids: np.ndarray,
                          column_ids: np.ndarray) -> None:
        """Mutex import: setting (row, column) clears any other row's bit
        in that column. Within the batch the last pair of a column wins
        (the last index of each column, from ``np.unique`` over the
        reversed ids). Conflicts are found with one dense AND of each
        present row against the batch's column mask; the conflicting
        bits go out as one clearing import and the pairs come in as
        another, so the count caches and the bank versions see both
        rows of a moved column."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        offs = np.asarray(column_ids, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
        if len(offs) == 0:
            return
        order = None
        if not _strictly_increasing(offs):
            if len(offs) > IMPORT_CHUNK_PAIRS:
                # Past one record, the chunks follow the columns' first
                # appearance, as the JAX package's import orders them.
                _, first = np.unique(offs, return_index=True)
                order = np.argsort(first, kind="stable")
            _, last = np.unique(offs[::-1], return_index=True)
            keep = len(offs) - 1 - last
            rows, offs = rows[keep], offs[keep]
        # offs now ascend, one pair a column.
        with self._lock:
            present = self.row_ids()
            clear_rows, clear_offs = [], []
            if present:
                mask = np.zeros(SHARD_WIDTH // 32, dtype=np.uint32)
                np.bitwise_or.at(mask, (offs >> np.uint64(5)).astype(np.int64),
                                 np.left_shift(np.uint32(1), (offs & np.uint64(
                                     31)).astype(np.uint32)))
                for r in present:
                    hit = self.row_dense(r) & mask
                    nz = np.flatnonzero(hit)
                    if not len(nz):
                        continue
                    bits = np.unpackbits(hit[nz].view(np.uint8),
                                         bitorder="little").reshape(-1, 32)
                    w, b = np.nonzero(bits)
                    conflict = (nz[w] * 32 + b).astype(np.uint64)
                    moved = rows[np.searchsorted(offs, conflict)] \
                        != np.uint64(r)
                    if moved.any():
                        clear_offs.append(conflict[moved])
                        clear_rows.append(np.full(int(moved.sum()), r,
                                                  np.uint64))
            if clear_rows:
                self.import_bits(np.concatenate(clear_rows),
                                 np.concatenate(clear_offs), clear=True)
            if order is not None:
                rows, offs = rows[order], offs[order]
            self.import_bits(rows, offs)

    def clear_row(self, row_id: int) -> bool:
        """Clear every bit of a row (the ClearRow write): its containers
        go whole, after one OP_REMOVE_BATCH record a chunk of its sorted
        positions. True when the row held a bit."""
        k0 = row_id * CONTAINERS_PER_ROW
        with self._lock:
            containers = self.storage.containers
            keys = [k for k in range(k0, k0 + CONTAINERS_PER_ROW)
                    if k in containers]
            if not keys:
                return False
            if self.storage.op_writer is not None:
                positions = np.concatenate(
                    [np.uint64(k << 16) + self.storage._positions(
                        containers[k]).astype(np.uint64) for k in keys])
                for i in range(0, len(positions), IMPORT_CHUNK_PAIRS):
                    self.storage._write_op(
                        OP_REMOVE_BATCH,
                        values=positions[i:i + IMPORT_CHUNK_PAIRS])
            for key in keys:
                del containers[key]
                self.storage._invalidate(key)
            self._touch_rows((row_id,))
            self._cache_update((row_id,))
            self._maybe_snapshot()
            return True

    def set_row(self, row_id: int, words: np.ndarray) -> None:
        """Replace a row's bits wholesale from uint32 words (the Store
        write). A width-trimmed ``words`` clears the rest of the row."""
        words = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1)
        cw32 = CONTAINER_BITS // 32
        if words.size % cw32:
            words = np.concatenate(
                [words, np.zeros(cw32 - words.size % cw32, np.uint32)])
        dense = words.view(np.uint64)
        n_given = dense.size // CONTAINER_WORDS
        k0 = row_id * CONTAINERS_PER_ROW
        with self._lock:
            containers = self.storage.containers
            present = self._row_present(row_id)
            for j in range(CONTAINERS_PER_ROW):
                key = k0 + j
                chunk = dense[j * CONTAINER_WORDS:(j + 1) * CONTAINER_WORDS] \
                    if j < n_given else None
                n = _popcount_words(chunk) if chunk is not None else 0
                if n:
                    containers[key] = _dense_to_array(chunk) \
                        if n <= ARRAY_MAX_SIZE else chunk.copy()
                    self.storage._invalidate(key)
                elif containers.pop(key, None) is not None:
                    self.storage._invalidate(key)
            self._touch_rows((row_id,), same_row_set=present
                             and self._row_present(row_id))
            self._cache_update((row_id,))
            # A whole-row overwrite has no op record: a snapshot keeps it.
            self._snapshot()

    def import_roaring(self, data: bytes, clear: bool = False) -> None:
        """Union the bits of a serialized roaring bitmap into the
        fragment, or with ``clear`` clear them; then rewrite the
        snapshot. Malformed bytes raise ValueError and change nothing."""
        other = Bitmap.from_bytes(data)
        with self._lock:
            if clear:
                self.storage.difference_in_place(other)
            else:
                self.storage.union_in_place(other)
            rows = sorted({k // CONTAINERS_PER_ROW
                           for k in other.containers})
            self._touch_rows(rows)
            self._cache_update(rows)
            self._snapshot()

    def replace_with_bytes(self, data: bytes) -> None:
        """Overwrite the whole fragment with the bits of a serialized
        roaring bitmap (the resize pull): bits absent from ``data`` go,
        so a stale copy resurrects nothing cleared while this node did
        not own the shard. The union of the old and the new rows is
        touched, so banks patch or rebuild every moved row; then the
        snapshot is rewritten."""
        other = Bitmap.from_bytes(data)
        with self._lock:
            old_rows = set(self.row_ids())
            self.storage.containers = other.containers
            self.storage._counts = {}
            self.storage.optimize()
            rows = sorted(old_rows | {k // CONTAINERS_PER_ROW
                                      for k in self.storage.containers})
            self._prelatch_cache_saturation(np.asarray(rows, np.uint64))
            self._touch_rows(rows)
            self._cache_update(rows)
            self._snapshot()

    def value(self, column_id: int, bit_depth: int) -> Tuple[int, bool]:
        """(base value, True) of a column of the BSI planes, from its
        bits in rows 0..bit_depth-1 (least significant first); (0, False)
        when its not-null bit (row bit_depth) is clear."""
        with self._lock:
            if not self.bit(bit_depth, column_id):
                return 0, False
            return sum(1 << i for i in range(bit_depth)
                       if self.bit(i, column_id)), True

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        """Write one BSI value bit by bit (an OP_ADD or OP_REMOVE record
        a changed bit), then the not-null bit."""
        with self._lock:
            changed = False
            for i in range(bit_depth):
                if value >> i & 1:
                    changed |= self.storage.add(self.pos(i, column_id))
                else:
                    changed |= self.storage.remove(self.pos(i, column_id))
            changed |= self.storage.add(self.pos(bit_depth, column_id))
            self._touch_rows(range(bit_depth + 1))
            self._maybe_snapshot()
            return changed

    def clear_value(self, column_id: int, bit_depth: int) -> bool:
        """Clear one column's value planes and not-null bit."""
        with self._lock:
            changed = False
            for i in range(bit_depth + 1):
                changed |= self.storage.remove(self.pos(i, column_id))
            self._touch_rows(range(bit_depth + 1))
            self._maybe_snapshot()
            return changed

    def import_values(self, column_ids: np.ndarray, values: np.ndarray,
                      bit_depth: int, clear: bool = False) -> None:
        """BSI import of base values. Duplicate columns in one batch
        resolve last-wins; columns that already held a value have their
        zero planes cleared first; every plane's set bits and the
        not-null bits then go in as one batch."""
        offs = np.asarray(column_ids, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
        vals = np.asarray(values, dtype=np.uint64)
        if len(offs) == 0:
            return
        if not _strictly_increasing(offs):
            _, last = np.unique(offs[::-1], return_index=True)
            keep = len(offs) - 1 - last
            offs, vals = offs[keep], vals[keep]
        with self._lock:
            if clear:
                for i in range(bit_depth + 1):
                    self.storage.remove_batch(
                        np.uint64(i * SHARD_WIDTH) + offs)
                self._touch_rows(range(bit_depth + 1))
                self._maybe_snapshot()
                return
            # Columns that already hold a value need their zero planes
            # cleared; a fragment with no not-null row has none.
            existed = np.zeros(0, dtype=bool)
            if self._row_present(bit_depth):
                nn = self.row_dense(bit_depth)
                w = (offs >> np.uint64(5)).astype(np.int64)
                existed = ((nn[w] >> (offs & np.uint64(31)).astype(
                    np.uint32)) & np.uint32(1)).astype(bool)
            if existed.any():
                eoff, evals = offs[existed], vals[existed]
                for i in range(bit_depth):
                    zero = ((evals >> np.uint64(i)) & np.uint64(1)) == 0
                    if zero.any():
                        self.storage.remove_batch(
                            np.uint64(i * SHARD_WIDTH) + eoff[zero])
            planes = [((vals >> np.uint64(i)) & np.uint64(1)).astype(bool)
                      for i in range(bit_depth)]
            # The pair count decides the branch; the not-null bits alone
            # often settle it without counting the planes.
            dense = dense_scatter(len(offs), 0, bit_depth, SHARD_WIDTH_EXP) \
                or dense_scatter(len(offs) + sum(int(m.sum()) for m in planes),
                                 0, bit_depth, SHARD_WIDTH_EXP)
            n_pairs = len(offs) + sum(int(m.sum()) for m in planes)
            if dense:
                # One bool row per plane (and not-null), packed in one
                # pass: the same dense masks import_batch would build,
                # without the (row, column) pair arrays.
                offs64 = offs.astype(np.int64)
                bits = np.zeros((bit_depth + 1, SHARD_WIDTH), dtype=bool)
                for i, m in enumerate(planes):
                    bits[i, offs64] = m
                bits[bit_depth, offs64] = True
                words = np.packbits(bits, axis=1, bitorder="little").view(
                    np.uint64).reshape(-1, CONTAINER_WORDS)
                counts = _popcount_rows(words)
                if n_pairs <= IMPORT_CHUNK_PAIRS:
                    nz = np.flatnonzero(counts)
                    self.storage._log_roaring(n_pairs, lambda: serialize_import(
                        nz.astype(np.uint64), words[nz]))
                else:
                    self._log_value_chunks(offs, planes, bit_depth, n_pairs)
                self.storage.merge_masks(0, words, counts)
            elif n_pairs <= IMPORT_CHUNK_PAIRS:
                self.storage.import_batch(
                    np.concatenate([np.full(int(m.sum()), i, np.uint64)
                                    for i, m in enumerate(planes)]
                                   + [np.full(len(offs), bit_depth,
                                              np.uint64)]),
                    np.concatenate([offs[m] for m in planes] + [offs]),
                    SHARD_WIDTH_EXP)
            else:
                positions = self._value_positions(offs, planes, bit_depth)
                for c0 in range(0, n_pairs, IMPORT_CHUNK_PAIRS):
                    chunk = positions[c0:c0 + IMPORT_CHUNK_PAIRS]
                    self.storage.import_batch(
                        chunk >> np.uint64(SHARD_WIDTH_EXP),
                        chunk & np.uint64(SHARD_WIDTH - 1), SHARD_WIDTH_EXP)
            self._touch_rows(range(bit_depth + 1))
            self._maybe_snapshot()

    @staticmethod
    def _value_positions(offs: np.ndarray, planes, bit_depth: int
                         ) -> np.ndarray:
        """The sorted positions of a value import's pairs: each plane's
        set offsets, plane by plane, then the not-null row."""
        return np.concatenate(
            [np.uint64(i * SHARD_WIDTH) + offs[m]
             for i, m in enumerate(planes)]
            + [np.uint64(bit_depth * SHARD_WIDTH) + offs])

    def _log_value_chunks(self, offs, planes, bit_depth: int,
                          n_pairs: int) -> None:
        """The records of a value import larger than one chunk: one
        OP_ADD_ROARING a chunk of IMPORT_CHUNK_PAIRS sorted positions,
        the chunks the pair list of the JAX package's import makes."""
        if self.storage.op_writer is None:
            self.storage._log_roaring(n_pairs, None)
            return
        positions = self._value_positions(offs, planes, bit_depth)
        for c0 in range(0, n_pairs, IMPORT_CHUNK_PAIRS):
            chunk = positions[c0:c0 + IMPORT_CHUNK_PAIRS]
            self.storage._log_roaring(
                len(chunk), lambda chunk=chunk: serialize_positions(chunk))

    # -- reads -------------------------------------------------------------

    def row_ids(self) -> Tuple[int, ...]:
        """Sorted ids of rows holding any bit, as an immutable tuple
        (cached per version). The store keeps no empty container, so the
        container keys alone give the rows."""
        with self._lock:
            version, rows = self._row_ids_cache
            if version != self.version:
                containers = self.storage.containers
                keys = np.fromiter(containers, dtype=np.int64,
                                   count=len(containers))
                rows = tuple(np.unique(keys // CONTAINERS_PER_ROW).tolist())
                self._row_ids_cache = (self.version, rows)
            return rows

    def row_count(self, row_id: int) -> int:
        return self.storage.count_range(row_id * SHARD_WIDTH,
                                        (row_id + 1) * SHARD_WIDTH)

    def row_offsets(self, row_id: int) -> np.ndarray:
        """The row's set in-shard column offsets, sorted, as uint64."""
        k0 = row_id * CONTAINERS_PER_ROW
        with self._lock:
            containers = self.storage.containers
            parts = [np.uint64((k - k0) << 16)
                     + self.storage._positions(containers[k]).astype(
                         np.uint64)
                     for k in range(k0, k0 + CONTAINERS_PER_ROW)
                     if k in containers]
        return np.concatenate(parts) if parts \
            else np.empty(0, dtype=np.uint64)

    def column_words(self) -> np.ndarray:
        """uint64 [CONTAINERS_PER_ROW, 1024]: the columns that hold a bit
        in any row, as one dense row."""
        out = np.zeros((CONTAINERS_PER_ROW, CONTAINER_WORDS), dtype=np.uint64)
        with self._lock:
            for key, c in self.storage.containers.items():
                j = key % CONTAINERS_PER_ROW
                if c.dtype == np.uint16:
                    v = c.astype(np.uint32)
                    np.bitwise_or.at(out[j], v >> 6, np.left_shift(
                        np.uint64(1), (v & 63).astype(np.uint64)))
                else:
                    out[j] |= c
        return out

    def import_row_words(self, row_id: int, words: np.ndarray) -> None:
        """Set the bits of uint64 [CONTAINERS_PER_ROW, 1024] ``words`` in
        row ``row_id``: one OP_ADD_ROARING record, the bytes a bulk
        import of the same columns logs."""
        counts = _popcount_rows(words)
        nz = np.flatnonzero(counts)
        if not len(nz):
            return
        k0 = row_id * CONTAINERS_PER_ROW
        with self._lock:
            self.storage._log_roaring(int(counts.sum()), lambda: serialize_import(
                nz.astype(np.uint64) + np.uint64(k0), words[nz]))
            self.storage.merge_masks(k0, words, counts)
            touched = np.array([row_id], dtype=np.uint64)
            self._prelatch_cache_saturation(touched)
            self._touch_rows((row_id,))
            self._cache_update((row_id,))
            self._maybe_snapshot()

    # -- block checksums (the anti-entropy unit) ----------------------------

    def _block_positions(self, blocks) -> np.ndarray:
        """Sorted positions of every bit in ``blocks`` (a set of block
        ids), from one scan of the container keys."""
        return self.storage.sorted_positions(sorted(
            k for k in self.storage.containers
            if k // _BLOCK_CONTAINERS in blocks))

    @staticmethod
    def _digest_blocks(pos: np.ndarray) -> Dict[int, bytes]:
        """{block: digest} of sorted positions, one blake2b a block over
        its positions as little-endian u64."""
        if not len(pos):
            return {}
        blk_of = pos // np.uint64(HASH_BLOCK_SIZE * SHARD_WIDTH)
        # Sorted input: each block's positions are one contiguous run.
        cuts = np.nonzero(np.diff(blk_of))[0] + 1
        bounds = np.concatenate(([0], cuts, [len(pos)]))
        raw = pos.astype("<u8", copy=False)
        return {int(blk_of[a]): hashlib.blake2b(
                    memoryview(raw[a:b]), digest_size=16).digest()
                for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist())}

    def checksum_blocks(self) -> List[Tuple[int, bytes]]:
        """(block, digest) pairs, ascending, over every block holding a
        bit. Digests are cached: a pass re-hashes the blocks written
        since the last one, or every block when cold or when most of
        them were written."""
        with self._lock:
            known = 0 if self._block_digests is None \
                else len(self._block_digests)
            if self._block_digests is None or \
                    len(self._dirty_blocks) * 4 > known + 4:
                self._block_digests = self._checksum_all_blocks()
            elif self._dirty_blocks:
                dirty = self._dirty_blocks
                for blk in dirty:
                    self._block_digests.pop(blk, None)
                self._block_digests.update(
                    self._digest_blocks(self._block_positions(dirty)))
            self._dirty_blocks = set()
            return sorted(self._block_digests.items())

    def _checksum_all_blocks(self) -> Dict[int, bytes]:
        """Every block's digest from one extraction of the whole
        store."""
        with self._lock:
            return self._digest_blocks(self.storage.slice())

    def _invalidate_block_checksums(self) -> None:
        """Forget the cached digests: the next pass hashes every
        block."""
        with self._lock:
            self._block_digests = None
            self._dirty_blocks = set()

    def block_data(self, block: int) -> Tuple[np.ndarray, np.ndarray]:
        """(row ids, absolute column ids) of every bit in ``block``."""
        with self._lock:
            pos = self._block_positions({block})
        rows = pos >> np.uint64(SHARD_WIDTH_EXP)
        cols = (pos & np.uint64(SHARD_WIDTH - 1)) \
            + np.uint64(self.shard * SHARD_WIDTH)
        return rows, cols

    def merge_block(self, block: int, their_rows: np.ndarray,
                    their_cols: np.ndarray):
        """Union a peer's pairs of ``block`` into this fragment; returns
        ((rows, cols) set here, (rows, cols) the peer lacks), the second
        for the caller to push back. A union only: a bit cleared on one
        replica and not the other comes back (the reference's mergeBlock
        also takes the clear side)."""
        their_pos = np.asarray(their_rows, np.uint64) \
            * np.uint64(SHARD_WIDTH) \
            + np.asarray(their_cols, np.uint64) % np.uint64(SHARD_WIDTH)
        with self._lock:
            ours = self._block_positions({block})
            missing_here = np.setdiff1d(their_pos, ours)
            missing_there = np.setdiff1d(ours, their_pos)
            if len(missing_here):
                self.import_bits(missing_here >> np.uint64(SHARD_WIDTH_EXP),
                                 missing_here & np.uint64(SHARD_WIDTH - 1))
        base = np.uint64(self.shard * SHARD_WIDTH)
        width = np.uint64(SHARD_WIDTH)
        return ((missing_here // width, missing_here % width + base),
                (missing_there // width, missing_there % width + base))

    def mutex_vector(self, column_id: int) -> Optional[int]:
        """The row holding ``column_id`` in a mutex or bool fragment, or
        None: a scan of the present rows, whose number the field's
        cardinality bounds."""
        for row_id in self.row_ids():
            if self.bit(row_id, column_id):
                return row_id
        return None

    def row_dense(self, row_id: int) -> np.ndarray:
        """One whole row as uint32 words."""
        return self.storage.dense_range(
            row_id * SHARD_WIDTH, (row_id + 1) * SHARD_WIDTH).view(np.uint32)

    @staticmethod
    def _gather_row_arrays(containers, row_ids, total64: int,
                           cwords64: int):
        """Gather of the rows' first containers for single-container
        widths: (u16 arrays, their row indexes, dense items), where the
        dense items are the (row index, dense container) pairs. Arrays
        are cut to the first ``total64 * 64`` positions. The dict probe
        runs as one map(dict.get) in C."""
        keys = (np.asarray(row_ids, dtype=np.uint64)
                * np.uint64(CONTAINERS_PER_ROW)).tolist()
        cs = list(map(containers.get, keys))
        arrays, rows_at, dense_items = [], [], []
        u16dt = np.dtype(np.uint16)
        trim = total64 != cwords64
        lim = np.uint16(total64 * 64 - 1) if trim else None
        ap_a, ap_r = arrays.append, rows_at.append
        for i, c in enumerate(cs):
            if c is None:
                continue
            if c.dtype is not u16dt:
                dense_items.append((i, c))
                continue
            if trim and c[-1] > lim:
                c = c[:np.searchsorted(c, lim, "right")]
            ap_a(c)
            ap_r(i)
        return arrays, rows_at, dense_items

    def rows_positions(self, row_ids, u32_words: int):
        """Each row's set positions below ``u32_words * 32``, for widths
        within one container: ``(pos u16 concatenated, lens int64,
        rows_at int64)`` in ascending row order, about 2 bytes per set
        bit. Dense-encoded containers (a point write densifies its
        row's container) have their positions extracted; None when more
        than a quarter of the rows are dense (a dense field belongs on
        the dense banks) or the width spans more than one container."""
        bits = u32_words * 32
        if bits > CONTAINER_BITS or bits % 64:
            return None
        total64 = u32_words // 2
        with self._lock:
            arrays, rows_at, dense_items = self._gather_row_arrays(
                self.storage.containers, row_ids, total64,
                CONTAINER_BITS // 64)
            if dense_items:
                if len(dense_items) * 4 > max(1, len(row_ids)):
                    return None
                lim = np.uint16(bits - 1) if bits < CONTAINER_BITS else None
                for i, c in dense_items:
                    pos = _dense_to_array(c)
                    if lim is not None and len(pos) and pos[-1] > lim:
                        pos = pos[:np.searchsorted(pos, lim, "right")]
                    arrays.append(pos)
                    rows_at.append(i)
        if not arrays:
            return (np.empty(0, np.uint16), np.empty(0, np.int64),
                    np.empty(0, np.int64))
        if dense_items:
            order = np.argsort(np.asarray(rows_at), kind="stable")
            arrays = [arrays[j] for j in order]
            rows_at = [rows_at[j] for j in order]
        lens = np.fromiter(map(len, arrays), dtype=np.int64,
                           count=len(arrays))
        return (np.concatenate(arrays), lens,
                np.asarray(rows_at, dtype=np.int64))

    def rows_dense(self, row_ids, u32_words: int) -> np.ndarray:
        """[len(row_ids), u32_words] uint32 prefix block; absent rows are
        zero. One dict probe and one copy (dense) or scatter (array) per
        (row, container)."""
        bits = u32_words * 32
        assert bits % 64 == 0
        n_containers = (bits + CONTAINER_BITS - 1) // CONTAINER_BITS
        cwords64 = CONTAINER_BITS // 64
        total64 = u32_words // 2
        out = np.zeros((len(row_ids), total64), dtype=np.uint64)
        one = np.uint64(1)
        with self._lock:
            containers = self.storage.containers
            if n_containers == 1:
                # Single-container widths (fingerprints): every row's u16
                # array in one flat scatter.
                arrays, rows_at, dense_items = self._gather_row_arrays(
                    containers, row_ids, total64, cwords64)
                for i, c in dense_items:
                    out[i] = c[:total64]
                if arrays:
                    scatter_rows(np.concatenate(arrays),
                                 np.fromiter(map(len, arrays), np.uint64,
                                             count=len(arrays)),
                                 np.asarray(rows_at, np.uint64), total64, out)
            else:
                for i, r in enumerate(row_ids):
                    k0 = r * CONTAINERS_PER_ROW
                    row = out[i]
                    for j in range(n_containers):
                        c = containers.get(k0 + j)
                        if c is None:
                            continue
                        lo = j * cwords64
                        n = min(cwords64, total64 - lo)
                        if c.dtype == np.uint16:
                            v = c if n == cwords64 else c[c < n * 64]
                            v = v.astype(np.uint32)
                            np.bitwise_or.at(
                                row, lo + (v >> 6),
                                np.left_shift(one,
                                              (v & 63).astype(np.uint64)))
                        else:
                            row[lo:lo + n] = c[:n]
        return out.view(np.uint32)

    def max_column_offset(self) -> int:
        """Largest in-shard column offset that may hold a bit, rounded up
        to a whole container (-1 when empty); drives the width-trimmed
        banks. Container-granular: the keys alone decide it."""
        with self._lock:
            version, best = self._max_col_cache
            if version == self.version:
                return best
            containers = self.storage.containers
            if containers:
                keys = np.fromiter(containers, dtype=np.int64,
                                   count=len(containers))
                best = (int((keys % CONTAINERS_PER_ROW).max()) + 1) \
                    * CONTAINER_BITS - 1
            else:
                best = -1
            self._max_col_cache = (self.version, best)
            return best
