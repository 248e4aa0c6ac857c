"""TopN row-count caches: the per-fragment count caches and the store of
per-row count vectors on the device.

A copy of the JAX package's ``core/cache.py`` (the port imports nothing
of it). Two tiers serve an unfiltered TopN without its popcount sweep:

- each fragment keeps a count cache (``RankedCache``, ``LRUCache`` or
  ``NopCache``, by the field's ``cacheType``). While every fragment's
  cache provably holds every present row, TopN answers from the cached
  counts with no device work (``Executor._topn_cached_counts``);
- otherwise a ``RankEntry`` keeps the view bank's per-row counts as a
  device vector, validated against the fragments' write versions:
  reused while unchanged, patched for the written rows, else rebuilt by
  the one sweep TopN would have paid anyway (``Executor._rank_counts``).

A fragment with a path keeps its count cache in a ``.cache`` sidecar
(``save_cache`` / ``load_cache``): ``CACHE_MAGIC``, a stamp binding the
sidecar to the storage bytes it was computed from, then little-endian
(u64 row, u64 count) pairs, by count descending. A saturated ranked
cache is saved empty. Every stored rank vector is registered with the
memory ledger as a ``rank_cache`` row of its device bytes, unregistered
when the store evicts or forgets it, or when a resize moves the
ownership of a shard its vector covers (``invalidate_shards``).
"""

from __future__ import annotations

import heapq
import os
import struct
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

THRESHOLD_FACTOR = 1.1

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"
CACHE_TYPES = (CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE)
DEFAULT_CACHE_SIZE = 50000


class RankedCache:
    """Keeps the top ``size`` rows by count; entries below the current
    threshold are rejected once the cache is full.

    The cache serves reads only while it provably holds every present
    row. The moment cardinality passes the bound (an eviction or a
    threshold rejection), it can never serve a read again until it is
    invalidated, so ``saturated`` latches, ``add`` becomes O(1), and the
    fragment skips the row recounts that fed it.

    Mutations take the lock; reads of ``counts`` do not, because
    ``invalidate`` and ``_recalculate`` rebind the dict instead of
    mutating it in place, so a reader sees one consistent snapshot."""

    def __init__(self, size: int = DEFAULT_CACHE_SIZE):
        self.size = size
        self.counts: Dict[int, int] = {}
        self._threshold = 0
        self.saturated = False
        self._lock = threading.Lock()

    def add(self, row_id: int, count: int) -> None:
        with self._lock:
            if self.saturated:
                return
            if count == 0:
                self.counts.pop(row_id, None)
                return
            if (len(self.counts) >= self.size * THRESHOLD_FACTOR
                    and count < self._threshold
                    and row_id not in self.counts):
                self.saturated = True
                return
            self.counts[row_id] = count
            if len(self.counts) > self.size * THRESHOLD_FACTOR:
                self._recalculate()
                self.saturated = True

    def add_many(self, row_ids: List[int], counts: List[int]) -> None:
        """``add`` of each pair in turn. Positive counts that keep the
        cache within its bound however they fall neither saturate it nor
        meet the threshold: one dict update then."""
        with self._lock:
            fits = not self.saturated and len(self.counts) + len(row_ids) \
                <= self.size * THRESHOLD_FACTOR and min(counts, default=1) > 0
            if fits:
                self.counts.update(zip(row_ids, counts))
                return
        for r, n in zip(row_ids, counts):
            self.add(r, n)

    def top(self) -> List[Tuple[int, int]]:
        """(row, count) by count descending, then row, at most ``size``."""
        pairs = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return pairs[:self.size]

    def _recalculate(self) -> None:
        """Top-``size`` selection (lock held) into a fresh dict, so
        lock-free readers never see a half-pruned map."""
        pairs = heapq.nlargest(self.size, self.counts.items(),
                               key=lambda kv: (kv[1], -kv[0]))
        self.counts = dict(pairs)
        self._threshold = pairs[-1][1] if len(pairs) >= self.size else 0

    def invalidate(self) -> None:
        with self._lock:
            self.counts = {}
            self._threshold = 0
            self.saturated = False

    def __len__(self) -> int:
        return len(self.counts)


class LRUCache:
    """Least-recently-used variant: a write makes its row the most
    recent, and past ``size`` rows the least recent goes."""

    def __init__(self, size: int = DEFAULT_CACHE_SIZE):
        self.size = size
        self.counts: "OrderedDict[int, int]" = OrderedDict()
        self._lock = threading.Lock()

    def add(self, row_id: int, count: int) -> None:
        with self._lock:
            if row_id in self.counts:
                self.counts.move_to_end(row_id)
            self.counts[row_id] = count
            while len(self.counts) > self.size:
                self.counts.popitem(last=False)

    def get(self, row_id: int) -> int:
        """The row's count (0 when absent); a read makes it recent."""
        with self._lock:
            if row_id in self.counts:
                self.counts.move_to_end(row_id)
                return self.counts[row_id]
            return 0

    def ids(self) -> List[int]:
        return sorted(self.counts)

    def top(self) -> List[Tuple[int, int]]:
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def invalidate(self) -> None:
        with self._lock:
            self.counts = OrderedDict()

    def __len__(self) -> int:
        return len(self.counts)


class NopCache:
    size = 0

    def add(self, row_id: int, count: int) -> None:
        pass

    def top(self) -> List[Tuple[int, int]]:
        return []

    def invalidate(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


def new_cache(cache_type: str, size: int):
    if cache_type == CACHE_TYPE_RANKED:
        return RankedCache(size)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type == CACHE_TYPE_NONE:
        return NopCache()
    raise ValueError(f"invalid cache type: {cache_type}")


# Sidecar magic ("pcV2"): the format with the storage stamp.
CACHE_MAGIC = 0x70635632


def save_cache(cache, path: str, stamp: bytes = b"") -> None:
    """Write the cache's top pairs to ``path`` through a rename; a
    saturated ranked cache (its counts may be stale) is saved empty."""
    pairs = [] if getattr(cache, "saturated", False) else cache.top()
    buf = bytearray(struct.pack("<IH", CACHE_MAGIC, len(stamp)))
    buf += stamp
    buf += struct.pack("<Q", len(pairs))
    for row_id, count in pairs:
        buf += struct.pack("<QQ", row_id, count)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


def load_cache(cache, path: str, stamp: bytes = b"") -> bool:
    """Add the sidecar's pairs to ``cache``; False, loading nothing, when
    the file is missing, of another format, or stamped for other
    storage bytes than ``stamp``."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 6:
        return False
    magic, stamp_len = struct.unpack_from("<IH", data, 0)
    if magic != CACHE_MAGIC:
        return False
    off = 6 + stamp_len
    if data[6:off] != stamp:
        return False
    (n,) = struct.unpack_from("<Q", data, off)
    off += 8
    for i in range(n):
        row_id, count = struct.unpack_from("<QQ", data, off + 16 * i)
        cache.add(row_id, count)
    return True


# ---------------------------------------------------------------------
# Device rank vectors. Where the host RankedCache dies the moment
# cardinality passes its bound, the device vector covers every bank slot
# at 8 bytes a row, so a leaderboard TopN over a warm bank is a device
# top-k over counts already made instead of an [R, S, W] sweep.

# Kill switch, the JAX package's variable.
RANK_CACHE_ENV = "PILOSA_TPU_RANK_CACHE"


def _rank_env_enabled() -> bool:
    return os.environ.get(RANK_CACHE_ENV, "1") != "0"


class RankEntry:
    """One cached per-row count vector: ``counts`` is a device int64
    ``[row_capacity]`` tensor aligned with the slot layout of the bank it
    was computed from. ``row_ids`` is that bank's slot-ordered row tuple:
    equality proves the same slot layout, so the vector, and any patch
    scattered into it, indexes the same rows."""

    __slots__ = ("versions", "row_ids", "counts")

    def __init__(self, versions: Dict[int, int], row_ids: tuple,
                 counts: Any) -> None:
        self.versions = versions    # {shard: fragment.version} at build
        self.row_ids = row_ids      # slot-ordered row-id tuple
        self.counts = counts

    @property
    def nbytes(self) -> int:
        return int(self.counts.numel()) * self.counts.element_size()


class RankCacheStore:
    """LRU registry of RankEntry vectors keyed (view identity, shard
    tuple, width), bounded by entry count. An entry holds its view, so a
    view's id is not reused while the entry lives; ``forget_view`` drops
    a deleted view's entries."""

    def __init__(self, max_entries: int = 64) -> None:
        self.enabled = _rank_env_enabled()
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[Any, RankEntry]]" = \
            OrderedDict()
        self.evictions = 0
        # Entries dropped because a resize moved shard ownership
        # (server/api.py _note_placement_change).
        self.placement_invalidations = 0

    def configure(self, enabled: Optional[bool] = None,
                  max_entries: Optional[int] = None) -> None:
        """The ``[cache]`` rank keys; PILOSA_TPU_RANK_CACHE=0 wins
        (config can switch the store off, never on past it)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled) and _rank_env_enabled()
            if max_entries is not None:
                self.max_entries = max(1, int(max_entries))

    def get(self, view: Any, key: tuple) -> Optional[RankEntry]:
        with self._lock:
            ent = self._entries.get((id(view), key))
            if ent is None:
                return None
            self._entries.move_to_end((id(view), key))
            return ent[1]

    def put(self, view: Any, key: tuple, entry: RankEntry) -> None:
        from pilosa_tpu_torch.utils.memledger import LEDGER
        ek = (id(view), key)
        with self._lock:
            self._entries.pop(ek, None)
            while len(self._entries) >= self.max_entries:
                (_vid, vkey), (v, _e) = self._entries.popitem(last=False)
                self.evictions += 1
                # Under the store lock (the ledger's is a leaf), so an
                # evict and a re-put cannot interleave.
                LEDGER.unregister("rank_cache", vkey, owner=v)
            self._entries[ek] = (view, entry)
            LEDGER.register("rank_cache", key, entry.nbytes, owner=view,
                            index=getattr(view, "index", ""),
                            field=getattr(view, "field", ""),
                            view=getattr(view, "name", ""),
                            rows=len(entry.row_ids))

    def forget_view(self, view: Any) -> None:
        """Drop every entry of a view whose field or index was deleted,
        with its ledger row."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        vid = id(view)
        with self._lock:
            for ek in [ek for ek in self._entries if ek[0] == vid]:
                self._entries.pop(ek, None)
                LEDGER.unregister("rank_cache", ek[1], owner=view)

    def invalidate_shards(self, moved: Any) -> int:
        """Drop entries whose count vector covers a shard whose owner
        set changed in a resize (``moved``: a set of ``(index, shard)``
        pairs), with their ledger rows. The per-shard version stamps
        already refuse a stale reuse; this frees the device bytes at the
        placement change and counts the drop
        (``placement_invalidations``). Returns the entries dropped."""
        if not moved:
            return 0
        from pilosa_tpu_torch.utils.memledger import LEDGER
        by_index: Dict[str, set] = {}
        for iname, shard in moved:
            by_index.setdefault(str(iname), set()).add(int(shard))
        with self._lock:
            dead = []
            for ek, (v, e) in self._entries.items():
                shs = by_index.get(str(getattr(v, "index", "")))
                if shs and shs & {int(s) for s in e.versions}:
                    dead.append(ek)
            for ek in dead:
                v, _e = self._entries.pop(ek)
                LEDGER.unregister("rank_cache", ek[1], owner=v)
            self.placement_invalidations += len(dead)
            return len(dead)

    def clear(self) -> None:
        """Drop every entry with its ledger row."""
        from pilosa_tpu_torch.utils.memledger import LEDGER
        with self._lock:
            for ek, (v, _e) in list(self._entries.items()):
                self._entries.pop(ek, None)
                LEDGER.unregister("rank_cache", ek[1], owner=v)

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """Live entries, their device bytes (the ``rank_cache.*`` gauges
        of ``/metrics``) and the entries a resize dropped."""
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": sum(int(e.nbytes)
                                 for _, e in self._entries.values()),
                    "placementInvalidations": self.placement_invalidations}
