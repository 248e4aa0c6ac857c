"""In-memory roaring container store, the port's copy of the JAX
package's ``storage/roaring.py`` container layer.

A bitmap of 64-bit positions is a dict of containers keyed by
``position >> 16``. Each container holds the 2^16 low positions of its
key in one of two encodings:

- dense: ``uint64[1024]`` words, bit ``p`` in word ``p >> 6``;
- array: sorted unique ``uint16`` positions, for at most
  ``ARRAY_MAX_SIZE`` bits (a 48-bit fingerprint row costs 96 bytes
  instead of 8 KiB).

Mutations materialise a container dense (``_container``); reads handle
both encodings; ``optimize`` re-encodes sparse dense containers as
arrays. No public operation leaves an empty container in the dict, so
the keys alone say which containers hold bits.

The file format, the op log, its checksums and the native codec are not
part of the port yet: the store lives in memory only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

CONTAINER_BITS = 1 << 16
CONTAINER_WORDS = CONTAINER_BITS // 64  # 1024 uint64 words
# Cardinality at or below which a container may use the array encoding.
ARRAY_MAX_SIZE = 4096

# Dense-scatter gates of import_batch (the counterpart of the JAX
# package's native import build): the batch's row span must stay under
# DENSE_SPAN_CONTAINERS containers of mask, and it must carry at least
# DENSE_MIN_BITS bits per container of that span unless the span is at
# most DENSE_SMALL_SPAN containers. Rows of one scatter pass are bounded
# by DENSE_GROUP_ROWS (each costs one bool per column of a shard row).
DENSE_SPAN_CONTAINERS = 1 << 17
DENSE_MIN_BITS = 256
DENSE_SMALL_SPAN = 64
DENSE_GROUP_ROWS = 64


def dense_scatter(n_pairs: int, rmin: int, rmax: int,
                  swidth_exp: int) -> bool:
    """Whether a batch of ``n_pairs`` (row, column) pairs over rows
    rmin..rmax takes the dense-mask import: a row span of fewer than
    DENSE_SPAN_CONTAINERS containers, and at least DENSE_MIN_BITS pairs
    per container of it unless the span is at most DENSE_SMALL_SPAN
    containers."""
    kpr = 1 << (swidth_exp - 16)
    if swidth_exp < 16 or rmax - rmin >= DENSE_SPAN_CONTAINERS // kpr \
            or rmax >= 1 << (64 - swidth_exp):
        return False
    span = (rmax - rmin + 1) * kpr
    return span <= DENSE_SMALL_SPAN or n_pairs >= span * DENSE_MIN_BITS


if hasattr(np, "bitwise_count"):
    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        """Set bits per row of a uint64 [n, k] block, as int64[n]."""
        return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)
else:  # pragma: no cover - numpy < 2.0
    _POP_TABLE = np.array([bin(i).count("1") for i in range(256)],
                          dtype=np.int64)

    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(words).view(np.uint8)
        return _POP_TABLE[b].reshape(words.shape[:-1] + (-1,)).sum(axis=-1)


def _popcount_words(words: np.ndarray) -> int:
    return int(_popcount_rows(words.reshape(1, -1))[0])


def _new_container() -> np.ndarray:
    return np.zeros(CONTAINER_WORDS, dtype=np.uint64)


def _dense_to_array(dense: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(dense.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint16)


def _low_mask(low: np.ndarray) -> np.ndarray:
    """Dense uint64[1024] mask from in-container positions: a bool
    scatter and packbits for large groups, an in-place OR scatter for
    small ones."""
    if len(low) >= 256:
        bits = np.zeros(CONTAINER_BITS, dtype=bool)
        bits[low] = True
        return np.packbits(bits, bitorder="little").view(np.uint64).copy()
    dense = _new_container()
    if len(low):
        v = low.astype(np.uint32)
        np.bitwise_or.at(
            dense, v >> 6,
            np.left_shift(np.uint64(1), (v & 63).astype(np.uint64)))
    return dense


class Bitmap:
    """A 64-bit-keyed roaring bitmap over dense and array containers."""

    __slots__ = ("containers", "_counts")

    def __init__(self) -> None:
        self.containers: Dict[int, np.ndarray] = {}
        # key -> popcount of a dense container.
        self._counts: Dict[int, int] = {}

    # -- container plumbing -------------------------------------------------

    def _container(self, key: int, create: bool = False
                   ) -> Optional[np.ndarray]:
        """Mutable dense container: an array-encoded one materialises in
        place."""
        c = self.containers.get(key)
        if c is None:
            if not create:
                return None
            c = _new_container()
            self.containers[key] = c
        elif c.dtype == np.uint16:
            c = _low_mask(c)
            self.containers[key] = c
        return c

    def _invalidate(self, key: int) -> None:
        self._counts.pop(key, None)

    def container_count(self, key: int) -> int:
        """Bits in one container: an array's length, or a dense
        container's popcount (cached until the next mutation)."""
        c = self.containers.get(key)
        if c is None:
            return 0
        if c.dtype == np.uint16:
            return len(c)
        n = self._counts.get(key)
        if n is None:
            n = self._counts[key] = _popcount_words(c)
        return n

    def optimize(self) -> int:
        """Re-encode dense containers of at most ARRAY_MAX_SIZE bits as
        arrays and drop empty ones; returns the number converted."""
        converted = 0
        for key, c in list(self.containers.items()):
            if c.dtype == np.uint16:
                continue
            n = self.container_count(key)
            if n == 0:
                del self.containers[key]
                self._invalidate(key)
            elif n <= ARRAY_MAX_SIZE:
                self.containers[key] = _dense_to_array(c)
                converted += 1
        return converted

    def _drop_empty(self, key: int) -> None:
        if key in self.containers and self.container_count(key) == 0:
            del self.containers[key]
            self._invalidate(key)

    # -- point ops ----------------------------------------------------------

    def add(self, *positions: int) -> bool:
        """Set each position; True when any bit changed."""
        changed = False
        for p in positions:
            p = int(p)
            key, low = p >> 16, p & 0xFFFF
            c = self._container(key, create=True)
            w, b = low >> 6, np.uint64(1 << (low & 63))
            if not c[w] & b:
                c[w] |= b
                self._invalidate(key)
                changed = True
        return changed

    def remove(self, *positions: int) -> bool:
        """Clear each position; True when any bit changed. A no-op
        remove never materialises an array container."""
        changed = False
        for p in positions:
            p = int(p)
            if not self.contains(p):
                continue
            key, low = p >> 16, p & 0xFFFF
            c = self._container(key)
            c[low >> 6] &= ~np.uint64(1 << (low & 63))
            self._invalidate(key)
            self._drop_empty(key)
            changed = True
        return changed

    def contains(self, p: int) -> bool:
        p = int(p)
        c = self.containers.get(p >> 16)
        if c is None:
            return False
        low = p & 0xFFFF
        if c.dtype == np.uint16:
            i = int(np.searchsorted(c, low))
            return i < len(c) and int(c[i]) == low
        return bool(c[low >> 6] & np.uint64(1 << (low & 63)))

    # -- batch ops ----------------------------------------------------------

    @staticmethod
    def _groups(positions: np.ndarray):
        """(keys, group bounds) of sorted positions grouped by key."""
        keys = (positions >> np.uint64(16)).astype(np.int64)
        uniq, starts = np.unique(keys, return_index=True)
        return uniq, np.append(starts, len(positions))

    def direct_add_n(self, positions: np.ndarray,
                     presorted: bool = False) -> int:
        """Bulk add; returns the number of bits that changed.
        ``presorted=True`` asserts sorted unique positions."""
        if len(positions) == 0:
            return 0
        if presorted:
            positions = np.ascontiguousarray(positions, dtype=np.uint64)
        else:
            positions = np.unique(np.asarray(positions, dtype=np.uint64))
        changed = 0
        uniq, bounds = self._groups(positions)
        for i, key in enumerate(uniq.tolist()):
            group = positions[bounds[i]:bounds[i + 1]]
            low = (group & np.uint64(0xFFFF)).astype(np.uint32)
            if key not in self.containers:
                self.containers[key] = _low_mask(low)
                self._counts[key] = len(group)
                changed += len(group)
                continue
            c = self._container(key)
            before = self.container_count(key)
            if len(group) >= 256:
                c |= _low_mask(low)
            else:
                np.bitwise_or.at(
                    c, low >> 6,
                    np.left_shift(np.uint64(1),
                                  (low & 63).astype(np.uint64)))
            self._invalidate(key)
            changed += self.container_count(key) - before
        return changed

    def direct_remove_n(self, positions: np.ndarray) -> int:
        """Bulk remove; returns the number of bits that changed."""
        if len(positions) == 0:
            return 0
        positions = np.unique(np.asarray(positions, dtype=np.uint64))
        changed = 0
        uniq, bounds = self._groups(positions)
        for i, key in enumerate(uniq.tolist()):
            if key not in self.containers:
                continue
            c = self._container(key)
            group = positions[bounds[i]:bounds[i + 1]]
            mask = _low_mask((group & np.uint64(0xFFFF)).astype(np.uint32))
            before = self.container_count(key)
            c &= ~mask
            self._invalidate(key)
            changed += before - self.container_count(key)
            self._drop_empty(key)
        return changed

    def import_batch(self, row_ids: np.ndarray, col_ids: np.ndarray,
                     swidth_exp: int) -> np.ndarray:
        """Add every (row, column) pair at position ``row << swidth_exp |
        (col mod 2^swidth_exp)``; returns the sorted touched container
        keys. Duplicates are harmless.

        Two branches, chosen as the JAX package's native import build
        chooses: a batch over a narrow, dense row span scatters into
        dense per-container masks without sorting; any other batch
        sorts and groups its positions into sorted-u16 array containers
        (dense above ARRAY_MAX_SIZE). Positions that arrive sorted (a
        bulk load in row order) skip the sort."""
        row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
        col_ids = np.ascontiguousarray(col_ids, dtype=np.uint64)
        if len(row_ids) == 0:
            return np.empty(0, dtype=np.uint64)
        keys = self._import_dense(row_ids, col_ids, swidth_exp)
        if keys is not None:
            return keys
        positions = (row_ids << np.uint64(swidth_exp)) \
            + (col_ids & np.uint64((1 << swidth_exp) - 1))
        if len(positions) > 1 and bool(np.all(positions[1:]
                                              >= positions[:-1])):
            keep = np.empty(len(positions), dtype=bool)
            keep[0] = True
            np.not_equal(positions[1:], positions[:-1], out=keep[1:])
            positions = positions[keep]
        else:
            positions = np.unique(positions)
        gkeys = positions >> np.uint64(16)
        starts = np.concatenate(
            ([0], np.flatnonzero(gkeys[1:] != gkeys[:-1]) + 1))
        bounds = np.append(starts, len(positions))
        keys = gkeys[starts]
        key_list = keys.tolist()
        lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
        counts = np.diff(bounds)
        groups = [lows[a:b] for a, b in zip(bounds[:-1].tolist(),
                                            bounds[1:].tolist())]
        if self.containers.keys().isdisjoint(key_list) and \
                int(counts.max(initial=0)) <= ARRAY_MAX_SIZE:
            # All-new array containers (the fingerprint import shape: a
            # million one-container rows): one dict update. An array's
            # count is its length, so no count is cached for it (at 100M
            # rows that cache alone would cost gigabytes).
            self.containers.update(zip(key_list, groups))
            return keys
        for k, g in zip(key_list, groups):
            if k not in self.containers:
                self.containers[k] = (g if len(g) <= ARRAY_MAX_SIZE
                                      else _low_mask(g.astype(np.uint32)))
            else:
                c = self._container(k)
                c |= _low_mask(g.astype(np.uint32))
            self._invalidate(k)
        return keys

    def merge_masks(self, first_key: int, words: np.ndarray) -> np.ndarray:
        """OR a block of dense container masks, uint64 [n, 1024] for keys
        first_key .. first_key + n - 1, into the store; every container
        that gets a bit is kept dense. Returns the keys that got bits."""
        counts = _popcount_rows(words)
        nz = np.flatnonzero(counts)
        for i, n in zip(nz.tolist(), counts[nz].tolist()):
            key = first_key + i
            if key not in self.containers:
                self.containers[key] = words[i].copy()
                self._counts[key] = n
            else:
                c = self._container(key)
                c |= words[i]
                self._invalidate(key)
        return nz.astype(np.uint64) + np.uint64(first_key)

    def _import_dense(self, row_ids: np.ndarray, col_ids: np.ndarray,
                      swidth_exp: int) -> Optional[np.ndarray]:
        """The dense-mask branch of import_batch, or None when the batch
        does not qualify. Rows scatter DENSE_GROUP_ROWS at a time into
        one bool mask, packed to words in one pass and merged."""
        rmin, rmax = int(row_ids.min()), int(row_ids.max())
        if not dense_scatter(len(row_ids), rmin, rmax, swidth_exp):
            return None
        width = 1 << swidth_exp
        kpr = width // CONTAINER_BITS
        rel = (row_ids - np.uint64(rmin)).astype(np.int64)
        cols = (col_ids & np.uint64(width - 1)).astype(np.int64)
        n_rows = rmax - rmin + 1
        if n_rows > DENSE_GROUP_ROWS:
            order = np.argsort((rel // DENSE_GROUP_ROWS).astype(np.uint16),
                               kind="stable")
            rel, cols = rel[order], cols[order]
            bounds = np.searchsorted(
                rel, np.arange(0, n_rows + DENSE_GROUP_ROWS,
                               DENSE_GROUP_ROWS))
        else:
            bounds = np.array([0, len(rel)])
        touched: List[np.ndarray] = []
        for g, (lo, hi) in enumerate(zip(bounds[:-1].tolist(),
                                          bounds[1:].tolist())):
            if lo == hi:
                continue
            g0 = g * DENSE_GROUP_ROWS
            g_rows = min(DENSE_GROUP_ROWS, n_rows - g0)
            bits = np.zeros(g_rows * width, dtype=bool)
            bits[(rel[lo:hi] - g0) * width + cols[lo:hi]] = True
            words = np.packbits(bits, bitorder="little").view(
                np.uint64).reshape(g_rows * kpr, CONTAINER_WORDS)
            touched.append(self.merge_masks((rmin + g0) * kpr, words))
        return np.concatenate(touched)

    # -- queries ------------------------------------------------------------

    def count(self) -> int:
        return sum(self.container_count(k) for k in self.containers)

    @staticmethod
    def _positions(c: np.ndarray) -> np.ndarray:
        """Sorted in-container positions of either encoding."""
        return c if c.dtype == np.uint16 else _dense_to_array(c)

    def max(self) -> int:
        if not self.containers:
            return 0
        key = max(self.containers)
        return (key << 16) | int(self._positions(self.containers[key])[-1])

    def slice(self) -> np.ndarray:
        """Every set position, sorted, as uint64."""
        out = []
        for key in sorted(self.containers):
            arr = self._positions(self.containers[key])
            if len(arr):
                out.append(np.uint64(key << 16) + arr.astype(np.uint64))
        if not out:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(out)

    def count_range(self, start: int, end: int) -> int:
        """Bits in [start, end)."""
        if end <= start:
            return 0
        total = 0
        k0, k1 = start >> 16, (end - 1) >> 16
        # Walk the smaller key set: the range span or the containers.
        if k1 - k0 + 1 <= len(self.containers):
            keys = (k for k in range(k0, k1 + 1) if k in self.containers)
        else:
            keys = (k for k in self.containers if k0 <= k <= k1)
        for key in keys:
            lo = max(start - (key << 16), 0)
            hi = min(end - (key << 16), CONTAINER_BITS)
            if lo == 0 and hi == CONTAINER_BITS:
                total += self.container_count(key)
            else:
                arr = self._positions(self.containers[key])
                total += int(np.count_nonzero((arr >= lo) & (arr < hi)))
        return total

    def dense_range(self, start: int, end: int) -> np.ndarray:
        """Dense uint64 words of bits [start, end), container-aligned."""
        assert start & 0xFFFF == 0 and end & 0xFFFF == 0
        n_containers = (end - start) >> 16
        out = np.zeros(n_containers * CONTAINER_WORDS, dtype=np.uint64)
        k0 = start >> 16
        for i in range(n_containers):
            c = self.containers.get(k0 + i)
            if c is None:
                continue
            seg = out[i * CONTAINER_WORDS:(i + 1) * CONTAINER_WORDS]
            if c.dtype == np.uint16:
                v = c.astype(np.uint32)
                np.bitwise_or.at(
                    seg, v >> 6,
                    np.left_shift(np.uint64(1), (v & 63).astype(np.uint64)))
            else:
                seg[:] = c
        return out
