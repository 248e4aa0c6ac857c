"""Key translation: string keys <-> uint64 ids, in memory.

A copy of the JAX package's ``TranslateStore`` for one node: ids are
allocated from 1, one a new key, in the order keys first appear, and an
allocated mapping never changes. TopN breaks count ties by id, so every
keyed answer depends on that order.

``translate_keys`` takes a whole import's keys at once: the distinct
keys are found in order of first appearance (C-level hashing), the new
ones allocated in that order, and the ids looked up in one pass. It
allocates exactly the ids that ``translate_key`` one key at a time
would.

The reverse map is an object array indexed by id, since allocated ids
are dense: the keys of a Row answer's columns are one gather, not a
dict probe a column. An id far past the array's end (one adopted by
``load_entries``, and those allocated after it) goes to a side dict.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Ids this far or farther past the array's end go to the side dict, so
# one stray adopted id cannot size the array.
_SPARSE_GAP = 1 << 16


class TranslateStore:
    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._by_id = np.full(1024, None, dtype=object)
        self._sparse: Dict[int, str] = {}
        self._next_id = 1
        self._lock = threading.RLock()

    def _store(self, fresh: range, keys: Sequence[str]) -> None:
        """Record ``keys`` under the consecutive ids ``fresh``."""
        if fresh.start >= len(self._by_id) + _SPARSE_GAP:
            self._sparse.update(zip(fresh, keys))
        else:
            if fresh.stop > len(self._by_id):
                grown = np.full(max(fresh.stop, 2 * len(self._by_id)), None,
                                dtype=object)
                grown[:len(self._by_id)] = self._by_id
                self._by_id = grown
            self._by_id[fresh.start:fresh.stop] = list(keys)
        self._next_id = max(self._next_id, fresh.stop)

    def translate_key(self, key: str, create: bool = True) -> Optional[int]:
        """The key's id; a new key gets the next id when ``create``,
        else None."""
        with self._lock:
            id_ = self._ids.get(key)
            if id_ is None and create:
                id_ = self._next_id
                self._ids[key] = id_
                self._store(range(id_, id_ + 1), [key])
            return id_

    def translate_keys(self, keys: Sequence[str], create: bool = True
                       ) -> np.ndarray:
        """uint64 ids of ``keys``, one a key; a missing key is 0 when
        not ``create``."""
        keys = list(keys)
        with self._lock:
            ids = self._ids
            if create:
                new = [k for k in dict.fromkeys(keys) if k not in ids]
                if new:
                    fresh = range(self._next_id, self._next_id + len(new))
                    ids.update(zip(new, fresh))
                    self._store(fresh, new)
            # A list first: np.fromiter converts item by item, slower.
            return np.array(list(map(ids.get, keys, itertools.repeat(0))),
                            dtype=np.uint64)

    def translate_id(self, id_: int) -> Optional[str]:
        return self.translate_ids([id_])[0]

    def translate_ids(self, ids: Iterable[int]) -> List[Optional[str]]:
        """Keys of ``ids`` (None where an id has no key)."""
        arr = np.asarray(ids if isinstance(ids, np.ndarray) else list(ids),
                         dtype=np.uint64)
        with self._lock:
            by_id = self._by_id
            inside = arr < np.uint64(len(by_id))
            if inside.all():
                keys = by_id[arr.astype(np.int64)].tolist()
            else:
                out = np.full(len(arr), None, dtype=object)
                out[inside] = by_id[arr[inside].astype(np.int64)]
                keys = out.tolist()
            if self._sparse:
                get = self._sparse.get
                keys = [k if k is not None else get(i)
                        for i, k in zip(arr.tolist(), keys)]
            return keys

    def load_entries(self, pairs: Iterable[Tuple[str, int]]) -> None:
        """Adopt (key, id) entries made elsewhere (``core/state.py``);
        a key already held under another id is refused."""
        with self._lock:
            for key, id_ in pairs:
                id_ = int(id_)
                cur = self._ids.get(key)
                if cur is None:
                    self._ids[key] = id_
                    self._store(range(id_, id_ + 1), [key])
                elif cur != id_:
                    raise ValueError(
                        f"translate conflict for {key!r}: {cur} != {id_}")

    def size(self) -> int:
        """Number of allocated (key, id) entries."""
        with self._lock:
            return len(self._ids)

    def entries(self) -> List[Tuple[str, int]]:
        """Every (key, id), by id."""
        with self._lock:
            return sorted(self._ids.items(), key=lambda kv: kv[1])
