"""Key translation: string keys <-> uint64 ids.

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
``apply_entries``, and those allocated after it) goes to a side dict.

With a ``path`` the store keeps the JAX package's append-only log: an
8-byte header (``PTLT`` and u32 version 1), then a record a key (u32
byte length, the utf-8 key, u64 id). New keys are appended and flushed
before their ids are returned; a batch of new keys is one write, of
the bytes the JAX package writes one key at a time. ``open`` replays
the log and cuts a record torn by a crash, so the next append starts on
a record boundary (the JAX store appends after the torn bytes; see
ROADMAP.md's reference notes).
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Ids this far or farther past the array's end go to the side dict, so
# one stray adopted id cannot size the array.
_SPARSE_GAP = 1 << 16


MAGIC = b"PTLT" + struct.pack("<I", 1)


def encode_records(keys: Sequence[str], ids: Sequence[int]) -> bytes:
    """Log records of (key, id) pairs, vectorised: each key's bytes land
    at their record's offset in one scatter."""
    raws = [k.encode("utf-8") for k in keys]
    n = len(raws)
    if not n:
        return b""
    lens = np.fromiter(map(len, raws), dtype=np.int64, count=n)
    starts = np.concatenate(([0], np.cumsum(lens + 12)[:-1]))
    out = np.empty(int(lens.sum()) + 12 * n, dtype=np.uint8)
    four = np.arange(4)
    out[(starts[:, None] + four).ravel()] = \
        lens.astype("<u4").view(np.uint8)
    body = np.frombuffer(b"".join(raws), dtype=np.uint8)
    out[np.arange(len(body)) + np.repeat(starts + 4, lens)
        - np.repeat(np.cumsum(lens) - lens, lens)] = body
    out[((starts + 4 + lens)[:, None] + np.arange(8)).ravel()] = \
        np.asarray(ids, dtype="<u8").view(np.uint8)
    return out.tobytes()


def parse_records(data: bytes) -> Tuple[List[str], List[int], int]:
    """(keys, ids, bytes consumed) of the whole records at the start of
    ``data``; a torn last record is left out of all three."""
    keys: List[str] = []
    ids: List[int] = []
    pos, end = 0, len(data)
    unpack_len = struct.Struct("<I").unpack_from
    unpack_id = struct.Struct("<Q").unpack_from
    while pos + 4 <= end:
        (n,) = unpack_len(data, pos)
        if pos + 12 + n > end:
            break
        keys.append(data[pos + 4:pos + 4 + n].decode("utf-8"))
        ids.append(unpack_id(data, pos + 4 + n)[0])
        pos += 12 + n
    return keys, ids, pos


class TranslateStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._ids: Dict[str, int] = {}
        self._by_id = np.full(1024, None, dtype=object)
        self._sparse: Dict[int, str] = {}
        self._next_id = 1
        self._lock = threading.RLock()
        self._file = None

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> None:
        """Replay the log at ``path`` (made, with its header, if missing
        or empty), cutting a torn last record."""
        if self.path is None:
            return
        with self._lock:
            data = b""
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    data = f.read()
            if len(data) < len(MAGIC) and MAGIC.startswith(data):
                # Missing, or torn in its header: no record can exist.
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                with open(self.path, "wb") as f:
                    f.write(MAGIC)
            else:
                if not data.startswith(MAGIC):
                    raise ValueError(
                        f"{self.path}: bad translate log header "
                        f"{data[:8]!r}; expected {MAGIC!r}")
                keys, ids, used = parse_records(data[8:])
                if len(set(keys)) != len(keys):
                    first = dict(zip(reversed(keys), reversed(ids)))
                    keys, ids = list(first), list(first.values())
                self._adopt(keys, ids)
                if 8 + used < len(data):
                    with open(self.path, "r+b") as f:
                        f.truncate(8 + used)
            self._file = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def _append(self, keys: Sequence[str], ids: Sequence[int]) -> None:
        if self._file is not None and len(keys):
            self._file.write(encode_records(keys, ids))
            self._file.flush()

    def _adopt(self, keys: Sequence[str], ids: Sequence[int]) -> None:
        """Record (key, id) pairs whose keys are new: the consecutive
        runs of ids in one array store each."""
        i, n = 0, len(keys)
        while i < n:
            j = i + 1
            while j < n and ids[j] == ids[j - 1] + 1:
                j += 1
            self._ids.update(zip(keys[i:j], ids[i:j]))
            self._store(range(ids[i], ids[j - 1] + 1), keys[i:j])
            i = j

    def log_bytes(self) -> bytes:
        """Every entry as log records, by id (the header left out)."""
        with self._lock:
            entries = self.entries()
            return encode_records([k for k, _ in entries],
                                  [i for _, i in entries])

    def apply_log(self, data: bytes) -> int:
        """Adopt the whole records of ``data`` whose keys are new (a
        torn last record stops it); returns how many."""
        keys, ids, _ = parse_records(data)
        with self._lock:
            new = [(k, i) for k, i in zip(keys, ids) if k not in self._ids]
            self.apply_entries(new)
            return len(new)

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
                self._append([key], [id_])
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
                    self._append(new, fresh)
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

    def apply_entries(self, pairs: Iterable[Tuple[str, int]]) -> None:
        """Adopt (key, id) entries made elsewhere (``core/state.py``),
        logged with a path; a key already held under another id is
        refused."""
        with self._lock:
            keys: List[str] = []
            ids: List[int] = []
            seen: Dict[str, int] = {}
            for key, id_ in pairs:
                id_ = int(id_)
                cur = self._ids.get(key, seen.get(key))
                if cur is None:
                    seen[key] = id_
                    keys.append(key)
                    ids.append(id_)
                elif cur != id_:
                    raise ValueError(
                        f"translate conflict for {key!r}: {cur} != {id_}")
            self._append(keys, ids)
            self._adopt(keys, ids)

    def size(self) -> int:
        """Number of allocated (key, id) entries."""
        with self._lock:
            return len(self._ids)

    def entries(self) -> List[Tuple[str, int]]:
        """Every (key, id), by id."""
        with self._lock:
            return sorted(self._ids.items(), key=lambda kv: kv[1])
