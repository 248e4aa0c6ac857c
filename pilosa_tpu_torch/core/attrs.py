"""Attribute store: key-value attributes on rows and columns.

A copy of the JAX package's ``AttrStore`` merge semantics: a write
merges into the id's attributes, a ``None`` value deletes its key, and
an id whose attributes become empty is dropped. Attributes stay on the
host; no device array holds them.

``gen`` counts mutations: an attribute write changes no fragment
version, so anything cached that embeds attributes (or depends on them,
as an attribute-filtered TopN does) must stamp it.

With a ``path`` the store persists as the JAX package's does: a JSON
snapshot at ``path`` and a ``path.log`` of delta lines, one JSON line a
write, flushed before the write returns. ``open`` loads the snapshot,
replays the whole lines of the log and truncates a torn last line; the
log folds into the snapshot (fsynced, renamed) after
LOG_COMPACT_ENTRIES lines or LOG_COMPACT_BYTES bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Ids a checksum block covers (reference attr.go:80-119).
ATTR_BLOCK_SIZE = 100

# Log lines or bytes after which the log folds into the snapshot (the
# JAX package's defaults).
LOG_COMPACT_ENTRIES = 4096
LOG_COMPACT_BYTES = 8 << 20


class AttrStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.attrs: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self.gen = 0
        self._log_fh = None
        self._log_entries = 0
        self._log_bytes = 0

    @property
    def _log_path(self) -> str:
        return self.path + ".log"

    def open(self) -> None:
        if not self.path:
            return
        with self._lock:
            if os.path.exists(self.path):
                with open(self.path) as f:
                    self.attrs = {int(k): v for k, v in json.load(f).items()}
            if os.path.exists(self._log_path):
                keep = 0
                with open(self._log_path, "rb") as f:
                    for line in f:
                        try:
                            delta = json.loads(line)
                        except ValueError:
                            break  # a torn last line
                        self._apply({int(k): v for k, v in delta.items()})
                        keep += len(line)
                        self._log_entries += 1
                if keep < os.path.getsize(self._log_path):
                    with open(self._log_path, "ab") as f:
                        f.truncate(keep)
                self._log_bytes = keep

    def close(self) -> None:
        with self._lock:
            if self._log_fh is not None:
                self._log_fh.close()
                self._log_fh = None

    def _append(self, items: Dict[int, Dict[str, Any]]) -> None:
        """One flushed log line a write."""
        if not self.path:
            return
        line = json.dumps({str(k): v for k, v in items.items()},
                          separators=(",", ":")) + "\n"
        if self._log_fh is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._log_fh = open(self._log_path, "a")
        self._log_fh.write(line)
        self._log_fh.flush()
        self._log_entries += 1
        self._log_bytes += len(line)
        if self._log_entries >= LOG_COMPACT_ENTRIES or \
                self._log_bytes >= LOG_COMPACT_BYTES:
            self._compact()

    def _compact(self) -> None:
        """Fold the log into the snapshot: the snapshot is written,
        fsynced and renamed before the log is emptied (a crash between
        the two replays deltas already folded, which merge the same)."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self.attrs.items()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self._log_fh is not None:
            self._log_fh.close()
        self._log_fh = open(self._log_path, "w")
        self._log_entries = 0
        self._log_bytes = 0

    def _apply(self, items: Dict[int, Dict[str, Any]]) -> None:
        self.gen += 1
        for id_, attrs in items.items():
            cur = self.attrs.setdefault(id_, {})
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v
            if not cur:
                self.attrs.pop(id_, None)

    def get(self, id_: int) -> Dict[str, Any]:
        with self._lock:
            return dict(self.attrs.get(id_, {}))

    def get_many(self, ids: Iterable[int]) -> Dict[int, Dict[str, Any]]:
        """{id: attributes} of the ids in ``ids`` that have any, in the
        order of ``ids``, under one acquisition of the lock."""
        ids = list(map(int, ids))
        with self._lock:
            return {i: dict(a) for i, a in zip(ids, map(self.attrs.get, ids))
                    if a}

    def set(self, id_: int, attrs: Dict[str, Any]) -> None:
        """Merge ``attrs`` into the id's attributes."""
        with self._lock:
            self._apply({id_: attrs})
            self._append({id_: attrs})

    def set_bulk(self, items: Dict[int, Dict[str, Any]]) -> None:
        with self._lock:
            self._apply(items)
            self._append(items)

    def ids_matching(self, key: str, values: List[Any]) -> List[int]:
        """Ids whose attribute ``key`` equals one of ``values``,
        ascending (TopN's attrName/attrValues)."""
        vals = values if isinstance(values, list) else [values]
        with self._lock:
            # A linear compare: values may be unhashable (lists are legal
            # attribute values).
            return sorted(i for i, a in self.attrs.items()
                          if any(a.get(key) == v for v in vals))

    def blocks(self) -> List[Tuple[int, bytes]]:
        """(block, digest) pairs, ascending, over every block holding an
        id with attributes."""
        with self._lock:
            by_block: Dict[int, List[Tuple[int, str]]] = {}
            for id_, attrs in self.attrs.items():
                by_block.setdefault(id_ // ATTR_BLOCK_SIZE, []).append(
                    (id_, json.dumps(attrs, sort_keys=True)))
        out = []
        for blk in sorted(by_block):
            h = hashlib.blake2b(digest_size=16)
            for id_, payload in sorted(by_block[blk]):
                h.update(f"{id_}:{payload};".encode())
            out.append((blk, h.digest()))
        return out

    def block_data(self, block: int) -> Dict[int, Dict[str, Any]]:
        """{id: attributes} of the ids in ``block``."""
        with self._lock:
            return {i: dict(a) for i, a in self.attrs.items()
                    if i // ATTR_BLOCK_SIZE == block}
