"""Attribute store: key-value attributes on rows and columns, in memory.

A copy of the JAX package's ``AttrStore`` merge semantics: a write
merges into the id's attributes, a ``None`` value deletes its key, and
an id whose attributes become empty is dropped. Attributes stay on the
host; no device array holds them.

``gen`` counts mutations: an attribute write changes no fragment
version, so anything cached that embeds attributes (or depends on them,
as an attribute-filtered TopN does) must stamp it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List


class AttrStore:
    def __init__(self):
        self.attrs: Dict[int, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self.gen = 0

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

    def set_bulk(self, items: Dict[int, Dict[str, Any]]) -> None:
        with self._lock:
            self._apply(items)

    def ids_matching(self, key: str, values: List[Any]) -> List[int]:
        """Ids whose attribute ``key`` equals one of ``values``,
        ascending (TopN's attrName/attrValues)."""
        vals = values if isinstance(values, list) else [values]
        with self._lock:
            # A linear compare: values may be unhashable (lists are legal
            # attribute values).
            return sorted(i for i, a in self.attrs.items()
                          if any(a.get(key) == v for v in vals))
