"""Index: a namespace sharing one column space, with the optional
existence field ``_exists`` that Not() reads, the column attribute
store, and with ``keys`` a translator of column keys (made on first
use).

An index with a ``path`` persists as the JAX package's does: ``.meta``
holds ``{"keys", "trackExistence"}``, each field is a directory, the
column keys live in ``.keys`` and the column attributes in
``.col_attrs``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.cache import CACHE_TYPE_NONE, RankCacheStore
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, Field, FieldOptions
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.view import VIEW_STANDARD

EXISTENCE_FIELD_NAME = "_exists"


class Index:
    """``rank_cache`` is the holder's store of device rank vectors; a
    deleted field's views leave it. ``tracer`` is the holder's, handed
    to every field."""

    def __init__(self, name: str, device: torch.device,
                 track_existence: bool = True,
                 rank_cache: Optional[RankCacheStore] = None,
                 keys: bool = False, path: Optional[str] = None,
                 tracer: Any = None):
        self.path = path
        self.tracer = tracer
        self.name = name
        self.device = device
        self.keys = keys
        self.track_existence = track_existence
        self.rank_cache = rank_cache if rank_cache is not None \
            else RankCacheStore()
        self.fields: Dict[str, Field] = {}
        self._lock = threading.RLock()
        self.column_attr_store = AttrStore(self._file(".col_attrs"))
        self.column_attr_store.open()
        self._column_translator: Optional[TranslateStore] = None
        if track_existence and path is None:
            self._create_existence_field()

    def _file(self, name: str) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, name)

    def _new_field(self, name: str,
                   options: Optional[FieldOptions] = None) -> Field:
        return Field(self.name, name, self.device, options,
                     path=self._file(name),
                     tracer=self.tracer)

    def _create_existence_field(self) -> Field:
        f = self._new_field(EXISTENCE_FIELD_NAME, FieldOptions(
            type=FIELD_TYPE_SET, cache_type=CACHE_TYPE_NONE, cache_size=0))
        if self.path is not None:
            f.save_meta()
        self.fields[EXISTENCE_FIELD_NAME] = f
        return f

    # -- lifecycle -----------------------------------------------------------

    def save_meta(self) -> None:
        """Write ``.meta`` through a rename."""
        os.makedirs(self.path, exist_ok=True)
        tmp = self._file(".meta") + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"keys": self.keys,
                       "trackExistence": self.track_existence}, f)
        os.replace(tmp, self._file(".meta"))

    def open(self) -> None:
        """Load ``.meta`` and every field directory; make ``_exists``
        when existence is tracked and it is missing."""
        meta = self._file(".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                m = json.load(f)
            self.keys = m.get("keys", False)
            self.track_existence = m.get("trackExistence", True)
        if os.path.isdir(self.path):
            for name in sorted(os.listdir(self.path)):
                if os.path.isdir(os.path.join(self.path, name)):
                    f = self._new_field(name)
                    f.open()
                    self.fields[name] = f
        if self.track_existence and EXISTENCE_FIELD_NAME not in self.fields:
            self._create_existence_field()

    def close(self) -> None:
        """Close every field (the fragments save their count caches) and
        the key and attribute files; drop the device banks and rank
        vectors."""
        with self._lock:
            for f in self.fields.values():
                f.close()
                self._forget_views(f)
            if self._column_translator is not None:
                self._column_translator.close()
            self.column_attr_store.close()

    @property
    def column_translator(self) -> TranslateStore:
        with self._lock:
            if self._column_translator is None:
                t = TranslateStore(self._file(".keys"))
                t.open()
                self._column_translator = t
            return self._column_translator

    def existence_field(self) -> Optional[Field]:
        return self.fields.get(EXISTENCE_FIELD_NAME)

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def create_field(self, name: str, options: Optional[FieldOptions] = None,
                     error_if_exists: bool = True) -> Field:
        with self._lock:
            if name in self.fields:
                if error_if_exists:
                    raise ValueError(f"field already exists: {name}")
                return self.fields[name]
            if name.startswith("_"):
                raise ValueError(f"invalid field name: {name}")
            f = self._new_field(name, options)
            if self.path is not None:
                f.save_meta()
            self.fields[name] = f
            return f

    def delete_field(self, name: str) -> None:
        """Drop a field, its device banks, its rank vectors and its
        directory."""
        with self._lock:
            f = self.fields.pop(name, None)
        if f is None:
            raise KeyError(f"field not found: {name}")
        self._drop_field(f)
        if f.path is not None:
            f.close()
            shutil.rmtree(f.path, ignore_errors=True)

    def _forget_views(self, f: Field) -> None:
        for v in list(f.views.values()):
            self.rank_cache.forget_view(v)

    def _drop_field(self, f: Field) -> None:
        f.drop_banks()
        self._forget_views(f)

    def drop_banks(self) -> None:
        """Drop every field's device banks and rank vectors (the index
        was deleted)."""
        for f in list(self.fields.values()):
            self._drop_field(f)

    def add_existence(self, column_ids: np.ndarray) -> None:
        """Mark columns as existing (every write path calls this)."""
        ef = self.existence_field()
        if ef is None:
            return
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        ef.import_bits(np.zeros(len(column_ids), dtype=np.uint64), column_ids)

    def add_existence_words(self, shard: int, words: np.ndarray) -> None:
        """Mark as existing the columns of ``shard`` set in uint64
        [16, 1024] ``words`` (a fragment's ``column_words``): the write
        ``add_existence`` of those columns makes, without listing them."""
        ef = self.existence_field()
        if ef is None or not words.any():
            return
        ef.create_view_if_not_exists(VIEW_STANDARD) \
            .create_fragment_if_not_exists(shard).import_row_words(0, words)

    def available_shards(self) -> List[int]:
        shards = set()
        # list(): a field created on another thread must not break the
        # walk.
        for f in list(self.fields.values()):
            shards.update(f.available_shards())
        return sorted(shards)
