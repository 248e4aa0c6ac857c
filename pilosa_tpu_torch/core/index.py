"""Index: a namespace sharing one column space, with the optional
existence field ``_exists`` that Not() reads, the column attribute
store, and with ``keys`` a translator of column keys (made on first
use)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.cache import CACHE_TYPE_NONE, RankCacheStore
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, Field, FieldOptions
from pilosa_tpu_torch.core.translate import TranslateStore

EXISTENCE_FIELD_NAME = "_exists"


class Index:
    """``rank_cache`` is the holder's store of device rank vectors; a
    deleted field's views leave it."""

    def __init__(self, name: str, device: torch.device,
                 track_existence: bool = True,
                 rank_cache: Optional[RankCacheStore] = None,
                 keys: bool = False):
        self.name = name
        self.device = device
        self.keys = keys
        self.track_existence = track_existence
        self.rank_cache = rank_cache if rank_cache is not None \
            else RankCacheStore()
        self.fields: Dict[str, Field] = {}
        self._lock = threading.RLock()
        self.column_attr_store = AttrStore()
        self._column_translator: Optional[TranslateStore] = None
        if track_existence:
            self.fields[EXISTENCE_FIELD_NAME] = Field(
                name, EXISTENCE_FIELD_NAME, device,
                FieldOptions(type=FIELD_TYPE_SET, cache_type=CACHE_TYPE_NONE,
                             cache_size=0))

    @property
    def column_translator(self) -> TranslateStore:
        with self._lock:
            if self._column_translator is None:
                self._column_translator = TranslateStore()
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
            f = Field(self.name, name, self.device, options)
            self.fields[name] = f
            return f

    def delete_field(self, name: str) -> None:
        """Drop a field, its device banks and its rank vectors."""
        with self._lock:
            f = self.fields.pop(name, None)
        if f is None:
            raise KeyError(f"field not found: {name}")
        self._drop_field(f)

    def _drop_field(self, f: Field) -> None:
        f.drop_banks()
        for v in list(f.views.values()):
            self.rank_cache.forget_view(v)

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

    def available_shards(self) -> List[int]:
        shards = set()
        # list(): a field created on another thread must not break the
        # walk.
        for f in list(self.fields.values()):
            shards.update(f.available_shards())
        return sorted(shards)
