"""Index: a namespace sharing one column space, with the optional
existence field ``_exists`` that Not() reads."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, Field, FieldOptions

EXISTENCE_FIELD_NAME = "_exists"


class Index:
    def __init__(self, name: str, device: torch.device,
                 track_existence: bool = True):
        self.name = name
        self.device = device
        self.track_existence = track_existence
        self.fields: Dict[str, Field] = {}
        self._lock = threading.RLock()
        if track_existence:
            self.fields[EXISTENCE_FIELD_NAME] = Field(
                name, EXISTENCE_FIELD_NAME, device,
                FieldOptions(type=FIELD_TYPE_SET, cache_type="none",
                             cache_size=0))

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
        """Drop a field and its device banks."""
        with self._lock:
            f = self.fields.pop(name, None)
        if f is None:
            raise KeyError(f"field not found: {name}")
        f.drop_banks()

    def drop_banks(self) -> None:
        for f in list(self.fields.values()):
            f.drop_banks()

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
