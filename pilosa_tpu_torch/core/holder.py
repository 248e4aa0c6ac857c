"""Holder: owns every index, in memory, on one device."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

import torch

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.device import resolve_device


class Holder:
    """In-memory holder. ``device`` defaults to CUDA and raises where
    there is none; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.indexes: Dict[str, Index] = {}
        self._lock = threading.RLock()

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, track_existence: bool = True,
                     error_if_exists: bool = True) -> Index:
        with self._lock:
            if name in self.indexes:
                if error_if_exists:
                    raise ValueError(f"index already exists: {name}")
                return self.indexes[name]
            if not name or not name.islower() or not name[0].isalpha():
                raise ValueError(f"invalid index name: {name!r}")
            idx = Index(name, self.device, track_existence=track_existence)
            self.indexes[name] = idx
            return idx

    def delete_index(self, name: str) -> None:
        """Drop an index and its device banks."""
        with self._lock:
            idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index not found: {name}")
        idx.drop_banks()

    def schema(self) -> List[dict]:
        """Every index with its fields and options, in the JSON form of
        the JAX package's ``Holder.schema`` (the ``/schema`` route)."""
        with self._lock:
            indexes = sorted(self.indexes.items())
        out = []
        for iname, idx in indexes:
            fields = []
            for fname, f in sorted(idx.fields.items()):
                if fname.startswith("_"):
                    continue
                o = f.options
                fields.append({"name": fname, "options": {
                    "type": o.type, "cacheType": o.cache_type,
                    "cacheSize": o.cache_size, "min": o.min, "max": o.max,
                    "timeQuantum": o.time_quantum, "keys": o.keys,
                    "noStandardView": o.no_standard_view,
                    "maxColumns": o.max_columns}})
            # The port has no keyed indexes.
            out.append({"name": iname,
                        "options": {"keys": False,
                                    "trackExistence": idx.track_existence},
                        "fields": fields,
                        "shards": idx.available_shards()})
        return out
