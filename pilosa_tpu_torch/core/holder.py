"""Holder: owns every index, on one device, in memory or under one data
directory.

``Holder(path)`` is the JAX package's ``Holder(path)``: ``open`` walks
``path`` (one directory an index, each with its ``.meta``), keeps the
node id in ``.id`` and raises the open-file limit, since every open
fragment keeps an append handle; ``close`` saves the count caches,
closes every file and drops the device banks and rank vectors, so
nothing of a closed holder serves a reopened one. The JAX package and
the port open each other's directories.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

from pilosa_tpu_torch.core.cache import RankCacheStore
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.device import resolve_device
from pilosa_tpu_torch.utils.tracing import RecordingTracer


class Holder:
    """A holder in memory (no ``path``) or over the data directory
    ``path`` (call ``open`` first). ``device`` defaults to CUDA and
    raises where there is none; pass ``device="cpu"`` to run on the
    CPU. The holder owns the store of device rank vectors
    (``rank_cache``) that TopN keeps per view bank, so two holders share
    no state. ``tracer`` is the node's tracer (a new ``RecordingTracer``
    where none is given): the spans of the holder's imports land there
    whether or not a server runs, and the API adopts it."""

    def __init__(self, path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 tracer: Any = None):
        self.path = path
        self.device = resolve_device(device)
        self.indexes: Dict[str, Index] = {}
        self.rank_cache = RankCacheStore()
        self.tracer = tracer if tracer is not None else RecordingTracer()
        self._lock = threading.RLock()
        self.node_id: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> None:
        """Open every index under ``path`` (made if missing)."""
        os.makedirs(self.path, exist_ok=True)
        self._raise_file_limit()
        self.node_id = self._load_node_id()
        for name in sorted(os.listdir(self.path)):
            ipath = os.path.join(self.path, name)
            if name.startswith(".") or not os.path.isdir(ipath):
                continue
            idx = Index(name, self.device, rank_cache=self.rank_cache,
                        path=ipath, tracer=self.tracer)
            idx.open()
            self.indexes[name] = idx

    def close(self) -> None:
        with self._lock:
            for idx in self.indexes.values():
                idx.close()

    @staticmethod
    def _raise_file_limit() -> None:
        """Raise RLIMIT_NOFILE's soft limit to its hard limit (a finite
        10240 where the kernel refuses an infinite one)."""
        try:
            import resource
            soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
            if hard == resource.RLIM_INFINITY or soft < hard:
                try:
                    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
                except (ValueError, OSError):
                    finite = 10240 if hard == resource.RLIM_INFINITY \
                        else min(hard, 10240)
                    if finite > soft:
                        resource.setrlimit(resource.RLIMIT_NOFILE,
                                           (finite, hard))
        except (ImportError, ValueError, OSError):
            pass

    def _load_node_id(self) -> str:
        """The node id kept in ``.id``, made on first open."""
        id_path = os.path.join(self.path, ".id")
        if os.path.exists(id_path):
            with open(id_path) as f:
                return f.read().strip()
        node_id = uuid.uuid4().hex
        with open(id_path, "w") as f:
            f.write(node_id)
        return node_id

    def iter_fragments(self) -> Iterator:
        for idx in list(self.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    yield from list(v.fragments.values())

    def flush_caches(self) -> None:
        for frag in self.iter_fragments():
            frag.flush_cache()

    def import_stats(self) -> Dict[str, float]:
        """The fragments' bulk-import counters, summed: set imports the
        dense builder declined (``sorted_calls``), those of them that
        recounted no row (``batch_calls``), and seconds in
        ``import_bits``."""
        out = {"sorted_calls": 0, "batch_calls": 0, "seconds": 0.0}
        for frag in self.iter_fragments():
            out["sorted_calls"] += frag.import_sorted_calls
            out["batch_calls"] += frag.import_batch_calls
            out["seconds"] += frag.import_seconds
        return out

    def tail_dropped_bytes(self) -> int:
        """Torn op-log bytes the open moved to ``.torn`` sidecars."""
        return sum(frag.tail_dropped_bytes
                   for frag in self.iter_fragments())

    # -- indexes -------------------------------------------------------------

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True,
                     error_if_exists: bool = True) -> Index:
        with self._lock:
            if name in self.indexes:
                if error_if_exists:
                    raise ValueError(f"index already exists: {name}")
                return self.indexes[name]
            if not name or not name.islower() or not name[0].isalpha():
                raise ValueError(f"invalid index name: {name!r}")
            path = None if self.path is None \
                else os.path.join(self.path, name)
            idx = Index(name, self.device, track_existence=track_existence,
                        rank_cache=self.rank_cache, keys=keys, path=path,
                        tracer=self.tracer)
            if path is not None:
                idx.save_meta()
                idx.open()
            self.indexes[name] = idx
            return idx

    def delete_index(self, name: str) -> None:
        """Drop an index, its device banks, its rank vectors and its
        directory."""
        with self._lock:
            idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index not found: {name}")
        idx.drop_banks()
        if idx.path is not None:
            idx.close()
            shutil.rmtree(idx.path, ignore_errors=True)

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
            out.append({"name": iname,
                        "options": {"keys": idx.keys,
                                    "trackExistence": idx.track_existence},
                        "fields": fields,
                        "shards": idx.available_shards()})
        return out
