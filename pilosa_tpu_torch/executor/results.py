"""Query result types, with the fields, equality and JSON shapes of the
JAX package's ``executor/results.py``. A Row result keeps its per-shard
words on the device until something asks for columns."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, to_numpy, \
    unpack_positions


class RowResult:
    """A query-result bitmap partitioned by shard."""

    def __init__(self, shards: List[int], words: Optional[torch.Tensor],
                 host: Optional[np.ndarray] = None):
        # words: int32 tensor [len(shards), W]
        self.shards = list(shards)
        self._words = words
        # A result-cache hit's words: the entry's host array, read-only
        # (shared by every hit of the entry, so nothing may write it).
        self._host = host
        self.attrs: Dict[str, Any] = {}
        self.keys: Optional[List[str]] = None
        self._columns: Optional[np.ndarray] = None
        # Served from the result cache: the words are host words already.
        self.cached = host is not None
        # Called once with the host words when columns() copies them
        # (the result cache's eval-tier fill rides that copy).
        self.on_host: Optional[Callable[[np.ndarray], None]] = None

    @property
    def words(self) -> torch.Tensor:
        """The words as an int32 tensor; a cache hit's are a copy of the
        entry's read-only host words, made when first asked for."""
        if self._words is None:
            self._words = torch.from_numpy(
                self._host.view(np.int32).copy())
        return self._words

    def columns(self) -> np.ndarray:
        """Absolute column ids, sorted (one device->host copy, cached)."""
        if self._columns is not None:
            return self._columns
        host = self._host if self._host is not None \
            else to_numpy(self.words)
        if self.on_host is not None:
            hook, self.on_host = self.on_host, None
            # On the CPU the host words alias the tensor: keep a copy.
            hook(host.copy() if self.words.device.type == "cpu" else host)
        out = []
        for i, shard in enumerate(self.shards):
            pos = unpack_positions(host[i])
            if len(pos):
                out.append(pos + np.uint64(shard * SHARD_WIDTH))
        self._columns = (np.concatenate(out) if out
                         else np.empty(0, dtype=np.uint64))
        return self._columns

    def clear_columns(self) -> None:
        """Drop the column data, keeping attrs (``excludeColumns``)."""
        device = self._words.device if self._words is not None else "cpu"
        self._words = torch.zeros((len(self.shards), 0), dtype=torch.int32,
                                  device=device)
        self._host = None
        self._columns = np.empty(0, dtype=np.uint64)

    def count(self) -> int:
        from pilosa_tpu_torch.ops import kernels
        words = self.words
        if words.numel() == 0:
            return 0
        return int(kernels.bank_row_counts(
            words.contiguous().unsqueeze(0))[0])

    def to_json(self) -> dict:
        d = {"columns": self.columns().tolist()}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.keys is not None:
            d["keys"] = self.keys
        return d


@dataclass
class PairsResult:
    """TopN result: (id, count) pairs sorted by (-count, id)."""
    pairs: List[Tuple[int, int]]
    keys: Optional[List[str]] = None

    def to_json(self) -> List[dict]:
        if self.keys is not None:
            return [{"key": k, "count": int(c)}
                    for (_, c), k in zip(self.pairs, self.keys)]
        return [{"id": int(r), "count": int(c)} for r, c in self.pairs]


@dataclass
class ValCount:
    """Sum/Min/Max result."""
    value: int
    count: int

    def to_json(self) -> dict:
        return {"value": int(self.value), "count": int(self.count)}


@dataclass
class RowIdentifiers:
    """Rows() result: row ids, ascending."""
    rows: List[int]
    keys: Optional[List[str]] = None

    def to_json(self) -> dict:
        if self.keys is not None:
            return {"keys": self.keys}
        return {"rows": [int(r) for r in self.rows]}


@dataclass
class FieldRow:
    """One (field, row) member of a GroupBy group."""
    field: str
    row_id: int
    row_key: Optional[str] = None

    def to_json(self) -> dict:
        if self.row_key is not None:
            return {"field": self.field, "rowKey": self.row_key}
        return {"field": self.field, "rowID": int(self.row_id)}


@dataclass
class GroupCount:
    """One GroupBy group and its count."""
    group: List[FieldRow]
    count: int

    def to_json(self) -> dict:
        return {"group": [g.to_json() for g in self.group],
                "count": int(self.count)}


def result_to_json(result: Any) -> Any:
    """The JSON form of one call's result, as the reference shapes it."""
    if hasattr(result, "to_json"):
        return result.to_json()
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, (bool, int, str, type(None))):
        return result
    if isinstance(result, np.integer):
        return int(result)
    raise TypeError(f"unserializable result {type(result)}")

