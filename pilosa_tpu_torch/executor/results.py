"""Query result types, with the fields, equality and JSON shapes of the
JAX package's ``executor/results.py``. A Row result keeps its per-shard
words on the device until something asks for columns."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH, to_numpy, \
    unpack_positions


class RowResult:
    """A query-result bitmap partitioned by shard."""

    def __init__(self, shards: List[int], words: torch.Tensor):
        # words: int32 tensor [len(shards), W]
        self.shards = list(shards)
        self.words = words
        self.attrs: Dict[str, Any] = {}
        self.keys: Optional[List[str]] = None
        self._columns: Optional[np.ndarray] = None

    def columns(self) -> np.ndarray:
        """Absolute column ids, sorted (one device->host copy, cached)."""
        if self._columns is not None:
            return self._columns
        host = to_numpy(self.words)
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
        self.words = torch.zeros((len(self.shards), 0), dtype=torch.int32,
                                 device=self.words.device)
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

