"""API facade of the port's server: the programmatic surface between the
HTTP routes and the executor, after the JAX package's ``server/api.py``.

Single node only. The cluster, key translation, attributes, time fields,
the debug and metrics planes, health, failpoints and the sentinel are not
ported: a request that needs one of them answers a 400 that names it,
never a silently different result.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH

# Field options the create-field body may carry (reference names).
_FIELD_OPTIONS = {"type": "type", "cacheType": "cache_type",
                  "cacheSize": "cache_size", "min": "min", "max": "max",
                  "timeQuantum": "time_quantum", "keys": "keys",
                  "noStandardView": "no_standard_view",
                  "maxColumns": "max_columns"}


class ApiError(ValueError):
    """A request error with its HTTP status; ``headers`` go out with
    the response."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status
        self.headers: Optional[Dict[str, str]] = None


def not_ported(what: str) -> ApiError:
    return ApiError(f"{what} is not ported yet", 400)


class API:
    """Queries, schema and imports over one in-memory Holder. The
    executor runs on the holder's device. ``coalescer`` is attached by
    the server wiring (``cli/main.py``) or a test; None means every
    query takes the direct path."""

    def __init__(self, holder: Holder):
        self.holder = holder
        self.executor = Executor(holder, device=holder.device)
        self.coalescer = None
        self.node_id = uuid.uuid4().hex

    # ----------------------------------------------------------------- query

    def query(self, index: str, query: Any,
              shards: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """The direct path: ``{"results": [...]}`` of one request."""
        return self.executor.execute_full(index, query, shards=shards)

    def query_coalesced(self, index: str, query: Any,
                        shards: Optional[Sequence[int]] = None
                        ) -> Dict[str, Any]:
        """``query`` through the coalescer when one is attached and
        running: concurrent requests share executor batches. Only a
        coalescer that stopped under the request (``CoalescerStopped``)
        re-runs it on the direct path; any other error is the
        request's."""
        from pilosa_tpu_torch.server.coalescer import CoalescerStopped
        coal = self.coalescer
        if coal is None or not coal.running:
            return self.query(index, query, shards=shards)
        try:
            return coal.submit(index, query, shards=shards)
        except CoalescerStopped:
            return self.query(index, query, shards=shards)

    def query_batch(self, items: Sequence[Any]) -> List[Dict[str, Any]]:
        """N independent queries in one request and one executor batch.
        Each item is ``{"index", "query", "shards"?}``; the answer holds
        ``{"results": ...}`` or ``{"error": ...}`` per item, so one bad
        item fails none of its batchmates."""
        reqs: List[Any] = []
        bad: Dict[int, Dict[str, str]] = {}
        for pos, it in enumerate(items):
            try:
                reqs.append((it["index"], it["query"], it.get("shards")))
            except (KeyError, TypeError) as e:
                bad[pos] = {"error": f"bad batch item: {e!r}"}
                reqs.append(None)
        shaped = iter(self.executor.execute_batch_shaped(
            [r for r in reqs if r is not None]))
        out = []
        for pos, r in enumerate(reqs):
            if r is None:
                out.append(bad[pos])
                continue
            res = next(shaped)
            out.append({"error": str(res)} if isinstance(res, Exception)
                       else res)
        return out

    # ---------------------------------------------------------------- schema

    def schema(self) -> Dict[str, Any]:
        return {"indexes": self.holder.schema()}

    def create_index(self, name: str, keys: bool = False,
                     track_existence: bool = True) -> Dict[str, Any]:
        if keys:
            raise not_ported("index keys (key translation)")
        try:
            idx = self.holder.create_index(name,
                                           track_existence=track_existence)
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        return {"name": idx.name}

    def delete_index(self, name: str) -> None:
        try:
            self.holder.delete_index(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    def create_field(self, index: str, name: str,
                     options: Optional[dict] = None) -> Dict[str, Any]:
        idx = self._index(index)
        opts = FieldOptions()
        for k, v in dict(options or {}).items():
            if k not in _FIELD_OPTIONS:
                raise ApiError(f"unknown field option {k!r}")
            setattr(opts, _FIELD_OPTIONS[k], v)
        try:
            f = idx.create_field(name, opts)
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        return {"name": f.name}

    def delete_field(self, index: str, name: str) -> None:
        idx = self._index(index)
        try:
            idx.delete_field(name)
        except KeyError as e:
            raise ApiError(str(e), 404)

    # --------------------------------------------------------------- imports

    def import_bits(self, index: str, field: str, rows=None, columns=None,
                    row_keys=None, column_keys=None, timestamps=None,
                    clear: bool = False) -> None:
        """Bulk bit import: the bits go into the field's standard view,
        and the columns into existence unless ``clear``."""
        idx = self._index(index)
        f = self._field(idx, field)
        if row_keys is not None or column_keys is not None:
            raise not_ported("import keys (key translation)")
        if timestamps is not None:
            raise not_ported("import timestamps (time fields)")
        rows = np.asarray(rows, dtype=np.uint64)
        columns = np.asarray(columns, dtype=np.uint64)
        if len(rows) != len(columns):
            raise ApiError("rows and columns length mismatch")
        f.import_bits(rows, columns, clear=clear)
        if not clear:
            idx.add_existence(columns)

    def import_values(self, index: str, field: str, columns=None,
                      values=None, column_keys=None,
                      clear: bool = False) -> None:
        """Bulk integer import into an int field's BSI view."""
        idx = self._index(index)
        f = self._field(idx, field)
        if column_keys is not None:
            raise not_ported("import keys (key translation)")
        columns = np.asarray(columns, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if len(columns) != len(values):
            raise ApiError("columns and values length mismatch")
        try:
            f.import_values(columns, values, clear=clear)
        except ValueError as e:
            raise ApiError(str(e))
        if not clear:
            idx.add_existence(columns)

    # ---------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        return {"state": "NORMAL",
                "nodes": [{"id": self.node_id, "isCoordinator": True,
                           "uri": {}}]}

    def info(self) -> Dict[str, Any]:
        return {"shardWidth": SHARD_WIDTH,
                "cpuPhysicalCores": os.cpu_count(),
                "version": __version__,
                "device": str(self.holder.device)}

    def version(self) -> Dict[str, str]:
        return {"version": __version__}

    # --------------------------------------------------------------- helpers

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index not found: {name}", 404)
        return idx

    def _field(self, idx, name: str):
        f = idx.field(name)
        if f is None:
            raise ApiError(f"field not found: {name}", 404)
        return f
