"""Field: a typed bitmap matrix within an index.

Types, as the JAX package's ``core/field.py`` has them:

- ``set``: multi-valued rows;
- ``int``: BSI bit-sliced integers with [min, max] and offset encoding;
- ``time``: set rows, and a timestamped write also lands in one view
  per unit of the field's quantum (``standard_2019``,
  ``standard_201901``, ``standard_20190105``; ``core/timeq.py``), which
  range reads union;
- ``mutex``: one row per column: a write clears the column's other row;
- ``bool``: a mutex of rows ``FALSE_ROW_ID`` and ``TRUE_ROW_ID``.

A bulk import with timestamps groups its pairs by the timestamp cut to
the quantum's finest unit and names each group's views once, so a load
of 100M rides spends its time in the fragments, not in ``strftime``.

A field with a ``path`` persists as the JAX package's does: ``.meta``
holds ``asdict(FieldOptions)`` as JSON, each view lives under
``views/<name>``, the row keys in ``.row_keys`` and the row attributes
in ``.row_attrs``.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, view_bsi_name
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH
from pilosa_tpu_torch.utils import tracing

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"
FIELD_TYPES = (FIELD_TYPE_SET, FIELD_TYPE_INT, FIELD_TYPE_TIME,
               FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)

FALSE_ROW_ID = 0
TRUE_ROW_ID = 1


@dataclass
class FieldOptions:
    """Field options, with the names and defaults of the JAX package's
    FieldOptions (so its ``asdict`` form loads here)."""
    type: str = FIELD_TYPE_SET
    cache_type: str = cache_mod.CACHE_TYPE_RANKED
    cache_size: int = cache_mod.DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    time_quantum: str = ""
    keys: bool = False
    no_standard_view: bool = False
    # Declared in-shard column bound (0 = the full shard width): banks
    # trim to the real span.
    max_columns: int = 0

    def validate(self) -> None:
        if self.type not in FIELD_TYPES:
            raise ValueError(f"invalid field type: {self.type}")
        # The JAX package refuses an unknown cache type when the first
        # fragment is made (cache.new_cache); the port refuses it here,
        # with the same message, before anything is written.
        if self.cache_type not in cache_mod.CACHE_TYPES:
            raise ValueError(f"invalid cache type: {self.cache_type}")
        if self.type == FIELD_TYPE_INT:
            if self.max < self.min:
                raise ValueError("int field max must be >= min")
            if (self.max - self.min).bit_length() > 63:
                raise ValueError(
                    "int field range too large: max-min must fit in 63 bits")
        if self.type == FIELD_TYPE_TIME:
            timeq.validate_quantum(self.time_quantum)
            if not self.time_quantum:
                raise ValueError("time field requires a time quantum")
        if not 0 <= self.max_columns <= SHARD_WIDTH:
            raise ValueError(f"max_columns must be in [0, {SHARD_WIDTH}]")


def bit_depth_for_range(min_v: int, max_v: int) -> int:
    """Bits needed for offset-encoded values in [min, max]; at least 1."""
    return max(1, (max_v - min_v).bit_length())


class BSIGroup:
    """Offset-encoded integer group."""

    def __init__(self, name: str, min_v: int, max_v: int):
        self.name = name
        self.min = min_v
        self.max = max_v

    @property
    def bit_depth(self) -> int:
        return bit_depth_for_range(self.min, self.max)

    def base_value(self, value: int) -> int:
        if not (self.min <= value <= self.max):
            raise ValueError(
                f"value {value} outside field range [{self.min}, {self.max}]")
        return value - self.min

    def base_value_clamped(self, value: int, op: str) -> Tuple[int, bool]:
        """Clamp a predicate operand into range; False means the predicate
        is answered without scanning."""
        if op in ("<", "<="):
            if value < self.min:
                return 0, False
            return min(value, self.max) - self.min, True
        if op in (">", ">="):
            if value > self.max:
                return 0, False
            return max(value, self.min) - self.min, True
        if value < self.min or value > self.max:
            return 0, False
        return value - self.min, True


def _by_shard(column_ids: np.ndarray):
    """Yield (shard, selector) over column ids: contiguous slices when the
    ids are sorted by shard (bulk loads), boolean masks otherwise."""
    shards = column_ids // np.uint64(SHARD_WIDTH)
    if len(shards) == 0:
        return
    if bool(np.all(shards[1:] >= shards[:-1])):
        starts = np.concatenate(
            [[0], np.flatnonzero(shards[1:] != shards[:-1]) + 1,
             [len(shards)]])
        for a, b in zip(starts[:-1].tolist(), starts[1:].tolist()):
            yield int(shards[a]), slice(a, b)
        return
    for s in np.unique(shards).tolist():
        yield int(s), shards == np.uint64(s)


class Field:
    def __init__(self, index: str, name: str, device: torch.device,
                 options: Optional[FieldOptions] = None,
                 path: Optional[str] = None,
                 tracer: Any = None):
        self.path = path
        # The node's tracer (the holder's): an import opens its root
        # span there when no span is open on the calling thread.
        self.tracer = tracer
        self.index = index
        self.name = name
        self.device = device
        self.options = options or FieldOptions()
        self.options.validate()
        self.views: Dict[str, View] = {}
        self.bsi_groups: Dict[str, BSIGroup] = {}
        self._lock = threading.RLock()
        self.row_attr_store = AttrStore(self._file(".row_attrs"))
        self.row_attr_store.open()
        self._row_translator: Optional[TranslateStore] = None
        self._set_bsi_group()

    def _file(self, name: str) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, name)

    def _set_bsi_group(self) -> None:
        if self.options.type == FIELD_TYPE_INT:
            self.bsi_groups[self.name] = BSIGroup(
                self.name, self.options.min, self.options.max)

    # -- lifecycle -----------------------------------------------------------

    def save_meta(self) -> None:
        """Write ``.meta`` (the options as JSON) through a rename."""
        os.makedirs(self.path, exist_ok=True)
        tmp = self._file(".meta") + ".tmp"
        with open(tmp, "w") as f:
            json.dump(asdict(self.options), f)
        os.replace(tmp, self._file(".meta"))

    def open(self) -> None:
        """Load ``.meta`` and every view under ``views/``."""
        meta = self._file(".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                self.options = FieldOptions(**json.load(f))
            self._set_bsi_group()
        views_dir = self._file("views")
        if os.path.isdir(views_dir):
            for name in os.listdir(views_dir):
                v = self._new_view(name)
                v.open()
                self.views[name] = v

    def close(self) -> None:
        with self._lock:
            for v in self.views.values():
                v.close()
            if self._row_translator is not None:
                self._row_translator.close()
            self.row_attr_store.close()

    @property
    def row_translator(self) -> TranslateStore:
        """The translator of the field's row keys, made (and with a path
        opened on ``.row_keys``) on first use."""
        with self._lock:
            if self._row_translator is None:
                t = TranslateStore(self._file(".row_keys"))
                t.open()
                self._row_translator = t
            return self._row_translator

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def _new_view(self, name: str) -> View:
        return View(self.name, name, self.device,
                    max_columns=self.options.max_columns,
                    cache_type=self.options.cache_type,
                    cache_size=self.options.cache_size,
                    path=self._file(os.path.join("views", name)),
                    index=self.index)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = self._new_view(name)
                self.views[name] = v
            return v

    def available_shards(self):
        shards = set()
        for v in list(self.views.values()):
            shards.update(v.available_shards())
        return sorted(shards)

    def drop_banks(self) -> None:
        for v in list(self.views.values()):
            v.drop_banks()

    def _bsig(self) -> BSIGroup:
        bsig = self.bsi_groups.get(self.name)
        if bsig is None:
            raise ValueError(f"field {self.name} is not an int field")
        return bsig

    def _check_column_bound(self, column_ids) -> None:
        mc = self.options.max_columns
        if not mc:
            return
        offs = np.asarray(column_ids, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
        if len(offs) and int(offs.max()) >= mc:
            raise ValueError(
                f"column offset {int(offs.max())} outside the field's "
                f"declared max_columns={mc}")

    # -- writes --------------------------------------------------------------

    def _is_mutex(self) -> bool:
        return self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)

    def set_bit(self, row_id: int, column_id: int,
                timestamp: Optional[datetime] = None) -> bool:
        """Set a bit; with ``timestamp`` (time fields) also in one view
        per unit of the quantum. As in the JAX package, the standard
        view is written before a timestamp on another type is refused."""
        self._check_column_bound([column_id])
        changed = False
        if not self.options.no_standard_view:
            view = self.create_view_if_not_exists(VIEW_STANDARD)
            if self._is_mutex():
                changed |= self._set_mutex(view, row_id, column_id)
            else:
                changed |= view.set_bit(row_id, column_id)
        if timestamp is not None:
            if self.options.type != FIELD_TYPE_TIME:
                raise ValueError(
                    f"cannot set timestamp on {self.options.type} field")
            for vname in timeq.views_by_time(VIEW_STANDARD, timestamp,
                                             self.options.time_quantum):
                changed |= self.create_view_if_not_exists(vname).set_bit(
                    row_id, column_id)
        elif self.options.type == FIELD_TYPE_TIME \
                and self.options.no_standard_view:
            raise ValueError(
                "time field with no standard view requires timestamp")
        return changed

    @staticmethod
    def _set_mutex(view: View, row_id: int, column_id: int) -> bool:
        """Clear the column's other row, then set this one."""
        frag = view.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        existing = frag.mutex_vector(column_id)
        if existing is not None and existing != row_id:
            frag.clear_bit(existing, column_id)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        changed = False
        for v in list(self.views.values()):
            changed |= v.clear_bit(row_id, column_id)
        return changed

    def set_value(self, column_id: int, value: int) -> bool:
        self._check_column_bound([column_id])
        bsig = self._bsig()
        base = bsig.base_value(value)
        view = self.create_view_if_not_exists(view_bsi_name(self.name))
        frag = view.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        depth = bsig.bit_depth
        if frag.bit(depth, column_id) and base == sum(
                1 << i for i in range(depth) if frag.bit(i, column_id)):
            return False
        return frag.set_value(column_id, depth, base)

    def value(self, column_id: int) -> Tuple[int, bool]:
        """(value, True) of an int field's column, or (0, False) when it
        holds none; a field of another type raises ValueError."""
        bsig = self._bsig()
        view = self.view(view_bsi_name(self.name))
        if view is None:
            return 0, False
        base, exists = view.value(column_id, bsig.bit_depth)
        return (base + bsig.min, True) if exists else (0, False)

    def clear_value(self, column_id: int) -> bool:
        bsig = self._bsig()
        view = self.view(view_bsi_name(self.name))
        frag = view.fragment(column_id // SHARD_WIDTH) if view else None
        if frag is None or not frag.bit(bsig.bit_depth, column_id):
            return False
        return frag.clear_value(column_id, bsig.bit_depth)

    def import_bits(self, row_ids: np.ndarray, column_ids: np.ndarray,
                    timestamps: Optional[Sequence[Any]] = None,
                    clear: bool = False) -> None:
        """Bulk import of (row, column) pairs: into the standard view
        (unless ``no_standard_view`` with timestamps) and, for each pair
        with a timestamp, into that time's views. ``timestamps`` holds a
        datetime or None a pair. A mutex or bool field imports with mutex
        semantics: the last pair of a column wins and the column's other
        row is cleared."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        self._check_column_bound(column_ids)
        # Pair indexes per target view; None selects every pair.
        by_view: Dict[str, Optional[np.ndarray]] = {}
        if timestamps is None or not self.options.no_standard_view:
            by_view[VIEW_STANDARD] = None
        if timestamps is not None:
            if self.options.type != FIELD_TYPE_TIME:
                raise ValueError("timestamps on non-time field")
            by_view.update(self._time_view_pairs(timestamps, len(row_ids)))
        mutex = self._is_mutex() and not clear
        with tracing.span_in(self.tracer, "Field.import",
                             field=self.name, pairs=len(row_ids)):
            for vname, sel in by_view.items():
                if vname == VIEW_STANDARD and \
                        self.options.no_standard_view:
                    continue
                view = self.create_view_if_not_exists(vname)
                rows = row_ids if sel is None else row_ids[sel]
                cols = column_ids if sel is None else column_ids[sel]
                for shard, s in _by_shard(cols):
                    frag = view.create_fragment_if_not_exists(shard)
                    if mutex:
                        frag.bulk_import_mutex(rows[s], cols[s])
                    else:
                        frag.import_bits(rows[s], cols[s], clear=clear)

    def _time_view_pairs(self, timestamps: Sequence[Any], n_pairs: int
                         ) -> Dict[str, Optional[np.ndarray]]:
        """{time view: ascending pair indexes} of timestamped pairs. The
        pairs group by their time cut to the quantum's finest unit, and
        ``views_by_time`` runs once a group."""
        codes, keys = _time_groups(timestamps, self.options.time_quantum[-1])
        per_view: Dict[str, List[int]] = {}
        for code, t in enumerate(keys):
            if t is None:
                continue
            for vname in timeq.views_by_time(VIEW_STANDARD, t,
                                             self.options.time_quantum):
                per_view.setdefault(vname, []).append(code)
        if not per_view:
            return {}
        small = np.int16 if len(keys) < 1 << 15 else np.int64
        order = np.argsort(codes.astype(small), kind="stable")
        bounds = np.searchsorted(codes[order], np.arange(len(keys) + 1))
        out: Dict[str, Optional[np.ndarray]] = {}
        for vname, cs in per_view.items():
            if len(cs) == len(keys) and len(codes) == n_pairs:
                out[vname] = None
            elif len(cs) == 1:
                out[vname] = order[bounds[cs[0]]:bounds[cs[0] + 1]]
            else:
                member = np.zeros(len(keys), dtype=bool)
                member[cs] = True
                out[vname] = np.flatnonzero(member[codes])
        return out

    def import_values(self, column_ids: np.ndarray, values: np.ndarray,
                      clear: bool = False) -> None:
        """Bulk import of integer values into the BSI view."""
        bsig = self._bsig()
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        self._check_column_bound(column_ids)
        values = np.asarray(values, dtype=np.int64)
        if len(values) and (values.min() < bsig.min
                            or values.max() > bsig.max):
            raise ValueError("value outside field range")
        base = (values - bsig.min).astype(np.uint64)
        view = self.create_view_if_not_exists(view_bsi_name(self.name))
        for shard, sel in _by_shard(column_ids):
            view.create_fragment_if_not_exists(shard).import_values(
                column_ids[sel], base[sel], bsig.bit_depth, clear=clear)

    # -- time range reads ----------------------------------------------------

    def views_for_range(self, start: datetime, end: datetime) -> List[str]:
        """The minimal cover of [start, end) by the quantum's views."""
        return timeq.views_by_time_range(VIEW_STANDARD, start, end,
                                         self.options.time_quantum)


    def row_time(self, row_id: int, t: datetime, quantum: str
                 ) -> Optional[View]:
        """The time view of ``t`` at one unit of the quantum (Y, M, D or
        H), or None when it does not exist (the JAX package's
        ``Field.row_time``, which returns that view; ``row_id`` selects
        nothing there either)."""
        return self.view(timeq.view_by_time_unit(VIEW_STANDARD, t, quantum))

def _truncate(t: datetime, unit: str) -> datetime:
    """``t`` cut to the start of its ``unit`` (Y, M, D or H)."""
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0,
                         microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _time_groups(timestamps: Sequence[Any], unit: str
                 ) -> Tuple[np.ndarray, List[Optional[datetime]]]:
    """(group code a pair, each group's time cut to ``unit`` or None).
    Pairs whose times share a ``unit`` share every view of a quantum
    whose finest unit is ``unit``."""
    # Distinct objects first (C-level hashing), then each distinct time
    # cut once.
    distinct = list(dict.fromkeys(timestamps))
    code_of = {t: i for i, t in enumerate(distinct)}
    codes = np.fromiter(map(code_of.__getitem__, timestamps),
                        dtype=np.int64, count=len(timestamps))
    cut_code: Dict[Optional[datetime], int] = {}
    remap = np.empty(len(distinct), np.int64)
    for i, t in enumerate(distinct):
        key = None if t is None else _truncate(t, unit)
        remap[i] = cut_code.setdefault(key, len(cut_code))
    return remap[codes], list(cut_code)
