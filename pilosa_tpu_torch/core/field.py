"""Field: a typed bitmap matrix within an index.

Types in this port: ``set`` (multi-valued rows) and ``int`` (BSI
bit-sliced integers with [min, max] and offset encoding). The ``time``,
``mutex`` and ``bool`` types of the JAX package's ``core/field.py`` are
not part of it yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import cache as cache_mod
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View, view_bsi_name
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"


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
        if self.type not in (FIELD_TYPE_SET, FIELD_TYPE_INT):
            raise ValueError(f"field type {self.type!r} is not supported "
                             "by the port yet (set and int are)")
        if self.keys:
            raise ValueError("keyed fields are not supported by the port yet")
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
                 options: Optional[FieldOptions] = None):
        self.index = index
        self.name = name
        self.device = device
        self.options = options or FieldOptions()
        self.options.validate()
        self.views: Dict[str, View] = {}
        self.bsi_groups: Dict[str, BSIGroup] = {}
        self._lock = threading.RLock()
        if self.options.type == FIELD_TYPE_INT:
            self.bsi_groups[name] = BSIGroup(name, self.options.min,
                                             self.options.max)

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = View(self.name, name, self.device,
                         max_columns=self.options.max_columns,
                         cache_type=self.options.cache_type,
                         cache_size=self.options.cache_size)
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

    def set_bit(self, row_id: int, column_id: int) -> bool:
        self._check_column_bound([column_id])
        return self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
            row_id, column_id)

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
        frag.import_values(np.array([column_id], np.uint64),
                           np.array([base], np.uint64), depth)
        return True

    def clear_value(self, column_id: int) -> bool:
        bsig = self._bsig()
        view = self.view(view_bsi_name(self.name))
        frag = view.fragment(column_id // SHARD_WIDTH) if view else None
        if frag is None or not frag.bit(bsig.bit_depth, column_id):
            return False
        frag.import_values(np.array([column_id], np.uint64),
                           np.array([0], np.uint64), bsig.bit_depth,
                           clear=True)
        return True

    def import_bits(self, row_ids: np.ndarray, column_ids: np.ndarray,
                    clear: bool = False) -> None:
        """Bulk import of (row, column) pairs into the standard view."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        self._check_column_bound(column_ids)
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        for shard, sel in _by_shard(column_ids):
            view.create_fragment_if_not_exists(shard).import_bits(
                row_ids[sel], column_ids[sel], clear=clear)

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
