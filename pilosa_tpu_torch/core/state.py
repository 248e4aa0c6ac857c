"""Fill a port Holder from a plain dict of numpy arrays.

The dict is the port's interchange form for index contents::

    {index: {field: {"options": {...FieldOptions keywords...},
                     "views": {view: {shard: {row_id: uint64 offsets}}},
                     "keys": [(row key, row id), ...],
                     "row_attrs": {row_id: {name: value}}},
             "@index": {"options": {"keys": bool},
                        "keys": [(column key, column id), ...],
                        "column_attrs": {column_id: {name: value}}}}}

Offsets are in-shard column offsets (0 <= offset < 2^20). The existence
field ``_exists`` rides like any other field. ``"@index"`` is no field
name (a field name starts with a lowercase letter): it carries the
index's own options, its column keys and its column attributes. Every
entry but a field's ``views`` may be left out. The translators adopt
the (key, id) pairs as they are, so the ids are the producer's. Any
producer that can list its rows' set bits can build it, so two
implementations can be filled with identical data.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.ops.bitset import SHARD_WIDTH

INDEX_ENTRY = "@index"


def load_state(holder: Holder, state: Dict[str, Dict[str, Any]]) -> Holder:
    """Create every index, field and view in ``state`` on ``holder`` and
    import its bits; returns ``holder``."""
    for index_name, fields in state.items():
        own = fields.get(INDEX_ENTRY, {})
        idx = holder.create_index(
            index_name, keys=bool(own.get("options", {}).get("keys")),
            track_existence=EXISTENCE_FIELD_NAME in fields,
            error_if_exists=False)
        if own.get("keys"):
            idx.column_translator.apply_entries(own["keys"])
        if own.get("column_attrs"):
            idx.column_attr_store.set_bulk(
                {int(c): dict(a) for c, a in own["column_attrs"].items()})
        for field_name, spec in fields.items():
            if field_name == INDEX_ENTRY:
                continue
            if field_name == EXISTENCE_FIELD_NAME:
                field = idx.existence_field()
            else:
                field = idx.create_field(
                    field_name, FieldOptions(**spec.get("options", {})),
                    error_if_exists=False)
            if spec.get("keys"):
                field.row_translator.apply_entries(spec["keys"])
            if spec.get("row_attrs"):
                field.row_attr_store.set_bulk(
                    {int(r): dict(a) for r, a in spec["row_attrs"].items()})
            for view_name, shards in spec.get("views", {}).items():
                view = field.create_view_if_not_exists(view_name)
                for shard, rows in shards.items():
                    frag = view.create_fragment_if_not_exists(int(shard))
                    parts = [(r, np.asarray(o, dtype=np.uint64))
                             for r, o in rows.items() if len(o)]
                    if not parts:
                        continue
                    offs = np.concatenate([o for _, o in parts])
                    if len(offs) and int(offs.max()) >= SHARD_WIDTH:
                        raise ValueError("state offsets must be in-shard")
                    row_ids = np.concatenate(
                        [np.full(len(o), r, np.uint64) for r, o in parts])
                    frag.import_bits(row_ids, offs)
    return holder
