"""proto3 wire compatibility for the reference client's public protobuf
surface: ``QueryRequest`` and ``QueryResponse`` on the query route,
``ImportRequest`` and ``ImportValueRequest`` on the import route (field
numbers of the reference's ``internal/public.proto``). A copy of the
JAX package's ``server/proto_compat.py`` for those four messages, with
their keys (``RowKeys``/``ColumnKeys`` in, keys in ``Row``, ``Pair``,
``RowIdentifiers`` and ``FieldRow`` out) and ``ColumnAttrSets``, and for
the ``ImportRoaringRequest`` of the roaring-import route; its
node-to-node translation messages belong to the cluster, not ported
yet.

The QueryResult.Type enum: 0=nil, 1=Row, 2=Pairs, 3=ValCount, 4=uint64,
5=bool, 6=RowIDs, 7=GroupCounts, 8=RowIdentifiers. Decoders accept
packed and unpacked repeated scalars; encoders write packed. Varints
decode in a Python loop, one byte a step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

CONTENT_TYPE = "application/x-protobuf"
# The reference answers with this exact value (http/handler.go:1178).
RESPONSE_CONTENT_TYPE = "application/protobuf"

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


class ProtoError(ValueError):
    pass


def _utf8(v: bytes) -> str:
    try:
        return v.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtoError(f"invalid utf-8 in string field: {e}") from e


# ----------------------------------------------------------- primitives

def _uvarint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if i >= len(buf):
            raise ProtoError("truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ProtoError("varint too long")


def _evarint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed(v: int) -> int:
    """proto3 int64: two's-complement varint."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> List[Tuple[int, int, Any]]:
    """Walk a message into (field_number, wire_type, raw_value) tuples."""
    out = []
    i = 0
    while i < len(buf):
        tag, i = _uvarint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == _WIRE_VARINT:
            v, i = _uvarint(buf, i)
        elif wt == _WIRE_LEN:
            n, i = _uvarint(buf, i)
            if i + n > len(buf):
                raise ProtoError("truncated length-delimited field")
            v = buf[i:i + n]
            i += n
        elif wt == _WIRE_I64:
            if i + 8 > len(buf):
                raise ProtoError("truncated fixed64 field")
            v = buf[i:i + 8]
            i += 8
        elif wt == _WIRE_I32:
            if i + 4 > len(buf):
                raise ProtoError("truncated fixed32 field")
            v = buf[i:i + 4]
            i += 4
        else:
            raise ProtoError(f"unsupported wire type {wt}")
        out.append((fnum, wt, v))
    return out


def _repeated_uint64(items, fnum) -> List[int]:
    """Packed or unpacked repeated uint64."""
    out: List[int] = []
    for f, wt, v in items:
        if f != fnum:
            continue
        if wt == _WIRE_VARINT:
            out.append(v)
        elif wt == _WIRE_LEN:
            i = 0
            while i < len(v):
                x, i = _uvarint(v, i)
                out.append(x)
    return out


def _tag(fnum: int, wt: int) -> bytes:
    return _evarint((fnum << 3) | wt)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, _WIRE_LEN) + _evarint(len(payload)) + payload


def _str_field(fnum: int, s: str) -> bytes:
    return _len_field(fnum, s.encode("utf-8"))


def _varint_field(fnum: int, v: int) -> bytes:
    return _tag(fnum, _WIRE_VARINT) + _evarint(v)


def _packed_uint64(fnum: int, values) -> bytes:
    if not len(values):
        return b""
    body = b"".join(_evarint(int(v)) for v in values)
    return _len_field(fnum, body)


# ------------------------------------------------------- request decode

def decode_query_request(data: bytes) -> Dict[str, Any]:
    """internal.QueryRequest (public.proto): Query=1, Shards=2,
    ColumnAttrs=3, Remote=5, ExcludeRowAttrs=6, ExcludeColumns=7."""
    items = _fields(data)
    out: Dict[str, Any] = {"query": "", "shards": [], "columnAttrs": False,
                           "remote": False, "excludeRowAttrs": False,
                           "excludeColumns": False}
    for f, wt, v in items:
        if f == 1 and wt == _WIRE_LEN:
            out["query"] = _utf8(v)
        elif f == 3 and wt == _WIRE_VARINT:
            out["columnAttrs"] = bool(v)
        elif f == 5 and wt == _WIRE_VARINT:
            out["remote"] = bool(v)
        elif f == 6 and wt == _WIRE_VARINT:
            out["excludeRowAttrs"] = bool(v)
        elif f == 7 and wt == _WIRE_VARINT:
            out["excludeColumns"] = bool(v)
    out["shards"] = _repeated_uint64(items, 2)
    return out


def decode_import_request(data: bytes) -> Dict[str, Any]:
    """internal.ImportRequest: Index=1, Field=2, Shard=3, RowIDs=4,
    ColumnIDs=5, Timestamps=6 (unix nanos, api.go:901), RowKeys=7,
    ColumnKeys=8."""
    items = _fields(data)
    out: Dict[str, Any] = {"index": "", "field": "", "shard": 0,
                           "rowIDs": [], "columnIDs": [], "rowKeys": [],
                           "columnKeys": [], "timestamps": []}
    for f, wt, v in items:
        if f == 1 and wt == _WIRE_LEN:
            out["index"] = _utf8(v)
        elif f == 2 and wt == _WIRE_LEN:
            out["field"] = _utf8(v)
        elif f == 3 and wt == _WIRE_VARINT:
            out["shard"] = v
        elif f == 7 and wt == _WIRE_LEN:
            out["rowKeys"].append(_utf8(v))
        elif f == 8 and wt == _WIRE_LEN:
            out["columnKeys"].append(_utf8(v))
    out["rowIDs"] = _repeated_uint64(items, 4)
    out["columnIDs"] = _repeated_uint64(items, 5)
    out["timestamps"] = [_signed(t) for t in _repeated_uint64(items, 6)]
    return out


def decode_import_value_request(data: bytes) -> Dict[str, Any]:
    """internal.ImportValueRequest: Index=1, Field=2, Shard=3,
    ColumnIDs=5, Values=6 (int64), ColumnKeys=7."""
    items = _fields(data)
    out: Dict[str, Any] = {"index": "", "field": "", "shard": 0,
                           "columnIDs": [], "columnKeys": [], "values": []}
    for f, wt, v in items:
        if f == 1 and wt == _WIRE_LEN:
            out["index"] = _utf8(v)
        elif f == 2 and wt == _WIRE_LEN:
            out["field"] = _utf8(v)
        elif f == 3 and wt == _WIRE_VARINT:
            out["shard"] = v
        elif f == 7 and wt == _WIRE_LEN:
            out["columnKeys"].append(_utf8(v))
    out["columnIDs"] = _repeated_uint64(items, 5)
    out["values"] = [_signed(t) for t in _repeated_uint64(items, 6)]
    return out


# ------------------------------------------------------ response encode

def decode_import_roaring_request(data: bytes) -> Dict[str, Any]:
    """internal.ImportRoaringRequest: Clear=1, views=2
    (ImportRoaringRequestView: Name=1, Data=2)."""
    out: Dict[str, Any] = {"clear": False, "views": []}
    for f, wt, v in _fields(data):
        if f == 1 and wt == _WIRE_VARINT:
            out["clear"] = bool(v)
        elif f == 2 and wt == _WIRE_LEN:
            name, blob = "", b""
            for f2, wt2, v2 in _fields(v):
                if f2 == 1 and wt2 == _WIRE_LEN:
                    name = _utf8(v2)
                elif f2 == 2 and wt2 == _WIRE_LEN:
                    blob = bytes(v2)
            out["views"].append((name, blob))
    return out


def _encode_attr(key: str, value) -> bytes:
    """internal.Attr: Key=1, Type=2 (1 str/2 int/3 bool/4 float —
    attr.go:27-30), value fields 3-6."""
    body = _str_field(1, key)
    if isinstance(value, bool):
        body += _varint_field(2, 3) + _varint_field(5, int(value))
    elif isinstance(value, int):
        body += _varint_field(2, 2) + _varint_field(4, value)
    elif isinstance(value, float):
        import struct as _s
        body += _varint_field(2, 4) + _tag(6, _WIRE_I64) + \
            _s.pack("<d", value)
    else:
        body += _varint_field(2, 1) + _str_field(3, str(value))
    return body


def _encode_row(columns, keys, attrs) -> bytes:
    body = _packed_uint64(1, columns)
    for k, v in (attrs or {}).items():
        body += _len_field(2, _encode_attr(k, v))
    for k in (keys or []):
        body += _str_field(3, k)
    return body


def _encode_result(result) -> bytes:
    """One internal.QueryResult from a JSON-shaped executor result (the
    form API.Query returns for both the single-node and cluster paths):
    {"columns": ...} = Row, [{"id"/"key","count"}] = Pairs,
    {"value","count"} = ValCount, int = Count, bool = Set/Clear,
    {"rows"}/{"keys"} = RowIdentifiers, [{"group",...}] = GroupCounts."""
    if result is None:
        return _varint_field(6, 0)
    if isinstance(result, bool):
        return _varint_field(6, 5) + _varint_field(4, int(result))
    if isinstance(result, int):
        return _varint_field(6, 4) + _varint_field(2, result)
    if isinstance(result, dict):
        if "columns" in result:
            row = _encode_row(result["columns"], result.get("keys"),
                              result.get("attrs"))
            return _varint_field(6, 1) + _len_field(1, row)
        if "value" in result:
            vc = _varint_field(1, int(result["value"])) + \
                _varint_field(2, int(result.get("count", 0)))
            return _varint_field(6, 3) + _len_field(5, vc)
        if "rows" in result or "keys" in result:
            body = _packed_uint64(1, result.get("rows") or [])
            for k in (result.get("keys") or []):
                body += _str_field(2, k)
            return _varint_field(6, 8) + _len_field(9, body)
        raise ProtoError(f"unmappable result shape {sorted(result)}")
    if isinstance(result, list):
        if result and isinstance(result[0], dict) and "group" in result[0]:
            out = _varint_field(6, 7)
            for gc in result:
                g = b""
                for fr in gc["group"]:
                    frb = _str_field(1, fr["field"])
                    if "rowKey" in fr:
                        frb += _str_field(3, fr["rowKey"])
                    else:
                        frb += _varint_field(2, int(fr.get("rowID", 0)))
                    g += _len_field(1, frb)
                g += _varint_field(2, int(gc["count"]))
                out += _len_field(8, g)
            return out
        # Pairs (TopN); an EMPTY list also encodes as empty Pairs — the
        # JSON shape cannot distinguish an empty GroupBy, matching what
        # a reference client sees for empty TopN.
        body = _varint_field(6, 2)
        for p in result:
            pair = b""
            if "id" in p:
                pair += _varint_field(1, int(p["id"]))
            pair += _varint_field(2, int(p["count"]))
            if "key" in p:
                pair += _str_field(3, p["key"])
            body += _len_field(3, pair)
        return body
    raise ProtoError(f"unmappable result type {type(result).__name__}")


def encode_query_response(results: Optional[List[Any]] = None,
                          err: Optional[str] = None,
                          column_attr_sets=None) -> bytes:
    """internal.QueryResponse: Err=1, Results=2, ColumnAttrSets=3."""
    body = b""
    if err:
        body += _str_field(1, err)
    for r in (results or []):
        body += _len_field(2, _encode_result(r))
    for cas in (column_attr_sets or []):
        c = _varint_field(1, int(cas.get("id", 0)))
        for k, v in (cas.get("attrs") or {}).items():
            c += _len_field(2, _encode_attr(k, v))
        if cas.get("key") is not None:
            c += _str_field(3, cas["key"])
        body += _len_field(3, c)
    return body
