"""Binary wire codec of node-to-node traffic, a copy of the JAX
package's ``server/wire.py``: for the same value both packages write the
same bytes, so a cluster may mix nodes of either package.

A schemaless codec over the JSON-shaped values the HTTP layer speaks:
self-describing type tags, with homogeneous integer lists (Row columns,
import row and column ids) packed as raw little-endian arrays. Requests
and responses carry ``Content-Type: application/x-pilosa-wire``; JSON
stays the public surface and the fallback.

Wire grammar (all little-endian):
    message  = magic "PW1\\0" value
    value    = tag:u8 payload
    tags     : 0 null | 1 false | 2 true | 3 int(i64) | 4 float(f64)
             | 5 str(u32 len + utf8) | 6 bytes(u32 len + raw)
             | 7 list(u32 n + n values) | 8 dict(u32 n + n (str, value))
             | 9 i64-array(u32 n + raw) | 10 u64-array(u32 n + raw)
             | 11 uint(u64)
Arrays decode to plain Python lists, so a decoded result is the JSON
path's (the cluster merge, ``parallel/cluster_executor.py``, reads
either). The encoder takes Python and numpy values only: a torch tensor
raises ``TypeError``, so results are converted before they are sent."""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

MAGIC = b"PW1\x00"
CONTENT_TYPE = "application/x-pilosa-wire"

_T_NULL = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_BYTES = 6
_T_LIST = 7
_T_DICT = 8
_T_I64S = 9
_T_U64S = 10
_T_UINT = 11

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_U64_MAX = (1 << 64) - 1


def _encode_value(v: Any, out: List[bytes]) -> None:
    if v is None:
        out.append(b"\x00")
    elif v is True:
        out.append(b"\x02")
    elif v is False:
        out.append(b"\x01")
    elif isinstance(v, int):
        if v > _U64_MAX or v < _I64_MIN:
            # JSON handles arbitrary precision; wire deliberately does not.
            # Encoders fall back to JSON on this (see http.py/_req).
            raise TypeError(f"wire: int out of 64-bit range: {v}")
        if v > _I64_MAX:  # u64-range scalar (e.g. a raw 64-bit id)
            out.append(struct.pack("<BQ", _T_UINT, v))
        else:
            out.append(struct.pack("<Bq", _T_INT, v))
    elif isinstance(v, float):
        out.append(struct.pack("<Bd", _T_FLOAT, v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(raw)))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        out.append(struct.pack("<BI", _T_BYTES, len(raw)))
        out.append(raw)
    elif isinstance(v, np.ndarray):
        _encode_array(v, out)
    elif isinstance(v, (list, tuple)):
        if v and _encode_int_list(v, out):
            return
        out.append(struct.pack("<BI", _T_LIST, len(v)))
        for item in v:
            _encode_value(item, out)
    elif isinstance(v, dict):
        out.append(struct.pack("<BI", _T_DICT, len(v)))
        for k, item in v.items():
            raw = str(k).encode("utf-8")
            out.append(struct.pack("<I", len(raw)))
            out.append(raw)
            _encode_value(item, out)
    elif isinstance(v, (np.integer,)):
        _encode_value(int(v), out)
    elif isinstance(v, (np.floating,)):
        _encode_value(float(v), out)
    else:
        raise TypeError(f"wire: cannot encode {type(v).__name__}")


def _encode_array(arr: np.ndarray, out: List[bytes]) -> None:
    if arr.ndim != 1:
        raise TypeError("wire: only 1-D arrays")
    if arr.dtype == np.uint64:
        out.append(struct.pack("<BI", _T_U64S, arr.size))
        out.append(np.ascontiguousarray(arr, dtype="<u8").tobytes())
    elif np.issubdtype(arr.dtype, np.integer):
        out.append(struct.pack("<BI", _T_I64S, arr.size))
        out.append(np.ascontiguousarray(arr, dtype="<i8").tobytes())
    else:
        _encode_value(arr.tolist(), out)


def _encode_int_list(v, out: List[bytes]) -> bool:
    """Bulk-pack a homogeneous int list; False → caller uses the generic
    per-element path. Every element must be a true int (bools are ints in
    Python and floats would be truncated by the dtype cast, so both force
    the generic path — values must round-trip exactly, as on the JSON
    path this codec replaces)."""
    if not all(type(x) is int for x in v):
        return False
    try:
        arr = np.asarray(v, dtype=np.int64)
    except (ValueError, TypeError, OverflowError):
        try:
            arr = np.asarray(v, dtype=np.uint64)
        except (ValueError, TypeError, OverflowError):
            return False
    _encode_array(arr, out)
    return True


def dumps(v: Any) -> bytes:
    out: List[bytes] = [MAGIC]
    _encode_value(v, out)
    return b"".join(out)


class WireError(ValueError):
    pass


def _decode_value(buf: memoryview, pos: int):
    if pos >= len(buf):
        raise WireError("truncated message")
    tag = buf[pos]
    pos += 1
    if tag == _T_NULL:
        return None, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_INT:
        if pos + 8 > len(buf):
            raise WireError("truncated int")
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == _T_FLOAT:
        if pos + 8 > len(buf):
            raise WireError("truncated float")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag in (_T_STR, _T_BYTES):
        if pos + 4 > len(buf):
            raise WireError("truncated length")
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if pos + n > len(buf):
            raise WireError("truncated payload")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if tag == _T_STR else raw), pos + n
    if tag == _T_LIST:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _decode_value(buf, pos)
            items.append(item)
        return items, pos
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            (kn,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            key = bytes(buf[pos:pos + kn]).decode("utf-8")
            pos += kn
            d[key], pos = _decode_value(buf, pos)
        return d, pos
    if tag in (_T_I64S, _T_U64S):
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if pos + 8 * n > len(buf):
            raise WireError("truncated array")
        dt = "<i8" if tag == _T_I64S else "<u8"
        arr = np.frombuffer(buf, dtype=dt, count=n, offset=pos)
        return arr.tolist(), pos + 8 * n
    if tag == _T_UINT:
        if pos + 8 > len(buf):
            raise WireError("truncated int")
        return struct.unpack_from("<Q", buf, pos)[0], pos + 8
    raise WireError(f"unknown wire tag {tag}")


def loads(data: bytes) -> Any:
    if len(data) < len(MAGIC) or bytes(data[:4]) != MAGIC:
        raise WireError("bad wire magic")
    try:
        v, pos = _decode_value(memoryview(data), 4)
    except (struct.error, UnicodeDecodeError, IndexError) as e:
        # Every malformed-input failure mode surfaces as WireError so the
        # HTTP layer can answer 400 and the client can wrap ClientError.
        raise WireError(f"malformed wire message: {e}") from e
    if pos != len(data):
        raise WireError("trailing bytes after message")
    return v
