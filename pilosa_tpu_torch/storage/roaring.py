"""Roaring container store and its file format, the port's copy of the
JAX package's ``storage/roaring.py``.

A bitmap of 64-bit positions is a dict of containers keyed by
``position >> 16``. Each container holds the 2^16 low positions of its
key in one of two encodings:

- dense: ``uint64[1024]`` words, bit ``p`` in word ``p >> 6``;
- array: sorted unique ``uint16`` positions, for at most
  ``ARRAY_MAX_SIZE`` bits (a 48-bit fingerprint row costs 96 bytes
  instead of 8 KiB).

Mutations materialise a container dense (``_container``); reads handle
both encodings; ``optimize`` re-encodes sparse dense containers as
arrays. No public operation leaves an empty container in the dict, so
the keys alone say which containers hold bits.

File format (the JAX package's bytes, little-endian):

    u16 magic 12348, u16 storage version 0, u32 container count N
    N x 12   u64 key, u16 type (1 array, 2 bitmap, 3 run), u16 card - 1
    N x 4    u32 absolute offset of each payload
    payloads array: card x u16; bitmap: 1024 x u64;
             run: u16 count, then (u16 start, u16 last) a run
    op log   to EOF: u8 type, u64 value, u32 checksum, then the payload
             of a batch: OP_ADD / OP_REMOVE carry one position and an
             fnv1a32 over the 9 header bytes; OP_ADD_BATCH /
             OP_REMOVE_BATCH carry ``value`` u64 positions and an
             fnv1a32 over header and positions; OP_ADD_ROARING carries
             a ``value``-byte roaring file of the batch and a zlib crc32
             over header and payload.

A snapshot writes each container in the smallest of the three
encodings (run before array before bitmap), except a bitmap whose
containers are more than a quarter arrays: that one is written as the
JAX package's native library writes it, array below 4096 bits and bitmap
from there, never run. An import record's payload always takes that
array-or-bitmap encoding. ``write_bytes`` and ``read_bytes``, the bulk
import builder (``import_build``, behind ``import_batch``), the record
writers (``serialize_groups``, ``serialize_import``), ``build_masks``,
``dense_positions_of`` and ``scatter_rows`` run the C++ codec of
``csrc/roaring_codec.cpp`` (built with g++ on first use by
``ops/build.py``; a failed build raises). Each has a numpy twin with
``_plain`` in its name (``write_bytes_plain``, ``from_bytes_plain``,
``import_batch_plain``, ...): the plain version the C++ one is held
against, used by the tests and nowhere on the main path.

With ``op_writer`` set (an unbuffered file, ``core/fragment.py``),
every logged write appends its record before it returns: ``add`` and
``remove`` one OP_ADD / OP_REMOVE a changed bit, ``remove_batch`` one
OP_REMOVE_BATCH, ``import_batch`` one OP_ADD_ROARING holding the batch's
own bits. ``op_n``, ``op_n_small`` and ``oplog_bytes`` count the log
since the last snapshot, for the fragment's snapshot policy; without a
writer nothing is written, and an import's record is not built (nor
its bytes counted).
"""

from __future__ import annotations

import struct
import types
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pilosa_tpu_torch.utils.tracing import span

MAGIC_NUMBER = 12348
STORAGE_VERSION = 0
COOKIE = MAGIC_NUMBER | (STORAGE_VERSION << 16)
HEADER_BASE_SIZE = 8

CONTAINER_ARRAY = 1
CONTAINER_BITMAP = 2
CONTAINER_RUN = 3
RUN_COUNT_HEADER_SIZE = 2

OP_ADD = 0
OP_REMOVE = 1
OP_ADD_BATCH = 2
OP_REMOVE_BATCH = 3
OP_ADD_ROARING = 4

# Nesting bound of OP_ADD_ROARING records inside their own payloads: a
# crafted file must not recurse without bound. Both codecs refuse at it.
MAX_OP_NESTING = 4

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193

CONTAINER_BITS = 1 << 16
CONTAINER_WORDS = CONTAINER_BITS // 64  # 1024 uint64 words
# Cardinality at or below which a container may use the array encoding.
ARRAY_MAX_SIZE = 4096

# Dense-scatter gates of import_batch (the counterpart of the JAX
# package's native import build): the batch's row span must stay under
# DENSE_SPAN_CONTAINERS containers of mask, and it must carry at least
# DENSE_MIN_BITS bits per container of that span unless the span is at
# most DENSE_SMALL_SPAN containers. Rows of one scatter pass are bounded
# by DENSE_GROUP_ROWS (each costs one bool per column of a shard row).
DENSE_SPAN_CONTAINERS = 1 << 17
DENSE_MIN_BITS = 256
DENSE_SMALL_SPAN = 64
DENSE_GROUP_ROWS = 64


def dense_scatter(n_pairs: int, rmin: int, rmax: int,
                  swidth_exp: int) -> bool:
    """Whether a batch of ``n_pairs`` (row, column) pairs over rows
    rmin..rmax takes the dense-mask import: a row span of fewer than
    DENSE_SPAN_CONTAINERS containers, and at least DENSE_MIN_BITS pairs
    per container of it unless the span is at most DENSE_SMALL_SPAN
    containers."""
    kpr = 1 << (swidth_exp - 16)
    if swidth_exp < 16 or rmax - rmin >= DENSE_SPAN_CONTAINERS // kpr \
            or rmax >= 1 << (64 - swidth_exp):
        return False
    span = (rmax - rmin + 1) * kpr
    return span <= DENSE_SMALL_SPAN or n_pairs >= span * DENSE_MIN_BITS


if hasattr(np, "bitwise_count"):
    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        """Set bits per row of a uint64 [n, k] block, as int64[n]."""
        return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)
else:  # pragma: no cover - numpy < 2.0
    _POP_TABLE = np.array([bin(i).count("1") for i in range(256)],
                          dtype=np.int64)

    def _popcount_rows(words: np.ndarray) -> np.ndarray:
        b = np.ascontiguousarray(words).view(np.uint8)
        return _POP_TABLE[b].reshape(words.shape[:-1] + (-1,)).sum(axis=-1)


def _popcount_words(words: np.ndarray) -> int:
    return int(_popcount_rows(words.reshape(1, -1))[0])


def _new_container() -> np.ndarray:
    return np.zeros(CONTAINER_WORDS, dtype=np.uint64)


def _dense_to_array(dense: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(dense.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint16)


def _low_mask(low: np.ndarray) -> np.ndarray:
    """Dense uint64[1024] mask from in-container positions: a bool
    scatter and packbits for large groups, an in-place OR scatter for
    small ones."""
    if len(low) >= 256:
        bits = np.zeros(CONTAINER_BITS, dtype=bool)
        bits[low] = True
        return np.packbits(bits, bitorder="little").view(np.uint64).copy()
    dense = _new_container()
    if len(low):
        v = low.astype(np.uint32)
        np.bitwise_or.at(
            dense, v >> 6,
            np.left_shift(np.uint64(1), (v & 63).astype(np.uint64)))
    return dense


def _as_dense(c: np.ndarray) -> np.ndarray:
    return _low_mask(c) if c.dtype == np.uint16 else c


def _runs_to_dense(runs: np.ndarray) -> np.ndarray:
    """Dense container of (n, 2) uint16 inclusive [start, last] runs."""
    bits = np.zeros(CONTAINER_BITS, dtype=np.uint8)
    for start, last in runs.tolist():
        bits[start:last + 1] = 1
    return np.packbits(bits, bitorder="little").view(np.uint64).copy()


def _dense_to_runs(dense: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(dense.view(np.uint8), bitorder="little")
    diff = np.diff(np.concatenate(([0], bits, [0])).astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0] - 1
    return np.stack([starts, ends], axis=1).astype(np.uint16)


_U16 = np.dtype(np.uint16)


# -- the C++ codec ------------------------------------------------------------

def _lib():
    from pilosa_tpu_torch.ops import build
    return build.load_host()


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def fnv1a32(*chunks) -> int:
    """FNV-1a 32 over the chunks in turn (Go's hash/fnv New32a): the
    checksum of the single-bit and batch op records. C++ codec."""
    lib = _lib()
    h = _FNV_OFFSET
    for c in chunks:
        buf = np.frombuffer(c, dtype=np.uint8)
        if len(buf):
            h = lib.rc_fnv1a32(_ptr(buf), len(buf), h)
    return h


def fnv1a32_plain(*chunks) -> int:
    """The plain version of ``fnv1a32``: one byte at a time in Python."""
    h = _FNV_OFFSET
    for chunk in chunks:
        for byte in bytes(chunk):
            h = ((h ^ byte) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def _native_serialize(keys: np.ndarray, lows: np.ndarray,
                      arr_off: np.ndarray, arr_len: np.ndarray,
                      ptrs: np.ndarray) -> bytes:
    """The C++ writer over n containers with ascending ``keys``:
    container i is ``lows[arr_off[i]:arr_off[i] + arr_len[i]]`` where
    ``arr_len[i]``, else the dense block at address ``ptrs[i]``."""
    lib = _lib()
    n = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    lows = np.ascontiguousarray(lows, dtype=np.uint16)
    if not len(lows):
        lows = np.zeros(1, dtype=np.uint16)
    arr_off = np.ascontiguousarray(arr_off, dtype=np.uint64)
    arr_len = np.ascontiguousarray(arr_len, dtype=np.uint64)
    ptrs = np.ascontiguousarray(ptrs, dtype=np.uint64)
    size = lib.rc_serialize_size(_ptr(lows), _ptr(arr_off), _ptr(arr_len),
                                 _ptr(ptrs), n)
    out = np.empty(size, dtype=np.uint8)
    got = lib.rc_serialize(_ptr(keys), _ptr(lows), _ptr(arr_off),
                           _ptr(arr_len), _ptr(ptrs), n, _ptr(out))
    if got != size:
        raise ValueError("roaring serialize: an empty container was given")
    return out.tobytes()


def serialize_containers(keys: Sequence[int],
                         containers: Sequence[np.ndarray]) -> bytes:
    """File bytes of non-empty containers (dense or array) under
    ascending ``keys``, through the C++ writer."""
    n = len(keys)
    arr_len = np.zeros(n, dtype=np.uint64)
    arr_off = np.zeros(n, dtype=np.uint64)
    ptrs = np.zeros(n, dtype=np.uint64)
    is_arr = np.fromiter((c.dtype is _U16 for c in containers), dtype=bool,
                         count=n)
    ai = np.flatnonzero(is_arr).tolist()
    lows = np.empty(0, dtype=np.uint16)
    if ai:
        arrays = [containers[i] for i in ai]
        lens = np.fromiter(map(len, arrays), dtype=np.uint64,
                           count=len(arrays))
        lows = np.concatenate(arrays)
        arr_len[ai] = lens
        arr_off[ai] = np.cumsum(lens) - lens
    di = np.flatnonzero(~is_arr).tolist()
    if di:
        ptrs[di] = np.fromiter((_ptr(containers[i]) for i in di),
                               dtype=np.uint64, count=len(di))
    return _native_serialize(np.asarray(keys, dtype=np.uint64), lows,
                             arr_off, arr_len, ptrs)


def serialize_positions(positions: np.ndarray) -> bytes:
    """An import record's payload of sorted unique uint64 positions,
    through the C++ groups writer."""
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    gkeys = positions >> np.uint64(16)
    starts = np.flatnonzero(np.concatenate(
        ([True], gkeys[1:] != gkeys[:-1]))) if len(positions) \
        else np.empty(0, dtype=np.int64)
    bounds = np.append(starts, len(positions)).astype(np.uint64)
    return serialize_groups(gkeys[starts],
                            (positions & np.uint64(0xFFFF)).astype(np.uint16),
                            bounds)


def _native_load(data: bytes, tolerate_torn_tail: bool) -> dict:
    """Parse a whole file (snapshot and op log) with the C++ reader:
    the keys, each container's count, the positions of containers of
    at most ARRAY_MAX_SIZE bits (concatenated, key order), the other
    containers' words, and the op-log accounting."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    h = lib.rc_load(_ptr(buf), len(buf))
    if not h:
        raise MemoryError("roaring load: out of memory")
    try:
        err = lib.rc_error(h)
        if err:
            raise ValueError(err.decode())
        dropped = int(lib.rc_tail_dropped(h))
        if dropped and not tolerate_torn_tail:
            raise OpTruncatedError(f"op data truncated ({dropped} tail "
                                   "bytes)")
        n = int(lib.rc_container_count(h))
        keys = np.empty(n, dtype=np.uint64)
        counts = np.empty(n, dtype=np.uint64)
        if n:
            lib.rc_keys(h, _ptr(keys))
            lib.rc_counts(h, _ptr(counts))
        arr = counts <= ARRAY_MAX_SIZE
        lows = np.empty(max(1, int(counts[arr].sum())), dtype=np.uint16)
        dense = np.empty((int((~arr).sum()), CONTAINER_WORDS),
                         dtype=np.uint64)
        if n:
            lib.rc_export_split(h, ARRAY_MAX_SIZE, _ptr(lows),
                                _ptr(dense) if len(dense) else _ptr(lows))
        return {"keys": keys, "counts": counts, "lows": lows,
                "dense": dense, "op_n": int(lib.rc_op_n(h)),
                "op_n_small": int(lib.rc_op_n_small(h)),
                "ops_bytes": int(lib.rc_ops_bytes(h)),
                "snapshot_bytes": int(lib.rc_snapshot_bytes(h)),
                "tail_dropped": dropped}
    finally:
        lib.rc_free(h)


def dense_positions_of(containers: Sequence[np.ndarray],
                       bases: np.ndarray) -> np.ndarray:
    """Every set bit of the dense containers (C-contiguous uint64[1024]
    each) as ``bases[i]`` + its index, container by container, in one
    C++ sweep."""
    lib = _lib()
    if not len(containers):
        return np.empty(0, dtype=np.uint64)
    ptrs = np.fromiter(map(_ptr, containers), dtype=np.uint64,
                       count=len(containers))
    bases = np.ascontiguousarray(bases, dtype=np.uint64)
    n = int(lib.rc_popcount_ptrs(_ptr(ptrs), len(ptrs)))
    out = np.empty(max(n, 1), dtype=np.uint64)
    lib.rc_dense_positions_ptrs(_ptr(ptrs), len(ptrs), _ptr(bases), _ptr(out))
    return out[:n]


def _dense_positions(containers: List[np.ndarray]) -> List[np.ndarray]:
    """The sorted uint16 positions of each dense container, in one C++
    sweep (``dense_positions_of``)."""
    pos = dense_positions_of(containers, np.zeros(len(containers),
                                                  np.uint64)).astype(np.uint16)
    counts = [_popcount_words(c) for c in containers]
    return np.split(pos, np.cumsum(counts)[:-1])


def dense_positions_of_plain(containers: Sequence[np.ndarray],
                             bases: np.ndarray) -> np.ndarray:
    """The plain version of ``dense_positions_of``."""
    parts = [np.uint64(b) + _dense_to_array(c).astype(np.uint64)
             for c, b in zip(containers, np.asarray(bases, np.uint64))]
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)


def import_build(row_ids: np.ndarray, col_ids: np.ndarray, swidth_exp: int,
                 want_payload: bool = True):
    """The C++ bulk import builder: the (row, column) pairs at
    ``row << swidth_exp | (col mod 2^swidth_exp)`` scattered into dense
    masks over the batch's container range without a sort. Returns
    (keys uint64[m] ascending, words uint64[m, 1024], counts uint64[m],
    the import record's payload or None without ``want_payload``, bits)
    for the m non-empty containers; None when the batch is declined
    (the gates of ``dense_scatter``): the caller sorts and groups it."""
    lib = _lib()
    rows = np.ascontiguousarray(row_ids, dtype=np.uint64)
    cols = np.ascontiguousarray(col_ids, dtype=np.uint64)
    h = lib.rc_import_build(_ptr(rows), _ptr(cols), len(rows), swidth_exp,
                            int(want_payload))
    if not h:
        raise MemoryError("import build: out of memory")
    try:
        if lib.rc_ib_error(h):
            return None
        m = int(lib.rc_ib_count(h))
        keys = np.empty(m, dtype=np.uint64)
        counts = np.empty(m, dtype=np.uint64)
        words = np.empty((m, CONTAINER_WORDS), dtype=np.uint64)
        if m:
            lib.rc_ib_keys_counts(h, _ptr(keys), _ptr(counts))
            lib.rc_ib_words(h, _ptr(words))
        payload = None
        if want_payload:
            buf = np.empty(max(1, int(lib.rc_ib_payload_size(h))),
                           dtype=np.uint8)
            lib.rc_ib_payload(h, _ptr(buf))
            payload = buf[:int(lib.rc_ib_payload_size(h))].tobytes()
        return keys, words, counts, payload, int(lib.rc_ib_nbits(h))
    finally:
        lib.rc_ib_free(h)


def import_build_plain(row_ids: np.ndarray, col_ids: np.ndarray,
                       swidth_exp: int, want_payload: bool = True):
    """The plain version of ``import_build`` (numpy): rows scatter
    DENSE_GROUP_ROWS at a time into one bool mask, packed to words."""
    rows = np.ascontiguousarray(row_ids, dtype=np.uint64)
    cols = np.ascontiguousarray(col_ids, dtype=np.uint64)
    rmin, rmax = int(rows.min()), int(rows.max())
    if not dense_scatter(len(rows), rmin, rmax, swidth_exp):
        return None
    width = 1 << swidth_exp
    kpr = width // CONTAINER_BITS
    rel = (rows - np.uint64(rmin)).astype(np.int64)
    offs = (cols & np.uint64(width - 1)).astype(np.int64)
    n_rows = rmax - rmin + 1
    keys, words, counts = [], [], []
    for g0 in range(0, n_rows, DENSE_GROUP_ROWS):
        g_rows = min(DENSE_GROUP_ROWS, n_rows - g0)
        sel = (rel >= g0) & (rel < g0 + g_rows)
        bits = np.zeros(g_rows * width, dtype=bool)
        bits[(rel[sel] - g0) * width + offs[sel]] = True
        w = np.packbits(bits, bitorder="little").view(np.uint64).reshape(
            g_rows * kpr, CONTAINER_WORDS)
        c = _popcount_rows(w)
        nz = np.flatnonzero(c)
        keys.append(np.uint64((rmin + g0) * kpr) + nz.astype(np.uint64))
        words.append(w[nz])
        counts.append(c[nz].astype(np.uint64))
    keys = np.concatenate(keys)
    words = np.concatenate(words)
    counts = np.concatenate(counts)
    payload = serialize_import_plain(keys, words) if want_payload else None
    return keys, words, counts, payload, int(counts.sum())


def serialize_groups(keys: np.ndarray, lows: np.ndarray,
                     bounds: np.ndarray) -> bytes:
    """An import record's payload from sorted unique positions grouped
    by container (C++): ``keys`` ascending, ``lows`` every group's
    in-container positions back to back, ``bounds`` the m + 1 group
    offsets into ``lows``. Array below 4096 bits, bitmap from there."""
    lib = _lib()
    m = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    lows = np.ascontiguousarray(lows, dtype=np.uint16)
    if not len(lows):
        lows = np.zeros(1, dtype=np.uint16)
    bounds = np.ascontiguousarray(bounds, dtype=np.uint64)
    out = np.empty(int(lib.rc_serialize_groups_cap(m, len(lows))),
                   dtype=np.uint8)
    size = lib.rc_serialize_groups(_ptr(keys), _ptr(lows), _ptr(bounds), m,
                                   _ptr(out))
    if size == (1 << 64) - 1:
        raise MemoryError("serialize groups: out of memory")
    if size == 0 and m:
        raise ValueError("serialize groups: bad group bounds")
    return out[:size].tobytes()


def _import_payload_plain(items: Iterable[Tuple[int, np.ndarray, int]],
                          n: int) -> bytes:
    """The plain import-record writer over (key, container, count)
    triples: array below 4096 bits, bitmap from there."""
    header = bytearray(struct.pack("<II", COOKIE, n))
    payloads: List[bytes] = []
    for key, c, card in items:
        if card < ARRAY_MAX_SIZE:
            typ = CONTAINER_ARRAY
            arr = c if c.dtype == np.uint16 else _dense_to_array(c)
            payloads.append(arr.astype("<u2").tobytes())
        else:
            typ = CONTAINER_BITMAP
            payloads.append(_as_dense(c).astype("<u8").tobytes())
        header += struct.pack("<QHH", int(key), typ, card - 1)
    offset = HEADER_BASE_SIZE + n * 16
    for pl in payloads:
        header += struct.pack("<I", offset)
        offset += len(pl)
    return bytes(header) + b"".join(payloads)


def serialize_groups_plain(keys: np.ndarray, lows: np.ndarray,
                           bounds: np.ndarray) -> bytes:
    """The plain version of ``serialize_groups``."""
    b = np.asarray(bounds, dtype=np.int64)
    return _import_payload_plain(
        ((k, lows[b[i]:b[i + 1]], int(b[i + 1] - b[i]))
         for i, k in enumerate(np.asarray(keys).tolist())), len(keys))


def serialize_import(keys: np.ndarray, words: np.ndarray) -> bytes:
    """An import record's payload from the non-empty dense containers
    ``words[i]`` (a uint64 [m, 1024] block) under ascending ``keys``
    (C++): array below 4096 bits, bitmap from there."""
    lib = _lib()
    words = np.ascontiguousarray(words, dtype=np.uint64)
    m = len(keys)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    card = np.ascontiguousarray(_popcount_rows(words), dtype=np.uint64) \
        if m else np.zeros(1, np.uint64)
    ptrs = np.uint64(_ptr(words)) + np.arange(m, dtype=np.uint64) \
        * np.uint64(8 * CONTAINER_WORDS) if m else np.zeros(1, np.uint64)
    size = int(lib.rc_serialize_import_size(_ptr(card), m))
    out = np.empty(size, dtype=np.uint8)
    if lib.rc_serialize_import(_ptr(keys), _ptr(ptrs), _ptr(card), m,
                               _ptr(out)) != size:
        raise MemoryError("serialize import: out of memory")
    return out.tobytes()


def serialize_import_plain(keys: np.ndarray, words: np.ndarray) -> bytes:
    """The plain version of ``serialize_import``."""
    counts = _popcount_rows(words) if len(keys) else []
    return _import_payload_plain(
        ((k, w, int(c)) for k, w, c in zip(np.asarray(keys).tolist(), words,
                                           counts)), len(keys))


def sort_unique(a: np.ndarray) -> np.ndarray:
    """The distinct values of the integer array ``a``, ascending: ``a``
    sorted in place (unless it arrives sorted), then its repeats
    dropped. ``np.unique`` hashes integers from numpy 2.3 on: over a
    million positions it took 744 ms on an H100 machine's 8-core host
    (numpy 2.3.5), where the sort takes 11 ms."""
    if len(a) < 2:
        return a
    if not bool(np.all(a[1:] >= a[:-1])):
        a.sort()
    keep = np.empty(len(a), dtype=bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a if keep.all() else a[keep]


def build_masks(positions: np.ndarray, m: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """(keys uint64[m], words uint64[m, 1024]): the dense mask of each
    container of sorted ``positions`` with m distinct keys (C++)."""
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    keys = np.empty(m, dtype=np.uint64)
    words = np.zeros((m, CONTAINER_WORDS), dtype=np.uint64)
    got = _lib().rc_build_masks(_ptr(positions), len(positions), m,
                                _ptr(keys), _ptr(words))
    if got != m:
        raise ValueError(f"build masks: {got} groups, expected {m}")
    return keys, words


def build_masks_plain(positions: np.ndarray, m: int) -> Tuple[np.ndarray,
                                                               np.ndarray]:
    """The plain version of ``build_masks``."""
    positions = np.asarray(positions, dtype=np.uint64)
    gkeys = positions >> np.uint64(16)
    keys, idx = np.unique(gkeys, return_inverse=True)
    if len(keys) != m:
        raise ValueError(f"build masks: {len(keys)} groups, expected {m}")
    words = np.zeros((m, CONTAINER_WORDS), dtype=np.uint64)
    low = (positions & np.uint64(0xFFFF)).astype(np.int64)
    np.bitwise_or.at(words, (idx, low >> 6),
                     np.left_shift(np.uint64(1), (low & 63).astype(np.uint64)))
    return keys.astype(np.uint64), words


def scatter_rows(pos: np.ndarray, lens: np.ndarray, row_index: np.ndarray,
                 words64: int, out: np.ndarray) -> None:
    """OR rows of in-container uint16 positions (``lens[r]`` of row r,
    back to back) into row ``row_index[r]`` of ``out`` (C-contiguous
    uint64, ``words64`` a row); positions past the row's width are
    skipped (C++)."""
    assert out.flags.c_contiguous and out.dtype == np.uint64
    pos = np.ascontiguousarray(pos, dtype=np.uint16)
    lens = np.ascontiguousarray(lens, dtype=np.uint64)
    row_index = np.ascontiguousarray(row_index, dtype=np.uint64)
    if not len(lens):
        return
    _lib().rc_scatter_rows(_ptr(pos) if len(pos) else _ptr(out), _ptr(lens),
                           len(lens), _ptr(row_index), words64, _ptr(out))


def scatter_rows_plain(pos: np.ndarray, lens: np.ndarray,
                       row_index: np.ndarray, words64: int,
                       out: np.ndarray) -> None:
    """The plain version of ``scatter_rows``."""
    p = np.asarray(pos, dtype=np.int64)
    rows = np.repeat(np.asarray(row_index, dtype=np.int64),
                     np.asarray(lens, dtype=np.int64))
    keep = (p >> 6) < words64
    p, rows = p[keep], rows[keep]
    np.bitwise_or.at(out.reshape(-1), rows * words64 + (p >> 6),
                     np.left_shift(np.uint64(1), (p & 63).astype(np.uint64)))


# The import builder's two implementations: the C++ codec on the main
# path, numpy (the plain version) in the tests.
CODEC = types.SimpleNamespace(import_build=import_build,
                              serialize_groups=serialize_groups,
                              build_masks=build_masks)
PLAIN = types.SimpleNamespace(import_build=import_build_plain,
                              serialize_groups=serialize_groups_plain,
                              build_masks=build_masks_plain)


# -- op records ---------------------------------------------------------------

class OpTruncatedError(ValueError):
    """An op record runs past the end of the data: a torn append."""


def encode_op(typ: int, value: int = 0,
              values: Optional[np.ndarray] = None) -> bytes:
    """One OP_ADD / OP_REMOVE record (``value``) or one batch record
    (``values``)."""
    if typ in (OP_ADD, OP_REMOVE):
        head = struct.pack("<BQ", typ, int(value))
        return head + struct.pack("<I", fnv1a32(head))
    vals = np.asarray(values, dtype="<u8").tobytes()
    head = struct.pack("<BQ", typ, len(values))
    return head + struct.pack("<I", fnv1a32(head, vals)) + vals


def encode_op_roaring(payload: bytes) -> bytes:
    """One OP_ADD_ROARING record: crc32 over header and payload."""
    head = struct.pack("<BQ", OP_ADD_ROARING, len(payload))
    return head + struct.pack("<I", zlib.crc32(payload, zlib.crc32(head))) \
        + payload


def decode_op(buf) -> Tuple[int, int, Optional[object], int]:
    """(type, value, values, encoded size) of the record at the start of
    ``buf``; ``values`` is the batch's positions, or an OP_ADD_ROARING
    record's payload bytes. Part of the plain reader."""
    if len(buf) < 13:
        raise OpTruncatedError(f"op data out of bounds: len={len(buf)}")
    typ, value = struct.unpack_from("<BQ", buf, 0)
    (chk,) = struct.unpack_from("<I", buf, 9)
    if typ in (OP_ADD, OP_REMOVE):
        if chk != fnv1a32_plain(bytes(buf[0:9])):
            raise ValueError("op checksum mismatch")
        return typ, value, None, 13
    if typ in (OP_ADD_BATCH, OP_REMOVE_BATCH):
        size = 13 + 8 * value
        if len(buf) < size:
            raise OpTruncatedError("op data truncated")
        if chk != fnv1a32_plain(bytes(buf[0:9]), bytes(buf[13:size])):
            raise ValueError("op checksum mismatch")
        return typ, 0, np.frombuffer(buf, dtype="<u8", count=value,
                                     offset=13).copy(), size
    if typ == OP_ADD_ROARING:
        size = 13 + value
        if len(buf) < size:
            raise OpTruncatedError("op data truncated")
        payload = bytes(buf[13:size])
        if chk != zlib.crc32(payload, zlib.crc32(bytes(buf[0:9]))):
            raise ValueError("op checksum mismatch")
        return typ, 0, payload, size
    raise ValueError(f"invalid op type {typ}")


def _write_all(w, data: bytes) -> None:
    """Write the whole record or raise: a raw write may be short, and an
    acknowledged op must never be a truncated record."""
    view = memoryview(data)
    while view:
        n = w.write(view)
        if not n:
            raise OSError("op-log write made no progress "
                          f"({len(view)} bytes unwritten)")
        view = view[n:]


def _serialize_container_seq(items: Iterable[Tuple[int, np.ndarray, int]],
                             n: int) -> bytes:
    """The plain writer: (key, container, count) triples, sorted and
    non-empty, one dense temporary at a time."""
    header = bytearray(struct.pack("<II", COOKIE, n))
    payloads: List[bytes] = []
    for key, c, card in items:
        dense = _as_dense(c)
        runs = _dense_to_runs(dense)
        run_size = RUN_COUNT_HEADER_SIZE + 4 * len(runs)
        array_size = 2 * card
        if run_size < min(array_size, 8192):
            typ = CONTAINER_RUN
            payloads.append(struct.pack("<H", len(runs))
                            + runs.astype("<u2").tobytes())
        elif array_size < 8192:
            typ = CONTAINER_ARRAY
            payloads.append(_dense_to_array(dense).astype("<u2").tobytes())
        else:
            typ = CONTAINER_BITMAP
            payloads.append(dense.astype("<u8").tobytes())
        header += struct.pack("<QHH", int(key), typ, card - 1)
    offset = HEADER_BASE_SIZE + n * 16
    for p in payloads:
        header += struct.pack("<I", offset)
        offset += len(p)
    return bytes(header) + b"".join(payloads)


class Bitmap:
    """A 64-bit-keyed roaring bitmap over dense and array containers."""

    __slots__ = ("containers", "_counts", "op_writer", "op_n", "op_n_small",
                 "oplog_bytes", "snapshot_bytes", "tail_dropped")

    def __init__(self) -> None:
        self.containers: Dict[int, np.ndarray] = {}
        # key -> popcount of a dense container.
        self._counts: Dict[int, int] = {}
        self.op_writer = None
        self.op_n = 0          # bits logged since the last snapshot
        self.op_n_small = 0    # single-bit records among them
        self.oplog_bytes = 0   # bytes of op records since the snapshot
        self.snapshot_bytes = 0  # size of the snapshot section read
        self.tail_dropped = 0  # torn-tail bytes the last read dropped

    # -- container plumbing -------------------------------------------------

    def _container(self, key: int, create: bool = False
                   ) -> Optional[np.ndarray]:
        """Mutable dense container: an array-encoded one materialises in
        place."""
        c = self.containers.get(key)
        if c is None:
            if not create:
                return None
            c = _new_container()
            self.containers[key] = c
        elif c.dtype == np.uint16:
            c = _low_mask(c)
            self.containers[key] = c
        return c

    def _invalidate(self, key: int) -> None:
        self._counts.pop(key, None)

    def container_count(self, key: int) -> int:
        """Bits in one container: an array's length, or a dense
        container's popcount (cached until the next mutation)."""
        c = self.containers.get(key)
        if c is None:
            return 0
        if c.dtype == np.uint16:
            return len(c)
        n = self._counts.get(key)
        if n is None:
            n = self._counts[key] = _popcount_words(c)
        return n

    def optimize(self) -> int:
        """Re-encode dense containers of at most ARRAY_MAX_SIZE bits as
        arrays and drop empty ones; returns the number converted."""
        cand: List[int] = []
        for key, c in list(self.containers.items()):
            if c.dtype == np.uint16:
                continue
            n = self.container_count(key)
            if n == 0:
                del self.containers[key]
                self._invalidate(key)
            elif n <= ARRAY_MAX_SIZE:
                cand.append(key)
        if cand:
            arrays = _dense_positions([self.containers[k] for k in cand])
            for key, arr in zip(cand, arrays):
                self.containers[key] = arr
                self._invalidate(key)
        return len(cand)

    def _drop_empty(self, key: int) -> None:
        if key in self.containers and self.container_count(key) == 0:
            del self.containers[key]
            self._invalidate(key)

    # -- point ops ----------------------------------------------------------

    def add(self, *positions: int) -> bool:
        """Set each position, logging one OP_ADD a changed bit; True
        when any bit changed."""
        changed = False
        for p in positions:
            p = int(p)
            if self._direct_add(p):
                changed = True
                self._write_op(OP_ADD, value=p)
        return changed

    def _direct_add(self, p: int) -> bool:
        key, low = p >> 16, p & 0xFFFF
        c = self._container(key, create=True)
        w, b = low >> 6, np.uint64(1 << (low & 63))
        if c[w] & b:
            return False
        c[w] |= b
        self._invalidate(key)
        return True

    def remove(self, *positions: int) -> bool:
        """Clear each position, logging one OP_REMOVE a changed bit; True
        when any bit changed. A no-op remove never materialises an array
        container."""
        changed = False
        for p in positions:
            p = int(p)
            if self._direct_remove(p):
                changed = True
                self._write_op(OP_REMOVE, value=p)
        return changed

    def _direct_remove(self, p: int) -> bool:
        if not self.contains(p):
            return False
        key, low = p >> 16, p & 0xFFFF
        c = self._container(key)
        c[low >> 6] &= ~np.uint64(1 << (low & 63))
        self._invalidate(key)
        self._drop_empty(key)
        return True

    def contains(self, p: int) -> bool:
        p = int(p)
        c = self.containers.get(p >> 16)
        if c is None:
            return False
        low = p & 0xFFFF
        if c.dtype == np.uint16:
            i = int(np.searchsorted(c, low))
            return i < len(c) and int(c[i]) == low
        return bool(c[low >> 6] & np.uint64(1 << (low & 63)))

    # -- batch ops ----------------------------------------------------------

    @staticmethod
    def _groups(positions: np.ndarray):
        """(keys, group bounds) of sorted positions grouped by key."""
        keys = (positions >> np.uint64(16)).astype(np.int64)
        uniq, starts = np.unique(keys, return_index=True)
        return uniq, np.append(starts, len(positions))

    def direct_add_n(self, positions: np.ndarray,
                     presorted: bool = False) -> int:
        """Bulk add; returns the number of bits that changed.
        ``presorted=True`` asserts sorted unique positions."""
        if len(positions) == 0:
            return 0
        if presorted:
            positions = np.ascontiguousarray(positions, dtype=np.uint64)
        else:
            positions = np.unique(np.asarray(positions, dtype=np.uint64))
        changed = 0
        uniq, bounds = self._groups(positions)
        # A dense enough batch builds every group's mask in one C++ pass
        # (the JAX package's gate); new containers take theirs.
        masks = None
        if len(positions) >= 4096 and len(uniq) <= 65536 and \
                len(positions) >= 64 * len(uniq):
            masks = build_masks(positions, len(uniq))[1]
        for i, key in enumerate(uniq.tolist()):
            group = positions[bounds[i]:bounds[i + 1]]
            low = (group & np.uint64(0xFFFF)).astype(np.uint32)
            if key not in self.containers:
                self.containers[key] = masks[i].copy() \
                    if masks is not None else _low_mask(low)
                self._counts[key] = len(group)
                changed += len(group)
                continue
            c = self._container(key)
            before = self.container_count(key)
            if len(group) >= 256:
                c |= _low_mask(low)
            else:
                np.bitwise_or.at(
                    c, low >> 6,
                    np.left_shift(np.uint64(1),
                                  (low & 63).astype(np.uint64)))
            self._invalidate(key)
            changed += self.container_count(key) - before
        return changed

    def direct_remove_n(self, positions: np.ndarray) -> int:
        """Bulk remove; returns the number of bits that changed."""
        if len(positions) == 0:
            return 0
        positions = np.unique(np.asarray(positions, dtype=np.uint64))
        changed = 0
        uniq, bounds = self._groups(positions)
        for i, key in enumerate(uniq.tolist()):
            if key not in self.containers:
                continue
            c = self._container(key)
            group = positions[bounds[i]:bounds[i + 1]]
            mask = _low_mask((group & np.uint64(0xFFFF)).astype(np.uint32))
            before = self.container_count(key)
            c &= ~mask
            self._invalidate(key)
            changed += before - self.container_count(key)
            self._drop_empty(key)
        return changed

    def import_batch(self, row_ids: np.ndarray, col_ids: np.ndarray,
                     swidth_exp: int) -> np.ndarray:
        """Add every (row, column) pair at position ``row << swidth_exp |
        (col mod 2^swidth_exp)``; returns the sorted touched container
        keys. Duplicates are harmless. One OP_ADD_ROARING record holds
        the batch's bits.

        Two branches, as in the JAX package with its native library: a
        batch over a narrow, dense row span goes through the C++ import
        builder (``import_build``: dense masks without a sort, its
        containers kept dense with their counts cached); any other
        batch sorts and groups its positions into sorted-u16 array
        containers (dense above ARRAY_MAX_SIZE), its record written by
        ``serialize_groups``. Positions that arrive sorted (a bulk load
        in row order) skip the sort."""
        return self.import_pairs(row_ids, col_ids, swidth_exp)[0]

    def import_pairs(self, row_ids: np.ndarray, col_ids: np.ndarray,
                     swidth_exp: int
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``import_batch``, with each key's bits in the batch where it
        was sorted and grouped (``_adopt``), else (the dense builder)
        None."""
        with span("Bitmap.importBatch", pairs=len(row_ids)):
            return self._import(row_ids, col_ids, swidth_exp, CODEC)

    def import_batch_plain(self, row_ids: np.ndarray, col_ids: np.ndarray,
                           swidth_exp: int) -> np.ndarray:
        """The plain version of ``import_batch`` (numpy builder and
        writer): the same containers, counts and record bytes."""
        return self._import(row_ids, col_ids, swidth_exp, PLAIN)[0]

    def _import(self, row_ids: np.ndarray, col_ids: np.ndarray,
                swidth_exp: int, impl
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
        col_ids = np.ascontiguousarray(col_ids, dtype=np.uint64)
        if len(row_ids) == 0:
            return np.empty(0, dtype=np.uint64), None
        built = impl.import_build(row_ids, col_ids, swidth_exp,
                                  self.op_writer is not None)
        if built is not None:
            keys, masks, counts, payload, n_bits = built
            self._log_roaring(n_bits, lambda: payload)
            self._merge_built(keys, masks, counts)
            return keys, None
        positions = sort_unique((row_ids << np.uint64(swidth_exp))
                                + (col_ids & np.uint64((1 << swidth_exp)
                                                       - 1)))
        gkeys = positions >> np.uint64(16)
        starts = np.concatenate(
            ([0], np.flatnonzero(gkeys[1:] != gkeys[:-1]) + 1))
        bounds = np.append(starts, len(positions))
        keys = gkeys[starts]
        lows = (positions & np.uint64(0xFFFF)).astype(np.uint16)
        self._log_roaring(len(positions), lambda: impl.serialize_groups(
            keys, lows, bounds))
        return keys, self._adopt(keys, positions, lows, bounds, impl)

    def _adopt(self, keys: np.ndarray, positions: np.ndarray,
               lows: np.ndarray, bounds: np.ndarray, impl) -> np.ndarray:
        """Merge the groups of sorted unique ``positions`` (under
        ``keys``, ``bounds`` into ``lows``). A group whose key is new to
        the store is taken as it is: of at most ARRAY_MAX_SIZE bits, a
        slice of ``lows``; of more, a dense mask from one ``build_masks``
        over just those groups, its count cached. An array's count is
        its length, so none is cached (at 100M rows that cache alone
        would cost gigabytes). A group whose key the store holds (a
        re-import, or a row split across two chunks) is ORed in. Returns
        each key's bits in the batch, -1 where the group was ORed."""
        counts = np.diff(bounds)
        key_list = keys.tolist()
        containers = self.containers
        present = np.fromiter(map(containers.__contains__, key_list),
                              dtype=bool, count=len(key_list))
        big = (counts > ARRAY_MAX_SIZE) & ~present
        small = (counts <= ARRAY_MAX_SIZE) & ~present
        if big.any():
            bkeys, masks = impl.build_masks(
                positions[np.repeat(big, counts)], int(np.count_nonzero(big)))
            bk = bkeys.tolist()
            containers.update(zip(bk, masks))
            self._counts.update(zip(bk, counts[big].tolist()))
        containers.update(zip(keys[small].tolist(), [
            lows[a:b] for a, b in zip(bounds[:-1][small].tolist(),
                                      bounds[1:][small].tolist())]))
        for i in np.flatnonzero(present).tolist():
            k = key_list[i]
            c = self._container(k)
            c |= _low_mask(lows[bounds[i]:bounds[i + 1]].astype(np.uint32))
            self._invalidate(k)
        return np.where(present, -1, counts)

    def _merge_built(self, keys: np.ndarray, masks: np.ndarray,
                     counts: np.ndarray) -> None:
        """OR the builder's non-empty masks into the store. A new key
        takes its row of ``masks`` (a view of the block when most keys
        are new, so a few survivors do not pin the whole block; else a
        copy) with its count cached; an existing one is ORed."""
        key_list = keys.tolist()
        containers = self.containers
        n_new = sum(1 for k in key_list if k not in containers)
        adopt = n_new * 2 >= len(key_list)
        for i, (key, n) in enumerate(zip(key_list, counts.tolist())):
            if key not in containers:
                containers[key] = masks[i] if adopt else masks[i].copy()
                self._counts[key] = n
            else:
                c = self._container(key)
                c |= masks[i]
                self._invalidate(key)

    def merge_masks(self, first_key: int, words: np.ndarray,
                    counts: Optional[np.ndarray] = None) -> np.ndarray:
        """OR a block of dense container masks, uint64 [n, 1024] for keys
        first_key .. first_key + n - 1, into the store; every container
        that gets a bit is kept dense. Returns the keys that got bits.
        Logs nothing (the callers log the batch's record)."""
        if counts is None:
            counts = _popcount_rows(words)
        nz = np.flatnonzero(counts)
        for i, n in zip(nz.tolist(), counts[nz].tolist()):
            key = first_key + i
            if key not in self.containers:
                self.containers[key] = words[i].copy()
                self._counts[key] = n
            else:
                c = self._container(key)
                c |= words[i]
                self._invalidate(key)
        return nz.astype(np.uint64) + np.uint64(first_key)

    def union_in_place(self, *others: "Bitmap") -> None:
        """OR every container of ``others`` into this store (unlogged)."""
        for other in others:
            for key, b in other.containers.items():
                if key not in self.containers:
                    self.containers[key] = b.copy()
                else:
                    a = self._container(key)
                    a |= _as_dense(b)
                self._invalidate(key)

    def difference_in_place(self, other: "Bitmap") -> None:
        """Clear every bit of ``other`` here (unlogged)."""
        for key, b in other.containers.items():
            if key in self.containers:
                c = self._container(key)
                c &= ~_as_dense(b)
                self._invalidate(key)
                self._drop_empty(key)

    # -- op log -------------------------------------------------------------

    def _write_op(self, typ: int, value: int = 0,
                  values: Optional[np.ndarray] = None) -> None:
        """Count one single-bit or batch record and append it when a
        writer is set (the record length is closed-form, so nothing is
        encoded without one)."""
        self.op_n += 1 if values is None else len(values)
        if values is None:
            self.op_n_small += 1
        self.oplog_bytes += 13 if values is None else 13 + 8 * len(values)
        if self.op_writer is not None:
            _write_all(self.op_writer, encode_op(typ, value, values))

    def _log_roaring(self, n_bits: int, payload) -> None:
        """Count one OP_ADD_ROARING record of ``n_bits`` bits and, when a
        writer is set, build its payload (``payload()``) and append it."""
        self.op_n += n_bits
        if self.op_writer is None:
            return
        rec = encode_op_roaring(payload())
        self.oplog_bytes += len(rec)
        _write_all(self.op_writer, rec)

    def remove_batch(self, positions: np.ndarray) -> int:
        """Clear ``positions``, logging one OP_REMOVE_BATCH record of
        them all; returns the number of bits that changed."""
        positions = np.asarray(positions, dtype=np.uint64)
        n = self.direct_remove_n(positions)
        if len(positions):
            self._write_op(OP_REMOVE_BATCH, values=positions)
        return n

    # -- serialization ------------------------------------------------------

    def _sorted_items(self) -> Tuple[List[int], List[np.ndarray]]:
        keys = sorted(k for k in self.containers if self.container_count(k))
        return keys, [self.containers[k] for k in keys]

    def _groups_heavy(self, cs: List[np.ndarray]) -> bool:
        """Whether more than a quarter of the containers are arrays: the
        JAX package's native writer then writes the snapshot through its
        groups writer (array below 4096 bits, bitmap from there, never
        run)."""
        return sum(1 for c in cs if c.dtype is _U16) * 4 > len(cs)

    def write_bytes(self) -> bytes:
        """The file bytes of the store (a snapshot, no op log), through
        the C++ writer: the smallest encoding a container, or the groups
        writer's when more than a quarter of them are arrays."""
        keys, cs = self._sorted_items()
        if self._groups_heavy(cs):
            lows, bounds = self._groups_of(keys, cs, _dense_positions)
            return serialize_groups(np.asarray(keys, np.uint64), lows, bounds)
        return serialize_containers(keys, cs)

    def write_bytes_plain(self) -> bytes:
        """The plain version of ``write_bytes`` (numpy): the same bytes."""
        keys, cs = self._sorted_items()
        if self._groups_heavy(cs):
            return _import_payload_plain(
                ((k, c, self.container_count(k)) for k, c in zip(keys, cs)),
                len(keys))
        return _serialize_container_seq(
            ((k, c, self.container_count(k)) for k, c in zip(keys, cs)),
            len(keys))

    @staticmethod
    def _groups_of(keys: List[int], cs: List[np.ndarray], positions_of):
        """(lows, bounds) of the groups writer: arrays verbatim, dense
        containers' positions from ``positions_of`` (one sweep)."""
        dense = [i for i, c in enumerate(cs) if c.dtype is not _U16]
        parts = list(cs)
        if dense:
            for i, arr in zip(dense, positions_of([cs[i] for i in dense])):
                parts[i] = arr
        lens = np.fromiter(map(len, parts), dtype=np.uint64, count=len(parts))
        lows = np.concatenate(parts) if parts else np.empty(0, np.uint16)
        return lows, np.concatenate(([0], np.cumsum(lens))).astype(np.uint64)

    @classmethod
    def from_bytes(cls, data: bytes,
                   tolerate_torn_tail: bool = False) -> "Bitmap":
        b = cls()
        b.read_bytes(data, tolerate_torn_tail=tolerate_torn_tail)
        return b

    def read_bytes(self, data: bytes, tolerate_torn_tail: bool = False
                   ) -> None:
        """Load a whole file, replaying its op log, through the C++
        reader. A record torn at the end raises ``OpTruncatedError``
        unless ``tolerate_torn_tail`` (a fragment recovering its own
        file), which drops it and reports its bytes in
        ``tail_dropped``. Containers of at most ARRAY_MAX_SIZE bits
        arrive as arrays, the others dense: views into two blocks sized
        to the data."""
        loaded = _native_load(bytes(data), tolerate_torn_tail)
        lows, dense = loaded["lows"], loaded["dense"]
        containers: Dict[int, np.ndarray] = {}
        counts: Dict[int, int] = {}
        lo = dn = 0
        for k, c in zip(loaded["keys"].tolist(), loaded["counts"].tolist()):
            if c <= ARRAY_MAX_SIZE:
                containers[k] = lows[lo:lo + c]
                lo += c
            else:
                containers[k] = dense[dn]
                counts[k] = c
                dn += 1
        self.containers = containers
        self._counts = counts
        self.op_n = loaded["op_n"]
        self.op_n_small = loaded["op_n_small"]
        self.oplog_bytes = loaded["ops_bytes"]
        self.snapshot_bytes = loaded["snapshot_bytes"]
        self.tail_dropped = loaded["tail_dropped"]

    @classmethod
    def from_bytes_plain(cls, data: bytes, tolerate_torn_tail: bool = False,
                         _depth: int = 0) -> "Bitmap":
        b = cls()
        b.read_bytes_plain(data, tolerate_torn_tail, _depth)
        return b

    def read_bytes_plain(self, data: bytes, tolerate_torn_tail: bool = False,
                         _depth: int = 0) -> None:
        """The plain version of ``read_bytes`` (numpy and struct): the
        same verdicts, bits and accounting."""
        self.tail_dropped = 0
        if len(data) < HEADER_BASE_SIZE:
            raise ValueError("data too small")
        magic, version = struct.unpack_from("<HH", data, 0)
        if magic != MAGIC_NUMBER:
            raise ValueError(f"invalid roaring file, magic number {magic}")
        if version != STORAGE_VERSION:
            raise ValueError(f"wrong roaring version v{version}")
        (n,) = struct.unpack_from("<I", data, 4)
        self.containers = {}
        self._counts = {}
        metas: List[Tuple[int, int]] = []
        pos = HEADER_BASE_SIZE
        prev_key = -1
        for _ in range(n):
            key, typ, _card = struct.unpack_from("<QHH", data, pos)
            if key <= prev_key:
                raise ValueError("container keys not sorted")
            prev_key = key
            metas.append((key, typ, _card + 1))
            pos += 12
        ops_offset = pos + 4 * n
        for i, (key, typ, card) in enumerate(metas):
            (offset,) = struct.unpack_from("<I", data, pos + 4 * i)
            if offset >= len(data):
                raise ValueError(f"offset out of bounds: {offset}")
            if typ == CONTAINER_ARRAY:
                vals = np.frombuffer(data, dtype="<u2", count=card,
                                     offset=offset)
                c = np.unique(vals).astype(np.uint16)
                if len(c) > ARRAY_MAX_SIZE:
                    c = _low_mask(c)
                end = offset + 2 * card
            elif typ == CONTAINER_BITMAP:
                c = np.frombuffer(data, dtype="<u8", count=CONTAINER_WORDS,
                                  offset=offset).astype(np.uint64)
                end = offset + 8 * CONTAINER_WORDS
            elif typ == CONTAINER_RUN:
                (run_n,) = struct.unpack_from("<H", data, offset)
                runs = np.frombuffer(
                    data, dtype="<u2", count=run_n * 2,
                    offset=offset + RUN_COUNT_HEADER_SIZE).reshape(-1, 2)
                c = _runs_to_dense(runs)
                end = offset + RUN_COUNT_HEADER_SIZE + 4 * run_n
            else:
                raise ValueError(f"unknown container type {typ}")
            # The header's cardinality is not trusted; the payload
            # decides, and an empty container is not kept.
            if len(c) if c.dtype == np.uint16 else c.any():
                self.containers[key] = c
            ops_offset = max(ops_offset, end)
        self.op_n = 0
        self.op_n_small = 0
        self.oplog_bytes = 0
        self.snapshot_bytes = ops_offset
        buf = memoryview(data)[ops_offset:]
        while len(buf):
            try:
                op_typ, value, values, size = decode_op(buf)
            except OpTruncatedError:
                if not tolerate_torn_tail:
                    raise
                self.tail_dropped = len(buf)
                break
            if op_typ == OP_ADD:
                self._direct_add(value)
                self.op_n_small += 1
                self.op_n += 1
            elif op_typ == OP_REMOVE:
                self._direct_remove(value)
                self.op_n_small += 1
                self.op_n += 1
            elif op_typ == OP_ADD_BATCH:
                self.direct_add_n(values)
                self.op_n += len(values)
            elif op_typ == OP_REMOVE_BATCH:
                self.direct_remove_n(values)
                self.op_n += len(values)
            else:
                if _depth + 1 >= MAX_OP_NESTING:
                    raise ValueError("op nesting too deep")
                batch = Bitmap.from_bytes_plain(values, _depth=_depth + 1)
                self.op_n += batch.count()
                self.union_in_place(batch)
            self.oplog_bytes += size
            buf = buf[size:]

    # -- queries ------------------------------------------------------------

    def count(self) -> int:
        return sum(self.container_count(k) for k in self.containers)

    @staticmethod
    def _positions(c: np.ndarray) -> np.ndarray:
        """Sorted in-container positions of either encoding."""
        return c if c.dtype == np.uint16 else _dense_to_array(c)

    def max(self) -> int:
        if not self.containers:
            return 0
        key = max(self.containers)
        return (key << 16) | int(self._positions(self.containers[key])[-1])

    def slice(self) -> np.ndarray:
        """Every set position, sorted, as uint64."""
        return self.sorted_positions(sorted(self.containers))

    def sorted_positions(self, keys: List[int]) -> np.ndarray:
        """Every set position of the containers ``keys`` (ascending
        container keys, each present), as one sorted uint64 array: the
        dense containers' positions in one C++ sweep, the arrays'
        widened in place."""
        cs = [self.containers[k] for k in keys]
        counts = np.fromiter(map(self.container_count, keys), np.int64,
                             count=len(keys))
        out = np.empty(int(counts.sum()), dtype=np.uint64)
        starts = np.cumsum(counts) - counts
        dense = [i for i, c in enumerate(cs) if c.dtype != np.uint16]
        if dense:
            ptrs = np.fromiter(
                (_ptr(np.ascontiguousarray(cs[i])) for i in dense),
                dtype=np.uint64, count=len(dense))
            bases = np.fromiter((keys[i] << 16 for i in dense),
                                dtype=np.uint64, count=len(dense))
            every = len(dense) == len(cs)
            buf = out if every else np.empty(
                max(1, int(counts[dense].sum())), dtype=np.uint64)
            _lib().rc_dense_positions_ptrs(_ptr(ptrs), len(ptrs),
                                           _ptr(bases), _ptr(buf))
            if not every:
                off = 0
                for i in dense:
                    n = int(counts[i])
                    out[starts[i]:starts[i] + n] = buf[off:off + n]
                    off += n
        for i, c in enumerate(cs):
            if c.dtype == np.uint16:
                seg = out[starts[i]:starts[i] + len(c)]
                seg[:] = c
                seg += np.uint64(keys[i] << 16)
        return out

    def count_range(self, start: int, end: int) -> int:
        """Bits in [start, end)."""
        if end <= start:
            return 0
        total = 0
        k0, k1 = start >> 16, (end - 1) >> 16
        # Walk the smaller key set: the range span or the containers.
        if k1 - k0 + 1 <= len(self.containers):
            keys = (k for k in range(k0, k1 + 1) if k in self.containers)
        else:
            keys = (k for k in self.containers if k0 <= k <= k1)
        for key in keys:
            lo = max(start - (key << 16), 0)
            hi = min(end - (key << 16), CONTAINER_BITS)
            if lo == 0 and hi == CONTAINER_BITS:
                total += self.container_count(key)
            else:
                arr = self._positions(self.containers[key])
                total += int(np.count_nonzero((arr >= lo) & (arr < hi)))
        return total

    def dense_range(self, start: int, end: int) -> np.ndarray:
        """Dense uint64 words of bits [start, end), container-aligned."""
        assert start & 0xFFFF == 0 and end & 0xFFFF == 0
        n_containers = (end - start) >> 16
        out = np.zeros(n_containers * CONTAINER_WORDS, dtype=np.uint64)
        k0 = start >> 16
        for i in range(n_containers):
            c = self.containers.get(k0 + i)
            if c is None:
                continue
            seg = out[i * CONTAINER_WORDS:(i + 1) * CONTAINER_WORDS]
            if c.dtype == np.uint16:
                v = c.astype(np.uint32)
                np.bitwise_or.at(
                    seg, v >> 6,
                    np.left_shift(np.uint64(1), (v & 63).astype(np.uint64)))
            else:
                seg[:] = c
        return out
