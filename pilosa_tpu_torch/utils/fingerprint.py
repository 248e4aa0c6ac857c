"""Stable query fingerprints shared by every identity-keyed surface,
after the JAX package's ``utils/fingerprint.py``.

- ``request_key(index, query, shards)``: the canonical identity of one
  serving-path request: the key the coalescer dedups identical reads
  on, the workload recorder windows on, and the request tier of the
  result cache caches under.
- ``digest(obj)``: a short stable blake2s digest of any repr-able key.
  Not ``hash()``: str hashing is salted per process, and a fingerprint
  must name the same identity across restarts (the shutdown dumps).

Host helpers: no locks, no state.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional, Sequence, Tuple


def digest(obj: Any, size: int = 8) -> str:
    """Stable short hex digest of a repr-able key (blake2s)."""
    return hashlib.blake2s(repr(obj).encode(),
                           digest_size=size).hexdigest()


def request_key(index: str, query: Any,
                shards: Optional[Sequence[int]]
                ) -> Tuple[str, str, Optional[Tuple[int, ...]]]:
    """``(index, pql text, shards)``. A parsed Call or Query keys through
    ``pql_text``, so a string and its parsed form key alike; an explicit
    shard list is type-normalized."""
    if isinstance(query, str):
        q = query
    else:
        from pilosa_tpu_torch.utils.profile import pql_text
        q = pql_text(query)
    return (str(index), q,
            tuple(int(s) for s in shards) if shards is not None else None)
