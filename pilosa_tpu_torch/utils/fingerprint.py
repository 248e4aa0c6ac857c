"""The canonical identity of one serving-path request: the key the
coalescer dedups identical reads on (the JAX package's
``utils/fingerprint.request_key`` for PQL text; the port has no result
cache or workload recorder to key parsed trees)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def request_key(index: str, query: str,
                shards: Optional[Sequence[int]]
                ) -> Tuple[str, str, Optional[Tuple[int, ...]]]:
    """``(index, pql text, shards)``, with an explicit shard list
    type-normalized."""
    return (str(index), query,
            tuple(int(s) for s in shards) if shards is not None else None)
