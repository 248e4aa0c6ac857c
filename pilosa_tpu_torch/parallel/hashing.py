"""Shard placement hashing, a copy of the JAX package's
``parallel/hashing.py``: placement is the same in both packages.

A shard maps to a partition by fnv64a over (index name, shard as 8
little-endian bytes) modulo 256 partitions, and a partition to a node
by Lamping-Veach jump consistent hashing, with ReplicaN successive
nodes around the sorted ring as its replicas.
"""

from __future__ import annotations

import struct
from typing import List

DEFAULT_PARTITION_N = 256

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


def fnv64a(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def partition(index: str, shard: int, partition_n: int = DEFAULT_PARTITION_N
              ) -> int:
    """(reference cluster.partition, cluster.go:828-837: hashes the index
    name then the shard as 8 little-endian bytes)."""
    buf = struct.pack("<Q", shard)
    return fnv64a(index.encode("utf-8") + buf) % partition_n


def jump_hash(key: int, n_buckets: int) -> int:
    """Lamping-Veach jump consistent hash (reference jmphasher.Hash,
    cluster.go:902-913): minimal movement when n_buckets changes."""
    if n_buckets <= 0:
        return -1
    b, j = -1, 0
    key &= 0xFFFFFFFFFFFFFFFF
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def partition_nodes(partition_id: int, n_nodes: int, replica_n: int
                    ) -> List[int]:
    """Node indexes serving a partition: jump-hash owner + ReplicaN-1
    successors around the sorted ring (reference partitionNodes,
    cluster.go:857-877)."""
    if n_nodes == 0:
        return []
    replica_n = min(max(replica_n, 1), n_nodes)
    owner = jump_hash(partition_id, n_nodes)
    return [(owner + i) % n_nodes for i in range(replica_n)]


def shard_nodes(index: str, shard: int, n_nodes: int, replica_n: int = 1,
                partition_n: int = DEFAULT_PARTITION_N) -> List[int]:
    """(reference ShardNodes, cluster.go:840)."""
    return partition_nodes(partition(index, shard, partition_n), n_nodes,
                           replica_n)
