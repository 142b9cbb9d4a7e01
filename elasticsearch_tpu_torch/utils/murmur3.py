"""MurmurHash3 x86 32-bit.

The reference routes documents to shards with murmur3 over the routing key
(cluster/routing/OperationRouting.java:216-222, which delegates to
``Murmur3HashFunction``). We implement the same public algorithm so routing
behavior is stable and well distributed; we do NOT need bit-for-bit parity
with Java's UTF-16 hashing (this is a new framework), so we hash UTF-8 bytes.
"""

from __future__ import annotations

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 over ``data``; returns unsigned 32-bit int.

    Pure Python: this package builds no host-side native helpers."""
    h = seed & _MASK
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK

    tail = data[nblocks * 4 :]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k

    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def hash_routing(routing_key: str) -> int:
    """Hash a routing key (usually the document _id) for shard routing."""
    return murmur3_32(routing_key.encode("utf-8"))


def shard_id_for(routing_key: str, num_shards: int, routing_partition_size: int = 1) -> int:
    """Map a routing key to a shard.

    Reference analog: OperationRouting.generateShardId
    (cluster/routing/OperationRouting.java:216-222) — murmur3(routing) % shards,
    with optional partition offset for routing_partition_size.
    """
    h = hash_routing(routing_key)
    if routing_partition_size > 1:
        # spread one routing value over a partition of shards
        offset = hash_routing(routing_key + "#partition") % routing_partition_size
        return (h + offset) % num_shards
    return h % num_shards
