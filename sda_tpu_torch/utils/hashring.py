"""Consistent hashing of aggregation ids over K partitions (copy of
``sda_tpu/utils/hashring.py``).

One ring serves both halves of the sharded coordination plane: the
sharded store (``server/sharded.py``) uses it to pick the backing
partition for an aggregation, and the multi-frontend REST client
(``rest/client.py``) uses it to pick a frontend for a request — both
sides hash the same key (the aggregation id as a string), so an
aggregation's traffic lands on one frontend and one partition without any
coordination between them.

Classic fixed-ring construction: each partition owns ``vnodes`` points
on a 64-bit ring (SHA-1 of ``"shard-<ix>-<vnode>"``), a key maps to the
first point clockwise from its own hash. Fully deterministic across
processes and runs — no randomness, no process-seeded hashing (never
``hash()``: PYTHONHASHSEED would split the client and server rings).
Virtual nodes keep the load split near-uniform at small K, and growing
K moves only ~1/K of the keyspace (the consistent-hashing property that
makes repartitioning cheap).
"""

from __future__ import annotations

import bisect
import hashlib


def _point(data: str) -> int:
    """A deterministic 64-bit ring position for ``data``."""
    return int.from_bytes(hashlib.sha1(data.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """A consistent-hash ring over ``shards`` partitions."""

    def __init__(self, shards: int, vnodes: int = 64):
        if shards < 1:
            raise ValueError("a hash ring needs at least one shard")
        self.shards = shards
        points = []
        for ix in range(shards):
            for v in range(vnodes):
                points.append((_point(f"shard-{ix}-{v}"), ix))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [ix for _, ix in points]

    def shard_for(self, key) -> int:
        """The partition owning ``key`` (stringified before hashing)."""
        if self.shards == 1:
            return 0
        at = bisect.bisect_right(self._points, _point(str(key)))
        return self._owners[at % len(self._owners)]

    def preference(self, key) -> list:
        """Every shard ordered by ring walk from ``key``'s point: the
        owner first, then each next-distinct shard clockwise. The client
        router uses this as its failover order so every client agrees on
        which frontend is 'next' for a given aggregation."""
        if self.shards == 1:
            return [0]
        at = bisect.bisect_right(self._points, _point(str(key)))
        order: list = []
        seen = set()
        n = len(self._owners)
        for step in range(n):
            owner = self._owners[(at + step) % n]
            if owner not in seen:
                seen.add(owner)
                order.append(owner)
                if len(order) == self.shards:
                    break
        return order
