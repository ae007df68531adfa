"""Memory accounting: context tree, pools and revocation.

The JAX package's memory plane on the port's batches (reference:
presto-memory-context's AggregatedMemoryContext / LocalMemoryContext,
memory/MemoryPool.java and QueryContext.java, and
execution/MemoryRevokingScheduler.java:46 — when a pool crosses a
threshold, revocable operators are asked to spill down to a target).

The pool is a ledger: batches are fixed-capacity device tensors, so an
operator's footprint is exact (`batch_device_bytes`). It neither caps nor
queries torch's caching allocator. Execution is synchronous per batch, so
revocation is too: a reserve() that crosses the threshold invokes the
registered revokers (spillable aggregations and join builds, which flag
themselves and spill at their next batch boundary) and then, if the limit
is still exceeded, fails the query with ExceededMemoryLimit. A revoker
that raises fails the reserve (the JAX package skips it).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional


class ExceededMemoryLimit(RuntimeError):
    pass


class MemoryPool:
    """A worker's query memory pool (MemoryPool.java analog)."""

    def __init__(self, limit_bytes: Optional[int] = None,
                 revoke_threshold: float = 0.9, revoke_target: float = 0.5):
        self.limit = limit_bytes
        self.reserved = 0
        self.peak = 0
        self.revoke_threshold = revoke_threshold
        self.revoke_target = revoke_target
        self._lock = threading.Lock()
        # revocable-state owners: fn(bytes_to_free) -> bytes actually freed
        self._revokers: List[Callable[[int], int]] = []

    def add_revoker(self, fn: Callable[[int], int]):
        with self._lock:
            self._revokers.append(fn)

    def remove_revoker(self, fn: Callable[[int], int]):
        with self._lock:
            try:
                self._revokers.remove(fn)
            except ValueError:
                pass

    def add_partial_revoker(self, owner) -> Callable[[int], int]:
        """Register a partition-granular revocable-state owner: `owner`
        exposes ``partition_sizes() -> [(pid, bytes)]`` and
        ``revoke_partition(pid) -> estimated bytes``, the latter marking
        the partition for the owner's next batch boundary. Pool pressure
        reaches it through the ordinary revoker list, largest partition
        first. Returns the wrapper; pass it to ``remove_revoker``."""

        def fn(want):
            self._mark_partial([owner], int(want))
            return 0  # freeing is deferred to the owner's batch boundary

        fn._partial_owner = owner
        with self._lock:
            self._revokers.append(fn)
        return fn

    @staticmethod
    def _mark_partial(owners, want: int) -> int:
        """Largest-partition-first marking across `owners` until the
        estimated freed bytes cover `want` (want <= 0 sheds exactly one
        partition, the largest). Returns partitions marked."""
        ranked = []
        for o in owners:
            ranked.extend((int(b), o, pid) for pid, b in o.partition_sizes())
        ranked.sort(key=lambda t: -t[0])
        est = 0
        marked = 0
        for b, o, pid in ranked:
            est += int(o.revoke_partition(pid))
            marked += 1
            if want <= 0 or est >= want:
                break
        return marked

    def request_partial_revoke(self, want_bytes: int = 0) -> int:
        """Out-of-band partial revoke: shed the largest partitions across
        every partition-granular owner. Returns partitions marked (0 when
        none is registered)."""
        with self._lock:
            owners = [fn._partial_owner for fn in self._revokers
                      if hasattr(fn, "_partial_owner")]
        if not owners:
            return 0
        return self._mark_partial(owners, int(want_bytes))

    def reserve(self, bytes_: int, tag: str = "") -> None:
        if bytes_ <= 0:
            return
        if self.limit is not None:
            with self._lock:
                projected = self.reserved + bytes_
                over_threshold = projected > self.limit * self.revoke_threshold
                revokers = list(self._revokers) if over_threshold else []
            if revokers:
                # MemoryRevokingScheduler: revoke until usage <= target
                target = int(self.limit * self.revoke_target)
                for fn in revokers:
                    if self.reserved + bytes_ <= target:
                        break
                    fn(self.reserved + bytes_ - target)
            with self._lock:
                if self.reserved + bytes_ > self.limit:
                    raise ExceededMemoryLimit(
                        f"Query exceeded per-node memory limit of "
                        f"{self.limit} bytes (requested {bytes_} for {tag}, "
                        f"reserved {self.reserved})"
                    )
                self.reserved += bytes_
                self.peak = max(self.peak, self.reserved)
        else:
            with self._lock:
                self.reserved += bytes_
                self.peak = max(self.peak, self.reserved)

    def request_revoke(self, want_bytes: int = 0) -> int:
        """Out-of-band revoke signal (requestMemoryRevoking): ask every
        registered revocable-state owner to shed state; flag-based
        revokers spill at their next batch boundary. Returns the number of
        revokers signaled."""
        with self._lock:
            revokers = list(self._revokers)
        for fn in revokers:
            fn(int(want_bytes))
        return len(revokers)

    def free(self, bytes_: int) -> None:
        if bytes_ <= 0:
            return
        with self._lock:
            self.reserved = max(0, self.reserved - bytes_)

    def info(self) -> dict:
        with self._lock:
            return {"reservedBytes": self.reserved, "peakBytes": self.peak,
                    "limitBytes": self.limit}


class QueryScopedPool:
    """Per-query view over a shared MemoryPool (QueryContext analog):
    forwards reserve/free to the node pool while tracking this query's
    own reservation."""

    def __init__(self, pool: MemoryPool, query_id: str = ""):
        self.pool = pool
        self.query_id = query_id
        self.query_reserved = 0
        self.peak = 0
        self._lock = threading.Lock()
        self.limit = pool.limit
        self.revoke_threshold = pool.revoke_threshold
        self.revoke_target = pool.revoke_target

    @property
    def reserved(self) -> int:
        # node-wide: spill decisions must see every query's pressure
        return self.pool.reserved

    def add_revoker(self, fn):
        self.pool.add_revoker(fn)

    def remove_revoker(self, fn):
        self.pool.remove_revoker(fn)

    def add_partial_revoker(self, owner):
        return self.pool.add_partial_revoker(owner)

    def request_partial_revoke(self, want_bytes: int = 0) -> int:
        return self.pool.request_partial_revoke(want_bytes)

    def reserve(self, bytes_: int, tag: str = "") -> None:
        self.pool.reserve(bytes_, tag or self.query_id)
        with self._lock:
            self.query_reserved += max(bytes_, 0)
            self.peak = max(self.peak, self.query_reserved)

    def free(self, bytes_: int) -> None:
        self.pool.free(bytes_)
        with self._lock:
            self.query_reserved = max(0, self.query_reserved - max(bytes_, 0))

    def info(self) -> dict:
        return self.pool.info()


class LocalMemoryContext:
    """One operator's accounting slot (LocalMemoryContext.java): setBytes
    semantics, the delta flows to the pool."""

    def __init__(self, pool: MemoryPool, tag: str = ""):
        self.pool = pool
        self.tag = tag
        self.bytes = 0

    def set_bytes(self, n: int):
        delta = n - self.bytes
        if delta > 0:
            self.pool.reserve(delta, self.tag)
        else:
            self.pool.free(-delta)
        self.bytes = n

    def close(self):
        self.set_bytes(0)


class AggregatedMemoryContext:
    """Groups child contexts (task/query rollup,
    AggregatedMemoryContext.java)."""

    def __init__(self, pool: MemoryPool, tag: str = ""):
        self.pool = pool
        self.tag = tag
        self._children: List[LocalMemoryContext] = []

    def new_local(self, tag: str = "") -> LocalMemoryContext:
        c = LocalMemoryContext(self.pool, f"{self.tag}/{tag}")
        self._children.append(c)
        return c

    @property
    def bytes(self) -> int:
        return sum(c.bytes for c in self._children)

    def close(self):
        for c in self._children:
            c.close()


def batch_device_bytes(batch) -> int:
    """Exact device footprint of a Batch: its live mask and every plane of
    every column (values, validity, the long-decimal limb and the
    structural planes), at capacity."""
    total = batch.live.nbytes
    for c in batch.columns:
        for p in c.planes():
            if p is not None:
                total += p.nbytes
    return total
