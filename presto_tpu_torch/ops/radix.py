"""Within-worker radix partitioning for pipeline breakers.

The JAX package's ops/radix.py (reference: the partitioned hash join of
arXiv:2112.02480 and arXiv:2505.04153): both sides of a breaker split by
the top bits of the shared 63-bit content hash (ops/partition.py), so each
partition's build and probe, or group merge, runs on a small table. On
torch a split is one stable `torch.sort` of the partition ids, a P-element
count to the host, and one index-window gather a partition straight out
of the unsorted batch; the bucket of a window is a power of two.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch
# the hash tables' slots take the LOW bits of the same hash
from presto_tpu_torch.ops.hashing import slot_hash  # noqa: F401
from presto_tpu_torch.ops.partition import partition_hash

_HASH_BITS = 63  # hash_columns masks the sign bit


def radix_bits(num_partitions: int) -> int:
    """log2(P); P must be a power of two."""
    if num_partitions <= 0 or num_partitions & (num_partitions - 1):
        raise ValueError(
            f"radix partition count must be a power of two, got "
            f"{num_partitions}")
    return num_partitions.bit_length() - 1


def radix_ids(batch: Batch, key_names: Sequence[str],
              num_partitions: int) -> torch.Tensor:
    """Row -> radix partition id: the top log2(P) bits of the content
    hash (int32)."""
    bits = radix_bits(num_partitions)
    if bits == 0:
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)
    h = partition_hash(batch, key_names)
    return (h >> (_HASH_BITS - bits)).to(torch.int32)


def _perm_by(ids: torch.Tensor, live: torch.Tensor, n_ids: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort of `ids` with dead rows last, and the live count of
    each id (int32[n_ids])."""
    ids = torch.where(live, ids, n_ids)  # dead rows sink
    sorted_ids, perm = torch.sort(ids, stable=True)
    counts = torch.bincount(sorted_ids.to(torch.int64),
                            minlength=n_ids + 1)[:n_ids]
    return perm, counts.to(torch.int32)


def radix_perm(batch: Batch, key_names: Sequence[str],
               num_partitions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort by radix id without moving the batch: (row indices
    in partition order with dead rows last, per-partition live counts
    int32[P]). `radix_window_perm` gathers each window's columns through
    it, so every payload byte moves once."""
    return _perm_by(radix_ids(batch, key_names, num_partitions), batch.live,
                    num_partitions)


def radix_sort(batch: Batch, key_names: Sequence[str],
               num_partitions: int) -> Tuple[Batch, torch.Tensor]:
    """The batch stably sorted by radix id, dead rows last (its live mask
    marks exactly the routed rows), and per-partition live counts."""
    perm, counts = radix_perm(batch, key_names, num_partitions)
    n_live = int(counts.sum())
    live = torch.arange(batch.capacity, device=batch.device) < n_live
    return Batch(batch.names, batch.types,
                 [c.gather(perm) for c in batch.columns], live,
                 batch.dicts), counts


def radix_window_perm(batch: Batch, perm: torch.Tensor, start: int,
                      count: int, bucket: int) -> Batch:
    """`bucket` rows whose partition-order ranks begin at `start`, gathered
    through `perm` from the unsorted batch; lanes at rank >= `count` are
    dead (out-of-range lanes clamp harmlessly)."""
    cap = batch.capacity
    lane = torch.arange(bucket, device=batch.device)
    idx = perm[torch.clamp(lane + start, 0, cap - 1)]
    return Batch(batch.names, batch.types,
                 [c.gather(idx) for c in batch.columns], lane < count,
                 batch.dicts)


def radix_window(sorted_batch: Batch, start: int, count: int,
                 bucket: int) -> Batch:
    """`bucket` rows from `start` of a batch sorted by `radix_sort`; lanes
    at rank >= `count` are dead."""
    cap = sorted_batch.capacity
    lane = torch.arange(bucket, device=sorted_batch.device)
    idx = torch.clamp(lane + start, 0, cap - 1)
    return Batch(sorted_batch.names, sorted_batch.types,
                 [c.gather(idx) for c in sorted_batch.columns], lane < count,
                 sorted_batch.dicts)


def radix_child_ids(batch: Batch, key_names: Sequence[str],
                    parent_partitions: int, fanout: int) -> torch.Tensor:
    """Row -> child index within its parent radix partition: the next
    log2(fanout) hash bits below the parent's top log2(P) bits, so a
    child id refines its parent id like a deeper radix pass."""
    pbits = radix_bits(parent_partitions)
    fbits = radix_bits(fanout)
    if pbits + fbits > _HASH_BITS:
        raise ValueError("radix growth exhausted the hash bits")
    h = partition_hash(batch, key_names)
    return ((h >> (_HASH_BITS - pbits - fbits)) & (fanout - 1)).to(
        torch.int32)


def radix_child_perm(batch: Batch, key_names: Sequence[str],
                     parent_partitions: int, fanout: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`radix_perm` over the child ids of one partition's rows."""
    return _perm_by(radix_child_ids(batch, key_names, parent_partitions,
                                    fanout), batch.live, fanout)
