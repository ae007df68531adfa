"""The content hash that partitions rows by their keys, and the exchange's
routing by it.

The JAX package's ops/partition.py, bit for bit: `partition_hash` is a
63-bit hash of the key columns in which a string key is first mapped
through its dictionary's content-hash table, so equal strings coded
against different dictionaries land in the same partition (reference
InterpretedHashGenerator hashes value bytes). The exchange routes a row to
consumer `hash % n` (`partition_ids`, which a worker's hash sink stamps on
every page); the within-worker radix partitioner takes the top bits of
the same hash (ops/radix.py), so a sink that routed by it can tag its
pages with their radix id. `partition_layout` / `partition_for_exchange`
scatter a batch into (partition, slot) lanes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops.hashing import hash_columns


def partition_hash(batch: Batch, key_names: Sequence[str]) -> torch.Tensor:
    """Content-equality 63-bit hash of the key columns (int64, >= 0)."""
    vals, valids = [], []
    for k in key_names:
        c = batch.column(k)
        v = c.values
        d = batch.dicts.get(k)
        if d is not None:
            lut = torch.as_tensor(d.content_hash_lut(), device=v.device)
            v = lut[torch.clamp(v.to(torch.int64) + 1, 0, lut.shape[0] - 1)]
        vals.append(v)
        valids.append(c.validity)
    return hash_columns(vals, valids)


def partition_ids(batch: Batch, key_names: Sequence[str],
                  num_partitions: int) -> torch.Tensor:
    """Row -> partition id by hash(keys) mod num_partitions (int32)."""
    h = partition_hash(batch, key_names)
    return (h % num_partitions).to(torch.int32)


def partition_layout(batch: Batch, key_names: Sequence[str],
                     num_partitions: int, per_partition_capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """Routing layout: sort rows by partition id once (stable, dead rows
    last) and derive every plane's scatter from that sort. Returns
    (sperm, dest, counts, routed, overflow):
    - sperm int32[n]: source row of each sorted position,
    - dest int32[n]: output slot (partition * C + rank) of each sorted
      position; P*C marks dead and overflow rows,
    - counts int32[P]: live rows a partition (overflow included),
    - routed bool[n]: sorted-order mask of the rows that landed in a lane,
    - overflow: the count of live rows past a partition's capacity."""
    n = batch.capacity
    P, C = num_partitions, per_partition_capacity
    pid = partition_ids(batch, key_names, P)
    pid = torch.where(batch.live, pid, P)
    spid, sperm = torch.sort(pid, stable=True)
    sperm = sperm.to(torch.int32)
    start = torch.searchsorted(
        spid, torch.arange(P + 1, dtype=spid.dtype, device=spid.device))
    rank = torch.arange(n, dtype=torch.int32, device=spid.device)
    pstart = start[torch.clamp(spid, 0, P).to(torch.int64)]
    slot = rank - pstart.to(torch.int32)
    live_sorted = spid < P
    in_cap = slot < C
    dest = torch.clamp(spid, 0, P - 1) * C + slot
    dest = torch.where(live_sorted & in_cap, dest, P * C).to(torch.int32)
    # dead rows sort to id P, past the counted range
    counts = torch.bincount(spid.to(torch.int64), minlength=P + 1)[:P]
    overflow = (live_sorted & ~in_cap).sum()
    return sperm, dest, counts.to(torch.int32), live_sorted & in_cap, overflow


def partition_for_exchange(batch: Batch, key_names: Sequence[str],
                           num_partitions: int, per_partition_capacity: int
                           ) -> Tuple[Batch, torch.Tensor, torch.Tensor]:
    """Scatter rows into (P, C) per-partition lanes. Returns (the batch of
    P*C rows, live counts a partition int32[P], overflow count); row order
    within a partition follows input order."""
    sperm, dest, counts, routed, overflow = partition_layout(
        batch, key_names, num_partitions, per_partition_capacity)
    out_n = num_partitions * per_partition_capacity
    keep = dest < out_n
    idx = sperm[keep].to(torch.int64)
    slots = dest[keep].to(torch.int64)

    def scatter(p):
        out = torch.zeros((out_n,) + tuple(p.shape[1:]), dtype=p.dtype,
                          device=p.device)
        out[slots] = p[idx]
        return out

    cols = [Column(scatter(c.values),
                   None if c.validity is None else scatter(c.validity),
                   None if c.hi is None else scatter(c.hi))
            for c in batch.columns]
    out_live = torch.zeros(out_n, dtype=torch.bool, device=batch.device)
    out_live[slots] = routed[keep]
    return (Batch(batch.names, batch.types, cols, out_live, batch.dicts),
            counts, overflow)
