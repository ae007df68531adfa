"""The content hash that partitions rows by their keys.

The JAX package's `partition_hash` (ops/partition.py there), bit for bit:
a 63-bit hash of the key columns in which a string key is first mapped
through its dictionary's content-hash table, so equal strings coded
against different dictionaries land in the same partition (reference
InterpretedHashGenerator hashes value bytes). The within-worker radix
partitioner takes its top bits (ops/radix.py). The exchange that routes
by it belongs to the distributed plane, which the port does not have.
"""

from __future__ import annotations

from typing import Sequence

import torch

from presto_tpu_torch.batch import Batch
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
