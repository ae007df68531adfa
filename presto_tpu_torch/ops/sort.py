"""ORDER BY / compaction kernels.

Reference: operator/OrderByOperator.java + PagesIndex.java:75;
TopNOperator.java:35.

Sort keys are monotone-encoded (descending by bitwise/arithmetic
negation, NULL placement by a separate rank key) and ordered by a chain
of stable `torch.sort` passes, least significant key first (LSD): torch
sorts one key at a time where XLA's sort takes many operands, and stable
passes compose into the same lexicographic order. Compaction (live rows
to the front, original order kept) is a stable sort on the dead bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from presto_tpu_torch.batch import Batch


class SortKey(NamedTuple):
    values: torch.Tensor
    validity: Optional[torch.Tensor]
    descending: bool = False
    nulls_first: bool = False


def _encode_key(k: SortKey):
    """Monotone encoding such that an ascending sort yields the requested
    order. Returns (null_rank | None, value_key)."""
    v = k.values
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    if k.descending:
        v = -v if v.is_floating_point() else ~v
    if k.validity is None:
        return None, v
    # nulls first → null rank 0; nulls last → null rank 1
    valid = k.validity
    null_rank = (valid if k.nulls_first else ~valid).to(torch.int32)
    v = torch.where(valid, v, torch.zeros_like(v))
    return null_rank, v


def lex_sort_permutation(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows lexicographically by `operands`
    (most significant first), ties in input order."""
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        if op.dtype == torch.bool:
            op = op.to(torch.int32)
        elif op.is_floating_point():
            # the JAX package's sort order: -0.0 ties +0.0 and every NaN is
            # one greatest value (the card's radix sort would split both)
            op = torch.where(op == 0, 0.0, op)
            op = torch.where(torch.isnan(op), float("nan"), op)
        _, idx = torch.sort(op[perm], stable=True)
        perm = perm[idx]
    return perm


def sort_permutation(keys: Sequence[SortKey], live: torch.Tensor) -> torch.Tensor:
    """Stable permutation ordering live rows by keys, dead rows last."""
    operands: List[torch.Tensor] = [(~live).to(torch.int32)]
    for k in keys:
        null_rank, v = _encode_key(k)
        if null_rank is not None:
            operands.append(null_rank)
        operands.append(v)
    return lex_sort_permutation(operands)


def permute_batch(b: Batch, perm: torch.Tensor) -> Batch:
    return Batch(b.names, b.types, [c.gather(perm) for c in b.columns],
                 b.live[perm], b.dicts)


def sort_batch(b: Batch, keys: Sequence[SortKey],
               limit: Optional[int] = None) -> Batch:
    out = permute_batch(b, sort_permutation(keys, b.live))
    if limit is not None:
        keep = torch.arange(out.capacity, device=out.device) < limit
        out = out.with_live(out.live & keep)
    return out


def compact(b: Batch) -> Batch:
    """Move live rows to the front (stable). Dead lanes become trailing."""
    _, perm = torch.sort((~b.live).to(torch.int32), stable=True)
    return permute_batch(b, perm)


def limit_batch(b: Batch, n: int) -> Batch:
    """LIMIT without ordering: keep the first n live rows."""
    rank = torch.cumsum(b.live.to(torch.int64), 0) - 1
    return b.with_live(b.live & (rank < n))
