"""64-bit vectorized hashing for join and group keys.

The same splitmix64-based combined hash as the JAX package, bit for bit:
slot0 of the hash tables and every partition id derive from it. torch has
no uint64 shifts on every device, so the arithmetic runs in int64: a
logical right shift is an arithmetic shift masked to the low 64-k bits,
and int64 multiplication wraps mod 2^64 like uint64's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _s64(u: int) -> int:
    """uint64 bit pattern → the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _s64(0xBF58476D1CE4E5B9)
_M2 = _s64(0x94D049BB133111EB)
_GOLDEN = 0x9E3779B97F4A7C15
_SIGN_OFF = 0x7FFFFFFFFFFFFFFF


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by k (0 < k < 64)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


def hash_columns(cols: Sequence[torch.Tensor],
                 valids: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> torch.Tensor:
    """Combined 64-bit hash of one or more key columns (int-ish values).

    NULLs hash as a distinct fixed value so NULL keys co-partition.
    Returns non-negative int64 (sign bit masked)."""
    h = None
    for i, v in enumerate(cols):
        x = v.to(torch.int64)
        if valids is not None and valids[i] is not None:
            x = torch.where(valids[i], x, torch.full_like(x, _s64(_GOLDEN)))
        hv = splitmix64(x + _s64(_GOLDEN * (i + 1)))
        h = splitmix64(hv if h is None else h ^ hv)
    return h & _SIGN_OFF


def slot_hash(h: torch.Tensor, tcap: int) -> torch.Tensor:
    """Initial probe slot for the hash-table engine: the LOW log2(tcap)
    bits of the 63-bit content hash."""
    if tcap <= 0 or tcap & (tcap - 1):
        raise ValueError(
            f"slot table capacity must be a power of two, got {tcap}")
    return (h & (tcap - 1)).to(torch.int32)
