"""HyperLogLog sketches as dictionary-entry values.

Reference surface: presto-main/.../type/HyperLogLogType.java,
operator/aggregation/ApproximateSetAggregation (approx_set),
MergeHyperLogLogAggregation (merge), and
operator/scalar/HyperLogLogFunctions.java (cardinality,
empty_approx_set).

Design: same shape as expr/tdigest.py — a sketch value is a serialized
sparse register list stored as a dictionary ENTRY, so sketches ride
joins/exchanges/spill as int32 codes and cardinality() is a code-indexed
LUT. The hash pipeline and the bias-corrected estimator are IDENTICAL to
the approx_distinct lowering (expr/compile.py __hll_reg/__hll_rank and
plan/builder._plan_hll), so `cardinality(approx_set(x))` and
`approx_distinct(x)` return the same number for the same input.
"""

from __future__ import annotations

import math

import re

import numpy as np

# must equal expr.compile.HLL_M (asserted by tests): 2^12 registers,
# standard error 1.04/sqrt(m) ≈ 1.6%
HLL_M = 4096

_MAGIC = "HL1"

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _np_splitmix64(x: np.ndarray) -> np.ndarray:
    """numpy twin of ops.hashing.splitmix64 (same constants/shifts)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def regs_and_ranks(values: np.ndarray,
                   content_hashes: np.ndarray | None = None):
    """Per-row (register, rank) exactly like the device lowering:
    register = low log2(m) hash bits; rank = 1 + clz of the top 32 bits.
    `content_hashes` (already int64) takes precedence — string columns
    hash by dictionary content, not code."""
    if content_hashes is not None:
        h = content_hashes.astype(np.int64)
    elif np.issubdtype(values.dtype, np.floating):
        v = values.astype(np.float64)
        h = v.view(np.int64).copy()
        h[v == 0.0] = 0  # canonicalize -0.0 → +0.0
    else:
        h = values.astype(np.int64)
    h = _np_splitmix64(h.view(np.uint64))
    reg = (h & np.uint64(HLL_M - 1)).astype(np.int64)
    w = ((h >> np.uint64(32)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    f = np.maximum(w.astype(np.float64), 1.0)
    rank = np.where(w == 0, 33, 32 - np.floor(np.log2(f))).astype(np.int64)
    return reg, rank


def serialize(ranks: np.ndarray) -> str:
    """Dense m-register rank array → sparse ASCII entry."""
    nz = np.nonzero(ranks)[0]
    body = ",".join(map("{}:{}".format, nz.tolist(), ranks[nz].tolist()))
    return f"{_MAGIC};{HLL_M};{body}"


# a sparse body: "i:r" pairs separated by commas
_PAIRS = re.compile(r"[^:,]*:[^:,]*(?:,[^:,]*:[^:,]*)*")


def deserialize(entry: str) -> np.ndarray | None:
    parts = entry.split(";")
    if len(parts) != 3 or parts[0] != _MAGIC:
        return None
    try:
        m = int(parts[1])
        if m <= 0:
            return None
        ranks = np.zeros(m, np.int64)
        if parts[2]:
            if not _PAIRS.fullmatch(parts[2]):
                return None
            toks = list(map(int, re.split("[:,]", parts[2])))
            idx = np.array(toks[0::2], dtype=np.int64)
            if ((idx < 0) | (idx >= m)).any():  # negative would wrap
                return None
            np.maximum.at(ranks, idx, np.array(toks[1::2], dtype=np.int64))
    except ValueError:
        return None
    return ranks


def empty() -> str:
    return serialize(np.zeros(HLL_M, np.int64))


def build(reg: np.ndarray, rank: np.ndarray) -> str:
    ranks = np.zeros(HLL_M, np.int64)
    np.maximum.at(ranks, reg, rank)
    return serialize(ranks)


def merge(entries) -> str | None:
    """Elementwise register max (MergeHyperLogLogAggregation). Sketches
    with differing register counts are INCOMPATIBLE states — fail the
    query loudly (the reference throws too) rather than undercount."""
    acc = None
    for e in entries:
        r = deserialize(e)
        if r is None:
            continue
        if acc is None:
            acc = r.copy()
        elif len(r) != len(acc):
            raise ValueError(
                f"cannot merge HyperLogLog sketches with different "
                f"register counts ({len(acc)} vs {len(r)})")
        else:
            np.maximum(acc, r, out=acc)
    return None if acc is None else serialize(acc)


def cardinality(entry: str) -> int | None:
    """Bias-corrected harmonic-mean estimate with the small-range
    linear-counting correction — the SAME estimator _plan_hll builds in
    plan nodes, so approx_set→cardinality == approx_distinct."""
    ranks = deserialize(entry)
    if ranks is None:
        return None
    m = float(len(ranks))
    occupied = ranks > 0
    zeros = m - float(occupied.sum())
    s = float(np.sum(np.power(2.0, -ranks[occupied].astype(np.float64))))
    alpha = 0.7213 / (1.0 + 1.079 / m)
    S = s + zeros
    raw = alpha * m * m / S
    if raw <= 2.5 * m and zeros > 0:
        return int(round(m * math.log(m / zeros)))
    return int(round(raw))
