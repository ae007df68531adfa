"""T-digest sketches as dictionary-entry values.

Reference surface: presto-main/src/main/java/com/facebook/presto/
tdigest/TDigest.java and operator/aggregation/TDigestAggregationFunction
/ operator/scalar/TDigestFunctions.java (tdigest_agg, merge,
value_at_quantile(s), quantile_at_value, scale_tdigest, trimmed_mean).

Design (TPU-first): a TDIGEST value is a serialized centroid list stored
as a dictionary ENTRY (like every other string-shaped value in this
engine), so digests ride joins/exchanges/spill as int32 codes and every
scalar function over them evaluates once per distinct digest as a
host-side LUT. Construction happens at the materialized single-task
aggregation (the fragmenter gathers non-decomposable aggregates), where
the full value array is available — so the centroid assignment is a
VECTORIZED one-shot pass over the sorted data rather than the
reference's streaming per-row insertion: cluster id = ⌊k(q) − k(0)⌋
with the k₁ scale function k(q) = δ/(2π)·asin(2q−1), which yields
≤ δ/2 + 1 centroids and the same tail-concentrated size invariant.

Serialization is exact ASCII (`repr` floats round-trip binary64), so
digests survive the wire codec and spill byte-identically.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_COMPRESSION = 100.0

_MAGIC = "TD1"


def _k(q: np.ndarray, d: float) -> np.ndarray:
    """k₁ scale function (TDigest.java integratedLocation analog)."""
    return d / (2.0 * math.pi) * np.arcsin(np.clip(2.0 * q - 1.0, -1.0, 1.0))


def serialize(compression: float, total: float, vmin: float, vmax: float,
              means: np.ndarray, weights: np.ndarray) -> str:
    cents = ",".join(f"{repr(float(m))}:{repr(float(w))}"
                     for m, w in zip(means, weights))
    return (f"{_MAGIC};{repr(float(compression))};{repr(float(total))};"
            f"{repr(float(vmin))};{repr(float(vmax))};{cents}")


def deserialize(entry: str):
    """entry → (compression, total, min, max, means, weights) or None."""
    parts = entry.split(";")
    if len(parts) != 6 or parts[0] != _MAGIC:
        return None
    try:
        compression, total, vmin, vmax = map(float, parts[1:5])
        if parts[5]:
            pairs = [c.split(":") for c in parts[5].split(",")]
            means = np.asarray([float(p[0]) for p in pairs])
            weights = np.asarray([float(p[1]) for p in pairs])
        else:
            means = np.zeros(0)
            weights = np.zeros(0)
    except (ValueError, IndexError):
        return None
    return compression, total, vmin, vmax, means, weights


def build(values, weights=None, compression: float = DEFAULT_COMPRESSION) -> str | None:
    """One-shot t-digest over a value array (aggregation-time path)."""
    v = np.asarray(values, np.float64)
    w = (np.ones_like(v) if weights is None
         else np.asarray(weights, np.float64))
    keep = w > 0
    v, w = v[keep], w[keep]
    if v.size == 0:
        return None
    order = np.argsort(v, kind="stable")
    return _compress(v[order], w[order], compression)


def build_sorted(values: np.ndarray, weights: np.ndarray,
                 compression: float = DEFAULT_COMPRESSION) -> str | None:
    """build() over values already in ascending order (ties in input
    order) with positive weights: the same digest, without the sort."""
    if len(values) == 0:
        return None
    return _compress(np.asarray(values, np.float64),
                     np.asarray(weights, np.float64), compression)


def _compress(v: np.ndarray, w: np.ndarray, compression: float) -> str:
    """Sorted values+weights → serialized digest (vectorized cluster
    assignment in k-space; one segment-sum per plane)."""
    total = float(w.sum())
    q_right = np.cumsum(w) / total
    cluster = np.floor(_k(q_right, compression)
                       - _k(np.zeros(1), compression)[0]).astype(np.int64)
    cluster = np.minimum(cluster, int(compression))  # q=1 edge cell
    # collapse empty cells so centroid count is the occupied-cell count
    _, seg = np.unique(cluster, return_inverse=True)
    n = int(seg.max()) + 1 if seg.size else 0
    wsum = np.bincount(seg, weights=w, minlength=n)
    msum = np.bincount(seg, weights=v * w, minlength=n)
    means = msum / wsum
    return serialize(compression, total, float(v[0]), float(v[-1]),
                     means, wsum)


def merge(entries) -> str | None:
    """Merge serialized digests (the reference's merge(tdigest) aggregate
    / TDigest.merge): concatenate centroids, re-compress sorted."""
    parsed = [p for p in (deserialize(e) for e in entries) if p is not None]
    if not parsed:
        return None
    compression = max(p[0] for p in parsed)
    vmin = min(p[2] for p in parsed)
    vmax = max(p[3] for p in parsed)
    means = np.concatenate([p[4] for p in parsed])
    weights = np.concatenate([p[5] for p in parsed])
    if means.size == 0:
        return None
    order = np.argsort(means, kind="stable")
    out = _compress(means[order], weights[order], compression)
    # centroid means can contract the observed extremes; restore them
    p = deserialize(out)
    return serialize(p[0], p[1], vmin, vmax, p[4], p[5])


def _midpoints(weights: np.ndarray) -> np.ndarray:
    cum = np.cumsum(weights)
    return cum - weights / 2.0


def value_at_quantile(entry: str, q: float) -> float | None:
    """Quantile → value by linear interpolation between centroid
    midpoints, clamped to the observed [min, max]
    (TDigest.getQuantile)."""
    p = deserialize(entry)
    if p is None or not 0.0 <= q <= 1.0:
        return None
    _, total, vmin, vmax, means, weights = p
    if means.size == 0:
        return None
    target = q * total
    mid = _midpoints(weights)
    if target <= mid[0]:
        # below the first midpoint: interpolate from the true minimum
        f = target / mid[0] if mid[0] > 0 else 1.0
        return float(vmin + f * (means[0] - vmin))
    if target >= mid[-1]:
        span = total - mid[-1]
        f = (target - mid[-1]) / span if span > 0 else 1.0
        return float(means[-1] + f * (vmax - means[-1]))
    i = int(np.searchsorted(mid, target, side="right")) - 1
    span = mid[i + 1] - mid[i]
    f = (target - mid[i]) / span if span > 0 else 0.0
    return float(means[i] + f * (means[i + 1] - means[i]))


def quantile_at_value(entry: str, x: float) -> float | None:
    """Value → rank estimate in [0, 1] (TDigest.getCdf)."""
    p = deserialize(entry)
    if p is None:
        return None
    _, total, vmin, vmax, means, weights = p
    if means.size == 0:
        return None
    if x < vmin:
        return 0.0
    if x >= vmax:
        return 1.0
    mid = _midpoints(weights)
    if x <= means[0]:
        span = means[0] - vmin
        f = (x - vmin) / span if span > 0 else 1.0
        return float(f * mid[0] / total)
    if x >= means[-1]:
        span = vmax - means[-1]
        f = (x - means[-1]) / span if span > 0 else 0.0
        return float((mid[-1] + f * (total - mid[-1])) / total)
    i = int(np.searchsorted(means, x, side="right")) - 1
    span = means[i + 1] - means[i]
    f = (x - means[i]) / span if span > 0 else 0.0
    return float((mid[i] + f * (mid[i + 1] - mid[i])) / total)


def scale(entry: str, factor: float) -> str | None:
    """scale_tdigest: multiply all centroid weights (TDigestFunctions
    .scaleTDigest; factor must be positive)."""
    p = deserialize(entry)
    if p is None or factor <= 0:
        return None
    compression, total, vmin, vmax, means, weights = p
    return serialize(compression, total * factor, vmin, vmax,
                     means, weights * factor)


def trimmed_mean(entry: str, lo: float, hi: float) -> float | None:
    """Mean of the values between the lo and hi quantiles: centroid
    weights clipped to the [lo·total, hi·total] rank window
    (TDigestFunctions.trimmedMean)."""
    p = deserialize(entry)
    if p is None or not 0.0 <= lo <= hi <= 1.0:
        return None
    _, total, _, _, means, weights = p
    if means.size == 0 or hi == lo:
        return None
    cum = np.cumsum(weights)
    left = cum - weights
    overlap = np.minimum(cum, hi * total) - np.maximum(left, lo * total)
    overlap = np.maximum(overlap, 0.0)
    wsum = overlap.sum()
    if wsum <= 0:
        return None
    return float((means * overlap).sum() / wsum)
