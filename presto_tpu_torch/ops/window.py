"""Window function kernels.

The counterpart of the JAX package's ops/window.py (reference:
operator/WindowOperator.java:47 + operator/window/*). The input is sorted
once by (partition keys, order keys); every window value is then a
closed-form vector computation over the sorted rows:

- partition/peer boundaries  → adjacent-row key-change masks
- segment start index        → cummax of boundary-marked iota
- segment id / sizes         → cumsum of boundaries + one indexed add
- running (frame) aggregates → cumsum minus its value at segment start
- RANGE CURRENT ROW frames   → gather the running value at the last peer row
- lag/lead                   → shifted gathers with same-partition masking

Where the JAX package leans on primitives torch lacks on CUDA, this module
has exact equivalents: the segmented running minimum (an associative scan
there) is a log-step doubling scan masked to the row's own partition, and
floor(log2(span)) (`lax.clz` there) counts the powers of two the span
reaches. Float minima and maxima follow IEEE 754 minimum/maximum, as XLA's
do: NaN wins, and -0.0 is below +0.0 (torch.minimum picks either operand
on a tie, torch's scatter reductions the first row).

Integer and decimal sums run in int64 and are exact. Float window sums are
differences of one global cumsum, as in the JAX package; torch's cumsum
adds in another order (a parallel scan on the card), so they agree to
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from presto_tpu_torch.ops.grouping import _minmax_identity


class WindowKeys(NamedTuple):
    """Sorted-order boundary structure shared by every function over one
    (partition_by, order_by) spec."""

    is_start: torch.Tensor      # partition boundary at i
    seg_start: torch.Tensor     # index of partition start, per row
    seg_id: torch.Tensor        # partition ordinal, per row
    seg_size: torch.Tensor      # partition row count, per row
    peer_start: torch.Tensor    # index of first peer (same order keys), per row
    peer_last: torch.Tensor     # index of last peer, per row
    row_number: torch.Tensor    # 1-based position within partition
    live: torch.Tensor
    n_live: torch.Tensor


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE 754 minimum: NaN if either is NaN, -0.0 below +0.0 (torch's
    minimum picks either operand on a tie, by code path)."""
    m = torch.minimum(a, b)
    if a.is_floating_point():
        m = torch.where(a == b, torch.where(torch.signbit(a), a, b), m)
    return m


def _seg_extreme(v: torch.Tensor, seg: torch.Tensor, nseg: int,
                 want_min: bool) -> torch.Tensor:
    """Per-segment IEEE minimum (maximum) of v by segment id, length nseg:
    a scatter reduction with NaN and the sign of zero settled by counts, so
    the result does not depend on the order rows reach a segment."""
    dev = v.device
    if not v.is_floating_point():
        info = torch.iinfo(v.dtype)
        out = torch.full((nseg,), info.max if want_min else info.min,
                         dtype=v.dtype, device=dev)
        return out.scatter_reduce(0, seg, v, "amin" if want_min else "amax")
    sent = float("inf") if want_min else float("-inf")
    nan = torch.isnan(v)
    out = torch.full((nseg,), sent, dtype=v.dtype, device=dev)
    out = out.scatter_reduce(0, seg, torch.where(nan, sent, v),
                             "amin" if want_min else "amax")

    def count(mask):
        c = torch.zeros(nseg, dtype=torch.int32, device=dev)
        return c.index_add_(0, seg, mask.to(torch.int32)) > 0

    # a zero extreme is -0.0 for a minimum when any -0.0 reached it, +0.0
    # for a maximum when any +0.0 did
    zero_sign = torch.signbit(v) if want_min else ~torch.signbit(v)
    zero = count((v == 0) & zero_sign)
    out = torch.where((out == 0) & zero,
                      torch.tensor(-0.0 if want_min else 0.0, dtype=v.dtype,
                                   device=dev), out)
    return torch.where(count(nan), float("nan"), out)


def _change_mask(cols, live):
    """True at i where any key column differs from row i-1 (or i == 0)."""
    n = live.shape[0]
    change = _iota(n, live.device) == 0
    for values, validity in cols:
        prev = torch.roll(values, 1)
        diff = values != prev
        if values.is_floating_point():
            # SQL total order: NaN equals NaN for grouping/peers
            diff = diff & ~(torch.isnan(values) & torch.isnan(prev))
        if validity is not None:
            pv = torch.roll(validity, 1)
            # null vs null is "same" for partitioning/peers; null vs value
            # differs
            diff = torch.where(validity & pv, diff, validity != pv)
        change = change | diff
    return change


def window_keys(part_cols: Sequence[tuple], order_cols: Sequence[tuple],
                live: torch.Tensor) -> WindowKeys:
    """All boundary structure for one spec, over batch-sorted rows (live
    rows first — sort_permutation puts dead rows last)."""
    n = live.shape[0]
    dev = live.device
    iota = _iota(n, dev)
    is_start = _change_mask(part_cols, live)
    seg_start = torch.cummax(torch.where(is_start, iota, 0), 0).values
    seg_id = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32) - 1
    ones = live.to(torch.int64)
    sizes = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg_id.to(torch.int64), ones)
    seg_size = sizes[seg_id.to(torch.int64)]
    if not order_cols:
        # no ORDER BY: every partition row is a peer of every other
        peer_start = seg_start
        peer_last = seg_start + torch.clamp(seg_size - 1, min=0)
    else:
        peer_change = is_start | _change_mask(order_cols, live)
        peer_start = torch.cummax(torch.where(peer_change, iota, 0), 0).values
        peer_id = torch.cumsum(peer_change.to(torch.int64), 0) - 1
        last = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
            0, peer_id, torch.where(live, iota, 0), "amax")
        peer_last = last[peer_id]
    row_number = iota - seg_start + 1
    return WindowKeys(is_start, seg_start, seg_id, seg_size, peer_start,
                      peer_last.to(torch.int32), row_number, live, ones.sum())


# ---------------------------------------------------------------------------
# ranking functions


def row_number(k: WindowKeys):
    return k.row_number, None


def rank(k: WindowKeys):
    return (k.peer_start - k.seg_start + 1).to(torch.int64), None


def dense_rank(k: WindowKeys):
    n = k.live.shape[0]
    peer_change = _iota(n, k.live.device) == k.peer_start
    cnt = torch.cumsum(peer_change.to(torch.int64), 0)
    return cnt - cnt[k.seg_start] + 1, None


def percent_rank(k: WindowKeys):
    r = (k.peer_start - k.seg_start + 1).to(torch.float64)
    denom = torch.clamp(k.seg_size - 1, min=1).to(torch.float64)
    return torch.where(k.seg_size > 1, (r - 1) / denom, 0.0), None


def cume_dist(k: WindowKeys):
    covered = (k.peer_last - k.seg_start + 1).to(torch.float64)
    return covered / torch.clamp(k.seg_size, min=1).to(torch.float64), None


def ntile(k: WindowKeys, buckets: int):
    """SQL NTILE: the first (size % n) buckets get one extra row."""
    size = k.seg_size
    q = size // buckets
    r = size % buckets
    rn0 = k.row_number - 1
    big = r * (q + 1)  # rows covered by the larger buckets
    b = torch.where(rn0 < big, rn0 // torch.clamp(q + 1, min=1),
                    r + (rn0 - big) // torch.clamp(q, min=1))
    # more buckets than rows: bucket == row_number
    b = torch.where(size < buckets, rn0, b)
    return b + 1, None


# ---------------------------------------------------------------------------
# value functions


def _shift_gather(values, validity, idx, ok, live, default=None):
    """Gather values[idx] where `ok`; out-of-frame rows are NULL, or
    `default` (lag/lead 3-arg form) when given."""
    n = values.shape[0]
    idx = torch.clamp(idx, 0, n - 1).to(torch.int64)
    v = values[idx]
    valid = (torch.ones(n, dtype=torch.bool, device=values.device)
             if validity is None else validity[idx])
    valid = valid & ok & live
    if default is not None:
        v = torch.where(ok, v, torch.tensor(default, dtype=v.dtype,
                                            device=v.device))
        valid = valid | (~ok & live)
    return v, valid


def lag(k: WindowKeys, values, validity, offset: int = 1, default=None):
    idx = _iota(values.shape[0], values.device) - offset
    return _shift_gather(values, validity, idx, idx >= k.seg_start, k.live,
                         default)


def lead(k: WindowKeys, values, validity, offset: int = 1, default=None):
    idx = _iota(values.shape[0], values.device) + offset
    seg_end = k.seg_start + k.seg_size - 1
    return _shift_gather(values, validity, idx, idx <= seg_end, k.live,
                         default)


def first_value(k: WindowKeys, values, validity):
    return _shift_gather(values, validity, k.seg_start,
                         torch.ones_like(k.live), k.live)


def last_value(k: WindowKeys, values, validity):
    # default frame = RANGE UNBOUNDED PRECEDING .. CURRENT ROW → last peer
    return _shift_gather(values, validity, k.peer_last,
                         torch.ones_like(k.live), k.live)


def nth_value(k: WindowKeys, values, validity, n: int):
    idx = k.seg_start + (n - 1)
    ok = (idx <= k.peer_last) & (n >= 1)
    return _shift_gather(values, validity, idx, ok, k.live)


# ---------------------------------------------------------------------------
# aggregate window functions (default frame: whole partition without ORDER
# BY, RANGE UNBOUNDED PRECEDING..CURRENT ROW with ORDER BY)


def _seg_total(x: torch.Tensor, k: WindowKeys) -> torch.Tensor:
    """Each row's partition total of x (an indexed add by partition)."""
    seg = k.seg_id.to(torch.int64)
    tot = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return tot.index_add_(0, seg, x)[seg]


def _avg_half_away(s, c):
    """Integer/decimal average, rounded half away from zero, like the
    aggregation finalizer."""
    cden = torch.clamp(c, min=1)
    return torch.sign(s) * ((torch.abs(s) + cden // 2) // cden)


def agg_window(k: WindowKeys, fn: str, values, validity, frame: str,
               is_float: bool):
    """sum/avg/min/max/count over the window. frame: "whole" = whole
    partition (no ORDER BY), "range" = RANGE UNBOUNDED..CURRENT (default
    with ORDER BY — peer rows included), "rows" = ROWS UNBOUNDED..CURRENT."""
    valid = k.live if validity is None else (k.live & validity)
    framed = frame in ("range", "rows")
    peer_last = k.peer_last.to(torch.int64)

    def frame_value(run):
        return run if frame == "rows" else run[peer_last]

    def running(x):
        c = torch.cumsum(x, 0)
        return c - c[k.seg_start] + x[k.seg_start]

    validi = valid.to(torch.int64)
    if fn == "count":
        if framed:
            return frame_value(running(validi)), None
        return _seg_total(validi, k), None

    if fn in ("sum", "avg"):
        acc_dtype = values.dtype if is_float else torch.int64
        v = torch.where(valid, values.to(acc_dtype),
                        torch.zeros((), dtype=acc_dtype, device=values.device))
        if framed:
            s = frame_value(running(v))
            c = frame_value(running(validi))
        else:
            s = _seg_total(v, k)
            c = _seg_total(validi, k)
        out_valid = c > 0
        if fn == "sum":
            return s, out_valid
        if is_float:
            return s / torch.clamp(c, min=1).to(s.dtype), out_valid
        return _avg_half_away(s, c), out_valid

    if fn in ("min", "max"):
        sent = _minmax_identity(values.dtype, fn)
        v = torch.where(valid, values,
                        torch.tensor(sent, dtype=values.dtype,
                                     device=values.device))
        if framed:
            cm = (_segmented_cummin(v, k) if fn == "min"
                  else -_segmented_cummin(-v, k))
            return frame_value(cm), frame_value(running(validi)) > 0
        seg = k.seg_id.to(torch.int64)
        total = _seg_extreme(v, seg, v.shape[0], fn == "min")
        return total[seg], _seg_total(validi, k) > 0

    raise NotImplementedError(f"window aggregate {fn}")


# ---------------------------------------------------------------------------
# bounded ROWS frames (ROWS BETWEEN <bound> AND <bound>)


def parse_frame_bound(tok: str):
    """'up' | 'uf' | 'cur' | 'pN' | 'fN' → (kind, offset)."""
    if tok in ("up", "uf", "cur"):
        return tok, 0
    if tok[0] == "p":
        return "p", int(tok[1:])
    if tok[0] == "f":
        return "f", int(tok[1:])
    raise ValueError(f"bad frame bound {tok!r}")


def frame_bounds(k: WindowKeys, frame: str):
    """'rows:<s>:<e>' → (start_idx, end_idx, nonempty) per sorted row.
    Bounds clamp to the partition; an inverted frame is empty (SQL: the
    aggregate over an empty frame is NULL / count 0)."""
    _, s_tok, e_tok = frame.split(":")
    sk, so = parse_frame_bound(s_tok)
    ek, eo = parse_frame_bound(e_tok)
    iota = _iota(k.live.shape[0], k.live.device)
    seg_end = k.seg_start + torch.clamp(k.seg_size - 1, min=0)

    def bound(kind, off):
        return {"up": k.seg_start, "cur": iota, "p": iota - off,
                "f": iota + off, "uf": seg_end}[kind]

    start, end = bound(sk, so), bound(ek, eo)
    nonempty = ((torch.maximum(start, k.seg_start)
                 <= torch.minimum(end, seg_end)) & k.live)
    start_c = torch.minimum(torch.maximum(start, k.seg_start), seg_end)
    end_c = torch.minimum(torch.maximum(end, k.seg_start), seg_end)
    return start_c.to(torch.int32), end_c.to(torch.int32), nonempty


def _range_min_table(v):
    """Sparse table for O(1) range-min queries: levels[j][i] = min over
    [i, i + 2^j), as a [L, n] tensor with L = floor(log2 n) + 1. It holds
    L copies of v: for store_sales at SF 1 (2.88 M rows in one batch, L =
    22) that is 22 x 2.88 M x 8 B, about 0.5 GB of device memory while one
    bounded min/max window function runs."""
    n = v.shape[0]
    levels = [v]
    j = 0
    while (1 << (j + 1)) <= n:
        prev = levels[-1]
        half = 1 << j
        shifted = torch.cat([prev[half:], prev[-1:].repeat(half)])
        levels.append(fmin(prev, shifted))
        j += 1
    return torch.stack(levels)


def floor_log2(span: torch.Tensor, levels: int) -> torch.Tensor:
    """floor(log2(span)) for 1 <= span, capped at levels - 1: how many of
    2, 4, 8, ... the span reaches (exact integer compares)."""
    j = torch.zeros_like(span, dtype=torch.int64)
    for e in range(1, levels):
        j += (span >= (1 << e)).to(torch.int64)
    return j


def _range_min_query(table, start, end):
    """min over [start, end] (inclusive, start <= end) via two overlapping
    power-of-two windows. An empty frame (start > end) reads the level the
    JAX package's clz-based level gives it (the top one), so even its
    masked-out value is the same."""
    n = table.shape[1]
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    span = end - start + 1
    j = torch.where(span < 0, table.shape[0] - 1,
                    floor_log2(span, table.shape[0]))
    second = torch.clamp(end - (1 << j) + 1, 0, n - 1)
    return fmin(table[j, start], table[j, second])


def range_frame_bounds(k: WindowKeys, order_vals, frame: str,
                       order_valid=None, nulls_first: bool = False,
                       offset_scale: int = 1):
    """'range:<s>:<e>' with VALUE offsets over ONE ascending-ized numeric
    order key: per-row frame bounds by vectorized binary search (log n
    gather steps). order_vals are the partition-sorted key values in their
    native domain (int64 for integral/decimal/date keys, float64 for
    doubles); offsets scale by offset_scale (10^scale for decimals) so the
    comparison is exact. NULL and NaN keys are left out of the searchable
    span; their offset bounds resolve to their peer-group edges, while
    UNBOUNDED / CURRENT ROW bounds keep their meaning."""
    _, s_tok, e_tok = frame.split(":")
    sk, so = parse_frame_bound(s_tok)
    ek, eo = parse_frame_bound(e_tok)
    seg_start = k.seg_start
    seg_end = k.seg_start + torch.clamp(k.seg_size - 1, min=0)
    v = order_vals
    iters = max(1, int(k.live.shape[0] - 1).bit_length()) + 1

    # NULL keys sit at one end of each partition (per nulls_first); NaN
    # keys sort at the tail of the non-null run in both directions (DESC
    # negates, and -NaN is still NaN). Shrink the searchable span so no
    # finite target absorbs either group.
    def segcount(mask):
        c = torch.cumsum(mask.to(torch.int64), 0)
        return c[seg_end] - c[seg_start] + mask[seg_start].to(torch.int64)

    nan_mask = (torch.isnan(v) & k.live
                if v is not None and v.is_floating_point() else None)
    null_mask = ((~order_valid) & k.live) if order_valid is not None else None
    lo0, hi0 = seg_start, seg_end
    if null_mask is not None and nulls_first:
        lo0 = torch.minimum(seg_start + segcount(null_mask), seg_end)
    tail = nan_mask
    if null_mask is not None and not nulls_first:
        tail = null_mask if tail is None else (tail | null_mask)
    if tail is not None:
        hi0 = torch.maximum(seg_end - segcount(tail), seg_start)
    # rows whose key cannot anchor a value search take their peer group as
    # any offset bound
    over = null_mask
    if nan_mask is not None:
        over = nan_mask if over is None else (over | nan_mask)

    def shift(delta: int):
        """v + delta, saturating (integer keys must not wrap past the
        extremes; float +/-inf saturates on its own)."""
        if v.is_floating_point():
            return v + float(delta)
        t = v + delta
        info = torch.iinfo(v.dtype)
        if delta > 0:
            t = torch.where(t < v, info.max, t)
        elif delta < 0:
            t = torch.where(t > v, info.min, t)
        return t

    def lower_bound(target):
        """Smallest index in [lo0, hi0] whose key >= target; hi0+1 when
        none."""
        lo, hi = lo0, hi0
        for _ in range(iters):
            mid = (lo + hi) // 2
            ok = v[mid] >= target
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok, lo, torch.minimum(mid + 1, hi0))
        return torch.where(v[hi] >= target, hi, hi0 + 1)

    def upper_bound(target):
        """Largest index in [lo0, hi0] whose key <= target; lo0-1 when
        none."""
        lo, hi = lo0, hi0
        for _ in range(iters):
            mid = (lo + hi + 1) // 2
            ok = v[mid] <= target
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, torch.maximum(mid - 1, lo0))
        return torch.where(v[lo] <= target, lo, lo0 - 1)

    if sk == "up":
        start = seg_start
    elif sk == "cur":
        # RANGE start at CURRENT ROW includes preceding PEERS
        start = k.peer_start
    else:
        start = lower_bound(shift((-so if sk == "p" else so) * offset_scale))
        if over is not None:
            start = torch.where(over, k.peer_start, start)
    peer_last = k.peer_last.to(torch.int64)
    if ek == "uf":
        end = seg_end
    elif ek == "cur":
        end = peer_last
    else:
        end = upper_bound(shift((eo if ek == "f" else -eo) * offset_scale))
        if over is not None:
            end = torch.where(over, peer_last, end)
    nonempty = (start <= end) & k.live
    start = torch.minimum(torch.maximum(start, seg_start), seg_end)
    end = torch.minimum(torch.maximum(end, seg_start), seg_end)
    return start.to(torch.int32), end.to(torch.int32), nonempty


def agg_window_bounded(k: WindowKeys, fn: str, values, validity,
                       frame: str, is_float: bool, order_vals=None,
                       order_valid=None, nulls_first: bool = False,
                       offset_scale: int = 1):
    """sum/avg/min/max/count over an explicit ROWS or RANGE frame.
    Prefix-sum differences for sum/count (both gather indices stay inside
    one partition, so cross-partition terms cancel); sparse-table range
    min/max for extremes."""
    if frame.startswith("range:"):
        start, end, nonempty = range_frame_bounds(
            k, order_vals, frame, order_valid, nulls_first, offset_scale)
    else:
        start, end, nonempty = frame_bounds(k, frame)
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    valid = k.live if validity is None else (k.live & validity)

    def windowed_sum(x, dtype):
        zero = torch.zeros((), dtype=dtype, device=x.device)
        cs = torch.cumsum(torch.where(valid, x.to(dtype), zero), 0)
        lo = torch.where(start > 0, cs[torch.clamp(start - 1, min=0)], zero)
        return cs[end] - lo

    cnt = windowed_sum(torch.ones_like(k.live, dtype=torch.int64),
                       torch.int64)
    cnt = torch.where(nonempty, cnt, 0)
    if fn == "count":
        return cnt, None
    if fn in ("sum", "avg"):
        acc_dtype = values.dtype if is_float else torch.int64
        s = torch.where(nonempty, windowed_sum(values, acc_dtype),
                        torch.zeros((), dtype=acc_dtype, device=values.device))
        out_valid = nonempty & (cnt > 0)
        if fn == "sum":
            return s, out_valid
        if is_float:
            return s / torch.clamp(cnt, min=1).to(s.dtype), out_valid
        return _avg_half_away(s, cnt), out_valid
    if fn in ("min", "max"):
        sent = _minmax_identity(values.dtype, fn)
        v = torch.where(valid, values,
                        torch.tensor(sent, dtype=values.dtype,
                                     device=values.device))
        if fn == "max":
            v = -v
        out = _range_min_query(_range_min_table(v), start, end)
        if fn == "max":
            out = -out
        return out, nonempty & (cnt > 0)
    raise NotImplementedError(f"bounded window aggregate {fn}")


def value_over_frame(k: WindowKeys, fn: str, values, validity, frame: str,
                     nth: int = 1, order_vals=None, order_valid=None,
                     nulls_first: bool = False, offset_scale: int = 1):
    """first_value/last_value/nth_value over an explicit ROWS or RANGE
    frame."""
    if frame.startswith("range:"):
        start, end, nonempty = range_frame_bounds(
            k, order_vals, frame, order_valid, nulls_first, offset_scale)
    else:
        start, end, nonempty = frame_bounds(k, frame)
    if fn == "first_value":
        idx, ok = start, nonempty
    elif fn == "last_value":
        idx, ok = end, nonempty
    else:
        idx = start + (nth - 1)
        ok = nonempty & (idx <= end) & (nth >= 1)
    return _shift_gather(values, validity, idx, ok, k.live)


def _segmented_cummin(v, k: WindowKeys):
    """Running minimum that resets at partition boundaries: a log-step
    doubling scan (Hillis-Steele) whose step d folds in row i-d only when
    that row lies in row i's partition. Minimum is exact and, as IEEE
    minimum, order-free, so this equals the JAX package's associative scan
    bit for bit — including its last step, which interleaves the even and
    odd results by adding them to zero padding and so turns every -0.0
    into +0.0 (from two rows up)."""
    n = v.shape[0]
    iota = _iota(n, v.device)
    out = v
    d = 1
    while d < n:
        prev = torch.cat([out[:d], out[:-d]])
        ok = (iota - d) >= k.seg_start
        out = torch.where(ok, fmin(prev, out), out)
        d *= 2
    if n >= 2 and out.is_floating_point():
        out = out + 0.0
    return out
