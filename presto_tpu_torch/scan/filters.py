"""TupleDomainFilter analogs — vectorized host-side value filters.

Reference: presto-orc's TupleDomainFilter.java (BigintRange, DoubleRange,
BytesRange/BytesValues, BooleanValue, IsNull/IsNotNull, Multi*) — the
per-column domain predicates Aria evaluates DURING column decode. Here the
filter runs on the decoded engine-native numpy column (dictionary codes
for strings, day ints for dates, unscaled ints for short decimals) before
any bytes reach the device.

Filters compiled from planner constraints are conservative SUPERSETS of
the true predicate (a `>` constraint arrives as an inclusive bound): rows
they drop are guaranteed to fail the exact device filter, rows they keep
still pass through it. Correctness therefore never depends on this layer;
it only shrinks the host→device transfer.

NULL semantics: planner constraints come from comparison conjuncts, and
SQL comparisons with NULL are never-true — so every filter here drops NULL
rows unless constructed with null_allowed=True.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch.types import DecimalType


class ValueFilter:
    """Base: boolean keep-mask over one decoded column slice."""

    null_allowed: bool = False

    def apply(self, values: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def test(self, values: np.ndarray,
             validity: Optional[np.ndarray]) -> np.ndarray:
        mask = self.apply(values)
        if validity is not None:
            mask = np.where(validity, mask, self.null_allowed)
        return mask


class BigintRange(ValueFilter):
    """Inclusive [lo, hi] over integer-domain columns (bigint, date day
    ints, short-decimal unscaled ints, dictionary codes, booleans)."""

    def __init__(self, lo=None, hi=None, null_allowed: bool = False):
        self.lo, self.hi = lo, hi
        self.null_allowed = null_allowed

    def apply(self, values):
        mask = np.ones(len(values), bool)
        if self.lo is not None:
            mask &= values >= self.lo
        if self.hi is not None:
            mask &= values <= self.hi
        return mask

    def __repr__(self):
        return f"BigintRange({self.lo}, {self.hi})"


class DoubleRange(ValueFilter):
    """Inclusive [lo, hi] over float columns (NaN never passes a range —
    matching SQL comparison semantics)."""

    def __init__(self, lo=None, hi=None, null_allowed: bool = False):
        self.lo, self.hi = lo, hi
        self.null_allowed = null_allowed

    def apply(self, values):
        mask = np.ones(len(values), bool)
        if self.lo is not None:
            mask &= values >= self.lo
        if self.hi is not None:
            mask &= values <= self.hi
        if self.lo is None and self.hi is None:
            return mask
        return mask & ~np.isnan(values)

    def __repr__(self):
        return f"DoubleRange({self.lo}, {self.hi})"


class BytesValues(ValueFilter):
    """IN-list over dictionary codes (the string domain never leaves the
    host: an IN ('a','b') predicate is an int32 membership test)."""

    def __init__(self, codes, null_allowed: bool = False):
        self.codes = np.asarray(codes, np.int32)
        self.null_allowed = null_allowed

    def apply(self, values):
        return np.isin(values, self.codes)

    def __repr__(self):
        return f"BytesValues({len(self.codes)} codes)"


class MultiRange(ValueFilter):
    """OR of inclusive ranges (TupleDomain multi-range domains)."""

    def __init__(self, ranges: Sequence[Tuple[object, object]],
                 null_allowed: bool = False):
        self.ranges = list(ranges)
        self.null_allowed = null_allowed

    def apply(self, values):
        mask = np.zeros(len(values), bool)
        for lo, hi in self.ranges:
            m = np.ones(len(values), bool)
            if lo is not None:
                m &= values >= lo
            if hi is not None:
                m &= values <= hi
            mask |= m
        return mask

    def __repr__(self):
        return f"MultiRange({self.ranges})"


class IsNull(ValueFilter):
    def test(self, values, validity):
        if validity is None:
            return np.zeros(len(values), bool)
        return ~validity

    def __repr__(self):
        return "IsNull"


class IsNotNull(ValueFilter):
    def test(self, values, validity):
        if validity is None:
            return np.ones(len(values), bool)
        return validity.copy()

    def __repr__(self):
        return "IsNotNull"


class AlwaysFalse(ValueFilter):
    """Constraint provably unsatisfiable (e.g. equality with a string
    absent from the dictionary) — the whole split dies without decode."""

    def test(self, values, validity):
        return np.zeros(len(values), bool)

    def __repr__(self):
        return "AlwaysFalse"


def filters_from_constraints(constraints: Dict[str, tuple],
                             handle) -> Dict[str, ValueFilter]:
    """Compile planner (lo, hi) constraints into per-column value filters
    in the ENGINE-NATIVE value domain (the decoded representation the
    connectors hand back): dates stay day ints, short decimals stay
    unscaled ints, strings become dictionary-code ranges."""
    out: Dict[str, ValueFilter] = {}
    for col, (lo, hi) in (constraints or {}).items():
        if lo is None and hi is None:
            continue
        try:
            info = handle.column(col)
        except KeyError:
            continue
        t = info.type
        if isinstance(t, DecimalType) and t.is_long:
            continue  # two-limb int128 — host compare not worth the cost
        if t.is_string:
            d = info.dictionary
            if d is None:
                continue
            if (lo is not None and not isinstance(lo, str)) or (
                    hi is not None and not isinstance(hi, str)):
                continue
            lo_c = d.range_codes(lo, "left") if lo is not None else 0
            hi_c = (d.range_codes(hi, "right") - 1 if hi is not None
                    else len(d) - 1)
            if lo_c > hi_c:
                out[col] = AlwaysFalse()
            else:
                # codes >= 0 by construction, so NULL (-1) never passes
                out[col] = BigintRange(lo_c, hi_c)
            continue
        if not isinstance(lo, (int, float, type(None))) or not isinstance(
                hi, (int, float, type(None))):
            continue
        if np.issubdtype(np.dtype(t.dtype), np.floating):
            out[col] = DoubleRange(lo, hi)
        else:
            out[col] = BigintRange(lo, hi)
    return out
