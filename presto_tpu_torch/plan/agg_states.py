"""Aggregate state layouts shared by the planner (fragmenter) and runtime.

Reference: AggregationNode.Step (PARTIAL/INTERMEDIATE/FINAL/SINGLE) and the
accumulator state classes (operator/aggregation/state/*, e.g.
VarianceState, CovarianceState, CorrelationState): a partial aggregation
emits *state columns* (avg → sum+count, variance → count+sum+sumsq) that
travel through the exchange and are merged by the final aggregation.

Decomposable aggregates expand into columns each merged with one of the
kernel ops (sum / min / max / count_add — ops/grouping.py). Aggregates with
no mergeable fixed-width state (approx_percentile, max_by/min_by) are
non-decomposable: the fragmenter gathers their input to a single task and
the runtime computes them over materialized sorted input.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from presto_tpu_torch.types import BIGINT, DOUBLE, TINYINT, DecimalType, Type

# fn → list of (state-suffix, merge-op); "" suffix = the agg's own symbol.
# The suffix doubles as the input-transform tag (runtime in_to_states).
_VARIANCE_FNS = {"variance", "var_samp", "var_pop", "stddev", "stddev_samp",
                 "stddev_pop"}
_COVAR_FNS = {"covar_pop", "covar_samp"}
_NON_DECOMPOSABLE = {"approx_percentile", "__approx_percentile_w",
                     "max_by", "min_by", "array_agg", "map_agg",
                     "numeric_histogram", "tdigest_agg", "merge",
                     "approx_set",
                     "count_distinct", "sum_distinct", "avg_distinct"}


def is_decomposable(aggs) -> bool:
    return all(a.fn not in _NON_DECOMPOSABLE for a in aggs)


def _decimal_arg(a, in_types) -> bool:
    t = in_types.get(a.arg) if a.arg else None
    if isinstance(t, DecimalType):
        return True
    # final step: the child output carries the partial's limb state columns
    return (a.symbol + "$hi") in in_types or (a.symbol + "$sum_hi") in in_types


def agg_state_layout(aggs, in_types: Dict[str, Type]) -> List[Tuple[str, str, object]]:
    """Each AggSpec expands to one or more (state_name, merge_op, spec).

    Decimal sums accumulate in TWO int64 limb states ($hi carries the
    arithmetic high limb, $lo the nonnegative low 32 bits) so int128-exact
    totals survive any row count — the reference's
    UnscaledDecimal128Arithmetic state (presto-spi/.../type/
    UnscaledDecimal128Arithmetic.java) on TPU-friendly int64 lanes."""
    layout = []
    for a in aggs:
        if a.fn == "sum":
            if _decimal_arg(a, in_types):
                layout.append((a.symbol + "$hi", "sum", a))
                layout.append((a.symbol + "$lo", "sum", a))
            else:
                layout.append((a.symbol, "sum", a))
        elif a.fn in ("count", "count_star", "count_if"):
            layout.append((a.symbol, "count_add", a))
        elif a.fn == "avg":
            if _decimal_arg(a, in_types):
                layout.append((a.symbol + "$sum_hi", "sum", a))
                layout.append((a.symbol + "$sum_lo", "sum", a))
            else:
                layout.append((a.symbol + "$sum", "sum", a))
            layout.append((a.symbol + "$cnt", "count_add", a))
        elif a.fn in ("min", "max"):
            layout.append((a.symbol, a.fn, a))
        elif a.fn in ("arbitrary", "any_value"):
            layout.append((a.symbol, "min", a))
        elif a.fn in ("bool_and", "every"):
            layout.append((a.symbol, "min", a))
        elif a.fn == "bool_or":
            layout.append((a.symbol, "max", a))
        elif a.fn == "checksum":
            layout.append((a.symbol, "sum", a))
        elif a.fn in _VARIANCE_FNS:
            layout.append((a.symbol + "$cnt", "count_add", a))
            layout.append((a.symbol + "$sum", "sum", a))
            layout.append((a.symbol + "$sumsq", "sum", a))
        elif a.fn in _COVAR_FNS:
            layout.append((a.symbol + "$cnt", "count_add", a))
            layout.append((a.symbol + "$sx", "sum", a))
            layout.append((a.symbol + "$sy", "sum", a))
            layout.append((a.symbol + "$sxy", "sum", a))
        elif a.fn == "corr":
            layout.append((a.symbol + "$cnt", "count_add", a))
            layout.append((a.symbol + "$sx", "sum", a))
            layout.append((a.symbol + "$sy", "sum", a))
            layout.append((a.symbol + "$sxy", "sum", a))
            layout.append((a.symbol + "$sxx", "sum", a))
            layout.append((a.symbol + "$syy", "sum", a))
        elif a.fn == "geometric_mean":
            layout.append((a.symbol + "$cnt", "count_add", a))
            layout.append((a.symbol + "$lsum", "sum", a))
        else:
            udf = _registered_aggregate(a.fn)
            if udf is None:
                raise NotImplementedError(f"aggregate {a.fn}")
            for suffix, op, _transform in udf.states:
                layout.append((a.symbol + suffix, op, a))
    return layout


def _registered_aggregate(fn: str):
    from presto_tpu_torch.functions import registry

    return registry().aggregate(fn)


def sum_state_type(a, in_types: Dict[str, Type]) -> Type:
    t = in_types[a.arg]
    if isinstance(t, DecimalType):
        return DecimalType(18, t.scale)
    if t.name in ("tinyint", "smallint", "integer", "bigint"):
        return BIGINT
    return DOUBLE


def limb_pairs(layout) -> List[Tuple[int, int]]:
    """(hi_index, lo_index) state pairs needing carry renormalization after
    each merge (lo kept canonical in [0, 2^32))."""
    idx = {name: i for i, (name, _, _) in enumerate(layout)}
    pairs = []
    for name, i in idx.items():
        if name.endswith("$hi") or name.endswith("$sum_hi"):
            lo_name = name[: -len("hi")] + "lo"
            if lo_name in idx:
                pairs.append((i, idx[lo_name]))
    return pairs


def state_types(layout, in_types: Dict[str, Type]) -> List[Type]:
    out = []
    for name, op, a in layout:
        if op == "count_add":
            out.append(BIGINT)
        elif name.endswith(("$hi", "$sum_hi")):
            out.append(BIGINT)
        elif name.endswith(("$lo", "$sum_lo")):
            # the low limb carries the value's scale through the exchange
            t = in_types.get(a.arg)
            scale = t.scale if isinstance(t, DecimalType) else 0
            out.append(DecimalType(38, scale))
        elif a.fn == "checksum":
            out.append(BIGINT)
        elif a.fn in ("bool_and", "bool_or", "every"):
            out.append(TINYINT)
        elif a.fn in _VARIANCE_FNS or a.fn in _COVAR_FNS or a.fn in (
                "corr", "geometric_mean"):
            out.append(DOUBLE)
        elif _registered_aggregate(a.fn) is not None:
            # registered UDAF states accumulate in float64 lanes
            out.append(DOUBLE)
        elif op == "sum":
            if a.fn in ("avg", "sum"):
                out.append(sum_state_type(a, in_types) if a.arg else BIGINT)
            else:
                out.append(DOUBLE)
        elif op in ("min", "max"):
            t = in_types[a.arg]
            if isinstance(t, DecimalType) and t.is_long:
                out.append(DOUBLE)  # combined-f64 extremes (see builder)
            else:
                out.append(t)
        else:
            out.append(DOUBLE)
    return out


def partial_output(child_output, group_keys, aggs) -> List[Tuple[str, Type]]:
    """Schema of a step='partial' aggregation: keys then state columns."""
    in_types = dict(child_output)
    layout = agg_state_layout(aggs, in_types)
    return [(k, in_types[k]) for k in group_keys] + list(
        zip([name for name, _, _ in layout], state_types(layout, in_types))
    )
