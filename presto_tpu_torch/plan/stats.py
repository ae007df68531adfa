"""Cost-based statistics derivation — CBO v1.

Reference: presto-main/.../cost/ (44 files): StatsCalculator walks the plan
deriving PlanNodeStatsEstimate per node; FilterStatsCalculator estimates
conjunct selectivities from column NDV/range stats; JoinStatsRule estimates
join output as |L|·|R| / max(NDV); consumed by ReorderJoins.java:94 and
DetermineJoinDistributionType.java:46.

TPU-native shape: connectors supply ColumnStats (NDV, null fraction,
min/max — exact for the generator connectors, footer-derived for parquet).
`derive(node)` recursively computes (rows, per-symbol ColumnStats),
memoized on the node. Consumers: join ordering (builder._assemble_joins),
broadcast-vs-partitioned choice (fragmenter stats_fn), and group-table
capacity selection (Aggregate.estimated_groups → ExecConfig.agg_capacity
override)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from presto_tpu_torch.connector import ColumnStats
from presto_tpu_torch.expr.ir import Call, Constant, InputRef, RowExpression
from presto_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    HashJoin,
    IndexJoin,
    Limit,
    MultiwayJoin,
    Output,
    PlanNode,
    Project,
    RemoteSource,
    SemiJoin,
    SetOp,
    Sort,
    TableScan,
    Window,
)

# fallback selectivities when column stats can't answer (the reference's
# FilterStatsCalculator UNKNOWN_FILTER_COEFFICIENT is 0.9; we keep the
# legacy engine defaults, which are tuned for TPC-H-ish predicates)
UNKNOWN_FILTER_SEL = 0.25
UNKNOWN_EQ_SEL = 0.1


@dataclasses.dataclass
class NodeStats:
    rows: float
    columns: Dict[str, ColumnStats] = dataclasses.field(default_factory=dict)

    def col(self, sym: str) -> Optional[ColumnStats]:
        return self.columns.get(sym)


def _scalar(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _range_fraction(cs: ColumnStats, lo: Optional[float], hi: Optional[float]) -> Optional[float]:
    """Fraction of ROWS in [lo, hi]: histogram-weighted when the column
    carries one (robust to skew), else the uniform [min,max] model
    (FilterStatsCalculator's range estimate)."""
    if cs.min_value is None or cs.max_value is None:
        return None
    width = cs.max_value - cs.min_value
    if width <= 0:
        return 1.0
    a = cs.min_value if lo is None else max(lo, cs.min_value)
    b = cs.max_value if hi is None else min(hi, cs.max_value)
    if b < a:
        return 0.0
    if cs.histogram and len(cs.histogram) >= 2:
        edges = cs.histogram  # equi-depth: each bin holds 1/nb of rows
        nb = len(edges) - 1
        covered = 0.0
        for i in range(nb):
            blo, bhi = edges[i], edges[i + 1]
            if bhi <= blo:
                # zero-width bin (heavy repeated value): counted fully
                # when the point lies inside [a, b]
                covered += 1.0 if a <= blo <= b else 0.0
                continue
            olo, ohi = max(a, blo), min(b, bhi)
            if ohi > olo:
                covered += (ohi - olo) / (bhi - blo)
        return min(1.0, covered / nb)
    return min(1.0, (b - a) / width)


def _conjunct_selectivity(e: RowExpression, stats: NodeStats) -> float:
    if isinstance(e, Call):
        fn = e.fn
        if fn == "and":
            return (_conjunct_selectivity(e.args[0], stats)
                    * _conjunct_selectivity(e.args[1], stats))
        if fn == "or":
            a = _conjunct_selectivity(e.args[0], stats)
            b = _conjunct_selectivity(e.args[1], stats)
            return min(1.0, a + b - a * b)
        if fn == "not":
            return max(0.0, 1.0 - _conjunct_selectivity(e.args[0], stats))
        ref = next((a for a in e.args if isinstance(a, InputRef)), None)
        const = next((a for a in e.args if isinstance(a, Constant)), None)
        cs = stats.col(ref.name) if ref is not None else None
        if fn == "eq" and cs is not None and cs.ndv:
            return min(1.0, 1.0 / cs.ndv)
        if fn == "ne" and cs is not None and cs.ndv:
            return max(0.0, 1.0 - 1.0 / cs.ndv)
        if fn in ("lt", "le", "gt", "ge") and cs is not None and const is not None:
            # normalize to "ref OP const": a constant on the LEFT mirrors
            # the comparison (const < ref  ≡  ref > const)
            if len(e.args) >= 2 and isinstance(e.args[0], Constant):
                fn = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}[fn]
            v = _scalar(const.value)
            if v is not None:
                frac = (_range_fraction(cs, None, v) if fn in ("lt", "le")
                        else _range_fraction(cs, v, None))
                if frac is not None:
                    return frac
        if fn == "between" and cs is not None and len(e.args) == 3:
            lo = _scalar(e.args[1].value) if isinstance(e.args[1], Constant) else None
            hi = _scalar(e.args[2].value) if isinstance(e.args[2], Constant) else None
            frac = _range_fraction(cs, lo, hi)
            if frac is not None:
                return frac
        if fn == "in":
            k = max(1, len(e.args) - 1)
            if cs is not None and cs.ndv:
                return min(1.0, k / cs.ndv)
            return min(1.0, k * UNKNOWN_EQ_SEL)
        if fn == "is_null":
            return cs.null_fraction if cs is not None and cs.null_fraction is not None else 0.05
        if fn == "is_not_null":
            nf = cs.null_fraction if cs is not None and cs.null_fraction is not None else 0.05
            return 1.0 - nf
        if fn == "eq":
            return UNKNOWN_EQ_SEL
        if fn == "like":
            return UNKNOWN_FILTER_SEL
    return UNKNOWN_FILTER_SEL


def filter_selectivity(pred: RowExpression, stats: NodeStats) -> float:
    return max(1e-6, min(1.0, _conjunct_selectivity(pred, stats)))


def _scale_ndv(cs: ColumnStats, factor: float) -> ColumnStats:
    """NDV after keeping `factor` of rows (capped at NDV — the reference
    caps distinct counts by output rows the same way)."""
    ndv = cs.ndv
    if ndv is not None and factor < 1.0:
        # uniform-draw model: expected distinct after sampling
        ndv = ndv * (1.0 - math.exp(-max(factor, 1e-9)))
        ndv = max(1.0, min(cs.ndv, ndv / (1.0 - math.exp(-1.0))))
    # equi-depth edges describe the value distribution, which filtering on
    # OTHER columns leaves unchanged — carry them through
    return ColumnStats(ndv, cs.null_fraction, cs.min_value, cs.max_value,
                       histogram=cs.histogram)


def derive(node: PlanNode, catalog) -> Optional[NodeStats]:
    """Recursive memoized stats derivation (StatsCalculator.getStats)."""
    memo = node.__dict__.get("_node_stats", "__unset__")
    if memo != "__unset__":
        return memo
    s = _derive(node, catalog)
    node.__dict__["_node_stats"] = s
    return s


def invalidate(node: PlanNode):
    node.__dict__.pop("_node_stats", None)
    for c in node.children():
        invalidate(c)


def _derive(node: PlanNode, catalog) -> Optional[NodeStats]:
    if isinstance(node, TableScan):
        if catalog is None:
            return None
        try:
            conn = catalog.connectors[node.catalog]
            handle = conn.get_table(node.table)
        except Exception:
            return None
        rows = float(handle.row_count or 0) or 1e6
        cols = {}
        for sym, cname in node.assignments.items():
            try:
                ci = handle.column(cname)
            except KeyError:
                continue
            if ci.stats is not None:
                cols[sym] = ci.stats
            elif ci.dictionary is not None:
                cols[sym] = ColumnStats(ndv=float(len(ci.dictionary)))
        if handle.primary_key and len(handle.primary_key) == 1:
            pk = handle.primary_key[0]
            for sym, cname in node.assignments.items():
                if cname == pk:
                    prev = cols.get(sym) or ColumnStats()
                    cols[sym] = dataclasses.replace(
                        prev, ndv=rows, null_fraction=0.0)
        # NOTE: scan `constraints` are split-pruning hints extracted from a
        # Filter that REMAINS in the plan — scaling here too would double
        # count the selectivity (the Filter rule above accounts for it)
        return NodeStats(rows, cols)
    if isinstance(node, Filter):
        child = derive(node.child, catalog)
        if child is None:
            return None
        sel = filter_selectivity(node.predicate, child)
        return NodeStats(max(1.0, child.rows * sel),
                         {k: _scale_ndv(v, sel) for k, v in child.columns.items()})
    if isinstance(node, Project):
        child = derive(node.child, catalog)
        if child is None:
            return None
        cols = {}
        for sym, e in node.exprs:
            if isinstance(e, InputRef) and e.name in child.columns:
                cols[sym] = child.columns[e.name]
        return NodeStats(child.rows, cols)
    if isinstance(node, HashJoin):
        left = derive(node.left, catalog)
        right = derive(node.right, catalog)
        if left is None or right is None:
            return None
        ndvs = []
        for lk, rk in zip(node.left_keys, node.right_keys):
            lc, rc = left.col(lk), right.col(rk)
            if lc is not None and lc.ndv:
                ndvs.append(lc.ndv)
            if rc is not None and rc.ndv:
                ndvs.append(rc.ndv)
        if ndvs:
            out_rows = left.rows * right.rows / max(ndvs)
        else:
            out_rows = max(left.rows, right.rows)
        if node.kind in ("left", "full"):
            out_rows = max(out_rows, left.rows)
        if node.kind == "full":
            out_rows = out_rows + right.rows * 0.1
        cols = dict(left.columns)
        cols.update(right.columns)
        return NodeStats(max(1.0, out_rows), cols)
    if isinstance(node, MultiwayJoin):
        cur = derive(node.probe, catalog)
        if cur is None:
            return None
        rows = cur.rows
        cols = dict(cur.columns)
        # leg-by-leg application of the binary join model — the collapse
        # is semantics-preserving, so the chain estimate is too
        for b, kind, pks, bks in zip(node.builds, node.kinds,
                                     node.probe_keys, node.build_keys):
            bs = derive(b, catalog)
            if bs is None:
                return None
            ndvs = []
            for lk, rk in zip(pks, bks):
                lc, rc = cols.get(lk), bs.col(rk)
                if lc is not None and lc.ndv:
                    ndvs.append(lc.ndv)
                if rc is not None and rc.ndv:
                    ndvs.append(rc.ndv)
            out = rows * bs.rows / max(ndvs) if ndvs else max(rows, bs.rows)
            if kind == "left":
                out = max(out, rows)
            rows = out
            cols.update(bs.columns)
        return NodeStats(max(1.0, rows), cols)
    if isinstance(node, SemiJoin):
        left = derive(node.left, catalog)
        if left is None:
            return None
        sel = 0.5
        return NodeStats(max(1.0, left.rows * sel), left.columns)
    if isinstance(node, Aggregate):
        child = derive(node.child, catalog)
        if child is None:
            return None
        if not node.group_keys:
            return NodeStats(1.0, {})
        prod = 1.0
        known = True
        for k in node.group_keys:
            cs = child.col(k)
            if cs is not None and cs.ndv:
                prod *= cs.ndv
            else:
                known = False
        groups = min(prod, child.rows) if known else max(1.0, child.rows * 0.1)
        cols = {k: child.columns[k] for k in node.group_keys if k in child.columns}
        return NodeStats(max(1.0, groups), cols)
    if isinstance(node, SetOp):
        left = derive(node.left, catalog)
        right = derive(node.right, catalog)
        if left is None or right is None:
            return None
        rows = left.rows + right.rows
        if node.kind == "intersect":
            rows = min(left.rows, right.rows)
        elif node.kind == "except":
            rows = left.rows
        return NodeStats(rows, {})
    if isinstance(node, (Sort, Window)):
        child = derive(node.child, catalog)
        if child is None:
            return None
        if isinstance(node, Sort) and node.limit is not None:
            return NodeStats(min(float(node.limit), child.rows), child.columns)
        return NodeStats(child.rows, child.columns)
    if isinstance(node, Limit):
        child = derive(node.child, catalog)
        rows = float(node.count)
        if child is not None:
            rows = min(rows, child.rows)
        return NodeStats(rows, child.columns if child else {})
    if isinstance(node, Output):
        return derive(node.child, catalog)
    if isinstance(node, RemoteSource):
        return None
    return None


# ---------------------------------------------------------------------------
# exchange lane sizing: how many rows the fullest (src device, dst
# partition) lane of an OUT_HASH exchange must hold. The prototype mesh
# exchange padded every lane to capacity//n_dev*2 — ICI bytes tracked the
# batch's padding, not its rows. Stats size the lane instead; under-
# estimates are safe because the executor's per-site overflow replay
# (parallel/mesh_exec) doubles exactly the lane that overflowed.

# multiplied onto the per-lane row estimate: absorbs hash placement
# variance and moderate skew without triggering a replay
EXCHANGE_SKEW_HEADROOM = 2.0


def combined_key_ndv(stats: NodeStats, keys) -> Optional[float]:
    """Combined NDV of a key tuple: product of per-key NDVs capped by the
    row count (the reference caps distinct counts by output rows the same
    way). None when no key has an estimate."""
    prod, known = 1.0, False
    for k in keys:
        cs = stats.col(k)
        if cs is not None and cs.ndv:
            prod *= cs.ndv
            known = True
    if not known:
        return None
    return min(prod, stats.rows) if stats.rows else prod


def exchange_lane_rows(rows: float, key_ndv: Optional[float],
                       n_dev: int,
                       observed_lane_rows: Optional[float] = None) -> float:
    """Estimated rows in the FULLEST lane of an n_dev-way hash exchange.

    A lane is one (source device, destination partition) bucket: each
    device holds ~rows/n_dev and splits them n_dev ways, so the uniform
    expectation is rows/n_dev². Low-NDV keys concentrate load: partition
    p receives ~ceil(ndv/n_dev) whole keys of ~rows/ndv rows each, of
    which each source device contributes a 1/n_dev share — the max of the
    two models sizes the lane, times EXCHANGE_SKEW_HEADROOM.

    ``observed_lane_rows`` (HBO, runstats history) is a measured fullest-
    lane high-water mark from a previous run of the same structure: it
    replaces the model entirely, with modest padding instead of the blind
    skew headroom."""
    if observed_lane_rows is not None and observed_lane_rows > 0:
        return max(1.0, float(observed_lane_rows) * 1.25)
    if rows <= 0:
        return 1.0
    if n_dev <= 1:
        return max(1.0, rows)
    per_lane = rows / (n_dev * n_dev)
    if key_ndv and key_ndv > 0:
        per_part = (rows / key_ndv) * math.ceil(key_ndv / n_dev)
        per_lane = max(per_lane, per_part / n_dev)
    return max(1.0, per_lane * EXCHANGE_SKEW_HEADROOM)


# ---------------------------------------------------------------------------
# breaker engine choice: sort-based vs Pallas linear-probing hash table
# (ops/pallas_hash). The hash engine wins when the group/build table is
# SMALL and rows hit it repeatedly — each row costs O(probe chain) serial
# work instead of participating in an O((cap + batch) log) sort — and
# loses when the table is large (long kernel, big planes) or barely
# reused. The reference analog is DetermineJoinDistributionType: a
# stats-driven physical-strategy pick recorded on the plan node.

# above this many estimated groups the group table stops being "small":
# the insert kernel's serial row loop dominates and the sort engine's
# O(n log n) batched primitives win
HASH_MAX_GROUPS = 1 << 12
# minimum rows-per-group duplication for keyed aggregation: near-distinct
# keys mean the hash table does no reduction, all insert cost
HASH_MIN_DUPLICATION = 4.0
# join/semijoin build sides larger than this probe too long a chain under
# skew and carry wide slot_row tables
HASH_MAX_BUILD_ROWS = 1 << 13
# each key adds an int64 plane every kernel walks per probe step; wide
# key tuples (and wide agg payloads) favor the sort engine's columnar ops
HASH_MAX_KEY_WIDTH = 6
HASH_MAX_PAYLOAD_STATES = 16


def _observed(node: PlanNode, catalog, site: str):
    """History entry for this node's structural fingerprint, or None.
    Only an ``hbo="correct"`` verdict reads it: the session refuses that
    value until ROADMAP item 12, so the engine decides from derived
    statistics and the runtime asks it only to count would-be flips."""
    from presto_tpu_torch.obs import runstats

    return runstats.lookup_node(node, catalog, site)


def _index_table_rows(node: IndexJoin, catalog) -> Optional[float]:
    """An index join's build rows at their most: the indexed table's, of
    which a lookup returns a part (a table scan's estimate)."""
    if catalog is None:
        return None
    try:
        handle = catalog.connectors[node.catalog].get_table(node.table)
    except Exception:
        return None
    return float(handle.row_count or 0) or 1e6


def choose_breaker_engine(node: PlanNode, catalog,
                          override: str = "auto", hbo: str = "off"):
    """(engine, why) for a pipeline breaker: ``engine`` ∈ {sort, hash}.

    ``override`` is the ``breaker_engine`` session property: ``sort`` /
    ``hash`` force the engine; ``auto`` asks the stats above. No stats →
    sort (never regress the known-good engine on a blind guess).

    ``hbo="correct"`` consults the runstats history first: a previous run
    of the same structural fingerprint replaces the estimated group /
    build-row counts with observed ones, and the why string carries an
    ``(hbo: observed)`` provenance suffix."""
    if override == "sort":
        return "sort", "session breaker_engine=sort"
    if override == "hash":
        return "hash", "session breaker_engine=hash"
    if isinstance(node, Aggregate):
        if not node.group_keys:
            return "sort", "global aggregate"
        if len(node.group_keys) > HASH_MAX_KEY_WIDTH:
            return "sort", f"{len(node.group_keys)} group keys > {HASH_MAX_KEY_WIDTH}"
        if len(node.aggs) > HASH_MAX_PAYLOAD_STATES:
            return "sort", f"{len(node.aggs)} agg states > {HASH_MAX_PAYLOAD_STATES}"
        groups = None
        src, suffix = "est", ""
        if hbo == "correct":
            h = _observed(node, catalog, "agg_groups")
            if h and h.get("actual"):
                groups = float(h["actual"])
                src, suffix = "observed", " (hbo: observed)"
        st = derive(node, catalog)
        child = derive(node.child, catalog)
        if groups is None:
            if st is None or child is None or not st.rows or not child.rows:
                return "sort", "no stats"
            groups = st.rows
        rows = child.rows if (child is not None and child.rows) else None
        if rows is None:
            # observed groups without an input-row estimate: assume enough
            # duplication that the group-count threshold alone decides
            rows = groups * HASH_MIN_DUPLICATION
        if groups > HASH_MAX_GROUPS:
            return "sort", f"{src} {groups:.3g} groups > {HASH_MAX_GROUPS}{suffix}"
        dup = rows / max(groups, 1.0)
        if dup < HASH_MIN_DUPLICATION:
            return "sort", f"duplication x{dup:.2g} < {HASH_MIN_DUPLICATION:.2g}{suffix}"
        return "hash", f"{src} {groups:.3g} groups, x{dup:.3g} duplication{suffix}"
    if isinstance(node, (HashJoin, SemiJoin, IndexJoin)):
        keys = node.left_keys
        if len(keys) > HASH_MAX_KEY_WIDTH:
            return "sort", f"{len(keys)} join keys > {HASH_MAX_KEY_WIDTH}"
        build_rows = None
        src, suffix = "est", ""
        if hbo == "correct":
            h = _observed(node, catalog, "join_build")
            if h and h.get("actual"):
                build_rows = float(h["actual"])
                src, suffix = "observed", " (hbo: observed)"
        if build_rows is None:
            if isinstance(node, IndexJoin):
                build_rows = _index_table_rows(node, catalog)
            else:
                build = derive(node.right, catalog)
                build_rows = None if build is None else build.rows
            if not build_rows:
                return "sort", "no build-side stats"
        if build_rows > HASH_MAX_BUILD_ROWS:
            return "sort", f"{src} build {build_rows:.3g} rows > {HASH_MAX_BUILD_ROWS}{suffix}"
        return "hash", f"{src} build {build_rows:.3g} rows{suffix}"
    return "sort", "not an engine-dimensioned breaker"


def choose_breaker_engine_observed(node: PlanNode, groups: float,
                                   rows: Optional[float] = None):
    """(engine, why) from OBSERVED telemetry — the in-run adaptive analog
    of ``choose_breaker_engine``. Same sort/hash thresholds, but the
    group count is the replay wave's confirmed ``ng`` and the row count
    is the host-known dispatched-capacity watermark, so the verdict
    reflects what THIS run actually saw instead of derived estimates.
    Structural guards (key width, payload states, global agg) match the
    estimate path — a shape the hash engine cannot take never flips."""
    if isinstance(node, Aggregate):
        if not node.group_keys:
            return "sort", "global aggregate"
        if len(node.group_keys) > HASH_MAX_KEY_WIDTH:
            return "sort", f"{len(node.group_keys)} group keys > {HASH_MAX_KEY_WIDTH}"
        if len(node.aggs) > HASH_MAX_PAYLOAD_STATES:
            return "sort", f"{len(node.aggs)} agg states > {HASH_MAX_PAYLOAD_STATES}"
        groups = float(max(groups, 1.0))
        if groups > HASH_MAX_GROUPS:
            return "sort", (f"observed {groups:.3g} groups > "
                            f"{HASH_MAX_GROUPS} (adaptive: observed)")
        if rows is None:
            rows = groups * HASH_MIN_DUPLICATION
        dup = float(rows) / groups
        if dup < HASH_MIN_DUPLICATION:
            return "sort", (f"observed duplication x{dup:.2g} < "
                            f"{HASH_MIN_DUPLICATION:.2g} (adaptive: observed)")
        return "hash", (f"observed {groups:.3g} groups, x{dup:.3g} "
                        f"duplication (adaptive: observed)")
    return "sort", "not an engine-dimensioned breaker"


# ---------------------------------------------------------------------------
# binary-vs-multiway join chain choice (plan/multiway.py collapse pass).
# Multiway keeps N build tables resident and walks every probe row through
# all N probes in one compiled pass — it wins when the chain's joins are
# not so selective that a binary cascade would shrink the intermediate
# stream early (multiway probes table i for rows a selective join i-1
# would already have dropped), and when the combined builds fit residency.

# combined build rows past which the resident-builds assumption is off —
# the collapse declines and the binary chain keeps its PR 15 spill ladder
MULTIWAY_MAX_BUILD_ROWS = 1 << 22
# non-unique builds probe through the Pallas fanout kernel; past the
# binary hash-engine threshold its serial insert loop dominates
MULTIWAY_MAX_FANOUT_BUILD_ROWS = HASH_MAX_BUILD_ROWS
# observed probe selectivity (output rows / probe rows) of the bottom
# join below which the binary cascade's early filtering wins
MULTIWAY_MIN_SELECTIVITY = 0.02


def choose_join_mode(chain, catalog, override: str = "auto",
                     hbo: str = "off"):
    """(mode, why) for a collapsible left-deep join chain: ``mode`` ∈
    {binary, multiway}. ``chain`` is the eligible HashJoin list bottom-up
    (chain[0] probes the base); ``override`` is the ``join_mode`` session
    property. Mirrors choose_breaker_engine: ``hbo="correct"`` swaps the
    estimated build sizes and bottom-join selectivity for runstats history
    under the joins' structural fingerprints, and the why string carries
    the ``(hbo: observed)`` provenance suffix."""
    n = len(chain)
    if override == "multiway":
        return "multiway", f"session join_mode=multiway ({n} joins)"
    if override in ("binary", "off"):
        return "binary", f"session join_mode={override}"
    total_build = 0.0
    src, suffix = "est", ""
    n_observed = 0
    for j in chain:
        build_rows = None
        if hbo == "correct":
            h = _observed(j, catalog, "join_build")
            if h and h.get("actual"):
                build_rows = float(h["actual"])
                n_observed += 1
                src, suffix = "observed", " (hbo: observed)"
        if build_rows is None:
            build = derive(j.right, catalog)
            if build is None or not build.rows:
                return "binary", "no build-side stats"
            build_rows = build.rows
        if not j.build_unique and build_rows > MULTIWAY_MAX_FANOUT_BUILD_ROWS:
            return "binary", (f"{src} fanout build {build_rows:.3g} rows > "
                              f"{MULTIWAY_MAX_FANOUT_BUILD_ROWS}{suffix}")
        total_build += build_rows
    if total_build > MULTIWAY_MAX_BUILD_ROWS:
        return "binary", (f"{src} combined builds {total_build:.3g} rows > "
                          f"{MULTIWAY_MAX_BUILD_ROWS}{suffix}")
    if n_observed < n:
        # auto fuses only on observed history: a misestimated chain
        # compounds the error N ways and pays every build before the
        # first probe can filter, so estimates alone never flip the
        # plan shape — the binary run itself lands the history
        return "binary", (f"{n - n_observed}/{n} builds lack observed "
                          f"history — binary until hbo=correct repeat")
    sel = None
    sel_src, sel_suffix = "est", ""
    if hbo == "correct":
        h = _observed(chain[0], catalog, "join_probe_sel")
        if h and h.get("actual") is not None:
            sel = float(h["actual"])
            sel_src, sel_suffix = "observed", " (hbo: observed)"
            src, suffix = sel_src, sel_suffix
    if sel is None:
        probe = derive(chain[0].left, catalog)
        out = derive(chain[0], catalog)
        if probe is not None and out is not None and probe.rows:
            sel = out.rows / probe.rows
    if sel is not None and sel < MULTIWAY_MIN_SELECTIVITY and n > 2:
        # deep chain over a near-empty bottom join: the binary cascade
        # filters before paying the upper probes; multiway pays them all
        return "binary", (f"{sel_src} bottom-join selectivity {sel:.3g} < "
                          f"{MULTIWAY_MIN_SELECTIVITY}{sel_suffix}")
    selpart = f", sel {sel:.3g}" if sel is not None else ""
    return "multiway", (f"{n} joins, {src} combined builds "
                        f"{total_build:.3g} rows{selpart}{suffix}")
