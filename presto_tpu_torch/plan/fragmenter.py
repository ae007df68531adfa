"""Distributed planning: exchange insertion + plan fragmentation.

Reference: sql/planner/optimizations/AddExchanges.java:141 (decides
partitioned vs broadcast joins, splits aggregations into partial/final
around hash exchanges) and sql/planner/PlanFragmenter.java:153 (cuts the
plan at exchanges into PlanFragments with a PartitioningScheme each).

The JAX package's fragmenter (plan/fragmenter.py there), its imports
renamed: for the same plan it cuts the same fragments, which the codec
writes to the same JSON. A fragment runs as one task per worker (or one
task for SINGLE); its sink hash-partitions / broadcasts / gathers output
pages into per-consumer buffers pulled over HTTP (server/). Partitioning
vocabulary mirrors SystemPartitioningHandle.java:59-66: SOURCE,
FIXED_HASH, SINGLE on the fragment side; HASH / BROADCAST / GATHER on the
output side. The port keeps no run history, so the cut-time estimates are
the CBO's alone (the JAX package's `hbo="correct"` refinement comes with
history-based optimization, ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    HashJoin,
    Limit,
    Output,
    PlanNode,
    Project,
    QueryPlan,
    RemoteSource,
    SemiJoin,
    SetOp,
    Sort,
    TableScan,
    Window,
)

SOURCE = "source"       # leaf scans; splits assigned across tasks
HASH = "hash"           # one task per worker, rows owned by hash(keys) % n
SINGLE = "single"       # exactly one task
ARBITRARY = "arbitrary"  # one task per worker, rows owned by no key
                         # (round-robin redistributed — the reference's
                         # FIXED_ARBITRARY_DISTRIBUTION)

OUT_HASH = "hash"
OUT_GATHER = "gather"
OUT_BROADCAST = "broadcast"
OUT_RR = "rr"  # page-level round robin (ArbitraryOutputBuffer analog)


@dataclasses.dataclass
class Fragment:
    fid: int
    root: PlanNode
    partitioning: str              # SOURCE | HASH | SINGLE
    output_partitioning: str       # OUT_HASH | OUT_GATHER | OUT_BROADCAST
    output_keys: List[str] = dataclasses.field(default_factory=list)
    # the consumer breaker radix-partitions on output_keys (join/agg): the
    # sink may additionally tag each page with its radix id so the consumer
    # skips the device re-partition sort (partition-aligned exchange)
    radix_align: bool = False
    # CBO estimates of the fragment's OUTPUT, stamped at cut time
    # (plan/stats.derive)
    est_rows: Optional[float] = None
    est_key_ndv: Optional[float] = None

    def remote_sources(self) -> List[RemoteSource]:
        out = []

        def walk(n: PlanNode):
            if isinstance(n, RemoteSource):
                out.append(n)
            for c in n.children():
                walk(c)

        walk(self.root)
        return out


@dataclasses.dataclass
class DistributedPlan:
    fragments: Dict[int, Fragment]
    root_fid: int
    output_names: List[str]

    def to_string(self, node_stats=None) -> str:
        from presto_tpu_torch.plan.nodes import plan_to_string

        parts = []
        for fid in sorted(self.fragments):
            f = self.fragments[fid]
            head = f"Fragment {fid} [{f.partitioning}] → {f.output_partitioning}"
            if f.output_keys:
                head += f"({', '.join(f.output_keys)})"
            if f.radix_align:
                head += " radix_align"
            if f.est_rows is not None:
                head += f" ~rows={f.est_rows:.3g}"
            parts.append(head + "\n"
                         + plan_to_string(f.root, 1, node_stats=node_stats))
        return "\n".join(parts)


def scan_bucketing(node, catalog):
    """Resolve a scan-chain subtree (Filter/Project over TableScan,
    projects restricted to pure renames) to its table's bucketing:
    returns (symbol→bucket-position map, count, n_bucket_cols) or None.
    Nested colocated joins extend the chain: a join already marked
    colocated with the same spec exposes its probe side's mapping."""
    from presto_tpu_torch.expr.ir import InputRef

    rename: dict = {}
    cur = node
    while True:
        if isinstance(cur, Filter):
            cur = cur.child
            continue
        if isinstance(cur, Project):
            nxt = {}
            for sym, e in cur.exprs:
                if isinstance(e, InputRef):
                    nxt[sym] = e.name
                # computed columns can't be bucket keys but don't
                # disqualify the chain
            cur = cur.child
            rename = {s: rename.get(c, c) for s, c in nxt.items()} \
                if rename else nxt
            continue
        break
    if isinstance(cur, HashJoin) and cur.colocated:
        inner = scan_bucketing(cur.left, catalog)
        if inner is None:
            return None
        pos, count, nb = inner
        if rename:
            pos = {s: pos[c] for s, c in rename.items() if c in pos}
        return (pos, count, nb) if pos else None
    if not isinstance(cur, TableScan):
        return None
    if catalog is None:
        return None
    try:
        handle = catalog.connectors[cur.catalog].get_table(cur.table)
    except Exception:
        return None
    if handle.bucketing is None:
        return None
    bcols, count = handle.bucketing
    col_pos = {c: i for i, c in enumerate(bcols)}
    pos = {}
    for sym, col in cur.assignments.items():
        if col in col_pos:
            pos[sym] = col_pos[col]
    if len(pos) != len(bcols):
        return None
    if rename:
        pos = {s: pos[c] for s, c in rename.items() if c in pos}
    return (pos, count, len(bcols)) if pos else None


def colocated_buckets(node, catalog) -> int:
    """Bucket count when this join can run colocated: both sides'
    tables bucketed with equal counts, and for EVERY bucket-key
    position there is a join equi-pair mapping to it on BOTH sides
    (HiveBucketing: same hash + same count ⇒ same bucket)."""
    lb = scan_bucketing(node.left, catalog)
    rb = scan_bucketing(node.right, catalog)
    if lb is None or rb is None:
        return 0
    (lpos, lcount, lnb), (rpos, rcount, rnb) = lb, rb
    if lcount != rcount or lnb != rnb:
        return 0
    covered = set()
    for lk, rk in zip(node.left_keys, node.right_keys):
        pl, pr = lpos.get(lk), rpos.get(rk)
        if pl is not None and pl == pr:
            covered.add(pl)
    return lcount if covered == set(range(lnb)) else 0


def tag_colocated_joins(node: PlanNode, catalog) -> None:
    """Mark bucket-colocated joins on a plan executed WITHOUT fragmentation
    (LocalRunner / a single-task fragment): the GroupedExecutionTagger
    analog for local execution. Bottom-up so nested colocated joins chain.
    The runtime's lifespan sweep (exec/runtime._execute_join /
    _execute_aggregate) then drives these bucket-by-bucket, bounding peak
    memory to one bucket's build side."""
    for c in node.children():
        tag_colocated_joins(c, catalog)
    if isinstance(node, HashJoin) and not node.colocated:
        node.colocated = colocated_buckets(node, catalog)


class _Fragmenter:
    def _scan_bucketing(self, node):
        return scan_bucketing(node, self.catalog)

    def _colocated_buckets(self, node) -> int:
        return colocated_buckets(node, self.catalog)

    def __init__(self, catalog, broadcast_threshold_rows: float,
                 stats_fn=None):
        self.fragments: Dict[int, Fragment] = {}
        self._next = 0
        self.catalog = catalog
        self.broadcast_threshold = broadcast_threshold_rows
        # optional row-count estimator (CBO hook): node -> Optional[float]
        if stats_fn is None:
            def stats_fn(n, _catalog=catalog):
                # CBO-derived estimate (StatsCalculator analog); the legacy
                # fixed-selectivity walk is the no-statistics fallback
                from presto_tpu_torch.plan.stats import derive

                s = derive(n, _catalog)
                if s is not None:
                    return s.rows
                return estimate_rows(n, _catalog)
        self.stats_fn = stats_fn

    def cut(self, root: PlanNode, partitioning: str,
            out_part: str, keys: Optional[List[str]] = None,
            radix_align: bool = False) -> RemoteSource:
        fid = self._next
        self._next += 1
        try:
            from presto_tpu_torch.plan.stats import combined_key_ndv, derive

            st = derive(root, self.catalog)
        except Exception:
            st = None
        frag = Fragment(fid, root, partitioning, out_part,
                        list(keys or []), radix_align=radix_align)
        if st is not None:
            frag.est_rows = st.rows
            if keys:
                frag.est_key_ndv = combined_key_ndv(st, keys)
        self.fragments[fid] = frag
        rs = RemoteSource(fid, list(root.output))
        # a cut is transparent to stats: stamping the producing fragment's
        # estimate as the RemoteSource's memo lets downstream derivations
        # (final-agg capacity, breaker engine choice, consumer exchange
        # sizing) see through the fragment boundary instead of derive()'s
        # None-on-RemoteSource. strip_runtime_state removes it before the
        # wire, and codec never serializes underscore state.
        rs.__dict__["_node_stats"] = st
        return rs

    # returns (node-in-current-fragment, partitioning of current fragment)
    def process(self, node: PlanNode) -> Tuple[PlanNode, str]:
        if isinstance(node, TableScan):
            return node, SOURCE
        if isinstance(node, Filter):
            node.child, p = self.process(node.child)
            return node, p
        if isinstance(node, Project):
            node.child, p = self.process(node.child)
            return node, p
        if isinstance(node, Aggregate):
            from presto_tpu_torch.plan.agg_states import is_decomposable

            child, cpart = self.process(node.child)
            if cpart == SINGLE:
                # already on one task — no exchange needed
                node.child = child
                return node, SINGLE
            if not is_decomposable(node.aggs):
                # order-dependent states (approx_percentile / max_by / min_by)
                # have no mergeable partial form: gather raw rows to one task
                node.child = self.cut(child, cpart, OUT_GATHER)
                return node, SINGLE
            partial = Aggregate(child, node.group_keys, node.aggs, step="partial")
            if node.group_keys:
                rs = self.cut(partial, cpart, OUT_HASH, node.group_keys,
                              radix_align=True)
                final = Aggregate(rs, node.group_keys, node.aggs, step="final")
                return final, HASH
            rs = self.cut(partial, cpart, OUT_GATHER)
            final = Aggregate(rs, [], node.aggs, step="final")
            return final, SINGLE
        if isinstance(node, HashJoin):
            # colocated bucketed join first (GroupedExecutionTagger +
            # ConnectorNodePartitioningProvider): both sides scan tables
            # bucketed on the join keys with the same count — no exchange,
            # the runtime drives the join bucket-by-bucket (lifespans)
            # estimate BEFORE fragmenting the build side: process() splices
            # RemoteSources into the subtree, which would blind the estimator
            build_rows = self.stats_fn(node.right)
            cob = self._colocated_buckets(node)
            left, lpart = self.process(node.left)
            right, rpart = self.process(node.right)
            if cob and lpart == SOURCE and rpart == SOURCE:
                node.left, node.right = left, right
                node.colocated = cob
                return node, SOURCE
            if (build_rows is not None
                    and build_rows <= self.broadcast_threshold
                    and node.kind != "full"):
                # BROADCAST join (DetermineJoinDistributionType REPLICATED):
                # build side is replicated to every probe task. FULL OUTER
                # must NOT broadcast — every task would re-emit the same
                # unmatched build rows; hash partitioning gives each build
                # row exactly one owner (LookupJoinOperators.fullOuterJoin
                # is likewise partitioned-only in the reference)
                if rpart == SINGLE and lpart == SINGLE:
                    node.left, node.right = left, right
                    return node, SINGLE
                node.left = left
                node.right = self.cut(right, rpart, OUT_BROADCAST)
                return node, lpart
            # PARTITIONED join: co-locate both sides by hash(join keys)
            node.left = self.cut(left, lpart, OUT_HASH, node.left_keys,
                                 radix_align=True)
            node.right = self.cut(right, rpart, OUT_HASH, node.right_keys,
                                  radix_align=True)
            return node, HASH
        from presto_tpu_torch.plan.nodes import MultiwayJoin

        if isinstance(node, MultiwayJoin):
            # the probe pipeline keeps its partitioning; every build table is
            # replicated to each probe task (the collapse pass only fuses
            # chains whose build sides are broadcast-sized, so REPLICATED is
            # always the right distribution here). SINGLE/SINGLE needs no cut.
            probe, ppart = self.process(node.probe)
            node.probe = probe
            new_builds = []
            for b in node.builds:
                rb, rpart = self.process(b)
                if rpart == SINGLE and ppart == SINGLE:
                    new_builds.append(rb)
                else:
                    new_builds.append(self.cut(rb, rpart, OUT_BROADCAST))
            node.builds = new_builds
            return node, ppart
        if isinstance(node, SemiJoin):
            left, lpart = self.process(node.left)
            right, rpart = self.process(node.right)
            node.left = left
            if rpart == SINGLE and lpart == SINGLE:
                node.right = right
                return node, SINGLE
            node.right = self.cut(right, rpart, OUT_BROADCAST)
            return node, lpart
        from presto_tpu_torch.plan.nodes import IndexJoin, NestedLoopJoin

        if isinstance(node, IndexJoin):
            # the index side is a connector keyed lookup, available on any
            # worker — the probe keeps its partitioning, no exchange
            node.left, p = self.process(node.left)
            return node, p

        if isinstance(node, NestedLoopJoin):
            # probe keeps its partitioning; the build is replicated
            # (NestedLoopBuildOperator is broadcast-only in the reference)
            left, lpart = self.process(node.left)
            right, rpart = self.process(node.right)
            node.left = left
            if rpart == SINGLE and lpart == SINGLE:
                node.right = right
                return node, SINGLE
            node.right = self.cut(right, rpart, OUT_BROADCAST)
            return node, lpart
        if isinstance(node, Window):
            child, cpart = self.process(node.child)
            if cpart == SINGLE:
                node.child = child
                return node, SINGLE
            if node.partition_keys:
                node.child = self.cut(child, cpart, OUT_HASH, node.partition_keys)
                return node, HASH
            node.child = self.cut(child, cpart, OUT_GATHER)
            return node, SINGLE
        if isinstance(node, Sort):
            child, cpart = self.process(node.child)
            if cpart == SINGLE:
                node.child = child
                return node, SINGLE
            if node.limit is not None:
                # distributed TopN: partial TopN per task, merge at gather
                partial = Sort(child, node.keys, node.limit)
                node.child = self.cut(partial, cpart, OUT_GATHER)
                return node, SINGLE
            # distributed sort: partial sort per task + final merge
            # (admin/dist-sort.rst); final re-sort on gathered runs
            node.child = self.cut(Sort(child, node.keys), cpart, OUT_GATHER)
            return node, SINGLE
        if isinstance(node, Limit):
            child, cpart = self.process(node.child)
            if cpart == SINGLE:
                node.child = child
                return node, SINGLE
            partial = Limit(child, node.count)
            node.child = self.cut(partial, cpart, OUT_GATHER)
            return node, SINGLE
        if isinstance(node, SetOp):
            left, lpart = self.process(node.left)
            right, rpart = self.process(node.right)
            if node.kind == "union" and node.all and not (
                    lpart == SINGLE and rpart == SINGLE):
                # UNION ALL streams: children round-robin pages across the
                # union fragment's tasks (FIXED_ARBITRARY distribution) —
                # no gather bottleneck, downstream partials run per task
                node.left = self.cut(left, lpart, OUT_RR)
                node.right = self.cut(right, rpart, OUT_RR)
                return node, ARBITRARY
            # DISTINCT variants need global visibility: gather
            node.left = left if lpart == SINGLE else self.cut(left, lpart, OUT_GATHER)
            node.right = (right if rpart == SINGLE
                          else self.cut(right, rpart, OUT_GATHER))
            return node, SINGLE
        if isinstance(node, Output):
            # nested Output (set-operation children are whole sub-plans):
            # keep the projection wrapper, fragment through it
            child, cpart = self.process(node.child)
            node.child = child
            return node, cpart
        if isinstance(node, RemoteSource):
            return node, SINGLE
        from presto_tpu_torch.plan.nodes import OneRow, TableWriter, Unnest

        if isinstance(node, Unnest):
            # streaming row expansion: stays in its child's fragment
            node.child, p = self.process(node.child)
            return node, p
        if isinstance(node, TableWriter):
            # scaled writers: the writer rides its child's partitioning —
            # every task writes its own part (SCALED_WRITER_DISTRIBUTION)
            node.child, p = self.process(node.child)
            return node, p
        if isinstance(node, OneRow):
            return node, SINGLE
        from presto_tpu_torch.plan.nodes import HostProject

        if isinstance(node, HostProject):
            # host finishing projection: runs where the rows materialize —
            # the single root task
            child, cpart = self.process(node.child)
            if cpart == SINGLE:
                node.child = child
                return node, SINGLE
            node.child = self.cut(child, cpart, OUT_GATHER)
            return node, SINGLE
        raise NotImplementedError(f"fragmenter: {type(node).__name__}")


def estimate_rows(node: PlanNode, catalog=None) -> Optional[float]:
    """Build-size estimate for join distribution choice. Replaced by the
    cost-based StatsCalculator when table statistics are available."""
    if isinstance(node, TableScan):
        if catalog is None:
            return None
        try:
            conn = catalog.connectors[node.catalog]
            return float(conn.get_table(node.table).row_count or 1e6)
        except Exception:
            return None
    if isinstance(node, Filter):
        r = estimate_rows(node.child, catalog)
        return None if r is None else r * 0.25
    if isinstance(node, Project):
        return estimate_rows(node.child, catalog)
    if isinstance(node, Aggregate):
        r = estimate_rows(node.child, catalog)
        return None if r is None else max(1.0, r * 0.1)
    if isinstance(node, (Sort, Window)):
        if isinstance(node, Sort) and node.limit is not None:
            return float(node.limit)
        return estimate_rows(node.child, catalog)
    if isinstance(node, Limit):
        return float(node.count)
    if isinstance(node, HashJoin):
        return estimate_rows(node.left, catalog)
    if isinstance(node, SemiJoin):
        return estimate_rows(node.left, catalog)
    if isinstance(node, SetOp):
        a = estimate_rows(node.left, catalog)
        b = estimate_rows(node.right, catalog)
        if a is None or b is None:
            return None
        return a + b
    return None


def fragment_plan(plan: QueryPlan, catalog=None,
                  broadcast_threshold_rows: float = 1_000_000,
                  stats_fn=None) -> DistributedPlan:
    """Cut an optimized single-node plan into a distributed fragment DAG.

    Scalar subqueries must have been bound first (the coordinator executes
    them before fragmenting, like the reference runs them as separate
    stages feeding semi-join/filter constants).
    """
    f = _Fragmenter(catalog, broadcast_threshold_rows, stats_fn)
    out = plan.root
    child, cpart = f.process(out.child)
    if cpart != SINGLE:
        child = f.cut(child, cpart, OUT_GATHER)
    root = Output(child, out.names, out.symbols)
    fid = f._next
    f.fragments[fid] = Fragment(fid, root, SINGLE, OUT_GATHER, [])
    return DistributedPlan(f.fragments, fid, list(out.names))


def strip_runtime_state(node: PlanNode):
    """Remove runtime state before pickling a fragment for the wire.

    Anything underscore-prefixed in a node's instance dict is runtime-only
    by convention (`_jit_cache` / `_jit_stats` memos, `_collapsed`,
    `_probe_shim`, `_node_stats`, ...) — no declared plan field starts
    with an underscore, so popping the prefix wholesale keeps the wire
    image equal to the logical plan. plan/codec.py enforces the same
    contract structurally (only declared fields serialize)."""
    for key in [k for k in node.__dict__ if k.startswith("_")]:
        node.__dict__.pop(key, None)
    for c in node.children():
        strip_runtime_state(c)
