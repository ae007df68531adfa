"""Plan execution: pull-based streams of fixed-capacity batches.

The counterpart of the JAX package's exec/runtime.py on its per-batch path
(`fragment_fusion=False`, which that package keeps bit-identical to its
fused default). Every node executes to an iterator of Batches on the
context's device; Filter/Project chains collapse into one function that a
breaker (aggregate, join, sort) applies to each input batch. Execution is
eager: there is no program cache, no whole-fragment fusion and no
optimistic dispatch window — an aggregate confirms its group count on the
host after every merge and replays that merge at a larger capacity on
overflow.

Operators: TableScan (also with no column read), OneRow (SELECT without
FROM, VALUES), Filter, Project, HostProject (cast to varchar and
date_format, formatted on the host at the query root), Aggregate (single,
partial and final steps; sum, avg, count, count(*), count_if, min, max, arbitrary,
bool_and/bool_or, checksum, geometric_mean, the variance family,
covar_pop/covar_samp/corr, and none for DISTINCT; global, small-domain,
sort- and hash-engine grouping; count/sum/avg DISTINCT beside other
aggregates, max_by/min_by and approx_percentile over the materialized
input, sorted once; approx_distinct is the planner's HyperLogLog lowering
onto these; array_agg and map_agg grouped on the device, numeric_histogram,
tdigest_agg, approx_set and merge built per group on the host from the
device's sorted groups), HashJoin (inner, left and full; sort and hash
engines), IndexJoin (a connector lookup a probe batch, joined by the
same prober), SemiJoin (semi, anti, null-aware NOT IN, residual EXISTS),
NestedLoopJoin (cross and non-equi inner joins), Unnest [WITH
ORDINALITY], SetOp (UNION [ALL], INTERSECT [ALL], EXCEPT [ALL]; with it
GROUPING SETS, ROLLUP and CUBE, which the planner lowers to UNION ALL),
Window, Sort and TopN, Limit, Output, and uncorrelated scalar subqueries
bound as constants, MultiwayJoin (plan/multiway.py's N-ary join), and in
a distributed task RemoteSource (pages pulled through the exchange,
`ctx.remote_sources`) and TableWriter (a scaled writer's part). A join of
two tables bucketed alike on its keys (`HashJoin.colocated`) runs bucket
by bucket (grouped execution: `ctx.lifespan`), and so does an
aggregation whose keys cover such a join's.
ARRAY and MAP columns ride through every operator with their planes
(batch.Column). Anything else raises NotImplementedError naming it.
Statements other than queries run in exec/runner.py.

Memory-bounded execution follows the JAX package's rules: operators
account their resident state in the context's memory pool (memory.py),
and past its revoke threshold an aggregation or a join build spills to
host files (spiller.py). A keyed aggregation whose presize passes
`agg_cap_ceiling` goes GRACE: its raw input hash-partitions to spill and
each partition merges on its own, splitting again by the next hash bits
when it still outgrows the ceiling. `radix_partitions` splits joins and
high-NDV group-bys by the top hash bits (ops/radix.py). Not yet here:
adaptive execution and history-based correction.

Observability (obs/) hooks in at the JAX package's sites: every operator
stream gets a span (`_traced`, host time only: no device sync) and, for
EXPLAIN ANALYZE, per-batch stats (`_instrumented`, which syncs); the
breakers stamp their engine verdict and replay, spill and cascade
markers; HBO observes estimate against actual at the aggregate, join and
spill sites. A count the port holds only on the device is read where it
already reads the host: an aggregate's group count at its merge, a
join's build and probe counts once at the query's end
(`ExecContext.flush_observations`).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import queue
import threading
import time
from types import SimpleNamespace
from typing import (
    Callable,
    Dict,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Tuple,
)

import numpy as np
import torch

from presto_tpu_torch.batch import (
    Batch,
    Column,
    carry_dicts,
    concat_columns,
    dict_names,
    dict_owner,
    empty_batch,
    key_dict_name,
    pad_plane_width,
    round_up_capacity,
    slice_column,
)
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.expr.compile import (
    compile_expr,
    compile_predicate,
    unscale,
)
from presto_tpu_torch.expr.ir import (
    Call,
    Constant,
    InputRef,
    substitute_params,
)
from presto_tpu_torch.expr.structural import StructVal
from presto_tpu_torch.memory import (
    LocalMemoryContext,
    MemoryPool,
    batch_device_bytes,
)
from presto_tpu_torch.ops.grouping import (
    KeyCol,
    StateCol,
    _minmax_identity,
    grouped_merge,
)
from presto_tpu_torch.ops.join import (
    MwSpec,
    align_probe_strings,
    build_side,
    gather_join_output,
    hash_build_side,
    hash_probe_counts,
    hash_probe_expand,
    hash_probe_unique,
    join_compare_dtypes,
    multiway_counts,
    multiway_expand,
    multiway_probe_unique,
    probe_counts,
    probe_expand,
    probe_unique,
)
from presto_tpu_torch.ops.radix import (
    radix_bits,
    radix_perm,
    radix_window_perm,
)
from presto_tpu_torch.ops.sort import (
    SortKey,
    compact,
    lex_sort_permutation,
    limit_batch,
    permute_batch,
    sort_batch,
    sort_permutation,
)
from presto_tpu_torch.plan.agg_states import (
    agg_state_layout,
    limb_pairs,
    state_types as _layout_state_types,
    sum_state_type,
)
from presto_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    HashJoin,
    HostProject,
    IndexJoin,
    Limit,
    MultiwayJoin,
    NestedLoopJoin,
    OneRow,
    Output,
    PlanNode,
    Project,
    QueryPlan,
    RemoteSource,
    SemiJoin,
    SetOp,
    Sort,
    TableScan,
    TableWriter,
    Unnest,
    Window,
)
from presto_tpu_torch.obs import devprof as _devprof
from presto_tpu_torch.obs import metrics as _obs_metrics
from presto_tpu_torch.obs import runstats as _runstats
from presto_tpu_torch.obs import trace as _obs_trace
from presto_tpu_torch.scan import metrics as _scan_metrics
from presto_tpu_torch.scan.adaptive import AdaptiveFilterOrder
from presto_tpu_torch.scan.filters import filters_from_constraints
from presto_tpu_torch.spiller import (
    SpillFile,
    SpillLimitExceeded,
    SpillManager,
)
from presto_tpu_torch.types import (
    BIGINT,
    VARCHAR,
    DecimalType,
    Type,
    torch_dtype,
)


@dataclasses.dataclass
class ExecConfig:
    """Session knobs (reference: SystemSessionProperties), with the JAX
    package's defaults."""

    batch_rows: int = 1 << 17  # rows per scan batch
    agg_capacity: int = 1 << 12  # initial group-table capacity
    # Past this group-table capacity a keyed aggregation goes GRACE: its
    # raw input hash-partitions to spill and each partition merges at a
    # small capacity (with spill disabled the table grows by replay)
    agg_cap_ceiling: int = 1 << 17
    # coalesce sparse join output batches before downstream operators
    # (MergingPageOutput analog; see _merging_output)
    merge_sparse_output: bool = True
    max_growth_retries: int = 24
    # EXPLAIN ANALYZE: per-operator wall/rows/batches accounting (forces a
    # device sync per batch — off in production, like Presto's verbose
    # stats)
    collect_stats: bool = False
    # query-lifecycle span tracing (obs/trace.py): operator, host_decode,
    # device_transfer, exchange_wait spans. Cheap enough to stay on (no
    # device sync: an operator span's wall is host time, which on the card
    # is kernel enqueue time); False makes every span site a single
    # attribute check on the NOOP tracer
    tracing: bool = True
    # history-based optimization (obs/runstats.py): "observe" (default)
    # records estimate-vs-actual drift at every stats-driven decision site
    # keyed on structural fingerprints; "off" is a strict no-op. The JAX
    # package's "correct" waits for ROADMAP item 12
    hbo: str = "observe"
    # device memory accounting plane (obs/devprof.py): "on" samples the
    # card's allocator watermark at query boundaries and reconciles it
    # against the MemoryPool ledger; "off" (default) is a strict no-op
    devprof: str = "off"
    # on-demand torch.profiler capture for this query, a Chrome trace
    # under PRESTO_TPU_CACHE_DIR (no-op with a warning without it)
    profile: bool = False
    # serving-plane SLO telemetry (obs/lifecycle.py): "on" makes worker
    # task sinks count emitted rows/batches so heartbeats carry live query
    # progress; "off" is a strict no-op
    lifecycle: str = "on"
    # mid-flight telemetry plane (obs/inflight.py): "on" makes operators
    # publish host-held watermarks (rows, replays, spill depth) into the
    # per-query inflight store; "off" (default) is a strict no-op
    inflight: str = "off"
    # stall detector bound: row watermarks frozen for this many seconds
    # while the query executes → stall_detected event + forensics dump
    stall_threshold_s: float = 2.0
    # straggler detector bound: a fragment site > factor x behind its
    # siblings' window watermark → straggler_detected event + slow-log doc
    straggler_factor: float = 4.0
    # memory pool and spill (memory.py, spiller.py; None = unlimited)
    memory_pool_bytes: Optional[int] = None
    spill_enabled: bool = True
    spill_dir: Optional[str] = None
    spill_partitions: int = 8
    # how many times a spill partition may split by the next hash bits,
    # mid-build past its byte budget or at replay (recursive
    # repartitioning); past it the query fails with SpillLimitExceeded
    spill_max_depth: int = 4
    # the spill directory's byte budget (None = unlimited)
    spill_dir_budget_bytes: Optional[int] = None
    memory_revoking_threshold: float = 0.9
    memory_revoking_target: float = 0.5
    # radix partitioning of joins and keyed aggregations (ops/radix.py):
    # a power of two; 0/1 = off
    radix_partitions: int = 0
    # hybrid spill: a radix partition whose build side (or group table)
    # passes this many bytes goes to host files and is processed after
    # the resident ones; also the replay budget of a spilled join
    # partition. None = never
    join_spill_budget_bytes: Optional[int] = None
    # "auto": the CBO (plan/stats.choose_breaker_engine) picks per
    # breaker; "sort" / "hash" force one engine everywhere
    breaker_engine: str = "auto"
    # multiway join collapse (plan/multiway.py): "auto" lets the CBO
    # (plan/stats.choose_join_mode) decide, "multiway" forces every
    # eligible chain, "binary" runs the pass and always declines, "off"
    # skips it
    join_mode: str = "auto"
    # Aria selective scan (scan/): constrained scans on connectors with a
    # read_split_selective path filter rows during host decode and upload
    # only survivors. Off → decode everything and filter on the device
    selective_scan: bool = True
    # background split prefetch depth: a host thread decodes and uploads
    # splits i+1..i+depth while the device computes split i. 0 disables
    scan_prefetch: int = 2
    # query-level elastic retry (the reference's RetryPolicy.QUERY): on a
    # failed or unreachable worker the coordinator re-probes the cluster,
    # drops dead nodes and runs the whole query again this many times
    query_retry_count: int = 1
    # stage scheduling (AllAtOnceExecutionPolicy / PhasedExecutionSchedule):
    # "phased" starts probe-side stages only once their join builds finish
    execution_policy: str = "all-at-once"
    # a colocated-join fragment runs one task a lifespan (bucket) in a
    # gated phase; a worker lost mid-phase re-runs only its unfinished
    # buckets on the survivors
    recoverable_grouped_execution: bool = False
    # phased mode: how long one build phase may run before the query fails
    phase_wait_timeout_s: float = 600.0
    # coordinator-side split placement by rendezvous hash (soft affinity):
    # a split lands on the same worker across queries. Off → static
    # task_index::n_tasks striding
    split_affinity: bool = True


class ExecContext:
    def __init__(self, catalog: Catalog, config: ExecConfig,
                 device: torch.device, memory_pool: Optional[MemoryPool] = None,
                 spill_manager: Optional[SpillManager] = None):
        self.catalog = catalog
        self.config = config
        self.device = device
        self.stats: Dict[str, float] = {}
        # distributed task context (set by the worker; LocalRunner keeps
        # one task): without an assignment this task reads
        # splits[task_index::n_tasks] of every scanned table
        self.task_index: int = 0
        self.n_tasks: int = 1
        # coordinator-assigned split ordinals per table (soft affinity),
        # with the coordinator's enumeration count per table: a mismatch
        # at scan time means the table changed underneath the plan
        self.split_assignment: Optional[Dict[str, List[int]]] = None
        self.split_counts: Optional[Dict[str, int]] = None
        # grouped (lifespan) execution: scans of bucketed tables read only
        # this bucket's splits while a colocated join or its aggregation
        # sweeps the task's buckets; `lifespans` is the sweep's bucket count
        self.lifespan: Optional[int] = None
        self.lifespans: Optional[int] = None
        # fragment_id -> iterator of the batches pulled from the exchange
        self.remote_sources: Optional[Callable[[int], Iterator[Batch]]] = None
        # a worker shares its pool and spill manager between its tasks
        self.memory_pool = memory_pool or MemoryPool(
            config.memory_pool_bytes,
            revoke_threshold=config.memory_revoking_threshold,
            revoke_target=config.memory_revoking_target)
        self.spill_manager = spill_manager or SpillManager(
            config.spill_dir, config.spill_dir_budget_bytes)
        if (config.spill_dir_budget_bytes is not None
                and self.spill_manager.budget_bytes is None):
            self.spill_manager.budget_bytes = config.spill_dir_budget_bytes
        # every spiller and spill file an operator opens, so teardown can
        # close and unlink them even when the operator died mid-spill
        self.spill_resources: List = []
        # per-plan-node OperatorStats analog (keyed by id(node)):
        # {"rows", "batches", "wall_s", "bytes"} — collect_stats runs only
        self.node_stats: Dict[int, Dict[str, float]] = {}
        # span tracer (obs/trace.py): NOOP unless the LocalRunner or a
        # worker task installs a real one
        self.tracer = _obs_trace.NOOP
        # mid-flight telemetry publisher (obs/inflight.TaskInflight), set
        # by a worker task when the `inflight` property is on
        self.inflight = None
        # HBO observations whose counts are still device scalars:
        # (callback, tensors), read together by flush_observations
        self.pending_obs: List[Tuple[Callable, List[torch.Tensor]]] = []

    def record(self, node, rows: int, wall_s: float, bytes_: int = 0):
        s = self.node_stats.setdefault(
            id(node), {"rows": 0, "batches": 0, "wall_s": 0.0, "bytes": 0})
        s["rows"] += rows
        s["batches"] += 1
        s["wall_s"] += wall_s
        s["bytes"] += bytes_

    def defer_observation(self, fn: Callable, *counts: torch.Tensor) -> None:
        """Call fn(*floats) with these device counts once they are read
        (flush_observations); nothing reads them now."""
        self.pending_obs.append((fn, list(counts)))

    def flush_observations(self) -> None:
        """Read every deferred count in one host copy and run its
        observation. Called where the query's device work is already
        being read (the end of run_plan, a task's sink), so the copy
        waits for nothing the caller would not wait for."""
        pending, self.pending_obs = self.pending_obs, []
        if not pending:
            return
        flat = [t.reshape(()).to(torch.float64) for _, ts in pending
                for t in ts]
        vals = torch.stack(flat).tolist()
        i = 0
        for fn, ts in pending:
            fn(*vals[i:i + len(ts)])
            i += len(ts)

    def bump(self, key: str, delta: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + delta

    def track_spill(self, resource) -> None:
        self.spill_resources.append(resource)

    def cleanup_spill(self) -> None:
        """Leak guard: close (and unlink) every spill resource this context
        opened. Idempotent, and safe after the operators' own closes."""
        for r in self.spill_resources:
            r.close()
        self.spill_resources = []

    def should_spill(self, projected_delta_bytes: int) -> bool:
        """Would reserving this many more bytes cross the revoke
        threshold?"""
        pool = self.memory_pool
        if pool.limit is None or not self.config.spill_enabled:
            return False
        return (pool.reserved + projected_delta_bytes
                > pool.limit * pool.revoke_threshold)


# ---------------------------------------------------------------------------
# stateless chain collapse


def collapse_chain(node: PlanNode) -> Tuple[PlanNode, Optional[Callable[[Batch], Batch]]]:
    """Peel Filter/Project off `node` until a breaker; return (base, fn)
    where fn applies the whole chain to a batch of base's output. Memoized
    per node, so a cached plan reuses the compiled expressions."""
    memo = node.__dict__.get("_collapsed")
    if memo is not None:
        return memo
    steps: List[Callable[[Batch], Batch]] = []
    cur = node
    while True:
        if isinstance(cur, Filter):
            pred = compile_predicate(cur.predicate)

            def step(b: Batch, pred=pred) -> Batch:
                return b.with_live(b.live & pred(b))

            steps.append(step)
            cur = cur.child
        elif isinstance(cur, Project):
            compiled = [(s, e.type, compile_expr(e), e) for s, e in cur.exprs]
            steps.append(lambda b, compiled=compiled: _project(b, compiled))
            cur = cur.child
        else:
            break
    if not steps:
        result = (cur, None)
    else:
        steps.reverse()

        def chain(b: Batch) -> Batch:
            for s in steps:
                b = s(b)
            return b

        result = (cur, chain)
    node.__dict__["_collapsed"] = result
    return result


def _project(b: Batch, compiled) -> Batch:
    names, types, cols = [], [], []
    dicts = {}
    for s, t, fn, e in compiled:
        names.append(s)
        types.append(t)
        if isinstance(e, InputRef):
            # identity projection reuses the column object (keeps the
            # long-decimal limb a re-evaluation would truncate)
            cols.append(b.column(e.name))
            carry_dicts(b.dicts, dicts, e.name, s)
            continue
        v, valid = fn(b)
        if isinstance(v, StructVal):
            # an ARRAY or MAP value: its planes, and the element and key
            # dictionaries it resolves to
            cols.append(Column(
                v.values.contiguous(), valid, None, v.sizes.contiguous(),
                None if v.evalid is None else v.evalid.contiguous(),
                None if v.keys is None else v.keys.contiguous()))
            ed, kd = fn.sdicts(b)
            if ed is not None:
                dicts[s] = ed
            if kd is not None:
                dicts[key_dict_name(s)] = kd
            continue
        v = torch.broadcast_to(v, (b.capacity,)).to(torch_dtype(t.dtype))
        if valid is not None:
            valid = torch.broadcast_to(valid, (b.capacity,))
        cols.append(Column(v.contiguous(), None if valid is None
                           else valid.contiguous()))
        # a computed string column carries its own dictionary
        dyn_dict = getattr(fn, "dyn_dict", None)
        if dyn_dict is not None:
            d = dyn_dict(b)
            if d is not None:
                dicts[s] = d
    return Batch(names, types, cols, b.live, dicts)


# ---------------------------------------------------------------------------
# node executors


# operators whose output batches can be sparse: their consumers see them
# coalesced (MergingPageOutput analog), the JAX package's set
_SPARSE_OUTPUT = (HashJoin, MultiwayJoin, SemiJoin, IndexJoin,
                  NestedLoopJoin)


def execute_node(node: PlanNode, ctx: ExecContext) -> Iterator[Batch]:
    """Execute a plan node to a stream of batches; a Filter/Project chain
    on top of a breaker applies per output batch."""
    base, down = collapse_chain(node)
    stream = _execute_base(base, ctx)
    if ctx.config.collect_stats:
        stream = _instrumented(stream, base, ctx)
    if ctx.tracer.enabled:
        stream = _traced(stream, base, ctx)
    if down is not None:
        stream = (down(b) for b in stream)
    if ctx.config.merge_sparse_output and isinstance(base, _SPARSE_OUTPUT):
        stream = _merging_output(stream, ctx.config.batch_rows)
    yield from stream


def _fused_child(node: PlanNode, ctx: ExecContext):
    """(raw input stream, chain to apply to each batch) for a breaker's
    child — the ScanFilterAndProject fusion point."""
    base, up = collapse_chain(node)
    stream = _execute_base(base, ctx)
    if ctx.config.collect_stats:
        stream = _instrumented(stream, base, ctx)
    if ctx.tracer.enabled:
        stream = _traced(stream, base, ctx)
    if ctx.config.merge_sparse_output and isinstance(base, _SPARSE_OUTPUT):
        stream = _merging_output(stream, ctx.config.batch_rows)
    return stream, (up or (lambda b: b))


def _instrumented(stream: Iterator[Batch], node: PlanNode, ctx: ExecContext):
    """OperatorStats collection (reference: OperationTimer stamping every
    addInput/getOutput into OperatorStats, Driver.java:277). Reads each
    batch's live count on the host: a device sync per batch, which is
    why only EXPLAIN ANALYZE (collect_stats) runs it."""
    while True:
        t0 = time.perf_counter()
        try:
            b = next(stream)
        except StopIteration:
            return
        rows = b.num_live()  # forces a device sync
        ctx.record(node, rows, time.perf_counter() - t0,
                   bytes_=batch_device_bytes(b))
        yield b


def _traced(stream: Iterator[Batch], node: PlanNode, ctx: ExecContext):
    """Span wrapper: one aggregate `operator` span per plan node (total
    span = first pull to exhaustion; busy_s = time spent inside next()),
    plus a kernel-wall histogram observation per batch. No device sync:
    on the card busy_s is the host's enqueue time, not kernel time. The
    span closes in `finally`, so an undrained stream (LIMIT, a consumer
    that raised) records it when the generator closes."""
    tracer = ctx.tracer
    parent = tracer.current_parent()
    start = time.time()
    busy = 0.0
    batches = 0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                b = next(stream)
            except StopIteration:
                return
            dt = time.perf_counter() - t0
            busy += dt
            batches += 1
            _obs_metrics.BATCH_KERNEL_WALL.observe(dt, plane="worker")
            yield b
    finally:
        tracer.record(type(node).__name__, "operator", start, time.time(),
                      parent_id=parent, busy_s=round(busy, 6),
                      batches=batches)


def _pad_batch(b: Batch, cap: int) -> Batch:
    """Pad rows with dead lanes up to cap."""
    extra = cap - b.capacity
    if extra <= 0:
        return b

    def padp(p):
        return torch.cat([p, torch.zeros((extra,) + tuple(p.shape[1:]),
                                         dtype=p.dtype, device=p.device)])

    return Batch(b.names, b.types, [c.map_rows(padp) for c in b.columns],
                 padp(b.live), b.dicts)


def _merging_output(stream: Iterator[Batch], target_cap: int) -> Iterator[Batch]:
    """MergingPageOutput analog: compact sparse batches (live rows to the
    front), slice them to their power-of-two bucket, and concatenate until
    a full batch accumulates. Dense batches pass through; empty batches
    are dropped. One host sync per input batch (its live count)."""
    pending: List[Batch] = []
    pending_live = 0

    def flush():
        nonlocal pending, pending_live
        if len(pending) == 1:
            out = pending[0]
        else:
            out = _collect_concat(iter(pending))
            out = _pad_batch(out, round_up_capacity(out.capacity))
        pending, pending_live = [], 0
        return out

    for b in stream:
        n = b.num_live()
        if n == 0:
            continue
        if 2 * n >= b.capacity:
            if pending:
                yield flush()
            yield b
            continue
        pending.append(_truncate(compact(b), round_up_capacity(n)))
        pending_live += n
        if pending_live >= target_cap:
            yield flush()
    if pending:
        yield flush()


def _execute_base(base: PlanNode, ctx: ExecContext) -> Iterator[Batch]:
    if isinstance(base, TableScan):
        yield from _scan_batches(base, ctx)
        return
    if isinstance(base, Aggregate):
        yield from _execute_aggregate(base, ctx)
        return
    if isinstance(base, HashJoin):
        yield from _execute_join(base, ctx)
        return
    if isinstance(base, MultiwayJoin):
        yield from _execute_multiway_join(base, ctx)
        return
    if isinstance(base, IndexJoin):
        yield from _execute_index_join(base, ctx)
        return
    if isinstance(base, Unnest):
        in_stream, chain = _fused_child(base.child, ctx)
        for b in in_stream:
            yield unnest_expand(base, chain(b))
        return
    if isinstance(base, NestedLoopJoin):
        yield from _execute_nljoin(base, ctx)
        return
    if isinstance(base, SemiJoin):
        yield from _execute_semijoin(base, ctx)
        return
    if isinstance(base, SetOp):
        yield from _execute_setop(base, ctx)
        return
    if isinstance(base, Sort):
        yield from _execute_sort(base, ctx)
        return
    if isinstance(base, Window):
        yield from _execute_window(base, ctx)
        return
    if isinstance(base, Limit):
        remaining = base.count
        for b in execute_node(base.child, ctx):
            out = limit_batch(b, remaining)
            remaining -= out.num_live()
            yield out
            if remaining <= 0:
                return
        return
    if isinstance(base, Output):
        for b in execute_node(base.child, ctx):
            yield b.select(base.symbols).rename(base.names)
        return
    if isinstance(base, OneRow):
        # SELECT without FROM: one live row, no column
        live = torch.zeros(128, dtype=torch.bool, device=ctx.device)
        live[0] = True
        yield Batch([], [], [], live, {})
        return
    if isinstance(base, HostProject):
        yield from _execute_host_project(base, ctx)
        return
    if isinstance(base, RemoteSource):
        if ctx.remote_sources is None:
            raise RuntimeError("RemoteSource outside a distributed task")
        yield from ctx.remote_sources(base.fragment_id)
        return
    if isinstance(base, TableWriter):
        # scaled writer: this task writes its stream as one part and emits
        # its row count (TableWriterOperator analog)
        conn = ctx.catalog.connectors[base.catalog]
        batches = list(execute_node(base.child, ctx))
        n = conn.write_part(base.table,
                            f"{base.write_id}-{ctx.task_index:04d}",
                            batches) if batches else 0
        yield count_batch(n, ctx.device)
        return
    raise NotImplementedError(
        f"no executor for {type(base).__name__} in presto_tpu_torch yet")


def count_batch(rows: int, device: torch.device) -> Batch:
    """One BIGINT `rows` row: what a statement or a scaled writer
    returns."""
    vals = torch.zeros(128, dtype=torch.int64, device=device)
    vals[0] = rows
    live = torch.zeros(128, dtype=torch.bool, device=device)
    live[0] = True
    return Batch(["rows"], [BIGINT], [Column(vals)], live, {})


# -- unnest ---------------------------------------------------------------------


def unnest_expand(node: Unnest, b: Batch) -> Batch:
    """UNNEST of one batch: output row i * W + j exists iff j < the largest
    size of row i over the sources (a NULL array counts as empty); W is
    the widest source plane, so the output capacity is cap * W. A map
    unnests into (key, value); the replicated columns repeat W times with
    their planes and dictionaries."""
    cap = b.capacity
    dev = b.device
    srcs = [b.column(s) for s in node.sources]
    w = max([c.values.shape[1] for c in srcs] + [1])
    counts = None
    for c in srcs:
        sz = c.sizes
        if c.validity is not None:
            sz = torch.where(c.validity, sz, 0)
        counts = sz if counts is None else torch.maximum(counts, sz)
    counts = torch.where(b.live, counts, 0)
    j = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    out_live = (j < counts[:, None]).reshape(-1)

    def flat(plane: torch.Tensor) -> torch.Tensor:
        """[cap, width] → [cap * w], slots past width padded with 0."""
        return pad_plane_width(plane, w, 0).reshape(-1)

    names, types, cols = [], [], []
    dicts = {}
    child_types = dict(node.child.output)
    for s in node.replicate:
        names.append(s)
        types.append(child_types[s])
        cols.append(b.column(s).map_rows(
            lambda p: torch.repeat_interleave(p, w, dim=0)))
        carry_dicts(b.dicts, dicts, s)
    for src, c, syms, etypes in zip(node.sources, srcs, node.out_syms,
                                    node.out_types):
        present = (torch.arange(c.values.shape[1], dtype=torch.int32,
                                device=dev)[None, :] < c.sizes[:, None])
        evalid = present if c.evalid is None else (present & c.evalid)
        if len(syms) == 2:  # map → (key, value)
            names.append(syms[0])
            types.append(etypes[0])
            cols.append(Column(flat(c.keys), flat(present)))
            if key_dict_name(src) in b.dicts:
                dicts[syms[0]] = b.dicts[key_dict_name(src)]
        names.append(syms[-1])
        types.append(etypes[-1])
        cols.append(Column(flat(c.values), flat(evalid)))
        if src in b.dicts:
            dicts[syms[-1]] = b.dicts[src]
    if node.ordinality_sym:
        names.append(node.ordinality_sym)
        types.append(BIGINT)
        cols.append(Column((j + 1).to(torch.int64).expand(cap, w)
                           .reshape(-1)))
    return Batch(names, types, cols, out_live, dicts)


# -- host projection -------------------------------------------------------


def _host_format_value(kind: str, param, t: Type, v) -> str:
    """One distinct value as text: cast to varchar renders as the JAX
    package renders it; date_format takes MySQL's format vocabulary."""
    import datetime as _d

    if kind == "date_format":
        from presto_tpu_torch.expr.host import mysql_format_to_strptime

        fmt = mysql_format_to_strptime(str(param))
        if t.name == "date":
            dt = _d.datetime(1970, 1, 1) + _d.timedelta(days=int(v))
        else:
            dt = _d.datetime(1970, 1, 1) + _d.timedelta(microseconds=int(v))
        return dt.strftime(fmt)
    if t.name == "boolean":
        return "true" if v else "false"
    if t.name == "date":
        return str(_d.date(1970, 1, 1) + _d.timedelta(days=int(v)))
    if t.name == "time":
        dt = _d.datetime(1970, 1, 1) + _d.timedelta(microseconds=int(v))
        return dt.strftime("%H:%M:%S.%f")[:-3]
    if t.name == "timestamp":
        dt = _d.datetime(1970, 1, 1) + _d.timedelta(microseconds=int(v))
        return dt.strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
    if isinstance(t, DecimalType):
        import decimal as _dec

        return str(_dec.Decimal(int(v)).scaleb(-t.scale))
    if t.name == "real":
        # float32's shortest repr: float(v) would print widened digits
        return str(np.float32(v))
    if t.name == "double":
        return str(float(v))
    return str(int(v))


def _execute_host_project(node: HostProject, ctx: ExecContext
                          ) -> Iterator[Batch]:
    """HostProject: the string-producing scalars with no input dictionary
    (cast to varchar, date_format), on the host at the query root. Each
    batch formats once per distinct value and its rows take codes in a
    fresh dictionary. This runs on the host by design, as in the JAX
    package."""
    in_types = dict(node.child.output)
    for b in execute_node(node.child, ctx):
        live = b.live.cpu().numpy()
        for sym, kind, in_sym, param in node.items:
            t = in_types[in_sym]
            c = b.column(in_sym)
            vals = c.values.cpu().numpy()
            if c.hi is not None:
                # long decimal: the exact value from its two limbs
                his = c.hi.cpu().numpy()
                vals = np.array([(int(h) << 32) + int(lo)
                                 for h, lo in zip(his, vals)], dtype=object)
            valid = c.valid_mask().cpu().numpy() & live
            # dead and NULL rows format a 0 that the validity hides
            safe = np.where(valid, vals, 0 if vals.dtype == object
                            else np.zeros((), dtype=vals.dtype))
            uniq, inv = np.unique(safe, return_inverse=True)
            strs = np.asarray([_host_format_value(kind, param, t, u)
                               for u in uniq], dtype=object)
            d, ucodes = Dictionary.encode(strs)
            codes = np.where(valid, ucodes[inv.reshape(-1)], -1).astype(
                np.int32)
            b = b.with_column(sym, VARCHAR, Column(
                torch.from_numpy(codes).to(ctx.device),
                torch.from_numpy(valid).to(ctx.device)), dictionary=d)
        yield b


# -- scan -------------------------------------------------------------------


def _scan_batches(scan: TableScan, ctx: ExecContext) -> Iterator[Batch]:
    conn = ctx.catalog.connectors[scan.catalog]
    handle = conn.get_table(scan.table)
    nrows = int(handle.row_count or 0)
    columns = list(scan.assignments.values())
    symbols = list(scan.assignments.keys())
    if not columns:
        # count(*)-style scan: batches of liveness only; a distributed
        # task accounts its slice of the rows
        per = (nrows // ctx.n_tasks
               + (1 if ctx.task_index < nrows % ctx.n_tasks else 0))
        cap = round_up_capacity(min(per, ctx.config.batch_rows) or 1)
        if per == 0 and ctx.task_index != 0:
            return
        done = 0
        while True:
            take = min(cap, per - done)
            live = torch.arange(cap, device=ctx.device) < take
            yield Batch([], [], [], live, {})
            done += take
            if done >= per:
                return
    nsplits = max(1, -(-nrows // ctx.config.batch_rows))
    cap = round_up_capacity(min(nrows, ctx.config.batch_rows) or 1)
    splits = _task_splits(scan, ctx, conn.splits(handle, nsplits))
    read_split = conn.read_split
    bounds = (_constraints_to_storage(scan, handle) if scan.constraints
              else {})
    if bounds:
        # split elimination by min/max statistics (row groups, stripes,
        # hive partition directories)
        before = len(splits)
        splits = conn.prune_splits(handle, splits, bounds)
        ctx.stats[f"scan.{scan.table}.splits_pruned"] = before - len(splits)
        _scan_metrics.record("splits_pruned", before - len(splits))
        if hasattr(conn, "read_split_constrained"):
            # full predicate pushdown: the connector evaluates the ranges
            # at the source (a remote service, a SQL WHERE)
            def read_split(split, columns, device, capacity=None):
                return conn.read_split_constrained(
                    split, columns, device, capacity=capacity,
                    constraints=bounds)
    if (scan.constraints and ctx.config.selective_scan
            and hasattr(conn, "read_split_selective")):
        # Aria selective scan: the constraints become host value filters
        # (scan/filters.py); filter columns decode first, the cascade
        # shrinks a selection vector in adaptive order, and payload columns
        # decode and upload only for survivors. The exact device filter
        # above the scan still runs (host filters are conservative
        # supersets), so results never depend on this layer.
        filters = filters_from_constraints(scan.constraints, handle)
        if filters:
            adaptive = AdaptiveFilterOrder()
            prefix = f"scan.{scan.table}"

            def count(name, delta):
                ctx.bump(f"{prefix}.{name}", delta)
                _scan_metrics.record(name, delta)

            def read_split(split, columns, device, capacity=None):
                return conn.read_split_selective(
                    split, columns, filters, device, capacity=capacity,
                    adaptive=adaptive, counters=count)
    if ctx.tracer.enabled:
        # host_decode / device_transfer sub-spans per split. The parent is
        # captured HERE (the consumer thread, under the query or task
        # span): the prefetch producer thread has no span stack of its own
        tracer = ctx.tracer
        scan_parent = tracer.current_parent()
        inner_read = read_split

        def read_split(split, columns, device, capacity=None):
            w0 = time.time()
            b = inner_read(split, columns, device, capacity=capacity)
            w1 = time.time()
            tracer.record("host_decode", "host_decode", w0, w1,
                          parent_id=scan_parent, table=scan.table)
            # the upload is enqueued with the read; never wait for it
            # here: a sync per split would serialize the prefetch pipeline
            tracer.record("device_transfer", "device_transfer", w1,
                          time.time(), parent_id=scan_parent,
                          table=scan.table)
            return b
    depth = ctx.config.scan_prefetch
    if depth <= 0 or len(splits) <= 1:
        for split in splits:
            yield read_split(split, columns, ctx.device,
                             capacity=cap).rename(symbols)
        return
    yield from _prefetched(
        lambda split: read_split(split, columns, ctx.device, capacity=cap),
        splits, depth, symbols, ctx.tracer)


def _task_splits(scan: TableScan, ctx: ExecContext, splits: list) -> list:
    """This task's share of a scan's splits: one bucket's in a grouped
    execution pass, else the coordinator's assignment (ordinals of the
    unpruned enumeration), else every n_tasks-th split from task_index."""
    assigned = (ctx.split_assignment or {}).get(scan.table)
    if ctx.lifespan is not None and any(s.bucket is not None
                                        for s in splits):
        return [s for s in splits if s.bucket == ctx.lifespan]
    if assigned is not None:
        expected = (ctx.split_counts or {}).get(scan.table)
        if expected is not None and expected != len(splits):
            raise RuntimeError(
                f"split enumeration for {scan.table} changed underneath "
                f"the plan (coordinator saw {expected}, scan sees "
                f"{len(splits)}) — retry the query")
        return [splits[i] for i in assigned if i < len(splits)]
    if ctx.n_tasks > 1:
        return splits[ctx.task_index::ctx.n_tasks]
    return splits


def _prefetched(read, splits, depth: int, symbols,
                tracer=_obs_trace.NOOP) -> Iterator[Batch]:
    """A host thread decodes and uploads splits ahead of the consumer
    through a bounded queue (memory stays O(depth) batches); a read error
    is raised on the consumer, and an early exit (LIMIT, an error) stops
    the producer after its current read and drains the queue. The
    producer carries the query's tracer, so span sites below the
    connector (the selective cascade) keep recording."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def producer():
        try:
            with _obs_trace.use(tracer):
                for split in splits:
                    if stop.is_set():
                        break
                    q.put(read(split))
            q.put(done)
        except BaseException as e:  # surface read errors on the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True, name="scan-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item.rename(symbols)
    finally:
        stop.set()
        while t.is_alive():
            try:
                item = q.get(timeout=0.1)
                if item is done or isinstance(item, BaseException):
                    break
            except queue.Empty:
                continue


def _constraints_to_storage(scan: TableScan, handle):
    """Engine-level (lo, hi) bounds → the connector's storage value domain
    (dates become datetime.date for parquet date32 statistics)."""
    col_types = {c.name: c.type for c in handle.columns}
    out = {}
    for col, (lo, hi) in scan.constraints.items():
        t = col_types.get(col)
        if t is None:
            continue
        if t.name == "date":
            def conv(d):
                return (None if d is None
                        else datetime.date.fromordinal(719163 + int(d)))
            out[col] = (conv(lo), conv(hi))
        else:
            out[col] = (lo, hi)
    return out


# -- aggregation --------------------------------------------------------------

_VARIANCE_FNS = {"var_samp", "var_pop", "stddev_samp", "stddev_pop"}
_COVAR_FNS = {"covar_pop", "covar_samp", "corr"}
# order-dependent aggregates: computed over the materialized input
# (_execute_materialized_aggregate), not by mergeable states
_SORTED_AGGS = {"approx_percentile", "__approx_percentile_w", "max_by",
                "min_by", "count_distinct", "sum_distinct", "avg_distinct"}
# aggregates whose value is built per group over the materialized input:
# arrays and maps (grouped on the device), histograms and sketches (on the
# host, as the JAX package builds them)
_HOST_AGGS = {"array_agg", "map_agg", "numeric_histogram", "tdigest_agg",
              "merge", "approx_set"}
# aggregate functions the port implements (the planner writes every as
# bool_and, any_value as arbitrary, variance as var_samp and stddev as
# stddev_samp)
_SUPPORTED_AGGS = ({"sum", "count_star", "count", "count_if", "avg", "min",
                    "max", "arbitrary", "bool_and", "bool_or", "checksum",
                    "geometric_mean"}
                   | _VARIANCE_FNS | _COVAR_FNS | _SORTED_AGGS | _HOST_AGGS)
# checksum's contribution of a NULL input
_CHECKSUM_NULL = -7046029254386353131


def _as_double(c: Column, t: Type) -> torch.Tensor:
    """Column values as float64, unscaling decimals (limb-combined for
    long decimals)."""
    v = c.combined_f64() if c.hi is not None else c.values.to(torch.float64)
    if isinstance(t, DecimalType):
        v = unscale(v, t.scale)
    return v


def _content_hash(c: Column, dictionary: Optional[Dictionary]) -> torch.Tensor:
    """checksum's order-independent per-row hash, the JAX package's bit for
    bit: a string hashes its entry's content, a double its bit pattern,
    anything else its int64 value; a NULL adds a fixed constant."""
    if dictionary is not None:
        lut = torch.as_tensor(dictionary.content_hash_lut(),
                              device=c.values.device)
        v = lut[c.values.to(torch.int64) + 1]
    elif c.values.is_floating_point():
        v = c.values.to(torch.float64).view(torch.int64)
    else:
        v = c.values.to(torch.int64)
    h = v * -7070675565921424023  # golden-ratio mix, wrapping like uint64
    h = h ^ (h >> 31)
    if c.validity is not None:
        h = torch.where(c.validity, h, _CHECKSUM_NULL)
    return h


def _input_state(b: Batch, name: str, op: str, a, st: Type,
                 in_types: Dict[str, Type]) -> StateCol:
    """Raw input column(s) → one state column for grouped_merge (the
    accumulator `addInput` step; the variance family keeps count, sum and
    sum of squares, the covariances their cross sums)."""
    suffix = name[len(a.symbol):] if name.startswith(a.symbol) else ""
    if op == "count_add":
        if a.fn == "count_if":
            c = b.column(a.arg)
            vals = c.values.to(torch.int64)
            if c.validity is not None:
                vals = torch.where(c.validity, vals, 0)
            return StateCol(vals, None, "count_add")
        if a.fn in _COVAR_FNS:
            both = b.column(a.arg).valid_mask() & b.column(a.arg2).valid_mask()
            return StateCol(both.to(torch.int64), None, "count_add")
        if a.fn == "count_star" or a.arg is None:
            return StateCol(b.live.to(torch.int64), None, "count_add")
        # count(col) and avg's count: the valid inputs
        c = b.column(a.arg)
        return StateCol(c.valid_mask().to(torch.int64), None, "count_add")
    if suffix in ("$hi", "$sum_hi", "$lo", "$sum_lo"):
        # int128 decimal sum limbs: value = hi * 2^32 + lo, lo canonical in
        # [0, 2^32). Short-decimal input splits arithmetically; long-decimal
        # input is already limbed.
        c = b.column(a.arg)
        if suffix.endswith("hi"):
            vals = c.hi if c.hi is not None else (c.values >> 32)
        else:
            vals = c.values if c.hi is not None else (c.values & 0xFFFFFFFF)
        return StateCol(vals.to(torch.int64), c.validity, "sum")
    c = b.column(a.arg)
    if a.fn == "checksum":
        return StateCol(_content_hash(c, b.dicts.get(a.arg)), None, "sum")
    if a.fn == "geometric_mean":
        return StateCol(torch.log(_as_double(c, in_types[a.arg])),
                        c.validity, "sum")
    if a.fn in ("bool_and", "bool_or"):
        return StateCol(c.values.to(torch.int8), c.validity, op)
    if a.fn in _VARIANCE_FNS:
        x = _as_double(c, in_types[a.arg])
        return StateCol(x * x if suffix == "$sumsq" else x, c.validity, "sum")
    if a.fn in _COVAR_FNS:
        cy = b.column(a.arg2)
        x = _as_double(c, in_types[a.arg])
        y = _as_double(cy, in_types[a.arg2])
        both = c.valid_mask() & cy.valid_mask()
        val = {"$sx": x, "$sy": y, "$sxy": x * y,
               "$sxx": x * x, "$syy": y * y}[suffix]
        return StateCol(val, both, "sum")
    if c.hi is not None:
        # long-decimal input to min/max/arbitrary: the combined float64
        # value scaled to the SQL value (the DOUBLE state type)
        return StateCol(_as_double(c, in_types[a.arg]), c.validity, op)
    return StateCol(c.values.to(torch_dtype(st.dtype)), c.validity, op)


def _renorm_limbs(sout: list, pairs) -> list:
    """Carry-propagate int128 limb states after a merge: keep lo canonical
    in [0, 2^32) so limb sums never overflow int64."""
    for ih, il in pairs:
        hi_s, lo_s = sout[ih], sout[il]
        carry = lo_s.values >> 32
        sout[il] = StateCol(lo_s.values - (carry << 32), lo_s.validity, lo_s.op)
        sout[ih] = StateCol(hi_s.values + carry, hi_s.validity, hi_s.op)
    return sout


def _concat_validity(a, b, cap_a, cap_b):
    if a is None and b is None:
        return None
    dev = (a if a is not None else b).device
    av = a if a is not None else torch.ones(cap_a, dtype=torch.bool, device=dev)
    bv = b if b is not None else torch.ones(cap_b, dtype=torch.bool, device=dev)
    return torch.cat([av, bv])


def _breaker_engine_choice(node: PlanNode, ctx: ExecContext) -> str:
    """Resolve the breaker engine ("sort" | "hash"): the session override
    first, else the CBO's NDV/row-count/payload-width thresholds. Stamps
    the decision on the node for EXPLAIN."""
    from presto_tpu_torch.plan.stats import choose_breaker_engine

    try:
        engine, why = choose_breaker_engine(node, ctx.catalog,
                                            ctx.config.breaker_engine)
    except Exception as e:  # noqa: BLE001 — the JAX package's fallback
        # verdict: a failed estimate keeps the known-good sort engine
        engine, why = "sort", f"stats derivation failed: {e}"
    node.__dict__["_breaker_engine"] = engine
    node.__dict__["_breaker_engine_why"] = why
    ctx.bump(f"breaker.engine_{engine}")
    if ctx.tracer.enabled:
        t = time.time()
        ctx.tracer.record("breaker_engine", "breaker_engine", t, t,
                          node=type(node).__name__, engine=engine, why=why)
    return engine


def _key_domain(b: Batch, k: str, t: Type) -> Optional[int]:
    """Static value-domain bound for the direct group path: dictionary
    codes ∈ [0, |dict|), booleans ∈ {0, 1}."""
    d = b.dicts.get(k)
    if d is not None:
        return len(d)
    if t.name == "boolean":
        return 2
    return None


def _agg_steps(node: Aggregate, engine: str) -> SimpleNamespace:
    """The merge steps of one Aggregate node for one breaker engine:
    merge_step(acc, b, cap, prechained=False) → (acc', n_groups) folds a
    raw input batch (through the node's child chain unless `prechained`)
    into the accumulator; acc_merge_step(acc, b, cap) folds a batch of
    state columns (a spilled accumulator) into it. A final step's input
    rows are a partial step's state columns (after the exchange)."""
    _, chain0 = collapse_chain(node.child)
    chain = chain0 or (lambda b: b)
    in_types = dict(node.child.output)
    layout = agg_state_layout(node.aggs, in_types)
    lpairs = limb_pairs(layout)
    key_syms = node.group_keys
    key_types = [in_types[k] for k in key_syms]
    final_mode = node.step == "final"
    if final_mode:
        state_types = [in_types[name] for name, _, _ in layout]
    else:
        state_types = _layout_state_types(layout, in_types)

    def in_to_states(b: Batch):
        keys = [KeyCol(b.column(k).values, b.column(k).validity,
                       _key_domain(b, k, t))
                for k, t in zip(key_syms, key_types)]
        if final_mode:
            # a count state over counts sums them
            states = [StateCol(b.column(name).values.to(
                                   torch_dtype(st.dtype)),
                               b.column(name).validity, op)
                      for (name, op, _), st in zip(layout, state_types)]
        else:
            states = [_input_state(b, name, op, a, st, in_types)
                      for (name, op, a), st in zip(layout, state_types)]
        return keys, states

    def acc_to_states(acc: Batch):
        keys = [KeyCol(acc.column(k).values, acc.column(k).validity,
                       _key_domain(acc, k, t))
                for k, t in zip(key_syms, key_types)]
        states = [StateCol(acc.column(name).values,
                           acc.column(name).validity, op)
                  for name, op, _ in layout]
        return keys, states

    def merge(acc: Optional[Batch], b: Batch, kin, sin, cap: int):
        live = b.live
        if acc is not None:
            ka, sa = acc_to_states(acc)
            kin = [KeyCol(torch.cat([x.values, y.values]),
                          _concat_validity(x.validity, y.validity,
                                           acc.capacity, b.capacity),
                          x.domain if x.domain == y.domain else None)
                   for x, y in zip(ka, kin)]
            sin = [StateCol(torch.cat([x.values, y.values]),
                            _concat_validity(x.validity, y.validity,
                                             acc.capacity, b.capacity),
                            x.op)
                   for x, y in zip(sa, sin)]
            live = torch.cat([acc.live, live])
        kout, sout, out_live, n_groups = grouped_merge(kin, sin, live, cap,
                                                       engine=engine)
        return kout, _renorm_limbs(list(sout), lpairs), out_live, n_groups

    def merge_step(acc: Optional[Batch], b: Batch, cap: int,
                   prechained: bool = False):
        if not prechained:
            b = chain(b)
        if acc is not None:
            # keys from different sources may be coded against different
            # dictionaries; group equality is string equality
            acc, b = _unify_batch_dicts([acc, b])
        kin, sin = in_to_states(b)
        kout, sout, out_live, n_groups = merge(acc, b, kin, sin, cap)
        out = _acc_batch(b, key_syms, key_types, layout, state_types, kout,
                         sout, out_live)
        return out, n_groups

    def acc_merge_step(acc: Optional[Batch], b: Batch, cap: int):
        if acc is not None:
            acc, b = _unify_batch_dicts([acc, b])
        kin, sin = acc_to_states(b)
        kout, sout, out_live, n_groups = merge(acc, b, kin, sin, cap)
        names = list(key_syms) + [name for name, _, _ in layout]
        cols = ([Column(k.values, k.validity) for k in kout]
                + [Column(st.values,
                          st.validity if st.op != "count_add" else None)
                   for st in sout])
        return Batch(names, list(key_types) + list(state_types), cols,
                     out_live, {k: v for k, v in b.dicts.items()
                                if k in names}), n_groups

    return SimpleNamespace(layout=layout, key_syms=key_syms,
                           key_types=key_types, in_types=in_types,
                           state_types=state_types, in_to_states=in_to_states,
                           chain=chain, merge_step=merge_step,
                           acc_merge_step=acc_merge_step)


def _acc_batch(src: Batch, key_syms, key_types, layout, state_types, kout,
               sout, out_live) -> Batch:
    """A merge's group table as a batch: the keys, then one column a state
    (a count state is never NULL); string keys, and string-valued
    min/max/arbitrary states, keep `src`'s dictionaries."""
    cols = ([Column(k.values, k.validity) for k in kout]
            + [Column(s.values, s.validity if s.op != "count_add" else None)
               for s in sout])
    names = list(key_syms) + [name for name, _, _ in layout]
    dicts = {k: src.dicts[k] for k in key_syms if k in src.dicts}
    for name, op, a in layout:
        # a final step's string state column carries its own dictionary
        if op in ("min", "max") and a.arg in src.dicts:
            dicts[name] = src.dicts[a.arg]
        elif op in ("min", "max") and name in src.dicts:
            dicts[name] = src.dicts[name]
    return Batch(names, list(key_types) + list(state_types), cols, out_live,
                 dicts)


def _agg_presize(node: Aggregate, ctx: ExecContext):
    """CBO group-table presizing from derived NDV stats and the GRACE
    decision, the JAX package's rule. Returns (cap, ceiling, can_spill,
    grace_from_start): a keyed aggregation whose presize passes the
    ceiling goes GRACE from the start when spill is on, and its table
    starts at the ceiling."""
    key_syms = node.group_keys
    cap = ctx.config.agg_capacity
    can_spill = bool(key_syms) and ctx.config.spill_enabled
    ceiling = max(ctx.config.agg_cap_ceiling, ctx.config.agg_capacity)
    if key_syms:
        from presto_tpu_torch.plan.stats import derive as _derive_stats

        try:
            st = _derive_stats(node, ctx.catalog)
        except Exception:  # noqa: BLE001 — no estimate: start at agg_capacity
            st = None
        rows = st.rows if (st is not None and st.rows) else None
        if rows:
            if ctx.lifespans:
                # grouped execution: one bucket holds ~1/lifespans of the
                # groups
                rows = rows / ctx.lifespans
            want = round_up_capacity(int(min(rows * 1.25, float(1 << 23))))
            cap = max(cap, want)
    grace_from_start = can_spill and cap > ceiling
    if can_spill:
        cap = min(cap, ceiling)
    return cap, ceiling, can_spill, grace_from_start


def _grouped_execution_lifespans(node: Aggregate) -> int:
    """GroupedExecutionTagger (reference PlanFragmenter.java:914): when
    every group key traces, through Filter/Project identity references,
    down to a colocated bucketed join whose preserved-side join keys the
    group keys cover, every group's rows live inside one bucket, so the
    whole aggregation over the join can run bucket by bucket. Returns the
    bucket count, or 0."""
    keys = set(node.group_keys)
    if not keys:
        return 0
    n = node.child
    while True:
        if isinstance(n, Filter):
            n = n.child
        elif isinstance(n, Project):
            m = dict(n.exprs)
            mapped = set()
            for k in keys:
                e = m.get(k)
                if not isinstance(e, InputRef):
                    return 0  # a computed key traces to no bucket column
                mapped.add(e.name)
            keys = mapped
            n = n.child
        elif isinstance(n, HashJoin) and n.colocated:
            # the NULL-extended rows of an outer join carry NULL keys on
            # the other side: only the preserved side's keys qualify
            if set(n.left_keys) <= keys and n.kind in ("inner", "left"):
                return n.colocated
            if set(n.right_keys) <= keys and n.kind == "inner":
                return n.colocated
            return 0
        else:
            return 0


def _lifespan_sweep(ctx: ExecContext, buckets: int, run,
                    sizes_state: bool = False) -> Iterator[Batch]:
    """Run `run()` once for each of this task's buckets with the scans
    reading that bucket alone (grouped execution). `sizes_state`: the
    aggregation rooted at the sweep sizes its table for one bucket."""
    try:
        if sizes_state:
            ctx.lifespans = buckets
        for b in range(ctx.task_index, buckets, ctx.n_tasks):
            ctx.lifespan = b
            yield from run()
    finally:
        ctx.lifespan = None
        ctx.lifespans = None


def _execute_aggregate(node: Aggregate, ctx: ExecContext) -> Iterator[Batch]:
    if ctx.lifespan is None:
        ls = _grouped_execution_lifespans(node)
        if ls:
            # the sweep rooted here finalizes and frees each bucket's
            # groups before the next bucket builds
            yield from _lifespan_sweep(
                ctx, ls, lambda: _execute_aggregate(node, ctx),
                sizes_state=True)
            return
    for a in node.aggs:
        if a.fn not in _SUPPORTED_AGGS or a.distinct:
            raise NotImplementedError(
                f"aggregate {a.fn}{' distinct' if a.distinct else ''} is not "
                "supported by presto_tpu_torch yet")
    if any(a.fn in _SORTED_AGGS or a.fn in _HOST_AGGS for a in node.aggs):
        if node.step != "single":
            raise RuntimeError(
                "non-decomposable aggregates must run single-step "
                "(fragmenter gathers them)")
        yield from _execute_materialized_aggregate(node, ctx)
        return
    in_stream, _ = _fused_child(node.child, ctx)
    engine = _breaker_engine_choice(node, ctx)
    steps = _agg_steps(node, engine)
    cap, ceiling, can_spill, grace_from_start = _agg_presize(node, ctx)
    if node.step == "partial" and grace_from_start:
        # partial-aggregation bypass: when the group count nears the row
        # count a partial merge reduces nothing, so each row's state
        # contributions pass unmerged and the final step merges once
        for b in in_stream:
            b = steps.chain(b)
            kin, sin = steps.in_to_states(b)
            yield _acc_batch(b, steps.key_syms, steps.key_types,
                             steps.layout, steps.state_types, kin, sin,
                             b.live)
        return
    # radix pays only for a large group table (a presize past the base
    # capacity); a spill budget engages it regardless
    if (node.group_keys and ctx.config.radix_partitions > 1
            and (ctx.config.join_spill_budget_bytes is not None
                 or cap > ctx.config.agg_capacity)):
        yield from _radix_aggregate(node, ctx, steps, in_stream, cap)
        return
    agg = _SpillableAggregation(node, ctx, steps, cap, ceiling, can_spill)
    yield from agg.run(in_stream, grace_from_start)


class _RevokeFlag:
    """A pool revoker that only raises a flag, which its operator honours
    at its next batch boundary (spilling inside reserve() would re-enter
    the ledger mid-update). Registered from construction, when `enabled`,
    until close()."""

    def __init__(self, pool: MemoryPool, enabled: bool):
        self.pool, self.enabled, self.raised = pool, enabled, False
        if enabled:
            pool.add_revoker(self)

    def __call__(self, _need: int) -> int:
        self.raised = True
        return 0

    def take(self) -> bool:
        """Whether a request came since the last take; clears it."""
        raised, self.raised = self.raised, False
        return raised

    def close(self) -> None:
        if self.enabled:
            self.pool.remove_revoker(self)
            self.enabled = False


def _grown_merge(ctx: ExecContext, step, acc: Optional[Batch], b: Batch,
                 cap: int, keyed: bool = True,
                 limit: Optional[Callable[[int], None]] = None,
                 node: Optional[PlanNode] = None,
                 obs: Optional[dict] = None) -> Tuple[Batch, int]:
    """(merged, capacity): `b` merged into `acc` at `cap`; a merge whose
    groups overflow the table runs again from the unchanged `acc` at the
    capacity that fits. `limit(capacity)` sees each growth first and may
    raise. `obs` (HBO) takes the confirmed group count, read on the host
    here anyway, and the replay waves."""
    for _ in range(ctx.config.max_growth_retries):
        out, ng = step(acc, b, cap)
        if not keyed:
            return out, cap  # a global aggregate has one group
        n = int(ng)
        if n <= cap:
            if obs is not None:
                obs["groups"] = n
            return out, cap
        want = round_up_capacity(n)
        if limit is not None:
            limit(want)
        cap = want
        _bump_replay_wave(node, ctx, obs, cap)
    raise RuntimeError("aggregate capacity growth exceeded retries")


def _bump_replay_wave(node: Optional[PlanNode], ctx: ExecContext,
                      obs: Optional[dict], cap_to: int) -> None:
    """Account one overflow-replay wave: a stats-sized capacity proved too
    small and a merge ran again at a larger one (counter, zero-width span,
    inflight watermark)."""
    ctx.bump("agg.replay_waves")
    if obs is not None:
        obs["replays"] += 1
    name = type(node).__name__ if node is not None else "Aggregate"
    if ctx.tracer.enabled:
        t = time.time()
        ctx.tracer.record("overflow_replay", "overflow_replay", t, t,
                          node=name, cap_to=cap_to)
    if ctx.inflight is not None:
        ctx.inflight.publish(name, wave=ctx.stats["agg.replay_waves"],
                             cap=cap_to)


class _GraceOverflow(Exception):
    """Group-table growth crossed the grace ceiling: the aggregation
    switches to hash-partitioned (GRACE) mode. Carries the input batch
    that was not merged."""

    def __init__(self, batch: Batch):
        super().__init__("aggregate group table crossed the grace ceiling")
        self.batch = batch


class _SpillableAggregation:
    """One aggregation over a stream under the memory pool
    (SpillableHashAggregationBuilder analog, the JAX package's protocol):

    - the accumulator's bytes are reserved in the pool; past the revoke
      threshold, or on a revoke request, it spills as state pages
      partitioned by hash(keys) and the merge starts over empty;
    - growth past the grace ceiling (or a presize past it) hands the
      input to GRACE: the chained raw batches hash-partition to spill;
    - once spilled, each partition replays on its own (raw rows, then
      state pages) at agg_capacity, and a partition that still outgrows
      the ceiling splits by the next hash bits, down to spill_max_depth,
      where the query fails with SpillLimitExceeded.

    Merges are synchronous: a batch that overflows the table is merged
    again from the unchanged accumulator at a capacity that fits."""

    def __init__(self, node: Aggregate, ctx: ExecContext, steps, cap: int,
                 ceiling: int, can_spill: bool):
        self.node, self.ctx, self.steps = node, ctx, steps
        self.cap, self.ceiling, self.can_spill = cap, ceiling, can_spill
        self.keyed = bool(node.group_keys)
        self.acc: Optional[Batch] = None
        self.spiller = None  # spilled accumulators (state pages)
        self.raw_spiller = None  # GRACE: the chained raw input
        self.rev: Optional[_RevokeFlag] = None
        self.mctx = LocalMemoryContext(ctx.memory_pool, "aggregate")
        self.raw_step = (lambda acc, b, c:
                         steps.merge_step(acc, b, c, prechained=True))
        # HBO: the confirmed group count and the replay waves
        self.obs = {"groups": 0, "replays": 0}

    def _new_spiller(self, tag: str):
        ctx = self.ctx
        sp = ctx.spill_manager.partitioning_spiller(
            self.steps.key_syms, ctx.config.spill_partitions, tag,
            on_grow=lambda child, _p: _note_spill_repartition(
                self.node, ctx, child))
        ctx.track_spill(sp)
        return sp

    def _raw(self):
        if self.raw_spiller is None:
            self.raw_spiller = self._new_spiller("agg-raw")
        return self.raw_spiller

    def _spill_acc(self) -> int:
        """Partition-spill the accumulator as state pages; returns the
        bytes it freed."""
        if self.acc is None:
            return 0
        if self.spiller is None:
            self.spiller = self._new_spiller("agg")
        self.spiller.spill(self.acc)
        freed = self.mctx.bytes
        self.acc = None
        self.mctx.set_bytes(0)
        return freed

    def _merge(self, b: Batch, step, mode: str) -> Batch:
        """`b` merged into the accumulator at a capacity that fits. Growth
        past the ceiling raises _GraceOverflow in mode "grace" and
        SpillLimitExceeded in mode "fail"; mode "grow" grows on."""
        def limit(want: int) -> None:
            if mode == "grow" or want <= self.ceiling:
                return
            if mode == "fail":
                raise SpillLimitExceeded(
                    "aggregate spill partition exceeds the grace ceiling "
                    "at max recursion depth "
                    f"{max(0, self.ctx.config.spill_max_depth)} (group keys "
                    "share too many hash bits to split further)")
            raise _GraceOverflow(b)

        out, self.cap = _grown_merge(self.ctx, step, self.acc, b, self.cap,
                                     self.keyed, limit, self.node, self.obs)
        return out

    def _absorb(self, stream: Iterator[Batch], step, allow_spill: bool,
                on_ceiling: Optional[str] = None) -> None:
        """Merge the stream into the accumulator, accounting the
        accumulator and the batch just merged in the pool."""
        mode = on_ceiling or ("grace" if allow_spill else "grow")
        if not self.can_spill:
            mode = "grow"
        ctx = self.ctx
        for b in stream:
            self.acc = self._merge(b, step, mode)
            if ctx.inflight is not None:
                # a merge boundary: counts the host already holds
                ctx.inflight.publish(type(self.node).__name__, batches=1)
            out_bytes = batch_device_bytes(self.acc)
            if self.keyed:
                out_bytes += batch_device_bytes(b)
            if allow_spill and self.can_spill and (
                    self.rev.raised
                    or ctx.should_spill(out_bytes - self.mctx.bytes)):
                was_revoke = self.rev.take()
                freed = self._spill_acc()
                if was_revoke:
                    _note_spill_revoke(self.node, ctx, freed)
            else:
                self.mctx.set_bytes(out_bytes)

    def _grace_ingest(self, stream: Iterator[Batch]) -> None:
        """Hash-partition the chained input straight to spill: no device
        merge until the per-partition phase."""
        raw, chain = self._raw(), self.steps.chain
        for b in stream:
            raw.spill(chain(b))

    def run(self, in_stream: Iterator[Batch],
            grace_from_start: bool) -> Iterator[Batch]:
        ctx, node, steps = self.ctx, self.node, self.steps
        self.rev = _RevokeFlag(ctx.memory_pool, self.can_spill)
        try:
            if grace_from_start:
                self._grace_ingest(in_stream)
            else:
                try:
                    self._absorb(in_stream, steps.merge_step,
                                 allow_spill=True)
                except _GraceOverflow as ov:
                    # the table outgrew the ceiling mid-stream: the
                    # accumulator spills as state pages, the unmerged
                    # batch and the rest of the input as raw rows
                    self._spill_acc()
                    self._raw().spill(steps.chain(ov.batch))
                    self._grace_ingest(in_stream)
            if self.spiller is None and self.raw_spiller is None:
                if ctx.lifespans is None:
                    # a bucket sweep's group counts are per bucket, which
                    # would poison the history as a whole-table total
                    self.obs["final_cap"] = self.cap
                    _hbo_record_agg(node, ctx, self.obs)
                yield from _agg_output(node, self.acc, steps, ctx.device)
                return
            # spilled: finalize partition by partition
            self._spill_acc()
            self.rev.close()
            spiller, raw = self.spiller, self.raw_spiller
            for p in range((raw or spiller).n_partitions):
                yield from self._finalize_leaf(raw, spiller, p, 0)
            _record_spill_done(ctx, [raw, spiller], node, "spill_agg",
                               ctx.config.spill_partitions, "group")
        finally:
            self.rev.close()
            self.mctx.set_bytes(0)
            for sp in (self.spiller, self.raw_spiller):
                if sp is not None:
                    sp.close()

    def _finalize_leaf(self, rsp, asp, p: int, sdepth: int
                       ) -> Iterator[Batch]:
        """Replay partition p of the raw and state-page spillers (which
        split in lockstep) and finalize it; a replay that outgrows the
        ceiling splits the partition by the next hash bits and recurses."""
        ctx, dev = self.ctx, self.ctx.device
        self.acc = None
        # each partition holds ~1/P of the groups: start small again
        self.cap = ctx.config.agg_capacity
        mode = ("grace" if sdepth < max(0, ctx.config.spill_max_depth)
                else "fail")
        try:
            rows = ctx.config.batch_rows
            if rsp is not None:
                self._absorb(_coalesced(rsp.read_partition(p, dev), rows),
                             self.raw_step, allow_spill=False,
                             on_ceiling=mode)
            if asp is not None:
                self._absorb(_coalesced(asp.read_partition(p, dev), rows),
                             self.steps.acc_merge_step, allow_spill=False,
                             on_ceiling=mode)
        except _GraceOverflow:
            # the partition's files are intact: drop the partial merge,
            # split both trees by the next hash bits, finalize the children
            self.acc = None
            self.mctx.set_bytes(0)
            sub_r = rsp.grow_partition(p) if rsp is not None else None
            sub_a = (asp.grow_partition(
                p, fanout=(sub_r.n_partitions if sub_r is not None
                           else None))
                if asp is not None else None)
            for q in range((sub_r or sub_a).n_partitions):
                yield from self._finalize_leaf(sub_r, sub_a, q, sdepth + 1)
            return
        acc, self.acc = self.acc, None
        if acc is None:
            return
        ctx.bump("spill.partitions")
        _spill_stats_for(self.node)["partitions"] += 1
        yield from _agg_output(self.node, acc, self.steps, ctx.device)
        self.mctx.set_bytes(0)


def _radix_aggregate(node: Aggregate, ctx: ExecContext, steps,
                     in_stream: Iterator[Batch], cap: int
                     ) -> Iterator[Batch]:
    """Radix-partitioned group-by: each chained input batch splits by the
    top hash bits of its keys and each partition merges into its own
    small accumulator. A partition whose accumulator passes
    join_spill_budget_bytes (or the largest one, on a revoke request)
    hybrid-spills: its state pages and all its later raw rows go to host
    files and replay, one partition at a time, at the end."""
    P = ctx.config.radix_partitions
    radix_bits(P)
    budget = ctx.config.join_spill_budget_bytes
    key_syms = steps.key_syms
    # the presize applies per partition: each holds ~1/P of the groups
    start_cap = max(ctx.config.agg_capacity,
                    round_up_capacity(max(cap // P, 1)))
    caps = [start_cap] * P
    accs: List[Optional[Batch]] = [None] * P
    afiles: Dict[int, SpillFile] = {}  # spilled accumulator state pages
    rfiles: Dict[int, SpillFile] = {}  # spilled raw (chained) input
    ctx.bump("radix.agg_engaged")

    def raw_step(acc, b, c):
        return steps.merge_step(acc, b, c, prechained=True)

    # HBO: each partition's confirmed group count
    part_obs = [{"groups": 0, "replays": 0} for _ in range(P)]

    def merge_into(p: int, sub: Batch, step) -> None:
        accs[p], caps[p] = _grown_merge(ctx, step, accs[p], sub, caps[p],
                                        node=node, obs=part_obs[p])

    def spill_partition(p: int) -> None:
        af = ctx.spill_manager.spill_file(f"radix-agg-acc-p{p}")
        ctx.track_spill(af)
        if accs[p] is not None:
            af.append(accs[p])
        afiles[p] = af
        rfiles[p] = ctx.spill_manager.spill_file(f"radix-agg-raw-p{p}")
        ctx.track_spill(rfiles[p])
        accs[p] = None
        caps[p] = start_cap
        ctx.bump("radix.partitions_spilled")

    rev = _RevokeFlag(ctx.memory_pool, ctx.config.spill_enabled)
    try:
        for raw_b in in_stream:
            rid = _radix_tag(raw_b, P, key_syms)
            b = steps.chain(_untag_batch(raw_b))
            subs = ([(rid, b)] if rid is not None
                    else _radix_split(b, key_syms, P))
            for p, sub in subs:
                if p in rfiles:
                    rfiles[p].append(sub)
                    continue
                merge_into(p, sub, raw_step)
                if (budget is not None
                        and batch_device_bytes(accs[p]) > budget):
                    spill_partition(p)
            if rev.take():
                # the pool asked for memory back: spill the largest
                # resident partition
                resident = [(pp, batch_device_bytes(accs[pp]))
                            for pp in range(P)
                            if accs[pp] is not None and pp not in rfiles]
                if resident:
                    pp, nbytes = max(resident, key=lambda t: t[1])
                    spill_partition(pp)
                    _note_spill_revoke(node, ctx, nbytes)
        for p in range(P):
            if p in rfiles or accs[p] is None:
                continue
            yield from _agg_output(node, accs[p], steps, ctx.device)
            accs[p] = None
        # hybrid-spilled partitions, one resident at a time
        for p in sorted(rfiles):
            t0 = time.time()
            accs[p] = None
            caps[p] = start_cap
            part_obs[p]["groups"] = 0
            rows = ctx.config.batch_rows
            for sub in _coalesced(rfiles[p].read(ctx.device), rows):
                merge_into(p, sub, raw_step)
            for sub in _coalesced(afiles[p].read(ctx.device), rows):
                merge_into(p, sub, steps.acc_merge_step)
            if ctx.tracer.enabled:
                ctx.tracer.record("radix_spill_replay", "radix_spill_replay",
                                  t0, time.time(), partition=p)
            if accs[p] is not None:
                yield from _agg_output(node, accs[p], steps, ctx.device)
                accs[p] = None
        if ctx.lifespans is None:
            _hbo_record_agg(node, ctx, {
                "groups": sum(o["groups"] for o in part_obs),
                "replays": sum(o["replays"] for o in part_obs)})
    finally:
        rev.close()
        _close_radix_files(ctx, list(afiles.values()) + list(rfiles.values()))


# -- spill bookkeeping ------------------------------------------------------


def _coalesced(pages: Iterator[Batch], rows: int) -> Iterator[Batch]:
    """Consecutive spill pages concatenated, in order, into batches of at
    most `rows` capacity (a page larger alone stays alone): a replay
    merges or probes a scan batch's worth at a time, not a page (a page
    is one partition's share of one batch)."""
    pending, cap = [], 0
    for b in pages:
        if pending and cap + b.capacity > rows:
            yield _collect_concat(iter(pending))
            pending, cap = [], 0
        pending.append(b)
        cap += b.capacity
    if pending:
        yield _collect_concat(iter(pending))


def _close_radix_files(ctx: ExecContext, files: List[SpillFile]) -> None:
    """Close a radix operator's hybrid-spill files, counting their bytes
    in radix.spill_bytes."""
    spilled = sum(f.bytes for f in files)
    if spilled:
        ctx.bump("radix.spill_bytes", spilled)
    for f in files:
        f.close()


def _spill_stats_for(node: PlanNode) -> dict:
    """Per-node spill accounting stamped for EXPLAIN ANALYZE's
    [spill: P=… depth=… reversed=…] rendering and the HBO spill sites."""
    return node.__dict__.setdefault(
        "_spill_stats",
        {"partitions": 0, "repartitions": 0, "reversed": 0, "depth": 0,
         "revocations": 0, "bytes": 0})


def _note_spill_repartition(node: PlanNode, ctx: ExecContext,
                            child) -> None:
    """One next-hash-bits split (mid-build growth or replay-time
    recursive repartitioning): counter, span, EXPLAIN stats, inflight."""
    st = _spill_stats_for(node)
    st["repartitions"] += 1
    st["depth"] = max(st["depth"], child.depth)
    ctx.bump("spill.repartitions")
    if ctx.tracer.enabled:
        t = time.time()
        ctx.tracer.record("spill_repartition", "spill_repartition", t, t,
                          node=type(node).__name__, depth=int(child.depth),
                          fanout=int(child.n_partitions))
    if ctx.inflight is not None:
        ctx.inflight.publish(type(node).__name__,
                             repartitions=st["repartitions"],
                             spillDepth=st["depth"])


def _note_spill_revoke(node: PlanNode, ctx: ExecContext, freed: int) -> None:
    """A pool revoke request was honored: spillable operator state left
    the device at a batch boundary."""
    _spill_stats_for(node)["revocations"] += 1
    ctx.bump("spill.revocations")
    if ctx.tracer.enabled:
        t = time.time()
        ctx.tracer.record("spill_revoke", "spill_revoke", t, t,
                          node=type(node).__name__, freed=int(freed))
    if ctx.inflight is not None:
        ctx.inflight.publish(type(node).__name__, spilledBytes=int(freed))


def _record_spill_done(ctx: ExecContext, spillers, node: PlanNode,
                       site: str, est_p: int, side: str) -> None:
    """Close out one spilling operator: the bytes and rows its spillers
    wrote, the spilled-bytes histogram, and its spill shape (leaf count,
    repartitions, reversals, depth) into HBO history under `site`."""
    spillers = [sp for sp in spillers if sp is not None]
    spilled = sum(sp.spilled_bytes for sp in spillers)
    ctx.bump("spill.bytes", spilled)
    ctx.bump("spill.rows", sum(sp.spilled_rows for sp in spillers))
    st = _spill_stats_for(node)
    st["bytes"] += int(spilled)
    if spilled:
        _obs_metrics.SPILLED_BYTES.observe(float(spilled), plane="worker",
                                           side=side)
    if ctx.config.hbo == "off":
        return
    fp = _runstats.node_fingerprint(node, ctx.catalog)
    if fp is None:
        return
    _runstats.observe(fp, site, type(node).__name__.lower(), float(est_p),
                      float(max(st["partitions"], 1)),
                      extra={"repartitions": int(st["repartitions"]),
                             "reversals": int(st["reversed"]),
                             "depth": int(st["depth"]),
                             "spilled_bytes": int(spilled)})


def _derived_rows(node: PlanNode, catalog) -> Optional[float]:
    """The CBO's row estimate of a node, None when it has none."""
    from presto_tpu_torch.plan.stats import derive

    try:
        st = derive(node, catalog)
    except Exception:  # noqa: BLE001 — an estimate that fails is absent
        return None
    return float(st.rows) if (st is not None and st.rows) else None


def _hbo_record_agg(node: Aggregate, ctx: ExecContext, obs: dict) -> None:
    """Record the aggregate's observed group count (the confirmed count
    the overflow protocol already read on the host — no extra device
    sync) into the runstats history, stamp the node for EXPLAIN ANALYZE's
    drift rendering, and count whether the engine choice would flip on
    the observed value."""
    if ctx.config.hbo == "off":
        return
    if not node.group_keys or not obs.get("groups"):
        return
    fp = _runstats.node_fingerprint(node, ctx.catalog)
    if fp is None:
        return
    est = _derived_rows(node, ctx.catalog)
    actual = float(obs["groups"])
    extra = {"replays": int(obs.get("replays", 0))}
    if obs.get("final_cap"):
        # the converged capacity, not the initial presize
        extra["final_cap"] = int(obs["final_cap"])
    made = node.__dict__.get("_breaker_engine")
    if made:
        extra["engine"] = made
    if ctx.config.devprof == "on" and getattr(ctx.memory_pool, "peak", 0):
        # the ledger's high-water so far rides the fingerprint into history
        extra["peak_bytes"] = float(ctx.memory_pool.peak)
    _runstats.observe(fp, "agg_groups", "aggregate", est, actual,
                      extra=extra)
    node.__dict__["_runstats"] = {
        "site": "agg_groups", "est": est, "actual": actual}
    _hbo_check_flip(node, ctx)


def _hbo_check_flip(node: PlanNode, ctx: ExecContext) -> None:
    """Count a breaker whose engine verdict would differ on the history
    just recorded."""
    from presto_tpu_torch.plan.stats import choose_breaker_engine

    made = node.__dict__.get("_breaker_engine")
    if not made:
        return
    try:
        would, _ = choose_breaker_engine(node, ctx.catalog,
                                         ctx.config.breaker_engine,
                                         hbo="correct")
    except Exception:  # noqa: BLE001 — the verdict's own fallback
        return
    if would != made:
        _runstats.record_flip("breaker_engine")


def _hbo_record_scans(root: PlanNode, ctx: ExecContext) -> None:
    """Observe per-scan actual rows against the derived estimates
    (collect_stats runs only: the row counts ride the instrumented
    stream's host sync; an uninstrumented run records nothing rather
    than adding a sync of its own)."""
    if ctx.config.hbo == "off" or not ctx.config.collect_stats \
            or not ctx.node_stats:
        return

    def walk(n):
        if isinstance(n, TableScan):
            rec = ctx.node_stats.get(id(n))
            if rec and rec.get("rows"):
                fp = _runstats.node_fingerprint(n, ctx.catalog)
                est = _derived_rows(n, ctx.catalog)
                _runstats.observe(fp, "scan_rows", "tablescan", est,
                                  float(rec["rows"]))
                n.__dict__["_runstats"] = {
                    "site": "scan_rows", "est": est,
                    "actual": float(rec["rows"])}
        for c in n.children():
            walk(c)

    walk(root)


def _spill_replay_budget(ctx: ExecContext) -> Optional[int]:
    """Bytes one replayed spill partition's build side must fit in: the
    explicit per-partition budget when set, else the pool's revoke target.
    None = unbudgeted."""
    if ctx.config.join_spill_budget_bytes is not None:
        return ctx.config.join_spill_budget_bytes
    pool = ctx.memory_pool
    if pool.limit is not None:
        return max(1, int(pool.limit * pool.revoke_target))
    return None


def _agg_output(node: Aggregate, acc: Optional[Batch], steps,
                device: torch.device) -> Iterator[Batch]:
    """An accumulator's output: a partial step's state columns as they are
    (for the exchange; none when no row came), else the final values."""
    if node.step == "partial":
        if acc is not None:
            yield acc
        return
    yield _finalize_aggregate(node, acc, steps, device)


def _finalize_aggregate(node: Aggregate, acc: Optional[Batch], steps,
                        device: torch.device) -> Batch:
    out_syms = [s for s, _ in node.output]
    out_types = [t for _, t in node.output]
    if acc is None:
        if node.group_keys:
            return empty_batch(out_syms, out_types, device)
        # empty input: a global aggregation still yields one row
        cols = []
        for a in node.aggs:
            vals = torch.zeros(128, dtype=torch_dtype(a.type.dtype),
                               device=device)
            null = (None if a.fn in ("count", "count_star", "count_if")
                    else torch.zeros(128, dtype=torch.bool, device=device))
            cols.append(Column(vals, null))
        live = torch.zeros(128, dtype=torch.bool, device=device)
        live[0] = True
        return Batch([a.symbol for a in node.aggs], [a.type for a in node.aggs],
                     cols, live, {})

    names, types, cols = [], [], []
    for k, t in zip(steps.key_syms, steps.key_types):
        names.append(k)
        types.append(t)
        cols.append(acc.column(k))
    for a in node.aggs:
        if a.fn == "avg":
            cnt = acc.column(a.symbol + "$cnt").values
            ok = cnt > 0
            denom = torch.where(ok, cnt, 1).to(torch.float64)
            if (a.symbol + "$sum_hi") in acc.names:
                hi = acc.column(a.symbol + "$sum_hi").values
                lo = acc.column(a.symbol + "$sum_lo").values
                lo_t = acc.type_of(a.symbol + "$sum_lo")
                num = unscale(hi.to(torch.float64) * float(1 << 32)
                              + lo.to(torch.float64), lo_t.scale)
            else:
                s = acc.column(a.symbol + "$sum").values
                src_t = (steps.in_types[a.symbol + "$sum"]
                         if node.step == "final"
                         else sum_state_type(a, steps.in_types))
                num = s.to(torch.float64)
                if isinstance(src_t, DecimalType):
                    num = unscale(num, src_t.scale)
            cols.append(Column(num / denom, ok))
        elif a.fn == "sum" and (a.symbol + "$hi") in acc.names:
            # exact int128 decimal total as a two-limb long-decimal column
            hi = acc.column(a.symbol + "$hi")
            lo = acc.column(a.symbol + "$lo")
            cols.append(Column(lo.values, lo.validity, hi.values))
        elif a.fn in _VARIANCE_FNS:
            n = acc.column(a.symbol + "$cnt").values.to(torch.float64)
            s = acc.column(a.symbol + "$sum").values
            ss = acc.column(a.symbol + "$sumsq").values
            pop = a.fn.endswith("_pop")
            ok = n > (0 if pop else 1)
            nn = torch.where(n > 0, n, 1.0)
            denom = torch.where(ok, n if pop else n - 1, 1.0)
            var = torch.clamp((ss - s * s / nn) / denom, min=0.0)
            cols.append(Column(torch.sqrt(var) if a.fn.startswith("stddev")
                               else var, ok))
        elif a.fn in ("covar_pop", "covar_samp"):
            n = acc.column(a.symbol + "$cnt").values.to(torch.float64)
            sx = acc.column(a.symbol + "$sx").values
            sy = acc.column(a.symbol + "$sy").values
            sxy = acc.column(a.symbol + "$sxy").values
            pop = a.fn.endswith("_pop")
            ok = n > (0 if pop else 1)
            nn = torch.where(n > 0, n, 1.0)
            denom = torch.where(ok, n if pop else n - 1, 1.0)
            cols.append(Column((sxy - sx * sy / nn) / denom, ok))
        elif a.fn == "corr":
            n = acc.column(a.symbol + "$cnt").values.to(torch.float64)
            sx = acc.column(a.symbol + "$sx").values
            sy = acc.column(a.symbol + "$sy").values
            sxy = acc.column(a.symbol + "$sxy").values
            vx = n * acc.column(a.symbol + "$sxx").values - sx * sx
            vy = n * acc.column(a.symbol + "$syy").values - sy * sy
            ok = (n > 1) & (vx > 0) & (vy > 0)
            denom = torch.sqrt(torch.where(ok, vx * vy, 1.0))
            cols.append(Column((n * sxy - sx * sy) / denom, ok))
        elif a.fn == "geometric_mean":
            n = acc.column(a.symbol + "$cnt").values.to(torch.float64)
            ls = acc.column(a.symbol + "$lsum").values
            ok = n > 0
            cols.append(Column(torch.exp(ls / torch.where(ok, n, 1.0)), ok))
        elif a.fn in ("bool_and", "bool_or"):
            c = acc.column(a.symbol)
            cols.append(Column(c.values.to(torch.bool), c.validity))
        elif a.fn == "checksum":
            cols.append(Column(acc.column(a.symbol).values, None))
        else:
            # count/sum/min/max/arbitrary/count_if, and the sorted
            # aggregates, pass through
            cols.append(acc.column(a.symbol))
        names.append(a.symbol)
        types.append(a.type)
    live = acc.live
    if not node.group_keys:
        # SQL: a global aggregation yields exactly one row even when every
        # input row was filtered out (count=0, sums NULL)
        live = live.clone()
        live[0] = True
    return Batch(names, types, cols, live, acc.dicts)


def _seg_sum(x: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-segment sums of x over segments [0, cap); rows of segment cap
    (dead rows) drop out."""
    out = torch.zeros(cap + 1, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)[:cap]


def _seg_min(x: torch.Tensor, seg: torch.Tensor, cap: int,
             fill: int) -> torch.Tensor:
    out = torch.full((cap + 1,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, "amin")[:cap]


def _group_operands(b: Batch, key_syms) -> List[torch.Tensor]:
    """The sort operands that order rows into the sort engine's groups:
    deadness, then each key's NULL bit and value."""
    operands = [(~b.live).to(torch.int32)]
    for k in key_syms:
        c = b.column(k)
        if c.validity is not None:
            operands.append((~c.validity).to(torch.int32))
            operands.append(torch.where(c.validity, c.values,
                                        torch.zeros_like(c.values)))
        else:
            operands.append(c.values)
    return operands


def _sorted_group_agg(b: Batch, key_syms, a, cap: int):
    """Per-group order-dependent aggregate over materialized input:
    approx_percentile (exact per-group quantile, or the sketch's weighted
    rank), max_by / min_by, and count/sum/avg DISTINCT. Sorts by
    (deadness, group keys, order value): the group enumeration matches the
    sort engine's grouped_merge over the same keys, so the returned arrays
    align with its group table rows."""
    n = b.capacity
    dev = b.device
    operands = _group_operands(b, key_syms)
    num_key_ops = len(operands)

    cx = b.column(a.arg)
    if a.fn in ("approx_percentile", "__approx_percentile_w",
                "count_distinct", "sum_distinct", "avg_distinct"):
        ov = cx.valid_mask()
        sortval = torch.where(ov, cx.values,
                              _minmax_identity(cx.values.dtype, "min"))
    else:
        cy = b.column(a.arg2)
        ov = cy.valid_mask()
        # max_by takes a run's last row, min_by its first; a NULL order
        # value sorts as +inf for max_by and -inf for min_by, as in the
        # JAX package (so a group's NULL-valued row can be the one taken)
        sortval = torch.where(ov, cy.values, _minmax_identity(
            cy.values.dtype, "min" if a.fn == "max_by" else "max"))
    operands.append(sortval)

    perm = lex_sort_permutation(operands)
    sorted_ops = [op[perm] for op in operands]
    sdead = sorted_ops[0]
    change = torch.zeros(n, dtype=torch.bool, device=dev)
    change[0] = True
    for sk in sorted_ops[:num_key_ops]:
        change[1:] |= sk[1:] != sk[:-1]
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    seg = torch.where(sdead == 1, cap, seg)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    start = _seg_min(idx, seg, cap, n)
    cnt = _seg_sum(torch.ones(n, dtype=torch.int64, device=dev), seg, cap)
    ov_sorted = ov[perm]
    cntv = _seg_sum(ov_sorted.to(torch.int64), seg, cap)
    valid = cntv > 0

    if a.fn in ("count_distinct", "sum_distinct", "avg_distinct"):
        # DISTINCT accumulators (MarkDistinct analog): after the (keys,
        # value) sort, the first row of each equal-value run inside a
        # segment carries the value; every other row contributes zero
        sv = cx.values[perm]
        prev_same = torch.zeros(n, dtype=torch.bool, device=dev)
        prev_same[1:] = (sv[1:] == sv[:-1]) & ~change[1:]
        first_distinct = ov_sorted & (sdead == 0) & ~prev_same
        dcount = _seg_sum(first_distinct.to(torch.int64), seg, cap)
        if a.fn == "count_distinct":
            return dcount, None
        acc_dtype = sv.dtype if sv.is_floating_point() else torch.int64
        contrib = torch.where(first_distinct, sv.to(acc_dtype),
                              torch.zeros((), dtype=acc_dtype, device=dev))
        dsum = _seg_sum(contrib, seg, cap)
        if a.fn == "sum_distinct":
            return dsum, dcount > 0
        t = b.type_of(a.arg)
        num = unscale(dsum.to(torch.float64),
                      t.scale if isinstance(t, DecimalType) else 0)
        return num / torch.clamp(dcount, min=1).to(torch.float64), dcount > 0
    if a.fn == "__approx_percentile_w":
        # weighted-rank selection over the sketch's bucket rows: the value
        # is the bucket minimum whose running count first reaches
        # ceil(p * total) (the approx_percentile lowering's last step)
        p = float(a.param)
        w = b.column(a.arg2).values.to(torch.int64)[perm]
        w = torch.where(ov_sorted & (sdead == 0), w, 0)
        cs = torch.cumsum(w, 0)
        run_start = torch.cummax(torch.where(change, idx, 0), 0).values
        cum = cs - cs[run_start] + w[run_start]
        totals = _seg_sum(w, seg, cap)
        thresh = torch.clamp(torch.ceil(p * totals.to(torch.float64))
                             .to(torch.int64), min=1)
        row_thresh = torch.cat([thresh, torch.zeros(1, dtype=torch.int64,
                                                    device=dev)])[
            torch.clamp(seg, 0, cap)]
        candidate = (cum >= row_thresh) & (w > 0)
        pick = _seg_min(torch.where(candidate, idx, n), seg, cap, n)
        rows = perm[torch.clamp(pick, 0, n - 1)]
        return cx.values[rows], totals > 0
    if a.fn == "approx_percentile":
        # exact quantile: index ceil(p * n_valid) - 1 of the group's sorted
        # valid values, placed as the JAX package places it
        p = float(a.param)
        k = torch.ceil(p * cntv.to(torch.float64)).to(torch.int64) - 1
        k = torch.minimum(torch.clamp(k, min=0),
                          torch.clamp(cntv - 1, min=0))
        pos = torch.clamp(start + (cnt - cntv) + k, 0, n - 1)
    elif a.fn == "max_by":
        pos = torch.clamp(start + cnt - 1, 0, n - 1)
    else:
        pos = torch.clamp(start, 0, n - 1)
    rows = perm[pos]
    if cx.validity is not None:
        valid = valid & cx.validity[rows]
    return cx.values[rows], valid


def _execute_materialized_aggregate(node: Aggregate,
                                    ctx: ExecContext) -> Iterator[Batch]:
    """Aggregates with order-dependent, non-mergeable state
    (approx_percentile, max_by/min_by, count/sum/avg DISTINCT beside other
    aggregates) and the ones built per group (_HOST_AGGS): materialize the
    input and compute per group over one global sort; the decomposable
    aggregates beside them merge in the same pass on the sort engine."""
    in_stream, chain = _fused_child(node.child, ctx)
    in_types = dict(node.child.output)
    key_syms = node.group_keys
    key_types = [in_types[k] for k in key_syms]
    decomp = [a for a in node.aggs
              if a.fn not in _SORTED_AGGS and a.fn not in _HOST_AGGS]
    ordered = [a for a in node.aggs if a.fn in _SORTED_AGGS]
    built = [a for a in node.aggs if a.fn in _HOST_AGGS]
    layout = agg_state_layout(decomp, in_types)
    state_types = _layout_state_types(layout, in_types)
    steps = SimpleNamespace(key_syms=key_syms, key_types=key_types,
                            in_types=in_types)
    full = _collect_concat(chain(b) for b in in_stream)
    if full is None:
        yield _finalize_aggregate(node, None, steps, ctx.device)
        return
    cap = full.capacity  # groups <= live rows
    keys = [KeyCol(full.column(k).values, full.column(k).validity)
            for k in key_syms]
    states = [_input_state(full, name, op, a, st, in_types)
              for (name, op, a), st in zip(layout, state_types)]
    kout, sout, out_live, _ = grouped_merge(keys, states, full.live, cap)
    acc = _acc_batch(full, key_syms, key_types, layout, state_types, kout,
                     _renorm_limbs(list(sout), limb_pairs(layout)), out_live)
    for a in ordered:
        vals, valid = _sorted_group_agg(full, key_syms, a, cap)
        acc = acc.with_column(
            a.symbol, a.type,
            Column(vals.to(torch_dtype(a.type.dtype)), valid),
            dictionary=full.dicts.get(a.arg))
    if built:
        # the groups are the table's first rows: the built values need no
        # more rows than that
        acc = _truncate(acc, round_up_capacity(int(out_live.sum())))
        acc = _attach_built_aggs(acc, full, built, key_syms)
    yield _finalize_aggregate(node, acc, steps, ctx.device)


def _row_groups(full: Batch, key_syms) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, seg): the input rows ordered by (dead, group keys), stable,
    and each sorted row's group index — the group order of the sort
    engine's grouped_merge over the same keys, so `seg` indexes its group
    table (dead rows get the index `capacity`)."""
    n = full.capacity
    operands = _group_operands(full, key_syms)
    perm = lex_sort_permutation(operands)
    change = torch.zeros(n, dtype=torch.bool, device=full.device)
    change[0] = True
    for op in operands:
        sk = op[perm]
        change[1:] |= sk[1:] != sk[:-1]
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    return perm, torch.where(full.live[perm], seg, n)


def _group_slots(gi: torch.Tensor, keep: torch.Tensor, cap: int):
    """Each kept row's slot within its group, in row order: (sizes [cap],
    slot [n]; a row not kept has slot -1). `gi` is each row's group."""
    n = gi.shape[0]
    g = torch.where(keep, gi, cap)
    sg, order = torch.sort(g, stable=True)
    idx = torch.arange(n, dtype=torch.int64, device=gi.device)
    start = torch.searchsorted(sg, sg)  # each row's group's first row
    slot = torch.full((n,), -1, dtype=torch.int64, device=gi.device)
    slot[order] = torch.where(sg < cap, idx - start, -1)
    sizes = torch.zeros(cap + 1, dtype=torch.int64, device=gi.device)
    sizes.index_add_(0, g, torch.ones_like(g))
    return sizes[:cap].to(torch.int32), slot


def _attach_built_aggs(acc: Batch, full: Batch, aggs, key_syms) -> Batch:
    """array_agg, map_agg, numeric_histogram, tdigest_agg, approx_set and
    merge, one value per group of `acc` (the sort engine's group table over
    `full`, the materialized input). Each row's group comes from the same
    sort on the device; array_agg keeps input order and NULL elements;
    map_agg keeps the first value of each key and drops NULL keys."""
    cap = acc.capacity
    perm, seg = _row_groups(full, key_syms)
    gi = torch.empty_like(seg)
    gi[perm] = seg  # each input row's group (dead rows: capacity)
    live = full.live
    for a in aggs:
        if a.fn in ("numeric_histogram", "tdigest_agg", "merge",
                    "approx_set"):
            acc = _attach_host_sketch(acc, full, a, gi)
            continue
        c = full.column(a.arg)
        if a.fn == "array_agg":
            sizes, slot = _group_slots(gi, live, cap)
            vals, evalid, keys = c.values, c.valid_mask(), None
        else:
            # map_agg(k, v): the first row of each (group, key) places the
            # entry; NULL keys drop out
            vc = full.column(a.arg2)
            kvalid = live & c.valid_mask()
            dedup = lex_sort_permutation([(~kvalid).to(torch.int32), gi,
                                          c.values])
            sk, sgi = c.values[dedup], gi[dedup]
            first = torch.ones_like(kvalid)
            first[1:] = (sk[1:] != sk[:-1]) | (sgi[1:] != sgi[:-1])
            keep = torch.zeros_like(kvalid)
            keep[dedup] = first & kvalid[dedup]
            sizes, slot = _group_slots(gi, keep, cap)
            vals, evalid, keys = vc.values, vc.valid_mask(), c.values
        w = max(int(sizes.max()) if cap else 0, 1)
        rows = slot >= 0
        at = gi[rows] * w + slot[rows]

        def plane(src, fill=0):
            out = torch.full((cap * w,), fill, dtype=src.dtype,
                             device=src.device)
            out[at] = src[rows]
            return out.reshape(cap, w)

        acc = acc.with_column(
            a.symbol, a.type,
            Column(plane(vals), None, None, sizes, plane(evalid, False),
                   None if keys is None else plane(keys)),
            dictionary=full.dicts.get(a.arg if a.fn == "array_agg"
                                      else a.arg2))
        if a.fn == "map_agg" and a.arg in full.dicts:
            acc.dicts[key_dict_name(a.symbol)] = full.dicts[a.arg]
    return acc


def merge_buckets(u: np.ndarray, cnt: np.ndarray, b: int):
    """numeric_histogram's buckets of one group from its distinct values
    `u` (ascending) and their counts: merge the closest adjacent pair (the
    first on a tie) into its weighted mean until at most `b` remain — the
    JAX package's sequential algorithm, to the bit. Merges run in rounds:
    every pair whose gap is below the R-th smallest gap (R the merges
    still needed), smaller than its left neighbour's and no larger than
    its right one's, is one the sequential algorithm would make with the
    same operands (a merge only widens the gaps beside it), so a round
    makes them all at once; when there is none, one sequential step."""
    u = np.asarray(u, np.float64).copy()
    cnt = np.asarray(cnt, np.float64).copy()
    while len(u) > b:
        gaps = np.diff(u)
        need = len(u) - b
        v = np.partition(gaps, need - 1)[need - 1]
        left = np.concatenate([[np.inf], gaps[:-1]])
        right = np.concatenate([gaps[1:], [np.inf]])
        pick = (gaps < v) & (gaps < left) & (gaps <= right)
        if not pick.any():
            pick[int(np.argmin(gaps))] = True
        i = np.flatnonzero(pick)
        tot = cnt[i] + cnt[i + 1]
        u[i] = (u[i] * cnt[i] + u[i + 1] * cnt[i + 1]) / tot
        cnt[i] = tot
        keep = np.ones(len(u), bool)
        keep[i + 1] = False
        u, cnt = u[keep], cnt[keep]
    return u, cnt


def _sorted_by_group(g: torch.Tensor, x: torch.Tensor, cap: int):
    """The rows of group < cap ordered by (group, x), stable: (groups, x,
    permutation) of those rows, and each group's [start, end) in them, on
    the host."""
    perm = lex_sort_permutation([g, x])
    perm = perm[g[perm] < cap]
    gs = g[perm]
    bounds = torch.searchsorted(gs, torch.arange(
        cap + 1, dtype=gs.dtype, device=gs.device))
    return gs, x[perm], perm, bounds.cpu().numpy()


def _attach_host_sketch(acc: Batch, full: Batch, a, gi: torch.Tensor
                        ) -> Batch:
    """numeric_histogram → map(double, double) of bucket centre to count;
    tdigest_agg / merge(tdigest) and approx_set / merge(hyperloglog) →
    one sketch entry per group, as a fresh dictionary column (the port's
    expr/tdigest.py and expr/hll.py, the JAX package's algorithms). The
    card sorts each group's values (and takes their distinct values and
    counts, or the HyperLogLog registers' maxima); the host builds each
    group's value from them. A group whose inputs were all NULL is
    NULL."""
    from presto_tpu_torch.expr import hll as _hll
    from presto_tpu_torch.expr import tdigest as _td

    cap = acc.capacity
    dev = acc.device
    c = full.column(a.arg)
    valid = full.live & c.valid_mask()
    if a.fn == "numeric_histogram":
        x = c.values.to(torch.float64)
        gs, xs, _, bounds = _sorted_by_group(torch.where(valid, gi, cap), x,
                                             cap)
        new = torch.ones_like(gs, dtype=torch.bool)
        both_nan = torch.isnan(xs[1:]) & torch.isnan(xs[:-1])
        new[1:] = (gs[1:] != gs[:-1]) | ((xs[1:] != xs[:-1]) & ~both_nan)
        first = torch.nonzero(new).squeeze(1)
        cnt = torch.diff(first, append=torch.tensor(
            [gs.numel()], device=dev)).cpu().numpy()
        ug = gs[first].cpu().numpy()
        u = xs[first].cpu().numpy()
        starts = np.searchsorted(ug, np.arange(cap + 1))
        hists = {}
        for g in np.flatnonzero(np.diff(bounds)):
            lo, hi = starts[g], starts[g + 1]
            hists[g] = merge_buckets(u[lo:hi], cnt[lo:hi], int(a.param))
        w = max([len(hu) for hu, _ in hists.values()] + [1])
        keys2d = np.zeros((cap, w), np.float64)
        plane = np.zeros((cap, w), np.float64)
        sizes = np.zeros(cap, np.int32)
        validity = np.zeros(cap, bool)
        for g, (hu, hc) in hists.items():
            keys2d[g, :len(hu)] = hu
            plane[g, :len(hu)] = hc
            sizes[g] = len(hu)
            validity[g] = True
        return acc.with_column(a.symbol, a.type, Column(
            torch.as_tensor(plane, device=dev),
            torch.as_tensor(validity, device=dev), None,
            torch.as_tensor(sizes, device=dev), None,
            torch.as_tensor(keys2d, device=dev)))
    entries = {}
    is_hll = a.fn == "approx_set" or (
        a.fn == "merge" and full.type_of(a.arg).name == "hyperloglog")
    if a.fn == "merge":
        # a few sketches a group: merged on the host
        g = torch.where(valid, gi, cap)
        gs, codes, _, bounds = _sorted_by_group(g, c.values, cap)
        sk = full.dicts[a.arg].decode(codes.cpu().numpy())
        merge = _hll.merge if is_hll else _td.merge
        for grp in np.flatnonzero(np.diff(bounds)):
            entries[grp] = merge([e for e in sk[bounds[grp]:bounds[grp + 1]]
                                  if e is not None])
    elif is_hll:
        # the registers and ranks of approx_distinct's lowering, and each
        # group's register maxima, on the card
        ref = InputRef(full.type_of(a.arg), a.arg)
        reg, _ = compile_expr(Call(BIGINT, "__hll_reg", (ref,)))(full)
        rank, _ = compile_expr(Call(BIGINT, "__hll_rank", (ref,)))(full)
        m = _hll.HLL_M
        dense = torch.cumsum(acc.live.to(torch.int64), 0) - 1
        n_live = int(acc.live.sum())
        gd = torch.where(valid, dense[torch.clamp(gi, max=cap - 1)], -1)
        group_of = torch.nonzero(acc.live).squeeze(1).cpu().numpy()
        chunk = max(1, (1 << 26) // m)
        for lo in range(0, n_live, chunk):
            hi = min(lo + chunk, n_live)
            sel = (gd >= lo) & (gd < hi)
            ranks = torch.zeros((hi - lo) * m, dtype=torch.int64, device=dev)
            ranks.scatter_reduce_(0, (gd[sel] - lo) * m + reg[sel],
                                  rank[sel].to(torch.int64), "amax")
            seen = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
            seen.index_add_(0, gd[sel] - lo, torch.ones_like(gd[sel]))
            ranks = ranks.view(hi - lo, m).cpu().numpy()
            for k in np.flatnonzero(seen.cpu().numpy()):
                entries[group_of[lo + k]] = _hll.serialize(ranks[k])
    else:
        x = c.values.to(torch.float64)
        wx = torch.ones_like(x)
        if a.arg2 is not None:
            wc = full.column(a.arg2)
            wx = wc.values.to(torch.float64)
            valid = valid & wc.valid_mask()
        valid = valid & (wx > 0)  # the digest drops non-positive weights
        compression = float(a.param) if a.param else _td.DEFAULT_COMPRESSION
        _, xs, perm, bounds = _sorted_by_group(torch.where(valid, gi, cap), x,
                                               cap)
        xs, ws = xs.cpu().numpy(), wx[perm].cpu().numpy()
        for g in np.flatnonzero(np.diff(bounds)):
            lo, hi = bounds[g], bounds[g + 1]
            entries[g] = _td.build_sorted(xs[lo:hi], ws[lo:hi], compression)
    # a NULL group holds the entry "" (as in the JAX package)
    groups = np.array([g for g, e in entries.items() if e is not None],
                      dtype=np.int64)
    texts = [e for e in entries.values() if e is not None]
    validity = np.zeros(cap, bool)
    validity[groups] = True
    if not validity.all():
        texts.append("")
    d, tcodes = Dictionary.encode(np.array(texts, dtype=object))
    codes = np.full(cap, tcodes[-1], dtype=np.int32)
    codes[groups] = tcodes[:len(groups)]
    return acc.with_column(a.symbol, a.type, Column(
        torch.as_tensor(codes, device=dev),
        torch.as_tensor(validity, device=dev)), dictionary=d)


# -- batches ------------------------------------------------------------------


def _cat_batches(bs: List[Batch]) -> Batch:
    caps = [b.capacity for b in bs]
    cols = [concat_columns([b.columns[i] for b in bs], caps)
            for i in range(len(bs[0].names))]
    dicts = {}
    for b in bs:
        dicts.update(b.dicts)
    return Batch(bs[0].names, bs[0].types, cols,
                 torch.cat([b.live for b in bs]), dicts)


def _unify_batch_dicts(batches: List[Batch]) -> List[Batch]:
    """Before concatenating, re-encode any string column whose batches
    carry different Dictionary objects against their merged dictionary
    (a string array's element plane likewise, and a map's key plane under
    its key dictionary). Batches from one table share dictionary
    objects (a no-op then)."""
    todo = {}
    for name in batches[0].names:
        for key in dict_names(name):
            present = [b.dicts[key] for b in batches if key in b.dicts]
            if not present or all(d is present[0] for d in present):
                continue
            m = present[0]
            for d in present[1:]:
                if d is not m:
                    m = Dictionary.merge(m, d)
            todo[key] = m
    if not todo:
        return batches
    out = []
    for b in batches:
        cols = list(b.columns)
        dicts = dict(b.dicts)
        for key, m in todo.items():
            d = b.dicts.get(key)
            dicts[key] = m
            if d is None or d is m:
                continue
            is_keys = dict_owner(key) != key
            i = b.names.index(dict_owner(key))
            remap = torch.as_tensor(d.map_to(m), device=b.device)
            c = cols[i]
            plane = c.keys if is_keys else c.values
            new = remap[plane.to(torch.int64) + 1].to(plane.dtype)
            cols[i] = dataclasses.replace(
                c, **{"keys" if is_keys else "values": new})
        out.append(Batch(b.names, b.types, cols, b.live, dicts))
    return out


def _collect_concat(stream: Iterator[Batch]) -> Optional[Batch]:
    batches = list(stream)
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return _cat_batches(_unify_batch_dicts(batches))


def _truncate(b: Batch, cap: int) -> Batch:
    return Batch(b.names, b.types, [slice_column(c, cap) for c in b.columns],
                 b.live[:cap], b.dicts)


# -- joins --------------------------------------------------------------------


def _join_plan_cdt(ltypes: dict, rtypes: dict, left_keys,
                   right_keys) -> tuple:
    """Per-key pairwise-promoted compare dtypes of an equi-join, from the
    plan's output types alone."""
    return tuple(
        torch.promote_types(torch_dtype(rtypes[rk].dtype),
                            torch_dtype(ltypes[lk].dtype))
        for lk, rk in zip(left_keys, right_keys))


class _JoinSpec(NamedTuple):
    """The shape of an equi-join that a `_JoinProber` needs: its kind, the
    probe and build key symbols, whether the build keys are unique, and
    each side's output."""

    kind: str
    left_keys: tuple
    right_keys: tuple
    build_unique: bool
    left_output: list
    right_output: list


def _join_spec(node: HashJoin) -> _JoinSpec:
    return _JoinSpec(node.kind, tuple(node.left_keys), tuple(node.right_keys),
                     node.build_unique, list(node.left.output),
                     list(node.right.output))


def _execute_join(node: HashJoin, ctx: ExecContext) -> Iterator[Batch]:
    if node.residual is not None:
        raise NotImplementedError(
            "hash joins with a residual filter are not supported by "
            "presto_tpu_torch yet")
    if node.kind not in ("inner", "left", "full"):
        raise NotImplementedError(
            f"{node.kind} hash joins are not supported by presto_tpu_torch yet")
    if node.colocated and ctx.lifespan is None:
        # grouped execution over a colocated bucketed join: each pass
        # builds from one bucket of the build table and probes the same
        # bucket of the probe table, so the build side held is one
        # bucket's and no row moves between tasks; a nested colocated
        # join runs within the sweep
        yield from _lifespan_sweep(ctx, node.colocated,
                                   lambda: _execute_join(node, ctx))
        return
    probe_stream, chain = _fused_child(node.left, ctx)
    build_stream = execute_node(node.right, ctx)
    if ctx.config.radix_partitions > 1:
        yield from _radix_join(node, ctx, probe_stream, build_stream, chain)
        return
    yield from _join_with_spill(node, ctx, probe_stream, build_stream, chain,
                                observe=True)


def _join_probe(node: HashJoin, ctx: ExecContext, build_in: Optional[Batch],
                probe_stream: Iterator[Batch], chain,
                observe: bool = False) -> Iterator[Batch]:
    """Build one table and probe the stream through it (a FULL join's
    unmatched build rows last); `observe` as for _JoinProber."""
    if build_in is None and node.kind == "inner":
        return  # empty build side: an inner join has no output
    prober = _JoinProber(node, _join_spec(node), ctx, build_in, chain,
                         observe=observe)
    for pb in probe_stream:
        yield from prober.probe_batch(pb)
    yield from prober.tail()
    prober.observe_selectivity()


def _join_with_spill(node: HashJoin, ctx: ExecContext,
                     probe_stream: Iterator[Batch],
                     build_stream: Iterator[Batch], chain,
                     observe: bool = False) -> Iterator[Batch]:
    """One binary hash join over opened child streams. The build side is
    collected under the pool; crossing the revoke threshold, or a revoke
    request, switches to the partitioned spill (HashBuilderOperator's
    SPILLING_INPUT state): both sides hash-partition to disk on the join
    keys and each partition is joined on its own, with mid-build growth,
    recursive repartitioning and per-partition role reversal when the
    partition count proves too small. Also each leg of the multiway
    join's binary cascade."""
    mctx = LocalMemoryContext(ctx.memory_pool, "join-build")
    build_batches: List[Batch] = []
    bspiller = pspiller = None
    can_spill = ctx.config.spill_enabled
    rev = _RevokeFlag(ctx.memory_pool, can_spill)
    try:
        for b in build_stream:
            nb = batch_device_bytes(b)
            if can_spill and (rev.raised or ctx.should_spill(nb)):
                bspiller = ctx.spill_manager.partitioning_spiller(
                    node.right_keys, ctx.config.spill_partitions,
                    "join-build",
                    partition_budget_bytes=_spill_replay_budget(ctx),
                    max_depth=max(0, ctx.config.spill_max_depth),
                    on_grow=lambda child, _p: _note_spill_repartition(
                        node, ctx, child))
                ctx.track_spill(bspiller)
                for bb in build_batches:
                    bspiller.spill(bb)
                if rev.take():
                    _note_spill_revoke(node, ctx, mctx.bytes)
                build_batches = []
                mctx.set_bytes(0)
                bspiller.spill(b)
                for bb in build_stream:
                    bspiller.spill(bb)
                break
            build_batches.append(b)
            mctx.set_bytes(mctx.bytes + nb)

        if bspiller is None:
            yield from _join_probe(node, ctx,
                                   _collect_concat(iter(build_batches)),
                                   probe_stream, chain, observe=observe)
            return

        # the chained probe side, partitioned by the probe keys: both
        # sides hash key content on the same schedule, so they are
        # co-partitioned
        pspiller = ctx.spill_manager.partitioning_spiller(
            node.left_keys, bspiller.n_partitions, "join-probe")
        ctx.track_spill(pspiller)
        for pb in probe_stream:
            pspiller.spill(chain(pb))
        # mid-build growth may have split build partitions: mirror the
        # split tree so replay pairs leaf with leaf
        pspiller.align_to(bspiller)
        yield from _replay_spilled_join(node, ctx, bspiller, pspiller, mctx)
    finally:
        rev.close()
        if bspiller is not None:
            _record_spill_done(ctx, [bspiller, pspiller], node, "spill_join",
                               ctx.config.spill_partitions, "build")
            bspiller.close()
        if pspiller is not None:
            pspiller.close()
        mctx.set_bytes(0)


def _reversed_join_shim(node: HashJoin) -> HashJoin:
    """The same inner join with build and probe roles swapped (sound only
    for an inner join without residual). Cached on the node."""
    shim = node.__dict__.get("_reversed_shim")
    if shim is None:
        shim = HashJoin(kind="inner", left=node.right, right=node.left,
                        left_keys=list(node.right_keys),
                        right_keys=list(node.left_keys),
                        residual=None, build_unique=False)
        node.__dict__["_reversed_shim"] = shim
    return shim


def _reorder_output(b: Batch, names: List[str]) -> Batch:
    """Columns of b in `names` order."""
    return Batch(list(names), [b.type_of(n) for n in names],
                 [b.column(n) for n in names], b.live, b.dicts)


def _replay_spilled_join(node: HashJoin, ctx: ExecContext,
                         bspiller, pspiller, mctx) -> Iterator[Batch]:
    """Replay a co-partitioned spilled join leaf by leaf. A leaf whose
    build side misses the replay budget first tries role reversal (build
    from the smaller probe side: inner joins without residual), then
    splits both sides by the next hash bits and recurses, and at the
    depth bound fails with SpillLimitExceeded."""
    budget = _spill_replay_budget(ctx)
    max_depth = max(0, ctx.config.spill_max_depth)
    out_names = [s for s, _ in node.output]
    dev = ctx.device

    def replay_leaf(bsp, psp, p: int) -> Iterator[Batch]:
        bc, pc = bsp.children.get(p), psp.children.get(p)
        if bc is not None or pc is not None:
            # one side split here: mirror so both expose the same leaves
            if bc is None:
                bc = bsp.grow_partition(p, fanout=pc.n_partitions)
            if pc is None:
                pc = psp.grow_partition(p, fanout=bc.n_partitions)
            bc.align_to(pc)
            pc.align_to(bc)
            for q in range(bc.n_partitions):
                yield from replay_leaf(bc, pc, q)
            return

        bb = bsp.partition_est_bytes(p)
        pb = psp.partition_est_bytes(p)
        reversed_ = (budget is not None and bb > budget and pb < bb
                     and node.kind == "inner" and node.residual is None)
        build_bytes = pb if reversed_ else bb
        if budget is not None and build_bytes > budget:
            # even the smaller side misses the budget: split this leaf by
            # the next hash bits and recurse, down to the depth bound
            if bsp.depth >= max_depth:
                raise SpillLimitExceeded(
                    f"join spill partition is {build_bytes} bytes against a "
                    f"{budget}-byte replay budget at max recursion depth "
                    f"{max_depth} (join keys too skewed to split further)")
            sub_b = bsp.grow_partition(p)
            sub_p = psp.grow_partition(p, fanout=sub_b.n_partitions)
            for q in range(sub_b.n_partitions):
                yield from replay_leaf(sub_b, sub_p, q)
            return

        if reversed_:
            ctx.bump("spill.role_reversals")
            _spill_stats_for(node)["reversed"] += 1
            build_sp, probe_sp = psp, bsp
            jnode = _reversed_join_shim(node)
        else:
            build_sp, probe_sp = bsp, psp
            jnode = node

        ctx.bump("spill.partitions")
        _spill_stats_for(node)["partitions"] += 1
        build_in = _collect_concat(build_sp.read_partition(p, dev))
        if build_in is None and node.kind == "inner":
            return
        # account the replayed partition: one past the pool limit fails
        # the query cleanly
        if build_in is not None:
            mctx.set_bytes(batch_device_bytes(build_in))
        out = _join_probe(jnode, ctx, build_in,
                          _coalesced(probe_sp.read_partition(p, dev),
                                     ctx.config.batch_rows), lambda b: b)
        if reversed_:
            for ob in out:
                yield _reorder_output(ob, out_names)
        else:
            yield from out
        mctx.set_bytes(0)

    for p in range(bspiller.n_partitions):
        yield from replay_leaf(bspiller, pspiller, p)


# -- radix partitioning -----------------------------------------------------


def _radix_tag(b: Batch, num_partitions: int, key_names) -> Optional[int]:
    """The radix id a page was stamped with (serde.TaggedBatch) when its
    decomposition matches this consumer's (same partition count and key
    symbols), else None."""
    tag = getattr(b, "radix", None)
    if tag is None:
        return None
    r, total, keys = tag
    if int(total) == num_partitions and tuple(keys) == tuple(key_names):
        return int(r)
    return None


def _untag_batch(b: Batch) -> Batch:
    """A plain Batch from a possibly tagged one."""
    if type(b) is Batch:
        return b
    return Batch(b.names, b.types, b.columns, b.live, b.dicts)


def _radix_split(b: Batch, key_names, P: int) -> Iterator[Tuple[int, Batch]]:
    """(partition, sub-batch) for each partition that holds live rows of
    `b`: one stable sort by radix id, the P counts to the host, one
    window gather a partition at its power-of-two bucket."""
    perm, counts = radix_perm(b, key_names, P)
    cnts = counts.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(cnts)])
    for p in range(P):
        n = int(cnts[p])
        if n:
            yield p, radix_window_perm(b, perm, int(starts[p]), n,
                                       round_up_capacity(n))


def _packed_concat(batches: List[Batch]) -> Optional[Batch]:
    """The live rows of `batches` packed into one batch of power-of-two
    capacity (a radix partition's build side)."""
    merged = _collect_concat(iter(batches))
    if merged is None:
        return None
    cap = round_up_capacity(merged.num_live())
    merged = compact(merged)
    if merged.capacity >= cap:
        return _truncate(merged, cap)
    return _pad_batch(merged, cap)


def _radix_join(node: HashJoin, ctx: ExecContext,
                probe_stream: Iterator[Batch],
                build_stream: Iterator[Batch], chain) -> Iterator[Batch]:
    """Radix-partitioned hash join: both sides split by the top bits of
    the content hash, and each partition is built and probed on its own
    small table. A partition whose build side passes
    join_spill_budget_bytes (or the largest one, on a revoke request)
    hybrid-spills: its batches go to host files and it is joined after the
    resident partitions, one at a time."""
    P = ctx.config.radix_partitions
    radix_bits(P)
    budget = ctx.config.join_spill_budget_bytes
    dev = ctx.device
    parts: List[List[Batch]] = [[] for _ in range(P)]
    pbytes = [0] * P
    bfiles: Dict[int, SpillFile] = {}
    pfiles: Dict[int, SpillFile] = {}

    def spill_build_partition(p: int) -> None:
        f = ctx.spill_manager.spill_file(f"radix-join-build-p{p}")
        ctx.track_spill(f)
        for bb in parts[p]:
            f.append(bb)
        parts[p] = []
        pbytes[p] = 0
        bfiles[p] = f
        ctx.bump("radix.partitions_spilled")

    def split(b: Batch, keys) -> Iterator[Tuple[int, Batch]]:
        rid = _radix_tag(b, P, keys)
        ub = _untag_batch(b)
        return [(rid, ub)] if rid is not None else _radix_split(ub, keys, P)

    rev = _RevokeFlag(ctx.memory_pool, ctx.config.spill_enabled)
    try:
        for b in build_stream:
            for p, sub in split(b, node.right_keys):
                if p in bfiles:
                    bfiles[p].append(sub)
                    continue
                parts[p].append(sub)
                pbytes[p] += batch_device_bytes(sub)
                if budget is not None and pbytes[p] > budget:
                    spill_build_partition(p)
            if rev.take():
                # the pool asked for memory back: spill the largest
                # resident build partition
                resident = [(pp, pbytes[pp]) for pp in range(P)
                            if parts[pp] and pp not in bfiles]
                if resident:
                    pp, nbytes = max(resident, key=lambda t: t[1])
                    spill_build_partition(pp)
                    _note_spill_revoke(node, ctx, nbytes)

        spec = _join_spec(node)

        def ident(bb):
            return bb  # the chain runs before the split

        probers: Dict[int, _JoinProber] = {}
        for p in range(P):
            if p in bfiles:
                continue
            build_in = _packed_concat(parts[p])
            parts[p] = []
            probers[p] = _JoinProber(node, spec, ctx, build_in, ident,
                                     fanout_scan=16)
        for raw in probe_stream:
            rid = _radix_tag(raw, P, node.left_keys)
            pb = chain(_untag_batch(raw))
            subs = ([(rid, pb)] if rid is not None
                    else _radix_split(pb, node.left_keys, P))
            for p, sub in subs:
                if p in bfiles:
                    f = pfiles.get(p)
                    if f is None:
                        f = pfiles[p] = ctx.spill_manager.spill_file(
                            f"radix-join-probe-p{p}")
                        ctx.track_spill(f)
                    f.append(sub)
                else:
                    yield from probers[p].probe_batch(sub)
        for p in sorted(probers):
            yield from probers[p].tail()
        # hybrid-spilled partitions, one resident at a time
        for p in sorted(bfiles):
            t0 = time.time()
            prober = _JoinProber(node, spec, ctx,
                                 _packed_concat(list(bfiles[p].read(dev))),
                                 ident, fanout_scan=16)
            pf = pfiles.get(p)
            if pf is not None:
                for sub in _coalesced(pf.read(dev), ctx.config.batch_rows):
                    yield from prober.probe_batch(sub)
            yield from prober.tail()
            if ctx.tracer.enabled:
                ctx.tracer.record("radix_spill_replay", "radix_spill_replay",
                                  t0, time.time(), partition=p)
    finally:
        rev.close()
        _close_radix_files(ctx, list(bfiles.values()) + list(pfiles.values()))


def _execute_index_join(node: IndexJoin, ctx: ExecContext) -> Iterator[Batch]:
    """Index join: each probe batch's live, valid key values go to the host
    (strings decoded from their dictionary codes), the connector's index
    returns only the matching rows, on the probe's device, and a prober
    with that batch as its build side joins them (under the hash engine
    one `join_insert` and its `join_probe` launches a probe batch). The
    host copy of the keys is the price, as in the JAX package."""
    conn = ctx.catalog.connectors[node.catalog]
    idx = conn.get_index(conn.get_table(node.table), node.index_key_cols)
    if idx is None:
        raise RuntimeError(
            f"connector {node.catalog!r} no longer provides an index over "
            f"{node.index_key_cols} on {node.table!r}")
    inv = {c: s for s, c in node.assignments.items()}
    spec = _JoinSpec(node.kind, tuple(node.left_keys),
                     tuple(inv[c] for c in node.index_key_cols),
                     node.build_unique, list(node.left.output),
                     list(node.index_output))
    probe_stream, chain = _fused_child(node.left, ctx)
    src_cols = [node.assignments[s] for s, _ in node.index_output]
    syms = [s for s, _ in node.index_output]
    for raw in probe_stream:
        b = chain(raw)
        valid = b.live
        for sym in node.left_keys:
            kv = b.column(sym).validity
            if kv is not None:
                valid = valid & kv
        valid = valid.cpu().numpy()
        key_vals = {}
        for sym, col in zip(node.left_keys, node.index_key_cols):
            vals = b.column(sym).values.cpu().numpy()[valid]
            d = b.dicts.get(sym)
            if d is not None:
                safe = np.clip(vals.astype(np.int64), 0, max(len(d) - 1, 0))
                vals = np.asarray(d.values, dtype=object)[safe]
            key_vals[col] = vals
        looked = idx.lookup(key_vals, src_cols, device=ctx.device)
        build = looked.rename(syms)
        prober = _JoinProber(node, spec, ctx, build, lambda x: x)
        yield from prober.probe_batch(b)


def _scatter_any(n: int, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[n]: whether any of `flags` landed on each index."""
    hits = torch.zeros(n, dtype=torch.int32, device=flags.device)
    hits.index_add_(0, idx.to(torch.int64), flags.to(torch.int32))
    return hits > 0


def _null_columns(b: Batch, syms, mask: Optional[torch.Tensor]) -> Batch:
    """`b` with the columns `syms` NULL wherever `mask` is False (mask None:
    everywhere)."""
    cols = list(b.columns)
    for i, name in enumerate(b.names):
        if name in syms:
            c = cols[i]
            if mask is None:
                valid = torch.zeros(b.capacity, dtype=torch.bool,
                                    device=b.device)
            else:
                valid = c.valid_mask() & mask
            cols[i] = dataclasses.replace(c, validity=valid)
    return Batch(b.names, b.types, cols, b.live, b.dicts)


class _JoinProber:
    """One build table, probed batch by batch: `probe_batch` yields the
    matches for one probe batch, with a LEFT or FULL join's NULL-extended
    probe rows; `tail` yields a FULL join's unmatched build rows."""

    def __init__(self, node: PlanNode, spec: _JoinSpec, ctx: ExecContext,
                 build_in: Optional[Batch], chain, fanout_scan: int = 8,
                 observe: bool = False):
        """`node` is the plan node the engine is chosen for and stamped on;
        `spec` the join's shape. `observe`: a whole-build binary join,
        whose build rows and probe selectivity are HBO observations (a
        radix, spill-partition, cascade-leg or index prober sees a slice)."""
        self.node, self.spec, self.ctx, self.chain = node, spec, ctx, chain
        self.lsyms = [n for n, _ in spec.left_output]
        self.rsyms = [n for n, _ in spec.right_output]
        self.observe = observe and ctx.config.hbo != "off" \
            and build_in is not None
        if build_in is None:
            # outer join over an empty build side: a table of dead rows
            build_in = empty_batch(self.rsyms,
                                   [t for _, t in spec.right_output],
                                   ctx.device)
        engine = _breaker_engine_choice(node, ctx)
        ltypes = dict(spec.left_output)
        self.probe_dtypes = tuple(torch_dtype(ltypes[lk].dtype)
                                  for lk in spec.left_keys)
        self.cdt = _join_plan_cdt(ltypes, dict(spec.right_output),
                                  spec.left_keys, spec.right_keys)
        if engine == "hash" and join_compare_dtypes(
                build_in, spec.right_keys, self.probe_dtypes) != self.cdt:
            engine = "sort"
            node.__dict__["_breaker_engine"] = "sort"
            node.__dict__["_breaker_engine_why"] = (
                "build batch dtypes deviate from plan types")
        self.engine = engine
        self.fanout_scan = fanout_scan
        if engine == "hash":
            self.table = hash_build_side(build_in, spec.right_keys,
                                         self.probe_dtypes)
        else:
            self.table = build_side(build_in, spec.right_keys)
        # FULL: how often each build row matched
        self.bm = (torch.zeros(self.table.batch.capacity, dtype=torch.int32,
                               device=ctx.device)
                   if spec.kind == "full" else None)
        if self.observe:
            ctx.defer_observation(self._observe_build, self.table.n_rows)
            # selectivity accumulators: device scalars, read once with the
            # query's other deferred counts
            self._n_probe = torch.zeros((), dtype=torch.int64,
                                        device=ctx.device)
            self._n_out = torch.zeros((), dtype=torch.int64,
                                      device=ctx.device)

    def _observe_build(self, actual: float) -> None:
        """The build side's live rows against the CBO's estimate."""
        if actual <= 0:
            return
        node, ctx = self.node, self.ctx
        fp = _runstats.node_fingerprint(node, ctx.catalog)
        if fp is None:
            return
        est = _derived_rows(node.right, ctx.catalog)
        _runstats.observe(fp, "join_build", type(node).__name__.lower(),
                          est, actual)
        node.__dict__["_runstats"] = {
            "site": "join_build", "est": est, "actual": actual}
        _hbo_check_flip(node, ctx)

    def observe_selectivity(self) -> None:
        """After the last probe batch: output rows over probe rows, under
        the join's fingerprint (the site choose_join_mode consults)."""
        if self.observe:
            self.ctx.defer_observation(self._observe_selectivity,
                                       self._n_probe, self._n_out)

    def _observe_selectivity(self, n_probe: float, n_out: float) -> None:
        if n_probe <= 0:
            return
        node, ctx = self.node, self.ctx
        fp = _runstats.node_fingerprint(node, ctx.catalog)
        if fp is None:
            return
        est = None
        pst = _derived_rows(node.left, ctx.catalog)
        ost = _derived_rows(node, ctx.catalog)
        if pst and ost is not None:
            est = ost / pst
        _runstats.observe(fp, "join_probe_sel", type(node).__name__.lower(),
                          est, n_out / n_probe,
                          extra={"probe_rows": n_probe})

    def probe_batch(self, pb_raw: Batch) -> Iterator[Batch]:
        if not self.observe:
            yield from self._probe_batch(pb_raw)
            return
        for out in self._probe_batch(pb_raw, count_probe=True):
            self._n_out = self._n_out + out.live.sum()
            yield out

    def _counts(self, pba: Batch, fanout: int):
        spec = self.spec
        if self.engine == "hash":
            return hash_probe_counts(self.table, pba, spec.left_keys,
                                     self.cdt, max_fanout_scan=fanout)
        return probe_counts(self.table, pba, spec.left_keys,
                            spec.right_keys, max_fanout_scan=fanout)

    def _expand(self, pb, pba, lo, counts, offsets, base: int, out_cap: int):
        """One output chunk, and for a LEFT or FULL join the probe rows it
        matched (None for an inner join); `lo` is the match matrix on the
        hash engine and the range starts on the sort engine."""
        spec, t = self.spec, self.table
        if self.engine == "hash":
            pr, bi, ol = hash_probe_expand(t, lo, counts, offsets, base,
                                           out_cap)
        else:
            pr, bi, ol = probe_expand(t, pba, spec.left_keys,
                                      spec.right_keys, lo, counts,
                                      offsets, base, out_cap)
        if self.bm is not None:
            self.bm.index_add_(0, bi, ol.to(torch.int32))
        out = gather_join_output(pb, t, pr, bi, ol, self.lsyms, self.rsyms)
        if spec.kind == "inner":
            return out, None
        return out, _scatter_any(pb.capacity, pr, ol)

    def _probe_batch(self, pb_raw: Batch,
                     count_probe: bool = False) -> Iterator[Batch]:
        spec, table = self.spec, self.table
        pb = self.chain(pb_raw)
        if count_probe:
            self._n_probe = self._n_probe + pb.live.sum()
        pba = align_probe_strings(pb, spec.left_keys, table, spec.right_keys)
        if spec.build_unique:
            if self.engine == "hash":
                idx, matched = hash_probe_unique(table, pba, spec.left_keys,
                                                 self.cdt)
            else:
                idx, matched = probe_unique(table, pba, spec.left_keys,
                                            spec.right_keys)
            rows = torch.arange(pb.capacity, device=pb.device)
            out = gather_join_output(pb, table, rows, idx, pb.live,
                                     self.lsyms, self.rsyms)
            if self.bm is not None:
                self.bm.index_add_(0, idx, (matched & pb.live).to(torch.int32))
            if spec.kind == "inner":
                yield out.with_live(out.live & matched)
            else:
                # LEFT/FULL keep every probe row; unmatched ones get NULL
                # build columns
                yield _null_columns(out, self.rsyms, matched)
            return

        # general fanout join: counts pass + chunked expansion
        fanout = self.fanout_scan
        lo, counts, offsets, total, _, ovf = self._counts(pba, fanout)
        ovn = int(ovf)
        if self.engine == "hash":
            # counts are exact but the match matrix truncated past its
            # width: re-probe at doubled widths until every row fits
            ov_rows = ovn
            while ovn:
                fanout *= 2
                if fanout > table.slot_row.shape[0]:
                    raise RuntimeError(
                        "join fanout exceeded build table capacity")
                self.ctx.bump("join.fanout_reprobes")
                lo, counts, offsets, total, _, ovf = self._counts(pba, fanout)
                ovn = int(ovf)
            ovn = ov_rows
        if ovn:
            self.ctx.bump("join.fanout_overflow_rows", ovn)
        out_cap = pb.capacity
        tot = int(total)
        base = 0
        exists = None
        while True:
            out, hit = self._expand(pb, pba, lo, counts, offsets, base,
                                    out_cap)
            if hit is not None:
                exists = hit if exists is None else (exists | hit)
            yield out
            base += out_cap
            if base >= tot:
                break
        if spec.kind in ("left", "full"):
            # the probe rows no chunk matched, with NULL build columns
            rows = torch.arange(pb.capacity, device=pb.device)
            out = gather_join_output(pb, table, rows, torch.zeros_like(rows),
                                     pb.live & ~exists, self.lsyms,
                                     self.rsyms)
            yield _null_columns(out, self.rsyms, None)

    def tail(self) -> Iterator[Batch]:
        """FULL join: the build rows no probe row matched, with NULL probe
        columns (NULL-key build rows included)."""
        if self.bm is None:
            return
        t = self.table
        cap = t.batch.capacity
        ltypes = dict(self.spec.left_output)
        names, types, cols = [], [], []
        nulls = empty_batch(self.lsyms, [ltypes[c] for c in self.lsyms],
                            self.ctx.device, cap)
        for c in self.lsyms:
            names.append(c)
            types.append(ltypes[c])
            cols.append(dataclasses.replace(
                nulls.column(c), validity=torch.zeros(
                    cap, dtype=torch.bool, device=self.ctx.device)))
        for c in self.rsyms:
            names.append(c)
            types.append(t.batch.type_of(c))
            cols.append(t.batch.column(c))
        yield Batch(names, types, cols, t.orig_live & (self.bm == 0),
                    {k: d for k, d in t.batch.dicts.items()
                     if dict_owner(k) in self.rsyms})


# -- multiway join -------------------------------------------------------------
# plan/multiway.py's MultiwayJoin: N resident build tables, one probe pass
# through all N per batch (ops/join.multiway_*). A build under pool
# pressure, or a leg the one pass cannot run exactly, falls back to the
# binary cascade, whose legs keep the partitioned spiller.


def _mw_cascade_shims(node: MultiwayJoin) -> List[HashJoin]:
    """Per-leg binary HashJoins: leg i's join with a never-executed scan
    stub standing in for the cascade intermediate (probe output plus the
    payloads of legs < i) on the left. They carry the leg's keys, kind and
    uniqueness for _JoinProber and the engine choice."""
    shims = node.__dict__.get("_mw_shims")
    if shims is None:
        shims = []
        schema = list(node.probe.output)
        for i in range(len(node.builds)):
            stub = TableScan(catalog="", table=f"__mw_cascade_{i}__",
                             assignments={}, output=list(schema))
            shims.append(HashJoin(
                kind=node.kinds[i], left=stub, right=node.builds[i],
                left_keys=list(node.probe_keys[i]),
                right_keys=list(node.build_keys[i]),
                build_unique=bool(node.build_unique[i])))
            schema = schema + list(node.builds[i].output)
        node.__dict__["_mw_shims"] = shims
    return shims


def _mw_plan_specs(node: MultiwayJoin):
    """Per leg, from the plan alone: the key sources (-1 = the probe
    batch, j >= 0 = unique build j's payload), the probe-side key dtypes
    and the pairwise-promoted compare dtypes. Memoized on the node."""
    memo = node.__dict__.get("_mw_plan")
    if memo is not None:
        return memo
    pout = dict(node.probe.output)
    bouts = [dict(b.output) for b in node.builds]
    legs = []
    for i in range(len(node.builds)):
        sources, pdts = [], []
        for sym in node.probe_keys[i]:
            if sym in pout:
                sources.append(-1)
                pdts.append(torch_dtype(pout[sym].dtype))
            else:
                for j in range(i):
                    if node.build_unique[j] and sym in bouts[j]:
                        sources.append(j)
                        pdts.append(torch_dtype(bouts[j][sym].dtype))
                        break
                else:
                    raise KeyError(
                        f"multiway probe key {sym!r} resolves against no "
                        f"probe column or earlier unique build payload")
        cdts = tuple(torch.promote_types(torch_dtype(bouts[i][bk].dtype), pd)
                     for bk, pd in zip(node.build_keys[i], pdts))
        legs.append((tuple(sources), tuple(pdts), cdts))
    node.__dict__["_mw_plan"] = legs
    return legs


class _MultiwayProber:
    """N resident build tables, probed in one pass a batch. Unique legs
    probe the sort engine's single-match table; fanout legs the hash
    engine's `join_probe` (exact counts, which a LEFT leg needs) or, for
    inner legs, the sort engine's ranges. All-unique chains (the dominant
    star shape) stay row-aligned with the probe batch; others take a
    counts pass (each hash leg's fanout starts at 16 and doubles on
    overflow) and a chunked mixed-radix expansion. `cascade` names why
    the one pass cannot run (a LEFT fanout leg without exact counts):
    the caller then falls back to the binary cascade."""

    def __init__(self, node: MultiwayJoin, ctx: ExecContext,
                 builds_in: List[Optional[Batch]], chain):
        from presto_tpu_torch.plan.stats import choose_breaker_engine

        self.node, self.ctx, self.chain = node, ctx, chain
        self.cascade = None
        self.empty = any(b is None and k == "inner"
                         for b, k in zip(builds_in, node.kinds))
        if self.empty:
            return
        self.psyms = [s for s, _ in node.probe.output]
        self.bsyms = tuple(tuple(s for s, _ in b.output)
                           for b in node.builds)
        legs = _mw_plan_specs(node)
        shims = _mw_cascade_shims(node)
        specs, tables = [], []
        for i, build_in in enumerate(builds_in):
            if build_in is None:
                # an empty LEFT leg: a table of dead rows
                schema = node.builds[i].output
                build_in = empty_batch([s for s, _ in schema],
                                       [t for _, t in schema], ctx.device)
            sources, pdts, cdts = legs[i]
            keys = tuple(node.build_keys[i])
            unique = bool(node.build_unique[i])
            hash_engine = False
            if not unique:
                try:
                    eng, _ = choose_breaker_engine(
                        shims[i], ctx.catalog, ctx.config.breaker_engine)
                except Exception:  # noqa: BLE001 — the JAX package's
                    eng = "sort"  # fallback: a failed estimate sorts
                hash_engine = (eng == "hash" and join_compare_dtypes(
                    build_in, keys, pdts) == cdts)
                if not hash_engine and node.kinds[i] == "left":
                    # sorted fanout counts can widen, which breaks a LEFT
                    # leg's null-extension: binary cascade instead
                    self.cascade = f"left fanout leg {i} lacks exact counts"
                    return
            specs.append(MwSpec(
                probe_keys=tuple(node.probe_keys[i]), build_keys=keys,
                sources=sources, kind=node.kinds[i], unique=unique,
                hash_engine=hash_engine,
                compare_dtypes=cdts if hash_engine else ()))
            tables.append(hash_build_side(build_in, keys, pdts) if hash_engine
                          else build_side(build_in, keys))
        self.specs = tuple(specs)
        self.tables = tuple(tables)
        self.fanouts = tuple(0 if sp.unique else 16 for sp in self.specs)
        self.all_unique = all(sp.unique for sp in self.specs)
        self.observe = ctx.config.hbo != "off"
        if self.observe:
            # per-leg build rows under the ORIGINAL binary joins'
            # fingerprints (stashed by the collapse pass), and device
            # accumulators for the chain's selectivity
            for i, fp in enumerate(node.__dict__.get("_leg_fps") or []):
                if fp is not None and i < len(tables):
                    ctx.defer_observation(
                        lambda actual, i=i, fp=fp: self._observe_build(
                            i, fp, actual), tables[i].n_rows)
            self._n_probe = torch.zeros((), dtype=torch.int64,
                                        device=ctx.device)
            self._n_out = torch.zeros((), dtype=torch.int64,
                                      device=ctx.device)

    def _observe_build(self, i: int, fp: str, actual: float) -> None:
        if actual > 0:
            _runstats.observe(fp, "join_build", "multiwayjoin",
                              _derived_rows(self.node.builds[i],
                                            self.ctx.catalog), actual)

    def observe_selectivity(self) -> None:
        """After the last probe batch: the chain's output rows over probe
        rows, on the node's fingerprint and the collapsed top join's."""
        if self.empty or not self.observe:
            return

        def observe(n_probe: float, n_out: float) -> None:
            if n_probe <= 0:
                return
            for fp in (_runstats.node_fingerprint(self.node,
                                                  self.ctx.catalog),
                       self.node.__dict__.get("_origin_fp")):
                if fp is not None:
                    _runstats.observe(fp, "join_probe_sel", "multiwayjoin",
                                      None, n_out / n_probe,
                                      extra={"probe_rows": n_probe})

        self.ctx.defer_observation(observe, self._n_probe, self._n_out)

    def probe_batch(self, pb_raw: Batch) -> Iterator[Batch]:
        if self.empty:
            return
        if not self.observe:
            yield from self._probe_batch(pb_raw)
            return
        for out in self._probe_batch(pb_raw):
            self._n_out = self._n_out + out.live.sum()
            yield out

    def _probe_batch(self, pb_raw: Batch) -> Iterator[Batch]:
        ctx, tables, specs = self.ctx, self.tables, self.specs
        pb = self.chain(pb_raw)
        if self.observe:
            self._n_probe = self._n_probe + pb.live.sum()
        if self.all_unique:
            yield multiway_probe_unique(tables, pb, specs, self.psyms,
                                        self.bsyms)
            return
        fanouts = self.fanouts
        state, chats, offsets, T, total, ovfs = multiway_counts(
            tables, pb, specs, fanouts)
        ovn = ovfs.cpu().numpy()
        if ovn.sum():
            # a hash leg's counts are exact but its match matrix
            # truncated: double the overflowing legs' widths until every
            # row fits
            ctx.bump("join.fanout_overflow_rows", int(ovn.sum()))
            ctx.bump("multiway.fanout_overflow_rows", int(ovn.sum()))
            while ovn.sum():
                fanouts = tuple(f * 2 if ovn[i] else f
                                for i, f in enumerate(fanouts))
                for i, f in enumerate(fanouts):
                    if (specs[i].hash_engine
                            and f > tables[i].slot_row.shape[0]):
                        raise RuntimeError(
                            "multiway join fanout exceeded build table "
                            f"capacity on leg {i}")
                ctx.bump("join.fanout_reprobes")
                state, chats, offsets, T, total, ovfs = multiway_counts(
                    tables, pb, specs, fanouts)
                ovn = ovfs.cpu().numpy()
        out_cap = pb.capacity
        tot = int(total)
        base = 0
        while True:
            yield multiway_expand(tables, pb, specs, state, chats, offsets,
                                  T, base, out_cap, self.psyms, self.bsyms)
            base += out_cap
            if base >= tot:
                break


def _mw_binary_cascade(node: MultiwayJoin, ctx: ExecContext,
                       probe_stream: Iterator[Batch], chain,
                       collected: List[List[Batch]],
                       pressure_at: Optional[int], partial: List[Batch],
                       bstream) -> Iterator[Batch]:
    """The chain as binary joins over the opened streams: leg i joins the
    cascade intermediate with build i. Builds collected before the
    pressure point replay from memory; the build at the pressure point
    resumes its partly consumed stream and it and the later legs run
    through `_join_with_spill`, so a build past the pool spills."""
    ctx.bump("multiway.cascade_fallbacks")
    if ctx.tracer.enabled:
        t = time.time()
        ctx.tracer.record("multiway_cascade", "multiway_cascade", t, t,
                          node=type(node).__name__)
    stream = probe_stream
    for i, shim in enumerate(_mw_cascade_shims(node)):
        leg_chain = chain if i == 0 else (lambda b: b)
        if pressure_at is None or i < pressure_at:
            build_in = (_collect_concat(iter(collected[i]))
                        if i < len(collected) else
                        _collect_concat(execute_node(node.builds[i], ctx)))
            stream = _join_probe(shim, ctx, build_in, stream, leg_chain)
        else:
            bs = (itertools.chain(iter(partial), bstream)
                  if i == pressure_at else execute_node(node.builds[i], ctx))
            stream = _join_with_spill(shim, ctx, stream, bs, leg_chain)
    yield from stream


def _execute_multiway_join(node: MultiwayJoin,
                           ctx: ExecContext) -> Iterator[Batch]:
    """Collect the N build sides under the pool, then probe every batch
    through all N in one pass. Pool pressure while collecting, or a leg
    the one pass cannot run exactly, falls back to the binary cascade."""
    probe_stream, chain = _fused_child(node.probe, ctx)
    ctx.bump("multiway.joins")
    ctx.bump("multiway.legs", len(node.builds))
    mctx = LocalMemoryContext(ctx.memory_pool, "mw-join-build")
    can_spill = ctx.config.spill_enabled
    rev = _RevokeFlag(ctx.memory_pool, can_spill)
    try:
        collected: List[List[Batch]] = []
        total_bytes = 0
        pressure_at = None
        partial: List[Batch] = []
        bstream = None
        for i in range(len(node.builds)):
            bstream = execute_node(node.builds[i], ctx)
            partial = []
            for b in bstream:
                nb = batch_device_bytes(b)
                partial.append(b)
                if can_spill and (rev.take() or ctx.should_spill(nb)):
                    pressure_at = i
                    break
                total_bytes += nb
                mctx.set_bytes(total_bytes)
            if pressure_at is not None:
                break
            collected.append(partial)
            partial, bstream = [], None

        if pressure_at is not None:
            yield from _mw_binary_cascade(node, ctx, probe_stream, chain,
                                          collected, pressure_at, partial,
                                          bstream)
            return
        prober = _MultiwayProber(
            node, ctx, [_collect_concat(iter(bb)) for bb in collected],
            chain)
        if prober.cascade is not None:
            yield from _mw_binary_cascade(node, ctx, probe_stream, chain,
                                          collected, None, [], None)
            return
        ctx.bump("multiway.fused_dispatches")
        for pb in probe_stream:
            yield from prober.probe_batch(pb)
        prober.observe_selectivity()
    finally:
        rev.close()
        mctx.set_bytes(0)


# -- semi joins ---------------------------------------------------------------


def _execute_semijoin(node: SemiJoin, ctx: ExecContext) -> Iterator[Batch]:
    """Semi (EXISTS, IN) and anti (NOT EXISTS, NOT IN) joins: each probe
    row is kept or dropped whole. Without a residual, the build side is a
    table of its keys; with one (correlated EXISTS with non-equi conjuncts,
    Q21), the probe expands to its candidate pairs chunk by chunk, the
    residual filters them, and a probe row exists if any pair survives."""
    right_in = _collect_concat(execute_node(node.right, ctx))
    probe_stream, chain = _fused_child(node.left, ctx)
    lkeys, rkeys = tuple(node.left_keys), tuple(node.right_keys)
    if right_in is None:
        # empty build side: semi keeps no row, anti keeps every row
        for pb in probe_stream:
            b = chain(pb)
            yield b if node.negated else b.with_live(torch.zeros_like(b.live))
        return

    if node.residual is None:
        engine = _breaker_engine_choice(node, ctx)
        ltypes = dict(node.left.output)
        probe_dtypes = tuple(torch_dtype(ltypes[lk].dtype) for lk in lkeys)
        cdt = _join_plan_cdt(ltypes, dict(node.right.output), lkeys, rkeys)
        if engine == "hash" and join_compare_dtypes(
                right_in, rkeys, probe_dtypes) != cdt:
            engine = "sort"
            node.__dict__["_breaker_engine"] = "sort"
            node.__dict__["_breaker_engine_why"] = (
                "build batch dtypes deviate from plan types")
        if engine == "hash":
            # the linear-probing table keeps duplicate build keys (a probe
            # walks the whole chain and only asks whether it matched)
            table = hash_build_side(right_in, rkeys, probe_dtypes)
        else:
            # the sort engine's unique probe needs distinct build keys
            cols = [right_in.column(r) for r in rkeys]
            keys, _, out_live, _ = grouped_merge(
                [KeyCol(c.values, c.validity) for c in cols], [],
                right_in.live, right_in.capacity)
            table = build_side(
                Batch(list(rkeys), [right_in.type_of(r) for r in rkeys],
                      [Column(k.values, k.validity) for k in keys], out_live,
                      right_in.dicts), rkeys)
        for pb in probe_stream:
            b = chain(pb)
            ba = align_probe_strings(b, lkeys, table, rkeys)
            if engine == "hash":
                _, matched = hash_probe_unique(table, ba, lkeys, cdt)
            else:
                _, matched = probe_unique(table, ba, lkeys, rkeys)
            if not node.negated:
                keep = matched
            elif node.null_aware:
                # NOT IN: a NULL probe key is NULL against a non-empty set,
                # so the row drops. (As in the JAX package, a NULL inside
                # the subquery does not drop every row.)
                key_valid = torch.ones_like(b.live)
                for lk in lkeys:
                    kv = b.column(lk).validity
                    if kv is not None:
                        key_valid = key_valid & kv
                keep = ~matched & (key_valid | (table.n_rows == 0))
            else:
                # NOT EXISTS: a NULL key never matches, so the row stays
                keep = ~matched
            yield b.with_live(b.live & keep)
        return

    lsyms = [n for n, _ in node.left.output]
    rsyms = [n for n, _ in node.right.output]
    pred = compile_predicate(node.residual)
    node.__dict__["_breaker_engine"] = "sort"
    node.__dict__["_breaker_engine_why"] = "residual semijoin"
    table = build_side(right_in, rkeys)
    for pb_raw in probe_stream:
        pb = chain(pb_raw)
        pba = align_probe_strings(pb, lkeys, table, rkeys)
        lo, counts, offsets, total, _, _ = probe_counts(table, pba, lkeys,
                                                        rkeys)
        out_cap = pb.capacity
        tot = int(total)
        exists = torch.zeros_like(pb.live)
        base = 0
        while True:
            pr, bi, ol = probe_expand(table, pba, lkeys, rkeys, lo, counts,
                                      offsets, base, out_cap)
            pair = gather_join_output(pb, table, pr, bi, ol, lsyms, rsyms)
            exists = exists | _scatter_any(pb.capacity, pr,
                                           pred(pair) & pair.live)
            base += out_cap
            if base >= tot:
                break
        keep = ~exists if node.negated else exists
        yield pb.with_live(pb.live & keep)


# -- nested-loop join -----------------------------------------------------------


def _execute_nljoin(node: NestedLoopJoin, ctx: ExecContext) -> Iterator[Batch]:
    """Nested-loop inner join (cross product / non-equi ON). Each output
    batch is one probe batch crossed with one fixed-size chunk of the
    compacted build side (probe row i, build row j at i * chunk + j), with
    the residual predicate applied to it."""
    probe_stream, chain = _fused_child(node.left, ctx)
    build = _collect_concat(execute_node(node.right, ctx))
    if build is None:
        return
    build = compact(build)  # live rows to the front
    nb = build.num_live()
    if nb == 0:
        return
    pred = (compile_predicate(node.residual)
            if node.residual is not None else None)
    out_names = [s for s, _ in node.left.output] + [
        s for s, _ in node.right.output]
    out_types = [t for _, t in node.left.output] + [
        t for _, t in node.right.output]
    for raw in probe_stream:
        pb = chain(raw)
        np_cap = pb.capacity
        # <= 512 build rows an output batch, about 2^21 output rows at
        # most (the JAX package's sizes)
        c = min(512, max(1, (1 << 21) // max(np_cap, 1)), build.capacity)
        left = [col.map_rows(lambda a: torch.repeat_interleave(a, c, 0))
                for col in pb.columns]
        plive = torch.repeat_interleave(pb.live, c, 0)
        dicts = dict(build.dicts)
        dicts.update(pb.dicts)
        for off in range(0, nb, c):
            # a chunk that would run past the build capacity starts at
            # capacity - c instead and re-reads rows of the chunk before
            # it, as the JAX package's clamped dynamic slice does (so both
            # count those pairs twice)
            lo = min(off, build.capacity - c)
            right = [col.map_rows(lambda a: a[lo:lo + c].repeat(
                         (np_cap,) + (1,) * (a.dim() - 1)))
                     for col in build.columns]
            live = plive & build.live[lo:lo + c].repeat(np_cap)
            out = Batch(out_names, out_types, left + right, live, dicts)
            if pred is not None:
                out = out.with_live(out.live & pred(out))
            yield out


# -- set operations -------------------------------------------------------------


def _align_setop_dicts(node: SetOp, batches: List[Batch]) -> List[Batch]:
    """Re-encode string columns of all batches against shared merged
    dictionaries so code equality is string equality; a side whose string
    column carries no dictionary (all NULL) gets the shared one too."""
    out = _unify_batch_dicts(batches)
    for i, t in enumerate(node.types):
        if not t.is_string:
            continue
        name = node.symbols[i]
        ds = [b.dicts[name] for b in out if b.dicts.get(name) is not None]
        if ds:
            out = [b if name in b.dicts else
                   Batch(b.names, b.types, b.columns, b.live,
                         {**b.dicts, name: ds[0]})
                   for b in out]
    return out


def _null_safe_encode(b: Batch) -> Tuple[Batch, List[str]]:
    """Rows as join keys with NULLs-equal semantics (SQL DISTINCT and set
    operations treat NULL = NULL): every column contributes a zero-filled
    value key plus a validity key, so build_side/probe never drop a NULL
    and NULL cells compare equal. Long decimals add their hi limb."""
    names, types, cols = [], [], []
    for i, c in enumerate(b.columns):
        if c.sizes is not None:
            # the JAX package fails here too (its sort takes no plane)
            raise NotImplementedError(
                "UNION, INTERSECT and EXCEPT over ARRAY or MAP columns are "
                "not supported (UNION ALL is)")
        base = f"k{i}"
        v = (c.values if c.validity is None
             else torch.where(c.validity, c.values, torch.zeros_like(c.values)))
        names.append(base)
        types.append(b.types[i])
        cols.append(Column(v, None))
        names.append(base + "$v")
        types.append(BIGINT)
        cols.append(Column(c.valid_mask().to(torch.int64), None))
        if c.hi is not None:
            hv = (c.hi if c.validity is None
                  else torch.where(c.validity, c.hi, torch.zeros_like(c.hi)))
            names.append(base + "$hi")
            types.append(BIGINT)
            cols.append(Column(hv, None))
    return Batch(names, types, cols, b.live, {}), names


def _distinct_rows(b: Batch) -> Batch:
    """Keep one row per distinct tuple (NULLs equal): sort by every
    null-safe key, keep the first row of each run. Full rows survive
    (validity and hi limbs), unlike grouped_merge, which rebuilds
    columns."""
    enc, _ = _null_safe_encode(b)
    operands = [(~b.live).to(torch.int32)] + [c.values for c in enc.columns]
    perm = lex_sort_permutation(operands)
    first = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
    first[0] = True
    for op in operands:
        sk = op[perm]
        first[1:] |= sk[1:] != sk[:-1]
    out = permute_batch(b, perm)
    return out.with_live(out.live & first)


def _execute_setop(node: SetOp, ctx: ExecContext) -> Iterator[Batch]:
    """UNION [ALL] / INTERSECT / EXCEPT: UNION ALL streams both sides;
    UNION sorts the rows once and keeps the first of each run; INTERSECT
    and EXCEPT probe the left side's distinct rows against a table of the
    right side's rows (the sort engine's unique probe over the null-safe
    encoding); the ALL forms count rows on the host."""
    syms = node.symbols

    def renamed(child):
        for b in execute_node(child, ctx):
            yield b.rename(syms)

    if node.all and node.kind == "union":
        yield from renamed(node.left)
        yield from renamed(node.right)
        return

    lb = _collect_concat(renamed(node.left))
    rb = _collect_concat(renamed(node.right))
    if node.kind == "union":
        sides = [b for b in (lb, rb) if b is not None]
        if not sides:
            return
        sides = _align_setop_dicts(node, sides)
        merged = sides[0] if len(sides) == 1 else _concat2(sides[0], sides[1])
        yield _distinct_rows(merged)
        return

    # INTERSECT / EXCEPT
    if lb is None:
        return
    if rb is None:
        if node.kind == "except":
            yield lb if node.all else _distinct_rows(lb)
        return
    lb, rb = _align_setop_dicts(node, [lb, rb])
    if node.all:
        yield _multiset_setop(node, lb, rb)
        return
    ld = _distinct_rows(lb)
    lenc, keys = _null_safe_encode(ld)
    renc, _ = _null_safe_encode(rb)
    table = build_side(renc, tuple(keys))
    _, matched = probe_unique(table, lenc, tuple(keys), tuple(keys))
    keep = matched if node.kind == "intersect" else ~matched
    yield ld.with_live(ld.live & keep)


def _multiset_setop(node: SetOp, lb: Batch, rb: Batch) -> Batch:
    """INTERSECT ALL / EXCEPT ALL: per distinct left row, min(cl, cr) or
    max(cl - cr, 0) copies. The rows are counted on the host over their
    null-safe encodings (copied there, as the JAX package does), then one
    device gather replicates the chosen row indices."""
    live_l = lb.live.cpu().numpy()
    orig_idx = np.nonzero(live_l)[0]
    lenc, _ = _null_safe_encode(lb)
    renc, _ = _null_safe_encode(rb)

    def rows_of(enc: Batch, live):
        cols = [c.values.cpu().numpy()[live] for c in enc.columns]
        return (np.stack(cols, axis=1) if cols
                else np.zeros((int(live.sum()), 0)))

    lrows = rows_of(lenc, live_l)
    rrows = rows_of(renc, rb.live.cpu().numpy())
    uniq, first_pos, lcnt = np.unique(lrows, axis=0, return_index=True,
                                      return_counts=True)
    rcounts: dict = {}
    for row in map(tuple, rrows):
        rcounts[row] = rcounts.get(row, 0) + 1
    reps = np.empty(len(uniq), np.int64)
    for i, row in enumerate(map(tuple, uniq)):
        cr = rcounts.get(row, 0)
        reps[i] = (min(int(lcnt[i]), cr) if node.kind == "intersect"
                   else max(int(lcnt[i]) - cr, 0))
    out_idx = np.repeat(orig_idx[first_pos], reps)
    n = len(out_idx)
    cap = round_up_capacity(max(n, 1))
    idx = np.zeros(cap, np.int64)
    idx[:n] = out_idx
    live = np.zeros(cap, bool)
    live[:n] = True
    didx = torch.as_tensor(idx, device=lb.device)
    return Batch(lb.names, lb.types, [c.gather(didx) for c in lb.columns],
                 torch.as_tensor(live, device=lb.device), lb.dicts)


# -- window -----------------------------------------------------------------------


def _execute_window(node: Window, ctx: ExecContext) -> Iterator[Batch]:
    """Pipeline breaker: materialize the input, sort once by (partition
    keys, order keys), compute every function of the node's spec as vector
    ops (ops/window.py), emit one batch with the window columns appended
    (reference: WindowOperator.java:47 over a PagesIndex)."""
    acc = _collect_concat(execute_node(node.child, ctx))
    if acc is None:
        return
    yield _window_compute(node, acc)


def _window_compute(node: Window, b: Batch) -> Batch:
    from presto_tpu_torch.ops import window as W

    child_types = dict(node.child.output)
    keys = [SortKey(b.column(pk).values, b.column(pk).validity)
            for pk in node.partition_keys]
    for oi in node.order_items:
        c = b.column(oi.symbol)
        nf = oi.nulls_first
        if nf is None:
            nf = not oi.ascending  # SQL default: NULLS LAST for ASC
        keys.append(SortKey(c.values, c.validity, not oi.ascending, nf))
    sb = permute_batch(b, sort_permutation(keys, b.live))
    part_cols = [(sb.column(pk).values, sb.column(pk).validity)
                 for pk in node.partition_keys]
    order_cols = [(sb.column(oi.symbol).values, sb.column(oi.symbol).validity)
                  for oi in node.order_items]
    wk = W.window_keys(part_cols, order_cols, sb.live)

    rng_kw = {"order_vals": None}
    if (any(f.frame and f.frame.startswith("range:") for f in node.funcs)
            and node.order_items):
        # RANGE value offsets: the single order key, ascending-ized (negated
        # for DESC), in its native domain — int64 for integral, decimal and
        # date keys, so boundary compares are exact; decimals compare
        # unscaled with the offset scaled by 10^scale
        oi = node.order_items[0]
        oc = sb.column(oi.symbol)
        ot = child_types.get(oi.symbol)
        ov = oc.values
        ov = (ov.to(torch.float64) if ov.is_floating_point()
              else ov.to(torch.int64))
        if not oi.ascending:
            ov = -ov  # NaN survives negation; the bounds mask it
        nf = oi.nulls_first
        if nf is None:
            nf = not oi.ascending
        rng_kw = {"order_vals": ov, "order_valid": oc.validity,
                  "nulls_first": nf,
                  "offset_scale": (10 ** ot.scale
                                   if isinstance(ot, DecimalType) else 1)}

    def as_double(vals, arg):
        # avg computes in double; decimals are unscaled integers
        t = child_types.get(arg)
        return unscale(vals.to(torch.float64),
                       t.scale if isinstance(t, DecimalType) else 0)

    out = sb
    for f in node.funcs:
        bounded = f.frame is not None and f.frame.startswith(("rows:",
                                                              "range:"))
        if f.fn in ("row_number", "rank", "dense_rank", "percent_rank",
                    "cume_dist"):
            v, valid = getattr(W, f.fn)(wk)
        elif f.fn == "ntile":
            v, valid = W.ntile(wk, f.param)
        elif f.fn in ("lag", "lead"):
            c = sb.column(f.arg)
            v, valid = getattr(W, f.fn)(
                wk, c.values, c.validity,
                f.param if f.param is not None else 1, f.default)
        elif f.fn in ("first_value", "last_value", "nth_value"):
            c = sb.column(f.arg)
            if bounded:
                v, valid = W.value_over_frame(
                    wk, f.fn, c.values, c.validity, f.frame,
                    f.param if f.param is not None else 1, **rng_kw)
            elif f.fn == "nth_value":
                v, valid = W.nth_value(wk, c.values, c.validity, f.param)
            else:
                v, valid = getattr(W, f.fn)(wk, c.values, c.validity)
        elif f.fn in ("sum", "avg", "min", "max", "count"):
            if not node.order_items:
                frame = "whole"
            elif f.frame == "rows_unbounded_current":
                frame = "rows"
            else:
                frame = "range"
            if f.arg is None:
                vals, validity, is_float = (
                    torch.zeros(sb.capacity, dtype=torch.int64,
                                device=sb.device), None, False)
                fn = "count"
            else:
                c = sb.column(f.arg)
                vals, validity = c.values, c.validity
                is_float = vals.is_floating_point()
                fn = f.fn
                if fn == "avg" and not is_float:
                    vals, is_float = as_double(vals, f.arg), True
            if bounded:
                v, valid = W.agg_window_bounded(wk, fn, vals, validity,
                                                f.frame, is_float, **rng_kw)
            else:
                v, valid = W.agg_window(wk, fn, vals, validity, frame,
                                        is_float)
        else:
            raise NotImplementedError(
                f"window function {f.fn} is not supported by "
                "presto_tpu_torch yet")
        dict_ = (sb.dict_of(f.arg)
                 if f.arg is not None and f.type.is_string else None)
        out = out.with_column(f.symbol, f.type,
                              Column(v.to(torch_dtype(f.type.dtype)), valid),
                              dictionary=dict_)
    return out


# -- sort -----------------------------------------------------------------------


def _sort_keys(node: Sort, b: Batch) -> List[SortKey]:
    keys = []
    for k in node.keys:
        c = b.column(k.symbol)
        nulls_first = k.nulls_first
        if nulls_first is None:
            nulls_first = not k.ascending  # SQL default: NULLS LAST for ASC
        if c.hi is not None:
            # long decimal sorts by (hi, lo): lo is the canonical
            # nonnegative low limb
            keys.append(SortKey(c.hi, c.validity, not k.ascending, nulls_first))
        keys.append(SortKey(c.values, c.validity, not k.ascending, nulls_first))
    return keys


def _concat2(a: Batch, b: Batch) -> Batch:
    caps = [a.capacity, b.capacity]
    cols = [concat_columns([a.columns[i], b.columns[i]], caps)
            for i in range(len(a.names))]
    dicts = dict(a.dicts)
    dicts.update(b.dicts)
    return Batch(a.names, a.types, cols, torch.cat([a.live, b.live]), dicts)


def _execute_sort(node: Sort, ctx: ExecContext) -> Iterator[Batch]:
    in_stream, chain = _fused_child(node.child, ctx)
    if node.limit is not None:
        # TopN: merge each batch into a heap of capacity round_up(limit)
        cap = round_up_capacity(node.limit)
        acc: Optional[Batch] = None
        for raw in in_stream:
            b = chain(raw)
            if acc is not None:
                acc, b = _unify_batch_dicts([acc, b])
                b = _concat2(acc, b)
            out = sort_batch(b, _sort_keys(node, b), limit=node.limit)
            acc = _truncate(out, cap)
        if acc is not None:
            yield acc
        return
    full = _collect_concat(chain(b) for b in in_stream)
    if full is not None:
        yield sort_batch(full, _sort_keys(node, full))


# ---------------------------------------------------------------------------
# plan entry


def bind_scalar_subqueries(qp: QueryPlan, ctx: ExecContext) -> None:
    """Run each uncorrelated scalar subquery of the plan and bind its value
    into the plan as a raw Constant. A subquery must give exactly one row
    (a global aggregate always does; over no input its value is NULL)."""
    if not qp.scalar_subqueries:
        return
    bindings = {}
    for sym, sub in qp.scalar_subqueries.items():
        sub_out = run_plan(sub, ctx)
        vals = sub_out.to_pydict(decode_strings=False)[sub_out.names[0]]
        if len(vals) != 1:
            raise RuntimeError(f"scalar subquery returned {len(vals)} rows")
        bindings[sym] = Constant(sub_out.types[0], vals[0], raw=True)
    _bind_plan_params(qp.root, bindings)


def _bind_plan_params(node: PlanNode, bindings) -> None:
    if isinstance(node, Filter):
        node.predicate = substitute_params(node.predicate, bindings)
    elif isinstance(node, Project):
        node.exprs = [(s, substitute_params(e, bindings)) for s, e in node.exprs]
    elif isinstance(node, HashJoin) and node.residual is not None:
        node.residual = substitute_params(node.residual, bindings)
    for c in node.children():
        _bind_plan_params(c, bindings)


def run_plan(qp: QueryPlan, ctx: ExecContext) -> Batch:
    """Execute a QueryPlan to one compacted Batch on the context's device,
    under the tracer's `query` span. Whatever spill files the operators
    left open (a query that failed mid-spill) are closed and unlinked on
    the way out."""
    try:
        with _obs_trace.use(ctx.tracer), ctx.tracer.span("query", "query"):
            if ctx.config.devprof != "on":
                return _run_plan_inner(qp, ctx)
            # devprof: allocator watermarks at the query's boundaries and
            # a ledger-vs-device reconciliation once the pool's peak is
            # final
            _devprof.activate(ctx.device)
            start = _devprof.begin_query()
            try:
                return _run_plan_inner(qp, ctx)
            finally:
                delta = _devprof.end_query(start)
                if delta is not None:
                    ctx.stats["devprof.peak_delta_bytes"] = delta
                rec = _devprof.reconcile(ctx.memory_pool, plane="worker",
                                         site="local_query")
                if rec is not None:
                    ctx.stats["devprof.drift_ratio"] = rec["driftRatio"]
    finally:
        ctx.cleanup_spill()


def _run_plan_inner(qp: QueryPlan, ctx: ExecContext) -> Batch:
    bind_scalar_subqueries(qp, ctx)
    if not qp.__dict__.get("_colocated_tagged"):
        # local grouped execution: joins of tables bucketed alike run
        # bucket by bucket (the fragmenter marks them for a cluster)
        from presto_tpu_torch.plan.fragmenter import tag_colocated_joins

        tag_colocated_joins(qp.root, ctx.catalog)
        qp.__dict__["_colocated_tagged"] = True
    out_node = qp.root
    merged = _collect_concat(execute_node(out_node.child, ctx))
    _hbo_record_scans(qp.root, ctx)
    if merged is None:
        types = dict(out_node.child.output)
        merged = empty_batch(out_node.symbols,
                             [types[s] for s in out_node.symbols],
                             ctx.device)
    merged = merged.select(out_node.symbols).rename(out_node.names)
    out = compact(merged)
    ctx.flush_observations()
    return out


def mark_breaker_engines(root: PlanNode, ctx: ExecContext) -> None:
    """Stamp each breaker's engine verdict on the plan (for EXPLAIN)."""
    if isinstance(root, (Aggregate, HashJoin, SemiJoin)):
        _breaker_engine_choice(root, ctx)
    for c in root.children():
        mark_breaker_engines(c, ctx)
