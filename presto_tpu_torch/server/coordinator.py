"""Coordinator — control plane: discovery, node health, distributed
scheduling, result collection.

Reference surface:
- metadata/DiscoveryNodeManager.java + embedded airlift discovery: workers
  announce themselves; the coordinator tracks active nodes
- failureDetector/HeartbeatFailureDetector.java:77,225,360: periodic pings
  with a decaying failure-rate gate; failed nodes are excluded from
  scheduling
- execution/scheduler/SqlQueryScheduler.java:640,657 + SqlStageExecution +
  server/remotetask/HttpRemoteTask.java:336: stage-by-stage task creation
  over HTTP
- ClusterSizeMonitor: gate query start on minimum workers

Fragments are scheduled one task per worker (HASH/SOURCE) or one task
(SINGLE); producers are created before consumers (ascending fragment id =
topological order), everything runs concurrently and streams through the
pull exchange.

The JAX package's server/coordinator.py, without what the port does not
have yet: the observability hooks (traces, events, lifecycle, inflight,
device profiles, metrics; ROADMAP item 14), the compile farm (item 12),
and the result cache, resource groups, cluster memory manager, security,
TLS, proxy, web UI and function listing (the cluster services, item 17).
The coordinator runs on CUDA unless it is given another device: scalar
subqueries bind there and the result pages land there. Every HTTP call
has a timeout (`timeout_s`); `query_timeout_s` bounds a query's wait for
its result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Union

import torch

from presto_tpu_torch import default_device
from presto_tpu_torch.batch import Batch, empty_batch
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec.runtime import (
    ExecConfig,
    ExecContext,
    _collect_concat,
    bind_scalar_subqueries,
    count_batch,
)
from presto_tpu_torch.obs import devprof as _devprof
from presto_tpu_torch.obs import events as _obs_events
from presto_tpu_torch.obs import inflight as _obs_inflight
from presto_tpu_torch.obs import lifecycle as _obs_lifecycle
from presto_tpu_torch.obs import metrics as _obs_metrics
from presto_tpu_torch.obs import runstats as _runstats
from presto_tpu_torch.obs import trace as _obs_trace
from presto_tpu_torch.ops.sort import compact
from presto_tpu_torch.plan.fragmenter import (
    SINGLE,
    SOURCE,
    DistributedPlan,
    fragment_plan,
    strip_runtime_state,
)
from presto_tpu_torch.server.exchange import (
    DEFAULT_TIMEOUT_S,
    ExchangeClient,
    ExchangeFailure,
)
from presto_tpu_torch.server.worker import TaskUpdate


class NodeInfo:
    def __init__(self, node_id: str, uri: str):
        self.node_id = node_id
        self.uri = uri
        self.last_seen = time.monotonic()
        # decayed failure counter (HeartbeatFailureDetector's
        # DecayCounter(0.1) moral equivalent)
        self.failure_score = 0.0
        self.state = "active"

    def record_success(self):
        self.last_seen = time.monotonic()
        self.failure_score *= 0.5

    def record_failure(self):
        self.failure_score = self.failure_score * 0.8 + 1.0

    @property
    def failed(self) -> bool:
        return self.failure_score > 4.0


class NodeManager:
    """Registry of announced worker nodes (DiscoveryNodeManager analog)."""

    def __init__(self, expire_s: float = 30.0):
        self.nodes: Dict[str, NodeInfo] = {}
        self._lock = threading.Lock()
        self.expire_s = expire_s

    def announce(self, node_id: str, uri: str, state: str = "active"):
        with self._lock:
            n = self.nodes.get(node_id)
            if n is None or n.uri != uri:
                n = NodeInfo(node_id, uri)
                self.nodes[node_id] = n
            else:
                n.record_success()
            # the worker's own announcement is authoritative for its state —
            # a restarted worker reusing node_id/uri returns to rotation
            n.state = "active" if state == "active" else "draining"

    def active_nodes(self) -> List[NodeInfo]:
        now = time.monotonic()
        with self._lock:
            return [
                n for n in self.nodes.values()
                if not n.failed and n.state == "active"
                and now - n.last_seen < self.expire_s
            ]

    def remove(self, node_id: str):
        with self._lock:
            self.nodes.pop(node_id, None)


class HeartbeatFailureDetector:
    """Background prober: GET /v1/status on every known node; nodes whose
    decayed failure score crosses the threshold are excluded from
    scheduling (HeartbeatFailureDetector.java:360 ping loop)."""

    def __init__(self, node_manager: NodeManager, interval_s: float = 2.0,
                 timeout_s: float = 5.0):
        self.node_manager = node_manager
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="failure-detector")

    def start(self):
        self.thread.start()

    def _probe(self, n: NodeInfo):
        try:
            with urllib.request.urlopen(f"{n.uri}/v1/status",
                                        timeout=self.timeout_s) as r:
                status = json.loads(r.read())
            if status.get("state") in ("shutting_down", "shut_down"):
                n.state = "draining"
            else:
                n.record_success()
        except Exception:  # noqa: BLE001 — any failure counts against the node
            n.record_failure()
            return
        progress = status.get("queryProgress")
        if progress:
            # lifecycle plane: the worker's live per-query row counts
            # (attempt ids resolve through the registry's alias map)
            _obs_lifecycle.merge_worker_progress(n.node_id, progress)
        inflight = status.get("queryInflight")
        if inflight:
            # inflight plane: per-task operator watermarks, merged per
            # fragment (seq-guarded: an in-process cluster's publishers
            # already live in the registry)
            _obs_inflight.merge_worker(n.node_id, inflight)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            # concurrent probes: one hung worker must not stall detection of
            # the others (reference pings asynchronously per service)
            probes = [
                threading.Thread(target=self._probe, args=(n,), daemon=True)
                for n in list(self.node_manager.nodes.values())
            ]
            for t in probes:
                t.start()
            for t in probes:
                t.join(timeout=self.timeout_s + 1)

    def stop(self):
        self._stop.set()


class ClusterSizeMonitor:
    def __init__(self, node_manager: NodeManager, min_workers: int = 1):
        self.node_manager = node_manager
        self.min_workers = min_workers

    def wait_for_minimum(self, timeout_s: float = 30.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.node_manager.active_nodes()) >= self.min_workers:
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"insufficient active workers "
            f"({len(self.node_manager.active_nodes())} < {self.min_workers})"
        )


class QueryFailed(RuntimeError):
    """`retryable=True` marks failures caused by worker/transport loss
    (worth re-running on the surviving cluster); deterministic task errors
    stay non-retryable — the reference's RetryPolicy.QUERY makes the same
    distinction."""

    def __init__(self, msg: str, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


def compute_phases(frags) -> Dict[int, int]:
    """PhasedExecutionSchedule analog (execution/scheduler/
    PhasedExecutionSchedule.java): fragments feeding a join BUILD side get
    an earlier phase than the probe's fragment, so probe-side scans don't
    hold memory while the build is still assembling. Streaming producers
    (exchanges that pipeline: partial→final agg, sort inputs) share their
    consumer's phase. Returns fid → 0-based phase (ascending start order)."""
    from presto_tpu_torch.plan.nodes import (
        HashJoin,
        NestedLoopJoin,
        RemoteSource,
        SemiJoin,
    )

    build_deps: Dict[int, set] = {fid: set() for fid in frags}
    stream_deps: Dict[int, set] = {fid: set() for fid in frags}

    def walk(n, fid, in_build):
        if isinstance(n, RemoteSource):
            (build_deps if in_build else stream_deps)[fid].add(n.fragment_id)
            return
        if isinstance(n, (HashJoin, SemiJoin, NestedLoopJoin)):
            walk(n.left, fid, in_build)
            walk(n.right, fid, True)  # build side
            return
        for c in n.children():
            walk(c, fid, in_build)

    for fid, f in frags.items():
        walk(f.root, fid, False)
    # consumers first (producers have lower fids — fragmenter numbers
    # topologically), so each fragment's phase is final before its deps'
    phase: Dict[int, int] = {}
    for fid in sorted(frags, reverse=True):
        phase.setdefault(fid, 0)
        for dep in stream_deps[fid]:
            phase[dep] = min(phase.get(dep, phase[fid]), phase[fid])
        for dep in build_deps[fid]:
            phase[dep] = min(phase.get(dep, phase[fid] - 1), phase[fid] - 1)
    lo = min(phase.values())
    return {fid: p - lo for fid, p in phase.items()}


def _fragment_scans(root) -> list:
    """All TableScan nodes of a fragment (split-placement candidates)."""
    from presto_tpu_torch.plan.nodes import TableScan

    out = []

    def walk(n):
        if isinstance(n, TableScan):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(root)
    return out


def _affinity_assign(table: str, n_splits: int,
                     worker_keys: List[str]) -> List[List[int]]:
    """Rendezvous-hash split placement with a balance cap (reference:
    scheduler/NodeScheduler.java + SimpleNodeSelector and the
    SOFT_AFFINITY NodeSelectionStrategy of connector split sources).

    Each split ranks every worker by fnv64(table:ordinal:worker) and
    lands on its best-ranked worker that still has capacity
    (cap = ⌈splits/workers⌉, the maxSplitsPerNode analog). The mapping is
    deterministic across queries AND coordinator restarts, so a worker
    keeps seeing the same splits — its device split cache turns that
    stability into scan locality. When a worker joins/leaves, only the
    splits hashed to it move (rendezvous minimal-disruption property)."""
    from presto_tpu_torch.dictionary import fnv64

    k = len(worker_keys)
    cap = -(-n_splits // k) if n_splits else 0
    counts = [0] * k
    out: List[List[int]] = [[] for _ in range(k)]
    for j in range(n_splits):
        ranked = sorted(
            range(k),
            key=lambda w: fnv64(f"{table}:{j}:{worker_keys[w]}"),
            reverse=True)
        for w in ranked:
            if counts[w] < cap:
                out[w].append(j)
                counts[w] += 1
                break
    return out


class DistributedScheduler:
    """Schedules a DistributedPlan onto workers and streams the result
    (SqlQueryScheduler.schedule:657 analog). Policies
    (SystemSessionProperties EXECUTION_POLICY): "all-at-once" starts every
    stage immediately; "phased" creates each phase's tasks only after the
    previous phase's (join-build) tasks finished — see compute_phases."""

    def __init__(self, config: Optional[ExecConfig] = None,
                 cluster_secret: Optional[str] = None,
                 on_worker_lost=None, catalog=None,
                 device: Union[str, torch.device] = "cpu",
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 query_timeout_s: Optional[float] = None):
        self.config = config or ExecConfig()
        self.cluster_secret = cluster_secret
        # notified with the NodeInfo of a worker found dead during task
        # placement/phase waits (the coordinator excludes it from rotation
        # immediately, like the pre-retry reprobe does)
        self.on_worker_lost = on_worker_lost
        # catalog access enables coordinator-side split placement
        # (soft-affinity scheduling); without it tasks fall back to the
        # static task_index::n_tasks striding
        self.catalog = catalog
        self.device = device
        self.timeout_s = timeout_s
        self.query_timeout_s = query_timeout_s

    def _headers(self, extra: Optional[dict] = None) -> dict:
        h = dict(extra or {})
        if self.cluster_secret is not None:
            h["X-Presto-Cluster-Secret"] = self.cluster_secret
        return h

    def execute(self, query_id: str, dplan: DistributedPlan,
                workers: List[NodeInfo],
                config: Optional[ExecConfig] = None,
                stats_out: Optional[list] = None, tracer=None,
                on_batch=None):
        """Schedule the plan's tasks and stream the root fragment's output.

        `stats_out`, when given, is filled with one (task_id, fragment_id,
        task_info) per task after the result stream completes — the
        per-task stats rollup EXPLAIN ANALYZE renders. `tracer` makes every
        task-create POST carry the query's trace token; after the stream
        completes each task's span dump is pulled and stitched into query
        → stage → task. `on_batch(rows)` sees each root batch's live rows,
        read from its page header."""
        config = config or self.config
        tracer = tracer or _obs_trace.NOOP
        trace_parent = tracer.current_parent()
        trace_hdrs = ({_obs_trace.TRACE_HEADER: tracer.token(trace_parent)}
                      if tracer.enabled else {})
        deadline = (None if self.query_timeout_s is None
                    else time.monotonic() + self.query_timeout_s)
        if not workers:
            raise QueryFailed("no active workers")
        frags = dplan.fragments
        # task counts per fragment (FIXED_HASH → one per worker; SINGLE → 1)
        n_tasks = {
            fid: 1 if f.partitioning == SINGLE else len(workers)
            for fid, f in frags.items()
        }
        # Recoverable grouped execution (reference:
        # SystemSessionProperties.java:69 recoverable_grouped_execution +
        # StageExecutionDescriptor + FixedSourcePartitionedScheduler):
        # a grouped SOURCE fragment (colocated bucketed join) is scheduled
        # ONE TASK PER LIFESPAN (task_index=b, n_tasks=B sweeps exactly
        # bucket b) in its own phase with spooled output; a worker lost
        # mid-phase re-runs only its UNFINISHED bucket tasks on survivors —
        # finished lifespans are never redone. Consumers launch only after
        # the gate, so a dead producer has contributed nothing downstream.
        grouped: Dict[int, int] = {}
        if config.recoverable_grouped_execution:
            for fid, f in frags.items():
                # only fully self-contained fragments qualify: one with a
                # remote source would be forced into phase 0 BEFORE its
                # producers (broadcast build feeding the colocated join)
                if (f.partitioning == SOURCE and fid != dplan.root_fid
                        and not f.remote_sources()):
                    B = _fragment_lifespans(f.root)
                    if B:
                        grouped[fid] = B
                        n_tasks[fid] = B
        # consumer fragment of each producer (tree: exactly one consumer)
        consumer: Dict[int, int] = {}
        for fid, f in frags.items():
            for rs in f.remote_sources():
                consumer[rs.fragment_id] = fid
        # output partition count = consumer's task count
        n_out = {
            fid: n_tasks[consumer[fid]] if fid in consumer else 1
            for fid in frags
        }
        # soft-affinity split placement (NodeScheduler analog): for each
        # single-scan SOURCE fragment, enumerate the connector's splits
        # HERE and pin each ordinal to a worker by rendezvous hash. A
        # rescheduled task keeps its index → its ordinals, so coverage
        # survives worker loss. Multi-scan fragments (colocated bucket
        # joins) keep aligned task_index striding.
        # fid → per-task (ordinals-by-table, enumeration-count-by-table)
        split_assignments: Dict[int, List[tuple]] = {}
        if self.catalog is not None and config.split_affinity:
            wkeys = [w.uri for w in workers]
            for fid, f in frags.items():
                if f.partitioning != SOURCE or fid in grouped:
                    continue
                scans = _fragment_scans(f.root)
                if len(scans) != 1:
                    continue
                scan = scans[0]
                try:
                    conn = self.catalog.connectors[scan.catalog]
                    handle = conn.get_table(scan.table)
                    nrows = int(handle.row_count or 0)
                    nsplits = max(1, -(-nrows // config.batch_rows))
                    n = len(conn.splits(handle, nsplits))
                except Exception:  # noqa: BLE001 — not enumerable here
                    continue  # → static striding
                per_worker = _affinity_assign(scan.table, n, wkeys)
                split_assignments[fid] = [
                    ({scan.table: per_worker[i % len(workers)]},
                     {scan.table: n})
                    for i in range(n_tasks[fid])
                ]
        phased = config.execution_policy == "phased"
        phases = (compute_phases(frags) if phased
                  else {fid: 0 for fid in frags})
        if grouped:
            # grouped fragments run (and gate) first; everything else keeps
            # its relative phasing shifted after them
            phases = {fid: (0 if fid in grouped else phases[fid] + 1)
                      for fid in frags}
        last_phase = max(phases.values())

        task_urls: Dict[int, List[str]] = {}
        assignments = []  # (task_id, worker, fragment id, index, phase)
        for fid in sorted(frags):
            cnt = n_tasks[fid]
            urls = []
            for i in range(cnt):
                w = workers[i % len(workers)]
                tid = f"{query_id}.{fid}.{i}"
                assignments.append((tid, w, fid, i, phases[fid]))
                urls.append(f"{w.uri}/v1/task/{tid}")
            task_urls[fid] = urls

        def post_task(tid, w, fid, i):
            """Create the task on `w`, resolving upstream buffer URLs from
            the CURRENT task_urls (rescheduled producers re-point them)."""
            from presto_tpu_torch.plan.codec import task_update_to_json

            f = frags[fid]
            upstreams = {
                rs.fragment_id: [
                    f"{u}/results/{i}" for u in task_urls[rs.fragment_id]
                ]
                for rs in f.remote_sources()
            }
            strip_runtime_state(f.root)
            sa = split_assignments.get(fid)
            update = TaskUpdate(
                fragment=f,
                task_index=i,
                n_tasks=n_tasks[fid],
                n_out_partitions=n_out[fid],
                upstreams=upstreams,
                config=dataclasses.asdict(config),
                # a build-phase task's consumers don't exist yet:
                # spool its output instead of blocking on back-pressure
                spool=phases[fid] < last_phase,
                split_assignment=None if sa is None else sa[i][0],
                split_counts=None if sa is None else sa[i][1],
            )
            body = json.dumps(task_update_to_json(update)).encode()
            req = urllib.request.Request(
                f"{w.uri}/v1/task/{tid}", data=body, method="POST",
                headers=self._headers({"Content-Type": "application/json",
                                       **trace_hdrs}),
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                info = json.loads(r.read())
            if info.get("state") == "failed":
                raise QueryFailed(info.get("error") or "task failed")

        created = []
        dead: set = set()

        def mark_dead(x):
            dead.add(id(x))
            x.record_failure()
            if self.on_worker_lost is not None:
                self.on_worker_lost(x)

        def reschedule(tid, w, fid, i):
            """Re-run ONE lost task on a surviving worker, walking past
            survivors that also turn out dead."""
            mark_dead(w)
            attempt = int(tid.rsplit(".r", 1)[1]) + 1 if ".r" in tid else 1
            while True:
                survivors = [x for x in workers if id(x) not in dead]
                if not survivors:
                    # retryable: the query-level loop re-probes the cluster
                    # (pruning truly-dead nodes) before giving up
                    raise QueryFailed(
                        "no surviving workers to re-place lost tasks on",
                        retryable=True)
                if attempt > len(workers):
                    raise QueryFailed(f"task {tid} exhausted re-placement "
                                      f"retries")
                nw = survivors[i % len(survivors)]
                ntid = f"{query_id}.{fid}.{i}.r{attempt}"
                try:
                    post_task(ntid, nw, fid, i)
                except (urllib.error.URLError, OSError):
                    mark_dead(nw)
                    attempt += 1
                    continue
                task_urls[fid][i] = f"{nw.uri}/v1/task/{ntid}"
                created.append((ntid, nw))
                return ntid, nw

        completed = False
        try:
            # phase by phase; within a phase producers first (ascending fid
            # = topological order). All-at-once has exactly one phase.
            for ph in range(last_phase + 1):
                phase_tids = []
                for tid, w, fid, i, p in assignments:
                    if p != ph:
                        continue
                    try:
                        if id(w) in dead:
                            raise urllib.error.URLError("worker known dead")
                        post_task(tid, w, fid, i)
                        created.append((tid, w))
                        phase_tids.append((tid, w, fid, i))
                    except (urllib.error.URLError, OSError):
                        # creation-time loss: any task is re-placeable on a
                        # survivor BEFORE its consumers wire upstreams
                        # (producers post first — ascending fid order)
                        ntid, nw = reschedule(tid, w, fid, i)
                        phase_tids.append((ntid, nw, fid, i))
                if ph < last_phase:
                    # gate the next phase on this (build) phase finishing
                    wait_s = config.phase_wait_timeout_s
                    if deadline is not None:
                        wait_s = min(wait_s, deadline - time.monotonic())
                    self._wait_finished(
                        phase_tids, timeout_s=wait_s,
                        on_lost=(reschedule if ph == 0 and grouped
                                 else None))
            # stream the root fragment's single output buffer
            root_urls = [f"{u}/results/0" for u in task_urls[dplan.root_fid]]
            client = ExchangeClient(root_urls, device=self.device,
                                    timeout_s=self.timeout_s,
                                    deadline=deadline)
            stream_w0 = time.time()
            waited = 0.0
            try:
                it = client.counted_batches()
                while True:
                    w0 = time.perf_counter()
                    try:
                        b, rows = next(it)
                    except StopIteration:
                        break
                    dt = time.perf_counter() - w0
                    waited += dt
                    if tracer.enabled:
                        _obs_metrics.EXCHANGE_WAIT.observe(
                            dt, plane="coordinator")
                    if on_batch is not None:
                        on_batch(rows)
                    yield b
                completed = True
            finally:
                client.close()
                if tracer.enabled:
                    tracer.record("exchange_wait", "exchange_wait",
                                  stream_w0, time.time(),
                                  parent_id=trace_parent,
                                  fragment=dplan.root_fid,
                                  wait_s=round(waited, 6))
            if stats_out is not None:
                for tid, w in created:
                    m = _TID_RE.match(tid)
                    stats_out.append((tid, int(m.group(2)) if m else -1,
                                      self._get_json(
                                          f"{w.uri}/v1/task/{tid}/status",
                                          trace_hdrs)))
            if tracer.enabled:
                self._collect_task_traces(tracer, created, trace_parent,
                                          trace_hdrs)
        except ExchangeFailure as e:
            raise QueryFailed(str(e), retryable=not e.task_error) from e
        finally:
            # abort on ANY early exit — including GeneratorExit when the
            # consumer abandons the stream (client disconnect / LIMIT) —
            # so worker tasks and buffers are always released
            if not completed:
                self._abort(created)

    def _get_json(self, url: str, extra_headers: dict) -> dict:
        req = urllib.request.Request(url, headers=self._headers(extra_headers))
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def _collect_task_traces(self, tracer, created, trace_parent,
                             extra_headers):
        """Stitch the distributed trace: pull every created task's span
        dump (GET /v1/task/{id}/trace, bounded by the HTTP timeout), group
        by fragment, synthesize one `stage` span per fragment (the envelope
        of its tasks' spans) under the query root, and re-parent each task
        root onto its stage span. An unreachable worker leaves a hole: the
        trace is best effort."""
        by_fid: Dict[int, list] = {}
        for tid, w in created:
            m = _TID_RE.match(tid)
            fid = int(m.group(2)) if m else -1
            try:
                doc = self._get_json(f"{w.uri}/v1/task/{tid}/trace",
                                     extra_headers)
            except (urllib.error.URLError, OSError, ValueError):
                continue
            if doc.get("spans"):
                by_fid.setdefault(fid, []).append(doc)
        for fid in sorted(by_fid):
            docs = by_fid[fid]
            starts = [sp["start"] for d in docs for sp in d["spans"]]
            ends = [(sp["end"] if sp["end"] is not None else sp["start"])
                    for d in docs for sp in d["spans"]]
            stage = tracer.record(
                f"stage-{fid}", "stage", min(starts), max(ends),
                parent_id=trace_parent, fragment=fid, tasks=len(docs))
            for d in docs:
                root = d.get("rootSpanId")
                tracer.absorb(d["spans"],
                              {root: stage.span_id} if root else None)

    def _wait_finished(self, tasks, timeout_s: float = 600.0,
                       poll_s: float = 0.1, on_lost=None):
        """Block until every (tid, worker, fid, index) task reached a
        terminal state (phased scheduling's stage-completion gate). A
        failed task fails the query immediately. With `on_lost` (recoverable
        grouped execution), a task whose worker stopped answering is handed
        back — on_lost re-runs that lifespan on a survivor and returns the
        replacement (tid, worker) to keep waiting on; deterministic task
        FAILURES still fail the query (they would fail identically on
        any node)."""
        deadline = time.monotonic() + timeout_s
        pending = list(tasks)
        while pending:
            still = []
            for tid, w, fid, i in pending:
                try:
                    req = urllib.request.Request(
                        f"{w.uri}/v1/task/{tid}/status",
                        headers=self._headers())
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as r:
                        info = json.loads(r.read())
                except Exception as e:  # noqa: BLE001 — the node is lost
                    if on_lost is not None:
                        ntid, nw = on_lost(tid, w, fid, i)
                        still.append((ntid, nw, fid, i))
                        continue
                    raise QueryFailed(
                        f"lost task {tid} while awaiting phase completion: "
                        f"{e}", retryable=True) from e
                state = info.get("state")
                if state == "failed":
                    raise QueryFailed(info.get("error") or f"task {tid} failed")
                if state not in ("finished", "aborted"):
                    still.append((tid, w, fid, i))
            pending = still
            if pending:
                if time.monotonic() > deadline:
                    raise QueryFailed(
                        f"phase did not complete within {timeout_s}s "
                        f"({len(pending)} tasks still running)")
                time.sleep(poll_s)

    def _abort(self, created):
        for tid, w in created:
            try:
                req = urllib.request.Request(
                    f"{w.uri}/v1/task/{tid}", method="DELETE",
                    headers=self._headers(),
                )
                urllib.request.urlopen(req, timeout=min(5.0, self.timeout_s)
                                       ).read()
            except Exception:  # noqa: BLE001 — best effort: the node may be gone
                pass


# task ids are "{query_id}.{fragment}.{index}[.r{retry}]"
_TID_RE = re.compile(r"^(.+)\.(\d+)\.(\d+)(?:\.r\d+)?$")


def _fragment_lifespans(node) -> int:
    """Bucket count of a grouped (colocated-join) fragment, else 0
    (StageExecutionDescriptor.isStageGroupedExecution analog)."""
    from presto_tpu_torch.plan.nodes import HashJoin

    if isinstance(node, HashJoin) and node.colocated:
        return node.colocated
    for c in node.children():
        b = _fragment_lifespans(c)
        if b:
            return b
    return 0


class Coordinator:
    """Discovery + health + scheduling service. Exposes the announcement
    endpoint over HTTP; the statement protocol lives in
    presto_tpu_torch.server.protocol (mounted on the same server)."""

    def __init__(self, catalog: Catalog, port: int = 0,
                 config: Optional[ExecConfig] = None, min_workers: int = 1,
                 broadcast_threshold_rows: float = 1_000_000,
                 cluster_secret: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 query_timeout_s: Optional[float] = None,
                 query_event_log: Optional[str] = None,
                 slow_query_log: Optional[str] = None,
                 slow_query_threshold_s: float = 0.0,
                 events_log: Optional[str] = None):
        from presto_tpu_torch.server.protocol import StatementProtocol
        from presto_tpu_torch.server.querymanager import (
            QueryManager,
            batch_to_result,
        )

        self.catalog = catalog
        self.config = config or ExecConfig()
        self.device = default_device(device)
        self.broadcast_threshold_rows = broadcast_threshold_rows
        self.timeout_s = timeout_s
        self.node_manager = NodeManager()
        self._cluster_secret = cluster_secret
        self.failure_detector = HeartbeatFailureDetector(
            self.node_manager, timeout_s=min(5.0, timeout_s))
        self.size_monitor = ClusterSizeMonitor(self.node_manager, min_workers)
        self.scheduler = DistributedScheduler(
            self.config, cluster_secret=cluster_secret,
            on_worker_lost=self._probe, catalog=catalog,
            device=self.device, timeout_s=timeout_s,
            query_timeout_s=query_timeout_s)
        self._query_seq = 0
        self._lock = threading.Lock()
        # keyed by (sql, plan-affecting session property values)
        self._dplan_cache: Dict[tuple, DistributedPlan] = {}
        self._cached_sqls: set = set()  # sqls with any cached plan (non-DDL)
        self._http = None

        def execute_fn(session, sql):
            return batch_to_result(self.run_batch(sql, session.exec_config(),
                                                  session))

        self.query_manager = QueryManager(execute_fn)
        # query-id → Tracer: /v1/query/{id}/trace resolves here (scheduler
        # attempt ids alias to the same trace)
        self.trace_registry = _obs_trace.TraceRegistry()
        # stall forensics get the victim's open span stack; configure()
        # never arms the plane
        _obs_inflight.configure(span_provider=lambda qid: (
            tr.spans() if (tr := self.trace_registry.get(qid)) is not None
            else None))
        if events_log:
            # the cluster event stream's JSONL sink (/v1/events mirrors the
            # in-memory ring regardless)
            _obs_events.EVENTS.configure(path=events_log)
        self._add_listeners(query_event_log, slow_query_log,
                            slow_query_threshold_s)
        # bind the socket first (determines self.url), wire the protocol,
        # THEN start serving — no request can observe a half-built coordinator
        self._bind_http(port)
        self.protocol = StatementProtocol(
            self.query_manager, catalog, self.url, explain_fn=self._explain)
        self.protocol.execute_stmt_fn = (
            lambda session, stmt: batch_to_result(self.run_batch(
                "", session.exec_config(), session, stmt=stmt)))
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name="coordinator-http").start()
        self.failure_detector.start()

    def _add_listeners(self, query_event_log: Optional[str],
                       slow_query_log: Optional[str],
                       slow_query_threshold_s: float) -> None:
        """Query-completion listeners, in the JAX package's order: the
        lifecycle plane first (SLO histograms, objective violations and
        the regression flag must exist before the slow log reads them),
        the latency histogram, the slow-query log, the event log."""
        qm = self.query_manager

        def lifecycle_complete(event: str, info):
            if event != "queryCompleted":
                return
            tr = self.trace_registry.get(info.query_id)
            _obs_lifecycle.complete(
                info, spans=tr.spans() if tr is not None else None)

        qm.listeners.append(lifecycle_complete)

        def record_latency(event: str, info):
            if event == "queryCompleted":
                _obs_metrics.QUERY_LATENCY.observe(
                    max(0.0, (info.end_time or time.time())
                        - info.create_time),
                    plane="coordinator", state=info.state)

        qm.listeners.append(record_latency)
        if slow_query_log:
            slow = _obs_events.SlowQueryLogger(
                slow_query_log, threshold_s=slow_query_threshold_s)

            def log_slow(event: str, info):
                if event != "queryCompleted":
                    return
                tr = self.trace_registry.get(info.query_id)
                mem = ({"device": _devprof.device_memory_doc()}
                       if _devprof.active() else None)
                extra = _obs_lifecycle.slow_log_annotation(info.query_id)
                inf = _obs_inflight.slow_log_annotation(info.query_id)
                if inf:
                    # the doctor verdict and straggler docs, when the
                    # inflight plane saw the query
                    extra = {**(extra or {}), **inf}
                slow.log(info, tr.spans() if tr is not None else None,
                         memory=mem, extra=extra)

            qm.listeners.append(log_slow)
        if query_event_log:
            # query audit stream (reference: the EventListener SPI's
            # QueryCreated/QueryCompleted events, shipped to a log)
            lock = threading.Lock()

            def log_event(event: str, info):
                line = json.dumps({"event": event, "ts": time.time(),
                                   **dataclasses.asdict(info)}, default=str)
                with lock:
                    with open(query_event_log, "a") as fh:
                        fh.write(line + "\n")

            qm.listeners.append(log_event)

    def _explain(self, sql: str, analyze: bool, session,
                 etype: Optional[str] = None) -> str:
        if etype not in (None, "distributed", "logical", "validate"):
            raise ValueError(
                f"unknown EXPLAIN type {etype!r} "
                "(supported: DISTRIBUTED, LOGICAL, VALIDATE)")
        if analyze:
            if etype not in (None, "distributed"):
                raise ValueError(
                    "EXPLAIN ANALYZE only supports TYPE DISTRIBUTED")
            return self.explain_analyze_distributed(sql, session)
        from presto_tpu_torch.plan.builder import plan_query

        if etype == "validate":
            plan_query(sql, self.catalog)  # raises on invalid queries
            return "VALID"
        if etype == "logical":
            from presto_tpu_torch.plan.nodes import plan_to_string
            from presto_tpu_torch.plan.optimizer import optimize

            return plan_to_string(optimize(plan_query(sql, self.catalog),
                                           self.catalog).root)
        # default / TYPE DISTRIBUTED
        return self.plan_distributed(sql, session).to_string()

    def explain_analyze_distributed(self, sql: str, session=None) -> str:
        """Run the query on the cluster with per-operator accounting and
        render a per-fragment, per-task stats rollup (the QueryStats/
        OperatorStats view of the reference's EXPLAIN ANALYZE)."""
        dplan = self.plan_distributed(sql, session)
        cfg = dataclasses.replace(
            session.exec_config() if session else self.config,
            collect_stats=True)
        stats: list = []
        self.size_monitor.wait_for_minimum(timeout_s=self.timeout_s)
        qid = self.next_query_id()
        workers = self.node_manager.active_nodes()
        session_qid = getattr(session, "query_id", "") or ""
        entry = _obs_lifecycle.get(session_qid) if session_qid else None
        if entry is not None:
            _obs_lifecycle.mark(session_qid, "compiling")
            _obs_lifecycle.alias(qid, entry.query_id)
        if session_qid and _obs_inflight.get(session_qid) is not None:
            # task publishers key by the scheduler attempt id; route them
            # to the session's inflight entry
            _obs_inflight.alias(qid, session_qid)
        tracer = _obs_trace.NOOP
        if cfg.tracing:
            tracer = _obs_trace.Tracer(trace_id=session_qid or None)
            self.trace_registry.register(tracer)
            self.trace_registry.alias(qid, tracer.trace_id)
        with _obs_trace.use(tracer), tracer.span("query", "query",
                                                 sql=sql[:200]):
            first = True
            for _ in self.scheduler.execute(qid, dplan, workers, cfg,
                                            stats_out=stats, tracer=tracer):
                if first and entry is not None:
                    _obs_lifecycle.mark(session_qid, "executing")
                    first = False
        lines = []
        if entry is not None:
            seg = entry.timeline.segments()
            lines += [
                "-- lifecycle --",
                "  " + "  ".join(
                    f"{k}={seg[k]:.3f}s"
                    for k in ("queue_wait", "plan", "compile", "exec",
                              "drain", "e2e")),
                "",
            ]
        # query doctor: ranked bottleneck attribution over lifecycle and
        # inflight telemetry (present only when a plane saw the query)
        doctor = _obs_inflight.analyze(
            session_qid or qid,
            spans=tracer.spans() if tracer.enabled else None)
        if doctor is not None and doctor.get("verdict"):
            lines += ["-- doctor --", "  " + doctor["verdict"]]
            for c in doctor.get("causes", [])[1:3]:
                lines.append(
                    f"    also: {c['cause']}"
                    f" ({c['score']:.0%}) {c.get('detail', '')}".rstrip())
            lines.append("")
        lines += [dplan.to_string(), "", "-- task execution profile --"]
        by_fid: Dict[int, list] = {}
        for tid, fid, info in stats:
            by_fid.setdefault(fid, []).append((tid, info))
        for fid in sorted(by_fid):
            lines.append(f"fragment {fid}:")
            for tid, info in sorted(by_fid[fid]):
                lines.append(f"  task {tid} [{info.get('state')}]")
                for row in info.get("stats") or []:
                    line = (
                        f"    {row['node']:<16} rows={int(row['rows']):>12,}"
                        f" batches={int(row['batches']):>6}"
                        f" wall={row['wall_s']:.3f}s")
                    if row.get("bytes"):
                        line += f" bytes={int(row['bytes']):,}"
                    lines.append(line)
        return "\n".join(lines)

    # -- http -------------------------------------------------------------

    def _bind_http(self, port: int):
        coord = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, obj, code=200, extra_headers=None):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                if self.path == "/v1/statement":
                    n = int(self.headers.get("Content-Length", 0))
                    sql = self.rfile.read(n).decode()
                    try:
                        out, extra = coord.protocol.create(sql, self.headers)
                        return self._json(out, extra_headers=extra)
                    except Exception as e:  # noqa: BLE001 — a user error reply
                        return self._json(
                            {"error": {"message": str(e),
                                       "errorName": type(e).__name__,
                                       "errorType": "USER_ERROR"},
                             "id": "", "stats": {"state": "FAILED"}})
                self._json({"error": "not found"}, 404)

            def do_PUT(self):
                if self.path.startswith("/v1/announcement/"):
                    node_id = self.path.rsplit("/", 1)[1]
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n))
                    coord.node_manager.announce(
                        node_id, body["uri"], body.get("state", "active")
                    )
                    return self._json({"ok": True})
                self._json({"error": "not found"}, 404)

            def _text(self, body: str, content_type: str, code=200):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _state(self, qid: str) -> Optional[str]:
                try:
                    return coord.query_manager.get(qid).state
                except KeyError:
                    return None

            def do_GET(self):
                m = re.match(r"^/v1/statement/([^/]+)/(\d+)$", self.path)
                if m:
                    try:
                        return self._json(
                            coord.protocol.poll(m.group(1), int(m.group(2)))
                        )
                    except KeyError:
                        return self._json({"error": "unknown query"}, 404)
                m = re.match(r"^/v1/query/([^/]+)/trace$", self.path)
                if m:
                    tr = coord.trace_registry.get(m.group(1))
                    if tr is None:
                        return self._json({"error": "no trace for query"},
                                          404)
                    return self._json(tr.to_json())
                m = re.match(r"^/v1/query/([^/]+)/progress$", self.path)
                if m:
                    qid = m.group(1)
                    doc = _obs_lifecycle.progress_doc(
                        qid, state=self._state(qid))
                    if doc is None:
                        return self._json(
                            {"error": "no lifecycle for query "
                                      "(unknown id or lifecycle=off)"}, 404)
                    return self._json(doc)
                m = re.match(r"^/v1/query/([^/]+)/inflight$", self.path)
                if m:
                    doc = _obs_inflight.snapshot_doc(m.group(1))
                    if doc is None:
                        return self._json(
                            {"error": "no inflight telemetry for query "
                                      "(unknown id or inflight=off)"}, 404)
                    return self._json(doc)
                m = re.match(r"^/v1/query/([^/]+)/doctor$", self.path)
                if m:
                    qid = m.group(1)
                    tr = coord.trace_registry.get(qid)
                    doc = _obs_inflight.analyze(
                        qid, spans=tr.spans() if tr is not None else None,
                        state=self._state(qid))
                    if doc is None:
                        return self._json(
                            {"error": "no telemetry for query (unknown id "
                                      "or lifecycle+inflight off)"}, 404)
                    return self._json(doc)
                m = re.match(r"^/v1/events(?:\?(.*))?$", self.path)
                if m:
                    import urllib.parse as _up

                    q = _up.parse_qs(m.group(1) or "")

                    def _one(name, cast=str, default=None):
                        vals = q.get(name)
                        try:
                            return cast(vals[0]) if vals else default
                        except (TypeError, ValueError):
                            return default

                    return self._json({
                        "lastSeq": _obs_events.EVENTS.last_seq(),
                        "events": _obs_events.EVENTS.events(
                            since=_one("since", int, 0),
                            query_id=_one("queryId"),
                            kind=_one("kind"),
                            limit=_one("limit", int, 1000)),
                    })
                if self.path == "/v1/metrics":
                    from presto_tpu_torch.server.metrics import (
                        coordinator_metrics,
                    )

                    return self._text(coordinator_metrics(coord),
                                      "text/plain; version=0.0.4")
                m = re.match(r"^/v1/query/([^/]+)$", self.path)
                if m:
                    try:
                        qe = coord.query_manager.get(m.group(1))
                    except KeyError:
                        return self._json({"error": "unknown query"}, 404)
                    return self._json(dataclasses.asdict(qe.info()))
                if self.path == "/v1/query":
                    return self._json(
                        [dataclasses.asdict(i)
                         for i in coord.query_manager.queries()])
                if self.path == "/v1/info":
                    return self._json({
                        "nodeId": "coordinator", "coordinator": True,
                        "uri": coord.url,
                    })
                if self.path == "/v1/node":
                    return self._json([
                        {"nodeId": n.node_id, "uri": n.uri,
                         "failureScore": n.failure_score, "state": n.state}
                        for n in coord.node_manager.nodes.values()
                    ])
                if self.path == "/v1/cluster":
                    qs = coord.query_manager.queries()
                    return self._json({
                        "activeWorkers": len(coord.node_manager.active_nodes()),
                        "runningQueries": sum(1 for q in qs if q.state == "RUNNING"),
                        "queuedQueries": sum(1 for q in qs if q.state == "QUEUED"),
                        "totalQueries": len(qs),
                    })
                self._json({"error": "not found"}, 404)

            def do_DELETE(self):
                m = re.match(r"^/v1/statement/([^/]+)(?:/\d+)?$", self.path)
                if m:
                    coord.protocol.cancel(m.group(1))
                    return self._json({"ok": True})
                self._json({"error": "not found"}, 404)

        self._http = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._http.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"

    # -- queries ----------------------------------------------------------

    def next_query_id(self) -> str:
        with self._lock:
            self._query_seq += 1
            return f"q{self._query_seq}"

    def execute_distributed(self, dplan: DistributedPlan,
                            config: Optional[ExecConfig] = None,
                            tracer=None):
        self.size_monitor.wait_for_minimum(timeout_s=self.timeout_s)
        qid = self.next_query_id()
        workers = self.node_manager.active_nodes()
        if tracer is None:
            tracer = _obs_trace.current()
        if tracer.enabled:
            # task ids embed this scheduler attempt id: make it resolve to
            # the query's trace, and (trace ids are the serving query id)
            # to its lifecycle and inflight entries, so worker heartbeats
            # keyed by the attempt reach the right slots
            self.trace_registry.alias(qid, tracer.trace_id)
            _obs_lifecycle.alias(qid, tracer.trace_id)
            _obs_inflight.alias(qid, tracer.trace_id)
        entry = _obs_lifecycle.get(qid)
        if entry is None:
            yield from self.scheduler.execute(qid, dplan, workers, config,
                                              tracer=tracer)
            return
        # lifecycle plane: the first root batch is the compiling→executing
        # boundary; every batch feeds the live progress counts
        first = True
        for b in self.scheduler.execute(qid, dplan, workers, config,
                                        tracer=tracer,
                                        on_batch=entry.observe_batch):
            if first:
                _obs_lifecycle.mark(entry.query_id, "executing")
                first = False
            yield b
        if first:
            # a stream without batches still crossed into execution
            _obs_lifecycle.mark(entry.query_id, "executing")

    def _try_scaled_write(self, stmt, config) -> Optional[Batch]:
        """Scaled writers (SCALED_WRITER_DISTRIBUTION): CTAS into a
        connector that supports part tables plans the source query
        distributed and wraps each root task with a TableWriter — every
        task writes its own part concurrently; counts gather and sum; the
        staging directory commits atomically (TableFinish). Returns None
        when the statement doesn't qualify (the gathered single-writer
        path handles it)."""
        import uuid

        from presto_tpu_torch.plan.builder import plan_query
        from presto_tpu_torch.plan.nodes import Output, TableWriter
        from presto_tpu_torch.plan.optimizer import optimize
        from presto_tpu_torch.sql import ast as _ast

        if not isinstance(stmt, _ast.CreateTableAs):
            return None
        if stmt.properties:
            # partitioned CTAS groups rows by partition value — the
            # single-writer path owns that layout
            return None
        conn, tname = self.catalog.connector_for(stmt.name)
        if not getattr(conn, "supports_scaled_writes", lambda: False)():
            return None
        qp = optimize(plan_query(stmt.query, self.catalog), self.catalog)
        if qp.scalar_subqueries:
            return None  # binding protocol stays on the gathered path
        write_id = uuid.uuid4().hex[:8]
        inner = qp.root.child
        writer = TableWriter(inner, conn.name, tname, write_id)
        qp.root = Output(writer, ["rows"], ["rows"])
        if not conn.begin_scaled_create(tname,
                                        if_not_exists=stmt.if_not_exists):
            return count_batch(0, self.device)
        try:
            dplan = fragment_plan(
                qp, self.catalog,
                broadcast_threshold_rows=self.broadcast_threshold_rows)
            # NO query-level retry here: a retry with a different worker
            # count would leave stale parts from the first attempt in the
            # staging dir (duplicated rows); failures abort the staging
            batches = list(self.execute_distributed(dplan, config))
            merged = _collect_concat(iter(batches))
            total = 0
            if merged is not None:
                rows = merged.to_pydict(decode_strings=False)["rows"]
                total = int(sum(int(v) for v in rows))
            conn.finish_scaled_create(tname)
        except BaseException:
            conn.abort_scaled_create(tname)
            raise
        return count_batch(total, self.device)

    def _probe(self, n: NodeInfo) -> None:
        """One direct probe (before a retry, or when task placement found
        the node dead): a node that fails it is excluded at once (its score
        jumps past the threshold) — the background detector's decayed
        counter is deliberately slow for flaky networks, but a retry must
        not re-schedule onto a node that just killed the query."""
        try:
            with urllib.request.urlopen(f"{n.uri}/v1/status",
                                        timeout=min(3.0, self.timeout_s)) as r:
                json.loads(r.read())
            n.record_success()
        except Exception:  # noqa: BLE001 — unreachable: exclude it
            n.failure_score = 5.0  # past NodeInfo.failed threshold

    def _reprobe_workers(self):
        """Synchronous cluster probe before a retry."""
        threads = [threading.Thread(target=self._probe, args=(n,), daemon=True)
                   for n in list(self.node_manager.nodes.values())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4)

    def _execute_with_retry(self, dplan: DistributedPlan,
                            config: Optional[ExecConfig] = None) -> list:
        """Query-level elastic retry (reference: RetryPolicy.QUERY /
        recoverable execution's coarse form): any task failure or worker
        transport error re-probes the cluster and re-runs the whole query
        on the surviving nodes."""
        retries = (config or self.config).query_retry_count
        attempt = 0
        while True:
            try:
                return list(self.execute_distributed(dplan, config))
            except (QueryFailed, urllib.error.URLError, OSError) as e:
                # deterministic task errors re-fail identically: don't
                # burn a full re-execution on them
                retryable = (e.retryable if isinstance(e, QueryFailed)
                             else True)
                if attempt >= retries or not retryable:
                    raise (e if isinstance(e, QueryFailed)
                           else QueryFailed(str(e), retryable=True))
                attempt += 1
                self._reprobe_workers()
                if not self.node_manager.active_nodes():
                    raise QueryFailed(
                        "no active workers after failure probe") from e

    def plan_distributed(self, sql: str, session=None,
                         stmt=None) -> DistributedPlan:
        from presto_tpu_torch.plan.builder import plan_query
        from presto_tpu_torch.plan.optimizer import optimize

        # session properties that change the PLAN feed the cache key
        # (join_distribution_type — SystemSessionProperties.java:59)
        jdt = (session.get("join_distribution_type") if session else "AUTOMATIC") or "AUTOMATIC"
        jdt = jdt.upper()
        threshold = {
            "BROADCAST": float("inf"),
            "PARTITIONED": 0.0,
        }.get(jdt, self.broadcast_threshold_rows)
        jm = ((session.get("join_mode") if session else None) or
              self.config.join_mode).lower()
        cache_key = (sql, jdt, jm)
        hit = self._dplan_cache.get(cache_key) if sql else None
        if hit is not None:
            return hit
        qp = optimize(plan_query(stmt if stmt is not None else sql,
                                 self.catalog), self.catalog)
        if jm != "off":
            from presto_tpu_torch.plan.multiway import apply_join_mode

            cfg = session.exec_config() if session else self.config
            apply_join_mode(qp, self.catalog, cfg)
        cacheable = bool(sql) and not qp.scalar_subqueries and qp.cacheable
        if qp.scalar_subqueries:
            # bind uncorrelated scalar subqueries coordinator-side first
            # (the reference runs them as separate plan stages)
            bind_scalar_subqueries(
                qp, ExecContext(self.catalog, self.config, self.device))
        dplan = fragment_plan(qp, self.catalog,
                              broadcast_threshold_rows=threshold)
        if cacheable:
            # concurrent submissions of the same sql both plan (the get
            # above is a lock-free fast path) but the insert keeps the
            # cache + membership set consistent; last writer wins with an
            # equivalent plan
            with self._lock:
                self._dplan_cache[cache_key] = dplan
                self._cached_sqls.add(sql)
        return dplan

    def _empty_result(self, dplan: DistributedPlan) -> Batch:
        types = dict(dplan.fragments[dplan.root_fid].root.output)
        return empty_batch(dplan.output_names,
                           [types[n] for n in dplan.output_names],
                           self.device)

    def _profile_capture(self, session):
        """Context manager for the `profile` session property: a
        torch.profiler Chrome trace of the query (CPU and, on a card, CUDA
        activity) under PRESTO_TPU_CACHE_DIR/profiles/<query_id>.json,
        surfaced as profileUri in the statement response. No-op with a
        warning without a cache dir — the query still runs."""
        import warnings

        qid = getattr(session, "query_id", "") or "adhoc"
        base = os.environ.get("PRESTO_TPU_CACHE_DIR")
        if not base:
            warnings.warn("profile=true is a no-op: PRESTO_TPU_CACHE_DIR "
                          "is not set", stacklevel=3)
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def run():
            from torch.profiler import ProfilerActivity, profile

            pdir = os.path.join(base, "profiles")
            os.makedirs(pdir, exist_ok=True)
            path = os.path.join(pdir, f"{qid}.json")
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                yield
            prof.export_chrome_trace(path)
            _devprof.register_profile(qid, path)

        return run()

    def run_batch(self, sql: str, config: Optional[ExecConfig] = None,
                  session=None, stmt=None) -> Batch:
        """`stmt` overrides parsing — the bound AST of a prepared
        statement (EXECUTE path; no SQL re-rendering)."""
        cfg = config or self.config
        if cfg.profile:
            with self._profile_capture(session):
                return self._run_batch_traced(sql, config, session, stmt)
        return self._run_batch_traced(sql, config, session, stmt)

    def _run_batch_traced(self, sql: str, config: Optional[ExecConfig],
                          session, stmt) -> Batch:
        if not (config or self.config).tracing:
            return self._run_batch_inner(sql, config, session, stmt)
        # trace id = the session query id when there is one, so
        # /v1/query/{id}/trace resolves directly; the root span covers
        # planning, scheduling and the result merge
        tracer = _obs_trace.Tracer(
            trace_id=getattr(session, "query_id", "") or None)
        self.trace_registry.register(tracer)
        with _obs_trace.use(tracer), tracer.span(
                "query", "query", sql=(sql or "")[:200],
                user=getattr(session, "user", None) or "user"):
            return self._run_batch_inner(sql, config, session, stmt)

    def _run_batch_inner(self, sql: str, config: Optional[ExecConfig],
                         session, stmt) -> Batch:
        from presto_tpu_torch.exec.runner import (
            execute_data_definition,
            is_ddl,
        )
        from presto_tpu_torch.sql.parser import parse_sql

        if stmt is None:
            # cached distributed plans are never DDL — skip the parse probe
            # (O(1) membership; the parsed stmt is reused by plan_distributed)
            cached = sql in self._cached_sqls
            stmt = None if cached else parse_sql(sql)

        if stmt is not None and is_ddl(stmt):
            scaled = self._try_scaled_write(stmt, config)
            if scaled is not None:
                return scaled
            # DDL/DML executes coordinator-side; the source query still
            # runs distributed (reference: DataDefinitionExecution on the
            # coordinator + a distributed TableWriter source)
            from presto_tpu_torch.plan.builder import plan_query
            from presto_tpu_torch.plan.optimizer import optimize

            def run_query_fn(q):
                qp = optimize(plan_query(q, self.catalog), self.catalog)
                d = fragment_plan(
                    qp, self.catalog,
                    broadcast_threshold_rows=self.broadcast_threshold_rows)
                merged = _collect_concat(
                    iter(list(self.execute_distributed(d, config))))
                return compact(merged if merged is not None
                               else self._empty_result(d))

            return execute_data_definition(stmt, self.catalog, run_query_fn,
                                           self.device)

        dplan = self.plan_distributed(sql, session, stmt=stmt)
        session_qid = getattr(session, "query_id", "") or ""
        if session_qid and _obs_lifecycle.get(session_qid) is not None:
            # the plan's structural fingerprint gives progress its HBO
            # prediction and completion its regression baseline; plan
            # ready = the plan→compile boundary
            _obs_lifecycle.set_fingerprint(
                session_qid, _runstats.node_fingerprint(
                    dplan.fragments[dplan.root_fid].root, self.catalog))
            _obs_lifecycle.mark(session_qid, "compiling")
        merged = _collect_concat(iter(self._execute_with_retry(dplan, config)))
        return compact(merged if merged is not None
                       else self._empty_result(dplan))

    def close(self):
        self.failure_detector.stop()
        self.query_manager.close()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()


class DistributedRunner:
    """In-process cluster: coordinator + N workers over real localhost HTTP
    (DistributedQueryRunner.java:78 analog — multi-node without a cluster).

    Every worker shares the same Catalog object (connectors are
    deterministic; in a real deployment each worker constructs its own from
    catalog properties) and the same device: None means CUDA (raising when
    there is none). `timeout_s` bounds every HTTP call, `query_timeout_s`
    a query's wait for its result."""

    def __init__(self, catalog: Catalog, n_workers: int = 2,
                 config: Optional[ExecConfig] = None,
                 broadcast_threshold_rows: float = 1_000_000,
                 device: Optional[Union[str, torch.device]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 query_timeout_s: Optional[float] = None):
        import secrets as _secrets

        from presto_tpu_torch.server.worker import Worker

        device = default_device(device)
        self.catalog = catalog
        self.config = config or ExecConfig()
        cluster_secret = _secrets.token_hex(16)
        self.coordinator = Coordinator(
            catalog, config=self.config, min_workers=n_workers,
            broadcast_threshold_rows=broadcast_threshold_rows,
            cluster_secret=cluster_secret, device=device,
            timeout_s=timeout_s, query_timeout_s=query_timeout_s)
        self.workers = [
            Worker(catalog, node_id=f"worker-{i}",
                   coordinator_url=self.coordinator.url,
                   memory_pool_bytes=self.config.memory_pool_bytes,
                   spill_dir=self.config.spill_dir,
                   revoke_threshold=self.config.memory_revoking_threshold,
                   revoke_target=self.config.memory_revoking_target,
                   cluster_secret=cluster_secret, device=device,
                   timeout_s=timeout_s)
            for i in range(n_workers)
        ]

    def plan_distributed(self, sql: str) -> DistributedPlan:
        return self.coordinator.plan_distributed(sql)

    def explain_distributed(self, sql: str) -> str:
        return self.coordinator.plan_distributed(sql).to_string()

    def run_batch(self, sql: str) -> Batch:
        return self.coordinator.run_batch(sql)

    def run(self, sql: str):
        return self.run_batch(sql).to_pandas()

    def close(self):
        # each server's shutdown waits out its serve loop's poll: close the
        # nodes side by side
        nodes = [*self.workers, self.coordinator]
        threads = [threading.Thread(target=n.close, daemon=True)
                   for n in nodes]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
