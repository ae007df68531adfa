"""Worker — the data-plane node: task CRUD over HTTP, fragment execution,
output buffers.

Reference surface:
- server/TaskResource.java:84 — `@Path("/v1/task")`: create/update (POST
  :126), status (GET :188), results by token (GET :245-247), ack (:304),
  abort (DELETE :317)
- execution/SqlTaskManager.java:84,351 + SqlTask / TaskStateMachine
- execution/SqlTaskExecution.java:82 — splits → pipeline → drivers
- server/GracefulShutdownHandler.java:43 — drain then exit on
  PUT /v1/info/state "SHUTTING_DOWN"

A task executes one plan fragment as a stream of fixed-capacity batches
on its worker's device (exec/runtime, the port's operators and kernels);
the task's sink serializes output pages into an OutputBuffer partitioned
for the consumer stage (hash / broadcast / gather). Fragments arrive as
JSON over the closed plan-node vocabulary (plan/codec.py) — the
TaskUpdateRequest JSON/Smile codec analog; nothing on the wire can
execute code. Each worker has its own memory pool and spill directory.

The JAX package's server/worker.py without its observability hooks
(traces, metrics, inflight and lifecycle telemetry: ROADMAP item 14), its
compile farm (item 12) and TLS (item 17). A worker runs on CUDA unless
it is given another device.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
import traceback
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Union

import torch

from presto_tpu_torch import default_device
from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec.runtime import ExecConfig, ExecContext, execute_node
from presto_tpu_torch.memory import MemoryPool, QueryScopedPool
from presto_tpu_torch.obs import devprof as _devprof
from presto_tpu_torch.obs import inflight as _obs_inflight
from presto_tpu_torch.obs import metrics as _obs_metrics
from presto_tpu_torch.obs import trace as _obs_trace
from presto_tpu_torch.ops.partition import partition_ids
from presto_tpu_torch.ops.radix import radix_ids
from presto_tpu_torch.plan.fragmenter import (
    OUT_BROADCAST,
    OUT_HASH,
    OUT_RR,
    Fragment,
)
from presto_tpu_torch.serde import serialize_batch
from presto_tpu_torch.server.buffers import BufferFailed, OutputBuffer
from presto_tpu_torch.server.exchange import (
    DEFAULT_TIMEOUT_S,
    ExchangeClient,
    encode_results_payload,
)
from presto_tpu_torch.spiller import SpillManager


@dataclasses.dataclass
class TaskUpdate:
    """POST /v1/task/{id} body (TaskUpdateRequest analog: fragment + split
    assignment + output buffer layout + upstream locations)."""

    fragment: Fragment
    task_index: int
    n_tasks: int
    n_out_partitions: int
    upstreams: Dict[int, List[str]]  # fragment_id -> result-buffer base URLs
    config: dict = dataclasses.field(default_factory=dict)
    # phased scheduling: build-phase tasks spool their output (no enqueue
    # back-pressure) because their consumers are created in a LATER phase
    # and cannot drain them yet (PhasedExecutionSchedule + the reference's
    # spooling broadcast buffers)
    spool: bool = False
    # coordinator-assigned split ordinals per table (soft-affinity
    # placement; None → static task_index::n_tasks striding), with the
    # coordinator's enumeration count so a drifted table (concurrent
    # INSERT) fails loudly instead of silently dropping splits
    split_assignment: Optional[Dict[str, List[int]]] = None
    split_counts: Optional[Dict[str, int]] = None


class TaskExecutor:
    """Fair batch-granularity time slicing across concurrent tasks — the
    analog of TaskExecutor.java:78 + MultilevelSplitQueue.java:41. Each
    task thread must hold a run slot to compute its next batch; when
    demand exceeds `slots`, free slots go to the waiting tasks with the
    LEAST accumulated compute time (so short interactive queries are not
    starved behind long scans). The reference time-slices at split
    quanta; the batch boundary is this engine's natural quantum."""

    def __init__(self, slots: int = 4):
        self.slots = max(1, slots)
        self._running = 0
        self._cv = threading.Condition()
        self._acc: dict = {}       # task_id -> accumulated seconds
        self._waiting: list = []

    def register(self, task_id: str) -> "TaskLease":
        with self._cv:
            self._acc.setdefault(task_id, 0.0)
        return TaskLease(self, task_id)

    def unregister(self, task_id: str):
        with self._cv:
            self._acc.pop(task_id, None)

    def accumulated(self, task_id: str) -> float:
        with self._cv:
            return self._acc.get(task_id, 0.0)

    def _acquire(self, task_id: str):
        with self._cv:
            self._waiting.append(task_id)
            while True:
                if self._running < self.slots:
                    free = self.slots - self._running
                    most_deserving = sorted(
                        self._waiting, key=lambda t: self._acc.get(t, 0.0)
                    )[:free]
                    if task_id in most_deserving:
                        self._waiting.remove(task_id)
                        self._running += 1
                        return
                self._cv.wait(timeout=1.0)

    def _release(self, task_id: str, elapsed: float):
        with self._cv:
            self._running -= 1
            self._acc[task_id] = self._acc.get(task_id, 0.0) + elapsed
            self._cv.notify_all()


class TaskLease:
    """Context manager: one held section = one scheduling quantum."""

    def __init__(self, executor: TaskExecutor, task_id: str):
        self.executor = executor
        self.task_id = task_id
        self._t0 = 0.0

    def __enter__(self):
        self.executor._acquire(self.task_id)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.executor._release(self.task_id, time.monotonic() - self._t0)
        return False


class TaskExecution:
    """One task: fragment + splits in, pages out (SqlTaskExecution analog)."""

    def __init__(self, task_id: str, update: TaskUpdate, catalog: Catalog,
                 device: torch.device, memory_pool=None, spill_manager=None,
                 executor=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 trace_token: Optional[str] = None, node_id: str = ""):
        self.task_id = task_id
        self.update = update
        self.catalog = catalog
        self.device = device
        self.memory_pool = memory_pool
        self.spill_manager = spill_manager
        self.executor = executor
        self.timeout_s = timeout_s
        self.node_id = node_id
        # the trace token travels in the X-Presto-Tpu-Trace header, not
        # the TaskUpdate body. Each task records into its own tracer; the
        # coordinator pulls the dump via GET /v1/task/{id}/trace and
        # stitches the query tree
        self.tracer = _obs_trace.NOOP
        self._trace_parent: Optional[str] = None
        if trace_token and update.config.get("tracing", True):
            trace_id, parent = _obs_trace.parse_token(trace_token)
            self.tracer = _obs_trace.Tracer(trace_id=trace_id)
            self._trace_parent = parent
        self.state = "running"
        self.error: Optional[str] = None
        self.stats_report: Optional[list] = None  # per-operator rows
        # lifecycle plane (obs/lifecycle.py): count emitted rows/batches
        # so heartbeats carry live query progress; lifecycle=off keeps the
        # sink path and heartbeat doc as they were
        self._count_progress = str(
            update.config.get("lifecycle", "on")).lower() == "on"
        self.rows_emitted = 0
        self.batches_emitted = 0
        # mid-flight telemetry plane (obs/inflight.py): the per-task
        # publisher operators heartbeat through; inflight=off keeps the
        # task path as it was
        self._inflight = None
        if str(update.config.get("inflight", "off")).lower() == "on":
            m = _TASK_ID_RE.match(task_id)
            self._inflight = _obs_inflight.task(
                m.group(1) if m else task_id, task_id,
                fragment=int(m.group(2)) if m else 0)
        f = update.fragment
        self.buffer = OutputBuffer(
            update.n_out_partitions,
            broadcast=(f.output_partitioning == OUT_BROADCAST),
            # phased build tasks spool overflow to disk: their consumers
            # are created in a later phase, so back-pressure cannot drain
            spool_dir=(spill_manager.dir if update.spool and spill_manager
                       is not None else None),
        )
        self.created_at = time.time()
        self.finished_at: Optional[float] = None
        self._clients: List[ExchangeClient] = []
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"task-{task_id}"
        )
        self.thread.start()

    def _remote_source_factory(self, fragment_id: int):
        urls = self.update.upstreams[fragment_id]
        client = ExchangeClient(urls, device=self.device,
                                timeout_s=self.timeout_s)
        self._clients.append(client)
        if not self.tracer.enabled:
            return client.batches()
        return self._traced_exchange(client, fragment_id)

    def _traced_exchange(self, client: ExchangeClient, fragment_id: int):
        """Exchange pull with consumer-blocked time accounted: each next()
        wall goes to the exchange-wait histogram, and one exchange_wait
        span records the stream envelope with total blocked seconds."""
        it = client.batches()
        parent = self.tracer.current_parent()
        start = time.time()
        waited = 0.0
        try:
            while True:
                w0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    break
                dt = time.perf_counter() - w0
                waited += dt
                _obs_metrics.EXCHANGE_WAIT.observe(dt, plane="worker")
                yield b
        finally:
            self.tracer.record("exchange_wait", "exchange_wait", start,
                               time.time(), parent_id=parent,
                               fragment=fragment_id,
                               wait_s=round(waited, 6))

    def _run(self):
        try:
            cfg = ExecConfig(**self.update.config)
            ctx = ExecContext(self.catalog, cfg, self.device,
                              memory_pool=self.memory_pool,
                              spill_manager=self.spill_manager)
            try:
                if self.tracer.enabled:
                    # created_at → first execution work = schedule delay
                    _obs_metrics.TASK_SCHEDULE_DELAY.observe(
                        max(0.0, time.time() - self.created_at),
                        plane="worker", node=self.node_id)
                    with _obs_trace.use(self.tracer), self.tracer.span(
                            "task", "task", parent_id=self._trace_parent,
                            task_id=self.task_id, node=self.node_id):
                        self._run_with_ctx(ctx)
                else:
                    self._run_with_ctx(ctx)
            finally:
                # a task that failed or was aborted mid-spill leaves no
                # spill file behind
                ctx.cleanup_spill()
            self.buffer.set_no_more_pages()
            self.state = "finished"
            self.finished_at = time.time()
        except Exception as e:  # noqa: BLE001 — the error goes to the consumers
            self.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            self.state = "failed"
            self.finished_at = time.time()
            self.buffer.fail(self.error)
        finally:
            if self._inflight is not None:
                self._inflight.finish()
            for c in self._clients:
                c.close()

    def _run_with_ctx(self, ctx: ExecContext):
        ctx.tracer = self.tracer
        ctx.inflight = self._inflight
        ctx.task_index = self.update.task_index
        ctx.n_tasks = self.update.n_tasks
        ctx.split_assignment = self.update.split_assignment
        ctx.split_counts = self.update.split_counts
        ctx.remote_sources = self._remote_source_factory
        f = self.update.fragment
        sink = self._make_sink(f, ctx.config)
        stream = execute_node(f.root, ctx)
        # fair time slicing applies to LEAF fragments only: a task
        # with remote sources can block inside next() waiting for
        # producer pages, and holding a run slot while blocked would
        # deadlock the slot pool (the reference's splits yield when
        # blocked; the exchange iterator cannot)
        gated = (self.executor is not None
                 and not f.remote_sources())
        if gated:
            lease = self.executor.register(self.task_id)
            try:
                while True:
                    with lease:
                        try:
                            batch = next(stream)
                        except StopIteration:
                            break
                        sink(batch)
            finally:
                self.executor.unregister(self.task_id)
        else:
            for batch in stream:
                sink(batch)
        # the sink has read every page to the host: the deferred HBO
        # counts are ready
        ctx.flush_observations()
        if ctx.config.devprof == "on":
            # reconcile this task's pool slice against the device
            # watermark once the task's work is done
            _devprof.activate(ctx.device)
            _devprof.reconcile(ctx.memory_pool, plane="worker", site="task")
        if ctx.config.collect_stats:
            self.stats_report = self._stats_rows(f.root, ctx)

    @staticmethod
    def _stats_rows(root, ctx: ExecContext) -> list:
        """Per-operator stats rows (collect_stats) for the coordinator's
        EXPLAIN ANALYZE, plus the context's counters as rows."""
        names = {}

        def walk(n):
            names[id(n)] = type(n).__name__
            for c in n.children():
                walk(c)

        walk(root)
        rows = [{"node": names.get(nid, "?"), **st}
                for nid, st in ctx.node_stats.items()]
        rows += [{"node": k, "rows": v, "batches": 0, "wall_s": 0.0}
                 for k, v in ctx.stats.items()]
        return rows

    def _make_sink(self, f: Fragment, cfg):
        """The task's page sink; each call returns the batch's live rows,
        which the sink reads on the host anyway to size its pages. With
        lifecycle or inflight on, those counts are the task's progress."""
        sink = self._make_sink_inner(f, cfg)
        if not self._count_progress and self._inflight is None:
            return sink

        def counting_sink(b: Batch):
            rows = sink(b)
            if self._count_progress:
                self.rows_emitted += rows
                self.batches_emitted += 1
            if self._inflight is not None:
                self._inflight.publish("output", rows_out=rows, batches=1)
            return rows

        return counting_sink

    def _make_sink_inner(self, f: Fragment, cfg):
        n_parts = self.update.n_out_partitions
        if f.output_partitioning == OUT_HASH and n_parts > 1:
            keys = tuple(f.output_keys)
            R = cfg.radix_partitions if f.radix_align else 0

            def sink(b: Batch) -> int:
                # device-side hash, one page a consumer
                # (PartitionedOutputOperator.partitionPage:377 analog)
                pid = partition_ids(b, keys, n_parts)
                # each consumer's live rows, in one host read
                counts = torch.bincount(
                    torch.where(b.live, pid.to(torch.int64), n_parts),
                    minlength=n_parts + 1)[:n_parts].tolist()
                if R <= 1:
                    for p in range(n_parts):
                        if counts[p]:
                            self.buffer.enqueue(
                                p, serialize_batch(
                                    b.with_live(b.live & (pid == p)),
                                    dict_refs=True))
                    return sum(counts)
                # partition-aligned exchange: the consumer breaker radix-
                # partitions on these same keys, so split each consumer's
                # page further by the radix id (top bits of the SAME 63-bit
                # hash whose modulo picked the consumer) and tag it — the
                # consumer routes the page straight to partition r with no
                # re-partition sort
                rid = radix_ids(b, keys, R)
                for p in range(n_parts):
                    if not counts[p]:
                        continue
                    pmask = b.live & (pid == p)
                    for r in torch.unique(rid[pmask]).tolist():
                        self.buffer.enqueue(
                            p, serialize_batch(
                                b.with_live(pmask & (rid == r)),
                                radix=(int(r), R, keys), dict_refs=True))
                return sum(counts)

            return sink

        if f.output_partitioning == OUT_RR and n_parts > 1:
            state = {"next": self.update.task_index}  # stagger producers

            def sink(b: Batch) -> int:
                # page-level round robin (the reference's
                # ArbitraryOutputBuffer: any consumer may take a page;
                # deterministic rotation here keeps tasks balanced)
                n = b.num_live()
                if n == 0:
                    return 0
                p = state["next"] % n_parts
                state["next"] += 1
                self.buffer.enqueue(p, serialize_batch(b, dict_refs=True))
                return n

            return sink

        def sink(b: Batch) -> int:
            # gather/broadcast: one serialized page, fanned out by the buffer
            n = b.num_live()
            if n == 0:
                return 0
            page = serialize_batch(b, dict_refs=True)
            if f.output_partitioning == OUT_BROADCAST:
                self.buffer.enqueue(None, page)
            else:
                self.buffer.enqueue(0, page)
            return n

        return sink

    def abort(self):
        self.state = "aborted"
        for c in self._clients:
            c.close()
        for p in range(self.buffer.n_partitions):
            self.buffer.abort(p)

    def info(self) -> dict:
        out = {
            "taskId": self.task_id,
            "state": self.state,
            "error": self.error,
            "bufferedBytes": self.buffer.buffered_bytes(),
            "spooledBytes": self.buffer.spooled_bytes(),
            "sentBytes": self.buffer.sent_bytes,
        }
        if self.stats_report is not None:
            out["stats"] = self.stats_report
        if self._count_progress:
            out["rowsEmitted"] = self.rows_emitted
            out["batchesEmitted"] = self.batches_emitted
        return out


# task ids are "{query_id}.{fragment}.{index}[.r{retry}]" — the greedy
# query group absorbs any dots inside the query id itself
_TASK_ID_RE = re.compile(r"^(.+)\.(\d+)\.(\d+)(?:\.r\d+)?$")


class TaskManager:
    """SqlTaskManager analog: task registry keyed by task id."""

    def __init__(self, catalog: Catalog, device: torch.device,
                 memory_pool=None, spill_manager=None, run_slots: int = 4,
                 timeout_s: float = DEFAULT_TIMEOUT_S, node_id: str = ""):
        self.catalog = catalog
        self.device = device
        self.node_id = node_id
        self.timeout_s = timeout_s
        self.memory_pool = memory_pool or MemoryPool(None)
        self.spill_manager = spill_manager or SpillManager()
        self.tasks: Dict[str, TaskExecution] = {}
        self.executor = TaskExecutor(run_slots)
        self._lock = threading.Lock()
        # query_id -> QueryScopedPool: per-query slice of the node pool
        self._query_pools: Dict[str, QueryScopedPool] = {}

    def _pool_for_locked(self, task_id: str):
        """Caller holds self._lock: the lookup and the insert must share
        one critical section, or two tasks of the same query arriving
        concurrently fork the query's reservations across two pools."""
        # task ids are "{query_id}.{fragment}.{index}" (coordinator.execute)
        query_id = task_id.rsplit(".", 2)[0] if task_id.count(".") >= 2 \
            else task_id
        qp = self._query_pools.get(query_id)
        if qp is None:
            qp = self._query_pools[query_id] = QueryScopedPool(
                self.memory_pool, query_id)
        return qp

    def query_progress(self) -> Dict[str, dict]:
        """Live per-query progress over lifecycle-counting tasks: rows and
        batches emitted plus task/fragment completion, keyed by the attempt
        query id (the coordinator's lifecycle registry resolves attempt ->
        serving query via its alias map). Empty when no task counts."""
        with self._lock:
            tasks = list(self.tasks.values())
        out: Dict[str, dict] = {}
        frag_states: Dict[str, Dict[int, List[str]]] = {}
        for t in tasks:
            if not t._count_progress:
                continue
            m = _TASK_ID_RE.match(t.task_id)
            qid = m.group(1) if m else t.task_id
            fid = int(m.group(2)) if m else 0
            d = out.setdefault(qid, {
                "rows": 0, "batches": 0, "tasksDone": 0, "tasksTotal": 0,
                "fragmentsDone": 0, "fragmentsTotal": 0})
            d["rows"] += t.rows_emitted
            d["batches"] += t.batches_emitted
            d["tasksTotal"] += 1
            if t.state != "running":
                d["tasksDone"] += 1
            frag_states.setdefault(qid, {}).setdefault(fid, []).append(
                t.state)
        for qid, fmap in frag_states.items():
            out[qid]["fragmentsTotal"] = len(fmap)
            out[qid]["fragmentsDone"] = sum(
                1 for states in fmap.values()
                if all(s != "running" for s in states))
        return out

    def query_inflight(self) -> Dict[str, dict]:
        """Per-task inflight telemetry docs keyed by attempt query id ->
        task id, for the heartbeat (`queryInflight`). Empty when no task
        publishes."""
        with self._lock:
            tasks = list(self.tasks.values())
        out: Dict[str, dict] = {}
        for t in tasks:
            pub = t._inflight
            if pub is None or not pub.ops:
                continue
            out.setdefault(pub.query_id, {})[t.task_id] = pub.doc()
        return out

    def query_memory(self) -> Dict[str, int]:
        """Live per-query reserved bytes (stale finished queries pruned)."""
        with self._lock:
            active = {t.task_id.rsplit(".", 2)[0]
                      if t.task_id.count(".") >= 2 else t.task_id
                      for t in self.tasks.values() if t.state == "running"}
            for qid in list(self._query_pools):
                if (qid not in active
                        and self._query_pools[qid].query_reserved == 0):
                    del self._query_pools[qid]
            return {qid: qp.query_reserved
                    for qid, qp in self._query_pools.items()}

    def update_task(self, task_id: str, update: TaskUpdate,
                    trace_token: Optional[str] = None) -> dict:
        with self._lock:
            t = self.tasks.get(task_id)
            if t is None:
                t = TaskExecution(task_id, update, self.catalog, self.device,
                                  self._pool_for_locked(task_id),
                                  self.spill_manager,
                                  executor=self.executor,
                                  timeout_s=self.timeout_s,
                                  trace_token=trace_token,
                                  node_id=self.node_id)
                self.tasks[task_id] = t
            return t.info()

    def get(self, task_id: str) -> Optional[TaskExecution]:
        return self.tasks.get(task_id)

    def abort_task(self, task_id: str):
        t = self.tasks.get(task_id)
        if t is not None:
            t.abort()

    def abort_all(self):
        for t in list(self.tasks.values()):
            t.abort()

    def has_running(self) -> bool:
        return any(t.state == "running" for t in self.tasks.values())


_TASK_RE = re.compile(r"^/v1/task/([^/]+)$")
_RESULTS_RE = re.compile(r"^/v1/task/([^/]+)/results/(\d+)/(\d+)$")
_ACK_RE = re.compile(r"^/v1/task/([^/]+)/results/(\d+)/(\d+)/ack$")
_BUFFER_RE = re.compile(r"^/v1/task/([^/]+)/results/(\d+)$")
_STATUS_RE = re.compile(r"^/v1/task/([^/]+)/status$")
_TRACE_RE = re.compile(r"^/v1/task/([^/]+)/trace$")
_DICT_RE = re.compile(r"^/v1/dict/([0-9a-f]{64})$")


class Worker:
    """A worker node: HTTP server + task manager + node lifecycle. Its
    tasks run on `device` (None: CUDA, raising when there is none).
    `timeout_s` bounds each HTTP call it makes."""

    def __init__(self, catalog: Catalog, node_id: str = "worker-0",
                 port: int = 0, coordinator_url: Optional[str] = None,
                 memory_pool_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 revoke_threshold: float = 0.9, revoke_target: float = 0.5,
                 cluster_secret: Optional[str] = None, run_slots: int = 4,
                 device: Optional[Union[str, torch.device]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.catalog = catalog
        self.device = default_device(device)
        self.timeout_s = timeout_s
        self.node_id = node_id
        # Intra-cluster auth: mutating endpoints require the shared cluster
        # secret when one is configured; task bodies are JSON over the
        # closed plan-node vocabulary (plan/codec.py — TaskUpdateRequest
        # analog), so no code execution is reachable from the wire.
        self.cluster_secret = cluster_secret
        self.memory_pool = MemoryPool(memory_pool_bytes,
                                      revoke_threshold=revoke_threshold,
                                      revoke_target=revoke_target)
        self.spill_manager = SpillManager(spill_dir)
        self.task_manager = TaskManager(catalog, self.device,
                                        self.memory_pool,
                                        self.spill_manager,
                                        run_slots=run_slots,
                                        timeout_s=timeout_s,
                                        node_id=node_id)
        self.node_state = "active"   # active | shutting_down | shut_down
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _bytes(self, data: bytes, code=200):
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _authorized(self) -> bool:
                if worker.cluster_secret is None:
                    return True
                return (self.headers.get("X-Presto-Cluster-Secret")
                        == worker.cluster_secret)

            def do_POST(self):
                m = _TASK_RE.match(self.path)
                if m:
                    if not self._authorized():
                        return self._json({"error": "unauthorized"}, 403)
                    n = int(self.headers.get("Content-Length", 0))
                    from presto_tpu_torch.plan.codec import (
                        CodecError, task_update_from_json,
                    )

                    try:
                        update = task_update_from_json(
                            json.loads(self.rfile.read(n)))
                    except (CodecError, KeyError, TypeError, ValueError) as e:
                        return self._json({"error": f"bad task update: {e}"},
                                          400)
                    info = worker.task_manager.update_task(
                        m.group(1), update,
                        trace_token=self.headers.get(_obs_trace.TRACE_HEADER))
                    return self._json(info)
                if self.path == "/v1/memory/revoke":
                    # cluster ladder rung: the coordinator asks this node's
                    # spillable operator state to move to disk before any
                    # query gets killed for memory. Body {"partial": true}
                    # selects the adaptive partition-granular rung.
                    if not self._authorized():
                        return self._json({"error": "unauthorized"}, 403)
                    n = int(self.headers.get("Content-Length", 0))
                    partial = False
                    if n:
                        try:
                            partial = bool(json.loads(
                                self.rfile.read(n) or b"{}").get("partial"))
                        except (ValueError, AttributeError):
                            partial = False
                    return self._json(worker.revoke_spillable(partial))
                self._json({"error": "not found"}, 404)

            def do_GET(self):
                m = _RESULTS_RE.match(self.path)
                if m:
                    tid, buf, token = m.group(1), int(m.group(2)), int(m.group(3))
                    t = worker.task_manager.get(tid)
                    if t is None:
                        return self._json({"error": "no such task"}, 404)
                    try:
                        pages, next_token, complete = t.buffer.get(buf, token)
                        header = {"next_token": next_token, "complete": complete,
                                  "task_state": t.state, "error": None}
                    except BufferFailed as e:
                        header = {"next_token": token, "complete": True,
                                  "task_state": t.state, "error": str(e)}
                        pages = []
                    return self._bytes(encode_results_payload(header, pages))
                m = _ACK_RE.match(self.path)
                if m:
                    t = worker.task_manager.get(m.group(1))
                    if t is not None:
                        t.buffer.ack(int(m.group(2)), int(m.group(3)))
                    return self._json({"ok": True})
                m = _STATUS_RE.match(self.path)
                if m:
                    t = worker.task_manager.get(m.group(1))
                    if t is None:
                        return self._json({"error": "no such task"}, 404)
                    return self._json(t.info())
                m = _TRACE_RE.match(self.path)
                if m:
                    t = worker.task_manager.get(m.group(1))
                    if t is None:
                        return self._json({"error": "no such task"}, 404)
                    return self._json(t.tracer.to_json())
                m = _DICT_RE.match(self.path)
                if m:
                    # dictionary side channel: by-ref wire pages resolve
                    # their content here exactly once on an intern miss
                    from presto_tpu_torch.serde import lookup_dictionary

                    vals = lookup_dictionary(m.group(1))
                    if vals is None:
                        return self._json(
                            {"error": "dictionary not interned"}, 404)
                    return self._json(vals)
                if self.path == "/v1/info":
                    return self._json({
                        "nodeId": worker.node_id,
                        "state": worker.node_state,
                        "uri": worker.url,
                        "coordinator": False,
                    })
                if self.path == "/v1/status":
                    return self._json(worker.status())
                if self.path == "/v1/metrics":
                    from presto_tpu_torch.server.metrics import (
                        worker_metrics,
                    )

                    body = worker_metrics(worker).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._json({"error": "not found"}, 404)

            def do_DELETE(self):
                m = _TASK_RE.match(self.path)
                if m:
                    if not self._authorized():
                        return self._json({"error": "unauthorized"}, 403)
                    worker.task_manager.abort_task(m.group(1))
                    return self._json({"ok": True})
                m = _BUFFER_RE.match(self.path)
                if m:
                    t = worker.task_manager.get(m.group(1))
                    if t is not None:
                        t.buffer.abort(int(m.group(2)))
                    return self._json({"ok": True})
                self._json({"error": "not found"}, 404)

            def do_PUT(self):
                if self.path == "/v1/info/state":
                    if not self._authorized():
                        return self._json({"error": "unauthorized"}, 403)
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b'""')
                    if body == "SHUTTING_DOWN":
                        worker.start_graceful_shutdown()
                        return self._json({"ok": True})
                    return self._json({"error": f"bad state {body}"}, 400)
                self._json({"error": "not found"}, 404)

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(
            target=self.server.serve_forever, daemon=True,
            name=f"worker-http-{self.node_id}",
        )
        self._serve_thread.start()
        self._coordinator_url = coordinator_url
        self._announce_thread = None
        if coordinator_url:
            self._announce_thread = threading.Thread(
                target=self._announce_loop, args=(coordinator_url,), daemon=True
            )
            self._announce_thread.start()

    def revoke_spillable(self, partial: bool = False) -> dict:
        """Signal every revocable-state owner on this node's pool (hybrid
        hash join builds, grace-agg accumulators): each flags itself and
        spills at its next batch boundary. The out-of-band half of the
        memory contract — reserve()-inline revoking handles local pressure,
        this handles CLUSTER pressure relayed by the coordinator.

        ``partial=True`` is the adaptive rung: shed only the LARGEST
        partitions of partition-granular owners (adaptive radix
        aggregations) instead of whole operators — `partitionsRevoked`
        comes back 0 when no such owner is registered, and the caller
        falls through to the whole-operator rung."""
        if partial:
            n = self.memory_pool.request_partial_revoke()
            return {"nodeId": self.node_id, "revokersSignaled": 0,
                    "partitionsRevoked": n}
        n = self.memory_pool.request_revoke()
        return {"nodeId": self.node_id, "revokersSignaled": n}

    def status(self) -> dict:
        tasks = self.task_manager.tasks
        doc = {
            "nodeId": self.node_id,
            "state": self.node_state,
            "device": str(self.device),
            "tasks": len(tasks),
            "runningTasks": sum(1 for t in tasks.values()
                                if t.state == "running"),
            "memory": self.memory_pool.info(),
            "queryMemory": self.task_manager.query_memory(),
            "spillInUseBytes": self.spill_manager.in_use_bytes,
        }
        progress = self.task_manager.query_progress()
        if progress:
            # lifecycle plane: live row counts ride the heartbeat so the
            # coordinator's progress endpoint sees mid-query state
            doc["queryProgress"] = progress
        inflight = self.task_manager.query_inflight()
        if inflight:
            # inflight plane: per-task operator watermarks; the
            # coordinator merges them per fragment (seq-guarded, so the
            # in-process cluster never double-counts)
            doc["queryInflight"] = inflight
        if _devprof.active():
            # the device's own memory accounting rides the heartbeat
            doc["deviceMemory"] = _devprof.device_memory_doc()
        return doc

    def _announce_once(self):
        """One announcement PUT carrying this node's current state."""
        if not self._coordinator_url:
            return
        try:
            body = json.dumps({"nodeId": self.node_id, "uri": self.url,
                               "state": self.node_state}).encode()
            req = urllib.request.Request(
                f"{self._coordinator_url}/v1/announcement/{self.node_id}",
                data=body, method="PUT",
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=min(5.0, self.timeout_s)).read()
        except Exception:  # noqa: BLE001 — the next announcement retries
            pass

    def _announce_loop(self, coordinator_url: str):
        """Service announcement (airlift discovery analog): re-announce
        periodically so the coordinator can expire dead nodes."""
        while self.node_state != "shut_down":
            self._announce_once()
            time.sleep(1.0)

    def start_graceful_shutdown(self):
        """Drain: stop accepting tasks, wait for running tasks, then stop
        (GracefulShutdownHandler.java:73)."""

        def drain():
            self.node_state = "shutting_down"
            # tell discovery immediately (don't wait for the next
            # announcement cycle) so scheduling stops routing here
            self._announce_once()
            while self.task_manager.has_running():
                time.sleep(0.1)
            self.close()
            self.node_state = "shut_down"

        threading.Thread(target=drain, daemon=True).start()

    def close(self):
        # stop announcing FIRST: a closed server that keeps announcing
        # would decay its failure score back under the exclusion threshold
        # and re-enter scheduling rotation as a black hole
        if self.node_state == "active":
            self.node_state = "shut_down"
        self.task_manager.abort_all()
        self.server.shutdown()
        self.server.server_close()
