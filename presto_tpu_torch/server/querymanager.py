"""Query lifecycle management.

Analog of execution/SqlQueryManager.java:92,304 (createQuery + enforcement
loops), QueryTracker.java (registry + expiry), and QueryStateMachine.java
(the state lattice QUEUED → PLANNING → RUNNING → FINISHING → FINISHED /
FAILED / CANCELED with listeners). Execution itself is pluggable — the
distributed scheduler for a cluster — via the `execute_fn` the manager is
constructed with.

The JAX package's server/querymanager.py without its admission control
(resource groups, which come with the cluster services, ROADMAP item 17):
a query is admitted as soon as it is created, under the label the JAX
package gives a query with no resource-group configuration ("global").
With the `lifecycle` session property on, every transition lands on the
query's timeline (obs/lifecycle.py); with `inflight` on, the query is
registered with the mid-flight telemetry plane (obs/inflight.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from presto_tpu_torch.obs import inflight as _inflight
from presto_tpu_torch.obs import lifecycle as _lifecycle
from presto_tpu_torch.server.session import Session

# the JAX package's root resource group, which takes every query when no
# resource groups are configured
DEFAULT_GROUP = "global"

# state lattice (QueryState.java) — terminal states are absorbing;
# EXPIRED is the enforcement loop's terminal (query_max_run_time_s),
# distinct from FAILED so clients can attribute it
QUEUED = "QUEUED"
PLANNING = "PLANNING"
RUNNING = "RUNNING"
FINISHING = "FINISHING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"
EXPIRED = "EXPIRED"
TERMINAL = {FINISHED, FAILED, CANCELED, EXPIRED}


@dataclasses.dataclass
class QueryResult:
    columns: List[str]
    types: List[str]
    rows: List[tuple]


@dataclasses.dataclass
class QueryInfo:
    query_id: str
    sql: str
    state: str
    user: str
    resource_group: Optional[str]
    create_time: float
    end_time: Optional[float] = None
    error: Optional[str] = None
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


class QueryExecution:
    """One query's state machine + worker thread
    (SqlQueryExecution.java:97 — start():335 runs analyze/plan/schedule)."""

    def __init__(self, session: Session, sql: str,
                 execute_fn: Callable[[Session, str], QueryResult]):
        self.session = session
        self.sql = sql
        self.query_id = session.query_id
        self._execute_fn = execute_fn
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.state = QUEUED
        self.error: Optional[str] = None
        self.error_type: Optional[str] = None
        self.result: Optional[QueryResult] = None
        self.create_time = time.time()
        self.end_time: Optional[float] = None
        self.resource_group: Optional[str] = None
        self._cancel_requested = False
        self._listeners: List[Callable[[str], None]] = []
        # lifecycle plane: the registry entry's Timeline when the session
        # runs with lifecycle=on, else None (every hook a no-op)
        self.timeline = None
        self.expired_limit_s: Optional[float] = None
        self.expired_elapsed_s: Optional[float] = None

    # -- state machine -----------------------------------------------------

    def _transition(self, new: str) -> bool:
        with self._lock:
            if self.state in TERMINAL:
                return False
            self.state = new
            if new in TERMINAL:
                self.end_time = time.time()
            listeners = list(self._listeners)
        if self.timeline is not None:
            attrs = {}
            if new == EXPIRED and self.expired_limit_s is not None:
                attrs = {"limitS": self.expired_limit_s,
                         "elapsedS": self.expired_elapsed_s}
            _lifecycle.transition(self.query_id, new, **attrs)
        for fn in listeners:
            fn(new)
        if new in TERMINAL:
            self._done.set()
        return True

    def add_state_listener(self, fn: Callable[[str], None]):
        with self._lock:
            self._listeners.append(fn)

    def fail(self, message: str, error_type: str = "INTERNAL_ERROR"):
        self.error = message
        self.error_type = error_type
        self._transition(FAILED)

    def cancel(self):
        self._cancel_requested = True
        self._transition(CANCELED)

    def expire(self, limit_s: float):
        """Enforcement-loop kill: terminal EXPIRED with the limit and
        elapsed wall in the error payload."""
        elapsed = time.time() - self.create_time
        self.expired_limit_s = float(limit_s)
        self.expired_elapsed_s = round(elapsed, 6)
        self.error = (f"Query exceeded maximum run time of {limit_s}s "
                      f"(elapsed {elapsed:.3f}s)")
        self.error_type = "EXCEEDED_TIME_LIMIT"
        self._transition(EXPIRED)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    # -- execution ---------------------------------------------------------

    def start(self):
        threading.Thread(target=self._run, daemon=True,
                         name=f"query-{self.query_id}").start()

    def _run(self):
        if not self._transition(PLANNING):
            return
        try:
            self._transition(RUNNING)
            result = self._execute_fn(self.session, self.sql)
            if self._cancel_requested:
                return
            self._transition(FINISHING)
            self.result = result
            self._transition(FINISHED)
        except Exception as e:  # noqa: BLE001 — query failure is data, not a crash
            self.fail(f"{type(e).__name__}: {e}", error_type=type(e).__name__)
            self._traceback = traceback.format_exc()

    def info(self) -> QueryInfo:
        stats: Dict[str, Any] = {"elapsed_s": round(
            (self.end_time or time.time()) - self.create_time, 6)}
        if self.timeline is not None:
            stats["lifecycle"] = self.timeline.doc()
        if self.expired_limit_s is not None:
            stats["expired"] = {"limitS": self.expired_limit_s,
                                "elapsedS": self.expired_elapsed_s}
        return QueryInfo(
            query_id=self.query_id,
            sql=self.sql,
            state=self.state,
            user=self.session.user,
            resource_group=self.resource_group,
            create_time=self.create_time,
            end_time=self.end_time,
            error=self.error,
            stats=stats,
        )


class QueryManager:
    """Registry + enforcement (SqlQueryManager: createQuery:304, the
    limit-enforcement loop, QueryTracker expiry)."""

    def __init__(
        self,
        execute_fn: Callable[[Session, str], QueryResult],
        max_query_history: int = 100,
        min_query_expire_age_s: float = 600.0,
    ):
        self._execute_fn = execute_fn
        self._queries: Dict[str, QueryExecution] = {}
        self._lock = threading.Lock()
        self.max_query_history = max_query_history
        self.min_query_expire_age_s = min_query_expire_age_s
        self._enforcer = threading.Thread(
            target=self._enforcement_loop, daemon=True, name="query-enforcer"
        )
        self._enforcer_stop = threading.Event()
        self._enforcer.start()
        self.listeners: List[Callable[[str, QueryInfo], None]] = []

    def close(self):
        self._enforcer_stop.set()

    # -- lifecycle ---------------------------------------------------------

    def create_query(self, session: Session, sql: str,
                     execute_fn: Optional[Callable] = None) -> QueryExecution:
        """execute_fn override supports coordinator-side statements
        (SHOW/SET/EXPLAIN — DataDefinitionExecution analog)."""
        qe = QueryExecution(session, sql, execute_fn or self._execute_fn)
        if str(session.get("lifecycle")).lower() == "on":
            qe.timeline = _lifecycle.register(
                qe.query_id, group=DEFAULT_GROUP,
                objectives=_lifecycle.parse_objectives(
                    session.get("slo_objectives")),
                regression_factor=float(
                    session.get("latency_regression_factor"))).timeline
        if str(session.get("inflight")).lower() == "on":
            # operator heartbeats, the stall/straggler watcher and the
            # query doctor; registering arms the plane
            _inflight.register(
                qe.query_id, group=DEFAULT_GROUP,
                stall_threshold_s=float(session.get("stall_threshold_s")),
                straggler_factor=float(session.get("straggler_factor")))
        with self._lock:
            self._queries[qe.query_id] = qe
        self._emit("queryCreated", qe)
        qe.add_state_listener(
            lambda state, qe=qe: self._on_state(qe, state))
        _lifecycle.mark(qe.query_id, "admitted")
        qe.start()
        self._expire_old()
        return qe

    def _on_state(self, qe: QueryExecution, state: str):
        if state in TERMINAL:
            # close any open stall episode and stop the watcher from
            # flagging the finished query
            _inflight.finish(qe.query_id)
            self._emit("queryCompleted", qe)

    def _emit(self, event: str, qe: QueryExecution):
        for fn in list(self.listeners):
            try:
                fn(event, qe.info())
            except Exception:  # noqa: BLE001 — a listener never fails a query
                pass

    def get(self, query_id: str) -> QueryExecution:
        with self._lock:
            if query_id not in self._queries:
                raise KeyError(f"unknown query {query_id}")
            return self._queries[query_id]

    def cancel(self, query_id: str):
        self.get(query_id).cancel()

    def queries(self) -> List[QueryInfo]:
        with self._lock:
            return [qe.info() for qe in self._queries.values()]

    # -- enforcement (SqlQueryManager.enforceTimeLimits) --------------------

    def _enforcement_loop(self):
        while not self._enforcer_stop.wait(1.0):
            now = time.time()
            with self._lock:
                running = [q for q in self._queries.values() if not q.done]
            for q in running:
                limit = q.session.get("query_max_run_time_s")
                if limit and now - q.create_time > limit:
                    q.expire(limit)

    def _expire_old(self):
        with self._lock:
            done = [q for q in self._queries.values() if q.done]
            if len(self._queries) <= self.max_query_history:
                return
            done.sort(key=lambda q: q.end_time or 0)
            now = time.time()
            for q in done:
                if len(self._queries) <= self.max_query_history:
                    break
                if now - (q.end_time or now) >= self.min_query_expire_age_s or len(
                    self._queries
                ) > 2 * self.max_query_history:
                    del self._queries[q.query_id]


def batch_to_result(batch) -> QueryResult:
    """Materialize an engine Batch into the wire-facing QueryResult."""
    d = batch.to_pydict()
    cols = list(d.keys())
    n = len(next(iter(d.values()))) if cols else 0
    rows = [tuple(d[c][i] for c in cols) for i in range(n)]
    return QueryResult(
        columns=cols,
        types=[str(t) for t in batch.types],
        rows=rows,
    )
