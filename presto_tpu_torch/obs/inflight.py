"""Mid-flight telemetry plane: live operator watermarks + bottleneck doctor.

Every other telemetry plane (HBO, devprof, lifecycle) reports after an
operator or query finishes; this one is readable WHILE a run is in
flight, which is what adaptive mid-query execution (ROADMAP item 12)
needs to react to. Operators publish into a per-query store at
wave/window boundaries only — counts the host already holds (rows
in/out, windows dispatched, overflow caps, spill depth/repartitions,
exchange lane utilization), never a fresh device sync — and everything
downstream is derived from those watermarks:

- ``GET /v1/query/{id}/inflight`` — merged per-fragment snapshot on the
  coordinator. Worker heartbeats carry per-task docs (`queryInflight`),
  merged idempotently by per-operator sequence number so the in-process
  cluster (workers publishing directly into the same registry their
  heartbeats also report) never double-counts.
- **Stall detector** — a coordinator-side watcher thread flags queries
  whose executing segment advances but whose row watermarks have not
  moved for ``stall_threshold_s``: emits a throttled ``stall_detected``
  event naming the stalled operator and appends a forensic JSONL record
  (last N window snapshots per operator, pool reservations, open span
  stack) analogous to the low-memory killer's forensics.
- **Straggler detector** — compares per-site window watermarks across a
  fragment's tasks; a site > ``straggler_factor``x behind its siblings
  emits ``straggler_detected`` and a slow-log doc.
- **Query doctor** — :func:`analyze` stitches lifecycle segments,
  inflight watermarks, trace spans, HBO drift and spill markers
  into one ranked verdict ("62% of wall in exchange_wait on fragment 3;
  lane util 0.11"), surfaced on EXPLAIN ANALYZE,
  ``GET /v1/query/{id}/doctor``, and the slow-query log.

Off-discipline matches every sibling plane: nothing registers, arms, or
starts the watcher until the ``inflight`` session property is on, so
``inflight=off`` sessions leave the serving path and the ``/v1/metrics``
scrape bit-for-bit identical (the ``presto_tpu_inflight_*`` /
``presto_tpu_stalls_total`` / ``presto_tpu_stragglers_total`` families
render only once :func:`armed`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from presto_tpu_torch.obs import events as _obs_events

#: window snapshots retained per operator (the forensic ring)
SNAPSHOT_DEPTH = 8

#: gauge keys an operator may publish (overwrite semantics; anything the
#: driver observed at the window boundary — never a fresh device sync)
GAUGE_KEYS = ("overflow", "cap", "spillDepth", "repartitions",
              "spilledBytes", "laneUtil", "lanesUsed", "lanesTotal",
              "wave", "stagedWindows", "site", "adaptiveActions",
              "adaptiveLast")


# ---------------------------------------------------------------------------
# per-task publisher

class TaskInflight:
    """The handle operators publish through (``ctx.inflight``). One per
    task execution; owns its operator docs, feeds the worker heartbeat
    (`doc()`), and — when the query is registered in this process —
    mirrors straight into the coordinator registry entry."""

    def __init__(self, query_id: str, task_id: str, fragment: int = 0):
        self.query_id = query_id
        self.task_id = task_id
        self.fragment = int(fragment)
        self.finished = False
        self._lock = threading.Lock()
        #: op name -> {seq, ts, windows, batches, rowsIn, rowsOut,
        #:             <gauges>, snapshots: deque}
        self.ops: Dict[str, Dict[str, Any]] = {}
        self._entry: Optional["QueryInflight"] = None

    def publish(self, op: str, rows_in: int = 0, rows_out: int = 0,
                windows: int = 0, batches: int = 0, **gauges) -> None:
        """One window-boundary heartbeat for operator ``op``: counters
        accumulate, gauges overwrite, and a snapshot lands in the
        forensic ring. Host-only arithmetic — callers pass counts they
        already computed; this never touches the device."""
        now = time.time()
        with self._lock:
            d = self.ops.get(op)
            if d is None:
                d = {"seq": 0, "ts": now, "windows": 0, "batches": 0,
                     "rowsIn": 0, "rowsOut": 0,
                     "snapshots": deque(maxlen=SNAPSHOT_DEPTH)}
                self.ops[op] = d
            d["seq"] += 1
            d["ts"] = now
            d["windows"] += int(windows)
            d["batches"] += int(batches)
            d["rowsIn"] += int(rows_in)
            d["rowsOut"] += int(rows_out)
            for k, v in gauges.items():
                if k in GAUGE_KEYS and v is not None:
                    d[k] = v
            snap = {"seq": d["seq"], "ts": round(now, 6),
                    "windows": d["windows"], "batches": d["batches"],
                    "rowsIn": d["rowsIn"], "rowsOut": d["rowsOut"]}
            for k in GAUGE_KEYS:
                if k in d:
                    snap[k] = d[k]
            d["snapshots"].append(snap)
        entry = self._entry
        if entry is not None:
            entry._note_publish(op, now)
        _count_publish()

    def finish(self) -> None:
        self.finished = True

    def windows_watermark(self) -> int:
        """The task's progress watermark: max windows over its ops, or —
        for fragments whose operators never dispatch fused windows (pure
        scan/project pipelines) — max batches, so sibling sites stay
        comparable for the straggler detector."""
        with self._lock:
            w = max((d["windows"] for d in self.ops.values()), default=0)
            if w:
                return w
            return max((d["batches"] for d in self.ops.values()), default=0)

    def doc(self) -> Dict[str, Any]:
        """Serializable per-task doc for the worker heartbeat."""
        with self._lock:
            ops = {op: {**{k: v for k, v in d.items() if k != "snapshots"},
                        "snapshots": list(d["snapshots"])}
                   for op, d in self.ops.items()}
        return {"taskId": self.task_id, "fragment": self.fragment,
                "finished": self.finished, "ops": ops}


# ---------------------------------------------------------------------------
# registry entry

class QueryInflight:
    """Coordinator-side entry: the per-task publishers (or their merged
    heartbeat images), stall/straggler episode state, and thresholds."""

    def __init__(self, query_id: str, group: Optional[str] = None,
                 stall_threshold_s: float = 2.0,
                 straggler_factor: float = 4.0):
        self.query_id = query_id
        self.group = group or "none"
        self.stall_threshold_s = float(stall_threshold_s or 2.0)
        self.straggler_factor = float(straggler_factor or 4.0)
        self.created = time.time()
        self.finished = False
        self._lock = threading.Lock()
        self.tasks: Dict[str, TaskInflight] = {}
        self.publishes = 0
        self.last_publish_ts: Optional[float] = None
        # stall episode state (watcher-owned except episode close)
        self._stall_since: Optional[float] = None
        self._stall_op: Optional[Tuple[str, str]] = None  # (task, op)
        #: op name -> accumulated stalled seconds over closed episodes
        self.stall_seconds: Dict[str, float] = {}
        self.stalls = 0
        #: straggler docs already flagged (one event per (fragment, task))
        self.stragglers: List[Dict[str, Any]] = []
        self._straggler_flagged: set = set()
        #: next observed/predicted rows ratio that fires inflight_drift
        #: (doubles each firing — the event-stream throttle)
        self._next_drift_ratio = 2.0

    # -- publish-side hooks -----------------------------------------------

    def _note_publish(self, op: str, now: float) -> None:
        with self._lock:
            self.publishes += 1
            self.last_publish_ts = now
            if self._stall_since is not None:
                # the watermark moved: close the stall episode and book
                # its wall to the operator that was stuck
                stuck = self._stall_op[1] if self._stall_op else op
                self.stall_seconds[stuck] = (
                    self.stall_seconds.get(stuck, 0.0)
                    + max(0.0, now - self._stall_since))
                self._stall_since = None
                self._stall_op = None

    def attach(self, task: TaskInflight) -> None:
        with self._lock:
            self.tasks[task.task_id] = task
        task._entry = self

    # -- derived watermarks -----------------------------------------------

    def total_rows_out(self) -> int:
        with self._lock:
            tasks = list(self.tasks.values())
        total = 0
        for t in tasks:
            with t._lock:
                total += sum(int(d.get("rowsOut", 0))
                             for d in t.ops.values())
        return total

    def stall_wall_s(self, now: Optional[float] = None) -> float:
        """Stalled seconds booked so far (closed episodes + the open
        one) — the doctor's stall score numerator."""
        now = time.time() if now is None else now
        with self._lock:
            total = sum(self.stall_seconds.values())
            if self._stall_since is not None:
                total += max(0.0, now - self._stall_since)
        return total


_lock = threading.RLock()
_entries: "OrderedDict[str, QueryInflight]" = OrderedDict()
_aliases: Dict[str, str] = {}
_MAX_ENTRIES = 256

_counter_lock = threading.Lock()
_publishes_total = 0
_stalls_total = 0
_stragglers_total = 0

_armed = False

# coordinator-configured context providers (best-effort, forensics only)
_forensics_dir: Optional[str] = None
_span_provider: Optional[Callable[[str], Optional[list]]] = None
_pool_provider: Optional[Callable[[], Optional[dict]]] = None


def _count_publish() -> None:
    global _publishes_total
    with _counter_lock:
        _publishes_total += 1


def arm() -> None:
    global _armed
    with _counter_lock:
        _armed = True


def armed() -> bool:
    return _armed


def configure(forensics_dir: Optional[str] = None,
              span_provider: Optional[Callable] = None,
              pool_provider: Optional[Callable] = None) -> None:
    """Wire coordinator context into forensic dumps. Configuring does
    NOT arm the plane — off sessions stay bit-for-bit."""
    global _forensics_dir, _span_provider, _pool_provider
    with _lock:
        if forensics_dir is not None:
            _forensics_dir = forensics_dir
        if span_provider is not None:
            _span_provider = span_provider
        if pool_provider is not None:
            _pool_provider = pool_provider


# ---------------------------------------------------------------------------
# registry

def register(query_id: str, group: Optional[str] = None,
             stall_threshold_s: float = 2.0,
             straggler_factor: float = 4.0) -> QueryInflight:
    """Create (and arm) the inflight entry for a query; starts the
    watcher thread on first use. Gated by the ``inflight`` session
    property at the call site — never reached for off sessions."""
    entry = QueryInflight(query_id, group=group,
                          stall_threshold_s=stall_threshold_s,
                          straggler_factor=straggler_factor)
    with _lock:
        arm()
        _entries[query_id] = entry
        while len(_entries) > _MAX_ENTRIES:
            old_id, _ = _entries.popitem(last=False)
            for a in [a for a, q in _aliases.items() if q == old_id]:
                del _aliases[a]
    _ensure_watcher()
    return entry


def alias(attempt_id: str, query_id: str) -> None:
    """Map a scheduler attempt query id onto the serving query id, so
    task publishers and heartbeat docs (keyed by attempt) reach the
    right entry."""
    if attempt_id == query_id:
        return
    with _lock:
        if query_id in _entries:
            _aliases[attempt_id] = query_id


def get(query_id: str) -> Optional[QueryInflight]:
    with _lock:
        qid = _aliases.get(query_id, query_id)
        return _entries.get(qid)


def task(query_id: str, task_id: str,
         fragment: int = 0) -> TaskInflight:
    """Worker-side publisher factory. Attaches to the registry entry
    when the query is registered in this process (in-process cluster);
    standalone otherwise — the doc still flows via the heartbeat."""
    t = TaskInflight(query_id, task_id, fragment=fragment)
    entry = get(query_id)
    if entry is not None:
        entry.attach(t)
    return t


def publish(query_id: str, op: str, task_id: str = "mesh",
            fragment: int = 0, **kw) -> None:
    """Registry-direct publish for drivers without a per-task publisher
    (the mesh data plane runs in the coordinator process). No-op when
    the query never registered — off-discipline preserved."""
    entry = get(query_id)
    if entry is None:
        return
    with entry._lock:
        t = entry.tasks.get(task_id)
        if t is None:
            t = TaskInflight(entry.query_id, task_id, fragment=fragment)
            t._entry = entry
            entry.tasks[task_id] = t
    t.publish(op, **kw)


def finish(query_id: str) -> None:
    """Terminal-state hook: closes any open stall episode and stops the
    watcher from flagging this query."""
    entry = get(query_id)
    if entry is None:
        return
    now = time.time()
    with entry._lock:
        if entry._stall_since is not None and entry._stall_op:
            op = entry._stall_op[1]
            entry.stall_seconds[op] = (
                entry.stall_seconds.get(op, 0.0)
                + max(0.0, now - entry._stall_since))
        entry._stall_since = None
        entry._stall_op = None
        entry.finished = True
        for t in entry.tasks.values():
            t.finished = True


def merge_worker(node_id: str, doc: Dict[str, Any]) -> None:
    """Fold one worker heartbeat ``queryInflight`` doc (attempt query id
    -> task id -> task doc) into the registry. Idempotent per operator:
    an incoming op doc replaces the held one only when its seq is newer,
    so the in-process cluster (heartbeats re-reporting publishers that
    already live in the registry) never double-counts."""
    for attempt_id, tasks in (doc or {}).items():
        entry = get(attempt_id)
        if entry is None or not isinstance(tasks, dict):
            continue
        for task_id, tdoc in tasks.items():
            if not isinstance(tdoc, dict):
                continue
            with entry._lock:
                t = entry.tasks.get(task_id)
                if t is None:
                    t = TaskInflight(entry.query_id, task_id,
                                     fragment=tdoc.get("fragment", 0))
                    t._entry = entry
                    entry.tasks[task_id] = t
            moved = False
            for op, od in (tdoc.get("ops") or {}).items():
                if not isinstance(od, dict):
                    continue
                with t._lock:
                    held = t.ops.get(op)
                    if held is not None and int(held.get("seq", 0)) >= \
                            int(od.get("seq", 0)):
                        continue
                    merged = {k: v for k, v in od.items()
                              if k != "snapshots"}
                    merged["snapshots"] = deque(
                        od.get("snapshots") or [], maxlen=SNAPSHOT_DEPTH)
                    t.ops[op] = merged
                    moved = True
            if tdoc.get("finished"):
                t.finished = True
            if moved:
                entry._note_publish("", time.time())


# ---------------------------------------------------------------------------
# snapshots (the GET /v1/query/{id}/inflight doc)

def snapshot_doc(query_id: str) -> Optional[Dict[str, Any]]:
    """Merged per-fragment snapshot, or None when the query never
    registered (inflight off / unknown id)."""
    entry = get(query_id)
    if entry is None:
        return None
    with entry._lock:
        tasks = list(entry.tasks.values())
        publishes = entry.publishes
        last_ts = entry.last_publish_ts
        stalls = entry.stalls
        stall_seconds = dict(entry.stall_seconds)
        stragglers = list(entry.stragglers)
        finished = entry.finished
    tdocs = [t.doc() for t in tasks]
    frags: Dict[str, Dict[str, Any]] = {}
    for d in tdocs:
        f = frags.setdefault(str(d["fragment"]), {
            "windows": 0, "batches": 0, "rowsIn": 0, "rowsOut": 0,
            "tasks": 0, "repartitions": 0, "spillDepth": 0})
        f["tasks"] += 1
        for od in d["ops"].values():
            f["windows"] += int(od.get("windows", 0))
            f["batches"] += int(od.get("batches", 0))
            f["rowsIn"] += int(od.get("rowsIn", 0))
            f["rowsOut"] += int(od.get("rowsOut", 0))
            f["repartitions"] += int(od.get("repartitions", 0) or 0)
            f["spillDepth"] = max(f["spillDepth"],
                                  int(od.get("spillDepth", 0) or 0))
            if "laneUtil" in od:
                f["laneUtil"] = od["laneUtil"]
    doc: Dict[str, Any] = {
        "queryId": entry.query_id,
        "group": entry.group,
        "finished": finished,
        "publishes": publishes,
        "lastPublishTs": round(last_ts, 6) if last_ts else None,
        "stalls": stalls,
        "stallSeconds": {op: round(s, 6)
                         for op, s in stall_seconds.items()},
        "fragments": frags,
        "tasks": tdocs,
    }
    if stragglers:
        doc["stragglers"] = stragglers
    return doc


# ---------------------------------------------------------------------------
# metric families — armed-gated like the lifecycle plane: render on the
# scrape only once an inflight-on query has registered.

def metric_rows(labels: Dict[str, str]) -> List[tuple]:
    """Rows for server.metrics.render_metrics (call when armed)."""
    with _lock:
        active = sum(1 for e in _entries.values() if not e.finished)
    with _counter_lock:
        pubs, stalls, strag = (_publishes_total, _stalls_total,
                               _stragglers_total)
    lbl = dict(labels)
    return [
        ("presto_tpu_inflight_queries",
         "queries with a live inflight telemetry entry", active, lbl,
         "gauge"),
        ("presto_tpu_inflight_publishes_total",
         "operator window-boundary telemetry publishes", pubs, lbl,
         "counter"),
        ("presto_tpu_stalls_total",
         "stall episodes flagged by the inflight watcher", stalls, lbl,
         "counter"),
        ("presto_tpu_stragglers_total",
         "fragment sites flagged >factor behind their siblings", strag,
         lbl, "counter"),
    ]


# ---------------------------------------------------------------------------
# watcher: stall + straggler + drift detection

_watcher_lock = threading.Lock()
_watcher: Optional[threading.Thread] = None


def _ensure_watcher() -> None:
    global _watcher
    with _watcher_lock:
        if _watcher is not None and _watcher.is_alive():
            return
        _watcher = threading.Thread(target=_watch_loop,
                                    name="inflight-watcher", daemon=True)
        _watcher.start()


def _watch_loop() -> None:
    global _watcher
    while True:
        with _watcher_lock:
            with _lock:
                entries = [e for e in _entries.values() if not e.finished]
            if not entries:
                # every watched query finished: the watcher stops with
                # them, and the next register() starts a new one
                _watcher = None
                return
        # poll a few times per stall threshold so detection latency is a
        # fraction of the bound, bounded below to stay off the hot path
        thresholds = [e.stall_threshold_s for e in entries] or [2.0]
        interval = min(0.5, max(0.02, min(thresholds) / 5.0))
        time.sleep(interval)
        now = time.time()
        for e in entries:
            try:
                _check_stall(e, now)
                _check_stragglers(e, now)
                _check_drift(e)
            except Exception:
                # the watcher must never take down telemetry publishing
                pass


def _check_stall(e: QueryInflight, now: float) -> None:
    global _stalls_total
    with e._lock:
        if (e.finished or e._stall_since is not None
                or e.last_publish_ts is None
                or now - e.last_publish_ts <= e.stall_threshold_s):
            return
        last = e.last_publish_ts
        # the stalled operator is the last one to publish — it entered a
        # window it never came back from
        stuck_task, stuck_op, stuck_ts = None, None, -1.0
        for tid, t in e.tasks.items():
            with t._lock:
                for op, d in t.ops.items():
                    if d["ts"] > stuck_ts:
                        stuck_task, stuck_op, stuck_ts = tid, op, d["ts"]
        if stuck_op is None:
            return
        e._stall_since = last
        e._stall_op = (stuck_task, stuck_op)
        e.stalls += 1
    with _counter_lock:
        _stalls_total += 1
    _obs_events.EVENTS.emit(
        "stall_detected", query_id=e.query_id, group=e.group,
        operator=stuck_op, taskId=stuck_task,
        stalledS=round(now - last, 6),
        thresholdS=e.stall_threshold_s)
    _dump_forensics(e, stuck_op, stuck_task, now - last)


def _check_stragglers(e: QueryInflight, now: float) -> None:
    global _stragglers_total
    with e._lock:
        tasks = list(e.tasks.items())
        factor = e.straggler_factor
    frags: Dict[int, List[Tuple[str, int]]] = {}
    for tid, t in tasks:
        frags.setdefault(t.fragment, []).append(
            (tid, t.windows_watermark()))
    for frag, sites in frags.items():
        if len(sites) < 2:
            continue
        leader_id, leader = max(sites, key=lambda s: s[1])
        lag_id, lag = min(sites, key=lambda s: s[1])
        # minimum-progress floor: a 2-vs-0 start-of-run skew is noise
        if leader < max(2, factor) or leader < factor * max(1, lag):
            continue
        key = (frag, lag_id)
        with e._lock:
            if key in e._straggler_flagged:
                continue
            e._straggler_flagged.add(key)
            doc = {"fragment": frag, "taskId": lag_id,
                   "leaderTaskId": leader_id, "leaderWindows": leader,
                   "laggardWindows": lag, "factor": factor,
                   "ts": round(now, 6)}
            e.stragglers.append(doc)
        with _counter_lock:
            _stragglers_total += 1
        _obs_events.EVENTS.emit(
            "straggler_detected", query_id=e.query_id, group=e.group,
            **{k: v for k, v in doc.items() if k != "ts"})


def _check_drift(e: QueryInflight) -> None:
    """Throttled ``inflight_drift``: observed output rows crossed the
    next doubling of the HBO-predicted total."""
    from presto_tpu_torch.obs import lifecycle as _lifecycle

    lc = _lifecycle.get(e.query_id)
    predicted = lc.predicted if lc is not None else None
    if not predicted:
        return
    p_sink = float(predicted.get("sink_rows", 0) or 0)
    if p_sink <= 0:
        return
    rows = e.total_rows_out()
    ratio = rows / p_sink
    with e._lock:
        if ratio < e._next_drift_ratio:
            return
        fired_at = e._next_drift_ratio
        while e._next_drift_ratio <= ratio:
            e._next_drift_ratio *= 2.0
    _obs_events.EVENTS.emit(
        "inflight_drift", query_id=e.query_id, group=e.group,
        observedRows=rows, predictedSinkRows=p_sink,
        ratio=round(ratio, 4), threshold=fired_at)


# ---------------------------------------------------------------------------
# forensics (the OOM-forensics analog for stalls)

def _forensics_path() -> Optional[str]:
    base = _forensics_dir or os.environ.get("PRESTO_TPU_CACHE_DIR")
    if not base:
        return None
    return os.path.join(base, "inflight_forensics.jsonl")


def _dump_forensics(e: QueryInflight, op: str, task_id: Optional[str],
                    stalled_s: float) -> Optional[str]:
    path = _forensics_path()
    if path is None:
        return None
    ops: Dict[str, Any] = {}
    with e._lock:
        tasks = list(e.tasks.items())
    for tid, t in tasks:
        with t._lock:
            for name, d in t.ops.items():
                ops[f"{tid}/{name}"] = {
                    "task": tid, "fragment": t.fragment,
                    "snapshots": list(d["snapshots"])}
    rec = {
        "event": "stall_detected",
        "ts": round(time.time(), 6),
        "queryId": e.query_id,
        "group": e.group,
        "operator": op,
        "taskId": task_id,
        "stalledS": round(stalled_s, 6),
        "thresholdS": e.stall_threshold_s,
        "ops": ops,
    }
    if _pool_provider is not None:
        try:
            rec["pool"] = _pool_provider()
        except Exception:
            pass
    if _span_provider is not None:
        try:
            spans = _span_provider(e.query_id)
            if spans:
                rec["openSpans"] = spans
        except Exception:
            pass
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _obs_events._append_line(path, json.dumps(rec, default=str))
    except OSError:
        return None
    return path


# ---------------------------------------------------------------------------
# query doctor

def analyze(query_id: str, spans: Optional[list] = None,
            state: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Ranked bottleneck attribution for one query: stitch lifecycle
    segments, inflight watermarks, trace spans, HBO drift and spill
    markers into causes scored by estimated fraction of wall. None when neither plane ever saw the query."""
    from presto_tpu_torch.obs import lifecycle as _lifecycle

    lc = _lifecycle.get(query_id)
    entry = get(query_id)
    if lc is None and entry is None:
        return None
    now = time.time()
    segments = (lc.timeline.segments() if lc is not None
                else {s: 0.0 for s in ("queue_wait", "plan", "compile",
                                       "exec", "drain", "e2e")})
    wall = max(segments.get("e2e", 0.0), 1e-9)
    causes: List[Dict[str, Any]] = []

    def cause(kind: str, score: float, detail: str,
              where: Optional[str] = None, **extra) -> None:
        if score <= 0.0:
            return
        c = {"cause": kind, "score": round(min(1.0, score), 4),
             "detail": detail}
        if where:
            c["where"] = where
        c.update(extra)
        causes.append(c)

    # -- stalls: wall booked to the operator that stopped publishing
    stall_s = entry.stall_wall_s(now) if entry is not None else 0.0
    stall_share = min(1.0, stall_s / wall)
    if entry is not None and stall_s > 0:
        booked = dict(entry.stall_seconds)
        open_op = entry._stall_op[1] if entry._stall_op else None
        if open_op is not None:
            booked[open_op] = booked.get(open_op, 0.0) + max(
                0.0, now - (entry._stall_since or now))
        worst_op = max(booked, key=booked.get) if booked else "unknown"
        cause("stall", stall_share,
              f"row watermarks frozen {stall_s:.2f}s "
              f"(threshold {entry.stall_threshold_s}s)",
              where=f"operator {worst_op}", operator=worst_op)

    # -- stragglers: a site behind its siblings gates the fragment
    if entry is not None and entry.stragglers:
        worst = max(entry.stragglers,
                    key=lambda s: s["leaderWindows"]
                    - s["laggardWindows"])
        lagf = 1.0 - (worst["laggardWindows"]
                      / max(1, worst["leaderWindows"]))
        cause("straggler",
              (segments.get("exec", 0.0) / wall) * lagf,
              f"site {worst['laggardWindows']}/{worst['leaderWindows']} "
              f"windows behind leader",
              where=f"fragment {worst['fragment']} "
                    f"task {worst['taskId']}",
              operator=worst["taskId"])

    # -- exchange wait from closed spans: the span envelope covers the
    #    whole stream, so score the wait_s attr (true consumer-blocked
    #    seconds), residual after stall attribution — exchange wait
    #    downstream of a stalled operator is a symptom, not the cause
    exch_share = 0.0
    if spans:
        def _wait_s(s):
            a = getattr(s, "attrs", None) or {}
            w = a.get("wait_s")
            return float(w) if w is not None else s.duration_s

        waits = [s for s in spans
                 if getattr(s, "kind", None) == "exchange_wait"
                 and getattr(s, "end", None) is not None]
        total_wait = sum(_wait_s(s) for s in waits)
        exch_share = min(1.0, total_wait / wall)
        exch_residual = max(0.0, exch_share - stall_share)
        if waits and exch_residual >= 0.1:
            worst = max(waits, key=_wait_s)
            a = worst.attrs or {}
            util = a.get("util")
            detail = f"{total_wait:.3f}s blocked on exchange"
            if util is not None:
                detail += f"; lane util {util}"
            cause("exchange_wait", exch_residual, detail,
                  where=f"fragment {a.get('fragment', a.get('fid'))}")
        replays = sum(1 for s in spans
                      if getattr(s, "kind", None) == "overflow_replay")
        if replays:
            cause("overflow_replay", min(0.5, 0.15 * replays),
                  f"{replays} overflow replay wave(s) re-ran the "
                  f"breaker fragment")
        spills = sum(1 for s in spans
                     if getattr(s, "kind", None) == "spill_repartition")
        if spills:
            cause("spill", min(0.5, 0.1 * spills),
                  f"{spills} spill repartition(s) — build exceeded "
                  f"memory budget")

    # (the JAX package's adaptive-layer causes wait for ROADMAP item 12)

    # -- lifecycle segment dominance (exec scored on its residual after
    #    stall/exchange attribution so a named operator outranks the
    #    generic segment)
    if lc is not None:
        for seg in ("queue_wait", "plan", "compile", "drain"):
            share = segments.get(seg, 0.0) / wall
            if seg in ("compile", "drain"):
                # distributed timelines book task execution into the
                # compile/drain envelope until the first/last root batch;
                # stall episodes overlapping it are the better-attributed
                # cause, so these segments score on their residual
                share = max(0.0, share - stall_share)
            if share >= 0.2:
                cause(seg, share, f"{segments[seg]:.3f}s in {seg}")
        exec_share = segments.get("exec", 0.0) / wall
        residual = max(0.0, exec_share - stall_share - exch_share)
        if residual >= 0.25:
            cause("exec", residual,
                  f"{segments['exec']:.3f}s executing — see devprof "
                  f"roofline for device vs dispatch split")

    # -- HBO drift: actual wall vs the pre-run prediction
    predicted = lc.predicted if lc is not None else None
    if predicted:
        p_wall = float(predicted.get("wall_s", 0) or 0)
        if p_wall > 0 and wall >= 2.0 * p_wall:
            cause("hbo_drift", min(1.0, (wall - p_wall) / wall),
                  f"est {wall / p_wall:.1f}x under actual "
                  f"(predicted {p_wall:.3f}s, actual {wall:.3f}s)")

    causes.sort(key=lambda c: c["score"], reverse=True)
    if causes:
        top = causes[0]
        verdict = f"{top['score'] * 100.0:.0f}% of wall in {top['cause']}"
        if top.get("where"):
            verdict += f" on {top['where']}"
        verdict += f"; {top['detail']}"
    else:
        verdict = "no dominant bottleneck attributed"
    doc: Dict[str, Any] = {
        "queryId": query_id,
        "state": state or (lc.timeline.terminal if lc else None)
        or "running",
        "wallS": round(wall, 6),
        "segments": {k: round(v, 6) for k, v in segments.items()},
        "verdict": verdict,
        "causes": causes,
    }
    if entry is not None:
        doc["inflight"] = {
            "publishes": entry.publishes,
            "stalls": entry.stalls,
            "stragglers": len(entry.stragglers),
        }
    if predicted:
        doc["predicted"] = {"rows": predicted.get("rows"),
                            "sinkRows": predicted.get("sink_rows"),
                            "wallS": predicted.get("wall_s")}
    try:
        from presto_tpu_torch.obs import devprof as _devprof

        if _devprof.active():
            doc["devprof"] = _devprof.summary(wall_s=wall)
    except Exception:
        pass
    return doc


def slow_log_annotation(query_id: str) -> Optional[Dict[str, Any]]:
    """Extra fields for the slow-query JSONL record: the doctor verdict
    plus any straggler docs (merged with the lifecycle annotation by the
    coordinator's slow-log listener)."""
    entry = get(query_id)
    if entry is None:
        return None
    doc = analyze(query_id)
    extra: Dict[str, Any] = {}
    if doc is not None:
        extra["doctor"] = {"verdict": doc["verdict"],
                           "causes": doc["causes"][:3]}
    with entry._lock:
        if entry.stragglers:
            extra["stragglers"] = list(entry.stragglers)
        if entry.stalls:
            extra["stalls"] = entry.stalls
    return extra or None


# ---------------------------------------------------------------------------

def reset() -> None:
    """Test hook: drop all entries and counters, disarm. The watcher
    thread (if started) idles over an empty registry."""
    global _armed, _publishes_total, _stalls_total, _stragglers_total
    with _lock:
        _entries.clear()
        _aliases.clear()
    with _counter_lock:
        _publishes_total = 0
        _stalls_total = 0
        _stragglers_total = 0
        _armed = False
