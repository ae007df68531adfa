"""Serving-plane SLO telemetry: query lifecycle timelines + live progress.

Three planes, all keyed on the serving query id (== trace id for traced
queries, so every record correlates with obs/trace spans):

1. **Lifecycle timeline** — monotonic timestamps for every state
   transition (``created -> queued -> admitted -> planning -> compiling
   -> executing -> draining -> finished|failed|canceled|expired``),
   decomposed into five segments that ALWAYS sum exactly to the e2e
   wall: a boundary that was never reached resolves to the next boundary
   on its right, so a query that dies while queued books its whole life
   to ``queue_wait`` and an immediate coordinator statement books its
   execute lambda to ``plan``. Segments feed per-resource-group
   log-bucket histograms (``presto_tpu_query_{queue_wait,compile,exec,
   e2e}_seconds{group=...}``) and the ``slo_objectives=`` violation
   counters.

2. **Live progress** — ``progress_doc`` estimates fraction-complete from
   HBO history (obs/runstats): the fingerprint's recorded output rows / sink
   rows / wall vs. what the coordinator root stream and worker
   heartbeats have observed so far (provenance ``"hbo"``), falling back
   to fragments-done/fragments-total from heartbeats (provenance
   ``"fragments"``). The reported fraction is a running max, so it is
   monotone nondecreasing by construction, and pins to 1.0 on any
   terminal state.

3. **Latency regression** — at completion the pre-run HBO baseline wall
   for the query's fingerprint is compared against the actual e2e; a
   wall >= factor x baseline increments
   ``presto_tpu_latency_regression_total``, lands in the cluster event
   stream, and annotates the slow-query JSONL record.

Everything here is dormant until :func:`register` first runs — the
``lifecycle`` session property gates registration, and the metric
families render on ``/v1/metrics`` only once :func:`armed` is true, so
``lifecycle=off`` sessions leave the scrape (and the serving path)
bit-for-bit as before the plane existed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from presto_tpu_torch.obs.metrics import Histogram, log_buckets
from presto_tpu_torch.obs import events as _obs_events
from presto_tpu_torch.obs import runstats as _runstats

# ---------------------------------------------------------------------------
# vocabulary

#: ordered non-terminal marks; ``created`` is stamped at construction
MARKS: Tuple[str, ...] = ("created", "queued", "admitted", "planning",
                          "compiling", "executing", "draining")
TERMINAL_MARKS: Tuple[str, ...] = ("finished", "failed", "canceled",
                                   "expired")
#: wall-clock decomposition; the five sum exactly to ``e2e``
SEGMENTS: Tuple[str, ...] = ("queue_wait", "plan", "compile", "exec",
                             "drain")
#: segment boundaries, left to right (the implicit 6th boundary is the
#: terminal timestamp / now)
_BOUNDARIES: Tuple[str, ...] = ("created", "planning", "compiling",
                                "executing", "draining")

#: HBO site under which completed-query profiles are recorded (wall,
#: output rows, sink rows) and regression baselines are looked up
HBO_SITE = _runstats.QUERY_SITE

_CANON_ORDER = {name: i for i, name in enumerate(MARKS + ("terminal",))}

# QueryManager state -> timeline mark (None = no mark for this state:
# QUEUED is covered by ``created``, RUNNING is refined into
# compiling/executing by the coordinator's own marks)
_STATE_MAP = {
    "QUEUED": None, "PLANNING": "planning", "RUNNING": None,
    "FINISHING": "draining", "FINISHED": "finished", "FAILED": "failed",
    "CANCELED": "canceled", "EXPIRED": "expired",
}


def parse_objectives(spec: str) -> Dict[str, float]:
    """Parse an ``slo_objectives`` spec: ``"e2e=1.5,queue_wait=0.25"``.

    Keys are segment names (or ``e2e``); values are seconds. Raises
    ValueError on unknown segments or non-numeric bounds so the session
    property validator can reject bad specs at SET time.
    """
    out: Dict[str, float] = {}
    allowed = set(SEGMENTS) | {"e2e"}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"slo_objectives entry {part!r} is not segment=seconds")
        key, _, val = part.partition("=")
        key = key.strip().lower()
        if key not in allowed:
            raise ValueError(
                f"unknown slo_objectives segment {key!r} "
                f"(allowed: {', '.join(sorted(allowed))})")
        limit = float(val)
        if limit <= 0:
            raise ValueError(f"slo_objectives bound for {key!r} must be > 0")
        out[key] = limit
    return out


# ---------------------------------------------------------------------------
# timeline

class Timeline:
    """Monotonic per-query state-transition timestamps.

    First mark wins (replay waves re-enter ``executing``; only the first
    entry is the segment boundary). ``finish`` closes the timeline; late
    marks after a terminal state are dropped.
    """

    def __init__(self, created: Optional[float] = None):
        self.created = time.time() if created is None else created
        self._lock = threading.Lock()
        self.marks: Dict[str, float] = {"created": self.created}
        #: transition log in arrival order: [(name, ts), ...]
        self.order: List[Tuple[str, float]] = [("created", self.created)]
        self.terminal: Optional[str] = None
        self.end: Optional[float] = None

    def mark(self, name: str, ts: Optional[float] = None) -> bool:
        now = time.time() if ts is None else ts
        with self._lock:
            if self.terminal is not None or name in self.marks:
                return False
            self.marks[name] = now
            self.order.append((name, now))
            return True

    def finish(self, terminal: str, ts: Optional[float] = None) -> bool:
        now = time.time() if ts is None else ts
        with self._lock:
            if self.terminal is not None:
                return False
            self.terminal = terminal
            self.end = now
            self.marks[terminal] = now
            self.order.append((terminal, now))
            return True

    def segments(self, now: Optional[float] = None) -> Dict[str, float]:
        """queue/plan/compile/exec/drain + e2e, in seconds.

        A boundary that was never stamped resolves to the next boundary
        on its right (terminal/now as the last resort), which keeps every
        segment nonnegative and makes the five segments sum exactly to
        ``e2e`` regardless of which states the query actually visited.
        """
        with self._lock:
            end = self.end if self.end is not None else (
                time.time() if now is None else now)
            bounds: List[Optional[float]] = [
                self.marks.get(n) for n in _BOUNDARIES]
        bounds.append(end)
        for i in range(len(bounds) - 2, -1, -1):
            if bounds[i] is None:
                bounds[i] = bounds[i + 1]
        return {
            "queue_wait": bounds[1] - bounds[0],
            "plan": bounds[2] - bounds[1],
            "compile": bounds[3] - bounds[2],
            "exec": bounds[4] - bounds[3],
            "drain": bounds[5] - bounds[4],
            "e2e": bounds[5] - bounds[0],
        }

    def doc(self) -> Dict[str, Any]:
        with self._lock:
            order = list(self.order)
            terminal = self.terminal
        return {
            "transitions": [
                {"state": n, "ts": round(ts, 6)} for n, ts in order],
            "terminal": terminal,
            "segments": {k: round(v, 6)
                         for k, v in self.segments().items()},
        }


# ---------------------------------------------------------------------------
# metric families — NOT in obs.metrics.ALL_HISTOGRAMS: they render on the
# scrape only once the plane is armed (first lifecycle-on query), so a
# never-armed process exposes the family set of a plane-free scrape.

QUERY_QUEUE_WAIT = Histogram(
    "presto_tpu_query_queue_wait_seconds",
    "query creation to planning start, per resource group",
    log_buckets(0.001, 600.0))
QUERY_COMPILE = Histogram(
    "presto_tpu_query_compile_seconds",
    "distributed plan ready to first root-stream output, per resource group",
    log_buckets(0.001, 600.0))
QUERY_EXEC = Histogram(
    "presto_tpu_query_exec_seconds",
    "first root-stream output to result drain start, per resource group",
    log_buckets(0.001, 600.0))
QUERY_E2E = Histogram(
    "presto_tpu_query_e2e_seconds",
    "query creation to terminal state, per resource group",
    log_buckets(0.001, 600.0))

SLO_HISTOGRAMS: Tuple[Histogram, ...] = (
    QUERY_QUEUE_WAIT, QUERY_COMPILE, QUERY_EXEC, QUERY_E2E)

_SEGMENT_HISTOGRAMS = {
    "queue_wait": QUERY_QUEUE_WAIT, "compile": QUERY_COMPILE,
    "exec": QUERY_EXEC, "e2e": QUERY_E2E,
}

_counter_lock = threading.Lock()
_slo_violations: Dict[Tuple[str, str], int] = {}   # (group, segment) -> n
# regressions attributed to the lifecycle segment that moved most vs the
# group's running baseline: (group, segment) -> n
_latency_regressions: Dict[Tuple[str, str], int] = {}
# per-(group, segment) running mean of completed-query segment walls:
# (group, segment) -> (sum_s, n). Folded AFTER each query's regression
# check, so attribution always compares against prior completions only.
_segment_baselines: Dict[Tuple[str, str], Tuple[float, int]] = {}
_REGRESSION_SEGMENTS = ("queue_wait", "plan", "compile", "exec", "drain")

_armed = False


def arm() -> None:
    global _armed
    with _counter_lock:
        _armed = True


def armed() -> bool:
    return _armed


def metric_rows(labels: Dict[str, str]) -> List[tuple]:
    """Counter rows for server.metrics.render_metrics (call when armed)."""
    rows: List[tuple] = []
    with _counter_lock:
        viol = dict(_slo_violations)
        regr = dict(_latency_regressions)
    help_v = "queries that missed a configured per-segment latency objective"
    help_r = "completed queries whose wall exceeded factor x HBO baseline"
    if viol:
        for (group, seg), n in sorted(viol.items()):
            rows.append(("presto_tpu_slo_violations_total", help_v, n,
                         {**labels, "group": group, "segment": seg},
                         "counter"))
    else:
        rows.append(("presto_tpu_slo_violations_total", help_v, 0,
                     dict(labels), "counter"))
    if regr:
        for (group, seg), n in sorted(regr.items()):
            rows.append(("presto_tpu_latency_regression_total", help_r, n,
                         {**labels, "group": group, "segment": seg},
                         "counter"))
    else:
        rows.append(("presto_tpu_latency_regression_total", help_r, 0,
                     dict(labels), "counter"))
    return rows


def render_slo_histograms(plane: str) -> str:
    lines: List[str] = []
    for h in SLO_HISTOGRAMS:
        lines.extend(h.render(plane))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# registry

class QueryLifecycle:
    """Registry entry: timeline + live progress state for one query."""

    def __init__(self, query_id: str, group: Optional[str] = None,
                 objectives: Optional[Dict[str, float]] = None,
                 regression_factor: float = 0.0):
        self.query_id = query_id
        self.timeline = Timeline()
        self.group = group or "none"
        self.objectives = dict(objectives or {})
        self.regression_factor = float(regression_factor or 0.0)
        self.fingerprint: Optional[str] = None
        #: HBO entry for the fingerprint as of plan time (pre-run)
        self.predicted: Optional[Dict[str, Any]] = None
        # live observations
        self.rows = 0            # root-stream output rows (coordinator)
        self.batches = 0         # root-stream batches ingested
        self.replay_waves = 0    # overflow replay waves (from spans)
        #: (node_id, attempt_query_id) -> latest heartbeat progress doc
        self.worker_progress: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.regression: Optional[Dict[str, Any]] = None
        self._max_fraction = 0.0
        self._lock = threading.Lock()

    # -- live counting ----------------------------------------------------

    def observe_batch(self, rows: int) -> None:
        with self._lock:
            self.rows += int(rows)
            self.batches += 1

    def worker_rows(self) -> Tuple[int, int]:
        """(sink rows, batches) summed over worker heartbeat docs."""
        with self._lock:
            docs = list(self.worker_progress.values())
        return (sum(int(d.get("rows", 0)) for d in docs),
                sum(int(d.get("batches", 0)) for d in docs))

    def fragment_fraction(self) -> Tuple[float, int, int]:
        """(done/total over tasks, fragmentsDone, fragmentsTotal)."""
        with self._lock:
            docs = list(self.worker_progress.values())
        done = sum(int(d.get("tasksDone", 0)) for d in docs)
        total = sum(int(d.get("tasksTotal", 0)) for d in docs)
        fdone = sum(int(d.get("fragmentsDone", 0)) for d in docs)
        ftotal = sum(int(d.get("fragmentsTotal", 0)) for d in docs)
        return ((done / total) if total else 0.0, fdone, ftotal)


_lock = threading.RLock()
_entries: "OrderedDict[str, QueryLifecycle]" = OrderedDict()
_aliases: Dict[str, str] = {}
_MAX_ENTRIES = 512


def register(query_id: str, group: Optional[str] = None,
             objectives: Optional[Dict[str, float]] = None,
             regression_factor: float = 0.0) -> QueryLifecycle:
    """Create (and arm) the lifecycle entry for a query; emits the
    ``created`` event."""
    entry = QueryLifecycle(query_id, group=group, objectives=objectives,
                           regression_factor=regression_factor)
    with _lock:
        arm()
        _entries[query_id] = entry
        while len(_entries) > _MAX_ENTRIES:
            old_id, _ = _entries.popitem(last=False)
            for a in [a for a, q in _aliases.items() if q == old_id]:
                del _aliases[a]
    _obs_events.EVENTS.emit("lifecycle", query_id=query_id,
                            state="created", group=entry.group)
    return entry


def alias(attempt_id: str, query_id: str) -> None:
    """Map a scheduler attempt query id onto the serving query id, so
    worker heartbeats (keyed by attempt) reach the right entry."""
    if attempt_id == query_id:
        return
    with _lock:
        if query_id in _entries:
            _aliases[attempt_id] = query_id


def get(query_id: str) -> Optional[QueryLifecycle]:
    with _lock:
        qid = _aliases.get(query_id, query_id)
        return _entries.get(qid)


def mark(query_id: str, name: str, **attrs) -> bool:
    """Stamp a timeline mark; emits the matching lifecycle event on the
    first stamp only. No-op (False) for unregistered queries, so callers
    never need their own lifecycle-enabled check."""
    entry = get(query_id)
    if entry is None or not entry.timeline.mark(name):
        return False
    _obs_events.EVENTS.emit("lifecycle", query_id=entry.query_id,
                            state=name, group=entry.group, **attrs)
    return True


def transition(query_id: str, state: str, **attrs) -> bool:
    """Record a QueryManager state transition (called from
    ``QueryExecution._transition``)."""
    entry = get(query_id)
    if entry is None:
        return False
    mapped = _STATE_MAP.get(state, None)
    if mapped is None:
        return False
    if mapped in TERMINAL_MARKS:
        ok = entry.timeline.finish(mapped)
    else:
        ok = entry.timeline.mark(mapped)
    if ok:
        _obs_events.EVENTS.emit("lifecycle", query_id=entry.query_id,
                                state=mapped, group=entry.group, **attrs)
    return ok


def set_fingerprint(query_id: str, fingerprint: str) -> None:
    """Stamp the plan fingerprint and snapshot the pre-run HBO baseline
    (prediction for progress, baseline for regression)."""
    entry = get(query_id)
    if entry is None:
        return
    entry.fingerprint = fingerprint
    ent = _runstats.lookup(fingerprint, HBO_SITE)
    if ent:
        entry.predicted = dict(ent)


def observe_batch(query_id: str, rows: int) -> None:
    entry = get(query_id)
    if entry is not None:
        entry.observe_batch(rows)


def merge_worker_progress(node_id: str, doc: Dict[str, Any]) -> None:
    """Fold one worker heartbeat ``queryProgress`` doc (keyed by attempt
    query id) into the registry."""
    for attempt_id, stats in (doc or {}).items():
        entry = get(attempt_id)
        if entry is None or not isinstance(stats, dict):
            continue
        with entry._lock:
            entry.worker_progress[(node_id, attempt_id)] = dict(stats)


def slow_log_annotation(query_id: str) -> Optional[Dict[str, Any]]:
    """Extra fields for the slow-query JSONL record (the regression flag;
    the JAX package's result-cache and compile-farm provenance wait for
    ROADMAP items 17 and 12)."""
    entry = get(query_id)
    if entry is None or entry.regression is None:
        return None
    return {"latencyRegression": dict(entry.regression)}


# ---------------------------------------------------------------------------
# progress

def progress_doc(query_id: str,
                 state: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The ``GET /v1/query/{id}/progress`` document, or None when the
    query never registered (lifecycle off / unknown id)."""
    entry = get(query_id)
    if entry is None:
        return None
    terminal = entry.timeline.terminal
    segments = entry.timeline.segments()
    w_rows, w_batches = entry.worker_rows()
    frag_frac, fdone, ftotal = entry.fragment_fraction()
    with entry._lock:
        root_rows, root_batches = entry.rows, entry.batches
        predicted = dict(entry.predicted) if entry.predicted else None
        waves = entry.replay_waves
    provenance = "fragments"
    fraction = min(frag_frac, 0.95)
    if predicted:
        provenance = "hbo"
        estimates = [fraction]
        p_rows = float(predicted.get("rows", 0) or 0)
        if p_rows > 0:
            estimates.append(root_rows / p_rows)
        p_sink = float(predicted.get("sink_rows", 0) or 0)
        if p_sink > 0 and w_rows:
            estimates.append(w_rows / p_sink)
        p_wall = float(predicted.get("wall_s", 0) or 0)
        if p_wall > 0:
            estimates.append(segments["e2e"] / p_wall)
        fraction = min(0.99, max(estimates))
    elif terminal is not None:
        provenance = "terminal"
    if terminal is not None:
        fraction = 1.0
    with entry._lock:
        entry._max_fraction = max(entry._max_fraction, fraction)
        fraction = entry._max_fraction
    doc: Dict[str, Any] = {
        "queryId": entry.query_id,
        "state": state or (terminal or "running"),
        "fraction": round(fraction, 6),
        "provenance": provenance,
        "elapsedS": round(segments["e2e"], 6),
        "segments": {k: round(v, 6) for k, v in segments.items()},
        "rows": root_rows,
        "batches": root_batches,
        "workerRows": w_rows,
        "workerBatches": w_batches,
        "fragments": {"done": fdone, "total": ftotal},
        "replayWaves": waves,
        "group": entry.group,
        "traceToken": entry.query_id,
    }
    if predicted:
        doc["predicted"] = {
            "rows": predicted.get("rows"),
            "sinkRows": predicted.get("sink_rows"),
            "wallS": predicted.get("wall_s"),
        }
    return doc


# ---------------------------------------------------------------------------
# completion

def complete(info, spans: Optional[list] = None) -> None:
    """Terminal-state hook (runs first in the queryCompleted listener
    chain): observes SLO histograms, checks objectives, flags latency
    regressions against the pre-run HBO baseline, derives memory/replay
    events from the query's trace spans, and records the completed
    profile back into HBO for the next run's prediction.
    """
    entry = get(info.query_id)
    if entry is None:
        return
    segments = entry.timeline.segments()
    group = entry.group
    state = entry.timeline.terminal or str(
        getattr(info, "state", "")).lower()

    for seg, hist in _SEGMENT_HISTOGRAMS.items():
        hist.observe(segments[seg], plane="coordinator", group=group)

    for seg, limit in entry.objectives.items():
        actual = segments.get(seg)
        if actual is not None and actual > limit:
            with _counter_lock:
                key = (group, seg)
                _slo_violations[key] = _slo_violations.get(key, 0) + 1
            _obs_events.EVENTS.emit(
                "slo_violation", query_id=entry.query_id, group=group,
                segment=seg, limitS=limit, actualS=round(actual, 6))

    if spans:
        _span_events(entry, spans)

    if state == "finished" and entry.fingerprint:
        baseline = _runstats.lookup(entry.fingerprint, HBO_SITE)
        wall = segments["e2e"]
        factor = entry.regression_factor
        base_wall = float((baseline or {}).get("wall_s", 0) or 0)
        if factor > 0 and base_wall > 0 and wall >= factor * base_wall:
            seg_attr = _attribute_regression(group, segments)
            entry.regression = {
                "wallS": round(wall, 6),
                "baselineWallS": round(base_wall, 6),
                "factor": factor,
                "fingerprint": entry.fingerprint,
                "segment": seg_attr,
            }
            with _counter_lock:
                key = (group, seg_attr)
                _latency_regressions[key] = (
                    _latency_regressions.get(key, 0) + 1)
            _obs_events.EVENTS.emit(
                "latency_regression", query_id=entry.query_id, group=group,
                **entry.regression)
        w_rows, _ = entry.worker_rows()
        _runstats.note(entry.fingerprint, HBO_SITE,
                       wall_s=wall, rows=entry.rows, sink_rows=w_rows)
    if state == "finished":
        # fold AFTER the regression check: baselines are means over prior
        # completions, never contaminated by the run being judged
        with _counter_lock:
            for seg in _REGRESSION_SEGMENTS:
                s, n = _segment_baselines.get((group, seg), (0.0, 0))
                _segment_baselines[(group, seg)] = (
                    s + float(segments.get(seg, 0.0) or 0.0), n + 1)


def _attribute_regression(group: str, segments: Dict[str, float]) -> str:
    """Name the lifecycle segment that regressed most vs the group's
    running baseline (largest actual/mean ratio over prior completions).
    Falls back to ``e2e`` when no baseline exists yet — the first slow
    query in a group has nothing to compare segments against."""
    best, best_ratio = "e2e", 0.0
    with _counter_lock:
        for seg in _REGRESSION_SEGMENTS:
            s, n = _segment_baselines.get((group, seg), (0.0, 0))
            if n == 0:
                continue
            mean = s / n
            if mean <= 1e-6:
                continue
            ratio = float(segments.get(seg, 0.0) or 0.0) / mean
            if ratio > best_ratio:
                best, best_ratio = seg, ratio
    return best


def _span_events(entry: QueryLifecycle, spans: list) -> None:
    """Unify memory revokes/kills and overflow-replay waves (already
    traced as spans) into the cluster event stream."""
    waves = 0
    for sp in spans:
        kind = getattr(sp, "kind", None)
        attrs = dict(getattr(sp, "attrs", {}) or {})
        if kind == "overflow_replay":
            waves += 1
            _obs_events.EVENTS.emit(
                "overflow_replay", query_id=entry.query_id,
                group=entry.group, site=getattr(sp, "name", ""), **attrs)
        elif kind == "memory_revoke":
            _obs_events.EVENTS.emit(
                "memory_revoke", query_id=entry.query_id,
                group=entry.group, **attrs)
        elif kind == "memory_kill":
            _obs_events.EVENTS.emit(
                "memory_kill", query_id=entry.query_id,
                group=entry.group, **attrs)
    if waves:
        with entry._lock:
            entry.replay_waves += waves


# ---------------------------------------------------------------------------

def reset() -> None:
    """Test hook: drop all entries, counters, samples, and disarm."""
    global _armed
    with _lock:
        _entries.clear()
        _aliases.clear()
    with _counter_lock:
        _slo_violations.clear()
        _latency_regressions.clear()
        _segment_baselines.clear()
        _armed = False
    for h in SLO_HISTOGRAMS:
        h.reset()
