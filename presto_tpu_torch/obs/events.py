"""Query-event listener sinks + the unified cluster event stream.

The QueryManager fires `(event, QueryInfo)` listeners (the EventListener
SPI's QueryCompletedEvent analog). This module's SlowQueryLogger is the
standard sink: a structured JSONL stream of completed queries over a
latency threshold, each record carrying the top-k most expensive spans
inline so a slow query is diagnosable from the log alone — no trace
endpoint round trip.

ClusterEventStream is the serving-plane's unified feed (`GET /v1/events`):
a bounded in-memory ring buffer — lifecycle transitions, admission
rejections, memory revokes/kills, overflow-replay waves, SLO violations,
and latency-regression flags — with an optional JSONL sink. Every record
carries the query's trace token for span correlation.

Both JSONL sinks append with a single `os.write` to an `O_APPEND` fd
under the shared `fcntl` flock from obs.runstats, so multiple server
processes can share one file without torn lines.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from presto_tpu_torch.obs.runstats import _flock, _funlock


def _append_line(path: str, line: str) -> None:
    """Cross-process-safe JSONL append: one `os.write` of the whole
    record to an `O_APPEND` fd while holding the shared flock (the HBO
    compactor takes it exclusively, so appends never interleave with a
    rewrite)."""
    lock_fd = _flock(path, exclusive=False)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, (line + "\n").encode("utf-8"))
        finally:
            os.close(fd)
    finally:
        _funlock(lock_fd)


class SlowQueryLogger:
    """Append one JSONL record per completed query whose wall time crossed
    `threshold_s` (0.0 = log every completion)."""

    def __init__(self, path: str, threshold_s: float = 0.0, top_k: int = 5):
        self.path = path
        self.threshold_s = threshold_s
        self.top_k = top_k
        self._lock = threading.Lock()

    def log(self, info, spans: Optional[list] = None,
            memory: Optional[dict] = None,
            extra: Optional[dict] = None) -> None:
        """`info` is a querymanager.QueryInfo; `spans` the query's trace
        spans (obs.trace.Span), when tracing captured any; `memory` an
        optional devprof-plane doc (per-query peak/footprint bytes +
        device stats) folded into the record; `extra` optional top-level
        annotations (e.g. the lifecycle plane's latency-regression
        flag)."""
        elapsed = max(0.0, (info.end_time or time.time()) - info.create_time)
        if elapsed < self.threshold_s:
            return
        top: List[dict] = []
        engines: List[dict] = []
        lane_util: List[dict] = []
        revokes = 0
        revoked_bytes = 0
        kills: List[dict] = []
        replays = 0
        boosts = 0
        spill_repartitions = 0
        spill_revokes = 0
        spill_reversals = 0
        if spans:
            closed = [s for s in spans if s.end is not None]
            closed.sort(key=lambda s: s.duration_s, reverse=True)
            for s in closed[:self.top_k]:
                d = {"name": s.name, "kind": s.kind,
                     "durationS": round(s.duration_s, 6)}
                if s.attrs:
                    d["attrs"] = s.attrs
                top.append(d)
            # breaker/exchange verdict markers (obs/runstats plane): the
            # CBO choices and replay waves behind a slow query, inline
            for s in spans:
                a = s.attrs or {}
                if s.kind == "breaker_engine":
                    engines.append({"node": a.get("node"),
                                    "engine": a.get("engine"),
                                    "why": a.get("why")})
                elif s.kind == "exchange_wait" and "util" in a:
                    lane_util.append({"fid": a.get("fid"),
                                      "lanesUsed": a.get("lanes_used"),
                                      "lanesTotal": a.get("lanes_total"),
                                      "util": a.get("util")})
                elif s.kind == "overflow_replay":
                    replays += 1
                    if a.get("cap_to"):
                        boosts += 1
                elif s.kind == "memory_revoke":
                    # devprof plane: memory pressure behind a slow query
                    revokes += 1
                    before = a.get("reserved_before") or 0
                    after = a.get("reserved_after") or 0
                    revoked_bytes += max(0, int(before) - int(after))
                elif s.kind == "memory_kill":
                    kills.append({"reason": a.get("reason"),
                                  "forensics": a.get("forensics")})
                elif s.kind == "spill_repartition":
                    # dynamic hybrid hash plane: a slow query that spent
                    # its time splitting skewed spill partitions says so
                    # from the log alone
                    spill_repartitions += 1
                elif s.kind == "spill_revoke":
                    spill_revokes += 1
                elif s.kind == "spill_role_reversal":
                    spill_reversals += 1
        rec = {
            "event": "queryCompleted",
            "ts": time.time(),
            "queryId": info.query_id,
            "state": info.state,
            "user": info.user,
            "sql": info.sql,
            "elapsedS": round(elapsed, 6),
            "error": info.error,
            "topSpans": top,
        }
        if engines:
            rec["breakerEngines"] = engines
        if lane_util:
            rec["laneUtil"] = lane_util
        if replays:
            rec["overflowReplays"] = replays
            rec["overflowBoosts"] = boosts
        if revokes:
            rec["memoryRevokes"] = revokes
            rec["memoryRevokedBytes"] = revoked_bytes
        if kills:
            rec["memoryKills"] = kills
        if spill_repartitions or spill_revokes or spill_reversals:
            rec["spill"] = {"repartitions": spill_repartitions,
                            "revocations": spill_revokes,
                            "roleReversals": spill_reversals}
        if memory:
            # peak/footprint fields from the devprof memory rollup
            rec["memory"] = memory
        if extra:
            rec.update(extra)
        line = json.dumps(rec, default=str)
        with self._lock:
            _append_line(self.path, line)


class ClusterEventStream:
    """Bounded ring buffer of cluster events + optional JSONL sink.

    `emit` is cheap and never raises toward the serving path: sink IO
    errors are swallowed (the in-memory ring still gets the record).
    Sequence numbers are monotonically increasing for the process
    lifetime, so `events(since=seq)` is a stable resume cursor.
    """

    def __init__(self, capacity: int = 2048, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._buf: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=capacity)
        self._seq = 0
        self.path = path

    def configure(self, path: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if path is not None:
                self.path = path
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = collections.deque(self._buf, maxlen=capacity)

    def emit(self, kind: str, query_id: Optional[str] = None,
             **attrs) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"ts": round(time.time(), 6), "kind": kind}
        if query_id is not None:
            rec["queryId"] = query_id
            # trace ids are minted as the serving query id, so the query
            # id doubles as the trace token for span correlation
            rec["traceToken"] = query_id
        rec.update(attrs)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._buf.append(rec)
            path = self.path
        if path:
            try:
                _append_line(path, json.dumps(rec, default=str))
            except OSError:
                pass
        return rec

    def events(self, since: int = 0, query_id: Optional[str] = None,
               kind: Optional[str] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
        """Events with seq > ``since``, oldest first, at most ``limit`` —
        a full page means more may follow, so advancing ``since`` to the
        page's last seq never skips events the ring still holds."""
        with self._lock:
            out = [dict(r) for r in self._buf if r["seq"] > since]
        if query_id is not None:
            out = [r for r in out if r.get("queryId") == query_id]
        if kind is not None:
            out = [r for r in out if r.get("kind") == kind]
        return out[:limit]

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        """Test hook: drop buffered events (seq keeps counting)."""
        with self._lock:
            self._buf.clear()


#: process-global stream — one serving plane per process; the coordinator
#: configures the JSONL sink at construction when `events_log=` is set
EVENTS = ClusterEventStream()
