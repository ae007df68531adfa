"""Query-lifecycle span tracing.

Analog of airlift's trace-token propagation + the reference's per-operator
OperatorStats tree: the coordinator mints one trace per query, every
coordinator↔worker HTTP call carries the token in the `X-Presto-Tpu-Trace`
header, and each worker records its task's spans locally. After the result
stream completes the coordinator pulls every task's span dump and stitches
one query → stage → task → operator tree, served at
`/v1/query/{id}/trace`.

Span kinds are the JAX package's. The port records query, stage, task,
operator, host_decode (also the selective read's scan_filter_cascade),
device_transfer, exchange_wait, breaker_engine, overflow_replay,
spill_repartition, spill_revoke, radix_spill_replay, multiway_cascade and
hbm_sample; compile, lane_pack, mesh_program and fragment_step wait for
the program cache and the mesh (ROADMAP items 12 and 13b), memory_revoke
and memory_kill for the cluster memory manager (item 17). An operator
span's wall is host time: on the card, the time to enqueue its kernels.

Span kinds:
  query            the coordinator-side root (covers plan + execute + merge)
  stage            synthesized per fragment (envelope of its task spans)
  task             one worker task execution
  operator         one plan node's aggregate batch-production wall
  compile          one XLA compile event inside a jitted program
  host_decode      one split's host-side decode (incl. selective cascade)
  device_transfer  host→device upload + readiness of one split's batch
  exchange_wait    time a consumer spent blocked on a pull exchange; on
                   the mesh path, one per fused-collective exchange site
                   with lane occupancy attrs (fid/bytes/lanes_used/util)
  lane_pack        zero-width marker describing a mesh exchange's packed
                   lane layout (dtype buckets, collectives, payload bytes)
  mesh_program     wall time of one fused mesh device program dispatch
                   (covers every exchange + breaker inside the shard_map)
  breaker_engine   zero-width marker: the CBO's hash-vs-sort verdict for
                   one breaker (attrs carry engine + why, incl. HBO
                   provenance)
  overflow_replay  zero-width marker: one capacity-regrow / fanout-widen
                   replay wave a breaker executed (the runtime cost of
                   estimate error; obs/runstats drives it to zero)
  memory_revoke    one memory-pressure event: a pool reserve() crossed
                   the revoke threshold and drove revokers toward the
                   target (attrs: reserved before/after, request, limit)
  memory_kill      zero-width marker on the victim query's trace: the
                   cluster low-memory killer failed it with
                   CLUSTER_OUT_OF_MEMORY (attrs point at the forensics
                   snapshot dumped by server/cluster_memory.py)
  hbm_sample       zero-width device memory watermark sample at a span
                   boundary (obs/devprof.py; attrs carry bytes_in_use /
                   peak or an honest available=false reason on CPU)

Everything is allocation-light: tracing disabled means every call site
talks to the module NOOP singleton (`enabled=False` short-circuits before
any work), so `ExecConfig.tracing=False` costs one attribute check.

Correlation with the serving-plane telemetry (obs/lifecycle.py): the
trace id IS the serving query id, so every record on the cluster event
stream (`/v1/events`) carries it as `traceToken` — a lifecycle
transition, admission rejection, SLO violation, or latency-regression
flag joins back to this span tree by token equality. obs/lifecycle's
`complete()` also walks the finished tree's span kinds
(overflow_replay / memory_revoke / memory_kill) to republish those
incidents on the event stream with the same token.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

# header carried on every coordinator↔worker HTTP call; value is
# "{trace_id}:{parent_span_id}" (parent = the coordinator's root span)
TRACE_HEADER = "X-Presto-Tpu-Trace"

_span_seq = itertools.count(1)
_trace_seq = itertools.count(1)
_PID = f"{os.getpid() & 0xFFFF:04x}"


def _new_span_id() -> str:
    return f"{_PID}-{next(_span_seq):x}"


def new_trace_id() -> str:
    return f"trace_{_PID}_{next(_trace_seq)}"


def format_token(trace_id: str, parent_span_id: Optional[str]) -> str:
    return f"{trace_id}:{parent_span_id or ''}"


def parse_token(token: str) -> Tuple[str, Optional[str]]:
    trace_id, _, parent = token.partition(":")
    return trace_id, (parent or None)


class Span:
    """One timed event. `end is None` means still open (never serialized
    that way by Tracer — spans are appended on close)."""

    __slots__ = ("span_id", "parent_id", "name", "kind", "start", "end",
                 "attrs")

    def __init__(self, span_id: str, parent_id: Optional[str], name: str,
                 kind: str, start: float, end: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.start = start
        self.end = end
        self.attrs = attrs

    @property
    def duration_s(self) -> float:
        return max(0.0, (self.end if self.end is not None else self.start)
                   - self.start)

    def to_dict(self) -> dict:
        d = {"spanId": self.span_id, "parentId": self.parent_id,
             "name": self.name, "kind": self.kind,
             "start": self.start, "end": self.end,
             "durationS": round(self.duration_s, 6)}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    span_id = None
    parent_id = None
    name = kind = ""
    start = end = 0.0
    duration_s = 0.0
    attrs = None


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Thread-safe span sink for one trace. A per-thread span stack gives
    `span()` contexts their default parent; threads that never opened a
    span (prefetch producers, exchange pullers) parent to the trace root."""

    enabled = True

    def __init__(self, trace_id: Optional[str] = None, max_spans: int = 8192):
        self.trace_id = trace_id or new_trace_id()
        self.max_spans = max_spans
        self.root_id: Optional[str] = None
        self.dropped = 0
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_parent(self) -> Optional[str]:
        st = self._stack()
        return st[-1] if st else self.root_id

    @contextlib.contextmanager
    def span(self, name: str, kind: str, parent_id: Optional[str] = None,
             **attrs):
        sid = _new_span_id()
        st = self._stack()
        pid = parent_id if parent_id is not None else (
            st[-1] if st else self.root_id)
        if self.root_id is None:
            self.root_id = sid
        sp = Span(sid, pid, name, kind, time.time(), None, attrs or None)
        st.append(sid)
        try:
            yield sp
        finally:
            st.pop()
            sp.end = time.time()
            self._add(sp)

    def record(self, name: str, kind: str, start: float, end: float,
               parent_id: Optional[str] = None, **attrs) -> Span:
        """Append an already-completed span (no stack interaction beyond
        default parenting)."""
        pid = parent_id if parent_id is not None else self.current_parent()
        sp = Span(_new_span_id(), pid, name, kind, start, end, attrs or None)
        self._add(sp)
        return sp

    def _add(self, sp: Span):
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(sp)

    def absorb(self, span_dicts: List[dict],
               parent_map: Optional[Dict[str, str]] = None):
        """Adopt spans serialized by another tracer (a worker task's dump).
        `parent_map` re-parents specific spans by their own span id —
        the coordinator uses it to hang task roots under synthesized
        stage spans."""
        for d in span_dicts or []:
            pid = d.get("parentId")
            sid = d.get("spanId") or _new_span_id()
            if parent_map and sid in parent_map:
                pid = parent_map[sid]
            self._add(Span(sid, pid, d.get("name") or "?",
                           d.get("kind") or "?",
                           float(d.get("start") or 0.0), d.get("end"),
                           d.get("attrs")))

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def token(self, parent_id: Optional[str] = None) -> str:
        return format_token(self.trace_id,
                            parent_id if parent_id is not None
                            else self.current_parent())

    def to_json(self) -> dict:
        spans = self.spans()
        return {
            "traceId": self.trace_id,
            "rootSpanId": self.root_id,
            "dropped": self.dropped,
            "spans": [s.to_dict() for s in spans],
            "tree": build_tree(spans),
        }


class NoopTracer:
    """`enabled=False` lets hot paths skip instrumentation entirely; the
    methods still exist so cold call sites need no branches."""

    enabled = False
    trace_id = ""
    root_id = None
    dropped = 0

    @contextlib.contextmanager
    def span(self, name, kind, parent_id=None, **attrs):
        yield _NOOP_SPAN

    def record(self, name, kind, start, end, parent_id=None, **attrs):
        return _NOOP_SPAN

    def absorb(self, span_dicts, parent_map=None):
        pass

    def current_parent(self):
        return None

    def spans(self):
        return []

    def token(self, parent_id=None):
        return ""

    def to_json(self):
        return {"traceId": "", "rootSpanId": None, "dropped": 0,
                "spans": [], "tree": []}


NOOP = NoopTracer()

# thread-local "current tracer" — lets deeply-buried code (jit compile
# detection, the selective-scan cascade) record spans without threading a
# tracer through every signature
_current = threading.local()


def current():
    return getattr(_current, "tracer", None) or NOOP


@contextlib.contextmanager
def use(tracer):
    prev = getattr(_current, "tracer", None)
    _current.tracer = tracer
    try:
        yield tracer
    finally:
        _current.tracer = prev


def build_tree(spans: List[Span]) -> List[dict]:
    """Nest spans by parent id; spans whose parent is unknown (foreign
    coordinator ids inside a worker dump, or None) become roots. Children
    sort by start time."""
    dicts = [s.to_dict() for s in spans]
    by_id = {d["spanId"]: d for d in dicts}
    roots: List[dict] = []
    for d in dicts:
        d.setdefault("children", [])
    for d in dicts:
        parent = by_id.get(d.get("parentId"))
        if parent is not None and parent is not d:
            parent["children"].append(d)
        else:
            roots.append(d)
    for d in dicts:
        d["children"].sort(key=lambda c: c["start"])
    roots.sort(key=lambda c: c["start"])
    return roots


class TraceRegistry:
    """Bounded query-id → Tracer map on the coordinator. Aliases let the
    session-level query id (what /v1/query serves) and the scheduler's
    internal per-attempt id (what task ids embed) resolve to one trace."""

    def __init__(self, max_traces: int = 200):
        self.max_traces = max_traces
        self._by_id: "OrderedDict[str, Tracer]" = OrderedDict()
        self._alias: Dict[str, str] = {}
        self._lock = threading.Lock()

    def register(self, tracer: Tracer, *aliases: str) -> None:
        with self._lock:
            self._by_id[tracer.trace_id] = tracer
            for a in aliases:
                self._alias[a] = tracer.trace_id
            while len(self._by_id) > self.max_traces:
                old, _ = self._by_id.popitem(last=False)
                self._alias = {a: t for a, t in self._alias.items()
                               if t != old}

    def alias(self, alias_id: str, trace_id: str) -> None:
        with self._lock:
            if trace_id in self._by_id:
                self._alias[alias_id] = trace_id

    def get(self, query_id: str) -> Optional[Tracer]:
        with self._lock:
            t = self._by_id.get(query_id)
            if t is not None:
                return t
            target = self._alias.get(query_id)
            return self._by_id.get(target) if target else None

    def latest(self) -> Optional[Tracer]:
        with self._lock:
            return next(reversed(self._by_id.values()), None) \
                if self._by_id else None
