"""Prometheus-style metrics rendering — the JMX-export analog.

Reference: the reference exposes engine internals over JMX MBeans
(presto-jmx connector + airlift jmx http endpoints); the cloud-native
equivalent is a /v1/metrics text exposition that scrapers ingest
directly. Metrics are derived on demand from the same status structures
the REST introspection serves — no separate collection machinery.

Exposition rules honored here (text format 0.0.4): HELP/TYPE once per
family, label values escaped (backslash, quote, newline), counter
families typed `counter`, and the histogram families from
presto_tpu_torch.obs.metrics appended per plane so the in-process
cluster (coordinator + workers sharing one process) never double-exposes
a series.

The JAX package's program-cache, compile-farm and adaptive rows wait for
ROADMAP item 12, its result-cache rows and web UI for item 17.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.obs import devprof as obs_devprof
from presto_tpu_torch.obs import inflight as obs_inflight
from presto_tpu_torch.obs import lifecycle as obs_lifecycle
from presto_tpu_torch.obs import metrics as obs_metrics
from presto_tpu_torch.obs import runstats as obs_runstats
from presto_tpu_torch.scan import metrics as scan_metrics

_ESCAPES = [("\\", "\\\\"), ('"', '\\"'), ("\n", "\\n")]


def _escape_label(value: object) -> str:
    s = str(value)
    for raw, esc in _ESCAPES:
        s = s.replace(raw, esc)
    return s


def _fmt(name: str, value, labels: Dict[str, str] | None = None) -> str:
    if labels:
        lab = ",".join(f'{k}="{_escape_label(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {value}"
    return f"{name} {value}"


def _row_type(name: str, explicit: Optional[str]) -> str:
    if explicit:
        return explicit
    # Prometheus naming convention: monotonic totals end in _total
    return "counter" if name.endswith("_total") else "gauge"


def render_metrics(rows: List[Tuple]) -> str:
    """rows: (metric_name, help_text, value, labels[, type]). Renders one
    exposition document with # HELP/# TYPE headers emitted once per
    metric family. The optional fifth element names the family type
    ("counter" / "gauge" / ...); absent, `*_total` names render as
    counters and everything else as gauges."""
    seen = set()
    out = []
    for row in rows:
        name, help_text, value, labels = row[0], row[1], row[2], row[3]
        mtype = _row_type(name, row[4] if len(row) > 4 else None)
        if name not in seen:
            seen.add(name)
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {mtype}")
        out.append(_fmt(name, value, labels))
    return "\n".join(out) + "\n"


def worker_metrics(worker) -> str:
    st = worker.status()
    mem = st.get("memory") or {}
    lbl = {"node": st["nodeId"]}
    rows = [
        ("presto_tpu_worker_tasks", "registered tasks", st["tasks"], lbl),
        ("presto_tpu_worker_running_tasks", "running tasks",
         st["runningTasks"], lbl),
        ("presto_tpu_worker_memory_reserved_bytes", "pool reservation",
         mem.get("reservedBytes", 0), lbl),
        ("presto_tpu_worker_memory_limit_bytes", "pool limit",
         mem.get("limitBytes") or 0, lbl),
        ("presto_tpu_worker_spill_in_use_bytes", "live spill-file bytes",
         st["spillInUseBytes"], lbl),
    ]
    # scan, HBO and devprof counters are process-wide; the plane label
    # keeps the worker and coordinator expositions of a shared-process
    # cluster apart (a sum over planes double-counts — filter on one)
    plane = {**lbl, "plane": "worker"}
    rows.extend(scan_metrics.metric_rows(plane))
    rows.extend(obs_runstats.metric_rows(plane))
    rows.extend(obs_devprof.metric_rows(plane))
    return render_metrics(rows) + obs_metrics.render_histograms("worker")


def coordinator_metrics(coordinator) -> str:
    qm = coordinator.query_manager
    states: Dict[str, int] = {}
    for q in qm.queries():
        states[q.state] = states.get(q.state, 0) + 1
    rows = [
        ("presto_tpu_cluster_active_workers", "workers in rotation",
         len(coordinator.node_manager.active_nodes()), None),
        ("presto_tpu_cluster_total_workers", "workers known to discovery",
         len(coordinator.node_manager.nodes), None),
    ]
    for state, count in sorted(states.items()):
        rows.append(("presto_tpu_queries", "queries by state", count,
                     {"state": state}))
    rows.append(("presto_tpu_plan_cache_entries", "cached distributed plans",
                 len(coordinator._dplan_cache), None))
    plane = {"plane": "coordinator"}
    rows.extend(scan_metrics.metric_rows(plane))
    rows.extend(obs_runstats.metric_rows(plane))
    rows.extend(obs_devprof.metric_rows(plane))
    text = render_metrics(rows) + obs_metrics.render_histograms("coordinator")
    # the SLO and inflight families appear only once a query armed their
    # plane: lifecycle=off and inflight=off scrapes stay family-free
    if obs_lifecycle.armed():
        slo_rows = obs_lifecycle.metric_rows(plane)
        text += render_metrics(slo_rows) if slo_rows else ""
        text += obs_lifecycle.render_slo_histograms("coordinator")
    if obs_inflight.armed():
        inf_rows = obs_inflight.metric_rows(plane)
        text += render_metrics(inf_rows) if inf_rows else ""
    return text
