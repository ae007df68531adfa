"""Histogram metric families for the /v1/metrics plane.

The gauges/counters in server/metrics.py are derived on demand from status
structures; latencies need real distributions, so these families accumulate
process-wide with fixed log-spaced buckets (the airlift DistributionStat /
TimeStat analog, rendered as proper Prometheus `histogram` types).

Process-global on purpose: the in-process cluster runs coordinator and
workers in ONE process, so every observation carries a `plane` label and
each endpoint renders ONLY its own plane's series — a scraper reading both
endpoints never double-counts (same discipline as the plane-labeled scan
counters).

The JAX package's compile-trace and compile-farm families belong to its
program cache, which the port does not have yet (ROADMAP item 12).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> List[float]:
    """Fixed log-spaced bucket bounds from lo to >= hi (3 significant
    digits so the rendered `le` values are stable and readable)."""
    out: List[float] = []
    ratio = 10.0 ** (1.0 / per_decade)
    v = float(lo)
    while v < hi * 1.0000001:
        b = float(f"{v:.3g}")
        if not out or b > out[-1]:
            out.append(b)
        v *= ratio
    return out


def _fmt_bound(v: float) -> str:
    s = f"{v:.12g}"
    return s


class Histogram:
    """One metric family; per-labelset cumulative-bucket series."""

    def __init__(self, name: str, help_text: str, buckets: List[float]):
        self.name = name
        self.help_text = help_text
        self.buckets = sorted(buckets)
        self._lock = threading.Lock()
        # labels tuple -> {"counts": per-bucket (+inf last), "sum", "count"}
        self._series: Dict[tuple, dict] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0,
                }
            s["counts"][bisect.bisect_left(self.buckets, value)] += 1
            s["sum"] += float(value)
            s["count"] += 1

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self, plane: Optional[str] = None) -> Dict[tuple, dict]:
        with self._lock:
            out = {}
            for key, s in self._series.items():
                if plane is not None and dict(key).get("plane") != plane:
                    continue
                out[key] = {"counts": list(s["counts"]), "sum": s["sum"],
                            "count": s["count"]}
            return out

    def render(self, plane: Optional[str] = None) -> List[str]:
        """Exposition lines for one plane (declares the family even when it
        has no samples yet, as a zeroed series, so scrapers see stable
        families)."""
        from presto_tpu_torch.server.metrics import _fmt

        series = self.snapshot(plane)
        if not series and plane is not None:
            series = {(("plane", plane),): {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}}
        lines = [f"# HELP {self.name} {self.help_text}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(series):
            s = series[key]
            labels = dict(key)
            cum = 0
            for bound, n in zip(self.buckets, s["counts"]):
                cum += n
                lines.append(_fmt(f"{self.name}_bucket", cum,
                                  {**labels, "le": _fmt_bound(bound)}))
            lines.append(_fmt(f"{self.name}_bucket", s["count"],
                              {**labels, "le": "+Inf"}))
            lines.append(_fmt(f"{self.name}_sum", f"{s['sum']:.9g}", labels))
            lines.append(_fmt(f"{self.name}_count", s["count"], labels))
        return lines


QUERY_LATENCY = Histogram(
    "presto_tpu_query_latency_seconds",
    "end-to-end query wall time (create to terminal state)",
    log_buckets(0.01, 600.0))
TASK_SCHEDULE_DELAY = Histogram(
    "presto_tpu_task_schedule_delay_seconds",
    "delay between task creation on the worker and execution start",
    log_buckets(0.0001, 60.0))
BATCH_KERNEL_WALL = Histogram(
    "presto_tpu_batch_kernel_wall_seconds",
    "wall time producing one operator output batch",
    log_buckets(0.0001, 60.0))
EXCHANGE_WAIT = Histogram(
    "presto_tpu_exchange_wait_seconds",
    "time a consumer spent blocked waiting on a pull-exchange page",
    log_buckets(0.0001, 60.0))
RADIX_PARTITION_ROWS = Histogram(
    "presto_tpu_radix_partition_rows",
    "rows per radix partition at a partitioned breaker (skew shows as a "
    "wide spread)",
    log_buckets(1.0, 1e8))
STATS_DRIFT = Histogram(
    "presto_tpu_stats_drift_ratio",
    "observed/estimated ratio at a stats-driven decision site "
    "(obs/runstats.py; 1.0 = perfect estimate, labeled by operator "
    "class and decision site)",
    log_buckets(0.01, 100.0))
LEDGER_DRIFT = Histogram(
    "presto_tpu_memory_ledger_drift_ratio",
    "device-reported peak bytes over the MemoryPool ledger's "
    "self-reported peak (obs/devprof.py reconciliation; 1.0 = the "
    "accounting matches the hardware, labeled by reconciliation site)",
    log_buckets(0.01, 100.0))
SPILLED_BYTES = Histogram(
    "presto_tpu_spilled_bytes",
    "bytes written to host spill per spilling operator (hybrid hash "
    "join builds/probes and grace-agg partitions, labeled by operator "
    "side; heavy right tails mean partition budgets are mis-sized)",
    log_buckets(1024.0, 1e12))

ALL_HISTOGRAMS: Tuple[Histogram, ...] = (
    QUERY_LATENCY, TASK_SCHEDULE_DELAY, BATCH_KERNEL_WALL, EXCHANGE_WAIT,
    RADIX_PARTITION_ROWS, STATS_DRIFT, LEDGER_DRIFT, SPILLED_BYTES)


def render_histograms(plane: str) -> str:
    """All histogram families for one plane ('coordinator' | 'worker'),
    ready to append to a render_metrics document."""
    lines: List[str] = []
    for h in ALL_HISTOGRAMS:
        lines.extend(h.render(plane))
    return "\n".join(lines) + "\n"


def reset() -> None:
    """Test hook — zero every histogram family."""
    for h in ALL_HISTOGRAMS:
        h.reset()
