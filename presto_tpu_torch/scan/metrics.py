"""Process-wide selective-scan counters.

The per-query numbers live in ExecContext.stats (keyed
"scan.<table>.<counter>"); these process totals are what a Prometheus
scraper sees on a long-lived worker or coordinator (`metric_rows`).
Monotonic, thread-safe (scans run on prefetch threads)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

COUNTER_NAMES = ("splits_pruned", "rows_predecode_filtered", "bytes_skipped")

_HELP = {
    "splits_pruned": "splits eliminated by min/max split statistics",
    "rows_predecode_filtered":
        "rows dropped by host value filters before device upload",
    "bytes_skipped":
        "payload bytes never uploaded thanks to predicate-during-decode",
}

_lock = threading.Lock()
_counters: Dict[str, int] = {k: 0 for k in COUNTER_NAMES}


def record(name: str, delta: int) -> None:
    if name not in _counters or delta == 0:
        return
    with _lock:
        _counters[name] += int(delta)


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Test hook — zero the process counters."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def metric_rows(labels: Optional[Dict[str, str]] = None,
                ) -> List[Tuple[str, str, object, Optional[Dict[str, str]],
                                str]]:
    """Rows for server.metrics.render_metrics, always present (0 when the
    selective path never ran) so scrapers see stable families. These are
    process-wide counters: the endpoint labels which plane exposes them,
    or an in-process cluster scraped on both planes double-counts."""
    snap = snapshot()
    return [(f"presto_tpu_scan_{k}_total", _HELP[k], snap[k], labels,
             "counter") for k in COUNTER_NAMES]
