"""Process-wide selective-scan counters.

The per-query numbers live in ExecContext.stats (keyed
"scan.<table>.<counter>"); these are the process totals a long-lived
server would expose. Monotonic, thread-safe (scans run on prefetch
threads)."""

from __future__ import annotations

import threading
from typing import Dict

COUNTER_NAMES = ("splits_pruned", "rows_predecode_filtered", "bytes_skipped")

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
