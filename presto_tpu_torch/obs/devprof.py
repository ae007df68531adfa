"""Device memory accounting plane (devprof).

Everything the engine knows about memory is self-reported (memory.py
pool reservations). This module is the device-side truth plane:

  * **device memory watermark sampling** — ``torch.cuda.memory_stats``
    (the caching allocator's allocated and reserved bytes, current and
    peak) and ``torch.cuda.mem_get_info`` for the card's total, at query
    boundaries plus a background cadence. A CPU device has no device
    memory to introspect, and says so (``available: false`` with the
    reason); a CUDA device that cannot be read raises;
  * **ledger-vs-device reconciliation** — the sampled device watermark
    against the MemoryPool ledger's own peak, exported as the
    ``presto_tpu_memory_ledger_drift_ratio`` histogram: it catches
    accounting bugs the way the stats-drift histogram catches
    cardinality bugs;
  * **on-demand ``torch.profiler`` captures** — a per-query registry of
    Chrome traces (the ``profile`` session property), surfaced as
    ``profileUri`` next to ``traceUri`` on ``/v1/statement``.

The JAX package also records XLA's per-program cost and memory analysis
here; the port compiles no programs (it runs eagerly), so ``summary()``
reports no programs until a program cache exists (ROADMAP item 12).

The allocator's statistics are process-wide: the watermark is the
high-water of every sample since :func:`activate`, whatever ran, and the
in-process cluster's workers share it. A query's own share is read as a
delta (:func:`begin_query` / :func:`end_query`): the peak reached during
the query over the bytes in use when it started, known only when the
query raised the process peak.

Process-global and strictly opt-in: until :func:`activate` runs (the
``devprof`` ExecConfig field / session property is ``"on"``), every hook
is a single boolean check. The latch is sticky for the process once
requested, and :func:`deactivate` is the test hook that re-arms the
strict no-op contract. The provider behind sampling is pluggable
(:func:`set_provider`) so reconciliation is unit-testable off-device.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from presto_tpu_torch.obs import metrics as _obs_metrics
from presto_tpu_torch.obs import trace as _obs_trace

_LOCK = threading.Lock()
_ACTIVE = False

_counters: Dict[str, int] = {
    # device memory watermark samples taken (cadence + query boundaries)
    "hbm_samples": 0,
    # samples answered with "no device memory introspection here"
    "hbm_unavailable": 0,
    # ledger-vs-device reconciliations performed
    "reconciliations": 0,
}

# device watermark state (high-water across samples since activate/reset)
_hbm: Dict[str, Any] = {
    "available": None,          # None = never sampled, False = no device
    "reason": None,             # why unavailable, honest label
    "platform": None,
    "bytes_in_use": 0,
    "peak_bytes_in_use": 0,
    "bytes_reserved": 0,
    "peak_bytes_reserved": 0,
    "bytes_limit": 0,
}

# query_id -> torch.profiler Chrome trace path (profile session property)
_query_profiles: Dict[str, str] = {}

# pluggable memory_stats source: () -> Optional[dict]; None = default
_provider: Optional[Callable[[], Optional[dict]]] = None
# the device the default provider reads (bound by activate)
_device = None

_sampler_thread: Optional[threading.Thread] = None
_sampler_stop = threading.Event()
_SAMPLE_PERIOD_S = float(os.environ.get("PRESTO_TPU_DEVPROF_SAMPLE_S",
                                        "0.5"))


def active() -> bool:
    """The one check every hot-path hook performs. False = strict no-op."""
    return _ACTIVE


def activate(device=None) -> None:
    """Arm the plane (devprof=on saw a query start) on `device`, the
    device the default provider samples. Sticky for the process; starts
    the background sampler."""
    global _ACTIVE, _device
    with _LOCK:
        if device is not None:
            _device = device
        if _ACTIVE:
            return
        _ACTIVE = True
    _start_sampler()


def deactivate() -> None:
    """Test hook: disarm and stop the sampler so a later devprof=off run
    can assert the strict no-op contract."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = False
    _stop_sampler()


def reset() -> None:
    """Test hook: deactivate and clear all recorded state."""
    global _device
    deactivate()
    with _LOCK:
        _device = None
        _query_profiles.clear()
        for k in _counters:
            _counters[k] = 0
        _hbm.update(available=None, reason=None, platform=None,
                    bytes_in_use=0, peak_bytes_in_use=0, bytes_reserved=0,
                    peak_bytes_reserved=0, bytes_limit=0)


# -- device memory watermark sampling -----------------------------------------


def set_provider(fn: Optional[Callable[[], Optional[dict]]]) -> None:
    """Override the memory_stats source (tests: a fake provider makes
    reconciliation deterministic off-device). None restores the real
    ``torch.cuda`` reader."""
    global _provider
    with _LOCK:
        _provider = fn
        # a new source invalidates the old watermark + availability label
        _hbm.update(available=None, reason=None, bytes_in_use=0,
                    peak_bytes_in_use=0, bytes_reserved=0,
                    peak_bytes_reserved=0, bytes_limit=0)


def _default_provider() -> Optional[dict]:
    """The bound device's allocator statistics, or None for a CPU device
    (no device memory to introspect). On a CUDA device every failure
    raises: the sample never hides the card behind "unavailable"."""
    import torch

    dev = _device
    if dev is None:
        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    dev = torch.device(dev)
    with _LOCK:
        _hbm["platform"] = dev.type
    if dev.type != "cuda":
        return None
    st = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(st["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(st["allocated_bytes.all.peak"]),
            "bytes_reserved": int(st["reserved_bytes.all.current"]),
            "peak_bytes_reserved": int(st["reserved_bytes.all.peak"]),
            "bytes_limit": int(total)}


def _read_stats() -> Tuple[Optional[dict], Optional[str]]:
    prov = _provider
    if prov is None:
        return _default_provider(), None
    try:
        return prov(), None
    except Exception as e:  # an injected source that cannot answer
        return None, f"{type(e).__name__}: {e}"


def sample_hbm(tag: Optional[str] = None) -> Dict[str, Any]:
    """Take one device memory sample, fold it into the watermark, and —
    when a tracer is live and a tag names the boundary — record an
    ``hbm_sample`` span so the sample lands in the query timeline.
    Honest on a CPU device: an ``available: false`` doc with the reason,
    never fabricated zeros."""
    now = time.time()
    stats, err = _read_stats()
    with _LOCK:
        _counters["hbm_samples"] += 1
        if not stats:
            _counters["hbm_unavailable"] += 1
            if _hbm["available"] is None:
                _hbm["available"] = False
                _hbm["reason"] = (err or "a CPU device has no device "
                                  "memory statistics")
        else:
            in_use = int(stats.get("bytes_in_use", 0) or 0)
            peak = int(stats.get("peak_bytes_in_use", in_use) or in_use)
            _hbm["available"] = True
            _hbm["reason"] = None
            _hbm["bytes_in_use"] = in_use
            _hbm["peak_bytes_in_use"] = max(
                int(_hbm["peak_bytes_in_use"]), peak, in_use)
            res = int(stats.get("bytes_reserved", 0) or 0)
            _hbm["bytes_reserved"] = res
            _hbm["peak_bytes_reserved"] = max(
                int(_hbm["peak_bytes_reserved"]),
                int(stats.get("peak_bytes_reserved", res) or res))
            _hbm["bytes_limit"] = int(stats.get(
                "bytes_limit", _hbm["bytes_limit"]) or _hbm["bytes_limit"])
        doc = _hbm_doc_locked()
    if tag is not None:
        tr = _obs_trace.current()
        if tr.enabled:
            tr.record("hbm_sample", "hbm_sample", now, now, tag=tag, **{
                k: v for k, v in doc.items() if v is not None})
    return doc


def _hbm_doc_locked() -> Dict[str, Any]:
    if _hbm["available"]:
        return {"available": True, "platform": _hbm["platform"],
                "bytesInUse": _hbm["bytes_in_use"],
                "peakBytesInUse": _hbm["peak_bytes_in_use"],
                "bytesReserved": _hbm["bytes_reserved"],
                "peakBytesReserved": _hbm["peak_bytes_reserved"],
                "bytesLimit": _hbm["bytes_limit"] or None}
    return {"available": False, "platform": _hbm["platform"],
            "reason": _hbm["reason"] or "never sampled"}


def device_memory_doc() -> Dict[str, Any]:
    """The current device memory document for status/heartbeat payloads
    (worker /v1/status → cluster heartbeat → /v1/memory rollup)."""
    with _LOCK:
        return _hbm_doc_locked()


def begin_query() -> Optional[Dict[str, int]]:
    """Query-start sample (tagged ``query_start``): the raw allocator
    numbers a query's peak delta is read against, or None without
    device statistics."""
    if not _ACTIVE:
        return None
    sample_hbm(tag="query_start")
    stats, _err = _read_stats()
    if not stats:
        return None
    return {"in_use": int(stats.get("bytes_in_use", 0) or 0),
            "peak": int(stats.get("peak_bytes_in_use", 0) or 0)}


def end_query(start: Optional[Dict[str, int]]) -> Optional[int]:
    """Query-end sample (tagged ``query_end``). Returns the query's peak
    delta — the process peak over the bytes in use at query start — when
    the query raised the process peak, else None (its own peak lies below
    an earlier one and the process-wide counter cannot tell it)."""
    if not _ACTIVE:
        return None
    sample_hbm(tag="query_end")
    stats, _err = _read_stats()
    if not stats or start is None:
        return None
    peak = int(stats.get("peak_bytes_in_use", 0) or 0)
    if peak <= start["peak"]:
        return None
    return peak - start["in_use"]


def _start_sampler() -> None:
    global _sampler_thread
    if _SAMPLE_PERIOD_S <= 0:
        return
    _sampler_stop.clear()

    def loop():
        while not _sampler_stop.wait(_SAMPLE_PERIOD_S):
            if not _ACTIVE:
                break
            doc = sample_hbm()
            if not doc.get("available"):
                # no introspection on this device: one honest sample is
                # the whole story, polling it again is pure overhead
                break

    t = threading.Thread(target=loop, daemon=True, name="devprof-hbm")
    with _LOCK:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            return
        _sampler_thread = t
    t.start()


def _stop_sampler() -> None:
    global _sampler_thread
    _sampler_stop.set()
    with _LOCK:
        t, _sampler_thread = _sampler_thread, None
    if t is not None and t is not threading.current_thread():
        t.join(timeout=2.0)


# -- ledger-vs-device reconciliation -----------------------------------------


def reconcile(pool, plane: str = "worker",
              site: str = "query") -> Optional[Dict[str, Any]]:
    """Compare the device watermark against the MemoryPool ledger's
    self-reported peak and feed the drift histogram. Returns the
    reconciliation doc, or None when either side has nothing to say
    (no device introspection, or a ledger that never reserved)."""
    if not _ACTIVE or pool is None:
        return None
    doc = sample_hbm()
    ledger_peak = float(getattr(pool, "peak", 0) or 0)
    if not doc.get("available") or ledger_peak <= 0:
        return None
    device_peak = float(doc.get("peakBytesInUse") or 0)
    if device_peak <= 0:
        return None
    ratio = device_peak / ledger_peak
    with _LOCK:
        _counters["reconciliations"] += 1
    _obs_metrics.LEDGER_DRIFT.observe(ratio, plane=plane, site=site)
    return {"devicePeakBytes": device_peak, "ledgerPeakBytes": ledger_peak,
            "driftRatio": ratio}


# -- per-query torch.profiler captures ---------------------------------------


def register_profile(query_id: str, path: str) -> None:
    with _LOCK:
        _query_profiles[query_id] = path
        # bounded like the trace registry — oldest captures age out
        while len(_query_profiles) > 200:
            _query_profiles.pop(next(iter(_query_profiles)))


def profile_for(query_id: str) -> Optional[str]:
    with _LOCK:
        return _query_profiles.get(query_id)


# -- exposure: summaries, metrics, rollups -----------------------------------


def snapshot() -> Dict[str, Any]:
    with _LOCK:
        return {"active": _ACTIVE, "counters": dict(_counters),
                "hbm": _hbm_doc_locked(), "programs": {}}


def summary(wall_s: Optional[float] = None) -> Dict[str, Any]:
    """The JAX package's roofline rollup over analyzed programs; the port
    has none, so the program totals are zero and only the device
    document carries numbers."""
    with _LOCK:
        hbm = _hbm_doc_locked()
    out: Dict[str, Any] = {
        "programs": 0, "calls": 0,
        "total_flops": 0.0, "total_bytes_accessed": 0.0,
        "arithmetic_intensity": None,
        "peak_program_footprint_bytes": 0.0,
        "device": hbm, "analysis_unavailable": 0,
    }
    if wall_s and wall_s > 0:
        out["achieved_flops_per_s"] = 0.0
        out["achieved_bytes_per_s"] = 0.0
    return out


_HELP = {
    "presto_tpu_devprof_hbm_samples_total":
        "device memory_stats() watermark samples taken",
    "presto_tpu_devprof_hbm_unavailable_total":
        "samples where the device had no memory introspection",
    "presto_tpu_devprof_reconciliations_total":
        "ledger-vs-device peak reconciliations performed",
    "presto_tpu_devprof_hbm_peak_bytes":
        "device-reported peak bytes in use (0 when unavailable)",
}


def metric_rows(labels: Dict[str, str]) -> List[Tuple]:
    """Rows for server.metrics.render_metrics on both /v1/metrics planes.
    Empty until the plane activates — the families appear only once
    devprof=on has run, keeping devprof=off scrapes byte-identical."""
    with _LOCK:
        if not _ACTIVE and not _counters["hbm_samples"]:
            return []
        c = dict(_counters)
        dev = _hbm_doc_locked()
    return [
        ("presto_tpu_devprof_hbm_samples_total",
         _HELP["presto_tpu_devprof_hbm_samples_total"],
         c["hbm_samples"], dict(labels), "counter"),
        ("presto_tpu_devprof_hbm_unavailable_total",
         _HELP["presto_tpu_devprof_hbm_unavailable_total"],
         c["hbm_unavailable"], dict(labels), "counter"),
        ("presto_tpu_devprof_reconciliations_total",
         _HELP["presto_tpu_devprof_reconciliations_total"],
         c["reconciliations"], dict(labels), "counter"),
        ("presto_tpu_devprof_hbm_peak_bytes",
         _HELP["presto_tpu_devprof_hbm_peak_bytes"],
         (dev.get("peakBytesInUse") or 0) if dev.get("available") else 0,
         {**labels, "available": str(bool(dev.get("available"))).lower()},
         "gauge"),
    ]
