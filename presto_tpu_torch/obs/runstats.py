"""Runtime statistics feedback plane (HBO: history-based optimization).

Every stats-driven decision the engine makes — breaker engine choice,
aggregate presize, spill and radix partition counts — runs
on *static* estimates from plan/stats.py. This module closes the loop:
execution sites report what they actually saw (group counts the breakers
already hold, build-side live rows, probe selectivity, scan rows,
overflow-replay waves, spill shapes) keyed on the
structural fingerprint plus a catalog snapshot token, and the planner
consults that history on a repeat of the same structure.

Three exposure paths:

  * drift telemetry: every observation with a usable estimate feeds the
    ``presto_tpu_stats_drift_ratio`` log-bucket histogram (labels:
    plane, op, site) in obs/metrics.py, plus per-site counters for
    observations, corrections applied, and decisions-that-would-flip;
  * EXPLAIN ANALYZE: observing sites stamp ``node._runstats`` which
    plan_to_string renders as ``[est=… actual=… drift=…x]``, and
    history-corrected CBO verdicts carry an ``(hbo: observed)`` suffix;
  * the history store itself: process-wide, and JSONL-persisted under
    ``$PRESTO_TPU_CACHE_DIR/hbo_history_torch.jsonl`` when that umbrella
    cache knob is set (the JAX package's file is ``hbo_history.jsonl``) — one JSON object per line, ``{"fp": fingerprint,
    "site": site, "est": …, "actual": …, "n": …, …extras}``; the file is
    append-only and the last line for a (fp, site) pair wins on load.

Merge policy: ``actual`` and all numeric extras merge with max() — the
consumers are capacity decisions, where the high-water mark is the safe
correction; ``n`` counts observations. The store is behavior-neutral
unless the ``hbo`` session property / ExecConfig field asks for it:
``off`` disables even observation (strict no-op — the pre-HBO engine
bit-for-bit) and ``observe`` (default) records and exposes drift. The
JAX package's ``correct``, which feeds observed values back into the CBO,
waits for ROADMAP item 12 in the port (the session refuses it).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from presto_tpu_torch.obs import metrics as _obs_metrics

_LOCK = threading.Lock()
_loaded = False
# byte offset into the JSONL file this process has loaded through
_load_offset = 0
# (fingerprint, site) -> {"est": float|None, "actual": float, "n": int, ...}
_history: Dict[Tuple[str, str], Dict[str, Any]] = {}
_observations: Dict[str, int] = {}
_would_flip: Dict[str, int] = {}
_corrections: Dict[str, int] = {}
# bumped on every history mutation: consumers that bake corrected values
# into cached state mix this into their cache key
# so a fresh observation invalidates stale capacities
_generation = 0

# the port's own file: neither package loads the other's observations
_HISTORY_FILE = "hbo_history_torch.jsonl"

# TTL / size bounds for the JSONL history (the file is append-only and
# last-line-wins, so it grows without these): entries older than the
# max age are dropped on load, the newest max-entries survive, and a
# badly bloated file (many superseded lines per live entry) is rewritten
# compacted in place. `python -m presto_tpu_torch.obs.runstats --compact`
# forces the rewrite.
_MAX_AGE_S = float(os.environ.get("PRESTO_TPU_HBO_MAX_AGE_S",
                                  30 * 86400))
_MAX_ENTRIES = int(os.environ.get("PRESTO_TPU_HBO_MAX_ENTRIES", 10000))
# rewrite-on-load trigger: superseded lines per live entry
_COMPACT_BLOAT_RATIO = 4


def _flock(path: str, exclusive: bool):
    """Advisory cross-PROCESS lock on ``<path>.lock`` (fcntl.flock).
    _LOCK serializes threads within one process; this serializes the
    file against other engine processes sharing the cache dir. Returns
    an fd to pass to _funlock, or None where fcntl is unavailable
    (non-POSIX) — the in-process lock still holds there."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - POSIX-only container
        return None
    fd = None
    try:
        fd = os.open(path + ".lock", os.O_WRONLY | os.O_CREAT, 0o644)
        fcntl.flock(fd, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
        return fd
    except OSError:
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        return None


def _funlock(fd) -> None:
    if fd is None:
        return
    try:
        os.close(fd)  # closing the fd releases the flock
    except OSError:
        pass


def history_path() -> Optional[str]:
    d = os.environ.get("PRESTO_TPU_CACHE_DIR")
    if not d:
        return None
    return os.path.join(d, _HISTORY_FILE)


def catalog_token(catalog) -> str:
    """Cheap snapshot token for the catalog: connector names, their table
    lists, and per-table row counts. A history entry is only reusable
    while the data it was observed against is unchanged; this token is
    the best effort short of content hashing."""
    parts: List[str] = []
    try:
        for cname in sorted(getattr(catalog, "connectors", {}) or {}):
            if cname.startswith("_"):
                # engine-internal connectors (e.g. the result cache's
                # "_rc" splice tables) are derived state, not user data:
                # their churn must not invalidate history or cache keys
                continue
            conn = catalog.connectors[cname]
            try:
                names = sorted(conn.table_names())
            except Exception:
                names = []
            for t in names:
                rows = None
                try:
                    rows = conn.get_table(t).row_count
                except Exception:
                    pass
                parts.append(f"{cname}.{t}={rows}")
    except Exception:
        pass
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()
    return h[:12]


def node_fingerprint(node, catalog) -> Optional[str]:
    """History key for a plan node: its pure structural sha (the codec's
    canonical JSON, equal to the JAX package's for the same plan) plus
    the catalog snapshot token. Memoized on the node."""
    fp = node.__dict__.get("_hbo_fp")
    if fp is not None:
        return fp or None
    from presto_tpu_torch.plan.codec import structural_fingerprint

    sha = structural_fingerprint(node)
    if sha is None:
        node.__dict__["_hbo_fp"] = ""
        return None
    fp = sha[:24] + "/" + catalog_token(catalog)
    node.__dict__["_hbo_fp"] = fp
    return fp


def _load_locked(max_age_s: Optional[float] = None,
                 max_entries: Optional[int] = None) -> None:
    global _loaded, _load_offset
    if _loaded:
        return
    _loaded = True
    _load_offset = 0
    path = history_path()
    if not path or not os.path.exists(path):
        return
    max_age_s = _MAX_AGE_S if max_age_s is None else max_age_s
    max_entries = _MAX_ENTRIES if max_entries is None else max_entries
    lines = 0
    now = time.time()
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
        # everything up to this offset has been seen (and possibly
        # deliberately TTL/cap-evicted) by THIS process; a compaction
        # rewrite treats only lines past it as foreign-process appends
        _load_offset = len(raw)
        for line in raw.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line:
                continue
            lines += 1
            try:
                rec = json.loads(line)
                fp, site = rec.pop("fp"), rec.pop("site")
            except Exception:
                continue
            # max-age compaction: stale observations (old data
            # distributions) must not correct tomorrow's queries;
            # ts-less records predate the TTL stamp — keep them
            ts = rec.get("ts")
            if max_age_s and isinstance(ts, (int, float)) \
                    and now - float(ts) > max_age_s:
                _history.pop((str(fp), str(site)), None)
                continue
            _history[(str(fp), str(site))] = rec
    except OSError:
        pass
    if max_entries and len(_history) > max_entries:
        # newest (by ts; ts-less sorts oldest) survive the entry cap
        keys = sorted(_history,
                      key=lambda k: float(_history[k].get("ts") or 0.0))
        for k in keys[:len(_history) - max_entries]:
            del _history[k]
    if lines > max(len(_history) * _COMPACT_BLOAT_RATIO, 1024):
        # the append-only file carries far more superseded lines than
        # live entries — rewrite it compacted while we hold the lock
        _rewrite_locked()


def _rewrite_locked() -> None:
    """Rewrite the JSONL file as exactly one line per live entry (atomic
    replace, same discipline as the connectors' atomic writes). Holds
    the exclusive cross-process flock for the whole read-merge-replace:
    appenders (shared flock) are quiesced, and lines appended past this
    process's load offset — foreign-process writes it never saw — are
    merged through rather than dropped by the os.replace. Lines BEFORE
    the offset were loaded (and possibly deliberately TTL/cap-evicted),
    so they are not resurrected."""
    global _load_offset
    path = history_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lk = _flock(path, exclusive=True)
        try:
            tail = b""
            try:
                with open(path, "rb") as fh:
                    fh.seek(_load_offset)
                    tail = fh.read()
            except OSError:
                pass
            foreign: Dict[Tuple[str, str], Dict[str, Any]] = {}
            for line in tail.decode("utf-8", "replace").splitlines():
                try:
                    rec = json.loads(line)
                    key = (str(rec.pop("fp")), str(rec.pop("site")))
                except Exception:
                    continue
                ent = _history.get(key)
                if ent is None:
                    foreign[key] = rec  # last line wins, as on load
                else:
                    # both processes hold the key (this process's own
                    # appends also land past the offset): the shipped
                    # max-merge policy applies, so replaying our own
                    # lines is a no-op and a foreign high-water wins
                    for k, v in rec.items():
                        if isinstance(v, (int, float)) \
                                and not isinstance(v, bool):
                            ent[k] = max(float(ent.get(k) or 0.0),
                                         float(v))
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                for (fp, site), ent in {**foreign, **_history}.items():
                    fh.write(json.dumps({"fp": fp, "site": site, **ent})
                             + "\n")
            os.replace(tmp, path)
            _load_offset = os.path.getsize(path)
        finally:
            _funlock(lk)
    except OSError:
        pass


def _persist_locked(fp: str, site: str, ent: Dict[str, Any]) -> None:
    path = history_path()
    if not path:
        return
    ent["ts"] = round(time.time(), 3)
    # one record = one os.write to an O_APPEND fd: POSIX appends are
    # atomic with respect to the file offset, so concurrent engine
    # processes interleave whole lines, never torn ones. The shared
    # flock additionally fences appends against a concurrent compaction
    # rewrite (whose os.replace would otherwise drop this record).
    data = (json.dumps({"fp": fp, "site": site, **ent}) + "\n").encode()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lk = _flock(path, exclusive=False)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        finally:
            _funlock(lk)
    except OSError:
        pass


def observe(fp: Optional[str], site: str, op: str,
            est: Optional[float], actual: Optional[float],
            extra: Optional[Dict[str, Any]] = None,
            plane: str = "worker") -> Optional[Dict[str, Any]]:
    """Record one estimate-vs-actual observation. Updates the history
    store (max-merge), appends the merged entry to the JSONL file, and
    feeds the drift histogram when the estimate is usable."""
    if fp is None or actual is None:
        return None
    actual = float(actual)
    global _generation
    with _LOCK:
        _load_locked()
        _generation += 1
        key = (fp, site)
        ent = _history.get(key)
        if ent is None:
            ent = {"est": None, "actual": 0.0, "n": 0}
            _history[key] = ent
        if est is not None:
            ent["est"] = float(est)
        ent["actual"] = max(float(ent.get("actual") or 0.0), actual)
        ent["n"] = int(ent.get("n") or 0) + 1
        for k, v in (extra or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                ent[k] = max(float(ent.get(k) or 0.0), float(v))
            else:
                ent[k] = v
        _observations[site] = _observations.get(site, 0) + 1
        _persist_locked(fp, site, ent)
        out = dict(ent)
    if est is not None and est > 0:
        _obs_metrics.STATS_DRIFT.observe(
            actual / float(est), plane=plane, op=op, site=site)
    return out


def note(fp: Optional[str], site: str, **extras: Any) -> None:
    """Merge extras into an existing/new history entry without recording
    a drift observation (no estimate involved — e.g. fanout overflow
    rows discovered mid-probe)."""
    if fp is None or not extras:
        return
    global _generation
    with _LOCK:
        _load_locked()
        _generation += 1
        key = (fp, site)
        ent = _history.setdefault(key, {"est": None, "actual": 0.0, "n": 0})
        for k, v in extras.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                ent[k] = max(float(ent.get(k) or 0.0), float(v))
            else:
                ent[k] = v
        _persist_locked(fp, site, ent)


def generation() -> int:
    """History mutation counter — see the module-state comment."""
    with _LOCK:
        return _generation


def lookup(fp: Optional[str], site: str) -> Optional[Dict[str, Any]]:
    if fp is None:
        return None
    with _LOCK:
        _load_locked()
        ent = _history.get((fp, site))
        return dict(ent) if ent is not None else None


def lookup_node(node, catalog, site: str) -> Optional[Dict[str, Any]]:
    return lookup(node_fingerprint(node, catalog), site)


# Whole-query profile site recorded by obs/lifecycle.py on every FINISHED
# lifecycle-tracked query, keyed on the root plan-node fingerprint. Entries
# carry wall_s / rows / sink_rows (max-merged like every note()d numeric).
QUERY_SITE = "lifecycle/query"


def record_flip(site: str) -> None:
    """A decision site, re-evaluated against freshly observed values,
    would have chosen differently than the static estimate did."""
    with _LOCK:
        _would_flip[site] = _would_flip.get(site, 0) + 1


_HELP = {
    "presto_tpu_hbo_observations_total":
        "runtime estimate-vs-actual observations recorded, by decision site",
    "presto_tpu_hbo_would_flip_total":
        "decisions whose observed values would flip the static choice",
    "presto_tpu_hbo_corrections_total":
        "decisions that used history-observed values instead of estimates",
    "presto_tpu_hbo_history_entries":
        "distinct (fingerprint, site) entries in the HBO history store",
}


def metric_rows(labels: Dict[str, str]) -> List[tuple]:
    """Rows for server.metrics.render_metrics: per-site HBO counters plus
    a history-size gauge."""
    rows: List[tuple] = []
    with _LOCK:
        for name, per_site in (
                ("presto_tpu_hbo_observations_total", _observations),
                ("presto_tpu_hbo_would_flip_total", _would_flip),
                ("presto_tpu_hbo_corrections_total", _corrections)):
            for site in sorted(per_site):
                rows.append((name, _HELP[name], per_site[site],
                             {**labels, "site": site}, "counter"))
        rows.append(("presto_tpu_hbo_history_entries",
                     _HELP["presto_tpu_hbo_history_entries"],
                     len(_history), dict(labels), "gauge"))
    return rows


def snapshot() -> Dict[str, Any]:
    """Test/bench hook: a copy of the full in-memory state."""
    with _LOCK:
        return {
            "history": {f"{fp}|{site}": dict(ent)
                        for (fp, site), ent in _history.items()},
            "observations": dict(_observations),
            "would_flip": dict(_would_flip),
            "corrections": dict(_corrections),
        }


def reset() -> None:
    """Test hook: clear in-memory state and force a lazy reload from the
    JSONL file (if any) on the next lookup/observe."""
    global _loaded, _generation, _load_offset
    with _LOCK:
        _loaded = False
        _load_offset = 0
        _generation += 1
        _history.clear()
        _observations.clear()
        _would_flip.clear()
        _corrections.clear()


def compact(max_age_s: Optional[float] = None,
            max_entries: Optional[int] = None) -> Dict[str, Any]:
    """Force a TTL/size compaction of the JSONL history: reload with the
    given bounds (defaults: the module TTL knobs) and rewrite the file
    as one line per surviving entry. Returns what happened."""
    global _loaded, _generation
    path = history_path()
    lines_before = 0
    if path and os.path.exists(path):
        try:
            with open(path, "r") as fh:
                lines_before = sum(1 for ln in fh if ln.strip())
        except OSError:
            pass
    with _LOCK:
        _history.clear()
        _loaded = False
        _load_locked(max_age_s=max_age_s, max_entries=max_entries)
        _generation += 1
        _rewrite_locked()
        kept = len(_history)
    return {"path": path, "lines_before": lines_before, "entries": kept}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m presto_tpu_torch.obs.runstats --compact`` — operator-facing
    history maintenance (TTL expiry + file rewrite)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.obs.runstats",
        description="HBO history store maintenance "
                    "($PRESTO_TPU_CACHE_DIR/hbo_history_torch.jsonl)")
    ap.add_argument("--compact", action="store_true",
                    help="drop entries past the TTL/size bounds and "
                         "rewrite the JSONL one line per live entry")
    ap.add_argument("--max-age-s", type=float, default=None,
                    help=f"entry TTL in seconds (default {_MAX_AGE_S:g})")
    ap.add_argument("--max-entries", type=int, default=None,
                    help=f"entry cap, newest win (default {_MAX_ENTRIES})")
    args = ap.parse_args(argv)
    if not args.compact:
        ap.print_help()
        return 2
    if history_path() is None:
        print("no history: PRESTO_TPU_CACHE_DIR is not set")
        return 1
    res = compact(max_age_s=args.max_age_s, max_entries=args.max_entries)
    print(f"compacted {res['path']}: {res['lines_before']} lines -> "
          f"{res['entries']} entries")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
