"""Stats-based split elimination — skip splits whose min/max can't match.

Reference: presto-orc StripeReader + the hive TupleDomain stripe/row-group
skipping (StatisticsValidation / OrcPredicate). Parquet footers carry
row-group statistics natively (catalog/parquet.py reads them in place);
pyarrow's ORC reader exposes NO per-stripe column statistics, so the ORC
connector persists a sidecar JSON next to each file at write time:

    <table>.orc.stats.json = {
      "version": 1,
      "file_size": <bytes of the .orc file it describes>,
      "num_rows": <total>,
      "stripes": [
        {"num_rows": n,
         "columns": {col: {"min": v, "max": v, "null_count": k,
                           "kind": "date"?}}},   # dates ride ISO strings
        ...]
    }

`file_size` pins the sidecar to the exact file it was computed from — a
rewritten .orc with a stale sidecar silently falls back to unpruned scans
rather than pruning with wrong bounds. Values are in the STORAGE domain
(what `_constraints_to_storage` produces): dates as datetime.date,
strings as str, numerics as python numbers.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Dict, List, Optional, Tuple

SIDECAR_VERSION = 1


@dataclasses.dataclass
class SplitStats:
    """Min/max/null-count per column for one split, storage-domain values.
    `columns` maps name -> (min, max, null_count); min/max None = unknown
    (all-NULL stripe, or a type the stats writer skips)."""

    num_rows: int
    columns: Dict[str, Tuple[object, object, Optional[int]]]


def split_prunable(stats: SplitStats,
                   min_max: Dict[str, Tuple[object, object]]) -> bool:
    """True when the split provably contains no row matching the
    constraints. Unknown stats and cross-type comparisons keep the split
    (pruning must stay conservative)."""
    for col, (lo, hi) in min_max.items():
        ent = stats.columns.get(col)
        if ent is None:
            continue
        mn, mx, _ = ent
        try:
            if lo is not None and mx is not None and mx < lo:
                return True
            if hi is not None and mn is not None and mn > hi:
                return True
        except TypeError:
            continue  # constraint/stat domain mismatch — keep the split
    return False


# -- ORC stripe-stats sidecar ----------------------------------------------


def sidecar_path(orc_path: str) -> str:
    return orc_path + ".stats.json"


def _stat_value(scalar):
    """Arrow scalar → (json value, kind tag) or (None, None) if the type
    has no sane JSON/storage-domain representation."""
    v = scalar.as_py() if hasattr(scalar, "as_py") else scalar
    if v is None:
        return None, None
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return v.isoformat(), "date"
    if isinstance(v, bool) or isinstance(v, (int, float, str)):
        return v, None
    return None, None


def write_orc_sidecar(orc_path: str) -> Optional[str]:
    """Compute per-stripe column stats by re-reading the just-written file
    (one extra pass at CTAS time buys stats pyarrow won't surface).
    Returns the sidecar path, or None when nothing useful was written."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.orc as po

    f = po.ORCFile(orc_path)
    stripes = []
    for s in range(f.nstripes):
        tbl = f.read_stripe(s)
        if not isinstance(tbl, pa.Table):
            tbl = pa.Table.from_batches([tbl])
        cols: Dict[str, dict] = {}
        for name in tbl.column_names:
            arr = tbl.column(name)
            try:
                mm = pc.min_max(arr)
                mn, kind_a = _stat_value(mm["min"])
                mx, kind_b = _stat_value(mm["max"])
            except pa.ArrowNotImplementedError:
                continue
            ent = {"null_count": int(arr.null_count)}
            if mn is not None:
                ent["min"] = mn
            if mx is not None:
                ent["max"] = mx
            kind = kind_a or kind_b
            if kind:
                ent["kind"] = kind
            cols[name] = ent
        stripes.append({"num_rows": int(tbl.num_rows), "columns": cols})
    doc = {"version": SIDECAR_VERSION,
           "file_size": os.stat(orc_path).st_size,
           "num_rows": int(f.nrows),
           "stripes": stripes}
    path = sidecar_path(orc_path)
    tmp = path + ".tmp"
    with open(tmp, "w") as out:
        json.dump(doc, out)
    os.replace(tmp, path)
    return path


def load_orc_sidecar(orc_path: str) -> Optional[List[SplitStats]]:
    """Per-stripe SplitStats, or None when the sidecar is absent, stale
    (file_size mismatch — the .orc was rewritten without it), or from an
    incompatible version."""
    path = sidecar_path(orc_path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("version") != SIDECAR_VERSION:
        return None
    try:
        if doc.get("file_size") != os.stat(orc_path).st_size:
            return None
    except OSError:
        return None
    out = []
    for st in doc.get("stripes", []):
        cols = {}
        for name, ent in (st.get("columns") or {}).items():
            mn, mx = ent.get("min"), ent.get("max")
            if ent.get("kind") == "date":
                mn = datetime.date.fromisoformat(mn) if mn is not None else None
                mx = datetime.date.fromisoformat(mx) if mx is not None else None
            cols[name] = (mn, mx, ent.get("null_count"))
        out.append(SplitStats(int(st.get("num_rows", 0)), cols))
    return out
