"""Lazy column materialization — the selective reader core.

Reference: OrcSelectiveRecordReader's two-phase read: filter columns
decode first, each filter shrinks a row-index selection vector
(positions surviving so far), and payload columns decode only for
surviving rows. A batch whose selection vector empties never touches its
payload columns at all — for wide tables behind selective predicates
that is most of the IO and ALL of the host→device transfer.

The connector supplies `decode(columns_tuple) -> ({name: (values,
validity, hi)}, n)` over its host-decode cache; this module owns the
cascade, the gather, and the Batch assembly on the caller's device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, round_up_capacity
from presto_tpu_torch.obs import trace as _obs_trace
from presto_tpu_torch.scan.adaptive import AdaptiveFilterOrder
from presto_tpu_torch.scan.filters import ValueFilter


def _bytes_per_row(handle, columns: Sequence[str]) -> int:
    total = 0
    for c in columns:
        try:
            total += np.dtype(handle.column(c).type.dtype).itemsize
        except (KeyError, TypeError):
            continue
    return total


def host_batch(columns: Sequence[str], types, planes, n: int, cap: int,
               dicts: dict, device: torch.device) -> Batch:
    """One Batch of capacity `cap` on `device` from host planes: `planes`
    maps a column to its (values, validity | None, hi | None) of n rows."""
    cols = []
    for name, st in zip(columns, types):
        arr, valid, hi = planes[name]
        buf = np.zeros(cap, dtype=st.dtype)
        buf[:n] = arr[:n]
        vcol = hcol = None
        if valid is not None:
            vb = np.zeros(cap, bool)
            vb[:n] = valid[:n]
            vcol = torch.from_numpy(vb).to(device)
        if hi is not None:
            hb = np.zeros(cap, np.int64)
            hb[:n] = hi[:n]
            hcol = torch.from_numpy(hb).to(device)
        cols.append(Column(torch.from_numpy(buf).to(device), vcol, hcol))
    live = np.zeros(cap, bool)
    live[:n] = True
    return Batch(list(columns), list(types), cols,
                 torch.from_numpy(live).to(device),
                 {c: dicts[c] for c in columns if c in dicts})


def selective_read(
    decode: Callable,
    handle,
    columns: Sequence[str],
    filters: Dict[str, ValueFilter],
    device: torch.device,
    capacity: Optional[int] = None,
    dicts: Optional[dict] = None,
    adaptive: Optional[AdaptiveFilterOrder] = None,
    counters: Optional[Callable[[str, int], None]] = None,
) -> Batch:
    """Read one split selectively. `filters` may constrain columns outside
    the projection (a pruned-away predicate column still filters — that is
    pushdown, not a schema change); the returned Batch carries exactly
    `columns`, sized to the survivor count, not the split."""
    tracer = _obs_trace.current()
    cascade_w0 = time.time() if tracer.enabled else 0.0
    filter_cols = list(filters)
    order = adaptive.order(filter_cols) if adaptive is not None else filter_cols
    decoded_f, n = decode(tuple(filter_cols))
    sel = np.arange(n)
    for col in order:
        if not len(sel):
            break
        arr, valid, _ = decoded_f[col]
        t0 = time.perf_counter()
        mask = filters[col].test(
            arr[sel], valid[sel] if valid is not None else None)
        rows_in = len(sel)
        sel = sel[mask]
        if adaptive is not None:
            adaptive.update(col, rows_in, len(sel),
                            time.perf_counter() - t0)
    m = len(sel)
    if tracer.enabled:
        # filter-decode + cascade wall, before any payload materializes
        tracer.record("scan_filter_cascade", "host_decode", cascade_w0,
                      time.time(), table=getattr(handle, "name", "?"),
                      rows_in=int(n), rows_out=int(m))
    if counters is not None and n > m:
        counters("rows_predecode_filtered", n - m)
        counters("bytes_skipped", (n - m) * _bytes_per_row(handle, columns))
    payload = [c for c in columns if c not in decoded_f]
    decoded_p: dict = {}
    if m and payload:
        decoded_p, n2 = decode(tuple(payload))
        if n2 != n:
            raise RuntimeError(
                f"selective read of {handle.name}: payload decode returned "
                f"{n2} rows, filter decode returned {n}")
    cap = round_up_capacity(max(m, 1))
    if capacity is not None:
        cap = min(cap, capacity)
    types = [handle.column(c).type for c in columns]
    planes = {}
    for name, st in zip(columns, types):
        got = decoded_f.get(name) or decoded_p.get(name)
        if got is None:
            # fully-filtered split: payload never decoded — correct-schema
            # all-dead planes
            planes[name] = (np.zeros(0, st.dtype), None, None)
            continue
        arr, valid, hi = got
        planes[name] = (arr[sel], None if valid is None else valid[sel],
                        None if hi is None else hi[sel])
    return host_batch(columns, types, planes, m, cap, dicts or {}, device)
