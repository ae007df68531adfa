"""Local-file connector — CSV / JSON-lines tables.

Reference: presto-local-file + presto-record-decoder (the csv/json
RowDecoders shared by the kafka/redis connectors). A directory of
<table>.csv / <table>.jsonl / <table>.json files serves as a schema;
decoding happens host-side into engine-native columns (pandas does the
parsing the reference's per-field decoders do), then batches flow
through the device pipeline like any connector's."""

from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, round_up_capacity
from presto_tpu_torch.catalog.memory import (
    DeviceSplitCache,
    MemoryTable,
    _rows_batch,
)
from presto_tpu_torch.connector import Connector, Split, TableHandle
from presto_tpu_torch.scan.pruning import SplitStats

_EXTS = (".csv", ".jsonl", ".json")


class LocalFileConnector(DeviceSplitCache, Connector):
    def __init__(self, directory: str, name: str = "localfile"):
        self.name = name
        self.directory = directory
        self._tables: Dict[str, MemoryTable] = {}
        self._versions: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._init_split_cache()

    def _path(self, name: str) -> Optional[str]:
        for ext in _EXTS:
            p = os.path.join(self.directory, name + ext)
            if os.path.exists(p):
                return p
        return None

    def table_names(self) -> List[str]:
        out = []
        for f in sorted(os.listdir(self.directory)):
            base, ext = os.path.splitext(f)
            if ext in _EXTS:
                out.append(base)
        return out

    def _load(self, name: str) -> MemoryTable:
        import pandas as pd

        path = self._path(name)
        if path is None:
            raise KeyError(f"table not found: {name}")
        st = os.stat(path)
        version = (st.st_mtime_ns, st.st_size)
        with self._lock:
            if self._versions.get(name) == version:
                return self._tables[name]
        if path.endswith(".csv"):
            df = pd.read_csv(path)
        else:
            df = pd.read_json(path, lines=path.endswith(".jsonl"))
        data = {c: df[c].to_numpy() for c in df.columns}
        mt = MemoryTable(name, data)
        with self._lock:
            # the pandas read above runs outside the lock by design;
            # racing loaders store (table, version) as an atomic pair, so
            # a stale pair self-heals on the next version probe
            self._tables[name] = mt
            self._versions[name] = version
        self.invalidate_cache(name)
        return mt

    def get_table(self, name: str) -> TableHandle:
        return self._load(name).handle(self.name)

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        return [Split(handle.name, i, desired) for i in range(desired)]

    def split_stats(self, handle: TableHandle, split: Split):
        """Storage-domain min/max over this split's row range (splits are
        contiguous slices of the parsed file) — constrained scans over
        sorted CSV/JSONL data skip whole slices via the generic
        prune_splits, the same elimination the file formats get from
        footer/sidecar stats."""
        t = self._load(split.table)
        n = next((len(a) for a in t.arrays.values()), 0)
        lo = n * split.part // split.total
        hi = n * (split.part + 1) // split.total
        cols = {}
        for name, arr in t.arrays.items():
            if name in t.struct or t.hi.get(name) is not None:
                continue
            ty = t.types[name]
            sl = arr[lo:hi]
            valid = t.validity.get(name)
            nulls = int((~valid[lo:hi]).sum()) if valid is not None else 0
            if valid is not None:
                sl = sl[valid[lo:hi]]
            if ty.is_string:
                sl = sl[sl >= 0]  # -1 codes are NULLs
            if not len(sl):
                cols[name] = (None, None, nulls)
                continue
            mn, mx = sl.min(), sl.max()
            if ty.is_string:
                d = t.dicts.get(name)
                if d is None:
                    continue
                mn, mx = str(d.values[mn]), str(d.values[mx])
            elif ty.name == "date":
                mn = datetime.date.fromordinal(719163 + int(mn))
                mx = datetime.date.fromordinal(719163 + int(mx))
            else:
                mn, mx = mn.item(), mx.item()
            cols[name] = (mn, mx, nulls)
        return SplitStats(max(hi - lo, 0), cols)

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None) -> Batch:
        t = self._load(split.table)
        n = t.num_rows
        lo = n * split.part // split.total
        hi = n * (split.part + 1) // split.total
        return _rows_batch(t, columns, np.arange(lo, hi), device,
                           capacity or round_up_capacity(max(hi - lo, 1)))
