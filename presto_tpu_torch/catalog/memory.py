"""In-memory connector — tables registered from host arrays / DataFrames.

Analog of presto-memory (the test/demo connector). Tables live on the host
as numpy arrays; a split is read into a Batch on the caller's device and
kept there (the device-resident split cache), so a repeated scan reads
device memory instead of crossing PCIe again. Scalar columns only:
ARRAY/MAP columns come with the structural planes in a later slice.
"""

from __future__ import annotations

import decimal
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, round_up_capacity
from presto_tpu_torch.connector import (
    ColumnInfo,
    ColumnStats,
    Connector,
    Split,
    TableHandle,
)
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import (
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    INTEGER,
    DecimalType,
    Type,
    VARCHAR,
)


def _is_null(v) -> bool:
    """None, pandas' NA scalar, or the float NaN pandas uses for missing
    object values."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return True
    import pandas as pd

    return v is pd.NA


def _null_mask(arr: np.ndarray) -> np.ndarray:
    """The NULLs of an object array, in one vectorized pass: None, NaN and
    pandas' NA (as _is_null), and also NaT."""
    import pandas as pd

    return np.asarray(pd.isna(arr), dtype=bool)


def _infer_type(arr: np.ndarray) -> Type:
    if arr.dtype == np.bool_:
        return BOOLEAN
    if np.issubdtype(arr.dtype, np.integer):
        return BIGINT if arr.dtype.itemsize > 4 else INTEGER
    if np.issubdtype(arr.dtype, np.floating):
        return DOUBLE
    if arr.dtype.kind == "O":
        first = next((v for v in arr if not _is_null(v)), None)
        if isinstance(first, bool):
            return BOOLEAN
        if isinstance(first, (int, np.integer)):
            return BIGINT
        if isinstance(first, (float, np.floating)):
            return DOUBLE
        if isinstance(first, (list, tuple, dict, bytes, bytearray)):
            raise NotImplementedError(
                f"column type of {type(first).__name__} values is not "
                "supported by the port yet")
        return VARCHAR
    if arr.dtype.kind in ("U", "S"):
        return VARCHAR
    if arr.dtype.kind == "M":  # datetime64
        return DATE
    raise TypeError(f"cannot infer SQL type for {arr.dtype}")


class MemoryTable:
    """Host arrays of one table: `arrays` (values; strings as dictionary
    codes), `validity` (bool or None), `hi` (long-decimal high limbs) and
    `dicts`, keyed by column."""

    def __init__(self, name: str, data: Dict[str, np.ndarray],
                 types: Optional[Dict[str, Type]] = None,
                 primary_key: Optional[List[str]] = None):
        self.name = name
        self.types: Dict[str, Type] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        self.validity: Dict[str, Optional[np.ndarray]] = {}
        self.dicts: Dict[str, Dictionary] = {}
        self.hi: Dict[str, Optional[np.ndarray]] = {}
        self.primary_key = primary_key
        n = None
        for col, raw in data.items():
            # pre-encoded string columns: (Dictionary, codes)
            if (isinstance(raw, tuple) and len(raw) == 2
                    and isinstance(raw[0], Dictionary)):
                d, codes = raw
                n = len(codes) if n is None else n
                self.dicts[col] = d
                self.types[col] = VARCHAR
                self.arrays[col] = np.ascontiguousarray(codes.astype(np.int32))
                self.validity[col] = None
                continue
            arr = (np.asarray(raw, dtype=object) if isinstance(raw, list)
                   else np.asarray(raw))
            n = len(arr) if n is None else n
            t = (types or {}).get(col) or _infer_type(arr)
            valid = None
            if arr.dtype == object:
                nulls = _null_mask(arr)
                if nulls.any():
                    valid = ~nulls
                    arr = np.where(nulls, "" if t.is_string else 0, arr)
            if t.is_string:
                if t is not VARCHAR:
                    raise NotImplementedError(
                        f"{t.name} columns are not supported by the port yet")
                d, codes = Dictionary.encode(arr.astype(str))
                if valid is not None:
                    codes = np.where(valid, codes, -1)
                self.dicts[col] = d
                arr = codes
            elif t is DATE and arr.dtype.kind == "M":
                arr = arr.astype("datetime64[D]").astype(np.int64)
            elif isinstance(t, DecimalType):
                if np.issubdtype(arr.dtype, np.floating):
                    arr = np.round(arr.astype(np.float64)
                                   * 10 ** t.scale).astype(np.int64)
                elif arr.dtype == object:
                    arr = np.array(
                        [int(decimal.Decimal(str(v)).scaleb(t.scale)
                             .to_integral_value(
                                 rounding=decimal.ROUND_HALF_UP))
                         for v in arr], dtype=np.int64)
                else:
                    arr = arr.astype(np.int64) * 10 ** t.scale
            self.types[col] = t
            self.arrays[col] = np.ascontiguousarray(arr.astype(t.dtype))
            self.validity[col] = valid
        self.num_rows = n or 0

    def column_stats(self, col: str) -> ColumnStats:
        """NDV / null-fraction / min-max for the CBO, computed as the JAX
        package computes them so both packages' planners decide alike."""
        cache = self.__dict__.setdefault("_stats_cache", {})
        if col in cache:
            return cache[col]
        arr = self.arrays[col]
        valid = self.validity.get(col)
        n = len(arr)
        nf = 0.0 if valid is None else float((~valid).sum()) / max(n, 1)
        if col in self.dicts:
            cs = ColumnStats(ndv=float(len(self.dicts[col])), null_fraction=nf)
        elif n == 0:
            cs = ColumnStats(ndv=0.0, null_fraction=nf)
        else:
            vals = arr if valid is None else arr[valid]
            if len(vals) == 0:
                cs = ColumnStats(ndv=0.0, null_fraction=nf)
            else:
                mn, mx = float(vals.min()), float(vals.max())
                hist = None
                if mx > mn and arr.ndim == 1 and np.issubdtype(
                        arr.dtype, np.number):
                    sample = (vals if len(vals) <= 2_000_000
                              else vals[:: len(vals) // 1_000_000])
                    edges = np.quantile(sample.astype(np.float64),
                                        np.linspace(0.0, 1.0, 33))
                    hist = tuple(float(e) for e in edges)
                if self.primary_key and self.primary_key == [col]:
                    ndv = float(len(vals))
                elif len(vals) <= 2_000_000:
                    ndv = float(len(np.unique(vals)))
                else:
                    samp = vals[:: max(1, len(vals) // 500_000)]
                    sndv = float(len(np.unique(samp)))
                    if sndv > 0.8 * len(samp):
                        ndv = float(len(vals))  # key-like: saturates
                    else:
                        ndv = sndv  # value-domain-like: sample saw it all
                cs = ColumnStats(ndv=ndv, null_fraction=nf,
                                 min_value=mn, max_value=mx,
                                 histogram=hist)
        cache[col] = cs
        return cs

    def handle(self, catalog: str) -> TableHandle:
        return TableHandle(
            catalog=catalog,
            name=self.name,
            columns=[ColumnInfo(c, t, self.dicts.get(c), self.column_stats(c))
                     for c, t in self.types.items()],
            row_count=float(self.num_rows),
            primary_key=self.primary_key,
        )


def batch_bytes(b: Batch) -> int:
    """Device bytes held by a batch's tensors."""
    n = b.live.numel() * b.live.element_size()
    for c in b.columns:
        for t in (c.values, c.validity, c.hi):
            if t is not None:
                n += t.numel() * t.element_size()
    return n


class MemoryConnector(Connector):
    """Tables from host arrays, read into device-resident batches. Split
    reads are cached per (split, columns, capacity, device) in a bounded
    LRU of device bytes; batches are never mutated, so sharing is safe."""

    split_cache_bytes: int = 6 << 30

    def __init__(self, name: str = "memory"):
        self.name = name
        self.tables: Dict[str, MemoryTable] = {}
        self._split_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._split_cache_used = 0
        self._split_cache_lock = threading.Lock()

    def invalidate_cache(self, table: Optional[str] = None):
        with self._split_cache_lock:
            for k in [k for k in self._split_cache
                      if table is None or k[0] == table]:
                _, nbytes = self._split_cache.pop(k)
                self._split_cache_used -= nbytes

    def add_table(self, name: str, data, types=None, primary_key=None):
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            cols = {}
            for c in data.columns:
                s = data[c]
                if pd.api.types.is_extension_array_dtype(s.dtype):
                    # nullable extension dtypes keep NULLs as NULLs
                    cols[c] = s.astype(object).to_numpy()
                else:
                    cols[c] = s.to_numpy()
            data = cols
        self.tables[name] = MemoryTable(name, data, types, primary_key)
        self.invalidate_cache(name)

    def add_generated(self, name: str, data: Dict[str, object],
                      types: Optional[Dict[str, Type]] = None,
                      primary_key: Optional[List[str]] = None):
        """Register a generator-produced table. A column value may be a
        plain array or a ("raw_decimal", DecimalType, unscaled_int_array)
        marker for pre-scaled decimal columns. Column order is preserved."""
        plain, raw = {}, {}
        for col, v in data.items():
            if isinstance(v, tuple) and len(v) == 3 and v[0] == "raw_decimal":
                raw[col] = (v[1], v[2])
            else:
                plain[col] = v
        mt = MemoryTable(name, plain, types, primary_key=primary_key)
        for col, (t, arr) in raw.items():
            mt.types[col] = t
            mt.arrays[col] = arr.astype(np.int64)
            mt.validity[col] = None
            mt.num_rows = max(mt.num_rows, len(arr))
        mt.arrays = {c: mt.arrays[c] for c in data.keys()}
        mt.types = {c: mt.types[c] for c in data.keys()}
        self.tables[name] = mt
        self.invalidate_cache(name)

    def table_names(self):
        return list(self.tables)

    def get_table(self, name: str) -> TableHandle:
        if name not in self.tables:
            raise KeyError(f"table not found: {name}")
        return self.tables[name].handle(self.name)

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        return [Split(handle.name, i, desired) for i in range(desired)]

    def read_split(self, split: Split, columns: Sequence[str],
                   device: torch.device,
                   capacity: Optional[int] = None) -> Batch:
        key = (split.table, split.part, split.total, tuple(columns),
               capacity, str(device))
        with self._split_cache_lock:
            hit = self._split_cache.get(key)
            if hit is not None:
                self._split_cache.move_to_end(key)
                return hit[0]
        b = self._read_split_uncached(split, columns, device, capacity)
        nbytes = batch_bytes(b)
        if nbytes <= self.split_cache_bytes:
            with self._split_cache_lock:
                if key not in self._split_cache:
                    self._split_cache[key] = (b, nbytes)
                    self._split_cache_used += nbytes
                    while self._split_cache_used > self.split_cache_bytes:
                        _, (_, freed) = self._split_cache.popitem(last=False)
                        self._split_cache_used -= freed
        return b

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None) -> Batch:
        t = self.tables[split.table]
        n = t.num_rows
        lo = n * split.part // split.total
        hi = n * (split.part + 1) // split.total
        b = Batch.from_numpy(
            {c: t.arrays[c][lo:hi] for c in columns},
            {c: t.types[c] for c in columns}, device,
            dicts={c: t.dicts[c] for c in columns if c in t.dicts},
            capacity=capacity or round_up_capacity(max(hi - lo, 1)))
        cols = list(b.columns)
        for i, c in enumerate(columns):
            v, h = t.validity[c], t.hi.get(c)
            if v is None and h is None:
                continue
            vcol = hcol = None
            if v is not None:
                pad = np.zeros(b.capacity, dtype=bool)
                pad[: hi - lo] = v[lo:hi]
                vcol = torch.from_numpy(pad).to(device)
            if h is not None:
                hpad = np.zeros(b.capacity, dtype=np.int64)
                hpad[: hi - lo] = h[lo:hi]
                hcol = torch.from_numpy(hpad).to(device)
            cols[i] = Column(cols[i].values, vcol, hcol)
        return Batch(b.names, b.types, cols, b.live, b.dicts)
