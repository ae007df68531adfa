"""In-memory connector — tables registered from host arrays / DataFrames.

Analog of presto-memory (the test/demo connector). Tables live on the host
as numpy arrays; a split is read into a Batch on the caller's device and
kept there (the device-resident split cache), so a repeated scan reads
device memory instead of crossing PCIe again. CREATE TABLE [AS], INSERT,
DELETE's rewrite, TRUNCATE and DROP write the host table and drop its
cached splits. Scalar columns only (varchar, varbinary, ipaddress and
ipprefix as dictionary codes): ARRAY/MAP columns come with the structural
planes in a later slice.
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
    VARBINARY,
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
    """The NULLs of an object array by _is_null's rule: pd.isna finds the
    candidates in one vectorized pass, and of those only None, pandas' NA
    and a Python float NaN are NULL (a float32 NaN, NaT or Decimal('NaN')
    is a value, as in the JAX package)."""
    import pandas as pd

    out = np.asarray(pd.isna(arr), dtype=bool)
    for i in np.flatnonzero(out):
        out[i] = _is_null(arr[i])
    return out


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
        if isinstance(first, (bytes, bytearray)):
            return VARBINARY
        if isinstance(first, (list, tuple, dict)):
            raise NotImplementedError(
                f"column type of {type(first).__name__} values is not "
                "supported by the port yet")
        return VARCHAR
    if arr.dtype.kind in ("U", "S"):
        return VARCHAR
    if arr.dtype.kind == "M":  # datetime64
        return DATE
    raise TypeError(f"cannot infer SQL type for {arr.dtype}")


def _canonical_ip(v, type_name: str) -> str:
    """An IPADDRESS or IPPREFIX value (text, or its canonical bytes) as
    its canonical dictionary entry; a NULL slot stays ""."""
    from presto_tpu_torch.expr import ip as _ip

    if v == "":
        return ""
    prefix = type_name == "ipprefix"
    if isinstance(v, (bytes, bytearray)):
        e = v.decode("latin-1")
        if prefix:
            # only the 17-byte canonical form: 16 address bytes carry no
            # prefix length
            s = e if _ip.format_prefix(e) else None
        else:
            s = _ip.address_from_bytes(e)
    elif prefix:
        s = _ip.parse_prefix(str(v))
    else:
        s = _ip.parse_address(str(v))
    if s is None:
        raise ValueError(f"invalid {type_name}: {v!r}")
    return s


def _batches_to_host(batches: Sequence[Batch]):
    """Result batches → host columns for the write path: names, types and
    {name: (values, validity|None, hi|None, Dictionary|None)}, live rows
    only, string columns against one dictionary."""
    from presto_tpu_torch.exec.runtime import _unify_batch_dicts

    batches = list(batches)
    if not batches:
        return [], [], {}
    if len(batches) > 1:
        batches = _unify_batch_dicts(batches)
    names, types = list(batches[0].names), list(batches[0].types)
    out = {}
    for i, name in enumerate(names):
        vals, valids, his = [], [], []
        any_valid = any_hi = False
        d = None
        for b in batches:
            live = b.live.cpu().numpy()
            c = b.columns[i]
            vals.append(c.values.cpu().numpy()[live])
            if c.validity is not None:
                any_valid = True
                valids.append(c.validity.cpu().numpy()[live])
            else:
                valids.append(np.ones(int(live.sum()), bool))
            if c.hi is not None:
                any_hi = True
                his.append(c.hi.cpu().numpy()[live])
            else:
                his.append(np.zeros(int(live.sum()), np.int64))
            if name in b.dicts:
                if d is not None and b.dicts[name] is not d:
                    d = Dictionary.merge(d, b.dicts[name])
                elif d is None:
                    d = b.dicts[name]
        out[name] = (np.concatenate(vals),
                     np.concatenate(valids) if any_valid else None,
                     np.concatenate(his) if any_hi else None,
                     d)
    return names, types, out


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
                if t.name == "varbinary":
                    # bytes ride the latin-1 bijection into the dictionary
                    arr = np.array(
                        [v.decode("latin-1")
                         if isinstance(v, (bytes, bytearray)) else str(v)
                         for v in arr], dtype=object)
                elif t.name in ("ipaddress", "ipprefix"):
                    arr = np.array([_canonical_ip(v, t.name) for v in arr],
                                   dtype=object)
                # the byte-carrying types may hold NULs: they keep object
                # dtype into encode (dictionary.safe_str_array); varchar
                # keeps the fast astype(str)
                nul_risky = t.name in ("varbinary", "ipaddress", "ipprefix",
                                       "tdigest(double)")
                d, codes = Dictionary.encode(
                    arr if arr.dtype == object and nul_risky
                    else arr.astype(str))
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

    # -- write path: a statement's rows go to the host table, and the
    # device split cache of that table is dropped ---------------------------

    def create_table_from(self, name: str, batches: Sequence[Batch],
                          if_not_exists: bool = False,
                          properties: Optional[dict] = None) -> int:
        if properties:
            raise ValueError(
                "memory connector does not support table properties")
        if name in self.tables:
            if if_not_exists:
                return 0
            raise ValueError(f"table already exists: {name}")
        names, types, data = _batches_to_host(batches)
        mt = MemoryTable(name, {}, {})
        mt.types = dict(zip(names, types))
        rows = 0
        for col, (vals, valid, hi, d) in data.items():
            mt.arrays[col] = vals
            mt.validity[col] = valid
            mt.hi[col] = hi
            if d is not None:
                mt.dicts[col] = d
            rows = len(vals)
        mt.num_rows = rows
        self.tables[name] = mt
        self.invalidate_cache(name)
        return rows

    def insert_into(self, name: str, batches: Sequence[Batch]) -> int:
        """INSERT ... SELECT: source columns feed the table's by position
        and must have its types; string codes re-encode into the table's
        dictionary."""
        if name not in self.tables:
            raise KeyError(f"table not found: {name}")
        mt = self.tables[name]
        names, types, data = _batches_to_host(batches)
        target_cols = list(mt.arrays.keys())
        if len(names) != len(target_cols):
            raise ValueError(
                f"INSERT arity mismatch: {len(names)} columns vs "
                f"{len(target_cols)} in {name}")
        for col, t in zip(target_cols, types):
            if t.name != mt.types[col].name:
                raise ValueError(
                    f"INSERT column {col} type mismatch: {t} vs "
                    f"{mt.types[col]}")
        rows = 0
        for src, col in zip(names, target_cols):
            vals, valid, hi, d = data[src]
            old_n = mt.num_rows
            if d is not None and mt.dicts.get(col) is None:
                # a string column created without a dictionary (CTAS of an
                # all-NULL varchar) adopts the incoming one
                mt.dicts[col] = d
            elif d is not None and d is not mt.dicts[col]:
                m = Dictionary.merge(mt.dicts[col], d)
                if m is not mt.dicts[col]:
                    remap_old = np.concatenate(
                        [[-1], np.searchsorted(m.values,
                                               mt.dicts[col].values)]
                    ).astype(np.int32)
                    mt.arrays[col] = remap_old[mt.arrays[col] + 1]
                    mt.dicts[col] = m
                vals = np.asarray(d.map_to(m))[vals.astype(np.int32) + 1]
            mt.arrays[col] = np.concatenate([mt.arrays[col], vals])
            if valid is not None or mt.validity.get(col) is not None:
                old_v = mt.validity.get(col)
                mt.validity[col] = np.concatenate([
                    old_v if old_v is not None else np.ones(old_n, bool),
                    valid if valid is not None
                    else np.ones(len(vals), bool)])
            if hi is not None or mt.hi.get(col) is not None:
                old_h = mt.hi.get(col)
                mt.hi[col] = np.concatenate([
                    old_h if old_h is not None else np.zeros(old_n, np.int64),
                    hi if hi is not None else np.zeros(len(vals), np.int64)])
            rows = len(vals)
        mt.num_rows += rows
        mt.__dict__.pop("_stats_cache", None)
        self.invalidate_cache(name)
        return rows

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        if name not in self.tables:
            if if_exists:
                return
            raise KeyError(f"table not found: {name}")
        del self.tables[name]
        self.invalidate_cache(name)

    def create_empty(self, name: str, cols, if_not_exists: bool = False):
        """CREATE TABLE name (schema): no rows, the given types."""
        if name in self.tables:
            if if_not_exists:
                return
            raise ValueError(f"table already exists: {name}")
        data = {c: (np.array([], dtype=object) if t.is_string
                    else np.zeros(0, dtype=t.dtype))
                for c, t in cols}
        self.tables[name] = MemoryTable(name, data, dict(cols))
        self.invalidate_cache(name)

    def truncate_table(self, name: str):
        mt = self.tables.get(name)
        if mt is None:
            raise KeyError(f"table not found: {name}")
        cols = list(mt.types.items())
        del self.tables[name]
        self.create_empty(name, cols)

    def replace_table_from(self, name: str, batches) -> int:
        """DELETE's target: the table becomes the rows it keeps."""
        if name not in self.tables:
            raise KeyError(f"table not found: {name}")
        del self.tables[name]
        return self.create_table_from(name, batches)

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
