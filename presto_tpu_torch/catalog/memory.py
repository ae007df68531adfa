"""In-memory connector — tables registered from host arrays / DataFrames.

Analog of presto-memory (the test/demo connector). Tables live on the host
as numpy arrays; a split is read into a Batch on the caller's device and
kept there (the device-resident split cache), so a repeated scan reads
device memory instead of crossing PCIe again. CREATE TABLE [AS], INSERT,
DELETE's rewrite, TRUNCATE and DROP write the host table and drop its
cached splits. String-like columns are dictionary codes; ARRAY and MAP
columns (Python lists and dicts) are dense padded planes, as the engine's
Column holds them. A table may declare index key sets (`index_keys`),
which `get_index` serves from a host hash map for index joins.
"""

from __future__ import annotations

import decimal
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import (
    Batch,
    Column,
    carry_dicts,
    concat_columns,
    key_dict_name,
    round_up_capacity,
)
from presto_tpu_torch.connector import (
    ColumnInfo,
    ColumnStats,
    Connector,
    ConnectorIndex,
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
    ArrayType,
    DecimalType,
    MapType,
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
        if isinstance(first, (list, tuple)):
            elems = [e for v in arr if isinstance(v, (list, tuple))
                     for e in v if e is not None]
            if not elems:
                et = BIGINT
            elif isinstance(elems[0], str):
                et = VARCHAR
            else:
                et = _infer_type(np.asarray(elems))
            return ArrayType(et)
        if isinstance(first, dict):
            ks = [k for v in arr if isinstance(v, dict) for k in v]
            vs = [x for v in arr if isinstance(v, dict)
                  for x in v.values() if x is not None]
            kt = VARCHAR if (ks and isinstance(ks[0], str)) else BIGINT
            vt = _infer_type(np.asarray(vs)) if vs else BIGINT
            return MapType(kt, vt)
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
    only, string columns against one dictionary. An ARRAY or MAP column
    comes as ("planes", (values, sizes, evalid | None, keys | None,
    validity | None), its element dictionary, its key dictionary), its
    planes cut to the widest live row."""
    from presto_tpu_torch.exec.runtime import _unify_batch_dicts

    batches = list(batches)
    if not batches:
        return [], [], {}
    if len(batches) > 1:
        batches = _unify_batch_dicts(batches)
    names, types = list(batches[0].names), list(batches[0].types)
    out = {}
    for i, name in enumerate(names):
        if isinstance(types[i], (ArrayType, MapType)):
            rows = [torch.nonzero(b.live).squeeze(1) for b in batches]
            c = concat_columns([b.columns[i].gather(r)
                                for b, r in zip(batches, rows)],
                               [len(r) for r in rows])
            w = int(c.sizes.max()) if c.sizes.numel() else 0

            def host(p, cut=True):
                return None if p is None else (
                    p[:, :w] if cut else p).cpu().numpy()

            out[name] = ("planes", (
                host(c.values), host(c.sizes, False), host(c.evalid),
                host(c.keys), host(c.validity, False)),
                batches[0].dicts.get(name),
                batches[0].dicts.get(key_dict_name(name)))
            continue
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


def _encode_structural(col: str, arr: np.ndarray, t: Type, dicts: dict):
    """Object array of Python lists or dicts → dense padded planes:
    (values [n, W], sizes, evalid | None, keys [n, W] | None, row validity
    | None). String elements take a dictionary under `col` (a map's keys
    under its key dictionary's name), which this adds to `dicts`."""
    n = len(arr)
    rvalid = np.array([not _is_null(v) for v in arr], dtype=bool)
    row_validity = None if rvalid.all() else rvalid
    if isinstance(t, MapType):
        cells = [list(v.items()) if isinstance(v, dict) else [] for v in arr]
    else:
        cells = [list(v) if isinstance(v, (list, tuple)) else [] for v in arr]
    sizes = np.array([len(c) for c in cells], np.int32)
    w = int(sizes.max()) if n else 0

    def encode_plane(get, et, dict_key):
        vals = np.zeros((n, w), dtype=et.dtype)
        evalid = np.ones((n, w), dtype=bool)
        if et.is_string:
            uniq = sorted({get(e) for c in cells for e in c
                           if get(e) is not None})
            d, _ = Dictionary.encode(np.asarray(uniq, dtype=str))
            dicts[dict_key] = d
        for i, c in enumerate(cells):
            for j, e in enumerate(c):
                v = get(e)
                if v is None:
                    evalid[i, j] = False
                    continue
                if et.is_string:
                    vals[i, j] = dicts[dict_key].code_of(str(v))
                elif isinstance(et, DecimalType):
                    vals[i, j] = int(round(float(v) * 10 ** et.scale))
                else:
                    vals[i, j] = v
        return vals, (None if evalid.all() else evalid)

    if isinstance(t, MapType):
        keys2d, _ = encode_plane(lambda kv: kv[0], t.key, key_dict_name(col))
        vals2d, evalid = encode_plane(lambda kv: kv[1], t.value, col)
        return vals2d, sizes, evalid, keys2d, row_validity
    vals2d, evalid = encode_plane(lambda e: e, t.element, col)
    return vals2d, sizes, evalid, None, row_validity


class MemoryTable:
    """Host arrays of one table: `arrays` (values; strings as dictionary
    codes; an ARRAY or MAP column's [n, W] value plane), `validity` (bool
    or None), `hi` (long-decimal high limbs), `struct` (a structural
    column's sizes, element validity and key plane) and `dicts`, keyed by
    column; `index_keys` are the column sets `get_index` serves."""

    def __init__(self, name: str, data: Dict[str, np.ndarray],
                 types: Optional[Dict[str, Type]] = None,
                 primary_key: Optional[List[str]] = None,
                 index_keys: Optional[List[List[str]]] = None):
        self.name = name
        self.index_keys = [list(k) for k in (index_keys or [])]
        self.types: Dict[str, Type] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        self.validity: Dict[str, Optional[np.ndarray]] = {}
        self.dicts: Dict[str, Dictionary] = {}
        self.hi: Dict[str, Optional[np.ndarray]] = {}
        # col -> (sizes, evalid | None, keys | None)
        self.struct: Dict[str, tuple] = {}
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
            if isinstance(t, (ArrayType, MapType)):
                vals2d, sizes, evalid, keys2d, rvalid = _encode_structural(
                    col, arr, t, self.dicts)
                self.types[col] = t
                self.arrays[col] = vals2d
                self.validity[col] = rvalid
                self.struct[col] = (sizes, evalid, keys2d)
                continue
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
        package computes them so both packages' planners decide alike. An
        ARRAY or MAP column is never a key or a compared value, so the
        planner reads only its null fraction, and its element statistics
        (a distinct count over every element of the plane) are not
        computed."""
        cache = self.__dict__.setdefault("_stats_cache", {})
        if col in cache:
            return cache[col]
        arr = self.arrays[col]
        valid = self.validity.get(col)
        n = len(arr)
        nf = 0.0 if valid is None else float((~valid).sum()) / max(n, 1)
        if col in self.struct:
            cs = ColumnStats(null_fraction=nf)
        elif col in self.dicts:
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


class DeviceSplitCache:
    """Device-resident split cache mixin: scans of the same table slice
    re-serve the already-uploaded device tensors instead of re-staging
    host→device per query (host→device is the dominant scan cost). A
    bounded LRU of device bytes (memory.batch_device_bytes, every plane),
    keyed by (table, part, total, columns, capacity, device); batches are
    never mutated, so sharing is safe. Subclasses implement
    `_read_split_uncached(split, columns, device, capacity)`."""

    split_cache_bytes: int = 6 << 30

    def _init_split_cache(self):
        self._split_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._split_cache_used = 0
        self._cache_epoch = 0
        self._split_cache_lock = threading.Lock()

    def invalidate_cache(self, table: Optional[str] = None):
        with self._split_cache_lock:
            self._cache_epoch += 1
            for k in [k for k in self._split_cache
                      if table is None or k[0] == table]:
                _, nbytes = self._split_cache.pop(k)
                self._split_cache_used -= nbytes

    def read_split(self, split: Split, columns: Sequence[str],
                   device: torch.device,
                   capacity: Optional[int] = None) -> Batch:
        from presto_tpu_torch.memory import batch_device_bytes

        key = (split.table, split.part, split.total, tuple(columns),
               capacity, str(device))
        with self._split_cache_lock:
            epoch = self._cache_epoch
            hit = self._split_cache.get(key)
            if hit is not None:
                self._split_cache.move_to_end(key)
                return hit[0]
        b = self._read_split_uncached(split, columns, device, capacity)
        nbytes = batch_device_bytes(b)
        if nbytes <= self.split_cache_bytes:
            with self._split_cache_lock:
                # an invalidation while we were reading means `b` may be
                # stale — don't resurrect it into the fresh cache
                if self._cache_epoch == epoch and key not in self._split_cache:
                    self._split_cache[key] = (b, nbytes)
                    self._split_cache_used += nbytes
                    while self._split_cache_used > self.split_cache_bytes:
                        _, (_, freed) = self._split_cache.popitem(last=False)
                        self._split_cache_used -= freed
        return b


class MemoryConnector(DeviceSplitCache, Connector):
    """Tables from host arrays, read into device-resident batches through
    the device split cache."""

    def __init__(self, name: str = "memory"):
        self.name = name
        self.tables: Dict[str, MemoryTable] = {}
        self._init_split_cache()

    def add_table(self, name: str, data, types=None, primary_key=None,
                  index_keys=None):
        """Register a table from a DataFrame or {column: array}.
        `index_keys` lists column sets that get_index serves (an index is
        never implied by the primary key)."""
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
        self.tables[name] = MemoryTable(name, data, types, primary_key,
                                        index_keys=index_keys)
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

    def get_index(self, handle, key_columns):
        """A keyed lookup over a declared index key set, else None. The
        index lives with the table version, so its host map is built once
        (set-up), not once a query."""
        t = self.tables.get(handle.name)
        if t is None:
            return None
        if not any(set(key_columns) == set(k) for k in t.index_keys):
            return None
        cache = t.__dict__.setdefault("_indexes", {})
        key = tuple(key_columns)
        if key not in cache:
            cache[key] = _MemoryIndex(t, list(key_columns))
        return cache[key]

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
        for col, payload in data.items():
            if isinstance(payload[0], str) and payload[0] == "planes":
                (vals, sizes, evalid, keys, valid), ed, kd = payload[1:]
                mt.arrays[col] = vals
                mt.validity[col] = valid
                mt.struct[col] = (sizes, evalid, keys)
                for key, d in ((col, ed), (key_dict_name(col), kd)):
                    if d is not None:
                        mt.dicts[key] = d
                rows = len(sizes)
                continue
            vals, valid, hi, d = payload
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
        if (any(isinstance(t, (ArrayType, MapType)) for t in types)
                or mt.struct):
            raise NotImplementedError(
                "INSERT INTO with ARRAY/MAP columns is not supported (CTAS "
                "is), as in the JAX package")
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
        mt.__dict__.pop("_indexes", None)
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

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None) -> Batch:
        t = self.tables[split.table]
        n = t.num_rows
        lo = n * split.part // split.total
        hi = n * (split.part + 1) // split.total
        return _rows_batch(t, columns, np.arange(lo, hi), device,
                           capacity or round_up_capacity(max(hi - lo, 1)))


def _rows_batch(t: MemoryTable, columns: Sequence[str], rows: np.ndarray,
                device: torch.device, cap: int) -> Batch:
    """Rows `rows` (ascending positions) of columns of a table as one batch
    of capacity `cap` on `device`, with validity, long-decimal limbs,
    structural planes and dictionaries (a map's key dictionary too)."""
    k = len(rows)
    contiguous = k == 0 or rows[-1] - rows[0] + 1 == k

    def take(arr):
        return (arr[rows[0]:rows[0] + k] if contiguous and k
                else arr[rows])

    def pad(arr, dtype):
        buf = np.zeros((cap,) + arr.shape[1:], dtype=dtype)
        buf[:k] = take(arr)
        return torch.from_numpy(buf).to(device)

    cols, dicts = [], {}
    for c in columns:
        typ = t.types[c]
        v, h = t.validity.get(c), t.hi.get(c)
        vcol = None if v is None else pad(v, bool)
        hcol = None if h is None else pad(h, np.int64)
        if c in t.struct:
            sizes, evalid, keys2d = t.struct[c]
            cols.append(Column(
                pad(t.arrays[c], typ.dtype), vcol, None,
                pad(sizes, np.int32),
                None if evalid is None else pad(evalid, bool),
                None if keys2d is None else pad(keys2d, keys2d.dtype)))
        else:
            cols.append(Column(pad(t.arrays[c], typ.dtype), vcol, hcol))
        carry_dicts(t.dicts, dicts, c)
    live = np.zeros(cap, dtype=bool)
    live[:k] = True
    return Batch(list(columns), [t.types[c] for c in columns], cols,
                 torch.from_numpy(live).to(device), dicts)


class _MemoryIndex(ConnectorIndex):
    """Key → row positions on the host, built on first use. Each key
    column codes its rows by their rank among its sorted distinct
    (decoded) values; the codes of a key set fold, column by column, into
    one dense int64 code, and the rows sit sorted by it. A lookup codes the
    distinct probe keys the same way, by binary search, and takes each
    one's run of rows. It materializes only the matching rows, as one
    batch, in table order. A NULL key matches nothing, and so does NaN
    (no probe equals it)."""

    def __init__(self, table: MemoryTable, key_columns):
        self.t = table
        self.keys = key_columns
        self._built = None

    def _decoded(self, col: str) -> np.ndarray:
        arr = self.t.arrays[col]
        d = self.t.dicts.get(col)
        if d is not None:
            return np.asarray(d.values, dtype=object)[arr]
        return arr

    def _ensure_built(self):
        """Per key column its sorted distinct values and the sorted folded
        codes after it; the indexed rows' final codes sorted, and those
        rows in the same order."""
        if self._built is not None:
            return
        cols = [self._decoded(c) for c in self.keys]
        valid = np.ones(self.t.num_rows, dtype=bool)
        for c in self.keys:
            v = self.t.validity.get(c)
            if v is not None:
                valid &= v
        rows = np.flatnonzero(valid)
        code = np.zeros(len(rows), dtype=np.int64)
        steps = []
        for vals in cols:
            uniq, inv = np.unique(vals[rows], return_inverse=True)
            folded, code = np.unique(code * len(uniq) + inv.reshape(-1),
                                     return_inverse=True)
            code = code.reshape(-1)
            steps.append((uniq, folded))
        order = np.argsort(code, kind="stable")
        self._built = (steps, code[order], rows[order])

    def _positions(self, keys) -> np.ndarray:
        """Ascending positions of the rows whose key is among `keys`."""
        self._ensure_built()
        steps, scodes, srows = self._built
        probe = [np.asarray(keys[c]) for c in self.keys]
        if not len(srows) or not len(probe[0]):
            return np.zeros(0, dtype=np.int64)
        code = np.zeros(len(probe[0]), dtype=np.int64)
        hit = np.ones(len(probe[0]), dtype=bool)
        for p, (uniq, folded) in zip(probe, steps):
            i = np.minimum(np.searchsorted(uniq, p), len(uniq) - 1)
            hit &= uniq[i] == p
            f = code * len(uniq) + i
            j = np.minimum(np.searchsorted(folded, f), len(folded) - 1)
            hit &= folded[j] == f
            code = j
        want = np.unique(code[hit])
        lo = np.searchsorted(scodes, want, "left")
        n = np.searchsorted(scodes, want, "right") - lo
        start = np.repeat(lo - np.cumsum(n) + n, n)
        return np.sort(srows[start + np.arange(int(n.sum()))])

    def lookup(self, keys, columns, capacity=None,
               device: torch.device = torch.device("cpu")) -> Batch:
        """Every row whose key tuple is among `keys` (decoded values, one
        array a key column), in table order, on `device`."""
        for c in columns:
            if c in self.t.struct:
                raise NotImplementedError(
                    "index lookup over structural columns")
        rows = self._positions(keys)
        cap = capacity or round_up_capacity(max(len(rows), 1))
        return _rows_batch(self.t, columns, rows, device, cap)
