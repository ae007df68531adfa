"""ORC connector — stripe-parallel reads + CTAS writes via pyarrow.orc.

Reference: presto-orc (the fork's flagship module — OrcReader,
OrcSelectiveRecordReader.java:54, StripeReader) and presto-hive's ORC page
sources. The reference hand-decodes ORC streams with predicate-during-
decode (Aria); here arrow does the decode and the engine's selective
machinery operates on the decoded batch (the exact filter above the scan still runs on the
device). Stripes
map to splits exactly as row groups do for parquet; string columns decode
straight into the table-global dictionary (codes only on device).

pyarrow exposes no per-stripe column statistics, so the writer persists a
sidecar stats file next to each table at CTAS/export time:
`<table>.orc.stats.json` = {"version", "file_size", "num_rows",
"stripes": [{"num_rows", "columns": {col: {"min", "max", "null_count",
"kind"?}}}]} (dates ride ISO strings with a "kind": "date" tag; see
scan/pruning.py). `split_stats` serves those per-stripe bounds to the
generic `prune_splits`, so constrained scans eliminate stripes without
opening them — the stripe-skipping half of the Aria selective reader —
and `read_split_selective` runs the value-filter cascade during decode.
A stale or missing sidecar (file_size mismatch after an out-of-band
rewrite) degrades to unpruned scans, never to wrong results.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.orc as po

import torch

from presto_tpu_torch.batch import Batch, round_up_capacity
from presto_tpu_torch.catalog.memory import DeviceSplitCache, _batches_to_host
from presto_tpu_torch.catalog.parquet import (
    _arrow_to_sql,
    _decode_column,
    _distinct_values,
    _to_arrow_columns,
)
from presto_tpu_torch.connector import ColumnInfo, Connector, Split, TableHandle
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.scan.pruning import (
    load_orc_sidecar,
    sidecar_path,
    write_orc_sidecar,
)
from presto_tpu_torch.scan.selective import host_batch, selective_read
from presto_tpu_torch.types import ArrayType, MapType


def _undictionarize(tbl: pa.Table) -> pa.Table:
    """ORC has no dictionary physical type in arrow's writer: cast
    dictionary columns to their value type (ORC files still dictionary-
    encode internally; the engine rebuilds the table-global dictionary at
    open)."""
    cols, fields = [], []
    for i, field in enumerate(tbl.schema):
        col = tbl.column(i)
        if pa.types.is_dictionary(field.type):
            col = col.cast(field.type.value_type)
            field = pa.field(field.name, field.type.value_type)
        cols.append(col)
        fields.append(field)
    return pa.Table.from_arrays(cols, schema=pa.schema(fields))


class _OrcTable:
    __slots__ = ("path", "handle", "dicts", "num_rows", "n_stripes",
                 "version")

    def __init__(self, path, handle, dicts, num_rows, n_stripes, version):
        self.path = path
        self.handle = handle
        self.dicts = dicts
        self.num_rows = num_rows
        self.n_stripes = n_stripes
        self.version = version


class OrcConnector(DeviceSplitCache, Connector):
    """Directory of <table>.orc files."""

    host_cache_bytes: int = 2 << 30

    def __init__(self, directory: str, name: str = "orc"):
        self.name = name
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._tables: Dict[str, _OrcTable] = {}
        self._init_split_cache()
        self._host_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._host_cache_used = 0
        self._host_cache_lock = threading.Lock()
        # (path, version) -> per-stripe SplitStats list | None
        self._sidecar_cache: Dict[tuple, object] = {}

    def table_names(self) -> List[str]:
        return sorted(
            f[:-4] for f in os.listdir(self.directory) if f.endswith(".orc")
        )

    @staticmethod
    def _file_version(path: str) -> tuple:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)

    def _check_fresh(self, name: str):
        t = self._tables.get(name)
        if t is None:
            return
        path = os.path.join(self.directory, f"{name}.orc")
        if not os.path.exists(path) or self._file_version(path) != t.version:
            self._invalidate_table(name)

    def _invalidate_table(self, name: str):
        with self._host_cache_lock:
            self._tables.pop(name, None)
        self.invalidate_cache(name)
        with self._host_cache_lock:
            for k in [k for k in self._host_cache if k[0].endswith(
                    os.sep + f"{name}.orc")]:
                _, nbytes = self._host_cache.pop(k)
                self._host_cache_used -= nbytes

    def _load(self, name: str) -> _OrcTable:
        self._check_fresh(name)
        if name in self._tables:
            return self._tables[name]
        path = os.path.join(self.directory, f"{name}.orc")
        if not os.path.exists(path):
            raise KeyError(f"table not found: {name}")
        f = po.ORCFile(path)
        schema = f.schema
        cols = []
        dicts: Dict[str, Dictionary] = {}
        for field in schema:
            t = _arrow_to_sql(field)
            if t.is_string:
                # table-global dictionary: one pass over the column at open
                vocab = set()
                for s in range(f.nstripes):
                    col = f.read_stripe(s, columns=[field.name]).column(
                        field.name)
                    arr = col.combine_chunks() if isinstance(
                        col, pa.ChunkedArray) else col
                    vocab.update(_distinct_values(arr))
                d = Dictionary(
                    np.array(sorted(v for v in vocab if v is not None)))
                dicts[field.name] = d
                cols.append(ColumnInfo(field.name, t, d))
            else:
                cols.append(ColumnInfo(field.name, t, None))
        handle = TableHandle(self.name, name, cols,
                             row_count=float(f.nrows))
        t = _OrcTable(path, handle, dicts, f.nrows, f.nstripes,
                      self._file_version(path))
        # concurrent loaders both build the table (the open is outside
        # any lock by design); the insert is idempotent, the lock keeps
        # the dict consistent
        with self._host_cache_lock:
            self._tables[name] = t
        return t

    def get_table(self, name: str) -> TableHandle:
        return self._load(name).handle

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        """One split per stripe, sub-split when fewer stripes than desired
        (mirrors the parquet connector's row-group sub-splitting)."""
        t = self._load(handle.name)
        n = max(t.n_stripes, 1)
        if n >= desired or t.num_rows == 0:
            return [Split(handle.name, (s, 0, 1), n)
                    for s in range(t.n_stripes)] or [
                        Split(handle.name, (0, 0, 1), 1)]
        sub = -(-desired // n)
        out = []
        for s in range(n):
            for i in range(sub):
                out.append(Split(handle.name, (s, i, sub), n * sub))
        return out

    # -- write path (CTAS/DROP; reference: HiveWriterFactory ORC path) ----

    def create_table_from(self, name: str, batches,
                          if_not_exists: bool = False,
                          properties: Optional[dict] = None) -> int:
        if properties:
            raise ValueError(
                "orc connector does not support table properties")
        path = os.path.join(self.directory, f"{name}.orc")
        if os.path.exists(path):
            if if_not_exists:
                return 0
            raise ValueError(f"table already exists: {name}")
        names, types, data = _batches_to_host(batches)
        if any(isinstance(t, (ArrayType, MapType)) for t in types):
            raise NotImplementedError(
                "ORC writer does not support ARRAY/MAP columns yet")
        plain = {c: v[0] for c, v in data.items()}
        validity = {c: v[1] for c, v in data.items() if v[1] is not None}
        his = {c: v[2] for c, v in data.items() if v[2] is not None}
        dicts = {c: v[3] for c, v in data.items() if v[3] is not None}
        arrays, schema = _to_arrow_columns(plain, dict(zip(names, types)),
                                           dicts, validity, his)
        tbl = _undictionarize(pa.Table.from_arrays(arrays, schema=schema))
        po.write_table(tbl, path + ".tmp")
        os.replace(path + ".tmp", path)
        _write_sidecar(path)
        self._invalidate_table(name)
        return int(tbl.num_rows)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        path = os.path.join(self.directory, f"{name}.orc")
        if not os.path.exists(path):
            if if_exists:
                return
            raise KeyError(f"table not found: {name}")
        os.remove(path)
        if os.path.exists(sidecar_path(path)):
            os.remove(sidecar_path(path))
        self._invalidate_table(name)

    # -- read path --------------------------------------------------------

    def read_split(self, split: Split, columns: Sequence[str],
                   device: torch.device,
                   capacity: Optional[int] = None) -> Batch:
        self._check_fresh(split.table)
        return super().read_split(split, columns, device, capacity)

    def _stripe_stats(self, t: _OrcTable):
        """Sidecar-backed per-stripe SplitStats list (None = no usable
        sidecar), cached per (path, file version)."""
        key = (t.path, t.version)
        with self._host_cache_lock:
            if key in self._sidecar_cache:
                return self._sidecar_cache[key]
        stats = load_orc_sidecar(t.path)  # file I/O stays outside the lock
        with self._host_cache_lock:
            while len(self._sidecar_cache) > 64:
                # eviction is sized-check and pop in this one section;
                # the earlier membership probe plays no part in it
                self._sidecar_cache.pop(next(iter(self._sidecar_cache)))
            # racing loaders read the same sidecar file; the insert is
            # idempotent, so re-checking membership buys nothing
            self._sidecar_cache[key] = stats
        return stats

    def split_stats(self, handle: TableHandle, split: Split):
        t = self._load(handle.name)
        stats = self._stripe_stats(t)
        if not stats:
            return None
        stripe = split.part[0] if isinstance(split.part, tuple) else split.part
        if stripe >= len(stats):
            return None
        # sub-splits of one stripe share its bounds (a superset — still a
        # correct pruning witness)
        return stats[stripe]

    def read_split_selective(self, split: Split, columns: Sequence[str],
                             filters, device: torch.device,
                             capacity: Optional[int] = None,
                             adaptive=None, counters=None) -> Batch:
        """Predicate-during-decode over one stripe (see
        scan/selective.py); bypasses the device split cache like the
        parquet selective path."""
        self._check_fresh(split.table)
        t = self._load(split.table)
        stripe, sub, sub_count = split.part

        def _decode(cols):
            return self._decoded_columns(t, stripe, sub, sub_count, cols)

        return selective_read(_decode, t.handle, columns, filters, device,
                              capacity=capacity, dicts=t.dicts,
                              adaptive=adaptive, counters=counters)

    def _decoded_columns(self, t: _OrcTable, stripe: int, sub: int,
                         sub_count: int, columns: Sequence[str]):
        key = (t.path, stripe, sub, sub_count, tuple(columns))
        with self._host_cache_lock:
            hit = self._host_cache.get(key)
            if hit is not None:
                self._host_cache.move_to_end(key)
                return hit[0]
        f = po.ORCFile(t.path)
        if t.n_stripes == 0:
            tbl = f.read(columns=list(columns))
        else:
            tbl = f.read_stripe(stripe, columns=list(columns))
            if not isinstance(tbl, pa.Table):
                tbl = pa.Table.from_batches([tbl])
        if sub_count > 1:
            per = -(-tbl.num_rows // sub_count)
            tbl = tbl.slice(sub * per, per)
        n = tbl.num_rows
        out = {}
        nbytes = 0
        for name in columns:
            st = t.handle.column(name).type
            arr, valid, hi = _decode_column(tbl.column(name), st,
                                            t.dicts.get(name))
            arr = np.ascontiguousarray(np.asarray(arr))
            out[name] = (arr, valid, hi)
            nbytes += arr.nbytes + (valid.nbytes if valid is not None else 0)
            nbytes += hi.nbytes if hi is not None else 0
        result = (out, n)
        if nbytes <= self.host_cache_bytes:
            with self._host_cache_lock:
                # the decode above ran outside the lock on purpose (it is
                # the expensive step); membership is RE-VALIDATED here
                # before the insert, so the stale first read cannot
                # double-account
                if key not in self._host_cache:
                    self._host_cache[key] = (result, nbytes)
                    self._host_cache_used += nbytes
                    while self._host_cache_used > self.host_cache_bytes:
                        _, (_, freed) = self._host_cache.popitem(last=False)
                        self._host_cache_used -= freed
        return result

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None) -> Batch:
        t = self._load(split.table)
        stripe, sub, sub_count = split.part
        decoded, n = self._decoded_columns(t, stripe, sub, sub_count,
                                           columns)
        cap = capacity or round_up_capacity(max(n, 1))
        return host_batch(columns, [t.handle.column(c).type for c in columns],
                          decoded, n, cap, t.dicts, device)


def _write_sidecar(path: str) -> None:
    """Best-effort stripe-stats sidecar: a stats failure must never fail
    the write itself (the scan degrades to unpruned, not to an error)."""
    try:
        write_orc_sidecar(path)
    except Exception:
        pass


def export_table_to_orc(directory: str, name: str, data, types,
                        dicts=None, stripe_size: Optional[int] = None,
                        validity=None) -> str:
    """Materialize host columns as <directory>/<name>.orc (test fixture
    helper, the dbgen→ORC-warehouse path). `stripe_size` (bytes) forces
    small multi-stripe files so split-elimination paths are testable at
    fixture scale; `validity` maps column → bool mask (False = NULL)."""
    os.makedirs(directory, exist_ok=True)
    arrays, schema = _to_arrow_columns(data, types, dicts or {}, validity)
    path = os.path.join(directory, f"{name}.orc")
    tbl = _undictionarize(pa.Table.from_arrays(arrays, schema=schema))
    if stripe_size:
        po.write_table(tbl, path, stripe_size=stripe_size)
    else:
        po.write_table(tbl, path)
    _write_sidecar(path)
    return path
