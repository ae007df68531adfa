"""Parquet storage connector — the persistent-format layer.

Reference analog: presto-hive + presto-orc/presto-parquet. Where the Aria
work makes the ORC reader *selective* (filter pushdown into the decode loop,
OrcSelectiveRecordReader.java:54, TupleDomainFilter.java:92), the
equivalents here are:

- row-group pruning with parquet min/max statistics (coarse TupleDomain
  filtering before any IO),
- column pruning (only referenced columns are decoded — driven by the
  planner's column pruning, SURVEY §2a PushdownSubfields analog),
- dictionary-preserving reads: parquet dictionary-encoded string columns map
  straight onto the engine's Dictionary codes without materializing strings.

Splits are row-group ranges; batches decode on the host into engine-native
numpy columns and upload to the caller's device. Files are the JAX
package's format byte for byte (decimal types ride the `presto_tpu.decimal`
field metadata), so either package reads what the other writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

import torch

from presto_tpu_torch.batch import Batch, round_up_capacity
from presto_tpu_torch.catalog.memory import DeviceSplitCache, _batches_to_host
from presto_tpu_torch.connector import (
    ColumnInfo,
    ColumnStats,
    Connector,
    Split,
    TableHandle,
)
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.scan.pruning import SplitStats
from presto_tpu_torch.scan.selective import host_batch, selective_read
from presto_tpu_torch.types import (
    ArrayType,
    BIGINT,
    BOOLEAN,
    DATE,
    DOUBLE,
    DecimalType,
    INTEGER,
    MapType,
    REAL,
    Type,
    VARCHAR,
    parse_type,
)


_DECIMAL_META = b"presto_tpu.decimal"


def _arrow_to_sql(field: pa.Field) -> Type:
    t = field.type
    if field.metadata and _DECIMAL_META in field.metadata:
        p, s = map(int, field.metadata[_DECIMAL_META].decode().split(","))
        return DecimalType(p, s)
    if pa.types.is_boolean(t):
        return BOOLEAN
    if pa.types.is_int8(t) or pa.types.is_int16(t) or pa.types.is_int32(t):
        return INTEGER
    if pa.types.is_int64(t):
        return BIGINT
    if pa.types.is_float32(t):
        return REAL
    if pa.types.is_float64(t):
        return DOUBLE
    if pa.types.is_date32(t):
        return DATE
    if pa.types.is_decimal(t):
        if t.precision > 38:
            raise NotImplementedError(f"decimal precision {t.precision} > 38")
        return DecimalType(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t) or (
        pa.types.is_dictionary(t)
    ):
        return VARCHAR
    raise NotImplementedError(f"arrow type {t}")


def _sql_to_arrow(t: Type):
    if t is BOOLEAN:
        return pa.bool_()
    if t is INTEGER:
        return pa.int32()
    if t is BIGINT:
        return pa.int64()
    if t is REAL:
        return pa.float32()
    if t is DOUBLE:
        return pa.float64()
    if t is DATE:
        return pa.date32()
    if isinstance(t, DecimalType):
        # unscaled int64 physical storage; the SQL type travels in field
        # metadata (fast zero-copy IO; readers see plain int64)
        return pa.int64()
    if t.is_string:
        return pa.dictionary(pa.int32(), pa.string())
    raise NotImplementedError(str(t))


def write_table(path: str, data: Dict[str, np.ndarray], types: Dict[str, Type],
                dicts: Optional[Dict[str, Dictionary]] = None,
                row_group_rows: int = 1 << 20,
                validity: Optional[Dict[str, np.ndarray]] = None):
    """Write engine-native columns (dict codes, unscaled decimals, day ints)
    to a parquet file. `validity` maps column → bool mask (False = NULL)."""
    arrays, schema = _to_arrow_columns(data, types, dicts or {}, validity)
    table = pa.Table.from_arrays(arrays, schema=schema)
    pq.write_table(table, path, row_group_size=row_group_rows,
                   use_dictionary=True, compression="zstd")


def write_bucketed_table(directory: str, name: str,
                         data: Dict[str, np.ndarray],
                         types: Dict[str, Type],
                         by: Sequence[str], count: int,
                         dicts: Optional[Dict[str, Dictionary]] = None,
                         validity: Optional[Dict[str, np.ndarray]] = None,
                         row_group_rows: int = 1 << 20):
    """Write a BUCKETED table: rows hash-partition by content hash of the
    `by` columns (np_bucket_ids — the SAME hash the spiller and colocated
    split placement use) into `<name>.buckets/b<i>.parquet` + a
    _bucketing.json spec. Reference: hive bucketed tables
    (HiveBucketing.getHiveBucket + ConnectorNodePartitioningProvider) —
    equal-bucketed joins on the bucket keys skip the shuffle."""
    import shutil

    from presto_tpu_torch.spiller import np_bucket_ids

    dicts = dicts or {}
    validity = validity or {}
    d = os.path.join(directory, f"{name}.buckets")
    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    pid = np_bucket_ids(
        [(np.asarray(data[k]), dicts.get(k), validity.get(k)) for k in by],
        count)
    for b in range(count):
        mask = pid == b
        bdata = {c: np.ascontiguousarray(np.asarray(v)[mask])
                 for c, v in data.items()}
        bvalid = {c: np.asarray(v)[mask] for c, v in validity.items()
                  if v is not None}
        arrays, schema = _to_arrow_columns(bdata, types, dicts, bvalid)
        pq.write_table(pa.Table.from_arrays(arrays, schema=schema),
                       os.path.join(tmp, f"b{b:05d}.parquet"),
                       row_group_size=row_group_rows,
                       use_dictionary=True, compression="zstd")
    with open(os.path.join(tmp, "_bucketing.json"), "w") as f:
        json.dump({"by": list(by), "count": int(count)}, f)
    shutil.rmtree(d, ignore_errors=True)
    os.replace(tmp, d)


def _footer_stats(f: "pq.ParquetFile", col_idx: int, t: Type,
                  ndv=None) -> Optional["ColumnStats"]:
    """CBO column stats from parquet footer metadata: min/max and null
    counts aggregated over row groups, NDV from the global dictionary when
    present (the reference's HiveMetastore-supplied table statistics analog;
    here the file footer IS the metastore)."""
    mn = mx = None
    nulls = 0
    rows = max(f.metadata.num_rows, 1)
    for rg in range(f.num_row_groups):
        st = f.metadata.row_group(rg).column(col_idx).statistics
        if st is None:
            return ColumnStats(ndv=ndv) if ndv else None
        if st.null_count is not None:
            nulls += st.null_count
        if st.has_min_max and not t.is_string:
            try:
                lo, hi = float(st.min), float(st.max)
            except (TypeError, ValueError):
                try:  # date32 statistics arrive as datetime.date
                    lo = float(st.min.toordinal() - 719163)
                    hi = float(st.max.toordinal() - 719163)
                except Exception:
                    lo = hi = None
            if lo is not None:
                mn = lo if mn is None else min(mn, lo)
                mx = hi if mx is None else max(mx, hi)
    return ColumnStats(ndv=ndv, null_fraction=nulls / rows,
                       min_value=mn, max_value=mx)


@dataclasses.dataclass
class _PqTable:
    path: str
    handle: TableHandle
    dicts: Dict[str, Dictionary]
    num_rows: int
    num_row_groups: int
    # file version at load: (mtime_ns, size). A rewrite (INSERT/CTAS
    # replace) changes it; every process watching the same directory
    # revalidates on access, so multi-process workers see DDL from the
    # coordinator without an invalidation RPC
    version: tuple = (0, 0)
    # flattened ROW leaves: dotted column name -> (struct column, field)
    nested: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    # scaled-writer part tables: virtual row-group index -> (file, rg)
    part_map: Optional[list] = None
    # hive-partitioned tables: {"pcols": [(name, Type)], "pvals": [tuple]}
    # where pvals[i] aligns with part_map[i] (engine-native values, None
    # for the NULL partition)
    hive: Optional[dict] = None
    # bucketed tables (ConnectorNodePartitioningProvider analog):
    # (key column names, bucket count); bucket_map[vrg] = bucket id
    bucketing: Optional[tuple] = None
    bucket_map: Optional[list] = None


class ParquetConnector(DeviceSplitCache, Connector):
    """Directory-of-parquet-files connector: each file <table>.parquet.

    Two cache tiers over the raw file (the warm-path analog of the
    reference's OS page cache + in-heap data cache):
    - device-resident split LRU (DeviceSplitCache mixin, a device-memory
      budget)
    - host-RAM decoded-column LRU (`host_cache_bytes`): parquet decode is
      single-threaded and dominates re-scans of tables too big for the
      device (SF100 lineitem); decoded engine-native numpy columns are
      kept so re-runs pay only host→device transfer."""

    host_cache_bytes: int = 48 << 30

    def __init__(self, directory: str, name: str = "parquet"):
        import threading
        from collections import OrderedDict

        self.name = name
        self.directory = directory
        self._tables: Dict[str, _PqTable] = {}
        self._init_split_cache()
        self._host_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._host_cache_used = 0
        self._host_cache_lock = threading.Lock()

    def table_names(self) -> List[str]:
        out = []
        for f in os.listdir(self.directory):
            if f.endswith(".parquet"):
                out.append(f[: -len(".parquet")])
            elif f.endswith(".parts") and os.path.isdir(
                    os.path.join(self.directory, f)):
                out.append(f[: -len(".parts")])
            elif f.endswith(".hive") and os.path.isdir(
                    os.path.join(self.directory, f)):
                out.append(f[: -len(".hive")])
        return sorted(out)

    @staticmethod
    def _file_version(path: str) -> tuple:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)

    def _check_fresh(self, name: str):
        """Drop cached metadata/pages when the backing file changed (the
        cross-process DDL-visibility path — see _PqTable.version)."""
        t = self._tables.get(name)
        if t is None:
            return
        try:
            if t.hive is not None:
                st = os.stat(t.path)  # the partition-root directory
                nfiles = sum(1 for _, _, fs in os.walk(t.path)
                             for f in fs if f.endswith(".parquet"))
                if (st.st_mtime_ns, nfiles) != t.version:
                    self._invalidate_table(name)
                return
            if t.part_map is not None:
                st = os.stat(t.path)  # the parts directory
                nparts = len([f for f in os.listdir(t.path)
                              if f.endswith(".parquet")])
                if (st.st_mtime_ns, nparts) != t.version:
                    self._invalidate_table(name)
                return
            if self._file_version(t.path) != t.version:
                self._invalidate_table(name)
        except OSError:
            self._invalidate_table(name)

    # -- scaled writers (SCALED_WRITER_DISTRIBUTION analog) ---------------
    # A table is either one <name>.parquet file or a <name>.parts/
    # directory of part-*.parquet files written concurrently by writer
    # tasks into <name>.parts.tmp/ and committed by one rename; readers
    # treat every (file, row group) as a split.

    # a staging directory nothing has written to for this long belongs to
    # a writer that died, and a new CTAS of the name reclaims it
    stale_staging_s: float = 3600.0

    def supports_scaled_writes(self) -> bool:
        return True

    def parts_dir(self, name: str, staging: bool = False) -> str:
        return os.path.join(self.directory,
                            f"{name}.parts.tmp" if staging else f"{name}.parts")

    def begin_scaled_create(self, name: str, if_not_exists: bool = False):
        if self._table_exists(name):
            if if_not_exists:
                return False
            raise ValueError(f"table already exists: {name}")
        staging = self.parts_dir(name, staging=True)
        for attempt in (0, 1):
            try:
                # exclusive create: two racing CTAS must not share a
                # staging directory (mkdir is the atomic mutual exclusion,
                # the role of HiveMetadata begin/finishCreate)
                os.makedirs(staging, exist_ok=False)
                return True
            except FileExistsError:
                # a writer killed mid-CTAS never aborts its staging:
                # reclaim it when nothing has written to it for a while
                try:
                    newest = max(
                        (os.path.getmtime(os.path.join(staging, f))
                         for f in os.listdir(staging)),
                        default=os.path.getmtime(staging))
                except OSError:
                    continue  # lost a race with a finishing writer
                if (attempt == 0
                        and time.time() - newest > self.stale_staging_s):
                    shutil.rmtree(staging, ignore_errors=True)
                    continue
                raise ValueError(
                    f"table {name!r} is being created concurrently"
                ) from None
        return True

    def finish_scaled_create(self, name: str):
        """Commit: the staging directory renames into place atomically."""
        os.replace(self.parts_dir(name, staging=True),
                   self.parts_dir(name))
        self._invalidate_table(name)

    def abort_scaled_create(self, name: str):
        shutil.rmtree(self.parts_dir(name, staging=True),
                      ignore_errors=True)

    def write_part(self, name: str, part_id: str, batches,
                   staging: bool = True) -> int:
        """One part file of a table: a scaled writer task's, into the
        staging directory, or INSERT's append to a part-file table."""
        names, types, data = _batches_to_host(batches)
        if any(isinstance(t, (ArrayType, MapType)) for t in types):
            raise NotImplementedError(
                "parquet writer does not support ARRAY/MAP columns yet")
        plain = {c: v[0] for c, v in data.items()}
        validity = {c: v[1] for c, v in data.items() if v[1] is not None}
        his = {c: v[2] for c, v in data.items() if v[2] is not None}
        dicts = {c: v[3] for c, v in data.items() if v[3] is not None}
        arrays, schema = _to_arrow_columns(plain, dict(zip(names, types)),
                                           dicts, validity, his)
        tbl = pa.Table.from_arrays(arrays, schema=schema)
        path = os.path.join(self.parts_dir(name, staging=staging),
                            f"part-{part_id}.parquet")
        pq.write_table(tbl, path + ".tmp", row_group_size=1 << 20,
                       use_dictionary=True, compression="zstd")
        os.replace(path + ".tmp", path)
        return int(tbl.num_rows)

    def _table_exists(self, name: str) -> bool:
        return (os.path.exists(os.path.join(self.directory,
                                            f"{name}.parquet"))
                or os.path.isdir(self.parts_dir(name))
                or os.path.isdir(self.hive_dir(name))
                or os.path.isdir(self.buckets_dir(name)))

    def _part_files(self, name: str):
        d = self.parts_dir(name)
        if not os.path.isdir(d):
            return None
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(".parquet"))

    def _scan_part_files(self, paths):
        """Union schema/row-groups/string-vocab over a list of parquet
        files (shared by the parts-directory and hive loaders).

        Schema drift across parts is REJECTED (every file must match the
        first file's arrow schema) instead of silently reading later files
        through the first schema. Per-file vocab is cached by
        (path, mtime), so an INSERT-triggered invalidation only scans the
        new part files, and string columns are read dictionary-encoded so
        the union walks unique values, not full columns."""
        schema = None
        str_cols: list = []
        num_rows = 0
        rgs = []  # (path, num_row_groups)
        vocab: Dict[str, set] = {}
        cache = self.__dict__.setdefault("_vocab_cache", {})
        for p in paths:
            f = pq.ParquetFile(p)
            if schema is None:
                schema = f.schema_arrow
                str_cols = [fl.name for fl in schema
                            if _arrow_to_sql(fl).is_string]
            elif not f.schema_arrow.equals(schema):
                raise ValueError(
                    f"schema drift in parts table: {p} has schema "
                    f"{f.schema_arrow} != first part's {schema}")
            num_rows += f.metadata.num_rows
            rgs.append((p, f.num_row_groups))
            if not str_cols:
                continue
            ckey = (p, os.stat(p).st_mtime_ns)
            fvocab = cache.get(ckey)
            if fvocab is None:
                fvocab = {c: set() for c in str_cols}
                fd = pq.ParquetFile(p, read_dictionary=str_cols)
                for rg in range(fd.num_row_groups):
                    t = fd.read_row_group(rg, columns=str_cols)
                    for c in str_cols:
                        for chunk in t.column(c).chunks:
                            fvocab[c].update(_distinct_values(chunk))
                cache[ckey] = fvocab
            for c, vs in fvocab.items():
                vocab.setdefault(c, set()).update(vs)
        # evict superseded generations (same path, older mtime) and entries
        # whose file was deleted (compaction/table rewrite) — stale vocab
        # sets would otherwise leak for the connector's lifetime. Other
        # tables share this cache; their live files are untouched.
        scanned = set(paths)
        live_keys = {(p, os.stat(p).st_mtime_ns) for p in paths
                     if os.path.exists(p)}
        for k in list(cache):
            if (k[0] in scanned and k not in live_keys) \
                    or not os.path.exists(k[0]):
                del cache[k]
        return schema, num_rows, rgs, vocab

    @staticmethod
    def _cols_from_schema(schema, vocab):
        """ColumnInfo + global Dictionary list from a unioned schema."""
        cols, dicts = [], {}
        for field in schema:
            t = _arrow_to_sql(field)
            if t.is_string:
                d = Dictionary(np.array(sorted(
                    v for v in vocab.get(field.name, ()) if v is not None)))
                dicts[field.name] = d
                cols.append(ColumnInfo(field.name, t, d))
            else:
                cols.append(ColumnInfo(field.name, t, None))
        return cols, dicts

    def _load_parts(self, name: str, parts: list) -> _PqTable:
        """Part-directory table: (file, row group) pairs become the
        virtual row-group space; schema/dictionaries union over parts."""
        schema, num_rows, rgs, vocab = self._scan_part_files(parts)
        part_map = [(p, rg) for p, n_rg in rgs for rg in range(n_rg)]
        cols, dicts = self._cols_from_schema(schema, vocab)
        handle = TableHandle(self.name, name, cols, row_count=float(num_rows))
        d = self.parts_dir(name)
        st = os.stat(d)
        t = _PqTable(d, handle, dicts, num_rows, len(part_map),
                     version=(st.st_mtime_ns, len(parts)),
                     part_map=part_map)
        self._tables[name] = t
        return t

    def buckets_dir(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.buckets")

    def _load_buckets(self, name: str) -> _PqTable:
        """Bucketed table: bucket files in id order become the virtual
        row-group space, each vrg tagged with its bucket (splits carry it
        as the lifespan id). The handle exposes the bucketing spec so the
        fragmenter can plan colocated joins."""
        d = self.buckets_dir(name)
        with open(os.path.join(d, "_bucketing.json")) as f:
            spec = json.load(f)
        count = int(spec["count"])
        files = [os.path.join(d, f"b{b:05d}.parquet") for b in range(count)]
        schema, num_rows, rgs, vocab = self._scan_part_files(files)
        part_map, bucket_map = [], []
        for b, (p, n_rg) in enumerate(rgs):
            for rg in range(n_rg):
                part_map.append((p, rg))
                bucket_map.append(b)
        cols, dicts = self._cols_from_schema(schema, vocab)
        handle = TableHandle(self.name, name, cols,
                             row_count=float(num_rows),
                             bucketing=(tuple(spec["by"]), count))
        st = os.stat(d)
        t = _PqTable(d, handle, dicts, num_rows, len(part_map),
                     version=(st.st_mtime_ns, count),
                     part_map=part_map,
                     bucketing=(tuple(spec["by"]), count),
                     bucket_map=bucket_map)
        self._tables[name] = t
        return t

    # -- hive-style partitioned tables (reference: presto-hive partitions:
    # HiveTableProperties.PARTITIONED_BY_PROPERTY, HivePartitionManager
    # partition pruning, directory layout <table>/<col>=<value>/part-*) ----

    _HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"

    def hive_dir(self, name: str, staging: bool = False) -> str:
        return os.path.join(self.directory,
                            f"{name}.hive.tmp" if staging else f"{name}.hive")

    @staticmethod
    def _pval_to_path(v) -> str:
        import urllib.parse

        if v is None:
            return ParquetConnector._HIVE_NULL
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return urllib.parse.quote(v, safe="")
        return str(int(v))

    @staticmethod
    def _pval_from_path(s: str, t: Type):
        import urllib.parse

        if s == ParquetConnector._HIVE_NULL:
            return None
        if t is BOOLEAN:
            return s == "true"
        if t.is_string:
            return urllib.parse.unquote(s)
        return int(s)

    def _hive_files(self, name: str):
        """[(fpath, pvals_by_name)] for every part file, sorted; None when
        the table is not hive-partitioned."""
        import json

        root = self.hive_dir(name)
        meta_path = os.path.join(root, "_meta.json")
        if not os.path.isfile(meta_path):
            return None
        meta = json.load(open(meta_path))
        pcols = [(c, parse_type(ts)) for c, ts in meta["partitioned_by"]]
        out: list = []
        for dirpath, _dirs, files in sorted(os.walk(root)):
            pq_files = sorted(f for f in files if f.endswith(".parquet"))
            if not pq_files:
                continue
            rel = os.path.relpath(dirpath, root)
            comps = [] if rel == "." else rel.split(os.sep)
            if len(comps) != len(pcols):
                continue  # stray depth: not a partition leaf
            pvals = {}
            for comp, (c, t) in zip(comps, pcols):
                cname, _, raw = comp.partition("=")
                if cname != c:
                    raise ValueError(
                        f"malformed partition directory {rel!r} in {name}")
                pvals[c] = self._pval_from_path(raw, t)
            for f in pq_files:
                out.append((os.path.join(dirpath, f), pvals))
        return pcols, out, meta

    def _load_hive(self, name: str) -> _PqTable:
        """Partitioned table: partition values come from directory names,
        data columns from the files; partition columns append to the
        schema (hive convention: partition keys are the trailing
        columns)."""
        root = self.hive_dir(name)
        pcols, files, meta = self._hive_files(name)
        schema, num_rows, rgs, vocab = self._scan_part_files(
            [fp for fp, _ in files])
        pvals_by_file = dict(files)
        part_map, pvals_list = [], []
        for fp, n_rg in rgs:
            for rg in range(n_rg):
                part_map.append((fp, rg))
                pvals_list.append(tuple(pvals_by_file[fp][c]
                                        for c, _ in pcols))
        if schema is not None:
            cols, dicts = self._cols_from_schema(schema, vocab)
        else:
            # zero-row table: the data-column schema survives in _meta.json
            cols, dicts = [], {}
            pset = {c for c, _ in pcols}
            for c, ts in meta.get("columns", []):
                if c in pset:
                    continue
                t = parse_type(ts)
                if t.is_string:
                    d = Dictionary(np.array([], dtype=object))
                    dicts[c] = d
                    cols.append(ColumnInfo(c, t, d))
                else:
                    cols.append(ColumnInfo(c, t, None))
        for i, (c, t) in enumerate(pcols):
            vals = sorted({pv[i] for pv in pvals_list if pv[i] is not None})
            if t.is_string:
                d = Dictionary(np.array(vals, dtype=object))
                dicts[c] = d
                cols.append(ColumnInfo(c, t, d,
                                       ColumnStats(ndv=float(len(vals)))))
            else:
                cols.append(ColumnInfo(c, t, None, ColumnStats(
                    ndv=float(len(vals)),
                    min_value=(float(vals[0]) if vals else None),
                    max_value=(float(vals[-1]) if vals else None))))
        handle = TableHandle(self.name, name, cols, row_count=float(num_rows))
        st = os.stat(root)
        t = _PqTable(root, handle, dicts, num_rows, len(part_map),
                     version=(st.st_mtime_ns, len(files)),
                     part_map=part_map,
                     hive={"pcols": pcols, "pvals": pvals_list})
        self._tables[name] = t
        return t

    def _hive_group_rows(self, pnames, data):
        """Group host rows by partition tuple: [(pvals_tuple, row_idx)]
        with engine-native values (strings decoded, None for NULL)."""
        combined = None
        reprs = []
        for c in pnames:
            vals, valid, hi, d = data[c]
            if hi is not None:
                raise ValueError(
                    f"partition column {c} has an unsupported wide type")
            is_bool = np.asarray(vals).dtype == np.bool_
            arr = np.asarray(vals).astype(np.int64)
            null_mark = (np.asarray(~np.asarray(valid))
                         if valid is not None else np.zeros(len(arr), bool))
            reprs.append((arr, null_mark, d, is_bool))
            # group code: 0 = the NULL partition, else 1 + value ordinal
            # (a separate null axis — a real value of -1 must not merge
            # with NULLs)
            _, inv = np.unique(arr, return_inverse=True)
            code = np.where(null_mark, 0, inv + 1)
            width = int(code.max()) + 1 if len(code) else 1
            combined = (code if combined is None
                        else combined * width + code)
        u_comb, inv = np.unique(combined, return_inverse=True)
        groups = []
        for gi in range(len(u_comb)):
            idx = np.nonzero(inv == gi)[0]
            row0 = int(idx[0])
            pvals = []
            for arr, null_mark, d, is_bool in reprs:
                if null_mark[row0]:
                    pvals.append(None)
                elif d is not None:
                    pvals.append(str(d.decode(arr[row0:row0 + 1])[0]))
                elif is_bool:
                    pvals.append(bool(arr[row0]))
                else:
                    pvals.append(int(arr[row0]))
            groups.append((tuple(pvals), idx))
        return groups

    def _hive_validate(self, pnames, names, types):
        tmap = dict(zip(names, types))
        for c in pnames:
            if c not in tmap:
                raise ValueError(f"partition column {c} not in table schema")
            t = tmap[c]
            ok = (t.is_string or t is BOOLEAN or t is DATE
                  or (not t.is_string and t.dtype in ("int64", "int32")
                      and not isinstance(t, DecimalType)))
            if not ok:
                raise ValueError(
                    f"partition column {c} must be integer, varchar, "
                    f"boolean or date, got {t}")
        if list(names[-len(pnames):]) != list(pnames):
            raise ValueError(
                "partitioned_by columns must be the trailing table "
                "columns (hive convention)")

    def _hive_write_groups(self, root, pnames, names, types, data, groups,
                           file_tag: str):
        """Write one parquet file per partition group under
        root/<c>=<v>/..., data columns only."""
        dnames = [c for c in names if c not in set(pnames)]
        tmap = dict(zip(names, types))
        rows = 0
        for pvals, idx in groups:
            comps = [f"{c}={self._pval_to_path(v)}"
                     for c, v in zip(pnames, pvals)]
            d = os.path.join(root, *comps)
            os.makedirs(d, exist_ok=True)
            plain = {c: np.asarray(data[c][0])[idx] for c in dnames}
            validity = {c: np.asarray(data[c][1])[idx]
                        for c in dnames if data[c][1] is not None}
            his = {c: np.asarray(data[c][2])[idx]
                   for c in dnames if data[c][2] is not None}
            dicts = {c: data[c][3] for c in dnames if data[c][3] is not None}
            arrays, schema = _to_arrow_columns(
                plain, {c: tmap[c] for c in dnames}, dicts, validity, his)
            tbl = pa.Table.from_arrays(arrays, schema=schema)
            pq.write_table(tbl, os.path.join(d, f"part-{file_tag}.parquet"),
                           row_group_size=1 << 20, use_dictionary=True,
                           compression="zstd")
            rows += int(tbl.num_rows)
        return rows

    def _hive_create(self, name: str, batches, pnames,
                     if_not_exists: bool = False) -> int:
        import json
        import shutil

        if self._table_exists(name):
            if if_not_exists:
                return 0
            raise ValueError(f"table already exists: {name}")
        names, types, data = _batches_to_host(batches)
        if any(isinstance(t, (ArrayType, MapType)) for t in types):
            raise NotImplementedError(
                "parquet writer does not support ARRAY/MAP columns yet")
        self._hive_validate(pnames, names, types)
        staging = self.hive_dir(name, staging=True)
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        groups = self._hive_group_rows(pnames, data)
        rows = self._hive_write_groups(staging, pnames, names, types, data,
                                       groups, "0")
        tmap = dict(zip(names, types))
        with open(os.path.join(staging, "_meta.json"), "w") as f:
            json.dump({"partitioned_by": [[c, tmap[c].name] for c in pnames],
                       # full schema: survives a zero-row CTAS (no files)
                       "columns": [[c, tmap[c].name] for c in names]}, f)
        os.rename(staging, self.hive_dir(name))
        self._invalidate_table(name)
        return rows

    def _hive_insert(self, name: str, batches) -> int:
        import uuid

        t = self._load(name)
        pnames = [c for c, _ in t.hive["pcols"]]
        names, types, data = _batches_to_host(batches)
        existing = [(c.name, c.type.name) for c in t.handle.columns]
        if [(c, tt.name) for c, tt in zip(names, types)] != existing:
            raise ValueError(
                f"INSERT schema mismatch for partitioned table {name}: "
                f"{[(c, tt.name) for c, tt in zip(names, types)]} vs "
                f"{existing}")
        groups = self._hive_group_rows(pnames, data)
        rows = self._hive_write_groups(self.hive_dir(name), pnames, names,
                                       types, data, groups, uuid.uuid4().hex)
        os.utime(self.hive_dir(name))  # bust _check_fresh versions
        self._invalidate_table(name)
        return rows

    def _load(self, name: str) -> _PqTable:
        self._check_fresh(name)
        if name in self._tables:
            return self._tables[name]
        path = os.path.join(self.directory, f"{name}.parquet")
        if not os.path.exists(path):
            if os.path.isdir(self.hive_dir(name)):
                return self._load_hive(name)
            if os.path.isdir(self.buckets_dir(name)):
                return self._load_buckets(name)
            parts = self._part_files(name)
            if parts:
                return self._load_parts(name, parts)
            raise KeyError(f"table not found: {name}")
        f = pq.ParquetFile(path)
        schema = f.schema_arrow
        cols = []
        dicts: Dict[str, Dictionary] = {}
        nested: Dict[str, tuple] = {}  # dotted name -> (parent, leaf)
        name_to_idx = {schema.field(i).name: i for i in range(len(schema.names))}
        for field in schema:
            if pa.types.is_struct(field.type):
                # ROW columns flatten to dotted leaf columns — the
                # spi/type/RowType surface over parquet structs (analysis
                # resolves r.f to the flattened name; see Scope.resolve)
                for sub in field.type:
                    leaf_name = f"{field.name}.{sub.name}"
                    st = _arrow_to_sql(sub)
                    nested[leaf_name] = (field.name, sub.name)
                    if st.is_string:
                        vocab = set()
                        for rg in range(f.num_row_groups):
                            col = f.read_row_group(
                                rg, columns=[field.name]).column(0)
                            vals = col.combine_chunks().field(sub.name)
                            vocab.update(_distinct_values(vals))
                        d = Dictionary(np.array(
                            sorted(v for v in vocab if v is not None)))
                        dicts[leaf_name] = d
                        cols.append(ColumnInfo(leaf_name, st, d))
                    else:
                        cols.append(ColumnInfo(leaf_name, st, None))
                continue
            t = _arrow_to_sql(field)
            if t.is_string:
                # global per-column dictionary: union of per-row-group
                # dictionaries, built once at open (order-preserving)
                vocab = set()
                for rg in range(f.num_row_groups):
                    col = f.read_row_group(rg, columns=[field.name]).column(0)
                    for chunk in col.chunks:
                        vocab.update(_distinct_values(chunk))
                d = Dictionary(np.array(sorted(v for v in vocab if v is not None)))
                dicts[field.name] = d
                cols.append(ColumnInfo(
                    field.name, t, d,
                    _footer_stats(f, name_to_idx[field.name], t,
                                  ndv=float(len(d)))))
            else:
                cols.append(ColumnInfo(
                    field.name, t, None,
                    _footer_stats(f, name_to_idx[field.name], t)))
        handle = TableHandle(self.name, name, cols, row_count=float(f.metadata.num_rows))
        t = _PqTable(path, handle, dicts, f.metadata.num_rows, f.num_row_groups,
                     version=self._file_version(path), nested=nested)
        self._tables[name] = t
        return t

    def get_table(self, name: str) -> TableHandle:
        return self._load(name).handle

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        """Scan-parallelism units: row groups (like ORC stripes), subdivided
        when the engine wants finer batches than a row group. Split.part is
        (row_group, sub_index, sub_count)."""
        t = self._load(handle.name)
        target = max(1, -(-t.num_rows // max(desired, 1)))
        out = []
        if t.part_map is not None:
            meta_cache: Dict[str, object] = {}
            for vrg, (fpath, rg) in enumerate(t.part_map):
                md = meta_cache.get(fpath)
                if md is None:
                    md = meta_cache[fpath] = pq.ParquetFile(fpath).metadata
                rg_rows = md.row_group(rg).num_rows
                subs = max(1, -(-rg_rows // target))
                bucket = (t.bucket_map[vrg] if t.bucket_map is not None
                          else None)
                for s in range(subs):
                    out.append(Split(handle.name, (vrg, s, subs),
                                     t.num_row_groups, bucket=bucket))
            return out
        f = pq.ParquetFile(t.path)
        for rg in range(t.num_row_groups):
            rg_rows = f.metadata.row_group(rg).num_rows
            subs = max(1, -(-rg_rows // target))
            for s in range(subs):
                out.append(Split(handle.name, (rg, s, subs), t.num_row_groups))
        return out

    def prune_splits(self, handle: TableHandle, splits: Sequence[Split],
                     min_max: Dict[str, Tuple[object, object]]) -> List[Split]:
        """Row-group pruning with column min/max constraints (the coarse
        TupleDomain pushdown of the selective reader)."""
        t = self._load(handle.name)
        files: Dict[str, object] = {}

        def rg_meta(rg_idx: int):
            if t.part_map is not None:
                fpath, rg = t.part_map[rg_idx]
            else:
                fpath, rg = t.path, rg_idx
            f = files.get(fpath)
            if f is None:
                f = files[fpath] = pq.ParquetFile(fpath)
            return f, f.metadata.row_group(rg)

        f0, _ = rg_meta(0) if (t.num_row_groups or t.part_map) else (None, None)
        if f0 is None:
            return list(splits)
        keep = []
        name_to_idx = {f0.schema_arrow.field(i).name: i
                       for i in range(len(f0.schema_arrow.names))}
        pidx = ({c: i for i, (c, _) in enumerate(t.hive["pcols"])}
                if t.hive is not None else {})

        def partition_pruned(rg_idx) -> bool:
            """Hive partition pruning: directory values against the
            constraint, zero file IO (HivePartitionManager analog).
            Constraint values arrive in the storage domain (dates as
            datetime.date) — convert the stored engine value to match."""
            import datetime

            pvals = t.hive["pvals"][rg_idx]
            for col, (lo, hi) in min_max.items():
                i = pidx.get(col)
                if i is None:
                    continue
                v = pvals[i]
                if v is None:
                    # NULL partition never matches a range constraint
                    return lo is not None or hi is not None
                if t.hive["pcols"][i][1] is DATE:
                    v = datetime.date.fromordinal(719163 + int(v))
                if lo is not None and v < lo:
                    return True
                if hi is not None and v > hi:
                    return True
            return False

        for s in splits:
            rg_idx = s.part[0] if isinstance(s.part, tuple) else s.part
            if pidx and partition_pruned(rg_idx):
                continue
            _, rg = rg_meta(rg_idx)
            ok = True
            for col, (lo, hi) in min_max.items():
                if col not in name_to_idx:
                    continue
                st = rg.column(name_to_idx[col]).statistics
                if st is None or not st.has_min_max:
                    continue
                try:
                    if lo is not None and st.max is not None and st.max < lo:
                        ok = False
                        break
                    if hi is not None and st.min is not None and st.min > hi:
                        ok = False
                        break
                except TypeError:
                    # constraint/statistic domain mismatch (e.g. a string
                    # bound against numeric stats) — keep the split
                    continue
            if ok:
                keep.append(s)
        return keep

    def split_stats(self, handle: TableHandle, split: Split):
        """Row-group statistics as a storage-domain SplitStats (the
        generic face of the footer stats `prune_splits` reads natively —
        used by tests and cross-connector tooling)."""
        t = self._load(handle.name)
        rg_idx = split.part[0] if isinstance(split.part, tuple) else split.part
        if t.part_map is not None:
            fpath, rg = t.part_map[rg_idx]
        elif t.num_row_groups:
            fpath, rg = t.path, rg_idx
        else:
            return None
        md = pq.ParquetFile(fpath).metadata.row_group(rg)
        cols = {}
        for i in range(md.num_columns):
            cmeta = md.column(i)
            st = cmeta.statistics
            if st is None:
                continue
            mn, mx = ((st.min, st.max) if st.has_min_max else (None, None))
            cols[cmeta.path_in_schema] = (mn, mx, st.null_count)
        return SplitStats(md.num_rows, cols)

    def read_split_selective(self, split: Split, columns: Sequence[str],
                             filters, device: torch.device,
                             capacity: Optional[int] = None,
                             adaptive=None, counters=None) -> Batch:
        """Predicate-during-decode read: filter columns decode first, the
        cascade shrinks the selection vector, payload columns decode (and
        upload) only for survivors. Bypasses the device split cache —
        output depends on the filter set, like read_split_constrained."""
        self._check_fresh(split.table)
        t = self._load(split.table)
        if isinstance(split.part, tuple):
            rg, sub, sub_count = split.part
        else:
            rg, sub, sub_count = split.part, 0, 1

        def _decode(cols):
            return self._decoded_columns(t, rg, sub, sub_count, cols)

        return selective_read(_decode, t.handle, columns, filters, device,
                              capacity=capacity, dicts=t.dicts,
                              adaptive=adaptive, counters=counters)

    # -- write path (reference: HivePageSink writing ORC/parquet files;
    # CTAS = CreateTableTask + TableWriter chain) -------------------------

    def _invalidate_table(self, name: str):
        self._tables.pop(name, None)
        self.invalidate_cache(name)
        with self._host_cache_lock:
            # t.path is the single file OR the parts/hive directory
            paths = {os.path.join(self.directory, f"{name}.parquet"),
                     self.parts_dir(name), self.hive_dir(name)}
            for k in [k for k in self._host_cache if k[0] in paths]:
                _, nbytes = self._host_cache.pop(k)
                self._host_cache_used -= nbytes

    def create_table_from(self, name: str, batches, if_not_exists: bool = False,
                          properties: Optional[dict] = None) -> int:
        if properties:
            props = dict(properties)
            pby = props.pop("partitioned_by", None)
            if props:
                raise ValueError(
                    f"unknown table properties: {sorted(props)}")
            if pby:
                if isinstance(pby, str):
                    pby = [pby]
                return self._hive_create(name, batches, list(pby),
                                         if_not_exists=if_not_exists)
        path = os.path.join(self.directory, f"{name}.parquet")
        if os.path.exists(path):
            if if_not_exists:
                return 0
            raise ValueError(f"table already exists: {name}")
        names, types, data = _batches_to_host(batches)
        if any(isinstance(t, (ArrayType, MapType)) for t in types):
            raise NotImplementedError(
                "parquet writer does not support ARRAY/MAP columns yet; "
                "CTAS structural results into the memory connector")
        plain = {c: v[0] for c, v in data.items()}
        validity = {c: v[1] for c, v in data.items() if v[1] is not None}
        his = {c: v[2] for c, v in data.items() if v[2] is not None}
        dicts = {c: v[3] for c, v in data.items() if v[3] is not None}
        arrays, schema = _to_arrow_columns(plain, dict(zip(names, types)),
                                           dicts, validity, his)
        tbl = pa.Table.from_arrays(arrays, schema=schema)
        try:
            pq.write_table(tbl, path + ".tmp", row_group_size=1 << 20,
                           use_dictionary=True, compression="zstd")
            os.replace(path + ".tmp", path)
        except BaseException:
            # all-or-nothing: a failed write must not leave staging junk
            try:
                os.remove(path + ".tmp")
            except OSError:
                pass
            raise
        self._invalidate_table(name)
        return int(tbl.num_rows)

    def insert_into(self, name: str, batches) -> int:
        """Append. Part-directory tables append a NEW part (no rewrite);
        single-file tables rewrite existing rows + new rows into a fresh
        file (parquet files are immutable)."""
        path = os.path.join(self.directory, f"{name}.parquet")
        if not os.path.exists(path):
            if os.path.isdir(self.hive_dir(name)):
                return self._hive_insert(name, batches)
            if os.path.isdir(self.parts_dir(name)):
                import uuid

                t = self._load(name)
                # schema check against the existing handle
                names, types, _ = _batches_to_host(batches)
                existing = [c.type.name for c in t.handle.columns]
                if [tt.name for tt in types] != existing:
                    raise ValueError(
                        f"INSERT schema mismatch: {[str(t) for t in types]}"
                        f" vs {existing}")
                n = self.write_part(name, f"ins-{uuid.uuid4().hex[:8]}",
                                    batches, staging=False)
                self._invalidate_table(name)
                return n
            raise KeyError(f"table not found: {name}")
        names, types, data = _batches_to_host(batches)
        if any(isinstance(t, (ArrayType, MapType)) for t in types):
            raise NotImplementedError(
                "parquet writer does not support ARRAY/MAP columns yet")
        existing = pq.read_table(path)
        target_names = list(existing.schema.names)
        if len(target_names) != len(names):
            raise ValueError(
                f"INSERT arity mismatch: {len(names)} columns vs "
                f"{len(target_names)} in {name}")
        # positional matching (INSERT ... SELECT semantics): i-th source
        # column feeds the i-th target column, logical types must agree
        for field, t in zip(existing.schema, types):
            et = _arrow_to_sql(field)
            if et.name != t.name:
                raise ValueError(
                    f"INSERT column {field.name} type mismatch: "
                    f"{t} vs {et}")
        plain, validity, his, dicts = {}, {}, {}, {}
        for src, tgt in zip(names, target_names):
            vals, valid, hi, d = data[src]
            plain[tgt] = vals
            if valid is not None:
                validity[tgt] = valid
            if hi is not None:
                his[tgt] = hi
            if d is not None:
                dicts[tgt] = d
        arrays, schema = _to_arrow_columns(plain, dict(zip(target_names, types)),
                                           dicts, validity, his)
        new_tbl = pa.Table.from_arrays(arrays, schema=schema)
        # unify schemas (dictionary value types etc.) then concatenate
        new_tbl = new_tbl.cast(existing.schema)
        merged = pa.concat_tables([existing, new_tbl])
        pq.write_table(merged, path + ".tmp", row_group_size=1 << 20,
                       use_dictionary=True, compression="zstd")
        os.replace(path + ".tmp", path)
        self._invalidate_table(name)
        return int(new_tbl.num_rows)

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        path = os.path.join(self.directory, f"{name}.parquet")
        if not os.path.exists(path):
            for d in (self.parts_dir(name), self.hive_dir(name)):
                if os.path.isdir(d):
                    import shutil

                    shutil.rmtree(d)
                    self._invalidate_table(name)
                    return
            if if_exists:
                return
            raise KeyError(f"table not found: {name}")
        os.remove(path)
        self._invalidate_table(name)

    def create_empty(self, name: str, cols, if_not_exists: bool = False):
        """CREATE TABLE name (schema): a zero-row file carrying the
        schema (decimal SQL types ride field metadata as usual)."""
        path = os.path.join(self.directory, f"{name}.parquet")
        if os.path.exists(path):
            if if_not_exists:
                return
            raise ValueError(f"table already exists: {name}")
        data = {c: np.zeros(0, dtype=t.dtype) for c, t in cols}
        arrays, schema = _to_arrow_columns(data, dict(cols), {})
        pq.write_table(pa.Table.from_arrays(arrays, schema=schema),
                       path + ".tmp")
        os.replace(path + ".tmp", path)
        self._invalidate_table(name)

    def truncate_table(self, name: str):
        t = self._load(name)
        if t.hive is not None:
            raise NotImplementedError(
                "TRUNCATE on hive-partitioned tables is not supported")
        cols = [(c.name, c.type) for c in t.handle.columns]
        self.drop_table(name)
        self.create_empty(name, cols)

    def replace_table_from(self, name: str, batches) -> int:
        t = self._load(name)  # existence check
        if t.hive is not None:
            raise NotImplementedError(
                "DELETE rewrite on hive-partitioned tables is not supported")
        self.drop_table(name)
        return self.create_table_from(name, batches)

    def read_split(self, split: Split, columns: Sequence[str],
                   device: torch.device,
                   capacity: Optional[int] = None) -> Batch:
        self._check_fresh(split.table)
        return super().read_split(split, columns, device, capacity)

    def _decoded_columns(self, t: _PqTable, rg: int, sub: int, sub_count: int,
                         columns: Sequence[str]):
        """Decode (or fetch from the host LRU) one split's engine-native
        numpy columns: {name: (values, validity_or_None)} plus row count."""
        key = (t.path, rg, sub, sub_count, tuple(columns))
        with self._host_cache_lock:
            hit = self._host_cache.get(key)
            if hit is not None:
                self._host_cache.move_to_end(key)
                return hit[0]
        vrg = rg
        if t.part_map is not None:
            # part-directory table: the virtual row-group index resolves
            # to (part file, row group within it)
            fpath, rg = t.part_map[rg]
            f = pq.ParquetFile(fpath)
        else:
            f = pq.ParquetFile(t.path)
        pset = ({c for c, _ in t.hive["pcols"]} if t.hive is not None
                else set())
        plain = [c for c in columns if c not in t.nested and c not in pset]
        parents = sorted({t.nested[c][0] for c in columns if c in t.nested})
        tbl = f.read_row_group(rg, columns=plain + parents)
        if t.nested:
            # flatten requested ROW leaves out of their struct columns
            arrays, fields = [], []
            for c in columns:
                if c in t.nested:
                    parent, leaf = t.nested[c]
                    sc = tbl.column(parent)
                    arr = (sc.combine_chunks() if isinstance(
                        sc, pa.ChunkedArray) else sc)
                    if isinstance(arr, pa.ChunkedArray):
                        arr = arr.combine_chunks()
                    arrays.append(arr.field(leaf))
                    fields.append(pa.field(c, arrays[-1].type))
                else:
                    arrays.append(tbl.column(c))
                    fields.append(pa.field(c, tbl.column(c).type))
            tbl = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
        rg_rows = f.metadata.row_group(rg).num_rows
        if sub_count > 1:
            per = -(-rg_rows // sub_count)
            tbl = tbl.slice(sub * per, per)
            n = max(0, min(per, rg_rows - sub * per))
        else:
            n = rg_rows
        out = {}
        nbytes = 0
        for name in columns:
            st = t.handle.column(name).type
            if name in pset:
                arr, valid, hi = self._hive_constant(t, vrg, name, st, n)
            else:
                arr, valid, hi = _decode_column(tbl.column(name), st,
                                                t.dicts.get(name))
            arr = np.ascontiguousarray(np.asarray(arr))
            out[name] = (arr, valid, hi)
            nbytes += arr.nbytes + (valid.nbytes if valid is not None else 0)
            nbytes += hi.nbytes if hi is not None else 0
        result = (out, n)
        if nbytes <= self.host_cache_bytes:
            with self._host_cache_lock:
                if key not in self._host_cache:
                    self._host_cache[key] = (result, nbytes)
                    self._host_cache_used += nbytes
                    while self._host_cache_used > self.host_cache_bytes:
                        _, (_, freed) = self._host_cache.popitem(last=False)
                        self._host_cache_used -= freed
        return result

    def _hive_constant(self, t: _PqTable, vrg: int, name: str, st: Type,
                       n: int):
        """Partition column for one split: a constant engine-native array
        from the directory value (HivePartitionKey → constant block)."""
        i = next(j for j, (c, _) in enumerate(t.hive["pcols"]) if c == name)
        v = t.hive["pvals"][vrg][i]
        if v is None:
            return (np.zeros(n, dtype=st.dtype), np.zeros(n, bool), None)
        if st.is_string:
            code = t.dicts[name].code_of(v)
            return (np.full(n, code, dtype=st.dtype), None, None)
        return (np.full(n, v, dtype=st.dtype), None, None)

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None) -> Batch:
        t = self._load(split.table)
        if isinstance(split.part, tuple):
            rg, sub, sub_count = split.part
        else:
            rg, sub, sub_count = split.part, 0, 1
        decoded, n = self._decoded_columns(t, rg, sub, sub_count, columns)
        cap = capacity or round_up_capacity(max(n, 1))
        return host_batch(columns, [t.handle.column(c).type for c in columns],
                          decoded, n, cap, t.dicts, device)


def _distinct_values(arr) -> list:
    """The distinct values of a string array, plain or dictionary-encoded
    (NULL among them when present)."""
    if pa.types.is_dictionary(arr.type):
        return arr.dictionary.to_pylist()
    return pc.unique(arr).to_pylist()


def _decode_column(col: pa.ChunkedArray, t: Type, d: Optional[Dictionary]):
    """Arrow column → engine-native numpy (codes / unscaled / day ints)."""
    combined = col.combine_chunks() if col.num_chunks > 1 else (
        col.chunk(0) if col.num_chunks == 1 else pa.array([], col.type)
    )
    valid = None
    if combined.null_count:
        valid = np.asarray(combined.is_valid())
    if t.is_string:
        if pa.types.is_dictionary(combined.type):
            # remap this row group's dictionary codes into the table-global
            # dictionary (pure integer gather — no string materialization)
            local_vocab = np.asarray(combined.dictionary.to_pylist(), dtype=object)
            remap = np.searchsorted(d.values, local_vocab.astype(str))
            idx = combined.indices.to_numpy(zero_copy_only=False)
            idx = np.where(idx < 0, 0, idx)
            arr = remap[idx].astype(np.int32)
        else:
            # each value's code in the table-global dictionary, -1 for NULL
            codes = pc.index_in(combined, value_set=pa.array(
                d.values.tolist(), combined.type))
            arr = codes.fill_null(-1).to_numpy(
                zero_copy_only=False).astype(np.int32)
        if valid is not None:
            arr = np.where(valid, arr, -1)
        return arr, valid, None
    if isinstance(t, DecimalType):
        if pa.types.is_decimal(combined.type):
            if t.is_long:
                # int128 unscaled values split into (hi, lo) limbs —
                # host-side python ints, exact (CTAS-of-sums scale data)
                import decimal as _dec

                pyvals = combined.to_pylist()
                lo = np.zeros(len(pyvals), np.int64)
                hi = np.zeros(len(pyvals), np.int64)
                with _dec.localcontext() as _ctx:
                    _ctx.prec = 50
                    for i, v in enumerate(pyvals):
                        if v is None:
                            continue
                        u = int(v.scaleb(t.scale))
                        if not (-(1 << 94) <= u < (1 << 94)):
                            raise ValueError(
                                f"decimal value {v} exceeds the engine's "
                                "two-limb (hi:int64, lo:32-bit) range")
                        lo[i] = u & 0xFFFFFFFF
                        hi[i] = u >> 32
                return (lo, valid, hi)
            arr = combined.cast(pa.decimal128(38, t.scale)).cast(pa.int64(), safe=False)
        else:
            arr = combined  # unscaled int64 storage
        return arr.to_numpy(zero_copy_only=False), valid, None
    if t is DATE:
        return combined.cast(pa.int32()).to_numpy(zero_copy_only=False), valid, None
    return combined.to_numpy(zero_copy_only=False), valid, None


def export_tpch(directory: str, sf: float = 1.0):
    """Materialize the TPC-H dataset to parquet (the dbgen→warehouse path):
    the memory connector's tables, from the same generator streams."""
    from presto_tpu_torch.catalog.tpch import TpchConnector

    os.makedirs(directory, exist_ok=True)
    conn = TpchConnector(sf)
    for tname in conn.table_names():
        conn._ensure(tname)
        mt = conn.tables[tname]
        write_table(
            os.path.join(directory, f"{tname}.parquet"),
            mt.arrays,
            mt.types,
            mt.dicts,
        )


def _to_arrow_columns(data, types, dicts, validity=None, his=None):
    """Engine-native columns → arrow arrays. `validity` maps column name →
    bool mask (False = SQL NULL); `his` maps name → long-decimal hi limbs
    (written as arrow decimal128(38, s) — the only physical type that
    preserves int128 exactness)."""
    arrays, fields = [], []
    for name, arr in data.items():
        t = types[name]
        valid = (validity or {}).get(name)
        mask = None if valid is None else ~np.asarray(valid)
        hi = (his or {}).get(name)
        meta = None
        if isinstance(t, DecimalType) and (hi is not None or t.is_long):
            import decimal as _dec

            lo = np.asarray(arr).astype(object)
            h = (np.zeros(len(lo), np.int64) if hi is None
                 else np.asarray(hi)).astype(object)
            with _dec.localcontext() as _ctx:
                _ctx.prec = 50  # int128 values reach 39 digits; never round
                vals = [
                    None if (mask is not None and mask[i])
                    else _dec.Decimal((int(h[i]) << 32) + int(lo[i])).scaleb(-t.scale)
                    for i in range(len(lo))
                ]
            at = pa.decimal128(38, t.scale)
            a = pa.array(vals, at)
            arrays.append(a)
            fields.append(pa.field(name, at))
            continue
        at = _sql_to_arrow(t)
        if t.is_string:
            d = dicts.get(name)
            if d is None:
                d = Dictionary(np.array([], dtype=object))  # empty/all-NULL column
            codes = np.asarray(arr).astype(np.int32)
            if mask is not None:
                # arrow dictionary arrays null via the index mask
                idx = pa.array(np.where(mask, 0, codes), pa.int32(), mask=mask)
            else:
                idx = pa.array(codes, pa.int32())
            vocab = pa.array([str(v) for v in d.values], pa.string())
            a = pa.DictionaryArray.from_arrays(idx, vocab)
        elif isinstance(t, DecimalType):
            a = pa.array(np.asarray(arr).astype(np.int64), pa.int64(), mask=mask)
            meta = {_DECIMAL_META: f"{t.precision},{t.scale}".encode()}
        elif t is DATE:
            a = pa.array(np.asarray(arr).astype(np.int32), pa.int32(),
                         mask=mask).cast(pa.date32())
        else:
            a = pa.array(np.asarray(arr), at, mask=mask)
        arrays.append(a)
        fields.append(pa.field(name, at, metadata=meta))
    return arrays, pa.schema(fields)


def export_tpcds_chunked(directory: str, sf: float,
                         rows_per_chunk: int = 30_000_000,
                         row_group_rows: int = 1 << 20,
                         log=None):
    """Stream-generate TPC-DS to parquet with bounded memory (dimensions
    whole, store_sales/store_returns chunked — see export_tpch_chunked)."""
    from presto_tpu_torch.catalog.tpcds import (
        _D72,
        TpcdsConnector,
        TpcdsGenerator,
    )

    os.makedirs(directory, exist_ok=True)
    conn = TpcdsConnector(sf)
    gen = TpcdsGenerator(sf)
    dims = [t for t in conn.table_names()
            if t not in ("store_sales", "store_returns")]
    for tname in dims:
        path = os.path.join(directory, f"{tname}.parquet")
        if os.path.exists(path):
            continue
        conn._ensure(tname)
        mt = conn.tables[tname]
        write_table(path + ".tmp", mt.arrays, mt.types, mt.dicts,
                    row_group_rows=row_group_rows)
        os.replace(path + ".tmp", path)  # atomic: no truncated reuse
        if log:
            log(f"wrote {tname} ({mt.num_rows} rows)")
        del conn.tables[tname]

    s_path = os.path.join(directory, "store_sales.parquet")
    r_path = os.path.join(directory, "store_returns.parquet")
    if os.path.exists(s_path) and os.path.exists(r_path):
        return

    def types_fn(table, data):
        out = {}
        for c, v in data.items():
            if isinstance(v, tuple) and len(v) == 2 and v[0] == "raw72":
                out[c] = _D72
            elif isinstance(v, tuple):
                out[c] = VARCHAR
            elif isinstance(v, np.ndarray) and v.dtype == object:
                out[c] = VARCHAR
            else:
                out[c] = BIGINT
        return out

    def unwrap(data):
        # ("raw72", arr) markers carry plain unscaled arrays for the writer
        return {c: (v[1] if isinstance(v, tuple) and len(v) == 2
                    and v[0] == "raw72" else v)
                for c, v in data.items()}

    n = gen.n_store_sales
    chunk = min(rows_per_chunk, n)
    s_writer = r_writer = None
    done = False
    try:
        for start_row in range(0, n, chunk):
            cnt = min(chunk, n - start_row)
            sales, returns = gen.store_sales_chunk(start_row, cnt)
            for (path, raw, is_sales) in ((s_path, sales, True),
                                          (r_path, returns, False)):
                types = types_fn("x", raw)
                data = unwrap(raw)
                arrays, schema = _to_arrow_columns(data, types, {})
                tbl = pa.Table.from_arrays(arrays, schema=schema)
                if is_sales:
                    if s_writer is None:
                        s_writer = pq.ParquetWriter(path + ".tmp", schema,
                                                    compression="zstd")
                    s_writer.write_table(tbl, row_group_size=row_group_rows)
                else:
                    if r_writer is None:
                        r_writer = pq.ParquetWriter(path + ".tmp", schema,
                                                    compression="zstd")
                    r_writer.write_table(tbl, row_group_size=row_group_rows)
            if log:
                log(f"store_sales chunk {start_row}..{start_row + cnt} of {n}")
        done = True
    finally:
        if s_writer is not None:
            s_writer.close()
        if r_writer is not None:
            r_writer.close()
        if done and s_writer is not None:
            # rename only after BOTH writers closed cleanly — an
            # interrupted export leaves .tmp files, never a silently
            # truncated dataset future rounds would reuse
            os.replace(s_path + ".tmp", s_path)
            os.replace(r_path + ".tmp", r_path)


def export_tpch_chunked(directory: str, sf: float,
                        orders_per_chunk: int = 7_500_000,
                        row_group_rows: int = 1 << 20,
                        log=None):
    """Stream-generate TPC-H to parquet with bounded memory.

    Small tables materialize whole; orders/lineitem generate in
    `orders_per_chunk` chunks appended as row groups (the dbgen -C/-S
    chunking analog), so SF100 (600M lineitems) exports without ever
    holding the table in RAM. Skips tables whose files already exist
    (re-runs are incremental)."""
    from presto_tpu_torch.catalog.tpch import (
        TpchConnector,
        TpchGenerator,
        _column_types,
    )

    os.makedirs(directory, exist_ok=True)
    conn = TpchConnector(sf)
    gen = TpchGenerator(sf)
    for tname in ("region", "nation", "supplier", "customer", "part", "partsupp"):
        path = os.path.join(directory, f"{tname}.parquet")
        if os.path.exists(path):
            continue
        conn._ensure(tname)
        mt = conn.tables[tname]
        write_table(path + ".tmp", mt.arrays, mt.types, mt.dicts,
                    row_group_rows=row_group_rows)
        os.replace(path + ".tmp", path)  # atomic: no truncated reuse
        if log:
            log(f"wrote {tname} ({mt.num_rows} rows)")
        del conn.tables[tname]

    o_path = os.path.join(directory, "orders.parquet")
    l_path = os.path.join(directory, "lineitem.parquet")
    if os.path.exists(o_path) and os.path.exists(l_path):
        return
    n_orders = gen.n_orders
    chunk = min(orders_per_chunk, n_orders)
    o_writer = l_writer = None
    done = False
    try:
        for start in range(0, n_orders, chunk):
            cnt = min(chunk, n_orders - start)
            orders, lineitem = gen.orders_lineitem_chunk(start, cnt)
            for (table, data) in (("orders", orders), ("lineitem", lineitem)):
                plain, dicts = {}, {}
                types = _column_types(table, data)
                for cname, v in data.items():
                    if isinstance(v, tuple):
                        dicts[cname] = v[0]
                        plain[cname] = v[1]
                    else:
                        plain[cname] = v
                arrays, schema = _to_arrow_columns(plain, types, dicts)
                tbl = pa.Table.from_arrays(arrays, schema=schema)
                if table == "orders":
                    if o_writer is None:
                        o_writer = pq.ParquetWriter(o_path + ".tmp", schema,
                                                    compression="zstd")
                    o_writer.write_table(tbl, row_group_size=row_group_rows)
                else:
                    if l_writer is None:
                        l_writer = pq.ParquetWriter(l_path + ".tmp", schema,
                                                    compression="zstd")
                    l_writer.write_table(tbl, row_group_size=row_group_rows)
            if log:
                log(f"orders/lineitem chunk {start}..{start + cnt} of {n_orders}")
        done = True
    finally:
        if o_writer is not None:
            o_writer.close()
        if l_writer is not None:
            l_writer.close()
        if done and o_writer is not None:
            # rename only after BOTH writers closed cleanly (see
            # export_tpcds_chunked — interrupted exports must not be
            # reused as complete datasets)
            os.replace(o_path + ".tmp", o_path)
            os.replace(l_path + ".tmp", l_path)
