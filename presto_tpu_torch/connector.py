"""Connector SPI — the plugin boundary between engine and data sources.

Analog of presto-spi's connector surface (spi/connector/ConnectorMetadata.java,
ConnectorSplitManager, ConnectorPageSourceProvider.java:24), reduced to the
read path: a Connector names tables, describes their schemas (including the
per-column string Dictionary, which is first-class metadata here), produces
Splits, and reads a Split into a Batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import Type


@dataclasses.dataclass
class ColumnStats:
    """Per-column statistics for the cost-based optimizer (reference:
    spi/statistics/ColumnStatistics — NDV, null fraction, range)."""

    ndv: Optional[float] = None            # distinct non-null values
    null_fraction: Optional[float] = None  # in [0, 1]
    min_value: Optional[float] = None      # numeric/date low (None: unknown)
    max_value: Optional[float] = None
    # equi-DEPTH histogram: tuple of bin edges (quantiles); each adjacent
    # pair holds an equal share of the rows. The reference models
    # distributions via NDV+range only; quantile edges make range
    # selectivities robust to skew (mass concentration moves the edges,
    # not the per-bin counts)
    histogram: Optional[tuple] = None


@dataclasses.dataclass
class ColumnInfo:
    name: str
    type: Type
    dictionary: Optional[Dictionary] = None
    stats: Optional[ColumnStats] = None


@dataclasses.dataclass
class TableHandle:
    catalog: str
    name: str
    columns: List[ColumnInfo]
    # statistics + constraints the planner uses (reference:
    # ConnectorMetadata.getTableStatistics / primary-key-ness is implicit in
    # Presto via hidden bucketing metadata; here it is first-class)
    row_count: Optional[float] = None
    primary_key: Optional[List[str]] = None
    # connector-bucketed partitioning (reference:
    # ConnectorNodePartitioningProvider / hive bucketed tables):
    # (key column names, bucket count) — rows are hash(keys) % count
    # co-partitioned on disk, so equal-bucketed joins skip the shuffle
    bucketing: Optional[tuple] = None

    def column(self, name: str) -> ColumnInfo:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


@dataclasses.dataclass
class Split:
    """A unit of scan parallelism (spi/ConnectorSplit). `part` indexes into
    the table's row partitioning; `total` is the partition count. `bucket`
    tags splits of bucketed tables with their bucket id (lifespan) so the
    scheduler can drive grouped execution (Lifespan.java:26-38)."""

    table: str
    part: int
    total: int
    bucket: Optional[int] = None


class ConnectorIndex:
    """Keyed-lookup capability on a table — the analog of the reference's
    spi `ConnectorIndex` resolved through `IndexManager` and driven by
    `operator/index/IndexLoader.java`: instead of scanning + hashing the
    whole table, the engine feeds probe-side key values and receives only
    the matching rows.

    `lookup` takes {key column: numpy array of probe values} (deduplicated
    by the caller; string keys arrive as decoded Python strings so the
    index never sees dictionary codes) and returns a Batch of `columns`
    containing every table row whose key combination appears in the
    input."""

    def lookup(self, keys: Dict[str, "np.ndarray"], columns: Sequence[str],
               capacity: Optional[int] = None) -> Batch:
        raise NotImplementedError


class Connector:
    name: str = ""

    def get_index(self, handle: "TableHandle",
                  key_columns: Sequence[str]) -> Optional[ConnectorIndex]:
        """An index over `key_columns`, or None (reference:
        ConnectorIndexProvider.getIndex — most connectors return none)."""
        return None

    def table_names(self) -> List[str]:
        raise NotImplementedError

    def get_table(self, name: str) -> TableHandle:
        raise NotImplementedError

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        raise NotImplementedError

    def read_split(
        self,
        split: Split,
        columns: Sequence[str],
        device,
        capacity: Optional[int] = None,
    ) -> Batch:
        raise NotImplementedError

    def split_stats(self, handle: TableHandle, split: Split):
        """Per-split min/max/null-count statistics (scan.pruning.SplitStats)
        in the STORAGE value domain, or None when the connector has no
        stats for this split. Drives the default `prune_splits` so
        eliminated splits are never opened (the reference's stripe/row-group
        skipping via TupleDomain + file statistics)."""
        return None

    def prune_splits(self, handle: TableHandle, splits: Sequence[Split],
                     min_max: Dict[str, tuple]) -> List[Split]:
        """Drop splits whose statistics prove no row can match `min_max`
        (storage-domain inclusive bounds). Connectors with a cheaper native
        path (parquet footers) override this wholesale; connectors without
        stats inherit a no-op via split_stats → None."""
        from presto_tpu_torch.scan.pruning import split_prunable

        keep = []
        for s in splits:
            st = self.split_stats(handle, s)
            if st is not None and split_prunable(st, min_max):
                continue
            keep.append(s)
        return keep

    # -- write path (reference: ConnectorMetadata.beginCreateTable/
    # beginInsert + ConnectorPageSink; connectors that stay read-only
    # simply inherit the failures) --------------------------------------

    def create_table_from(self, name: str, batches: Sequence[Batch],
                          if_not_exists: bool = False,
                          properties: Optional[dict] = None) -> int:
        raise NotImplementedError(
            f"connector {self.name!r} does not support CREATE TABLE")

    def insert_into(self, name: str, batches: Sequence[Batch]) -> int:
        raise NotImplementedError(
            f"connector {self.name!r} does not support INSERT")

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        raise NotImplementedError(
            f"connector {self.name!r} does not support DROP TABLE")


class Catalog:
    """Catalog/metadata facade (reference: metadata/MetadataManager.java +
    CatalogManager)."""

    def __init__(self):
        self.connectors: Dict[str, Connector] = {}
        self.default: Optional[str] = None
        # engine-level views: name -> stored query AST, expanded at plan
        # time like CTEs (reference: view definitions in connector
        # metadata; engine-level is the deliberate simplification)
        self.views: Dict[str, object] = {}

    def register(self, name: str, connector: Connector, default: bool = False):
        connector.name = name  # the registered name is authoritative
        self.connectors[name] = connector
        if default or self.default is None:
            self.default = name

    def connector_for(self, parts) -> tuple[Connector, str]:
        """Resolve a (possibly qualified) table name to (connector,
        table_name) WITHOUT requiring the table to exist (DDL targets)."""
        if len(parts) == 1:
            cname, tname = self.default, parts[0]
        else:
            cname, tname = parts[-2], parts[-1]
        if cname not in self.connectors:
            raise KeyError(f"unknown catalog {cname}")
        return self.connectors[cname], tname

    def resolve(self, parts) -> tuple[Connector, TableHandle]:
        conn, tname = self.connector_for(parts)
        return conn, conn.get_table(tname)
