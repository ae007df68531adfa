"""Spilling: hash-partitioned batch spill files.

The JAX package's spill plane (reference: spiller/ — FileSingleStreamSpiller
and GenericPartitioningSpiller — driving SpillableHashAggregationBuilder
and HashBuilderOperator's SPILLING_INPUT state, plus the dynamic hybrid
hash join of arXiv 2112.02480: partition counts are estimates, so a
partition grows mid-build and an oversized spilled partition splits again
at replay instead of failing).

A spilled batch leaves the device with one `.cpu()` a plane and is written
as one crc32-guarded page of the serde format. Rows route to partitions by
a content hash of their keys on the host, bit for bit the JAX package's
(`np_row_hash`), so the same rows land in the same partitions. A partition
past its byte budget splits by the NEXT hash bits, (hash // divisor) %
fanout, so a split uses fresh entropy and both sides of a join stay
co-partitioned while they split on the same schedule.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.serde import deserialize_batch, serialize_batch

# Process-monotonic spill-file ids: id(self) is recycled after GC, so two
# spillers alive at different times could collide on one path.
_file_counter = itertools.count(1)


def next_file_id() -> int:
    return next(_file_counter)


class SpillCorruption(RuntimeError):
    """A spilled page failed its crc32 or framing check on replay
    (SPILL_CORRUPTION)."""

    def __init__(self, path: str, page: int, reason: str):
        super().__init__(
            f"spill file corruption in {path!r} at page {page}: {reason}")
        self.path = path
        self.page = page
        self.reason = reason


class SpillLimitExceeded(RuntimeError):
    """Spill could not converge within its limits (SPILL_LIMIT_EXCEEDED):
    the spill directory's byte budget is exhausted, or recursive
    repartitioning hit its depth bound without shrinking a partition
    (identical keys share every hash bit and never split)."""


_PAGE_HEADER = 12  # 8-byte little-endian length + 4-byte crc32


def host_batch(b: Batch) -> Batch:
    """`b` with every plane on the host (one copy a plane; a no-op for a
    batch already there)."""
    if b.live.device.type == "cpu":
        return b
    return Batch(b.names, b.types, [c.map_rows(lambda p: p.cpu())
                                    for c in b.columns],
                 b.live.cpu(), b.dicts)


class SpillFile:
    """Append-only page stream on disk (FileSingleStreamSpiller analog).

    Page frame: [8B length][4B crc32(payload)][payload]; the crc is checked
    on every read, so bit-rot or a torn write raises SpillCorruption."""

    def __init__(self, path: str, manager: Optional["SpillManager"] = None):
        self.path = path
        self.manager = manager
        self._f = open(path, "wb")
        self.pages = 0
        self.bytes = 0
        self.rows = 0
        self._closed = False

    def append(self, batch: Batch, rows: Optional[int] = None):
        page = serialize_batch(batch)
        n = len(page) + _PAGE_HEADER
        if self.manager is not None:
            self.manager.charge(n)
        self._f.write(len(page).to_bytes(8, "little"))
        self._f.write(zlib.crc32(page).to_bytes(4, "little"))
        self._f.write(page)
        self.pages += 1
        self.bytes += n
        if rows is None:
            rows = int(batch.live.sum())
        self.rows += rows

    def finish_writing(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def read(self, device: Union[str, torch.device] = "cpu"
             ) -> Iterator[Batch]:
        """The pages in order, each a Batch on `device`."""
        self.finish_writing()
        if self.pages == 0:
            return
        with open(self.path, "rb") as f:
            page = 0
            while True:
                head = f.read(8)
                if len(head) == 0:
                    return
                if len(head) < 8:
                    raise SpillCorruption(self.path, page,
                                          "truncated page header")
                n = int.from_bytes(head, "little")
                crc_raw = f.read(4)
                if len(crc_raw) < 4:
                    raise SpillCorruption(self.path, page, "truncated crc")
                payload = f.read(n)
                if len(payload) < n:
                    raise SpillCorruption(
                        self.path, page,
                        f"truncated page: want {n} bytes, got {len(payload)}")
                if zlib.crc32(payload) != int.from_bytes(crc_raw, "little"):
                    raise SpillCorruption(self.path, page, "crc32 mismatch")
                yield deserialize_batch(payload, device=device)
                page += 1

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.finish_writing()
        if self.manager is not None:
            self.manager.discharge(self.bytes)
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _strhash_lut(d) -> np.ndarray:
    """code+1-indexed table of string-content hashes (slot 0 = NULL)."""
    return d.content_hash_lut()


def np_row_hash(cols) -> np.ndarray:
    """The canonical per-row content hash over host arrays; `cols` is a
    list of (values, dictionary|None, validity|None). String keys hash by
    content through their dictionary's table, not by code: the two sides
    of a spilled join may be coded against different dictionaries."""
    n = len(cols[0][0])
    h = np.zeros(n, dtype=np.uint64)
    for vals, d, validity in cols:
        a = np.asarray(vals)
        if a.dtype.kind == "f":
            # float keys hash by their canonical bit pattern (-0.0 and NaN
            # canonicalized so equal groups share a bucket)
            a = a.astype(np.float64)
            a = np.where(a == 0.0, np.float64(0.0), a)
            a = np.where(np.isnan(a), np.float64("nan"), a)
            v = a.view(np.int64)
        else:
            v = a.astype(np.int64)
        if d is not None:
            v = _strhash_lut(d)[v + 1]
        if validity is not None:
            v = np.where(np.asarray(validity), v, np.int64(-0x61c88647))
        h = (h * np.uint64(0x9E3779B185EBCA87)) ^ v.astype(np.uint64)
        h = h ^ (h >> np.uint64(31))
    return h


def _est_row_bytes(batch: Batch) -> int:
    """Per-row device bytes of a batch's schema, for replay budgets: rows
    x width converges under splitting, where page bytes (which carry each
    string dictionary whole) would not."""
    w = 0
    for c in batch.columns:
        for plane in c.planes():
            if plane is not None:
                w += plane.element_size()
    return max(1, w)


def np_bucket_ids(cols, n_buckets: int, divisor: int = 1) -> np.ndarray:
    """Row -> bucket id over host arrays, (hash // divisor) % n_buckets:
    `divisor` (the product of the fanouts above a sub-partition) consumes
    the hash bits already spent, so recursive repartitioning splits on
    fresh bits."""
    h = np_row_hash(cols)
    if divisor > 1:
        h = h // np.uint64(divisor)
    return (h % np.uint64(n_buckets)).astype(np.int64)


class PartitioningSpiller:
    """Routes batch rows to per-partition spill files by hash(keys)
    (GenericPartitioningSpiller analog), with dynamic hybrid-hash growth:
    a partition whose rows pass `partition_budget_bytes` splits by the
    next hash bits into a child spiller mid-build, and a replay can force
    the same split (`grow_partition`). Leaves of the resulting tree are
    the units of replay (`leaf_items`)."""

    def __init__(self, spill_dir: str, key_names: Sequence[str],
                 n_partitions: int, tag: str = "spill",
                 divisor: int = 1, depth: int = 0,
                 manager: Optional["SpillManager"] = None,
                 partition_budget_bytes: Optional[int] = None,
                 max_depth: int = 0,
                 on_grow: Optional[Callable[["PartitioningSpiller", int],
                                            None]] = None):
        self.spill_dir = spill_dir
        self.key_names = tuple(key_names)
        self.n_partitions = n_partitions
        self.tag = tag
        self.divisor = divisor
        self.depth = depth
        self.manager = manager
        self.partition_budget_bytes = partition_budget_bytes
        self.max_depth = max_depth
        self.on_grow = on_grow
        # per-row device width, from the first spilled batch; children
        # inherit it
        self._row_width: Optional[int] = None
        self.children: Dict[int, "PartitioningSpiller"] = {}
        self.files: List[SpillFile] = [
            SpillFile(os.path.join(
                spill_dir, f"{tag}-p{p}-{next_file_id()}.bin"),
                manager=manager)
            for p in range(n_partitions)
        ]

    def _partition_ids(self, hb: Batch) -> np.ndarray:
        return np_bucket_ids(
            [(hb.column(k).values.numpy(), hb.dicts.get(k),
              None if hb.column(k).validity is None
              else hb.column(k).validity.numpy())
             for k in self.key_names],
            self.n_partitions, divisor=self.divisor,
        )

    def spill(self, batch: Batch):
        if self._row_width is None:
            self._row_width = _est_row_bytes(batch)
        hb = host_batch(batch)
        pid = self._partition_ids(hb)
        live = hb.live.numpy()
        for p in range(self.n_partitions):
            mask = live & (pid == p)
            if not mask.any():
                continue
            sub = hb.with_live(torch.from_numpy(mask))
            child = self.children.get(p)
            if child is not None:
                child.spill(sub)
                continue
            self.files[p].append(sub, rows=int(mask.sum()))
            # dynamic growth: the partition passed its replay budget
            # mid-build; split it by the next hash bits now
            if (self.partition_budget_bytes is not None
                    and self.depth < self.max_depth
                    and self.files[p].rows * self._row_width
                    > self.partition_budget_bytes):
                self.grow_partition(p)

    def grow_partition(self, p: int,
                       fanout: Optional[int] = None) -> "PartitioningSpiller":
        """Split partition p by the next hash bits into a child spiller:
        its file re-partitions into `fanout` sub-files and later rows of p
        flow to the child. Returns the child (an existing one as is)."""
        child = self.children.get(p)
        if child is not None:
            return child
        fanout = fanout or self.n_partitions
        child = PartitioningSpiller(
            self.spill_dir, self.key_names, fanout,
            tag=f"{self.tag}-p{p}",
            divisor=self.divisor * self.n_partitions,
            depth=self.depth + 1, manager=self.manager,
            partition_budget_bytes=self.partition_budget_bytes,
            max_depth=self.max_depth, on_grow=self.on_grow)
        child._row_width = self._row_width
        self.children[p] = child
        for b in self.files[p].read():
            child.spill(b)
        self.files[p].close()
        if self.on_grow is not None:
            self.on_grow(child, p)
        return child

    def align_to(self, other: "PartitioningSpiller"):
        """Mirror `other`'s split tree onto this spiller (same fanouts), so
        a join's build and probe spillers expose identical leaf sets."""
        for p, oc in other.children.items():
            child = self.children.get(p)
            if child is None:
                child = self.grow_partition(p, fanout=oc.n_partitions)
            child.align_to(oc)

    def read_partition(self, p: int, device: Union[str, torch.device] = "cpu"
                       ) -> Iterator[Batch]:
        child = self.children.get(p)
        if child is not None:
            for q in range(child.n_partitions):
                yield from child.read_partition(q, device)
            return
        yield from self.files[p].read(device)

    def partition_rows(self, p: int) -> int:
        child = self.children.get(p)
        if child is not None:
            return sum(child.partition_rows(q)
                       for q in range(child.n_partitions))
        return self.files[p].rows

    def partition_est_bytes(self, p: int) -> int:
        """Estimated device bytes of replaying partition p (rows x schema
        row width), what replay budgets compare against."""
        return self.partition_rows(p) * (self._row_width or 0)

    def leaf_items(self) -> Iterator[tuple]:
        """Depth-first (spiller, partition) walk of the replay units."""
        for p in range(self.n_partitions):
            child = self.children.get(p)
            if child is not None:
                yield from child.leaf_items()
            else:
                yield self, p

    @property
    def spilled_bytes(self) -> int:
        return (sum(f.bytes for f in self.files)
                + sum(c.spilled_bytes for c in self.children.values()))

    @property
    def spilled_rows(self) -> int:
        return (sum(f.rows for f in self.files)
                + sum(c.spilled_rows for c in self.children.values()))

    def close(self):
        for f in self.files:
            f.close()
        for c in self.children.values():
            c.close()


class SpillManager:
    """Factory and accounting for a query's spill directory
    (SpillSpaceTracker analog). `budget_bytes` caps the directory's live
    bytes: a write that would cross it fails with SpillLimitExceeded. With
    no directory given, one is made under the temporary directory at the
    first spill (removed when the manager is collected)."""

    def __init__(self, spill_dir: Optional[str] = None,
                 budget_bytes: Optional[int] = None):
        self._dir = spill_dir
        self._tmp = None
        self._lock = threading.Lock()
        self.budget_bytes = budget_bytes
        self.in_use_bytes = 0  # live (unclosed) spill-file bytes

    @property
    def dir(self) -> str:
        with self._lock:
            if self._dir is None:
                self._tmp = tempfile.TemporaryDirectory(
                    prefix="presto-tpu-torch-spill-")
                self._dir = self._tmp.name
            return self._dir

    def spill_file(self, tag: str = "spill") -> SpillFile:
        """A single uniquely named page stream charged to this manager."""
        return SpillFile(
            os.path.join(self.dir, f"{tag}-{next_file_id()}.bin"),
            manager=self)

    def partitioning_spiller(self, key_names: Sequence[str], n_partitions: int,
                             tag: str = "spill",
                             partition_budget_bytes: Optional[int] = None,
                             max_depth: int = 0,
                             on_grow=None) -> PartitioningSpiller:
        return PartitioningSpiller(
            self.dir, key_names, n_partitions, tag, manager=self,
            partition_budget_bytes=partition_budget_bytes,
            max_depth=max_depth, on_grow=on_grow)

    def charge(self, bytes_: int):
        with self._lock:
            if (self.budget_bytes is not None
                    and self.in_use_bytes + bytes_ > self.budget_bytes):
                raise SpillLimitExceeded(
                    f"spill directory byte budget exceeded: "
                    f"{self.in_use_bytes} in use + {bytes_} requested > "
                    f"{self.budget_bytes} budget")
            self.in_use_bytes += bytes_

    def discharge(self, bytes_: int):
        with self._lock:
            self.in_use_bytes = max(0, self.in_use_bytes - bytes_)
