"""Task output buffers — the producer side of the HTTP pull shuffle.

Reference: execution/buffer/OutputBuffer.java and its Partitioned/Broadcast
variants + ClientBuffer: pages are buffered per downstream consumer, fetched
by explicit token sequence numbers, retained until acknowledged, so a
consumer can re-fetch from any token (restart-safe, exactly-once delivery —
TaskResource.java:245-304).

Spool mode (phased execution): a build-phase task's consumers are created
in a LATER phase, so back-pressure can never drain — pages beyond the
memory cap overflow to an unlinked temp file instead of blocking (the
reference's spooling output buffers), and `get` reads them back
transparently by token.

The JAX package's server/buffers.py, with one counter more: `sent_bytes`,
the page bytes queued for the consumers (a broadcast page once for each).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import List, Optional, Tuple


class _SharedPage:
    """One broadcast page shared by every partition queue. The buffer's
    byte accounting holds it exactly ONCE and releases it when the last
    consumer acks or aborts (BroadcastOutputBuffer's page refcounting) —
    counting per partition overstated buffered bytes N× and tripped
    back-pressure long before the buffer was actually full."""

    __slots__ = ("page", "refs")

    def __init__(self, page: bytes, refs: int):
        self.page = page
        self.refs = refs


class _PartitionBuffer:
    """Token-addressed page queue for one consumer. Entries are either hot
    bytes or ("d", offset, length) descriptors into the shared spool file."""

    def __init__(self):
        self.entries: List[object] = []
        self.base_token = 0          # token of entries[0]
        self.no_more = False
        self.aborted = False

    @property
    def end_token(self) -> int:
        return self.base_token + len(self.entries)


class OutputBuffer:
    """Pages per downstream partition with token/ack delivery.

    broadcast=True appends every page to all partitions (shared bytes —
    reference: BroadcastOutputBuffer page reference counting).
    spool_dir, when set, disables producer blocking: overflow pages go to
    disk (see module docstring).
    """

    def __init__(self, n_partitions: int, broadcast: bool = False,
                 max_buffered_bytes: int = 256 << 20,
                 spool_dir: Optional[str] = None):
        self.n_partitions = n_partitions
        self.broadcast = broadcast
        self._parts = [_PartitionBuffer() for _ in range(n_partitions)]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._bytes = 0
        self._spooled_bytes = 0
        self._max_bytes = max_buffered_bytes
        self._spool_dir = spool_dir
        self._spool_f = None  # unlinked temp file: space frees on close
        self._failed: Optional[str] = None
        self.sent_bytes = 0

    # -- producer ---------------------------------------------------------

    def _spool_page(self, page: bytes):
        if self._spool_f is None:
            fd, path = tempfile.mkstemp(prefix="outbuf-", suffix=".spool",
                                        dir=self._spool_dir)
            self._spool_f = os.fdopen(fd, "wb")
            os.unlink(path)  # invisible; space reclaimed when fd closes
        off = self._spool_f.tell()
        self._spool_f.write(page)
        self._spool_f.flush()
        self._spooled_bytes += len(page)
        return ("d", off, len(page))

    def _read_entry(self, entry) -> bytes:
        if isinstance(entry, bytes):
            return entry
        if isinstance(entry, _SharedPage):
            return entry.page
        _, off, length = entry
        return os.pread(self._spool_f.fileno(), length, off)

    def _release_entry(self, entry):
        # caller holds the lock
        if isinstance(entry, bytes):
            self._bytes -= len(entry)
        elif isinstance(entry, _SharedPage):
            entry.refs -= 1
            if entry.refs == 0:
                self._bytes -= len(entry.page)

    def enqueue(self, partition: Optional[int], page: bytes):
        """Append a page; partition=None broadcasts. Blocks for back-pressure
        when the buffer is full (OutputBufferMemoryManager's blocked future)
        — unless spooling, where overflow goes to disk instead."""
        with self._cond:
            if self._spool_dir is None:
                while self._bytes >= self._max_bytes and not self._all_aborted():
                    self._cond.wait(timeout=1.0)
            fanout = range(self.n_partitions) if (self.broadcast or partition is None) \
                else (partition,)
            targets = [p for p in fanout if not self._parts[p].aborted]
            entry: object = page
            if (self._spool_dir is not None
                    and self._bytes + len(page) > self._max_bytes):
                entry = self._spool_page(page)
            elif len(targets) > 1:
                entry = _SharedPage(page, len(targets))
                self._bytes += len(page)
            elif targets:
                self._bytes += len(page)
            for p in targets:
                self._parts[p].entries.append(entry)
            self.sent_bytes += len(page) * len(targets)
            self._cond.notify_all()

    def set_no_more_pages(self):
        with self._cond:
            for pb in self._parts:
                pb.no_more = True
            self._cond.notify_all()

    def fail(self, message: str):
        with self._cond:
            self._failed = message
            for pb in self._parts:
                pb.no_more = True
            self._cond.notify_all()

    def _all_aborted(self) -> bool:
        return all(pb.aborted for pb in self._parts)

    def _maybe_release_spool(self):
        # caller holds the lock; drop the spool file once no partition can
        # ever read from it again
        if self._spool_f is None:
            return
        if all(pb.aborted or (pb.no_more and not pb.entries)
               for pb in self._parts):
            try:
                self._spool_f.close()
            except OSError:
                pass
            self._spool_f = None
            self._spooled_bytes = 0

    # -- consumer ---------------------------------------------------------

    def get(self, partition: int, token: int, max_bytes: int = 16 << 20,
            max_wait_s: float = 1.0) -> Tuple[List[bytes], int, bool]:
        """Pages from `token` on (long-poll up to max_wait_s).

        Returns (pages, next_token, complete). Re-fetching an unacked token
        returns the same pages (exactly-once via client-side dedup, like
        SerializedPage token semantics)."""
        with self._cond:
            pb = self._parts[partition]
            if self._failed is not None:
                raise BufferFailed(self._failed)
            deadline = max_wait_s
            while token >= pb.end_token and not pb.no_more and deadline > 0:
                step = min(deadline, 0.1)
                self._cond.wait(timeout=step)
                deadline -= step
                if self._failed is not None:
                    raise BufferFailed(self._failed)
            pages = []
            size = 0
            t = token
            if t < pb.base_token:
                t = pb.base_token  # already acked past this point
            while t < pb.end_token and size < max_bytes:
                page = self._read_entry(pb.entries[t - pb.base_token])
                pages.append(page)
                size += len(page)
                t += 1
            complete = pb.no_more and t >= pb.end_token
            return pages, t, complete

    def ack(self, partition: int, token: int):
        """Discard pages before `token` (client acknowledged receipt)."""
        with self._cond:
            pb = self._parts[partition]
            drop = min(max(token - pb.base_token, 0), len(pb.entries))
            for i in range(drop):
                self._release_entry(pb.entries[i])
            del pb.entries[:drop]
            pb.base_token += drop
            self._maybe_release_spool()
            self._cond.notify_all()

    def abort(self, partition: int):
        with self._cond:
            pb = self._parts[partition]
            pb.aborted = True
            for e in pb.entries:
                self._release_entry(e)
            pb.entries.clear()
            pb.no_more = True
            self._maybe_release_spool()
            self._cond.notify_all()

    def buffered_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def spooled_bytes(self) -> int:
        with self._lock:
            return self._spooled_bytes

    def is_finished(self) -> bool:
        with self._lock:
            return all(
                pb.aborted or (pb.no_more and not pb.entries) for pb in self._parts
            )


class BufferFailed(RuntimeError):
    pass
