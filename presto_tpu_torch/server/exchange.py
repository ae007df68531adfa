"""Exchange client — the consumer side of the HTTP pull shuffle.

Reference: operator/ExchangeClient.java:69 (addLocation:158, pollPage:250,
scheduleRequestIfNecessary:326) + HttpPageBufferClient.java:88: concurrent
page pulls from every upstream task's buffer, explicit token sequence
numbers, acknowledge-after-receive, bounded client-side buffer for
back-pressure.

Response wire format (mirrors PagesResponseWriter; the JAX package's
server/exchange.py, byte for byte):
    <u32 header_len> <json header {next_token, complete, page_lens,
                                   task_state, error}> <pages bytes...>

Every HTTP call has a timeout (`timeout_s`); a client given a
`deadline` (time.monotonic) fails with ExchangeFailure once it passes.
"""

from __future__ import annotations

import json
import queue
import struct
import threading
import time
import urllib.error
import urllib.request
from typing import Iterator, List, Optional, Tuple, Union

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.serde import deserialize_batch, page_rows

# HTTP timeout of one exchange request (the JAX package's 30 s)
DEFAULT_TIMEOUT_S = 30.0


class ExchangeFailure(RuntimeError):
    """`task_error=True` means the REMOTE task reported a deterministic
    failure (its error message travels in the results header) — retrying
    the query would hit the same error. False means a transport-level
    failure (unreachable/partial producer), which IS worth a retry."""

    def __init__(self, msg: str, task_error: bool = False):
        super().__init__(msg)
        self.task_error = task_error


def parse_results_payload(data: bytes):
    (hlen,) = struct.unpack_from("<I", data, 0)
    header = json.loads(data[4:4 + hlen])
    pages = []
    off = 4 + hlen
    for n in header.get("page_lens", []):
        pages.append(data[off:off + n])
        off += n
    return header, pages


def encode_results_payload(header: dict, pages: List[bytes]) -> bytes:
    header = dict(header)
    header["page_lens"] = [len(p) for p in pages]
    hj = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack("<I", len(hj)) + hj + b"".join(pages)


class _LocationPuller(threading.Thread):
    """One sequential token/ack pull loop per upstream location
    (HttpPageBufferClient analog)."""

    def __init__(self, location: str, out: "ExchangeClient"):
        super().__init__(daemon=True, name=f"exchange-{location}")
        self.location = location.rstrip("/")
        self.out = out

    def run(self):
        token = 0
        timeout = self.out.timeout_s
        missing_since = None
        try:
            while not self.out.closed:
                url = f"{self.location}/{token}"
                try:
                    with urllib.request.urlopen(url, timeout=timeout) as r:
                        data = r.read()
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        # task not created yet — transient during
                        # scheduling, for at most one timeout
                        now = time.monotonic()
                        missing_since = missing_since or now
                        if now - missing_since > timeout:
                            raise
                        time.sleep(0.05)
                        continue
                    raise
                missing_since = None
                header, pages = parse_results_payload(data)
                if header.get("error"):
                    raise ExchangeFailure(header["error"], task_error=True)
                for p in pages:
                    self.out._offer(p)
                next_token = header["next_token"]
                if pages:
                    # acknowledge so the producer can release the pages
                    urllib.request.urlopen(
                        f"{self.location}/{next_token}/ack", timeout=timeout
                    ).read()
                token = next_token
                if header.get("complete"):
                    break
        except Exception as e:  # propagate to the consuming iterator
            self.out._fail(f"{self.location}: {e}",
                           getattr(e, "task_error", False))
        finally:
            self.out._done()


class ExchangeClient:
    """Pulls pages from N upstream locations concurrently, yields Batches
    on `device`."""

    def __init__(self, locations: List[str], max_buffered_pages: int = 64,
                 device: Union[str, torch.device] = "cpu",
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 deadline: Optional[float] = None):
        self.locations = list(locations)
        self.device = device
        self.timeout_s = timeout_s
        self.deadline = deadline
        self._queue: queue.Queue = queue.Queue(maxsize=max_buffered_pages)
        self._remaining = len(self.locations)
        self._lock = threading.Lock()
        self._error: Optional[str] = None
        self.closed = False
        self._pullers = [_LocationPuller(loc, self) for loc in self.locations]
        for p in self._pullers:
            p.start()

    def _offer(self, page: bytes):
        while not self.closed:
            try:
                self._queue.put(page, timeout=0.5)
                return
            except queue.Full:
                continue

    def _fail(self, msg: str, task_error: bool = False):
        with self._lock:
            if self._error is None:
                self._error = msg
                self._error_is_task = task_error

    _error_is_task = False

    def _done(self):
        with self._lock:
            self._remaining -= 1
        self._queue.put(None)  # wake consumer

    def pages(self) -> Iterator[bytes]:
        done = 0
        while True:
            with self._lock:
                if self._error is not None:
                    self.closed = True
                    raise ExchangeFailure(self._error,
                                          task_error=self._error_is_task)
                if done >= len(self.locations) and self._queue.empty():
                    return
            if self.deadline is not None and time.monotonic() > self.deadline:
                self.closed = True
                raise ExchangeFailure("query deadline passed while waiting "
                                      "for pages", task_error=True)
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                done += 1
                continue
            yield item

    def _resolve_dict(self, digest: str) -> List[str]:
        """One-shot side-channel fetch for a by-ref dictionary. In-process
        deployments never get here (producer and consumer share the intern
        table); across processes, any upstream worker that shipped the ref
        has it interned, so try each distinct base once."""
        seen = set()
        for loc in self.locations:
            base = loc.split("/v1/")[0]
            if base in seen or not base.startswith("http"):
                continue
            seen.add(base)
            try:
                with urllib.request.urlopen(f"{base}/v1/dict/{digest}",
                                            timeout=self.timeout_s) as r:
                    return json.loads(r.read())
            except Exception:
                continue
        raise ExchangeFailure(
            f"dictionary {digest[:12]} unresolvable from any upstream",
            task_error=True)

    def batches(self) -> Iterator[Batch]:
        for page in self.pages():
            yield deserialize_batch(page, device=self.device,
                                    dict_resolver=self._resolve_dict)

    def counted_batches(self) -> Iterator[Tuple[Batch, int]]:
        """(batch, live rows) pairs: the count comes from the page header,
        so reading it costs no device sync."""
        for page in self.pages():
            yield (deserialize_batch(page, device=self.device,
                                     dict_resolver=self._resolve_dict),
                   page_rows(page))

    def close(self):
        self.closed = True
