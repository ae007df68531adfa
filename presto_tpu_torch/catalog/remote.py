"""Remote-service connector — federate an external data service over RPC.

Reference: presto-thrift-connector(-api): an external service implements a
small RPC surface (prestoListTables / prestoGetTableMetadata /
prestoGetSplits / prestoGetRows with continuation tokens and
`desiredColumns` + TupleDomain pushdown) and any number of Presto
clusters query it. Here the same four-call shape runs as JSON over HTTP
(the engine's control-plane idiom; drift/thrift adds codegen without
adding capability):

    GET  {base}/v1/tables                      → {"tables": [name, …]}
    GET  {base}/v1/tables/{t}/schema           → {"columns": [{name, type}],
                                                  "rowCount": n}
    GET  {base}/v1/tables/{t}/splits?desired=N → {"splits": [id, …]}
    POST {base}/v1/tables/{t}/rows             → {"columns": {name: [v,…]},
         {"split": id, "columns": [...],          "nextToken": tok|null}
          "constraints": {col: [lo, hi]},
          "token": tok|null, "maxRows": n}

Projection pushdown = the `columns` list; predicate pushdown = the
`constraints` ranges (TupleDomain analog); paging = `token` continuation
exactly like the thrift `nextToken`. A reference in-process service
(`RemoteTableService`) doubles as the test fixture — the analog of the
thrift connector's TestingThriftService.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, round_up_capacity
from presto_tpu_torch.catalog.memory import DeviceSplitCache
from presto_tpu_torch.connector import ColumnInfo, Connector, Split, TableHandle
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, Type, VARCHAR

_TYPES = {"bigint": BIGINT, "double": DOUBLE, "varchar": VARCHAR,
          "boolean": BOOLEAN}


def _type_name(t: Type) -> str:
    for k, v in _TYPES.items():
        if v is t:
            return k
    return "varchar"


class RemoteServiceConnector(DeviceSplitCache, Connector):
    """Engine-side client of the remote table service."""

    def __init__(self, base_url: str, name: str = "remote",
                 page_rows: int = 1 << 16):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.page_rows = page_rows
        self._handles: Dict[str, TableHandle] = {}
        self._dicts: Dict[str, Dict[str, Dictionary]] = {}
        self._lock = threading.Lock()
        self._init_split_cache()

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path, timeout=30) as r:
            return json.loads(r.read())

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(body).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def table_names(self) -> List[str]:
        return list(self._get("/v1/tables")["tables"])

    def get_table(self, name: str) -> TableHandle:
        with self._lock:
            h = self._handles.get(name)
            if h is not None:
                return h
        meta = self._get(f"/v1/tables/{urllib.parse.quote(name)}/schema")
        cols = [ColumnInfo(c["name"], _TYPES.get(c["type"], VARCHAR), None)
                for c in meta["columns"]]
        h = TableHandle(self.name, name, cols,
                        row_count=float(meta.get("rowCount") or 0))
        with self._lock:
            # the schema fetch above runs outside the lock by design;
            # racing fetches produce equivalent handles and the insert is
            # idempotent (last writer wins)
            self._handles[name] = h
        return h

    def splits(self, handle: TableHandle, desired: int = 1) -> List[Split]:
        got = self._get(
            f"/v1/tables/{urllib.parse.quote(handle.name)}/splits"
            f"?desired={desired}")["splits"]
        return [Split(handle.name, i, len(got)) for i in range(len(got))]

    def read_split_constrained(self, split: Split, columns: Sequence[str],
                               device: torch.device,
                               capacity: Optional[int] = None,
                               constraints=None) -> Batch:
        """Predicate-pushdown read: bypasses the split cache (cache keys
        don't carry constraints) and ships the ranges to the service.
        Only JSON-native numeric bounds travel; anything else (dates as
        datetime objects) stays engine-side — the filter above the scan
        re-applies every predicate regardless."""
        num = {c: (lo, hi) for c, (lo, hi) in (constraints or {}).items()
               if all(v is None or isinstance(v, (int, float))
                      for v in (lo, hi))}
        return self._read_split_uncached(split, columns, device, capacity,
                                         constraints=num)

    def _read_split_uncached(self, split: Split, columns: Sequence[str],
                             device: torch.device,
                             capacity: Optional[int] = None,
                             constraints=None) -> Batch:
        h = self.get_table(split.table)
        col_types = {c.name: c.type for c in h.columns}
        data: Dict[str, list] = {c: [] for c in columns}
        token = None
        while True:
            out = self._post(
                f"/v1/tables/{urllib.parse.quote(split.table)}/rows",
                {"split": split.part, "nSplits": split.total,
                 "columns": list(columns),
                 "constraints": {c: [lo, hi] for c, (lo, hi)
                                 in (constraints or {}).items()},
                 "token": token, "maxRows": self.page_rows})
            for c in columns:
                data[c].extend(out["columns"][c])
            token = out.get("nextToken")
            if token is None:
                break
        return self._to_batch(split.table, columns, col_types, data, device,
                              capacity)

    def _to_batch(self, table, columns, col_types, data, device, capacity):
        def dev(a):
            return torch.from_numpy(a).to(device)

        n = len(data[columns[0]]) if columns else 0
        cap = max(capacity or 0, round_up_capacity(max(n, 1)))
        live = np.zeros(cap, bool)
        live[:n] = True
        names, types, cols, dicts = [], [], [], {}
        for cname in columns:
            t = col_types[cname]
            raw = data[cname]
            valid = np.array([v is not None for v in raw])
            vcol = None
            if t.is_string:
                with self._lock:
                    d = self._dicts.setdefault(table, {}).get(cname)
                    vocab = sorted({str(v) for v in raw if v is not None})
                    nd = Dictionary(np.asarray(vocab, dtype=str))
                    if d is not None:
                        nd = Dictionary.merge(d, nd)
                    self._dicts[table][cname] = nd
                buf = np.full(cap, -1, np.int32)
                buf[:n] = [nd.code_of(str(v)) if v is not None else -1
                           for v in raw]
                dicts[cname] = nd
            else:
                buf = np.zeros(cap, dtype=t.dtype)
                buf[:n] = [v if v is not None else 0 for v in raw]
            if not valid.all():
                vb = np.zeros(cap, bool)
                vb[:n] = valid
                vcol = dev(vb)
            names.append(cname)
            types.append(t)
            cols.append(Column(dev(buf), vcol))
        return Batch(names, types, cols, dev(live), dicts)


class RemoteTableService:
    """Reference implementation of the service side, backed by pandas
    DataFrames — in-process HTTP server used by tests/examples (the
    TestingThriftService analog). Records every /rows request so tests
    can assert projection/predicate pushdown reached the service."""

    def __init__(self, tables, port: int = 0, n_splits: int = 2):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.tables = tables
        self.n_splits = n_splits
        self.requests: List[dict] = []  # /rows bodies, for pushdown asserts
        svc = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = urllib.parse.urlparse(self.path)
                parts = [p for p in path.path.split("/") if p]
                if parts == ["v1", "tables"]:
                    return self._json({"tables": sorted(svc.tables)})
                if (len(parts) == 4 and parts[:2] == ["v1", "tables"]
                        and parts[3] == "schema"):
                    df = svc.tables.get(urllib.parse.unquote(parts[2]))
                    if df is None:
                        return self._json({"error": "no such table"}, 404)
                    cols = []
                    for c in df.columns:
                        k = df[c].dtype.kind
                        cols.append({"name": c, "type":
                                     "bigint" if k in "iu" else
                                     "double" if k == "f" else
                                     "boolean" if k == "b" else "varchar"})
                    return self._json({"columns": cols,
                                       "rowCount": int(len(df))})
                if (len(parts) == 4 and parts[:2] == ["v1", "tables"]
                        and parts[3] == "splits"):
                    q = urllib.parse.parse_qs(path.query)
                    desired = int(q.get("desired", ["1"])[0])
                    n = min(max(desired, 1), svc.n_splits)
                    return self._json({"splits": list(range(n))})
                self._json({"error": "not found"}, 404)

            def do_POST(self):
                path = urllib.parse.urlparse(self.path)
                parts = [p for p in path.path.split("/") if p]
                if not (len(parts) == 4 and parts[:2] == ["v1", "tables"]
                        and parts[3] == "rows"):
                    return self._json({"error": "not found"}, 404)
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", "0"))))
                svc.requests.append(body)
                df = svc.tables[urllib.parse.unquote(parts[2])]
                # split slicing (row ranges — the service owns its split
                # semantics, like thrift splits carry opaque payloads)
                i, total = int(body["split"]), int(body.get("nSplits", 1))
                lo = len(df) * i // total
                hi = len(df) * (i + 1) // total
                part = df.iloc[lo:hi]
                # predicate pushdown: range constraints filter server-side
                for c, (clo, chi) in (body.get("constraints") or {}).items():
                    if clo is not None:
                        part = part[part[c] >= clo]
                    if chi is not None:
                        part = part[part[c] <= chi]
                # continuation token = row offset into the filtered part
                tok = int(body.get("token") or 0)
                page = part.iloc[tok:tok + int(body.get("maxRows", 65536))]
                nxt = tok + len(page)
                cols = {c: [None if v != v else
                            (v.item() if hasattr(v, "item") else v)
                            for v in page[c]]
                        for c in body["columns"]}
                return self._json({
                    "columns": cols,
                    "nextToken": nxt if nxt < len(part) else None})

        self._http = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._http.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True, name="remote-table-svc")
        self._thread.start()

    def close(self):
        self._http.shutdown()
        self._http.server_close()
