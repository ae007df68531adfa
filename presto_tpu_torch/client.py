"""Statement client — the HTTP polling loop shared by CLI and DBAPI.

Reference: presto-client StatementClientV1.java:87,340-352 (`advance()`
follows `nextUri` until absent; session mutations arrive via
X-Presto-Set-Session / X-Presto-Clear-Session response headers and are
client-carried on subsequent requests — the server is stateless).

The JAX package's client.py: HTTP and text only, so it speaks to either
package's coordinator. Every request has a timeout (`timeout_s`).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional


class QueryError(RuntimeError):
    def __init__(self, message: str, error_name: str = "", error_type: str = ""):
        super().__init__(message)
        self.error_name = error_name
        self.error_type = error_type


class StatementClient:
    """One statement's lifecycle: submit → poll nextUri → rows."""

    def __init__(self, server: str, sql: str, session: "ClientSession",
                 timeout_s: float = 60.0):
        self.server = server.rstrip("/")
        self.sql = sql
        self.session = session
        self.timeout_s = timeout_s
        self.columns: Optional[List[dict]] = None
        self.query_id: Optional[str] = None
        self.stats: Dict[str, Any] = {}
        self.progress_uri: Optional[str] = None
        self._next_uri: Optional[str] = None
        self._current_data: List[list] = []
        self._error: Optional[dict] = None
        self._submit()

    def _headers(self) -> Dict[str, str]:
        h = {"X-Presto-User": self.session.user, "Content-Type": "text/plain"}
        if self.session.source:
            h["X-Presto-Source"] = self.session.source
        if self.session.catalog:
            h["X-Presto-Catalog"] = self.session.catalog
        if self.session.schema:
            h["X-Presto-Schema"] = self.session.schema
        if self.session.properties:
            from urllib.parse import quote

            # values are URL-encoded: a comma inside a value must survive
            # the comma-separated pair list (reference protocol does the same)
            h["X-Presto-Session"] = ",".join(
                f"{k}={quote(str(v))}" for k, v in self.session.properties.items()
            )
        return h

    def _apply_response_headers(self, headers):
        sets = headers.get_all("X-Presto-Set-Session") if hasattr(
            headers, "get_all") else None
        for item in sets or []:
            if "=" in item:
                k, v = item.split("=", 1)
                self.session.properties[k.strip()] = v.strip()
        clears = headers.get_all("X-Presto-Clear-Session") if hasattr(
            headers, "get_all") else None
        for item in clears or []:
            self.session.properties.pop(item.strip(), None)

    def _consume(self, payload: dict):
        self.query_id = payload.get("id") or self.query_id
        self.stats = payload.get("stats", {})
        if payload.get("columns") and self.columns is None:
            self.columns = payload["columns"]
        self._current_data = payload.get("data") or []
        self._next_uri = payload.get("nextUri")
        # present only when the server tracks this query's lifecycle
        # (session lifecycle=on); pollable even after the query finishes
        self.progress_uri = payload.get("progressUri") or self.progress_uri
        self._error = payload.get("error")

    def _submit(self):
        req = urllib.request.Request(
            f"{self.server}/v1/statement",
            data=self.sql.encode(), method="POST", headers=self._headers(),
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            self._apply_response_headers(r.headers)
            self._consume(json.loads(r.read()))

    def _advance(self) -> bool:
        if self._next_uri is None:
            return False
        backoff = 0.0
        while True:
            try:
                with urllib.request.urlopen(self._next_uri,
                                            timeout=self.timeout_s) as r:
                    self._apply_response_headers(r.headers)
                    self._consume(json.loads(r.read()))
                return True
            except urllib.error.URLError:
                backoff = min((backoff or 0.05) * 2, 1.0)
                time.sleep(backoff)
                if backoff >= 1.0:
                    raise

    def rows(self) -> Iterator[list]:
        while True:
            if self._error:
                raise QueryError(
                    self._error.get("message", "query failed"),
                    self._error.get("errorName", ""),
                    self._error.get("errorType", ""),
                )
            yield from self._current_data
            self._current_data = []
            if not self._advance():
                return

    def progress(self) -> Optional[dict]:
        """Fetch the server's live progress estimate (fraction complete,
        HBO/fragment provenance, lifecycle segments). None when the server
        exposed no progressUri (lifecycle=off) or the fetch fails."""
        if not self.progress_uri:
            return None
        try:
            with urllib.request.urlopen(self.progress_uri,
                                        timeout=min(10.0, self.timeout_s)) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def cancel(self):
        if self.query_id:
            req = urllib.request.Request(
                f"{self.server}/v1/statement/{self.query_id}", method="DELETE"
            )
            try:
                urllib.request.urlopen(req, timeout=min(10.0, self.timeout_s)
                                       ).read()
            except Exception:  # noqa: BLE001 — best effort: it may be done
                pass


class ClientSession:
    """Client-carried session state (user, default catalog/schema, property
    overrides accumulated from SET SESSION responses)."""

    def __init__(self, user: str = "user", source: str = "presto-tpu-client",
                 catalog: Optional[str] = None, schema: Optional[str] = None):
        self.user = user
        self.source = source
        self.catalog = catalog
        self.schema = schema
        self.properties: Dict[str, str] = {}


def execute(server: str, sql: str,
            session: Optional[ClientSession] = None,
            timeout_s: float = 60.0) -> tuple:
    """One-shot helper: (column names, rows)."""
    client = StatementClient(server, sql, session or ClientSession(),
                             timeout_s=timeout_s)
    rows = list(client.rows())
    cols = [c["name"] for c in (client.columns or [])]
    return cols, rows
