"""Client statement protocol — the Presto-compatible paged REST API.

Reference: server/protocol/StatementResource.java:89 (`@Path("/v1/statement")`,
POST :135 create, GET /{queryId}/{token} :174 page fetch, DELETE :277 cancel)
and the client's polling loop (presto-client StatementClientV1.java:340-352:
follow `nextUri` until absent). Session state is client-carried via headers
(X-Presto-Session etc.), mutated by SET/RESET SESSION through
X-Presto-Set-Session response headers — the coordinator itself is stateless
across requests, exactly like the reference.

Coordinator-side statements (SHOW/EXPLAIN/SET) execute inline, the analog of
DataDefinitionExecution + execution/*Task.java running on the coordinator.

The JAX package's server/protocol.py: the same statements, wire values
and responses, without what the port does not have yet — password
authentication and rule-based session defaults and SHOW FUNCTIONS (the
cluster services, ROADMAP item 17), and the trace, progress, result-cache
and profile links of a response (ROADMAP item 14).
"""

from __future__ import annotations

import datetime
import decimal
import re
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from presto_tpu_torch.obs import devprof as _devprof
from presto_tpu_torch.server.querymanager import (
    CANCELED,
    EXPIRED,
    FAILED,
    QueryManager,
    QueryResult,
    TERMINAL,
)
from presto_tpu_torch.server.session import SYSTEM_PROPERTIES, Session

_SET_SESSION_RE = re.compile(
    r"^\s*set\s+session\s+([a-zA-Z_][\w.]*)\s*=\s*(.+?)\s*$", re.I | re.S
)
_RESET_SESSION_RE = re.compile(r"^\s*reset\s+session\s+([a-zA-Z_][\w.]*)\s*$", re.I)
_SHOW_SESSION_RE = re.compile(r"^\s*show\s+session\s*$", re.I)
_SHOW_TABLES_RE = re.compile(r"^\s*show\s+tables(?:\s+from\s+([\w.]+))?\s*$", re.I)
_SHOW_CATALOGS_RE = re.compile(r"^\s*show\s+catalogs\s*$", re.I)
_SHOW_COLUMNS_RE = re.compile(
    r"^\s*(?:show\s+columns\s+from|describe)\s+([\w.]+)\s*$", re.I
)
_PREPARE_RE = re.compile(r"^\s*prepare\s+(\w+)\s+from\s+(.+)$",
                         re.I | re.S)
_EXECUTE_RE = re.compile(r"^\s*execute\s+(\w+)(?:\s+using\s+(.+))?\s*$",
                         re.I | re.S)
_DEALLOCATE_RE = re.compile(r"^\s*deallocate\s+prepare\s+(\w+)\s*$", re.I)
_SHOW_FUNCTIONS_RE = re.compile(r"^\s*show\s+functions\s*$", re.I)
_SHOW_SCHEMAS_RE = re.compile(
    r"^\s*show\s+schemas(?:\s+from\s+([\w.]+))?\s*$", re.I)
_SHOW_STATS_RE = re.compile(
    r"^\s*show\s+stats\s+for\s+([\w.]+)\s*$", re.I)
_EXPLAIN_RE = re.compile(
    r"^\s*explain\s+(analyze\s+)?(?:\(\s*type\s+(\w+)\s*\)\s+)?(.+)$",
    re.I | re.S)


def _json_value(v: Any, type_name: str) -> Any:
    """Row value → JSON-safe wire value, by declared SQL type."""
    if v is None:
        return None
    if isinstance(v, (np.generic,)):
        v = v.item()
    if type_name == "date":
        if isinstance(v, int):
            return (datetime.date(1970, 1, 1) + datetime.timedelta(days=v)).isoformat()
        if isinstance(v, datetime.date):
            return v.isoformat()
    if type_name == "timestamp" and isinstance(v, int):
        return datetime.datetime.fromtimestamp(
            v / 1e6, tz=datetime.timezone.utc
        ).strftime("%Y-%m-%d %H:%M:%S.%f")
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, float) and (v != v):  # NaN → null (JSON has no NaN)
        return None
    return v


def result_rows_json(result: QueryResult) -> List[List[Any]]:
    return [
        [_json_value(v, t) for v, t in zip(row, result.types)]
        for row in result.rows
    ]


def _parse_using_args(using: str | None) -> list:
    """EXECUTE ... USING literal list → AST expressions (parsed by the
    real lexer/parser; no raw-text handling anywhere). Only literal-like
    forms are accepted — parameters carry values, not expressions over
    the query's scope."""
    if not using:
        return []
    from presto_tpu_torch.sql import ast as _ast
    from presto_tpu_torch.sql.parser import Parser

    q = Parser(f"select {using}").parse_statement()
    args = [item.expr for item in q.select]

    def literal_like(e) -> bool:
        if isinstance(e, (_ast.Literal, _ast.IntervalLiteral)):
            return True
        if isinstance(e, _ast.UnaryOp) and e.op == "-":
            return literal_like(e.operand)
        if isinstance(e, _ast.Cast):
            return literal_like(e.expr)
        return False

    for a in args:
        if not literal_like(a):
            raise ValueError("EXECUTE ... USING accepts literals only")
    return args


def _bind_statement(body: str, using: str | None):
    """Parse the prepared body (the lexer knows `?`) and bind parameters
    on the AST positionally."""
    from presto_tpu_torch.sql import ast as _ast
    from presto_tpu_torch.sql.parser import parse_sql

    args = _parse_using_args(using)
    stmt = parse_sql(body)
    bound, n_params = _ast.substitute_parameters(stmt, args)
    if n_params != len(args):
        raise ValueError(
            f"prepared statement has {n_params} parameters, "
            f"USING supplies {len(args)}")
    return bound


class StatementProtocol:
    """Stateless request handlers; mounted on the coordinator HTTP server."""

    def __init__(self, query_manager: QueryManager, catalog, base_url: str,
                 page_rows: int = 1000, explain_fn=None):
        self.qm = query_manager
        self.catalog = catalog
        self.base_url = base_url
        self.page_rows = page_rows
        self.explain_fn = explain_fn  # sql -> plan text
        # prepared statements keyed by (user, name) — a deliberate
        # statefulness deviation: the reference round-trips them in
        # X-Presto-Prepared-Statement headers; this registry serves the
        # same PREPARE/EXECUTE surface for header-less clients, bounded
        # per user (insertion-ordered dict → oldest evicts)
        self._prepared: Dict[tuple, str] = {}
        self.max_prepared_per_user = 64
        # (session, bound_stmt_ast) -> QueryResult; wired by the
        # coordinator so EXECUTE runs the bound AST without re-rendering
        self.execute_stmt_fn = None

    # -- session from headers ---------------------------------------------

    def session_from_headers(self, headers) -> Session:
        user = headers.get("X-Presto-User") or "user"
        source = headers.get("X-Presto-Source") or ""
        props: Dict[str, Any] = {}
        raw = headers.get("X-Presto-Session") or headers.get("X-Trino-Session")
        if raw:
            from urllib.parse import unquote

            for pair in raw.split(","):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    props[k.strip()] = SYSTEM_PROPERTIES.decode(
                        k.strip(), unquote(v.strip())
                    )
        return Session(
            user=user,
            source=source,
            catalog=headers.get("X-Presto-Catalog"),
            schema=headers.get("X-Presto-Schema"),
            properties=props,
        )

    # -- statement handling -------------------------------------------------

    def create(self, sql: str, headers) -> Tuple[dict, Dict[str, str]]:
        """POST /v1/statement → (QueryResults json, extra response headers)."""
        session = self.session_from_headers(headers)
        extra: Dict[str, str] = {}

        m = _SET_SESSION_RE.match(sql)
        if m:
            name, raw = m.group(1), m.group(2).strip().strip("'\"")
            SYSTEM_PROPERTIES.decode(name, raw)  # validate
            extra["X-Presto-Set-Session"] = f"{name}={raw}"
            return self._immediate(session, sql, QueryResult([], [], [])), extra
        m = _RESET_SESSION_RE.match(sql)
        if m:
            SYSTEM_PROPERTIES.metadata(m.group(1))
            extra["X-Presto-Clear-Session"] = m.group(1)
            return self._immediate(session, sql, QueryResult([], [], [])), extra
        m = _SHOW_SESSION_RE.match(sql)
        if m:
            rows = []
            for name in SYSTEM_PROPERTIES.names():
                meta = SYSTEM_PROPERTIES.metadata(name)
                if meta.hidden:
                    continue
                cur = session.properties.get(name, meta.default)
                rows.append((name, str(cur), str(meta.default),
                             meta.py_type.__name__, meta.description))
            r = QueryResult(
                ["name", "value", "default", "type", "description"],
                ["varchar"] * 5, rows)
            return self._immediate(session, sql, r), extra
        m = _SHOW_CATALOGS_RE.match(sql)
        if m:
            r = QueryResult(["catalog"], ["varchar"],
                            [(c,) for c in sorted(self.catalog.connectors)])
            return self._immediate(session, sql, r), extra
        m = _SHOW_TABLES_RE.match(sql)
        if m:
            cname = m.group(1) or session.catalog or self.catalog.default
            conn = self.catalog.connectors[cname]
            r = QueryResult(["table"], ["varchar"],
                            [(t,) for t in sorted(conn.table_names())])
            return self._immediate(session, sql, r), extra
        m = _SHOW_COLUMNS_RE.match(sql)
        if m:
            conn, handle = self.catalog.resolve(m.group(1).split("."))
            r = QueryResult(
                ["column", "type"], ["varchar", "varchar"],
                [(c.name, str(c.type)) for c in handle.columns])
            return self._immediate(session, sql, r), extra
        m = _PREPARE_RE.match(sql)
        if m:
            name, body = m.group(1).lower(), m.group(2).strip()
            from presto_tpu_torch.sql.parser import parse_sql

            parse_sql(body)  # the lexer/parser know `?` — real validation
            key = (session.user, name)
            self._prepared.pop(key, None)
            self._prepared[key] = body
            # bounded per-user registry (oldest-prepared evicts)
            mine = [k for k in self._prepared if k[0] == session.user]
            while len(mine) > self.max_prepared_per_user:
                self._prepared.pop(mine.pop(0), None)
            extra["X-Presto-Added-Prepare"] = name
            return self._immediate(session, sql, QueryResult([], [], [])), extra
        m = _DEALLOCATE_RE.match(sql)
        if m:
            self._prepared.pop((session.user, m.group(1).lower()), None)
            extra["X-Presto-Deallocated-Prepare"] = m.group(1).lower()
            return self._immediate(session, sql, QueryResult([], [], [])), extra
        m = _EXECUTE_RE.match(sql)
        if m:
            name = m.group(1).lower()
            body = self._prepared.get((session.user, name))
            if body is None:
                raise KeyError(f"prepared statement not found: {name}")
            bound = _bind_statement(body, m.group(2))
            if self.execute_stmt_fn is None:
                raise RuntimeError("EXECUTE not supported on this server")
            qe = self.qm.create_query(
                session, sql,
                execute_fn=lambda s, q, stmt=bound:
                    self.execute_stmt_fn(s, stmt))
            return self._results(qe, 0), extra
        m = _SHOW_FUNCTIONS_RE.match(sql)
        if m:
            raise NotImplementedError(
                "SHOW FUNCTIONS is not supported by presto_tpu_torch yet — "
                "needs the cluster services (ROADMAP item 17)")
        m = _SHOW_SCHEMAS_RE.match(sql)
        if m:
            # single-schema connectors: one "default" schema per catalog
            cname = m.group(1) or session.catalog or self.catalog.default
            self.catalog.connectors[cname]  # raise on unknown catalog
            r = QueryResult(["schema"], ["varchar"], [("default",)])
            return self._immediate(session, sql, r), extra
        m = _SHOW_STATS_RE.match(sql)
        if m:
            conn, handle = self.catalog.resolve(m.group(1).split("."))
            rows = []
            for c in handle.columns:
                cs = getattr(c, "stats", None)
                rows.append((
                    c.name,
                    str(cs.ndv) if cs and cs.ndv is not None else None,
                    str(cs.null_fraction) if cs else None,
                    str(cs.min_value) if cs and cs.min_value is not None else None,
                    str(cs.max_value) if cs and cs.max_value is not None else None,
                ))
            rows.append((None, None, None, None, str(handle.row_count)))
            r = QueryResult(
                ["column_name", "distinct_values_count", "nulls_fraction",
                 "low_value", "high_value"],
                ["varchar"] * 5, rows)
            return self._immediate(session, sql, r), extra
        m = _EXPLAIN_RE.match(sql)
        if m and self.explain_fn is not None:
            etype = (m.group(2) or "").lower() or None
            text = self.explain_fn(m.group(3), bool(m.group(1)), session,
                                   etype)
            r = QueryResult(["Query Plan"], ["varchar"],
                            [(line,) for line in text.split("\n")])
            return self._immediate(session, sql, r), extra

        qe = self.qm.create_query(session, sql)
        return self._results(qe, 0), extra

    def _immediate(self, session: Session, sql: str, result: QueryResult) -> dict:
        """Coordinator-side statement: completes with a prepared result but
        still flows through the QueryManager (history, events, admission)."""
        qe = self.qm.create_query(session, sql, execute_fn=lambda s, q: result)
        qe.wait(10.0)
        return self._results(qe, 0, force_data=True)

    def poll(self, query_id: str, token: int, wait_s: float = 0.5) -> dict:
        qe = self.qm.get(query_id)
        if not qe.done:
            qe.wait(wait_s)
        return self._results(qe, token)

    def cancel(self, query_id: str):
        try:
            self.qm.cancel(query_id)
        except KeyError:
            pass

    def _results(self, qe, token: int, force_data: bool = False) -> dict:
        base = f"{self.base_url}/v1/statement/{qe.query_id}"
        out: dict = {
            "id": qe.query_id,
            "infoUri": f"{self.base_url}/v1/query/{qe.query_id}",
            "traceUri": f"{self.base_url}/v1/query/{qe.query_id}/trace",
            "stats": {
                "state": qe.state,
                "queued": qe.state == "QUEUED",
                "elapsedTimeMillis": int(
                    ((qe.end_time or time.time()) - qe.create_time) * 1000
                ),
            },
        }
        if qe.timeline is not None:
            # lifecycle plane only: the live fraction-complete endpoint
            out["progressUri"] = (
                f"{self.base_url}/v1/query/{qe.query_id}/progress")
        # `profile` session property: the query's torch.profiler trace
        pfile = _devprof.profile_for(qe.query_id)
        if pfile:
            out["profileUri"] = f"file://{pfile}"
        if qe.state == FAILED:
            # user mistakes (parse/analysis/session/admission) are USER_ERROR,
            # everything else INTERNAL (reference: StandardErrorCode types)
            user_error = (qe.error_type or "").startswith(
                ("Parse", "Analysis", "Session", "QUERY_QUEUE", "Key",
                 "AccessDenied")
            )
            out["error"] = {
                "message": qe.error or "query failed",
                "errorName": qe.error_type or "INTERNAL_ERROR",
                "errorType": "USER_ERROR" if user_error else "INTERNAL_ERROR",
            }
            return out
        if qe.state == CANCELED:
            out["error"] = {
                "message": "Query was canceled by the user",
                "errorName": "USER_CANCELED",
                "errorType": "USER_ERROR",
            }
            return out
        if qe.state == EXPIRED:
            # enforcement-loop kill (query_max_run_time_s): resource
            # exhaustion, not a user mistake and not an engine bug
            err = {
                "message": qe.error or "Query expired",
                "errorName": qe.error_type or "EXCEEDED_TIME_LIMIT",
                "errorType": "INSUFFICIENT_RESOURCES",
            }
            if qe.expired_limit_s is not None:
                err["limitS"] = qe.expired_limit_s
                err["elapsedS"] = qe.expired_elapsed_s
            out["error"] = err
            return out
        if qe.state not in TERMINAL:
            out["nextUri"] = f"{base}/{token}"
            return out
        # FINISHED: page the materialized result
        result = qe.result or QueryResult([], [], [])
        out["columns"] = [
            {"name": c, "type": t} for c, t in zip(result.columns, result.types)
        ]
        lo = token * self.page_rows
        hi = lo + self.page_rows
        page = QueryResult(result.columns, result.types, result.rows[lo:hi])
        if page.rows or force_data or token == 0:
            out["data"] = result_rows_json(page)
        if hi < len(result.rows):
            out["nextUri"] = f"{base}/{token + 1}"
        return out
