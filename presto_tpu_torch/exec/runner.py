"""LocalRunner — single-process query runner.

Analog of the reference's LocalQueryRunner: parse → plan → optimize
(with the session's multiway join collapse) → execute in-process. Runs
on the GPU unless the caller passes a device: `device=None` means CUDA
and raises when CUDA is absent.

Statements other than queries (CREATE TABLE [AS], INSERT, DROP TABLE,
CREATE/DROP VIEW, DELETE, TRUNCATE) run engine-side before any planning,
as in the JAX package: each returns one row, the `rows` it wrote or
removed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from presto_tpu_torch import default_device
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec.runtime import (
    ExecConfig,
    ExecContext,
    mark_breaker_engines,
    run_plan,
)
from presto_tpu_torch.plan.builder import plan_query
from presto_tpu_torch.plan.multiway import apply_join_mode
from presto_tpu_torch.plan.nodes import QueryPlan, plan_to_string
from presto_tpu_torch.plan.optimizer import optimize
from presto_tpu_torch.sql import ast
from presto_tpu_torch.sql.parser import parse_sql
from presto_tpu_torch.types import BIGINT

_DDL_NODES = (ast.CreateTableAs, ast.Insert, ast.DropTable, ast.CreateTable,
              ast.CreateView, ast.DropView, ast.Delete, ast.Truncate)


def is_ddl(stmt) -> bool:
    return isinstance(stmt, _DDL_NODES)


def execute_data_definition(stmt, catalog: Catalog, run_query_fn,
                            device: torch.device) -> Batch:
    """Run a statement that is not a query against its connector; the
    result is one `rows` row on `device`. `run_query_fn` runs a query AST
    (a CTAS or INSERT source, or DELETE's rewrite) to a Batch."""

    def count_batch(rows: int) -> Batch:
        vals = torch.zeros(128, dtype=torch.int64, device=device)
        vals[0] = rows
        live = torch.zeros(128, dtype=torch.bool, device=device)
        live[0] = True
        return Batch(["rows"], [BIGINT], [Column(vals)], live, {})

    if isinstance(stmt, ast.CreateView):
        name = stmt.name[-1]
        if name in catalog.views and not stmt.or_replace:
            raise ValueError(f"view already exists: {name}")
        catalog.views[name] = stmt.query
        return count_batch(0)
    if isinstance(stmt, ast.DropView):
        if stmt.name[-1] not in catalog.views and not stmt.if_exists:
            raise KeyError(f"view not found: {stmt.name[-1]}")
        catalog.views.pop(stmt.name[-1], None)
        return count_batch(0)

    conn, tname = catalog.connector_for(stmt.name)
    if isinstance(stmt, ast.DropTable):
        conn.drop_table(tname, if_exists=stmt.if_exists)
        return count_batch(0)
    if isinstance(stmt, ast.CreateTable):
        from presto_tpu_torch.types import GEOMETRY, parse_type

        if stmt.properties:
            raise ValueError(
                "table properties are only supported on CREATE TABLE AS")
        cols = [(c, parse_type(t)) for c, t in stmt.columns]
        if any(t is GEOMETRY for _, t in cols):
            raise ValueError(
                "GEOMETRY columns cannot be stored — keep WKT varchar and "
                "parse with ST_GeometryFromText")
        conn.create_empty(tname, cols, if_not_exists=stmt.if_not_exists)
        return count_batch(0)
    if isinstance(stmt, ast.Truncate):
        before = int(conn.get_table(tname).row_count or 0)
        conn.truncate_table(tname)
        return count_batch(before)
    if isinstance(stmt, ast.Delete):
        # the rows kept are those where the predicate is not TRUE (a NULL
        # predicate keeps its row)
        before = int(conn.get_table(tname).row_count or 0)
        if stmt.where is None:
            conn.truncate_table(tname)
            return count_batch(before)
        keep = ast.UnaryOp("not", ast.FunctionCall(
            "coalesce", [stmt.where, ast.Literal(False, "boolean")]))
        q = ast.Query(select=[ast.SelectItem(ast.Star(), None)],
                      from_=ast.Table(stmt.name), where=keep)
        conn.replace_table_from(tname, [run_query_fn(q)])
        return count_batch(before - int(conn.get_table(tname).row_count or 0))

    result = run_query_fn(stmt.query)
    if isinstance(stmt, ast.CreateTableAs):
        n = conn.create_table_from(tname, [result],
                                   if_not_exists=stmt.if_not_exists,
                                   properties=stmt.properties or None)
    else:
        n = conn.insert_into(tname, [result])
    return count_batch(n)


class LocalRunner:
    def __init__(self, catalog: Catalog, config: Optional[ExecConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.catalog = catalog
        self.config = config or ExecConfig()
        self.device = default_device(device)
        # prepared plans by SQL text; plans with scalar subqueries mutate
        # when their parameters bind and are not cached
        self._plan_cache = {}
        # ExecContext.stats of the most recent run
        self.last_stats: dict = {}

    def _plan_statement(self, stmt, sql: Optional[str] = None) -> QueryPlan:
        if not isinstance(stmt, (ast.Query, ast.SetOp)):
            raise NotImplementedError(
                f"statement {type(stmt).__name__} is not supported by "
                "presto_tpu_torch yet")
        qp = self._optimize(plan_query(stmt, self.catalog))
        if sql is not None and not qp.scalar_subqueries and qp.cacheable:
            self._plan_cache[sql] = qp
        return qp

    def _optimize(self, qp: QueryPlan) -> QueryPlan:
        """optimize() and the session's multiway collapse, which runs
        when the plan is installed because its verdict depends on the
        session's join_mode."""
        qp = optimize(qp, self.catalog)
        apply_join_mode(qp, self.catalog, self.config)
        return qp

    def plan(self, sql: str) -> QueryPlan:
        qp = self._plan_cache.get(sql)
        return qp if qp is not None else self._plan_statement(
            parse_sql(sql), sql)

    def explain(self, sql: str) -> str:
        qp = self.plan(sql)
        mark_breaker_engines(qp.root, self._new_ctx())
        return plan_to_string(qp.root)

    def _new_ctx(self) -> ExecContext:
        return ExecContext(self.catalog, self.config, self.device)

    def _run_plan(self, qp: QueryPlan) -> Batch:
        ctx = self._new_ctx()
        out = run_plan(qp, ctx)
        self.last_stats = ctx.stats
        return out

    def run_batch(self, sql: str) -> Batch:
        """Execute to one compacted Batch on the runner's device."""
        qp = self._plan_cache.get(sql)  # a cached plan is never a statement
        if qp is None:
            stmt = parse_sql(sql)
            if is_ddl(stmt):
                return execute_data_definition(
                    stmt, self.catalog,
                    lambda q: self._run_plan(self._plan_statement(q)),
                    self.device)
            qp = self._plan_statement(stmt, sql)
        return self._run_plan(qp)

    def run(self, sql: str):
        """Execute and return a pandas DataFrame (host materialization)."""
        return self.run_batch(sql).to_pandas()
