"""LocalRunner — single-process query runner.

Analog of the reference's LocalQueryRunner: parse → plan → optimize →
execute in-process. Runs on the GPU unless the caller passes a device:
`device=None` means CUDA and raises when CUDA is absent.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from presto_tpu_torch import default_device
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec.runtime import (
    ExecConfig,
    ExecContext,
    mark_breaker_engines,
    run_plan,
)
from presto_tpu_torch.plan.builder import plan_query
from presto_tpu_torch.plan.nodes import QueryPlan, plan_to_string
from presto_tpu_torch.plan.optimizer import optimize


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

    def plan(self, sql: str) -> QueryPlan:
        qp = self._plan_cache.get(sql)
        if qp is not None:
            return qp
        qp = optimize(plan_query(sql, self.catalog), self.catalog)
        if not qp.scalar_subqueries and qp.cacheable:
            self._plan_cache[sql] = qp
        return qp

    def explain(self, sql: str) -> str:
        qp = self.plan(sql)
        mark_breaker_engines(qp.root, self._new_ctx())
        return plan_to_string(qp.root)

    def _new_ctx(self) -> ExecContext:
        return ExecContext(self.catalog, self.config, self.device)

    def run_batch(self, sql: str):
        """Execute to one compacted Batch on the runner's device."""
        ctx = self._new_ctx()
        out = run_plan(self.plan(sql), ctx)
        self.last_stats = ctx.stats
        return out

    def run(self, sql: str):
        """Execute and return a pandas DataFrame (host materialization)."""
        return self.run_batch(sql).to_pandas()
