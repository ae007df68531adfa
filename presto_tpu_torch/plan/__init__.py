from presto_tpu_torch.plan.nodes import (
    PlanNode,
    TableScan,
    Filter,
    Project,
    Aggregate,
    AggSpec,
    HashJoin,
    SemiJoin,
    Sort,
    SortItem,
    Limit,
    Output,
    QueryPlan,
)
from presto_tpu_torch.plan.builder import plan_query

__all__ = [
    "PlanNode", "TableScan", "Filter", "Project", "Aggregate", "AggSpec",
    "HashJoin", "SemiJoin", "Sort", "SortItem", "Limit", "Output",
    "QueryPlan", "plan_query",
]
