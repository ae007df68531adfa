"""SQL abstract syntax tree.

Analog of presto-parser's tree package (164 node classes under
presto-parser/src/main/java/com/facebook/presto/sql/tree/) — reduced to the
query surface this engine executes. Untyped; the analyzer lowers AST
expressions into the typed IR (presto_tpu_torch.expr.ir).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


# ---------------------------------------------------------------------------
# expressions


@dataclasses.dataclass
class Identifier(Node):
    parts: Tuple[str, ...]  # possibly qualified: (table, column) or (column,)

    def __str__(self):
        return ".".join(self.parts)


@dataclasses.dataclass
class Literal(Node):
    value: object  # int | float | str | bool | None
    kind: str  # 'integer' | 'decimal' | 'double' | 'string' | 'boolean' | 'null' | 'date'
    text: str = ""


@dataclasses.dataclass
class IntervalLiteral(Node):
    value: int
    unit: str  # 'day' | 'month' | 'year'


@dataclasses.dataclass
class UnaryOp(Node):
    op: str  # '-' | '+' | 'not'
    operand: Node


@dataclasses.dataclass
class BinaryOp(Node):
    op: str  # arithmetic / comparison / 'and' / 'or'
    left: Node
    right: Node


@dataclasses.dataclass
class Between(Node):
    value: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass
class InList(Node):
    value: Node
    items: List[Node]
    negated: bool = False


@dataclasses.dataclass
class InSubquery(Node):
    value: Node
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class ScalarSubquery(Node):
    query: "Query"


@dataclasses.dataclass
class Like(Node):
    value: Node
    pattern: Node
    escape: Optional[Node] = None
    negated: bool = False


@dataclasses.dataclass
class IsNull(Node):
    value: Node
    negated: bool = False


@dataclasses.dataclass
class FunctionCall(Node):
    name: str
    args: List[Node]
    distinct: bool = False
    is_star: bool = False  # count(*)


@dataclasses.dataclass
class WindowFunction(Node):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])."""

    name: str
    args: List[Node]
    partition_by: List[Node]
    order_by: List["OrderItem"]
    is_star: bool = False
    # frame: None = default (RANGE UNBOUNDED..CURRENT with ORDER BY, whole
    # partition otherwise); "rows_unbounded_current" = ROWS UNBOUNDED
    # PRECEDING..CURRENT ROW
    frame: object = None


@dataclasses.dataclass
class Parameter(Node):
    """`?` prepared-statement placeholder (bound before analysis by
    substitute_parameters; an unbound Parameter is an analysis error)."""

    index: int


def substitute_parameters(node, args: list):
    """Replace every ast.Parameter with its positional argument AST
    (generic dataclass walk — binding happens on the parse tree, never
    by text splicing). Returns (new_node, n_params_seen)."""
    seen = [0]

    def walk(x):
        if isinstance(x, Parameter):
            seen[0] = max(seen[0], x.index + 1)
            if x.index < len(args):
                return args[x.index]
            return x
        if isinstance(x, Node):
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                nv = walk(v)
                if nv is not v:
                    changes[f.name] = nv
            return dataclasses.replace(x, **changes) if changes else x
        if isinstance(x, list):
            out = [walk(v) for v in x]
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, tuple):
            out = tuple(walk(v) for v in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        return x

    return walk(node), seen[0]


@dataclasses.dataclass
class Lambda(Node):
    """`x -> body` / `(a, b) -> body` — argument to higher-order array
    functions (SqlBase.g4 lambda; spi/function/LambdaDefinitionExpression)."""

    params: list
    body: Node


@dataclasses.dataclass
class Cast(Node):
    value: Node
    type_name: str


@dataclasses.dataclass
class Case(Node):
    operand: Optional[Node]  # simple CASE x WHEN ... vs searched CASE WHEN
    whens: List[Tuple[Node, Node]]
    default: Optional[Node]


@dataclasses.dataclass
class Extract(Node):
    field: str  # 'year' | 'month' | 'day'
    value: Node


@dataclasses.dataclass
class Star(Node):
    qualifier: Optional[str] = None


# ---------------------------------------------------------------------------
# relations


@dataclasses.dataclass
class Table(Node):
    name: Tuple[str, ...]
    alias: Optional[str] = None


@dataclasses.dataclass
class SubqueryRelation(Node):
    query: "Query"
    alias: str = ""


@dataclasses.dataclass
class Join(Node):
    kind: str  # 'inner' | 'left' | 'right' | 'cross'
    left: Node
    right: Node
    condition: Optional[Node] = None


@dataclasses.dataclass
class ValuesRelation(Node):
    """(VALUES ...) [AS alias (col, ...)] — `query` is the desugared
    UNION-ALL-of-one-row-SELECTs body (RelationPlanner.visitValues)."""

    query: Node  # Query | SetOp
    alias: str = "values"
    column_names: Optional[list] = None


@dataclasses.dataclass
class UnnestRelation(Node):
    """UNNEST(expr, ...) [WITH ORDINALITY] [AS alias (col, ...)].

    As the right side of CROSS JOIN it is lateral: the expressions may
    reference the left relation's columns (SqlBase.g4 unnest /
    planner/plan/UnnestNode)."""

    exprs: list
    ordinality: bool = False
    alias: Optional[str] = None
    column_names: Optional[list] = None


# ---------------------------------------------------------------------------
# query


@dataclasses.dataclass
class GroupingSets(Node):
    """GROUP BY GROUPING SETS / ROLLUP / CUBE, expanded to explicit key
    sets. Appears as the sole element of Query.group_by."""

    sets: list  # List[List[Node]]


@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass
class OrderItem(Node):
    expr: Node
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = default (last for asc)


@dataclasses.dataclass
class Query(Node):
    select: List[SelectItem]
    distinct: bool = False
    from_: Optional[Node] = None
    where: Optional[Node] = None
    group_by: List[Node] = dataclasses.field(default_factory=list)
    having: Optional[Node] = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    ctes: List[Tuple[str, "Query"]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CreateTableAs(Node):
    """CREATE TABLE [IF NOT EXISTS] name [WITH (props)] AS query
    (reference: execution/CreateTableTask.java + the TableWriter chain;
    properties e.g. partitioned_by = array['c'] as in the hive
    connector's HiveTableProperties)."""

    name: Tuple[str, ...]
    query: Node  # Query | SetOp
    if_not_exists: bool = False
    properties: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Insert(Node):
    """INSERT INTO name query (reference: TableWriterOperator +
    TableFinishOperator row-count result)."""

    name: Tuple[str, ...]
    query: Node


@dataclasses.dataclass
class CreateTable(Node):
    """CREATE TABLE name (col type, ...) — empty table with an explicit
    schema (execution/CreateTableTask without the AS-query source)."""

    name: Tuple[str, ...]
    columns: list  # [(name, type_string)]
    if_not_exists: bool = False
    properties: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW name AS query — stored-query expansion at
    plan time (execution/CreateViewTask; views are engine-level here, not
    connector metadata)."""

    name: Tuple[str, ...]
    query: Node
    or_replace: bool = False


@dataclasses.dataclass
class DropView(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass
class Delete(Node):
    """DELETE FROM name [WHERE cond] — rewrite-based (kept rows are those
    where the predicate is not TRUE)."""

    name: Tuple[str, ...]
    where: Optional[Node] = None


@dataclasses.dataclass
class Truncate(Node):
    name: Tuple[str, ...]


@dataclasses.dataclass
class DropTable(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass
class SetOp(Node):
    """UNION [ALL] / INTERSECT / EXCEPT of two query bodies
    (SqlBase.g4:802 queryTerm; reference planner/plan/UnionNode,
    IntersectNode, ExceptNode). `order_by`/`limit` apply to the combined
    result; `ctes` from an enclosing WITH scope both sides."""

    kind: str  # 'union' | 'intersect' | 'except'
    all: bool
    left: Node  # Query | SetOp
    right: Node
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    ctes: List[Tuple[str, "Query"]] = dataclasses.field(default_factory=list)
