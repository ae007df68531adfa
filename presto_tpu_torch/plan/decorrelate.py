"""Subquery decorrelation — AST→AST rewrites applied before planning.

The reference implements decorrelation as plan rewrites
(TransformCorrelatedScalarAggregationToJoin, TransformExistsApplyToLateralNode,
PlanNodeDecorrelator under sql/planner/optimizations + iterative/rule).
Here the classic cases are rewritten at the AST level, which composes with
the existing planner without an Apply/Lateral node:

1. [NOT] EXISTS (SELECT ... FROM t WHERE outer = inner AND rest)
     → outer [NOT] IN (SELECT inner FROM t WHERE rest)          (Q4, Q21-lite)

2. expr CMP (SELECT agg(x) FROM t WHERE inner = outer [AND rest])   (Q2, Q17)
     → join a grouped derived table on the correlation key:
       FROM ..., (SELECT inner AS __ck, agg(x) AS __agg FROM t
                  [WHERE rest] GROUP BY inner) __dtN
       WHERE __dtN.__ck = outer AND expr CMP __dtN.__agg
   (valid in WHERE position: an empty subquery yields NULL which fails the
   comparison, exactly like the dropped row of the inner join)

Correlation detection is name-based: a column referenced in the subquery
that does not resolve against the subquery's own FROM (via catalog schemas)
is an outer reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.sql import ast


def _relation_columns(rel, catalog: Catalog, ctes: Dict[str, ast.Query]) -> Set[str]:
    """Column names visible from a FROM tree (unqualified)."""
    if rel is None:
        return set()
    if isinstance(rel, ast.Table):
        name = rel.name[-1]
        if len(rel.name) == 1 and name in ctes:
            sub = ctes[name]
            out = set()
            for it in sub.select:
                if it.alias:
                    out.add(it.alias)
                elif isinstance(it.expr, ast.Identifier):
                    out.add(it.expr.parts[-1])
            return out
        try:
            _, handle = catalog.resolve(rel.name)
        except KeyError:
            return set()
        return {c.name for c in handle.columns}
    if isinstance(rel, ast.SubqueryRelation):
        out = set()
        for it in rel.query.select:
            if it.alias:
                out.add(it.alias)
            elif isinstance(it.expr, ast.Identifier):
                out.add(it.expr.parts[-1])
        return out
    if isinstance(rel, ast.Join):
        return _relation_columns(rel.left, catalog, ctes) | _relation_columns(
            rel.right, catalog, ctes
        )
    return set()


def _relation_names(rel) -> Set[str]:
    """Relation aliases/names visible from a FROM tree — the qualifiers
    an identifier may carry to resolve INSIDE the subquery."""
    if rel is None:
        return set()
    if isinstance(rel, ast.Table):
        return {rel.alias or rel.name[-1]}
    if isinstance(rel, ast.SubqueryRelation):
        return {rel.alias} if rel.alias else set()
    if isinstance(rel, ast.Join):
        return _relation_names(rel.left) | _relation_names(rel.right)
    return set()


def _split_conjuncts(e) -> List:
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _combine(es: List) -> Optional[ast.Node]:
    if not es:
        return None
    out = es[0]
    for e in es[1:]:
        out = ast.BinaryOp("and", out, e)
    return out


def _factor_or(c) -> List:
    """(a AND x) OR (a AND y) → a AND (x OR y). Returns conjunct list."""
    if not (isinstance(c, ast.BinaryOp) and c.op == "or"):
        return [c]

    def branches(n):
        if isinstance(n, ast.BinaryOp) and n.op == "or":
            return branches(n.left) + branches(n.right)
        return [n]

    from presto_tpu_torch.plan.builder import ast_key

    brs = [_split_conjuncts(b) for b in branches(c)]
    if len(brs) < 2:
        return [c]
    common_keys = set(ast_key(x) for x in brs[0])
    for b in brs[1:]:
        common_keys &= {ast_key(x) for x in b}
    if not common_keys:
        return [c]
    hoisted = [x for x in brs[0] if ast_key(x) in common_keys]
    residual_branches = []
    for b in brs:
        rest = [x for x in b if ast_key(x) not in common_keys]
        if not rest:
            # a branch fully covered by the common part → OR is implied true
            residual_branches = None
            break
        residual_branches.append(_combine(rest))
    out = list(hoisted)
    if residual_branches is not None:
        orr = residual_branches[0]
        for b in residual_branches[1:]:
            orr = ast.BinaryOp("or", orr, b)
        out.append(orr)
    return out


def _find_correlation(
    sub: ast.Query, catalog: Catalog, ctes: Dict[str, ast.Query]
) -> Optional[Tuple[List[Tuple[ast.Identifier, ast.Identifier]], List]]:
    """If sub's WHERE contains `inner_col = outer_col` conjuncts (one side
    resolving in sub's FROM, the other not), return
    ([(outer_ident, inner_ident), ...], remaining_conjuncts)."""
    if sub.where is None:
        return None
    inner_cols = _relation_columns(sub.from_, catalog, ctes)
    inner_rels = _relation_names(sub.from_)

    def is_inner(ident: ast.Identifier) -> bool:
        # unqualified: resolves against the subquery's columns;
        # qualified: the qualifier must name a subquery relation —
        # `t1.k` stays an OUTER ref even when the inner table also has
        # a column `k`
        if len(ident.parts) == 1:
            return ident.parts[0] in inner_cols
        return ident.parts[0] in inner_rels

    conjs = _split_conjuncts(sub.where)
    pairs: List[Tuple[ast.Identifier, ast.Identifier]] = []
    rest = []
    for c in conjs:
        if (
            isinstance(c, ast.BinaryOp)
            and c.op == "eq"
            and isinstance(c.left, ast.Identifier)
            and isinstance(c.right, ast.Identifier)
        ):
            l_in = is_inner(c.left)
            r_in = is_inner(c.right)
            if l_in and not r_in:
                pairs.append((c.right, c.left))
                continue
            if r_in and not l_in:
                pairs.append((c.left, c.right))
                continue
        rest.append(c)
    if not pairs:
        return None
    # any remaining outer references → too correlated for these rewrites
    outer_refs = set()

    def scan(n):
        if isinstance(n, ast.Identifier) and not is_inner(n):
            outer_refs.add(".".join(n.parts))
        for ch in _children(n):
            scan(ch)

    for c in rest:
        scan(c)
    for it in sub.select:
        scan(it.expr)
    if outer_refs:
        return None
    return pairs, rest


def _children(n):
    from presto_tpu_torch.plan.builder import _ast_children

    return _ast_children(n)


class Decorrelator:
    def __init__(self, catalog: Catalog, ctes: Dict[str, ast.Query]):
        self.catalog = catalog
        self.ctes = ctes
        self.derived: List[ast.Join] = []  # pending joins to graft onto FROM
        self.counter = 0

    def rewrite_where(self, q: ast.Query) -> None:
        """Rewrite EXISTS and correlated scalar subqueries in q.where;
        grafts derived-table joins onto q.from_."""
        if q.where is None:
            return
        conjs = _split_conjuncts(q.where)
        # OR factoring: hoist conjuncts common to every OR branch
        # (ExtractCommonPredicatesExpressionRewriter analog) — unlocks the
        # Q19 shape where the equi-join conjunct lives inside each branch
        expanded = []
        for c in conjs:
            expanded.extend(_factor_or(c))
        conjs = expanded
        self._mode = "cross"
        out = []
        for c in conjs:
            out.append(self._rewrite_conjunct(c))
        # graft derived tables: plain aggregates become cross joins +
        # WHERE equi-conjuncts (the planner's comma-join assembly orders
        # them with everything else); count-like ones must LEFT-join with
        # the condition in ON (a WHERE conjunct would re-drop the
        # null-extended row whose true count is 0)
        for kind, dt, cond in self._pending:
            if kind == "left":
                q.from_ = ast.Join("left", q.from_, dt, cond)
            else:
                q.from_ = ast.Join("cross", q.from_, dt, None)
                out.append(cond)
        self._pending = []
        q.where = _combine(out)

    def rewrite_select(self, q: ast.Query) -> None:
        """Correlated scalar-aggregate subqueries in the SELECT list:
        LEFT-JOIN the grouped derived table (a missing group must yield
        NULL, not drop the outer row — the semantic difference from the
        WHERE-position rewrite; reference:
        TransformCorrelatedScalarAggregationToJoin)."""
        if q.from_ is None:
            return
        self._mode = "left"
        self._pending = []
        for it in q.select:
            it.expr = self._rewrite_scalar(it.expr)
        for _, dt, cond in self._pending:
            q.from_ = ast.Join("left", q.from_, dt, cond)
        self._pending = []

    _pending: List

    def _rewrite_conjunct(self, c):
        self._pending = getattr(self, "_pending", [])
        # EXISTS stays an AST node — the planner lowers it directly to a
        # SemiJoin with keys + residual (null_aware=False)
        # comparisons containing correlated scalar aggregates
        if isinstance(c, ast.BinaryOp) and c.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            c.left = self._rewrite_scalar(c.left)
            c.right = self._rewrite_scalar(c.right)
        return c

    def _rewrite_scalar(self, e):
        """Replace a correlated scalar-aggregate subquery inside an
        expression with a reference into a grouped derived table."""
        if isinstance(e, ast.ScalarSubquery):
            from presto_tpu_torch.plan.builder import _contains_agg

            sub = e.query
            if (
                sub.group_by
                or len(sub.select) != 1
                or not _contains_agg(sub.select[0].expr)
            ):
                return e
            # count over an empty group is 0, not NULL: bare count()
            # rewrites with a coalesce + LEFT join; count buried in an
            # expression (count(*)+1) has no join-side compensation —
            # leave it to fail loudly rather than answer wrongly
            expr0 = sub.select[0].expr
            is_count = (isinstance(expr0, ast.FunctionCall)
                        and expr0.name.lower() in ("count", "count_if"))
            if not is_count and _contains_count(expr0):
                return e
            corr = _find_correlation(sub, self.catalog, self.ctes)
            if corr is None:
                return e  # uncorrelated: handled as a Param at plan time
            pairs, rest = corr
            self.counter += 1
            alias = f"__dt{self.counter}"
            key_items = [
                ast.SelectItem(inner, f"__ck{i}") for i, (_, inner) in enumerate(pairs)
            ]
            dq = ast.Query(
                select=key_items + [ast.SelectItem(sub.select[0].expr, "__agg")],
                from_=sub.from_,
                where=_combine(rest),
                group_by=[inner for _, inner in pairs],
            )
            dq.ctes = sub.ctes
            dt = ast.SubqueryRelation(dq, alias)
            cond = _combine([
                ast.BinaryOp("eq", ast.Identifier((alias, f"__ck{i}")), outer)
                for i, (outer, _) in enumerate(pairs)
            ])
            self._pending.append(
                ("left" if is_count else self._mode, dt, cond))
            ident = ast.Identifier((alias, "__agg"))
            if is_count:
                return ast.FunctionCall(
                    "coalesce", [ident, ast.Literal(0, "integer", "0")])
            return ident
        if isinstance(e, ast.BinaryOp):
            e.left = self._rewrite_scalar(e.left)
            e.right = self._rewrite_scalar(e.right)
        if isinstance(e, ast.UnaryOp):
            e.operand = self._rewrite_scalar(e.operand)
        if isinstance(e, ast.FunctionCall):
            e.args = [self._rewrite_scalar(a) for a in e.args]
        if isinstance(e, ast.Cast):
            e.value = self._rewrite_scalar(e.value)
        if isinstance(e, ast.Case):
            if e.operand is not None:
                e.operand = self._rewrite_scalar(e.operand)
            e.whens = [(self._rewrite_scalar(w), self._rewrite_scalar(t))
                       for w, t in e.whens]
            if e.default is not None:
                e.default = self._rewrite_scalar(e.default)
        if isinstance(e, ast.Between):
            e.value = self._rewrite_scalar(e.value)
            e.low = self._rewrite_scalar(e.low)
            e.high = self._rewrite_scalar(e.high)
        if isinstance(e, ast.IsNull):
            e.value = self._rewrite_scalar(e.value)
        if isinstance(e, ast.InList):
            e.value = self._rewrite_scalar(e.value)
            e.items = [self._rewrite_scalar(x) for x in e.items]
        return e


def _contains_count(n) -> bool:
    if isinstance(n, ast.FunctionCall) and n.name.lower() in ("count",
                                                              "count_if"):
        return True
    return any(_contains_count(c) for c in _children(n))


def decorrelate(q: ast.Query, catalog: Catalog, ctes: Dict[str, ast.Query]) -> ast.Query:
    import copy

    # the rewrites mutate expressions and FROM trees in place; a CTE body
    # is re-planned per reference from the SAME stored AST, so rewrite a
    # private deep copy (the reference rewrites immutable plan trees)
    q = copy.deepcopy(q)
    d = Decorrelator(catalog, dict(ctes))
    for name, sub in q.ctes:
        d.ctes[name] = sub
    d._pending = []
    d.rewrite_where(q)
    d.rewrite_select(q)
    return q
