"""Iterative rule-based optimizer — pattern-matched plan rewrites to
fixpoint.

Reference: sql/planner/iterative/IterativeOptimizer.java + Rule.java and
the presto-matching pattern DSL (Pattern.typeOf().matching(...)): rules
declare a node pattern and a rewrite; the driver applies them bottom-up
until no rule fires (with a trip-count guard). The big visitor passes
(filter pushdown, column pruning — plan/optimizer.py) stay as passes;
this engine hosts the local algebraic rewrites the reference expresses
as iterative/rule/*.java.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from presto_tpu_torch.expr.ir import InputRef, substitute_refs
from presto_tpu_torch.plan.nodes import (
    Filter,
    Limit,
    PlanNode,
    Project,
    Sort,
)


class Pattern:
    """typeOf(cls).matching(pred) — the matching-DSL surface."""

    def __init__(self, node_type, pred: Optional[Callable] = None):
        self.node_type = node_type
        self.pred = pred

    @staticmethod
    def type_of(node_type) -> "Pattern":
        return Pattern(node_type)

    def matching(self, pred: Callable) -> "Pattern":
        return Pattern(self.node_type, pred)

    def matches(self, node) -> bool:
        if not isinstance(node, self.node_type):
            return False
        return self.pred is None or bool(self.pred(node))


class Rule:
    """Subclasses set `pattern` and implement apply() → replacement node
    or None (no change)."""

    pattern: Pattern

    def apply(self, node: PlanNode) -> Optional[PlanNode]:
        raise NotImplementedError


# -- the rule set -----------------------------------------------------------


class MergeAdjacentFilters(Rule):
    """Filter(Filter(x)) → Filter(x, a AND b)
    (reference: iterative/rule/MergeFilters)."""

    pattern = Pattern.type_of(Filter).matching(
        lambda n: isinstance(n.child, Filter))

    def apply(self, node: Filter):
        from presto_tpu_torch.expr.ir import Call
        from presto_tpu_torch.types import BOOLEAN

        inner = node.child
        return Filter(inner.child,
                      Call(BOOLEAN, "and", (inner.predicate, node.predicate)))


class RemoveIdentityProject(Rule):
    """Project that re-emits its child's columns unchanged disappears
    (reference: iterative/rule/RemoveRedundantIdentityProjections)."""

    pattern = Pattern.type_of(Project)

    def apply(self, node: Project):
        child_names = [n for n, _ in node.child.output]
        if len(node.exprs) != len(child_names):
            return None
        if all(isinstance(e, InputRef) and e.name == s and s == cn
               for (s, e), cn in zip(node.exprs, child_names)):
            return node.child
        return None


class CollapseAdjacentProjects(Rule):
    """Project(Project(x)) → Project(x) with inner expressions substituted
    into the outer ones (reference: iterative/rule/MergeProjections /
    InlineProjections). Substitution only when every outer reference to a
    non-trivial inner expression is used ONCE — duplicating a computed
    expression would re-evaluate it."""

    pattern = Pattern.type_of(Project).matching(
        lambda n: isinstance(n.child, Project))

    def apply(self, node: Project):
        from presto_tpu_torch.expr.ir import Call, LambdaExpr

        inner: Project = node.child
        mapping = {s: e for s, e in inner.exprs}
        uses: dict = {}

        def count(e):  # per OCCURRENCE, not per distinct symbol
            if isinstance(e, InputRef):
                uses[e.name] = uses.get(e.name, 0) + 1
            elif isinstance(e, LambdaExpr):
                count(e.body)
            elif isinstance(e, Call):
                for a in e.args:
                    count(a)

        for _, e in node.exprs:
            count(e)
        for s, e in inner.exprs:
            if not isinstance(e, InputRef) and uses.get(s, 0) > 1:
                return None  # would duplicate a computed expression
        new_exprs = [(s, substitute_refs(e, mapping)) for s, e in node.exprs]
        return Project(inner.child, new_exprs)


class MergeLimits(Rule):
    """Limit(Limit(x)) → Limit(x, min) (reference: MergeLimits)."""

    pattern = Pattern.type_of(Limit).matching(
        lambda n: isinstance(n.child, Limit))

    def apply(self, node: Limit):
        return Limit(node.child.child, min(node.count, node.child.count))


class LimitIntoSort(Rule):
    """Limit(Sort(x)) → Sort(x, limit) — a TopN instead of a full sort
    (reference: LimitPushDown / TopN creation)."""

    pattern = Pattern.type_of(Limit).matching(
        lambda n: isinstance(n.child, Sort))

    def apply(self, node: Limit):
        s: Sort = node.child
        limit = node.count if s.limit is None else min(node.count, s.limit)
        return Sort(s.child, s.keys, limit)


class LimitThroughProject(Rule):
    """Limit(Project(x)) → Project(Limit(x)) — limits travel toward the
    source (reference: PushLimitThroughProject)."""

    pattern = Pattern.type_of(Limit).matching(
        lambda n: isinstance(n.child, Project))

    def apply(self, node: Limit):
        p: Project = node.child
        return Project(Limit(p.child, node.count), p.exprs)


DEFAULT_RULES: List[Rule] = [
    MergeAdjacentFilters(),
    CollapseAdjacentProjects(),
    RemoveIdentityProject(),
    MergeLimits(),
    LimitIntoSort(),
    LimitThroughProject(),
]

_CHILD_ATTRS = ("child", "left", "right")


class IterativeOptimizer:
    """Bottom-up fixpoint driver with a trip-count guard
    (IterativeOptimizer.java's exploration loop without the memo/groups —
    the plan is a tree here, not a DAG of group references)."""

    def __init__(self, rules: Optional[List[Rule]] = None,
                 max_passes: int = 20):
        self.rules = list(rules or DEFAULT_RULES)
        self.max_passes = max_passes

    def optimize(self, root: PlanNode) -> PlanNode:
        for _ in range(self.max_passes):
            root, changed = self._rewrite(root)
            if not changed:
                break
        return root

    def _rewrite(self, node: PlanNode):
        changed = False
        for attr in _CHILD_ATTRS:
            child = getattr(node, attr, None)
            if isinstance(child, PlanNode):
                new_child, ch = self._rewrite(child)
                if ch:
                    setattr(node, attr, new_child)
                    changed = True
        for rule in self.rules:
            if rule.pattern.matches(node):
                out = rule.apply(node)
                if out is not None and out is not node:
                    return out, True
        return node, changed
