"""Typed row-expression IR.

Analog of the reference's post-analysis expression IR
(presto-spi/src/main/java/com/facebook/presto/spi/relation/RowExpression.java,
CallExpression.java, SpecialFormExpression.java, ConstantExpression.java,
InputReferenceExpression.java) — the form the planner optimizes and the
"codegen" consumes. Here the consumer is the XLA tracer instead of ASM
bytecode (sql/gen/ExpressionCompiler.java).

Expressions are frozen/hashable so plans can be cached and compared.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from presto_tpu_torch.types import Type


@dataclasses.dataclass(frozen=True)
class RowExpression:
    type: Type


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpression):
    """Reference to a column of the input batch by name."""

    name: str = ""

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Constant(RowExpression):
    """A literal. value=None means typed NULL. Strings stay as python str
    until compile time, when they are resolved against the relevant
    dictionary. raw=True means the value is already in device representation
    (e.g. an unscaled decimal bound from a scalar subquery result)."""

    value: object = None
    raw: bool = False

    def __str__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    """Function / operator / special-form application.

    fn names (the built-in scalar surface, analog of operator/scalar/*):
      arithmetic: add sub mul div mod neg abs
      comparison: eq ne lt le gt ge
      boolean:    and or not          (Kleene three-valued logic)
      null:       is_null is_not_null coalesce nullif
      control:    if  (cond, then, else)  case handled by nesting ifs
      membership: in (value, *constants)  between (v, lo, hi)
      string:     like (value, pattern-const)  [host-evaluated over dict]
      cast:       cast (target type = self.type)
      math:       sqrt exp ln floor ceil round power
      date:       year month day extract_* date_add_days
    """

    fn: str = ""
    args: Tuple[RowExpression, ...] = ()

    def __str__(self):
        return f"{self.fn}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class LambdaExpr(RowExpression):
    """Typed lambda argument of a higher-order function. `params` are
    (unique plan symbol, element Type) pairs; the body references them as
    InputRefs. `type` is the body's type (spi/relation/
    LambdaDefinitionExpression analog)."""

    params: Tuple[Tuple[str, "Type"], ...] = ()
    body: Optional[RowExpression] = None

    def __str__(self):
        ps = ", ".join(n for n, _ in self.params)
        return f"({ps}) -> {self.body}"


@dataclasses.dataclass(frozen=True)
class Param(RowExpression):
    """Placeholder bound before compilation — carries the value of an
    uncorrelated scalar subquery (reference: SubqueryPlanner's handling of
    uncorrelated scalar subqueries, applied at execution time here)."""

    name: str = ""

    def __str__(self):
        return f"${self.name}"


def substitute_params(e: RowExpression, bindings: dict) -> RowExpression:
    """Replace Param nodes with Constants (bindings: name -> Constant)."""
    if isinstance(e, Param):
        if e.name not in bindings:
            raise KeyError(f"unbound parameter {e.name}")
        return bindings[e.name]
    if isinstance(e, Call):
        new_args = tuple(substitute_params(a, bindings) for a in e.args)
        if new_args != e.args:
            return Call(e.type, e.fn, new_args)
    return e


def substitute_refs(e: RowExpression, mapping: dict) -> RowExpression:
    """Rename InputRefs (symbol -> symbol), for pushdown through Project."""
    if isinstance(e, InputRef) and e.name in mapping:
        m = mapping[e.name]
        return m if isinstance(m, RowExpression) else InputRef(e.type, m)
    if isinstance(e, LambdaExpr):
        # lambda params shadow outer symbols
        inner = {k: v for k, v in mapping.items()
                 if k not in {n for n, _ in e.params}}
        nb = substitute_refs(e.body, inner)
        if nb is not e.body:
            return LambdaExpr(e.type, e.params, nb)
        return e
    if isinstance(e, Call):
        new_args = tuple(substitute_refs(a, mapping) for a in e.args)
        if new_args != e.args:
            return Call(e.type, e.fn, new_args)
    return e


def expr_inputs(e: RowExpression, acc: Optional[set] = None) -> set:
    """Collect referenced input column names (for projection pruning)."""
    if acc is None:
        acc = set()
    if isinstance(e, InputRef):
        acc.add(e.name)
    elif isinstance(e, LambdaExpr):
        inner: set = set()
        expr_inputs(e.body, inner)
        acc |= inner - {n for n, _ in e.params}
    elif isinstance(e, Call):
        for a in e.args:
            expr_inputs(a, acc)
    return acc
