"""SQL lexer + recursive-descent parser.

Analog of presto-parser (SqlBase.g4, 802-line ANTLR4 grammar +
parser/AstBuilder.java). Hand-written recursive descent over the query
subset the engine executes: SELECT .. FROM .. [JOIN ..] WHERE .. GROUP BY ..
HAVING .. ORDER BY .. LIMIT, WITH CTEs, subqueries (FROM / IN / EXISTS /
scalar), the TPC-H expression surface.

Operator precedence (low→high): OR, AND, NOT, comparison/IN/BETWEEN/LIKE/IS,
additive, multiplicative, unary.
"""

from __future__ import annotations

import re
from typing import List, Optional

from presto_tpu_torch.sql import ast

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "escape", "is",
    "null", "true", "false", "case", "when", "then", "else", "end", "cast",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "distinct", "all", "asc", "desc", "nulls", "first", "last", "exists",
    "date", "interval", "day", "month", "year", "extract", "with", "union",
    "intersect", "except",
    "substring", "for", "over", "partition", "rows", "range", "unbounded",
    "preceding", "following", "current", "row",
    "create", "insert", "drop", "table", "into", "if",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|->|\|\||[-+*/%(),.<>=;\[\]?])
    """,
    re.VERBOSE | re.DOTALL,
)


class Token:
    __slots__ = ("kind", "value", "pos", "quoted")

    def __init__(self, kind, value, pos, quoted=False):
        self.kind = kind  # 'number' | 'string' | 'ident' | 'keyword' | 'op' | 'eof'
        self.value = value
        self.pos = pos
        # "was a double-quoted identifier": quoting forces identifier
        # interpretation (a quoted current_date is a column, never the
        # niladic function)
        self.quoted = quoted

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


class ParseError(Exception):
    pass


def tokenize(sql: str) -> List[Token]:
    out = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        v = m.group()
        if m.lastgroup == "ident":
            low = v.lower()
            if low in _KEYWORDS:
                out.append(Token("keyword", low, m.start()))
            else:
                out.append(Token("ident", low, m.start()))
        elif m.lastgroup == "qident":
            out.append(Token("ident", v[1:-1].replace('""', '"'), m.start(),
                             quoted=True))
        elif m.lastgroup == "string":
            out.append(Token("string", v[1:-1].replace("''", "'"), m.start()))
        elif m.lastgroup == "number":
            out.append(Token("number", v, m.start()))
        else:
            out.append(Token("op", v, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers ----------------------------------------------------

    def peek(self, ahead=0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws) -> Optional[str]:
        t = self.peek()
        if t.kind == "keyword" and t.value in kws:
            self.next()
            return t.value
        return None

    def expect_kw(self, kw):
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()}, got {self.peek()!r}")

    def accept_op(self, *ops) -> Optional[str]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            self.next()
            return t.value
        return None

    def expect_op(self, op):
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r}, got {self.peek()!r}")

    def ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords as identifiers where unambiguous
        if t.kind in ("ident",) or (t.kind == "keyword" and t.value in (
                "year", "month", "day", "date", "first", "last", "if",
                "table", "into", "view", "replace", "delete", "truncate",
                "values")):
            self.next()
            return t.value
        raise ParseError(f"expected identifier, got {t!r}")

    def accept_word(self, w: str) -> bool:
        """Match a NON-reserved statement word (ident or keyword token) —
        words like view/replace/delete/truncate stay usable as function
        and column names."""
        t = self.peek()
        if t.kind in ("ident", "keyword") and t.value == w:
            self.next()
            return True
        return False

    # -- entry ------------------------------------------------------------

    def parse_statement(self) -> ast.Node:
        t = self.peek()
        if t.kind == "keyword" and t.value == "create":
            q = self._parse_create()
        elif t.kind == "keyword" and t.value == "insert":
            q = self._parse_insert()
        elif t.kind == "keyword" and t.value == "drop":
            q = self._parse_drop()
        elif t.kind in ("keyword", "ident") and t.value == "delete":
            self.next()
            self.expect_kw("from")
            name = self._qualified_name()
            where = None
            if self.accept_kw("where"):
                where = self.parse_expr()
            q = ast.Delete(name, where)
        elif t.kind in ("keyword", "ident") and t.value == "truncate":
            self.next()
            self.expect_kw("table")
            q = ast.Truncate(self._qualified_name())
        else:
            q = self.parse_query()
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise ParseError(f"trailing tokens at {self.peek()!r}")
        return q

    def _qualified_name(self):
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        return tuple(parts)

    def _parse_create(self) -> ast.Node:
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or"):
            if not self.accept_word("replace"):
                raise ParseError("expected REPLACE after CREATE OR")
            or_replace = True
        if self.accept_word("view"):
            name = self._qualified_name()
            self.expect_kw("as")
            return ast.CreateView(name, self.parse_query(), or_replace)
        if or_replace:
            raise ParseError("CREATE OR REPLACE applies to views only")
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self._qualified_name()
        if self.accept_op("("):
            # CREATE TABLE name (col type, ...)
            cols = []
            while True:
                cname = self.ident()
                tparts = [self.next().value]
                if self.accept_op("("):
                    targs = [self.next().value]
                    while self.accept_op(","):
                        targs.append(self.next().value)
                    self.expect_op(")")
                    tparts.append("(" + ",".join(targs) + ")")
                cols.append((cname, "".join(tparts)))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            props = self._parse_table_properties()
            return ast.CreateTable(name, cols, if_not_exists, props)
        props = self._parse_table_properties()
        self.expect_kw("as")
        q = self.parse_query()
        return ast.CreateTableAs(name, q, if_not_exists, props)

    def _parse_table_properties(self) -> dict:
        """WITH (key = <literal>, ...) — hive-style table properties;
        values are literals or ARRAY[<literals>]."""
        if not self.accept_kw("with"):
            return {}
        self.expect_op("(")
        props = {}

        def literal_value(e):
            if isinstance(e, ast.Literal):
                return e.value
            if (isinstance(e, ast.FunctionCall) and e.name == "array_ctor"
                    and all(isinstance(a, ast.Literal) for a in e.args)):
                return [a.value for a in e.args]
            raise ParseError(
                "table property values must be literals or arrays of "
                "literals")

        while True:
            key = self.ident()
            self.expect_op("=")
            props[key] = literal_value(self.parse_expr())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return props

    def _parse_insert(self) -> ast.Node:
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self._qualified_name()
        q = self.parse_query()
        return ast.Insert(name, q)

    def _parse_drop(self) -> ast.Node:
        self.expect_kw("drop")
        if self.accept_word("view"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropView(self._qualified_name(), if_exists)
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return ast.DropTable(self._qualified_name(), if_exists)

    def parse_query(self) -> ast.Query:
        ctes = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                ctes.append((name, sub))
                if not self.accept_op(","):
                    break
        q = self.parse_set_expr()
        q.ctes = ctes
        return q

    def parse_set_expr(self):
        """queryTerm (UNION [ALL|DISTINCT] | EXCEPT) queryTerm — INTERSECT
        binds tighter (SqlBase.g4:802 precedence). A trailing ORDER BY/LIMIT
        parsed by the rightmost body applies to the whole set operation."""
        left = self.parse_intersect_term()
        while True:
            if self.accept_kw("union"):
                kind = "union"
            elif self.accept_kw("except"):
                kind = "except"
            else:
                break
            all_ = bool(self.accept_kw("all"))
            if not all_:
                self.accept_kw("distinct")
            right = self.parse_intersect_term()
            left = ast.SetOp(kind, all_, left, right)
        if isinstance(left, ast.SetOp):
            left.order_by, left.limit = self._steal_order_limit(left)
            # a parenthesized rightmost operand keeps its own clauses; a
            # trailing ORDER BY/LIMIT may still follow the set op itself
            if not left.order_by and self.accept_kw("order"):
                self.expect_kw("by")
                left.order_by.append(self.parse_order_item())
                while self.accept_op(","):
                    left.order_by.append(self.parse_order_item())
            if left.limit is None and self.accept_kw("limit"):
                t = self.next()
                if t.kind != "number":
                    raise ParseError("LIMIT expects a number")
                left.limit = int(t.value)
        return left

    def parse_intersect_term(self):
        left = self.parse_query_term()
        while self.accept_kw("intersect"):
            all_ = bool(self.accept_kw("all"))
            if not all_:
                self.accept_kw("distinct")
            right = self.parse_query_term()
            left = ast.SetOp("intersect", all_, left, right)
        return left

    def parse_query_term(self):
        if (self.peek().kind == "op" and self.peek().value == "("
                and self._peek2_is_query()):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            q._parenthesized = True  # its ORDER BY/LIMIT is its own
            return q
        return self.parse_query_body()

    def _peek2_is_query(self) -> bool:
        # skip any depth of opening parens: "((select ..." is a query term
        ahead = 1
        t = self.peek(ahead)
        while t.kind == "op" and t.value == "(":
            ahead += 1
            t = self.peek(ahead)
        return t.kind == "keyword" and t.value in ("select", "with")

    def _steal_order_limit(self, node):
        """Move the rightmost body's ORDER BY/LIMIT up to the set op (a
        trailing clause binds to the whole set expression — unless the body
        was parenthesized, in which case the clause is its own)."""
        right = node.right
        while isinstance(right, ast.SetOp):
            right = right.right
        if getattr(right, "_parenthesized", False):
            return [], None
        order, limit = right.order_by, right.limit
        right.order_by, right.limit = [], None
        return order, limit

    def parse_query_body(self) -> ast.Query:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        self.accept_kw("all")
        select = [self.parse_select_item()]
        while self.accept_op(","):
            select.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_relation()
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        group_by: List[ast.Node] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            gs = self._try_grouping_construct()
            if gs is not None:
                group_by.append(gs)
            else:
                group_by.append(self.parse_expr())
                while self.accept_op(","):
                    group_by.append(self.parse_expr())
        having = None
        if self.accept_kw("having"):
            having = self.parse_expr()
        order_by: List[ast.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = None
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind == "op" and t.value == "?":
                self._param_count = getattr(self, "_param_count", 0) + 1
                limit = ast.Parameter(self._param_count - 1)
            elif t.kind != "number":
                raise ParseError("LIMIT expects a number")
            else:
                limit = int(t.value)
        return ast.Query(
            select=select, distinct=distinct, from_=from_, where=where,
            group_by=group_by, having=having, order_by=order_by, limit=limit,
        )

    def _try_grouping_construct(self):
        """ROLLUP(...), CUBE(...), GROUPING SETS ((..), ..) — expanded to
        an explicit set list at parse time (SqlBase.g4 groupingElement;
        planner/GroupIdNode is redesigned as a UNION ALL of aggregates)."""
        t = self.peek()
        if t.kind != "ident" or t.value not in ("rollup", "cube", "grouping"):
            return None
        if t.value == "grouping":
            nt = self.peek(1)
            if not (nt.kind == "ident" and nt.value == "sets"):
                return None
            self.next()
            self.next()
            self.expect_op("(")
            sets = []
            while True:
                self.expect_op("(")
                one = []
                if not (self.peek().kind == "op" and self.peek().value == ")"):
                    one.append(self.parse_expr())
                    while self.accept_op(","):
                        one.append(self.parse_expr())
                self.expect_op(")")
                sets.append(one)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return ast.GroupingSets(sets)
        kind = t.value
        if not (self.peek(1).kind == "op" and self.peek(1).value == "("):
            return None
        self.next()
        self.expect_op("(")
        cols = [self.parse_expr()]
        while self.accept_op(","):
            cols.append(self.parse_expr())
        self.expect_op(")")
        if kind == "rollup":
            sets = [cols[:i] for i in range(len(cols), -1, -1)]
        else:  # cube: every subset, preserving column order
            sets = []
            n = len(cols)
            for mask in range((1 << n) - 1, -1, -1):
                sets.append([cols[i] for i in range(n) if mask & (1 << i)])
        return ast.GroupingSets(sets)

    def parse_select_item(self) -> ast.SelectItem:
        t = self.peek()
        if t.kind == "op" and t.value == "*":
            self.next()
            return ast.SelectItem(ast.Star(), None)
        # qualified star: ident '.' '*'
        if (
            t.kind == "ident"
            and self.peek(1).kind == "op" and self.peek(1).value == "."
            and self.peek(2).kind == "op" and self.peek(2).value == "*"
        ):
            self.next(); self.next(); self.next()
            return ast.SelectItem(ast.Star(qualifier=t.value), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return ast.SelectItem(e, alias)

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return ast.OrderItem(e, asc, nulls_first)

    # -- relations --------------------------------------------------------

    def parse_relation(self) -> ast.Node:
        rel = self.parse_table_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.parse_table_primary()
                rel = ast.Join("cross", rel, right, None)
                continue
            kind = None
            if self.accept_kw("inner"):
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                kind = "full"
            if kind is not None:
                self.expect_kw("join")
            elif self.accept_kw("join"):
                kind = "inner"
            elif self.accept_op(","):
                right = self.parse_table_primary()
                rel = ast.Join("cross", rel, right, None)
                continue
            else:
                break
            right = self.parse_table_primary()
            self.expect_kw("on")
            cond = self.parse_expr()
            rel = ast.Join(kind, rel, right, cond)
        return rel

    def _parse_values(self) -> ast.Node:
        """VALUES (e, ...), (e, ...) → desugared UNION ALL of FROM-less
        SELECTs (planner/RelationPlanner.visitValues without a dedicated
        node — each row is a one-row projection)."""
        rows = []
        while True:
            if self.accept_op("("):
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
            else:
                row = [self.parse_expr()]  # VALUES 1, 2, 3 (single column)
            rows.append(row)
            if not self.accept_op(","):
                break
        arity = len(rows[0])
        for r in rows:
            if len(r) != arity:
                raise ParseError(
                    f"VALUES rows differ in arity ({arity} vs {len(r)})")

        def row_query(row):
            items = [ast.SelectItem(e, f"_col{i}")
                     for i, e in enumerate(row)]
            return ast.Query(select=items)

        node = row_query(rows[0])
        for r in rows[1:]:
            node = ast.SetOp("union", True, node, row_query(r))
        return node

    def parse_table_primary(self) -> ast.Node:
        if (self.peek().kind in ("keyword", "ident")
                and self.peek().value == "values"
                and self.peek(1).kind == "op"
                and self.peek(1).value in ("(",)):
            self.next()
            q = self._parse_values()
            alias = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "ident":
                alias = self.ident()
            cols = None
            if alias is not None and self.accept_op("("):
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            return ast.ValuesRelation(q, alias or "values", cols)
        if (self.peek().kind == "ident" and self.peek().value == "unnest"
                and self.peek(1).kind == "op" and self.peek(1).value == "("):
            self.next()
            self.expect_op("(")
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            ordinality = False
            if self.accept_kw("with"):
                word = self.ident()
                if word != "ordinality":
                    raise ParseError(f"expected ORDINALITY, got {word}")
                ordinality = True
            alias = cols = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "ident":
                alias = self.ident()
            if alias is not None and self.accept_op("("):
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            return ast.UnnestRelation(exprs, ordinality, alias, cols)
        if self.accept_op("("):
            if (self.peek().kind in ("keyword", "ident")
                    and self.peek().value == "values"):
                self.next()
                q = self._parse_values()
                self.expect_op(")")
                alias = None
                if self.accept_kw("as"):
                    alias = self.ident()
                elif self.peek().kind == "ident":
                    alias = self.ident()
                cols = None
                if alias is not None and self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                return ast.ValuesRelation(q, alias or "values", cols)
            if self.peek().kind == "keyword" and self.peek().value in ("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                self.accept_kw("as")
                alias = self.ident()
                return ast.SubqueryRelation(q, alias)
            rel = self.parse_relation()
            self.expect_op(")")
            return rel
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.ident()
        return ast.Table(tuple(parts), alias)

    # -- expressions ------------------------------------------------------

    def parse_expr(self) -> ast.Node:
        # lambda: `x -> body` or `(x, y) -> body` (valid only in function
        # argument position; the analyzer rejects stray lambdas)
        t = self.peek()
        if (t.kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).value == "->"):
            name = self.ident()
            self.next()  # ->
            return ast.Lambda([name], self.parse_expr())
        if (t.kind == "op" and t.value == "(" and self.peek(1).kind == "ident"
                and self.peek(2).kind == "op"
                and self.peek(2).value in (",", ")")):
            # lookahead for "(a, b) ->"
            save = self.i
            try:
                self.next()
                params = [self.ident()]
                while self.accept_op(","):
                    params.append(self.ident())
                if (self.accept_op(")")
                        and self.peek().kind == "op"
                        and self.peek().value == "->"):
                    self.next()
                    return ast.Lambda(params, self.parse_expr())
            except ParseError:
                pass
            self.i = save
        return self.parse_or()

    def parse_or(self) -> ast.Node:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = ast.BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Node:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = ast.BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> ast.Node:
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Node:
        left = self.parse_additive()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect_kw("and")
                high = self.parse_additive()
                left = ast.Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.peek().kind == "keyword" and self.peek().value in ("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                    self.expect_op(")")
                    left = ast.InList(left, items, negated)
                continue
            if self.accept_kw("like"):
                pattern = self.parse_additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self.parse_additive()
                left = ast.Like(left, pattern, escape, negated)
                continue
            if negated:
                self.i = save
                break
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                self.expect_kw("null")
                left = ast.IsNull(left, neg)
                continue
            op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
            if op:
                opmap = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt",
                         "<=": "le", ">": "gt", ">=": "ge"}
                right = self.parse_additive()
                left = ast.BinaryOp(opmap[op], left, right)
                continue
            break
        return left

    def parse_additive(self) -> ast.Node:
        left = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-", "||")
            if not op:
                break
            right = self.parse_multiplicative()
            left = ast.BinaryOp({"+": "add", "-": "sub", "||": "concat"}[op], left, right)
        return left

    def parse_multiplicative(self) -> ast.Node:
        left = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                break
            right = self.parse_unary()
            left = ast.BinaryOp({"*": "mul", "/": "div", "%": "mod"}[op], left, right)
        return left

    def parse_unary(self) -> ast.Node:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        e = self.parse_primary()
        while self.accept_op("["):
            idx = self.parse_expr()
            self.expect_op("]")
            e = ast.FunctionCall("subscript", [e, idx])
        return e

    def parse_primary(self) -> ast.Node:
        t = self.peek()
        if t.kind == "op" and t.value == "?":
            # prepared-statement parameter, bound at EXECUTE time
            self.next()
            self._param_count = getattr(self, "_param_count", 0) + 1
            return ast.Parameter(self._param_count - 1)
        # literals
        if t.kind == "number":
            self.next()
            txt = t.value
            if re.fullmatch(r"\d+", txt):
                return ast.Literal(int(txt), "integer", txt)
            if "e" in txt.lower():
                return ast.Literal(float(txt), "double", txt)
            return ast.Literal(float(txt), "decimal", txt)
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value, "string", t.value)
        if t.kind == "keyword":
            kw = t.value
            if kw == "null":
                self.next()
                return ast.Literal(None, "null")
            if kw in ("true", "false"):
                self.next()
                return ast.Literal(kw == "true", "boolean")
            if kw == "date":
                # DATE 'yyyy-mm-dd'
                if self.peek(1).kind == "string":
                    self.next()
                    s = self.next().value
                    return ast.Literal(s, "date", s)
            if kw == "interval":
                self.next()
                v = self.next()
                if v.kind != "string":
                    raise ParseError("INTERVAL expects a quoted value")
                unit_tok = self.next()
                unit = unit_tok.value.lower().rstrip("s")
                if unit not in ("day", "month", "year"):
                    raise ParseError(f"unsupported interval unit {unit}")
                return ast.IntervalLiteral(int(v.value), unit)
            if kw == "case":
                return self.parse_case()
            if kw == "cast":
                self.next()
                return self._parse_cast_body()
            if kw == "extract":
                self.next()
                self.expect_op("(")
                field = self.next().value.lower()
                self.expect_kw("from")
                e = self.parse_expr()
                self.expect_op(")")
                return ast.Extract(field, e)
            if kw == "exists":
                self.next()
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                return ast.Exists(q)
            if kw == "substring":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                if self.accept_kw("from"):
                    start = self.parse_expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.parse_expr()
                else:
                    self.expect_op(",")
                    start = self.parse_expr()
                    length = None
                    if self.accept_op(","):
                        length = self.parse_expr()
                self.expect_op(")")
                args = [e, start] + ([length] if length is not None else [])
                return ast.FunctionCall("substr", args)
            if kw in ("year", "month", "day") and self.peek(1).kind == "op" and self.peek(1).value == "(":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_op(")")
                return ast.Extract(kw, e)
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "keyword" and self.peek().value in ("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        # identifier or function call
        if t.kind in ("ident", "keyword"):
            was_quoted = t.quoted
            name = self.ident()
            if (name == "try_cast" and not was_quoted
                    and self.peek().kind == "op"
                    and self.peek().value == "("):
                # TRY_CAST(x AS t) ≡ CAST: device casts already yield
                # NULL on unparseable input (the engine's documented
                # row-level-error deviation), which IS try semantics
                return self._parse_cast_body()
            if (name == "timestamp" and not was_quoted
                    and self.peek().kind == "string"):
                # TIMESTAMP 'yyyy-mm-dd[ hh:mm:ss[.ffffff]]'
                s = self.next().value
                return ast.Literal(s, "timestamp", s)
            if (name == "time" and not was_quoted
                    and self.peek().kind == "string"):
                # TIME 'hh:mm:ss[.ffffff]'
                s = self.next().value
                return ast.Literal(s, "time", s)
            if name in ("current_date", "current_timestamp",
                        "localtimestamp") and not was_quoted and not (
                    self.peek().kind == "op"
                    and self.peek().value in ("(", ".")):
                # niladic datetime functions (standard SQL: no parens)
                return ast.FunctionCall(
                    "current_timestamp" if name == "localtimestamp"
                    else name, [])
            if name == "array" and self.peek().kind == "op" and self.peek().value == "[":
                # ARRAY[e1, .., eN] literal constructor
                self.next()
                items = []
                if not (self.peek().kind == "op" and self.peek().value == "]"):
                    items.append(self.parse_expr())
                    while self.accept_op(","):
                        items.append(self.parse_expr())
                self.expect_op("]")
                return ast.FunctionCall("array_ctor", items)
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                if self.accept_op("*"):
                    self.expect_op(")")
                    fc = ast.FunctionCall(name, [], is_star=True)
                else:
                    distinct = bool(self.accept_kw("distinct"))
                    args = []
                    if not (self.peek().kind == "op" and self.peek().value == ")"):
                        args.append(self.parse_expr())
                        while self.accept_op(","):
                            args.append(self.parse_expr())
                    self.expect_op(")")
                    fc = ast.FunctionCall(name, args, distinct=distinct)
                if self.accept_kw("over"):
                    return self.parse_over(fc)
                return fc
            parts = [name]
            while self.accept_op("."):
                parts.append(self.ident())
            return ast.Identifier(tuple(parts))
        raise ParseError(f"unexpected token {t!r}")

    def parse_over(self, fc: ast.FunctionCall) -> ast.Node:
        """OVER (PARTITION BY ... ORDER BY ... [ROWS|RANGE frame])."""
        self.expect_op("(")
        partition_by = []
        order_by = []
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.accept_op(","):
                partition_by.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        if self.accept_kw("rows"):
            if self.accept_kw("between"):
                s = self._parse_frame_bound(is_start=True)
                self.expect_kw("and")
                e = self._parse_frame_bound(is_start=False)
            else:
                # shorthand: ROWS <bound> == BETWEEN <bound> AND CURRENT ROW
                s = self._parse_frame_bound(is_start=True)
                if s.startswith("f"):
                    raise ParseError(
                        "frame shorthand bound must be UNBOUNDED PRECEDING, "
                        "n PRECEDING or CURRENT ROW")
                e = "cur"
            frame = ("rows_unbounded_current" if (s, e) == ("up", "cur")
                     else f"rows:{s}:{e}")
        elif self.accept_kw("range"):
            if self.accept_kw("between"):
                s = self._parse_frame_bound(is_start=True)
                self.expect_kw("and")
                e = self._parse_frame_bound(is_start=False)
            else:
                s = self._parse_frame_bound(is_start=True)
                if s.startswith("f"):
                    raise ParseError(
                        "frame shorthand bound must be UNBOUNDED PRECEDING, "
                        "n PRECEDING or CURRENT ROW")
                e = "cur"
            # UNBOUNDED PRECEDING..CURRENT ROW is exactly the default
            # frame (peer-inclusive running aggregate) — leave frame unset
            frame = None if (s, e) == ("up", "cur") else f"range:{s}:{e}"
        self.expect_op(")")
        return ast.WindowFunction(
            fc.name, fc.args, partition_by, order_by, fc.is_star, frame
        )

    def _parse_frame_bound(self, is_start: bool) -> str:
        """UNBOUNDED PRECEDING|FOLLOWING, n PRECEDING|FOLLOWING,
        CURRENT ROW → the compact frame-bound token ('up','uf','cur',
        'pN','fN')."""
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                if not is_start:
                    raise ParseError("frame end cannot be UNBOUNDED PRECEDING")
                return "up"
            self.expect_kw("following")
            if is_start:
                raise ParseError("frame start cannot be UNBOUNDED FOLLOWING")
            return "uf"
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "cur"
        t = self.next()
        if t.kind != "number" or not t.value.isdigit():
            raise ParseError(f"expected frame offset, got {t.value!r}")
        n = int(t.value)
        if self.accept_kw("preceding"):
            return f"p{n}"
        self.expect_kw("following")
        return f"f{n}"

    def _parse_cast_body(self) -> ast.Node:
        """`( expr AS typename )` — shared by CAST and TRY_CAST."""
        self.expect_op("(")
        e = self.parse_expr()
        self.expect_kw("as")
        # type name: ident or keyword ('date'), optional (p[,s])
        tt = self.next()
        type_name = tt.value
        if self.accept_op("("):
            args = [self.next().value]
            while self.accept_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            type_name += "(" + ",".join(args) + ")"
        self.expect_op(")")
        return ast.Cast(e, type_name)

    def parse_case(self) -> ast.Node:
        self.expect_kw("case")
        operand = None
        if not (self.peek().kind == "keyword" and self.peek().value == "when"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            whens.append((cond, val))
        default = None
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect_kw("end")
        return ast.Case(operand, whens, default)


def parse_sql(sql: str) -> ast.Query:
    """Parse a SQL query string into an AST (reference:
    presto-parser/.../SqlParser.java:91 createStatement)."""
    return Parser(sql).parse_statement()
