"""Row-expression → torch evaluation.

The analog of the reference's ExpressionCompiler: the typed IR lowers to
torch ops over whole batches (eager; no tracing). A compiled expression is
fn(batch) -> (values, validity|None), vectorized over the batch capacity.
NULL semantics are SQL three-valued logic; the `live` mask is not
consulted (dead lanes compute harmlessly).

Strings are dictionary codes: literals resolve against the column's
Dictionary on the host, so string equality and IN become integer compares,
and a range compare against a literal compares codes with the literal's
position in the sorted dictionary. Two string columns on different
dictionaries compare through a host remap of one into the other.

String functions work on the dictionary, not on the rows
(`expr/host.py` holds their Python kernels): a string→string function
maps each entry to a new, canonical dictionary plus a code remap; a
string→int, →double or →boolean function, a cast from varchar and LIKE
are tables over the entries; split/regexp_split feed subscript,
element_at and cardinality through a [entries, pieces] table. The device
does one gather either way.

Lowered: comparisons (numeric, date and string), BETWEEN, IN, AND/OR/NOT,
IS [NOT] NULL, COALESCE, NULLIF, IF (CASE), LIKE with its escape, the
string families of expr/host.py (substr, upper, concat and ||,
split_part, regexp_*, url, hash, json, varbinary and IP functions,
length, strpos, starts_with, ...), CAST among numeric, decimal and date
and from varchar, exact decimal arithmetic, the numeric functions (abs,
negation, sqrt/exp/ln/floor/ceil/... and sign/truncate, atan2,
greatest/least, round half away from zero, power), bitwise_*,
is_nan/is_finite/is_infinite, from_unixtime/to_unixtime, width_bucket,
the date and time parts and arithmetic (year/quarter/month/day,
day_of_week, day_of_year, the time-of-day parts, date_add, date_trunc,
date_diff), approx_distinct's __hll_reg/__hll_rank, every function over
ARRAY and MAP values (expr/structural.py: constructors, subscripts,
contains, sorts and set functions, and the lambdas transform, filter,
reduce, the matches, transform_values, map_filter and zip_with, whose
body evaluates once over the flattened [cap * W] element plane), and the
geometry functions (expr/geo.py). Any other function raises
NotImplementedError naming it; a cast to varchar runs on the host
(exec/runtime.py HostProject).

Division of a float by a plan-time constant multiplies by its reciprocal,
as XLA compiles the JAX package's division, so both round alike.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from presto_tpu_torch.batch import (
    Batch,
    Column,
    carry_dicts,
    key_dict_name,
    pad_plane_width,
)
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.expr import structural as _struct
from presto_tpu_torch.expr.structural import StructVal
from presto_tpu_torch.expr.host import (
    HLL_M,
    _STR_INT_NULLABLE,
    _STR_PRED,
    _STR_TO_FLOAT,
    _STR_TO_INT,
    _STR_TO_STR,
    _str_float_pyfn,
    _str_int_pyfn,
    _str_pred_pyfn,
    _str_xform_pyfn,
    _xform_parts,
    parse_string_to,
    regexp_split_pieces,
)
from presto_tpu_torch.expr.ir import (
    Call,
    Constant,
    InputRef,
    LambdaExpr,
    RowExpression,
)
from presto_tpu_torch.ops.hashing import splitmix64
from presto_tpu_torch.types import (
    BOOLEAN,
    DOUBLE,
    ArrayType,
    DecimalType,
    MapType,
    Type,
    is_floating,
    is_integral,
    is_structural,
    torch_dtype,
)

# ---------------------------------------------------------------------------
# helpers


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Half-away-from-zero rounding for floats (SQL ROUND semantics)."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _div_half_away(v: torch.Tensor, f: int) -> torch.Tensor:
    """Integer divide with half-away-from-zero rounding of dropped digits."""
    av = torch.abs(v)
    return torch.sign(v) * torch.div(av + f // 2, f, rounding_mode="floor")


def like_to_regex(pattern: str, escape: str | None = None) -> str:
    """SQL LIKE pattern → anchored python regex."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _civil_from_days(z: torch.Tensor):
    """Days since the epoch → (year, month, day): Howard Hinnant's
    algorithm in integer arithmetic (floor division throughout)."""
    z = z.to(torch.int64) + 719468
    era = torch.div(torch.where(z >= 0, z, z - 146096), 146097,
                    rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"),
                    365, rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def unscale(v: torch.Tensor, scale: int) -> torch.Tensor:
    """A decimal's unscaled value as its SQL value: multiplication by the
    reciprocal of 10^scale. XLA compiles the JAX package's division by
    that constant to the same multiplication, so both packages round
    alike."""
    return v * (1.0 / 10.0 ** scale)


class CompileContext:
    """What evaluation needs beyond the IR: the batch (its dictionaries and
    device), `out_dict`, the dictionary of the string literals an
    expression yields as values (CASE ... THEN 'x'), and `extra_dicts`,
    the dictionaries of a lambda's string parameters by symbol."""

    def __init__(self, batch: Batch, out_dict: Dictionary | None = None,
                 extra_dicts: dict | None = None):
        self.batch = batch
        self.out_dict = out_dict
        self.extra_dicts = extra_dicts or {}

    @property
    def device(self) -> torch.device:
        return self.batch.device

    def const(self, value, typ: Type) -> torch.Tensor:
        return torch.tensor(value, dtype=torch_dtype(typ.dtype),
                            device=self.device)

    def dict_for(self, e: RowExpression) -> Dictionary | None:
        if isinstance(e, InputRef):
            if e.name in self.extra_dicts:
                return self.extra_dicts[e.name]
            return self.batch.dict_of(e.name)
        if isinstance(e, Call):
            if e.fn in _STR_TO_STR:
                return self.transformed(e)[0]
            if (e.fn in ("subscript", "element_at") and e.args
                    and isinstance(e.args[0].type, (ArrayType, MapType))):
                # codes of the structural operand's element plane (the
                # pieces' dictionary of a split, not its operand's)
                return _elem_dict(e.args[0], self)
            for a in e.args:
                d = self.dict_for(a)
                if d is not None:
                    return d
        return None

    def transformed(self, e: Call):
        """(new dictionary, code remap, operand) of a string transform,
        memoized on the operand's dictionary; remap None means the result
        is NULL (a NULL constant inside concat)."""
        operand, cargs = _xform_parts(e)
        if cargs is None:
            return None, None, operand
        d = self.dict_for(operand)
        if d is None:
            raise ValueError(f"string function {e.fn} needs a dictionary "
                             "operand")
        nd, remap = d.transform((e.fn, cargs), _str_xform_pyfn(e.fn, cargs))
        return nd, remap, operand

    def split_tables(self, e: Call):
        """(pieces dictionary, [entries + 1, W] piece codes, [entries + 1]
        piece counts, operand) of split/regexp_split over its operand's
        dictionary."""
        operand, cargs = _xform_parts(e)
        d = self.dict_for(operand)
        if d is None:
            raise ValueError(f"{e.fn} needs a dictionary operand")
        return _split_tables(d, e.fn, cargs) + (operand,)

    def table(self, arr: np.ndarray) -> torch.Tensor:
        """A host table over a dictionary, on the batch's device."""
        return torch.as_tensor(arr, device=self.device)

    def gather(self, arr: np.ndarray, operand: RowExpression):
        """Rows' entries of a host table indexed by code + 1 (row 0 holds
        the NULL code -1), with the operand's validity."""
        codes, valid = _eval(operand, self)
        return self.table(arr)[codes.to(torch.int64) + 1], valid


def _is_split(e: RowExpression) -> bool:
    return isinstance(e, Call) and e.fn in ("split", "regexp_split")


def _split_tables(d: Dictionary, fn: str, cargs: tuple):
    """split/regexp_split over a dictionary: each entry's pieces →
    (pieces dictionary, [len + 1, W] code plane, [len + 1] sizes), row 0
    for NULL. Memoized on the dictionary like Dictionary.transform."""
    key = ("__split", fn, cargs)
    hit = d._memo.get(key)
    if hit is not None:
        return hit
    if fn == "split":
        delim = str(cargs[0])
        limit = int(cargs[1]) if len(cargs) > 1 else None
        # SQL limit = the most pieces; the last one takes the rest
        splitter = (lambda s: s.split(delim) if limit is None
                    else s.split(delim, limit - 1))
    else:
        splitter = regexp_split_pieces(str(cargs[0]))
    pieces = [splitter(str(v)) for v in d.values]
    from presto_tpu_torch.dictionary import safe_str_array

    uniq = sorted({p for ps in pieces for p in ps}) or [""]
    ed = Dictionary(np.unique(safe_str_array(
        np.asarray(uniq, dtype=object))))
    w = max((len(ps) for ps in pieces), default=1) or 1
    n = len(d.values)
    plane = np.zeros((n + 1, w), np.int32)
    sizes = np.zeros(n + 1, np.int32)
    for i, ps in enumerate(pieces):
        sizes[i + 1] = len(ps)
        for j, p in enumerate(ps):
            plane[i + 1, j] = ed.code_of(p)
    d._memo[key] = (ed, plane, sizes)
    return ed, plane, sizes


def string_output_dictionary(e: RowExpression) -> Dictionary | None:
    """The dictionary of the string literals an expression yields as values
    (CASE tags, COALESCE defaults), built at plan time; None if there are
    none. Literals in comparison, LIKE or IN positions resolve against the
    column's dictionary instead."""
    if isinstance(e, InputRef):
        return None
    consts: list[str] = []

    def walk(x, value_pos: bool):
        if (isinstance(x, Constant) and x.type.is_string and value_pos
                and x.value is not None):
            consts.append(str(x.value))
        if isinstance(x, Call):
            in_value_pos = x.fn in ("if", "coalesce", "nullif", "array_ctor",
                                    "repeat", "map") or (
                value_pos and x.fn == "cast")
            for a in x.args:
                walk(a, in_value_pos and a.type.is_string)

    walk(e, True)
    if not consts:
        return None
    from presto_tpu_torch.dictionary import safe_str_array

    return Dictionary(np.unique(safe_str_array(
        np.asarray(consts, dtype=object))))


def compile_expr(e: RowExpression):
    """Return fn(batch) -> (values, validity|None). A string-valued
    expression also gets `fn.dyn_dict(batch)`, its output dictionary."""
    out_dict = string_output_dictionary(e)

    def fn(batch: Batch):
        return _eval(e, CompileContext(batch, out_dict))

    if isinstance(e.type, (ArrayType, MapType)) and not isinstance(
            e, InputRef):
        def sdicts(batch: Batch):
            """(element dictionary, key dictionary) of the value."""
            return struct_dicts(e, CompileContext(batch, out_dict))

        fn.sdicts = sdicts
    if e.type.is_string and not isinstance(e, InputRef):
        def dyn_dict(batch: Batch):
            d = CompileContext(batch, out_dict).dict_for(e)
            return d if d is not None else out_dict

        fn.dyn_dict = dyn_dict
    return fn


def compile_predicate(e: RowExpression):
    """Return fn(batch) -> bool mask (NULL → False, like Presto filters)."""
    out_dict = string_output_dictionary(e)

    def fn(batch: Batch):
        v, valid = _eval(e, CompileContext(batch, out_dict))
        mask = v.to(torch.bool)
        if valid is not None:
            mask = mask & valid
        return mask

    return fn


# ---------------------------------------------------------------------------
# evaluation


def _eval(e: RowExpression, ctx: CompileContext):
    if isinstance(e, InputRef):
        c = ctx.batch.column(e.name)
        if c.sizes is not None:
            return StructVal(c.values, c.sizes, c.evalid, c.keys), c.validity
        if c.hi is not None:
            # long decimal: expressions compute over the combined float64
            # unscaled value — exact below 2^53
            return c.combined_f64(), c.validity
        return c.values, c.validity
    if isinstance(e, Constant):
        return _eval_constant(e, ctx, None)
    if isinstance(e, Call):
        return _eval_call(e, ctx)
    raise NotImplementedError(f"cannot compile {e!r}")


def _eval_constant(e: Constant, ctx: CompileContext,
                   sibling: RowExpression | None):
    """Constants; string constants resolve against the sibling's dictionary."""
    if e.value is None:
        cap = ctx.batch.capacity
        return (torch.zeros(cap, dtype=torch_dtype(e.type.dtype),
                            device=ctx.device),
                torch.zeros(cap, dtype=torch.bool, device=ctx.device))
    if e.raw:
        return ctx.const(e.value, e.type), None
    if e.type.is_string:
        d = ctx.dict_for(sibling) if sibling is not None else None
        if d is None:
            d = ctx.out_dict
        if d is None:
            raise ValueError("string constant without dictionary context")
        return torch.tensor(d.code_of(str(e.value)), dtype=torch.int32,
                            device=ctx.device), None
    if isinstance(e.type, DecimalType):
        unscaled = int(round(float(e.value) * (10 ** e.type.scale)))
        return ctx.const(unscaled, e.type), None
    return ctx.const(e.value, e.type), None


def _eval_arg(a: RowExpression, ctx, sibling=None):
    if isinstance(a, Constant):
        return _eval_constant(a, ctx, sibling)
    return _eval(a, ctx)


_CMP = {
    "eq": torch.eq,
    "ne": torch.ne,
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
}


# functions over ARRAY/MAP values; the polymorphic names only when their
# first argument is one
_STRUCT_ONLY_FNS = {
    "array_ctor", "array_position", "array_min", "array_max", "array_sum",
    "array_average", "array_distinct", "array_sort", "slice", "sequence",
    "repeat", "map", "map_keys", "map_values",
    "transform", "filter", "reduce", "any_match", "all_match", "none_match",
    "transform_values", "map_filter",
    "array_union", "array_intersect", "array_except", "arrays_overlap",
    "map_concat", "zip_with", "split", "regexp_split", "array_remove",
}
_STRUCT_POLY_FNS = {"cardinality", "contains", "concat", "element_at",
                    "subscript"}
_GEO_FNS = {
    "st_geometryfromtext", "st_point", "st_x", "st_y", "st_distance",
    "st_contains", "st_intersects", "st_area", "st_perimeter", "st_length",
    "st_npoints", "st_xmin", "st_xmax", "st_ymin", "st_ymax", "st_centroid",
    "great_circle_distance",
}


def _eval_call(e: Call, ctx: CompileContext):
    fn = e.fn

    if fn in _GEO_FNS:
        return _eval_geo(e, ctx)

    # ---- structural (ARRAY / MAP) ----------------------------------------
    if fn in ("subscript", "element_at", "cardinality") and _is_split(
            e.args[0]):
        # a split's pieces straight from the split tables
        return _eval_split_access(e, ctx)
    if fn in _STRUCT_ONLY_FNS or (fn in _STRUCT_POLY_FNS and e.args
                                  and is_structural(e.args[0].type)):
        return _eval_structural(e, ctx)

    # ---- comparisons (incl. dictionary-code string compares) -------------
    if fn in _CMP:
        l, r = e.args
        if l.type.is_string or r.type.is_string:
            return _string_compare(fn, l, r, ctx)
        lv, lval = _eval_arg(l, ctx, r)
        rv, rval = _eval_arg(r, ctx, l)
        lv, rv = _numeric_align(lv, rv)
        return _CMP[fn](lv, rv), _and_valid(lval, rval)

    # ---- boolean (Kleene) ------------------------------------------------
    if fn == "and":
        vals, valids = zip(*[_eval_arg(a, ctx) for a in e.args])
        v = vals[0].to(torch.bool)
        for x in vals[1:]:
            v = v & x.to(torch.bool)
        # AND is null iff no operand is definitively false and any is null
        known_false = torch.zeros_like(v)
        any_null = None
        for x, va in zip(vals, valids):
            xb = x.to(torch.bool)
            if va is not None:
                known_false = known_false | (~xb & va)
                any_null = ~va if any_null is None else (any_null | ~va)
            else:
                known_false = known_false | ~xb
        if any_null is None:
            return v, None
        valid = known_false | ~any_null
        return v & valid, valid
    if fn == "or":
        vals, valids = zip(*[_eval_arg(a, ctx) for a in e.args])
        v = vals[0].to(torch.bool)
        for x in vals[1:]:
            v = v | x.to(torch.bool)
        known_true = torch.zeros_like(v)
        any_null = None
        for x, va in zip(vals, valids):
            xb = x.to(torch.bool)
            if va is not None:
                known_true = known_true | (xb & va)
                any_null = ~va if any_null is None else (any_null | ~va)
            else:
                known_true = known_true | xb
        if any_null is None:
            return v, None
        return v, known_true | ~any_null
    if fn == "not":
        v, valid = _eval_arg(e.args[0], ctx)
        return ~v.to(torch.bool), valid

    # ---- null handling ---------------------------------------------------
    if fn == "is_null":
        v, valid = _eval_arg(e.args[0], ctx)
        if valid is None:
            return torch.zeros(v.shape, dtype=torch.bool, device=ctx.device), None
        return ~valid, None
    if fn == "is_not_null":
        v, valid = _eval_arg(e.args[0], ctx)
        if valid is None:
            return torch.ones(v.shape, dtype=torch.bool, device=ctx.device), None
        return valid, None
    if fn == "coalesce":
        dt = torch_dtype(e.type.dtype)
        out_v, out_valid = _eval_arg(e.args[0], ctx)
        out_v = out_v.to(dt)
        for a in e.args[1:]:
            if out_valid is None:
                break
            av, avalid = _eval_arg(a, ctx)
            out_v = torch.where(out_valid, out_v, av.to(dt))
            if avalid is None:
                return out_v, None  # fully covered
            out_valid = out_valid | avalid
        return out_v, out_valid
    if fn == "nullif":
        av, avalid = _eval_arg(e.args[0], ctx, e.args[1])
        bv, bvalid = _eval_arg(e.args[1], ctx, e.args[0])
        eq = av == bv
        if bvalid is not None:
            eq = eq & bvalid
        valid = (avalid if avalid is not None
                 else torch.ones(av.shape, dtype=torch.bool, device=ctx.device))
        return av, valid & ~eq

    # ---- control flow ----------------------------------------------------
    if fn == "if":
        cond, then, els = e.args
        cv, cvalid = _eval_arg(cond, ctx)
        cmask = cv.to(torch.bool)
        if cvalid is not None:
            cmask = cmask & cvalid
        dt = torch_dtype(e.type.dtype)
        tv, tvalid = _eval_arg(then, ctx, els)
        ev, evalid = _eval_arg(els, ctx, then)
        out = torch.where(cmask, tv.to(dt), ev.to(dt))
        if tvalid is None and evalid is None:
            return out, None
        ones = torch.ones(out.shape, dtype=torch.bool, device=ctx.device)
        tva = tvalid if tvalid is not None else ones
        eva = evalid if evalid is not None else ones
        return out, torch.where(cmask, tva, eva)

    # ---- membership ------------------------------------------------------
    if fn == "in":
        val = e.args[0]
        vv, vvalid = _eval(val, ctx) if val.type.is_string else _eval_arg(val, ctx)
        m = torch.zeros(vv.shape, dtype=torch.bool, device=ctx.device)
        if val.type.is_string:
            d = ctx.dict_for(val)
            for c in e.args[1:]:
                m = m | (vv == d.code_of(str(c.value)))
            return m, vvalid
        for c in e.args[1:]:
            cv, _ = _eval_arg(c, ctx, val)
            m = m | (vv == cv)
        return m, vvalid
    if fn == "between":
        v, lo, hi = e.args
        ge = _eval_call(Call(BOOLEAN, "ge", (v, lo)), ctx)
        le = _eval_call(Call(BOOLEAN, "le", (v, hi)), ctx)
        return ge[0] & le[0], _and_valid(ge[1], le[1])

    # ---- LIKE over the dictionary ---------------------------------------
    if fn == "like":
        val, pat = e.args[0], e.args[1]
        escape = str(e.args[2].value) if len(e.args) > 2 else None
        d = ctx.dict_for(val)
        if d is None:
            raise ValueError("LIKE on non-dictionary column")
        rx = re.compile(like_to_regex(str(pat.value), escape))
        return ctx.gather(d.int_lut(("like", pat.value, escape),
                                    lambda s: rx.match(s) is not None,
                                    dtype=np.bool_), val)

    # ---- string functions over the dictionary ---------------------------
    if fn in _STR_TO_STR:
        _, remap, operand = ctx.transformed(e)
        if remap is None:  # a NULL constant inside concat: NULL
            cap = ctx.batch.capacity
            return (torch.zeros(cap, dtype=torch.int32, device=ctx.device),
                    torch.zeros(cap, dtype=torch.bool, device=ctx.device))
        out, valid = ctx.gather(remap, operand)
        if bool((remap[1:] < 0).any()):
            # the transform gave NULL for some entries (regexp_extract
            # without a match, an absent json path): a negative new code
            notnull = out >= 0
            valid = notnull if valid is None else valid & notnull
        return out, valid
    if fn in _STR_TO_FLOAT or fn in _STR_TO_INT or fn in _STR_PRED:
        return _eval_string_table(e, ctx)

    # ---- HyperLogLog primitives (approx_distinct's lowering) -------------
    if fn in ("__hll_reg", "__hll_rank"):
        return _eval_hll(e, ctx)

    if fn == "__host_date_format":
        raise NotImplementedError(
            "date_format is supported in the top-level SELECT list only "
            "(it is a host finishing projection)")

    if fn == "cast":
        return _eval_cast(e, ctx)

    # ---- arithmetic ------------------------------------------------------
    if fn in ("add", "sub", "mul", "div", "mod"):
        return _eval_arith(e, ctx)
    if fn == "neg":
        v, valid = _eval_arg(e.args[0], ctx)
        return -v, valid
    if fn == "abs":
        v, valid = _eval_arg(e.args[0], ctx)
        return torch.abs(v), valid
    if fn in _MATH or fn in _ROUNDING or fn in _FLOAT_TESTS:
        return _eval_math(e, ctx)
    if fn == "round":
        return _eval_round(e, ctx)
    if fn in ("atan2", "power", "greatest", "least"):
        return _eval_binary_math(e, ctx)
    if fn in _BITWISE or fn == "bitwise_not":
        return _eval_bitwise(e, ctx)
    if fn in _TIME_FNS:
        return _eval_time(e, ctx)
    if fn in _DATE_FNS:
        return _eval_date(e, ctx)
    if fn == "__qsk_bucket":
        return _qsk_bucket(e, ctx)

    raise NotImplementedError(
        f"function {fn} is not supported by presto_tpu_torch yet")


# ---------------------------------------------------------------------------
# numeric functions


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(v) * torch.pow(torch.abs(v), 1.0 / 3.0)


_MATH = {
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "log2": torch.log2, "log10": torch.log10, "cbrt": _cbrt,
    "degrees": torch.rad2deg, "radians": torch.deg2rad, "sign": torch.sign,
}
# integer-valued on integers: identities there
_ROUNDING = {"floor": torch.floor, "ceil": torch.ceil, "truncate": torch.trunc}
_FLOAT_TESTS = {"is_nan": torch.isnan, "is_finite": torch.isfinite,
                "is_infinite": torch.isinf}


def _eval_math(e: Call, ctx):
    fn = e.fn
    v, valid = _eval_arg(e.args[0], ctx)
    if fn in _FLOAT_TESTS:
        return _FLOAT_TESTS[fn](v.to(torch.float64)), valid
    v = v.to(torch_dtype(e.type.dtype))
    if fn in _MATH:
        return _MATH[fn](v), valid
    return (_ROUNDING[fn](v) if v.is_floating_point() else v), valid


def _eval_round(e: Call, ctx):
    """SQL ROUND is half away from zero (Presto MathFunctions.round), not
    torch.round's half to even."""
    v, valid = _eval_arg(e.args[0], ctx)
    digits = int(e.args[1].value) if len(e.args) > 1 else 0
    if isinstance(e.type, DecimalType):
        src_scale = e.args[0].type.scale
        if digits >= src_scale:
            return v, valid
        f = 10 ** (src_scale - digits)
        return _div_half_away(v, f) * f, valid
    if len(e.args) > 1:
        f = 10.0 ** digits
        return _round_half_away(v * f) * (1.0 / f), valid
    return _round_half_away(v), valid


def _eval_binary_math(e: Call, ctx):
    fn = e.fn
    dt = torch_dtype(e.type.dtype)
    out, valid = _eval_arg(e.args[0], ctx)
    out = out.to(dt)
    if fn in ("greatest", "least"):
        # SQL: NULL if any argument is NULL (Presto MathFunctions.greatest)
        op = torch.maximum if fn == "greatest" else torch.minimum
        for a in e.args[1:]:
            av, avalid = _eval_arg(a, ctx)
            out = op(out, av.to(dt))
            valid = _and_valid(valid, avalid)
        return out, valid
    b, bvalid = _eval_arg(e.args[1], ctx)
    op = torch.atan2 if fn == "atan2" else torch.pow
    return op(out, b.to(dt)), _and_valid(valid, bvalid)


_BITWISE = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
            "bitwise_right_shift"}


def _eval_bitwise(e: Call, ctx):
    """On int64; a shift by less than 0 or more than 63 bits gives 0, and
    the right shift is logical, as XLA's shifts are."""
    if e.fn == "bitwise_not":
        v, valid = _eval_arg(e.args[0], ctx)
        return ~v.to(torch.int64), valid
    a, avalid = _eval_arg(e.args[0], ctx)
    b, bvalid = _eval_arg(e.args[1], ctx)
    a, b = a.to(torch.int64), b.to(torch.int64)
    valid = _and_valid(avalid, bvalid)
    if e.fn == "bitwise_and":
        return a & b, valid
    if e.fn == "bitwise_or":
        return a | b, valid
    if e.fn == "bitwise_xor":
        return a ^ b, valid
    a, b = torch.broadcast_tensors(a, b)
    out_of_range = (b < 0) | (b > 63)
    bb = torch.clamp(b, 0, 63)
    if e.fn == "bitwise_left_shift":
        out = a << bb
    else:
        # logical: clear the bits the arithmetic shift copied the sign into
        mask = torch.where(bb == 0, -1, (1 << (64 - torch.clamp(bb, min=1)))
                           - 1)
        out = (a >> bb) & mask
    return torch.where(out_of_range, 0, out), valid


# ---------------------------------------------------------------------------
# time


_TIME_FNS = {"from_unixtime", "to_unixtime", "width_bucket", "__time_hour",
             "__time_minute", "__time_second"}


def _eval_time(e: Call, ctx):
    fn = e.fn
    v, valid = _eval_arg(e.args[0], ctx)
    if fn == "from_unixtime":
        return (v.to(torch.float64) * 1e6).to(torch.int64), valid
    if fn == "to_unixtime":
        return v.to(torch.float64) * (1.0 / 1e6), valid
    if fn == "width_bucket":
        lo = float(e.args[1].value)
        hi = float(e.args[2].value)
        nb = int(e.args[3].value)
        x = v.to(torch.float64)
        bucket = torch.floor((x - lo) * (1.0 / (hi - lo)) * nb).to(
            torch.int64) + 1
        return torch.clamp(bucket, 0, nb + 1), valid
    # TIME (micros of the day) and TIMESTAMP (micros since the epoch) both
    # reduce mod one day
    tod = torch.remainder(v.to(torch.int64), 86_400_000_000)
    if fn == "__time_hour":
        return torch.div(tod, 3_600_000_000, rounding_mode="floor"), valid
    if fn == "__time_minute":
        return torch.remainder(torch.div(tod, 60_000_000,
                                         rounding_mode="floor"), 60), valid
    return torch.remainder(torch.div(tod, 1_000_000, rounding_mode="floor"),
                           60), valid


# ---------------------------------------------------------------------------
# dates


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _days_from_civil_vec(y, m, d):
    """Inverse of _civil_from_days (the same Hinnant algorithm)."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y, m):
    base = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)[
        (m - 1).to(torch.int64)]
    leap = (((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0))
            | (torch.remainder(y, 400) == 0))
    return torch.where((m == 2) & leap, 29, base)


_DATE_FNS = {"year", "month", "day", "quarter", "day_of_week", "day_of_year",
             "date_add_days", "date_trunc", "date_diff", "date_add_unit"}


def _as_days(a: RowExpression, v: torch.Tensor) -> torch.Tensor:
    """TIMESTAMP operands (micros since the epoch) reduce to civil days;
    DATE is already days."""
    if a.type.name == "timestamp":
        return _fdiv(v.to(torch.int64), 86_400_000_000)
    return v.to(torch.int64)


def _eval_date(e: Call, ctx):
    fn = e.fn
    if fn in ("date_trunc", "date_diff", "date_add_unit"):
        unit = str(e.args[0].value).lower()
        return {"date_trunc": _date_trunc, "date_diff": _date_diff,
                "date_add_unit": _date_add_unit}[fn](e, unit, ctx)
    v, valid = _eval_arg(e.args[0], ctx)
    if fn == "date_add_days":
        dv, dvalid = _eval_arg(e.args[1], ctx)
        return v + dv.to(v.dtype), _and_valid(valid, dvalid)
    days = _as_days(e.args[0], v)
    if fn == "day_of_week":
        # ISO: 1 = Monday ... 7 = Sunday; epoch day 0 (1970-01-01) is a
        # Thursday
        return torch.remainder(days + 3, 7) + 1, valid
    y, m, d = _civil_from_days(days)
    if fn == "day_of_year":
        return days - _days_from_civil_vec(y, torch.ones_like(m), 1) + 1, valid
    if fn == "quarter":
        return _fdiv(m - 1, 3) + 1, valid
    return {"year": y, "month": m, "day": d}[fn], valid


def _date_trunc(e: Call, unit: str, ctx):
    v, valid = _eval_arg(e.args[1], ctx)
    days = v.to(torch.int64)
    if unit == "day":
        return days.to(torch.int32), valid
    if unit == "week":
        return (days - torch.remainder(days + 3, 7)).to(torch.int32), valid
    y, m, _ = _civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "month":
        return _days_from_civil_vec(y, m, 1), valid
    if unit == "quarter":
        return _days_from_civil_vec(y, _fdiv(m - 1, 3) * 3 + 1, 1), valid
    if unit == "year":
        return _days_from_civil_vec(y, one, 1), valid
    raise NotImplementedError(f"date_trunc unit {unit}")


def _date_diff(e: Call, unit: str, ctx):
    a, avalid = _eval_arg(e.args[1], ctx)
    b, bvalid = _eval_arg(e.args[2], ctx)
    valid = _and_valid(avalid, bvalid)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    if unit == "day":
        return b64 - a64, valid
    if unit == "week":
        return _fdiv(b64 - a64, 7), valid
    ya, ma, da = _civil_from_days(a64)
    yb, mb, db = _civil_from_days(b64)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # truncate toward zero on the day-of-month remainder
    months = months - ((months > 0) & (db < da)).to(torch.int64)
    months = months + ((months < 0) & (db > da)).to(torch.int64)
    if unit == "month":
        return months, valid
    if unit == "quarter":
        return _fdiv(months, 3), valid
    if unit == "year":
        return _fdiv(months, 12), valid
    raise NotImplementedError(f"date_diff unit {unit}")


def _date_add_unit(e: Call, unit: str, ctx):
    n, nvalid = _eval_arg(e.args[1], ctx)
    v, valid = _eval_arg(e.args[2], ctx)
    valid = _and_valid(valid, nvalid)
    days = v.to(torch.int64)
    n = n.to(torch.int64)
    if unit == "day":
        return (days + n).to(torch.int32), valid
    if unit == "week":
        return (days + 7 * n).to(torch.int32), valid
    mult = {"month": 1, "quarter": 3, "year": 12}.get(unit)
    if mult is None:
        raise NotImplementedError(f"date_add unit {unit}")
    y, m, d = _civil_from_days(days)
    total = y * 12 + (m - 1) + n * mult
    y2 = _fdiv(total, 12)
    m2 = torch.remainder(total, 12) + 1
    d2 = torch.minimum(d, _days_in_month(y2, m2))
    return _days_from_civil_vec(y2, m2, d2), valid


def _qsk_bucket(e: Call, ctx):
    """approx_percentile's sketch bucket: the monotone IEEE-754 integer
    encoding of x as float64, its top 24 bits (sign, exponent and 12
    mantissa bits), with -0.0 as +0.0."""
    v, valid = _eval_arg(e.args[0], ctx)
    x = v.to(torch.float64)
    x = torch.where(x == 0.0, 0.0, x)
    bits = x.view(torch.int64)
    flip = torch.where(bits < 0, -1, torch.iinfo(torch.int64).min)
    return ((bits ^ flip) >> 40) & ((1 << 24) - 1), valid


def _eval_string_table(e: Call, ctx: CompileContext):
    """A string→double, →int or →boolean function as a table over its
    operand's dictionary entries; an entry whose function gives None is
    NULL (a parallel null table, evaluated once an entry)."""
    fn = e.fn
    operand, cargs = _xform_parts(e)
    d = ctx.dict_for(operand)
    if d is None:
        raise ValueError(f"{fn} needs a dictionary operand")
    if fn in _STR_PRED:
        return ctx.gather(d.int_lut((fn, cargs), _str_pred_pyfn(fn, cargs),
                                    dtype=np.bool_), operand)
    if fn in _STR_TO_INT and fn not in _STR_INT_NULLABLE:
        return ctx.gather(d.int_lut((fn, cargs), _str_int_pyfn(fn, cargs)),
                          operand)
    is_float = fn in _STR_TO_FLOAT
    pyfn = (_str_float_pyfn if is_float else _str_int_pyfn)(fn, cargs)
    memo: dict = {}

    def once(s):
        if s not in memo:
            memo[s] = pyfn(s)
        return memo[s]

    if is_float:
        table = d.int_lut((fn, cargs, "v"),
                          lambda s: 0.0 if once(s) is None else once(s),
                          dtype=np.float64)
    else:
        table = d.int_lut((fn, cargs, "v"), lambda s: once(s) or 0)
    nulls = d.int_lut((fn, cargs, "null"), lambda s: once(s) is None,
                      dtype=np.bool_)
    codes, valid = _eval(operand, ctx)
    idx = codes.to(torch.int64) + 1
    notnull = ~ctx.table(nulls)[idx]
    out = ctx.table(table)[idx]
    if not is_float:
        out = out.to(torch_dtype(e.type.dtype))  # DATE tables are int32
    return out, notnull if valid is None else valid & notnull


def _eval_split_access(e: Call, ctx: CompileContext):
    """cardinality, subscript and element_at of split/regexp_split: the
    split tables gathered by the operand's codes, then each row's piece
    (1-based; a negative index counts from the end; out of range is
    NULL, as in the JAX package)."""
    _, plane, sizes, operand = ctx.split_tables(e.args[0])
    codes, rvalid = _eval(operand, ctx)
    idx = codes.to(torch.int64) + 1
    n = ctx.table(sizes)[idx].to(torch.int64)
    if e.fn == "cardinality":
        return n, rvalid
    iv, ivalid = _eval_arg(e.args[1], ctx)
    iv = torch.broadcast_to(iv.to(torch.int64), n.shape)
    pos = torch.where(iv >= 0, iv - 1, n + iv)
    valid = (pos >= 0) & (pos < n)
    posc = torch.clamp(pos, 0, plane.shape[1] - 1)
    out = ctx.table(plane)[idx, posc]
    return out, _and_valid(_and_valid(valid, ivalid), rvalid)


def _eval_hll(e: Call, ctx: CompileContext):
    """__hll_reg(x): the low log2(HLL_M) bits of x's 64-bit content hash;
    __hll_rank(x): 1 + the leading zeros of its top 32 bits (1..33). The
    JAX package's hash, bit for bit: strings hash their entries' content,
    doubles their bit pattern with -0.0 as +0.0."""
    a = e.args[0]
    av, avalid = _eval(a, ctx)
    if a.type.is_string:
        lut = ctx.dict_for(a).content_hash_lut()
        h = splitmix64(ctx.table(lut)[av.to(torch.int64) + 1])
    elif av.is_floating_point():
        x = av.to(torch.float64)
        bits = torch.where(x == 0.0, 0, x.view(torch.int64))
        h = splitmix64(bits)
    else:
        h = splitmix64(av.to(torch.int64))
    if e.fn == "__hll_reg":
        return h & (HLL_M - 1), avalid
    w = (h >> 32) & 0xFFFFFFFF
    # floor(log2(w)) + 1 is w's bit length: frexp's exponent, exactly
    _, bitlen = torch.frexp(w.to(torch.float64))
    return torch.where(w == 0, 33, 33 - bitlen.to(torch.int64)), avalid


def _numeric_align(lv: torch.Tensor, rv: torch.Tensor):
    """Align device representations for comparison (the analyzer makes the
    SQL types comparable; decimals arrive same-scale via casts)."""
    if lv.dtype != rv.dtype:
        t = torch.promote_types(lv.dtype, rv.dtype)
        lv, rv = lv.to(t), rv.to(t)
    return lv, rv


def _string_compare(op: str, l: RowExpression, r: RowExpression, ctx):
    """String compares on dictionary codes. Dictionaries are sorted, so a
    range compare against a literal compares codes with the literal's
    position, and two columns on one dictionary compare codes. Columns on
    different dictionaries compare for (in)equality through a remap of
    one into the other; a range compare across them is refused, as in the
    JAX package."""
    if isinstance(l, Constant) and not isinstance(r, Constant):
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        return _string_compare(flip.get(op, op), r, l, ctx)
    if isinstance(r, Constant):
        d = ctx.dict_for(l)
        if d is None:
            raise ValueError(f"no dictionary for {l}")
        s = str(r.value)
        lv, lvalid = _eval(l, ctx)
        if op in ("eq", "ne"):
            m = lv == d.code_of(s)
            return (m if op == "eq" else ~m), lvalid
        if op in ("lt", "le"):
            return lv < d.range_codes(s, "left" if op == "lt" else "right"), \
                lvalid
        return lv >= d.range_codes(s, "right" if op == "gt" else "left"), \
            lvalid
    ld, rd = ctx.dict_for(l), ctx.dict_for(r)
    lv, lvalid = _eval(l, ctx)
    rv, rvalid = _eval(r, ctx)
    valid = _and_valid(lvalid, rvalid)
    if ld is rd or ld is None or rd is None:
        return _CMP[op](lv, rv), valid
    if op in ("eq", "ne"):
        lv2 = ctx.table(ld.map_to(rd))[lv.to(torch.int64) + 1]
        m = (lv2 == rv) & (lv2 >= 0)
        return (m if op == "eq" else ~m), valid
    raise NotImplementedError("cross-dictionary range comparison")


def _eval_arith(e: Call, ctx):
    l, r = e.args
    lv, lvalid = _eval_arg(l, ctx, r)
    rv, rvalid = _eval_arg(r, ctx, l)
    valid = _and_valid(lvalid, rvalid)
    out_t = e.type
    if isinstance(out_t, DecimalType):
        # exact scaled-int64 arithmetic; the analyzer pre-aligned scales
        # for add/sub, and scale(out) = scale(l) + scale(r) for mul
        if e.fn == "div":
            return _decimal_div(lv, rv, l.type, r.type, out_t, valid)
        lv, rv = lv.to(torch.int64), rv.to(torch.int64)
        if e.fn == "add":
            return lv + rv, valid
        if e.fn == "sub":
            return lv - rv, valid
        if e.fn == "mul":
            return lv * rv, valid
        if e.fn == "mod":
            return torch.remainder(lv, rv), valid
        raise NotImplementedError(f"decimal {e.fn}")
    dt = torch_dtype(out_t.dtype)
    if out_t is DOUBLE or is_floating(out_t):
        lv = lv.to(dt)
        rv = rv.to(dt)
        if isinstance(l.type, DecimalType):
            lv = unscale(lv, l.type.scale)
        if isinstance(r.type, DecimalType):
            rv = unscale(rv, r.type.scale)
    else:
        lv, rv = lv.to(dt), rv.to(dt)
    if e.fn == "add":
        return lv + rv, valid
    if e.fn == "sub":
        return lv - rv, valid
    if e.fn == "mul":
        return lv * rv, valid
    if e.fn == "div":
        if is_integral(out_t):
            # SQL integer division truncates toward zero
            q = (torch.sign(lv) * torch.sign(rv)
                 * torch.div(torch.abs(lv), torch.clamp(torch.abs(rv), min=1),
                             rounding_mode="floor"))
            return q.to(dt), _and_valid(valid, rv != 0)
        div_ok = rv != 0.0
        safe = torch.where(div_ok, rv, torch.ones_like(rv))
        return (torch.where(div_ok, lv / safe, torch.zeros_like(lv)),
                _and_valid(valid, div_ok))
    if e.fn == "mod":
        safe = torch.where(rv == 0, torch.ones_like(rv), rv)
        if is_floating(out_t):
            m = lv - torch.trunc(lv / safe) * safe
        else:
            m = torch.sign(lv) * torch.remainder(torch.abs(lv), torch.abs(safe))
        return m, _and_valid(valid, rv != 0)
    raise NotImplementedError(e.fn)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """Dekker/Veltkamp exact two-product: a*b = hi + lo with hi = fl(a*b).
    Separate float64 ops, so no fused multiply-add changes the rounding."""
    p = a * b
    c = 134217729.0  # 2^27 + 1 (Veltkamp splitter)
    ac = a * c
    ah = ac - (ac - a)
    al = a - ah
    bc = b * c
    bh = bc - (bc - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _decimal_div(lv, rv, lt, rt, out_t, valid):
    """DECIMAL ÷ DECIMAL with Presto semantics: the numerator rescales by
    10^(s_out + s_r - s_l) and the quotient rounds half away from zero.
    Pure int64 while the numerator fits 18 digits; otherwise a Dekker
    two-product float64 path with exact-remainder correction (exact while
    operands and quotient stay below 2^53 and the shift ≤ 22); beyond that
    the float64 approximation — the JAX package's ladder, step for step."""
    ls = lt.scale if isinstance(lt, DecimalType) else 0
    rs = rt.scale if isinstance(rt, DecimalType) else 0
    lp = lt.precision if isinstance(lt, DecimalType) else 18
    shift = out_t.scale + rs - ls
    div_ok = rv != 0
    valid = _and_valid(valid, div_ok)
    int_in = not lv.is_floating_point() and not rv.is_floating_point()
    if int_in and shift >= 0 and lp + shift <= 18:
        n = lv.to(torch.int64) * (10 ** shift)
        d = torch.where(div_ok, rv.to(torch.int64), torch.ones_like(rv, dtype=torch.int64))
        an, ad = torch.abs(n), torch.abs(d)
        q = torch.div(an + torch.div(ad, 2, rounding_mode="floor"), ad,
                      rounding_mode="floor")
        return (torch.sign(n) * torch.sign(d) * q).to(torch.int64), valid

    lf = lv.to(torch.float64)
    rf = torch.where(div_ok, rv.to(torch.float64),
                     torch.ones_like(rv, dtype=torch.float64))
    nf = torch.abs(lf)
    da = torch.abs(rf)
    sgn = torch.sign(lf) * torch.sign(rf)
    if shift < 0 or shift > 22:
        q = torch.round(nf * (10.0 ** shift) / da)
        return (sgn * q).to(torch.int64), valid
    n_hi, n_lo = _two_prod(nf, torch.full_like(nf, 10.0 ** shift))
    qa = torch.floor(n_hi / da)
    for _ in range(2):
        p_hi, p_lo = _two_prod(qa, da)
        r = ((n_hi - p_hi) - p_lo) + n_lo
        qa = qa + torch.floor(r / da)
    p_hi, p_lo = _two_prod(qa, da)
    r = ((n_hi - p_hi) - p_lo) + n_lo
    q = qa + (2.0 * r >= da).to(torch.float64)
    return (sgn * q).to(torch.int64), valid


def _eval_cast(e: Call, ctx):
    src = e.args[0]
    st, tt = src.type, e.type
    if st.is_string and not tt.is_string:
        # varchar → number, date or boolean: each dictionary entry parsed
        # on the host, one gather on the device; an entry that does not
        # parse is NULL (try(cast(...)) is the same), as in the JAX package
        d = ctx.dict_for(src)
        if d is None:
            raise ValueError("cast from varchar requires a dictionary")

        def val_of(s):
            v = parse_string_to(tt, s)
            return 0 if v is None else v

        vlut = d.int_lut(("cast_val", tt.name), val_of,
                         dtype=np.float64 if is_floating(tt) else np.int64)
        olut = d.int_lut(("cast_ok", tt.name),
                         lambda s: parse_string_to(tt, s) is not None,
                         dtype=np.bool_)
        codes, valid = _eval(src, ctx)
        idx = codes.to(torch.int64) + 1
        ok = ctx.table(olut)[idx]
        return (ctx.table(vlut)[idx].to(torch_dtype(tt.dtype)),
                ok if valid is None else valid & ok)
    if tt.is_string and not st.is_string:
        raise NotImplementedError(
            "cast to varchar from non-string types is supported in the "
            "top-level SELECT list only (it runs as a HostProject "
            "finishing projection)")
    v, valid = _eval_arg(src, ctx)
    if st == tt:
        return v, valid
    sdec = isinstance(st, DecimalType)
    tdec = isinstance(tt, DecimalType)
    if sdec and tdec:
        if tt.scale >= st.scale:
            return v * (10 ** (tt.scale - st.scale)), valid
        return _div_half_away(v, 10 ** (st.scale - tt.scale)), valid
    tdt = torch_dtype(tt.dtype)
    if sdec and is_floating(tt):
        return unscale(v.to(tdt), st.scale), valid
    if sdec and is_integral(tt):
        return _div_half_away(v, 10 ** st.scale).to(tdt), valid
    if tdec and is_integral(st):
        return v.to(torch.int64) * (10 ** tt.scale), valid
    if tdec and is_floating(st):
        return (_round_half_away(v * (10.0 ** tt.scale)).to(torch.int64),
                valid)
    if tt is BOOLEAN:
        return v.to(torch.bool), valid
    return v.to(tdt), valid


# ---------------------------------------------------------------------------
# structural (ARRAY / MAP) evaluation


def _merge_dicts(ds) -> Dictionary | None:
    d = None
    for x in ds:
        if x is not None:
            d = x if d is None or d is x else Dictionary.merge(d, x)
    return d


def _array_ctor_dict(e: Call, ctx: CompileContext) -> Dictionary | None:
    """Element dictionary of ARRAY[...] over strings: the union of each
    operand column's dictionary and the literal elements (a literal absent
    from a column's dictionary still gets a code; operand codes remap into
    the union when evaluated)."""
    d = _merge_dicts(ctx.dict_for(a) for a in e.args
                     if not isinstance(a, Constant))
    lits = sorted({str(a.value) for a in e.args
                   if isinstance(a, Constant) and a.value is not None})
    if lits:
        # object dtype keeps the trailing NULs of canonical byte entries
        ld, _ = Dictionary.encode(np.asarray(lits, dtype=object))
        d = ld if d is None else Dictionary.merge(d, ld)
    return d


def _setop_elem_dict(e: Call, ctx: CompileContext) -> Dictionary | None:
    """The operands' element dictionaries merged (codes of a set function
    must share one space to compare)."""
    t0 = e.args[0].type
    elem = t0.element if isinstance(t0, ArrayType) else t0.value
    if not elem.is_string:
        return None
    return _merge_dicts(_elem_dict(a, ctx) for a in e.args)


def _setop_key_dict(e: Call, ctx: CompileContext) -> Dictionary | None:
    return _merge_dicts(_key_dict(a, ctx) for a in e.args)


def _elem_dict(e: RowExpression, ctx: CompileContext) -> Dictionary | None:
    """Dictionary of a structural expression's (string) element plane."""
    if isinstance(e, InputRef):
        return ctx.batch.dict_of(e.name)
    if isinstance(e, Call):
        if e.fn == "array_ctor" and e.type.element.is_string:
            return _array_ctor_dict(e, ctx)
        if _is_split(e):
            operand, cargs = _xform_parts(e)
            d = ctx.dict_for(operand)
            return None if d is None else _split_tables(d, e.fn, cargs)[0]
        if e.fn == "array_remove":
            return _elem_dict(e.args[0], ctx)
        if e.fn == "map":
            return _elem_dict(e.args[1], ctx)
        if e.fn == "map_keys":
            return _key_dict(e.args[0], ctx)
        if e.fn in ("array_union", "array_intersect", "array_except",
                    "map_concat"):
            return _setop_elem_dict(e, ctx)
        if e.fn in ("transform", "transform_values"):
            # the body's dictionary with the parameters bound to the
            # input's element (and key) dictionaries
            le = e.args[1]
            bound = dict(ctx.extra_dicts)
            if e.fn == "transform":
                bound[le.params[0][0]] = _elem_dict(e.args[0], ctx)
            else:
                bound[le.params[0][0]] = _key_dict(e.args[0], ctx)
                bound[le.params[1][0]] = _elem_dict(e.args[0], ctx)
            return CompileContext(ctx.batch, ctx.out_dict,
                                  bound).dict_for(le.body)
        for a in e.args:
            if isinstance(a.type, (ArrayType, MapType)):
                d = _elem_dict(a, ctx)
            elif a.type.is_string:
                d = ctx.dict_for(a)
            else:
                continue
            if d is not None:
                return d
    return ctx.out_dict


def _key_dict(e: RowExpression, ctx: CompileContext) -> Dictionary | None:
    """Dictionary of a map expression's (string) key plane."""
    if isinstance(e, InputRef):
        return ctx.batch.dict_of(key_dict_name(e.name))
    if isinstance(e, Call):
        if e.fn == "map":
            return _elem_dict(e.args[0], ctx)
        if e.fn in ("transform_values", "map_filter"):
            return _key_dict(e.args[0], ctx)
        if e.fn == "map_concat":
            return _setop_key_dict(e, ctx)
        for a in e.args:
            if isinstance(a.type, MapType):
                d = _key_dict(a, ctx)
                if d is not None:
                    return d
    return None


def struct_dicts(e: RowExpression, ctx: CompileContext):
    """(element dictionary, key dictionary) a projected structural column
    carries."""
    t = e.type
    ed = kd = None
    if isinstance(t, ArrayType) and t.element.is_string:
        ed = _elem_dict(e, ctx)
    if isinstance(t, MapType):
        if t.value.is_string:
            ed = _elem_dict(e, ctx)
        if t.key.is_string:
            kd = _key_dict(e, ctx)
    return ed, kd


def _eval_struct_const(a: Constant, ctx: CompileContext,
                       d: Dictionary | None):
    """A scalar constant inside a structural expression; a string resolves
    against the element or key dictionary `d`."""
    if a.value is None:
        cap = ctx.batch.capacity
        return (torch.zeros(cap, dtype=torch_dtype(a.type.dtype),
                            device=ctx.device),
                torch.zeros(cap, dtype=torch.bool, device=ctx.device))
    if a.type.is_string:
        d = d if d is not None else ctx.out_dict
        if d is None:
            raise ValueError("string constant in structural expression "
                             "without a dictionary context")
        return torch.tensor(d.code_of(str(a.value)), dtype=torch.int32,
                            device=ctx.device), None
    return _eval_constant(a, ctx, None)


def _remapped(ctx: CompileContext, src: Dictionary, dst: Dictionary,
              codes: torch.Tensor) -> torch.Tensor:
    """Codes of `src` as codes of `dst` (-1 where absent)."""
    return ctx.table(src.map_to(dst))[codes.to(torch.int64) + 1].to(
        codes.dtype)


def _eval_structural(e: Call, ctx: CompileContext):
    fn = e.fn
    cap = ctx.batch.capacity

    def scalar_arg(a: RowExpression, d: Dictionary | None = None):
        if isinstance(a, Constant):
            v, valid = _eval_struct_const(a, ctx, d)
        else:
            v, valid = _eval(a, ctx)
        return torch.broadcast_to(v, (cap,)), valid

    if fn == "array_ctor":
        et = e.type.element
        dt = torch_dtype(et.dtype)
        if not et.is_string:
            return _struct.array_ctor([scalar_arg(a) for a in e.args], cap,
                                      dt, ctx.device), None
        # one element dictionary: operand codes remap into the union of
        # the column dictionaries and the literals
        d = _array_ctor_dict(e, ctx)
        parts = []
        for a in e.args:
            if isinstance(a, Constant):
                v, valid = _eval_struct_const(a, ctx, d)
            else:
                v, valid = _eval(a, ctx)
                ad = ctx.dict_for(a)
                if ad is not None and ad is not d:
                    v = _remapped(ctx, ad, d, v)
            parts.append((torch.broadcast_to(v, (cap,)), valid))
        return _struct.array_ctor(parts, cap, dt, ctx.device), None

    if _is_split(e):
        # the pieces and counts are host tables over the operand's
        # dictionary; rows take theirs by one gather
        _, plane, sizes, operand = ctx.split_tables(e)
        codes, valid = _eval(operand, ctx)
        idx = codes.to(torch.int64) + 1
        return StructVal(ctx.table(plane)[idx], ctx.table(sizes)[idx],
                         None), valid

    if fn == "array_remove":
        sv0, rvalid0 = _eval(e.args[0], ctx)
        d = (_elem_dict(e.args[0], ctx)
             if e.args[0].type.element.is_string else None)
        xb, xvalid = scalar_arg(e.args[1], d)
        # only present non-NULL elements can equal; NULL elements stay.
        # Mixed numeric widths compare in float64
        if xb.dtype != sv0.values.dtype:
            equal = (sv0.values.to(torch.float64)
                     == xb.to(torch.float64)[:, None])
        else:
            equal = sv0.values == xb[:, None]
        keep = sv0.present() & ~(equal & sv0.element_valid())
        # a NULL element argument gives a NULL result
        return (_struct.filter_elements(sv0, keep),
                _and_valid(rvalid0, xvalid))

    if fn == "sequence":
        lo = int(e.args[0].value)
        hi = int(e.args[1].value)
        step = (int(e.args[2].value) if len(e.args) > 2
                else (1 if hi >= lo else -1))
        return _struct.sequence(lo, hi, step, cap, ctx.device), None

    if fn == "repeat":
        n = int(e.args[1].value)
        et = e.type.element
        d = _elem_dict(e, ctx) if et.is_string else None
        v, valid = scalar_arg(e.args[0], d)
        return _struct.repeat_val(v, valid, n, cap,
                                  torch_dtype(et.dtype)), None

    if fn == "map":
        ksv, kvalid = _eval(e.args[0], ctx)
        vsv, vvalid = _eval(e.args[1], ctx)
        return _struct.map_from_arrays(ksv, vsv), _and_valid(kvalid, vvalid)

    if fn == "reduce":
        return _eval_reduce(e, ctx)
    if fn == "zip_with":
        return _eval_zip_with(e, ctx)

    # the remaining forms evaluate their structural operand first
    sv, rvalid = _eval(e.args[0], ctx)
    t0 = e.args[0].type

    if fn == "cardinality":
        return _struct.cardinality(sv, rvalid)
    if fn in ("subscript", "element_at"):
        if isinstance(t0, MapType):
            d = _key_dict(e.args[0], ctx) if t0.key.is_string else None
            kv, kvalid = scalar_arg(e.args[1], d)
            return _struct.map_element_at(sv, kv, kvalid, rvalid)
        iv, ivalid = scalar_arg(e.args[1])
        return _struct.subscript(sv, iv.to(torch.int64), ivalid, rvalid)
    if fn in ("contains", "array_position"):
        d = _elem_dict(e.args[0], ctx) if t0.element.is_string else None
        xv, xvalid = scalar_arg(e.args[1], d)
        f = _struct.contains if fn == "contains" else _struct.array_position
        return f(sv, xv, xvalid, rvalid)
    if fn in ("array_min", "array_max"):
        return _struct.array_minmax(sv, rvalid, fn == "array_min")
    if fn in ("array_sum", "array_average"):
        return _struct.array_sum(sv, rvalid, torch_dtype(e.type.dtype),
                                 fn == "array_average")
    if fn == "array_sort":
        return _struct.array_sort(sv), rvalid
    if fn == "array_distinct":
        return _struct.array_distinct(sv), rvalid
    if fn == "slice":
        s0, svalid = scalar_arg(e.args[1])
        ln, lvalid = scalar_arg(e.args[2])
        out = _struct.slice_array(sv, s0.to(torch.int64), ln.to(torch.int64))
        return out, _and_valid(rvalid, _and_valid(svalid, lvalid))
    if fn == "concat":
        out, valid = sv, rvalid
        for a in e.args[1:]:
            asv, avalid = _eval(a, ctx)
            out = _struct.concat_arrays(out, asv)
            valid = _and_valid(valid, avalid)
        return out, valid
    if fn == "map_keys":
        return _struct.map_keys(sv), rvalid
    if fn == "map_values":
        return _struct.map_values(sv), rvalid
    if fn in ("array_union", "array_intersect", "array_except",
              "arrays_overlap", "map_concat"):
        target = _setop_elem_dict(e, ctx)
        ktarget = (_setop_key_dict(e, ctx)
                   if fn == "map_concat" and t0.key.is_string else None)

        def aligned(arg, s):
            # each operand's codes in the merged dictionaries
            if target is not None:
                d = _elem_dict(arg, ctx)
                if d is not None and d is not target:
                    s = s.replace(values=_remapped(ctx, d, target, s.values))
            if ktarget is not None:
                d = _key_dict(arg, ctx)
                if d is not None and d is not ktarget:
                    s = s.replace(keys=_remapped(ctx, d, ktarget, s.keys))
            return s

        out, valid = aligned(e.args[0], sv), rvalid
        setfn = {"array_union": _struct.array_union,
                 "array_intersect": _struct.array_intersect,
                 "array_except": _struct.array_except,
                 "map_concat": _struct.map_concat}
        for a in e.args[1:]:
            osv, ovalid = _eval(a, ctx)
            osv = aligned(a, osv)
            valid = _and_valid(valid, ovalid)
            if fn == "arrays_overlap":
                return _struct.arrays_overlap(out, osv), valid
            out = setfn[fn](out, osv)
        return out, valid
    if fn in ("transform", "filter", "any_match", "all_match", "none_match"):
        return _eval_higher_order(e, ctx, sv, rvalid)
    if fn in ("transform_values", "map_filter"):
        return _eval_map_higher_order(e, ctx, sv, rvalid)
    raise NotImplementedError(f"structural function not implemented: {fn}")


def _refs(e: RowExpression, out: set) -> set:
    """The symbols an expression reads (inside nested lambdas too)."""
    if isinstance(e, InputRef):
        out.add(e.name)
    elif isinstance(e, LambdaExpr):
        _refs(e.body, out)
    elif isinstance(e, Call):
        for a in e.args:
            _refs(a, out)
    return out


def _element_batch(ctx: CompileContext, w: int, body: RowExpression,
                   param_cols):
    """The [cap * w]-row batch a lambda body evaluates over: each outer
    column the body reads, repeated once per element slot, and the
    parameter columns (flattened element planes). Returns the batch and
    the parameters' dictionaries."""
    b = ctx.batch
    used = _refs(body, set())
    params = {sym for sym, *_ in param_cols}
    names, types, cols = [], [], []
    dicts = {}
    for name, t, c in zip(b.names, b.types, b.columns):
        if name not in used or name in params:
            continue
        names.append(name)
        types.append(t)
        cols.append(c if w == 1 else c.map_rows(
            lambda p: torch.repeat_interleave(p, w, dim=0)))
        carry_dicts(b.dicts, dicts, name)
    extra = {}
    for sym, t, vals, valid, d in param_cols:
        names.append(sym)
        types.append(t)
        cols.append(Column(vals, valid))
        if d is not None:
            dicts[sym] = d
            extra[sym] = d
    live = b.live if w == 1 else torch.repeat_interleave(b.live, w)
    return Batch(names, types, cols, live, dicts), extra


def _eval_body(ctx: CompileContext, le: LambdaExpr, w: int, param_cols):
    """A lambda body over the flattened planes: ([cap, w] values,
    [cap, w] validity | None)."""
    cap = ctx.batch.capacity
    eb, extra = _element_batch(ctx, w, le.body, param_cols)
    bv, bvalid = _eval(le.body, CompileContext(eb, ctx.out_dict, extra))
    bv = torch.broadcast_to(bv, (cap * w,)).reshape(cap, w)
    if bvalid is not None:
        bvalid = torch.broadcast_to(bvalid, (cap * w,)).reshape(cap, w)
    return bv, bvalid


def _eval_higher_order(e: Call, ctx: CompileContext, sv: StructVal, rvalid):
    """transform, filter and the matches: the body evaluates once over the
    flattened [cap * W] element plane."""
    fn = e.fn
    cap = ctx.batch.capacity
    le: LambdaExpr = e.args[1]
    (psym, pt), = le.params
    w = sv.width
    if w == 0:
        if fn == "transform":
            return StructVal(torch.zeros((cap, 0),
                                         dtype=torch_dtype(le.type.dtype),
                                         device=ctx.device),
                             sv.sizes, None), rvalid
        if fn == "filter":
            return sv, rvalid
        return torch.full((cap,), fn in ("all_match", "none_match"),
                          dtype=torch.bool, device=ctx.device), rvalid
    present = sv.present()
    pdict = _elem_dict(e.args[0], ctx) if pt.is_string else None
    bv, bvalid = _eval_body(ctx, le, w, [
        (psym, pt, sv.values.reshape(-1), sv.element_valid().reshape(-1),
         pdict)])
    if fn == "transform":
        return StructVal(bv.to(torch_dtype(le.type.dtype)), sv.sizes,
                         bvalid), rvalid
    truth = bv.to(torch.bool)
    if bvalid is not None:
        truth = truth & bvalid  # a NULL predicate does not match
    if fn == "filter":
        return _struct.filter_elements(sv, truth & present), rvalid
    if fn == "any_match":
        return torch.any(truth & present, dim=1), rvalid
    if fn == "all_match":
        return torch.all(truth | ~present, dim=1), rvalid
    return ~torch.any(truth & present, dim=1), rvalid  # none_match


def _eval_map_higher_order(e: Call, ctx: CompileContext, sv: StructVal,
                           rvalid):
    """transform_values and map_filter: the (k, v) body evaluates over the
    flattened key and value planes together."""
    le: LambdaExpr = e.args[1]
    (ksym, kt), (vsym, vt) = le.params
    w = sv.width
    if w == 0:
        return sv, rvalid
    present = sv.present()
    kdict = _key_dict(e.args[0], ctx) if kt.is_string else None
    vdict = _elem_dict(e.args[0], ctx) if vt.is_string else None
    bv, bvalid = _eval_body(ctx, le, w, [
        (ksym, kt, sv.keys.reshape(-1), present.reshape(-1), kdict),
        (vsym, vt, sv.values.reshape(-1), sv.element_valid().reshape(-1),
         vdict)])
    if e.fn == "transform_values":
        return StructVal(bv.to(torch_dtype(le.type.dtype)), sv.sizes,
                         bvalid, keys=sv.keys), rvalid
    truth = bv.to(torch.bool)
    if bvalid is not None:
        truth = truth & bvalid
    return _struct.filter_elements(sv, truth & present), rvalid


def _eval_zip_with(e: Call, ctx: CompileContext):
    """zip_with(a, b, (x, y) -> ...): the planes pad to the longer array
    (the shorter side's missing elements are NULL parameters); the body
    evaluates once over the paired flattened planes."""
    asv, avalid = _eval(e.args[0], ctx)
    bsv, bvalid = _eval(e.args[1], ctx)
    le: LambdaExpr = e.args[2]
    (xsym, xt), (ysym, yt) = le.params
    w = max(asv.width, bsv.width, 1)
    av = pad_plane_width(asv.values, w)
    bv = pad_plane_width(bsv.values, w)
    aev = pad_plane_width(asv.element_valid(), w, False)
    bev = pad_plane_width(bsv.element_valid(), w, False)
    xdict = _elem_dict(e.args[0], ctx) if xt.is_string else None
    ydict = _elem_dict(e.args[1], ctx) if yt.is_string else None
    ov, ovalid = _eval_body(ctx, le, w, [
        (xsym, xt, av.reshape(-1), aev.reshape(-1), xdict),
        (ysym, yt, bv.reshape(-1), bev.reshape(-1), ydict)])
    out = StructVal(ov.to(torch_dtype(le.type.dtype)),
                    torch.maximum(asv.sizes, bsv.sizes), ovalid)
    return out, _and_valid(avalid, bvalid)


def _eval_reduce(e: Call, ctx: CompileContext):
    """reduce(arr, init, (state, x) -> ...): a fold unrolled over the W
    element slots, each step one body evaluation over every row."""
    sv, rvalid = _eval(e.args[0], ctx)
    iv, ivalid = _eval_arg(e.args[1], ctx)
    le: LambdaExpr = e.args[2]
    (ssym, st), (xsym, xt) = le.params
    cap = ctx.batch.capacity
    sdt = torch_dtype(st.dtype)
    acc_v = torch.broadcast_to(iv, (cap,)).to(sdt)
    acc_valid = (torch.broadcast_to(ivalid, (cap,)) if ivalid is not None
                 else torch.ones(cap, dtype=torch.bool, device=ctx.device))
    present = sv.present()
    evalid = sv.element_valid()
    xdict = _elem_dict(e.args[0], ctx) if xt.is_string else None
    for j in range(sv.width):
        bv, bvalid = _eval_body(ctx, le, 1, [
            (ssym, st, acc_v, acc_valid, None),
            (xsym, xt, sv.values[:, j], evalid[:, j], xdict)])
        bv = bv[:, 0].to(sdt)
        bvalid = (bvalid[:, 0] if bvalid is not None
                  else torch.ones(cap, dtype=torch.bool, device=ctx.device))
        active = present[:, j]
        acc_v = torch.where(active, bv, acc_v)
        acc_valid = torch.where(active, bvalid, acc_valid)
    return acc_v, _and_valid(acc_valid, rvalid)


# ---------------------------------------------------------------------------
# geometry: WKT parsed on the host once per dictionary entry; the coded
# kind rides on the WKT column's dictionary


# bounded LRUs: a long-running process plans without bound
_GEO_PLANES_CACHE: "OrderedDict" = OrderedDict()  # id(geoms) -> (geoms, planes)
_GEO_CONST_CACHE: "OrderedDict" = OrderedDict()   # WKT literal -> (geoms, ok)


def _geo_planes(geoms: tuple) -> np.ndarray:
    from presto_tpu_torch.expr import geo as G

    hit = _GEO_PLANES_CACHE.get(id(geoms))
    if hit is not None and hit[0] is geoms:
        _GEO_PLANES_CACHE.move_to_end(id(geoms))
        return hit[1]
    planes = G.edge_planes(geoms)
    _GEO_PLANES_CACHE[id(geoms)] = (geoms, planes)
    while len(_GEO_PLANES_CACHE) > 128:
        _GEO_PLANES_CACHE.popitem(last=False)
    return planes


def _geo_parse_all(values):
    """Lenient WKT parse: (geoms tuple, ok array). A value that does not
    parse (or the '' a NULL slot holds) is an invalid row, not a failed
    query."""
    from presto_tpu_torch.expr import geo as G

    parsed, ok = [], []
    fallback = G.parse_wkt("POINT(0 0)")
    for v in values:
        try:
            parsed.append(G.parse_wkt(str(v)))
            ok.append(True)
        except G.WktError:
            parsed.append(fallback)
            ok.append(False)
    return tuple(parsed), np.asarray(ok, bool)


def _geo_lut(gv, func, device, dtype=np.float64) -> torch.Tensor:
    """geometry → scalar as a host table gathered by code."""
    table = torch.as_tensor(
        np.array([func(g) for g in gv.geoms]).astype(dtype), device=device)
    return table[torch.clamp(gv.codes.to(torch.int64), 0,
                             len(gv.geoms) - 1)]


def _geo_points(gv, device):
    """(x, y) tensors of a GeomVal; None when it holds geometries other
    than points."""
    from presto_tpu_torch.expr import geo as G

    if gv.kind == "points":
        return gv.x, gv.y
    if all(G.is_point(g) for g in gv.geoms):
        return (_geo_lut(gv, lambda g: G.point_xy(g)[0], device),
                _geo_lut(gv, lambda g: G.point_xy(g)[1], device))
    return None


def _eval_geom_arg(a: RowExpression, ctx: CompileContext):
    """A GEOMETRY-typed subexpression as (GeomVal, validity)."""
    from presto_tpu_torch.expr.geo import GeomVal

    v, valid = _eval(a, ctx)
    if not isinstance(v, GeomVal):
        raise NotImplementedError(
            "GEOMETRY values only flow between geospatial functions")
    return v, valid


def _eval_geo(e: Call, ctx: CompileContext):
    from presto_tpu_torch.expr import geo as G
    from presto_tpu_torch.expr.geo import GeomVal

    fn = e.fn
    cap = ctx.batch.capacity
    dev = ctx.device
    if fn == "great_circle_distance":
        vals = [_eval_arg(a, ctx) for a in e.args]
        valid = None
        for _, va in vals:
            valid = _and_valid(valid, va)
        lat1, lon1, lat2, lon2 = (v.to(torch.float64) for v, _ in vals)
        return G.great_circle_distance(lat1, lon1, lat2, lon2), valid

    if fn == "st_geometryfromtext":
        a = e.args[0]
        if isinstance(a, Constant):
            key = str(a.value) if a.value is not None else None
            if key is None:
                geoms, ok = _geo_parse_all([""])
            else:
                hit = _GEO_CONST_CACHE.get(key)
                if hit is None:
                    hit = _geo_parse_all([key])
                    _GEO_CONST_CACHE[key] = hit
                    while len(_GEO_CONST_CACHE) > 256:
                        _GEO_CONST_CACHE.popitem(last=False)
                else:
                    _GEO_CONST_CACHE.move_to_end(key)
                geoms, ok = hit
            valid = (None if bool(ok[0])
                     else torch.zeros(cap, dtype=torch.bool, device=dev))
            return GeomVal("coded", torch.zeros(cap, dtype=torch.int32,
                                                device=dev),
                           geoms, None, None), valid
        codes, valid = _eval(a, ctx)
        d = ctx.dict_for(a)
        if d is None:
            raise NotImplementedError(
                "ST_GeometryFromText needs a dictionary-encoded varchar")
        memo = d._memo.get("__geoms__")
        if memo is None:
            memo = _geo_parse_all(d.values)
            d._memo["__geoms__"] = memo
        geoms, ok = memo
        if not geoms:
            geoms, ok = _geo_parse_all([""])
            return (GeomVal("coded", torch.zeros(cap, dtype=torch.int32,
                                                 device=dev),
                            geoms, None, None),
                    torch.zeros(cap, dtype=torch.bool, device=dev))
        okv = ctx.table(ok)[torch.clamp(codes.to(torch.int64), 0,
                                        len(geoms) - 1)]
        okv = okv & (codes >= 0)
        return GeomVal("coded", codes, geoms, None, None), _and_valid(
            valid, okv)

    if fn == "st_point":
        (x, xv), (y, yv) = (_eval_arg(a, ctx) for a in e.args)

        def vec(v):
            # literal coordinates arrive 0-d; the planes need rows
            return torch.broadcast_to(v.to(torch.float64), (cap,))

        return (GeomVal("points", None, None, vec(x), vec(y)),
                _and_valid(xv, yv))

    if fn in ("st_area", "st_perimeter", "st_length", "st_npoints",
              "st_xmin", "st_xmax", "st_ymin", "st_ymax", "st_x", "st_y",
              "st_centroid"):
        gv, valid = _eval_geom_arg(e.args[0], ctx)
        if gv.kind == "points":
            if fn in ("st_x", "st_xmin", "st_xmax"):
                return gv.x, valid
            if fn in ("st_y", "st_ymin", "st_ymax"):
                return gv.y, valid
            if fn == "st_centroid":
                return gv, valid
            if fn == "st_npoints":
                return torch.ones_like(gv.x, dtype=torch.int64), valid
            return torch.zeros_like(gv.x), valid  # area/perimeter/length
        if fn in ("st_x", "st_y"):
            if not all(G.is_point(g) for g in gv.geoms):
                raise NotImplementedError(f"{fn} needs POINT geometries")
            i = 0 if fn == "st_x" else 1
            return _geo_lut(gv, lambda g: G.point_xy(g)[i], dev), valid
        if fn == "st_centroid":
            return (GeomVal(
                "points", None, None,
                _geo_lut(gv, lambda g: G.geom_centroid(g)[0], dev),
                _geo_lut(gv, lambda g: G.geom_centroid(g)[1], dev)), valid)
        if fn == "st_npoints":
            return _geo_lut(gv, G.geom_npoints, dev, np.int64), valid
        host = {"st_area": G.geom_area, "st_perimeter": G.geom_perimeter,
                "st_length": G.geom_length,
                "st_xmin": lambda g: G.geom_bbox(g)[0],
                "st_ymin": lambda g: G.geom_bbox(g)[1],
                "st_xmax": lambda g: G.geom_bbox(g)[2],
                "st_ymax": lambda g: G.geom_bbox(g)[3]}
        return _geo_lut(gv, host[fn], dev), valid

    # binary relations
    ga, va = _eval_geom_arg(e.args[0], ctx)
    gb, vb = _eval_geom_arg(e.args[1], ctx)
    valid = _and_valid(va, vb)
    pa, pb = _geo_points(ga, dev), _geo_points(gb, dev)

    def inside_area(poly, px, py):
        # only polygons enclose points (a linestring never does)
        inside = G.point_in_coded(_geo_planes(poly.geoms), poly.codes,
                                  px, py)
        return inside & (_geo_lut(poly, lambda g: float(G.is_area(g)),
                                  dev) > 0)

    if fn in ("st_contains", "st_intersects"):
        if ga.kind == "coded" and pb is not None and pa is None:
            return inside_area(ga, pb[0], pb[1]), valid
        if (fn == "st_intersects" and gb.kind == "coded"
                and pa is not None and pb is None):
            return inside_area(gb, pa[0], pa[1]), valid
        if pa is not None and pb is not None:
            return (pa[0] == pb[0]) & (pa[1] == pb[1]), valid
        if fn == "st_contains" and pa is not None and pb is None:
            # a point never contains a polygon or linestring
            return torch.zeros_like(pa[0], dtype=torch.bool), valid
        raise NotImplementedError(
            f"{fn} between two non-point geometries is not supported")

    if fn == "st_distance":
        if pa is not None and pb is not None:
            return torch.hypot(pa[0] - pb[0], pa[1] - pb[1]), valid
        poly, pt = (ga, pb) if pa is None else (gb, pa)
        if pt is None:
            raise NotImplementedError(
                "ST_Distance between two non-point geometries is not "
                "supported")
        d = G.point_seg_distance(_geo_planes(poly.geoms), poly.codes,
                                 pt[0], pt[1])
        inside = inside_area(poly, pt[0], pt[1])
        return torch.where(inside, torch.zeros_like(d), d), valid

    raise NotImplementedError(f"geospatial function {fn}")
