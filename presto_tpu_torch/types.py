"""SQL type system mapped onto flat device representations.

Reference surface: presto-spi/src/main/java/com/facebook/presto/spi/type/
(Type.java, BigintType, DoubleType, DecimalType, VarcharType, DateType, ...).

Design (TPU-first, not a port):

- Every type has exactly one flat device representation (a numpy dtype); there
  are no variable-width device values. VARCHAR is dictionary-encoded: the
  device sees order-preserving int32 codes, the host keeps the dictionary
  (see presto_tpu_torch.dictionary). This generalizes Presto's DictionaryBlock
  (spi/block/DictionaryBlock.java) from an optimization into the only string
  representation the device ever touches.
- DECIMAL(p, s) with p <= 18 is a scaled int64 ("unscaled value", like
  Presto's short decimal, spi/type/DecimalType.java); arithmetic is exact
  int64 math with explicit rescales. p > 18 ("long decimal") carries a
  second int64 limb on the Column (`Column.hi`: value = hi·2³² + lo, lo
  canonical in [0, 2³²)) — produced by sum(decimal) aggregation states
  and carried exactly through joins, sorts, exchanges and spill
  (reference: UnscaledDecimal128Arithmetic.java two-long layout). General
  long-decimal multiplication/division is not implemented; comparisons
  and min/max fall back to combined float64.
- DATE is int32 days since 1970-01-01 (same as Presto, spi/type/DateType).
- TIMESTAMP is int64 microseconds since epoch.
- ARRAY(T) / MAP(K, V) (spi/type/ArrayType.java, MapType.java) use a dense
  padded layout instead of the reference's offsets-into-flat-block
  (spi/block/ColumnarArray.java): an array column's device value is a
  [capacity, W] plane of element values (W = static per-batch max
  cardinality, padded to keep shapes compile-cache friendly) plus an int32
  `sizes` vector and an element-validity plane. Rows gather through joins
  and sorts as plain 2D row gathers, elementwise array functions vectorize
  over the whole plane, and UNNEST is a static reshape — no ragged offsets
  ever reach the device.
- ROW(fields) is a planning-time type: analysis flattens row construction
  and field access into the underlying scalar columns (spi/type/RowType
  without a device representation of its own).
"""

from __future__ import annotations

import dataclasses


import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype("bool"): torch.bool,
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
}


def torch_dtype(dtype) -> "torch.dtype":
    """numpy dtype → torch dtype (the device form of a SQL type)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class Type:
    """Base class for SQL types. Frozen/hashable: types are plan-time values."""

    name: str

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def torch_dtype(self):
        """The torch dtype of this type's device values."""
        return torch_dtype(self.dtype)

    @property
    def is_string(self) -> bool:
        return False

    @property
    def null_value(self):
        """Placeholder stored in value slots whose validity bit is 0."""
        return np.zeros((), dtype=self.dtype).item()

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class _FixedType(Type):
    _dtype: str

    @property
    def dtype(self):
        return np.dtype(self._dtype)


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    """DECIMAL(p, s). p <= 18: scaled int64. p > 18 ("long decimal"):
    two-limb representation — Column.values holds the low 32 bits
    (nonnegative int64) and Column.hi the arithmetic high limb, so
    value = hi * 2^32 + lo exactly (the reference's
    UnscaledDecimal128Arithmetic int128 on two int64 limbs)."""

    precision: int = 18
    scale: int = 0

    def __init__(self, precision: int = 18, scale: int = 0):
        if precision > 38:
            raise ValueError("DECIMAL precision > 38 unsupported")
        object.__setattr__(self, "name", f"decimal({precision},{scale})")
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)

    @property
    def is_long(self) -> bool:
        return self.precision > 18

    @property
    def dtype(self):
        return np.dtype("int64")


@dataclasses.dataclass(frozen=True)
class VarcharType(Type):
    """Dictionary-encoded string. Device value: int32 code, order-preserving."""

    def __init__(self):
        object.__setattr__(self, "name", "varchar")

    @property
    def dtype(self):
        return np.dtype("int32")

    @property
    def is_string(self) -> bool:
        return True

    @property
    def null_value(self):
        return -1  # codes are >= 0; -1 marks null even without a validity mask


class VarbinaryType(VarcharType):
    """Byte strings, stored through the SAME dictionary machinery as
    VARCHAR via the latin-1 bijection (bytes 0x00-0xFF ↔ U+0000-U+00FF):
    lexicographic order on the mapped text IS byte order, equality is
    byte equality, and `length` is the byte count. Reference:
    spi/type/VarbinaryType + operator/scalar/VarbinaryFunctions."""

    def __init__(self):
        object.__setattr__(self, "name", "varbinary")


class IpAddressType(VarcharType):
    """IPADDRESS: dictionary-encoded like VARCHAR, but the dictionary
    entry is the canonical 16-byte IPv6 form (IPv4 → v4-mapped ::ffff:…)
    through the latin-1 bijection. Byte order on the canonical form IS
    address order, so comparisons / grouping / joins / sorts ride the
    order-preserving code machinery unchanged. Reference:
    presto-main/.../type/IpAddressType.java (16-byte Slice value)."""

    def __init__(self):
        object.__setattr__(self, "name", "ipaddress")


class IpPrefixType(VarcharType):
    """IPPREFIX: canonical 16-byte network address + one prefix-length
    byte; byte order gives the reference's (address, length) ordering.
    Reference: presto-main/.../type/IpPrefixType.java."""

    def __init__(self):
        object.__setattr__(self, "name", "ipprefix")


class HyperLogLogType(VarcharType):
    """HYPERLOGLOG: a serialized sparse-register sketch stored as a
    dictionary entry (expr/hll.py); approx_set/merge/cardinality share
    the approx_distinct lowering's hash + estimator exactly. Reference:
    presto-main/.../type/HyperLogLogType.java."""

    def __init__(self):
        object.__setattr__(self, "name", "hyperloglog")


class TDigestType(VarcharType):
    """TDIGEST(DOUBLE): a serialized centroid-list sketch stored as a
    dictionary entry (expr/tdigest.py) — digests travel as int32 codes
    and scalar functions over them evaluate once per distinct digest.
    Reference: presto-main/.../type/TDigestType.java (Slice-backed)."""

    def __init__(self):
        object.__setattr__(self, "name", "tdigest(double)")


@dataclasses.dataclass(frozen=True)
class ArrayType(Type):
    """ARRAY(element). Device value: [capacity, W] plane of element values
    (element dtype), with per-row `sizes` and an element-validity plane on
    the Column. W is static per batch."""

    element: Type = None  # type: ignore[assignment]

    def __init__(self, element: Type):
        object.__setattr__(self, "name", f"array({element.name})")
        object.__setattr__(self, "element", element)

    @property
    def dtype(self):
        return self.element.dtype


@dataclasses.dataclass(frozen=True)
class MapType(Type):
    """MAP(key, value). Device value: two aligned [capacity, W] planes
    (keys on Column.keys, values on Column.values) sharing `sizes`.
    Map keys are non-null (Presto semantics); map values may be null via
    the element-validity plane."""

    key: Type = None  # type: ignore[assignment]
    value: Type = None  # type: ignore[assignment]

    def __init__(self, key: Type, value: Type):
        object.__setattr__(self, "name", f"map({key.name},{value.name})")
        object.__setattr__(self, "key", key)
        object.__setattr__(self, "value", value)

    @property
    def dtype(self):
        return self.value.dtype


@dataclasses.dataclass(frozen=True)
class RowType(Type):
    """ROW(name type, ...). Planning-time only: analysis flattens field
    access / row construction to the underlying columns."""

    fields: tuple = ()  # tuple[(name, Type), ...]

    def __init__(self, fields):
        fields = tuple((str(n), t) for n, t in fields)
        object.__setattr__(
            self, "name",
            "row(" + ", ".join(f"{n} {t.name}" for n, t in fields) + ")")
        object.__setattr__(self, "fields", fields)

    def field_type(self, name: str) -> "Type":
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(f"row type has no field {name}")

    @property
    def dtype(self):
        raise TypeError("ROW has no single device representation")


def is_structural(t: Type) -> bool:
    return isinstance(t, (ArrayType, MapType, RowType))


BOOLEAN = _FixedType("boolean", "bool")
TINYINT = _FixedType("tinyint", "int8")
SMALLINT = _FixedType("smallint", "int16")
INTEGER = _FixedType("integer", "int32")
BIGINT = _FixedType("bigint", "int64")
REAL = _FixedType("real", "float32")
DOUBLE = _FixedType("double", "float64")
DATE = _FixedType("date", "int32")
TIMESTAMP = _FixedType("timestamp", "int64")
# TIME: microseconds since midnight (the reference's TIME w/o time zone;
# spi/type/TimeType — millis there, micros here matching TIMESTAMP)
TIME = _FixedType("time", "int64")
# geometries live as int32 codes into per-expression parsed-WKT tables
# (expr/geo.py); never stored in tables — ST_AsText round-trips to varchar
GEOMETRY = _FixedType("geometry", "int32")
VARCHAR = VarcharType()
VARBINARY = VarbinaryType()
IPADDRESS = IpAddressType()
IPPREFIX = IpPrefixType()
TDIGEST = TDigestType()
HYPERLOGLOG = HyperLogLogType()


_NUMERIC_RANK = {
    "tinyint": 1,
    "smallint": 2,
    "integer": 3,
    "bigint": 4,
    "real": 6,
    "double": 7,
}


def is_numeric(t: Type) -> bool:
    return t.name in _NUMERIC_RANK or isinstance(t, DecimalType)


def is_integral(t: Type) -> bool:
    return t.name in ("tinyint", "smallint", "integer", "bigint")


def is_floating(t: Type) -> bool:
    return t.name in ("real", "double")


def common_super_type(a: Type, b: Type) -> Type:
    """Implicit coercion for binary ops (analog of TypeCoercion in
    sql/analyzer — simplified to the numeric tower + identical types)."""
    if a == b:
        return a
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return DecimalType(min(18, intd + scale), scale)
    if isinstance(a, DecimalType) and is_integral(b):
        return a
    if isinstance(b, DecimalType) and is_integral(a):
        return b
    if isinstance(a, DecimalType) and is_floating(b):
        return DOUBLE
    if isinstance(b, DecimalType) and is_floating(a):
        return DOUBLE
    if a.name in _NUMERIC_RANK and b.name in _NUMERIC_RANK:
        r = max(_NUMERIC_RANK[a.name], _NUMERIC_RANK[b.name])
        for name, rank in _NUMERIC_RANK.items():
            if rank == r:
                return {"tinyint": TINYINT, "smallint": SMALLINT,
                        "integer": INTEGER, "bigint": BIGINT,
                        "real": REAL, "double": DOUBLE}[name]
    if a.name == "date" and b.name == "date":
        return DATE
    raise TypeError(f"no common type for {a} and {b}")


def _split_top(s: str) -> list:
    """Split on commas at paren depth 0 ("row(a bigint, b double)" safe)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def parse_type(s: str) -> Type:
    """Parse a SQL type name (for CAST and DDL)."""
    s = s.strip().lower()
    if s.startswith("array(") and s.endswith(")"):
        return ArrayType(parse_type(s[6:-1]))
    if s.startswith("map(") and s.endswith(")"):
        k, v = _split_top(s[4:-1])
        return MapType(parse_type(k), parse_type(v))
    if s.startswith("row(") and s.endswith(")"):
        fields = []
        for part in _split_top(s[4:-1]):
            name, _, ft = part.strip().partition(" ")
            fields.append((name, parse_type(ft)))
        return RowType(fields)
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "int": INTEGER,
        "integer": INTEGER,
        "bigint": BIGINT,
        "real": REAL,
        "float": REAL,
        "double": DOUBLE,
        "date": DATE,
        "time": TIME,
        "timestamp": TIMESTAMP,
        "geometry": GEOMETRY,
        "varchar": VARCHAR,
        "string": VARCHAR,
        "varbinary": VARBINARY,
        "ipaddress": IPADDRESS,
        "ipprefix": IPPREFIX,
        "tdigest": TDIGEST,
        "tdigest(double)": TDIGEST,
        "hyperloglog": HYPERLOGLOG,
        "p4hyperloglog": HYPERLOGLOG,
    }
    if s in simple:
        return simple[s]
    if s.startswith("varchar(") and s.endswith(")"):
        return VARCHAR
    if s.startswith("decimal"):
        if "(" in s:
            args = s[s.index("(") + 1 : s.rindex(")")].split(",")
            p = int(args[0])
            sc = int(args[1]) if len(args) > 1 else 0
            return DecimalType(p, sc)
        return DecimalType(18, 0)
    raise ValueError(f"unknown type: {s}")
