"""Fixed-capacity columnar batches — the device data model.

The same contract as the JAX package's batches, on torch tensors:

- capacity   : rows a batch holds, padded to a power-of-two bucket
- live       : bool[capacity]; padding rows and filtered-out rows are dead.
               A filter is `live &= predicate`; compaction happens only at
               materialization points (join build, output).
- validity   : per-column bool[capacity] or None (all valid). SQL NULL is
               orthogonal to liveness.
- values     : one flat tensor per column (strings are dictionary codes).

Every tensor of a batch lies on one device; the host keeps names, types
and dictionaries.

Structural columns (ARRAY / MAP) are dense padded planes: `values` is a
[capacity, W] plane of element values, `sizes` int32[capacity] the row
cardinalities (<= W), `evalid` an optional bool[capacity, W] element
validity, and a map's `keys` the aligned [capacity, W] key plane. The
element dictionary of a string array or map value lives under the
column's name, a map's key dictionary under `name#keys`.
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import (
    ArrayType,
    DecimalType,
    MapType,
    Type,
    torch_dtype,
)


_KEYS = "#keys"


def key_dict_name(name: str) -> str:
    """The entry of a batch's dicts that holds map column `name`'s key
    dictionary."""
    return name + _KEYS


def dict_names(name: str) -> tuple:
    """Every entry of a batch's dicts that column `name` owns: its values'
    dictionary and, for a map, its keys'."""
    return (name, name + _KEYS)


def dict_owner(key: str) -> str:
    """The column that owns entry `key` of a batch's dicts."""
    return key.removesuffix(_KEYS)


def carry_dicts(src: dict, dst: dict, old: str, new: Optional[str] = None):
    """Copy the dictionaries column `old` owns in `src` into `dst`, under
    column name `new` (default `old`)."""
    for a, b in zip(dict_names(old), dict_names(new or old)):
        if a in src:
            dst[b] = src[a]


def round_up_capacity(n: int, minimum: int = 128) -> int:
    """Pad row counts into power-of-two buckets."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclass(frozen=True)
class Column:
    """values + optional validity + optional long-decimal high limb, and
    the structural planes.

    `hi` is the high limb of a long-decimal column (DecimalType precision
    > 18): value = hi * 2^32 + values, with values (the low limb) kept
    canonical in [0, 2^32). None for every other type. `sizes`, `evalid`
    and `keys` are a structural column's planes (module docstring);
    `validity` stays the row's NULL mask."""

    values: torch.Tensor
    validity: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    sizes: Optional[torch.Tensor] = None
    evalid: Optional[torch.Tensor] = None
    keys: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> Optional[int]:
        """Element width W of a structural column (None for a scalar)."""
        return self.values.shape[1] if self.values.dim() == 2 else None

    def planes(self):
        """Every row-indexed tensor of the column (None where absent)."""
        return (self.values, self.validity, self.hi, self.sizes,
                self.evalid, self.keys)

    def map_rows(self, f) -> "Column":
        """The column with `f` applied to each row-indexed plane."""
        return Column(*(None if p is None else f(p) for p in self.planes()))

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.values.shape[0], dtype=torch.bool,
                              device=self.values.device)
        return self.validity

    def gather(self, idx: torch.Tensor) -> "Column":
        """Row gather preserving validity, the long-decimal limb and the
        structural planes."""
        return self.map_rows(lambda p: p[idx])

    def combined_f64(self) -> torch.Tensor:
        """Full value as float64 (exact below 2^53)."""
        if self.hi is None:
            return self.values.to(torch.float64)
        return (self.hi.to(torch.float64) * float(1 << 32)
                + self.values.to(torch.float64))


def pad_plane_width(plane: torch.Tensor, w: int, fill=0) -> torch.Tensor:
    """Widen a [n, w0] structural plane to [n, w] with `fill` padding."""
    w0 = plane.shape[1]
    if w0 == w:
        return plane
    pad = torch.full((plane.shape[0], w - w0), fill, dtype=plane.dtype,
                     device=plane.device)
    return torch.cat([plane, pad], dim=1)


def concat_columns(cols: Sequence[Column], caps: Sequence[int]) -> Column:
    """Row-concatenate Columns preserving validity, long-decimal limbs and
    the structural planes (padded to the widest W)."""
    dev = cols[0].values.device
    sizes = evalid = keys = None
    if any(c.values.dim() == 2 for c in cols):
        w = max(c.values.shape[1] for c in cols)
        vals = torch.cat([pad_plane_width(c.values, w) for c in cols])
        sizes = torch.cat([
            c.sizes if c.sizes is not None
            else torch.zeros(cap, dtype=torch.int32, device=dev)
            for c, cap in zip(cols, caps)])
        if any(c.evalid is not None for c in cols):
            evalid = torch.cat([
                pad_plane_width(
                    c.evalid if c.evalid is not None
                    else torch.ones((cap, c.values.shape[1]),
                                    dtype=torch.bool, device=dev), w, False)
                for c, cap in zip(cols, caps)])
        if any(c.keys is not None for c in cols):
            kd = next(c.keys.dtype for c in cols if c.keys is not None)
            keys = torch.cat([
                pad_plane_width(
                    c.keys if c.keys is not None
                    else torch.zeros((cap, c.values.shape[1]), dtype=kd,
                                     device=dev), w)
                for c, cap in zip(cols, caps)])
    else:
        vals = torch.cat([c.values for c in cols])
    valid = None
    if any(c.validity is not None for c in cols):
        valid = torch.cat([
            c.validity if c.validity is not None
            else torch.ones(cap, dtype=torch.bool, device=dev)
            for c, cap in zip(cols, caps)])
    hi = None
    if any(c.hi is not None for c in cols):
        hi = torch.cat([
            c.hi if c.hi is not None
            else torch.zeros(cap, dtype=torch.int64, device=dev)
            for c, cap in zip(cols, caps)])
    return Column(vals, valid, hi, sizes, evalid, keys)


def slice_column(c: Column, cap: int) -> Column:
    """First-cap-rows slice preserving every plane."""
    return c.map_rows(lambda p: p[:cap])


class Batch:
    """A schema-carrying set of Columns with a shared live mask."""

    __slots__ = ("names", "types", "columns", "live", "dicts")

    def __init__(self, names: Sequence[str], types: Sequence[Type],
                 columns: Sequence[Column], live: torch.Tensor,
                 dicts: Optional[dict] = None):
        self.names = tuple(names)
        self.types = tuple(types)
        self.columns = tuple(columns)
        self.live = live
        self.dicts = dict(dicts or {})

    @staticmethod
    def from_numpy(data: dict, types: dict, device: torch.device,
                   dicts: Optional[dict] = None,
                   capacity: Optional[int] = None) -> "Batch":
        """Build a batch on `device` from host numpy arrays, padding to
        capacity."""
        names = list(data.keys())
        n = len(next(iter(data.values()))) if names else 0
        cap = capacity or round_up_capacity(max(n, 1))
        cols = []
        for name in names:
            t = types[name]
            vals = np.zeros(cap, dtype=t.dtype)
            vals[:n] = np.asarray(data[name]).astype(t.dtype)
            cols.append(Column(torch.from_numpy(vals).to(device)))
        live = np.zeros(cap, dtype=bool)
        live[:n] = True
        return Batch(names, [types[k] for k in names], cols,
                     torch.from_numpy(live).to(device), dicts)

    @property
    def capacity(self) -> int:
        return self.live.shape[0]

    @property
    def device(self) -> torch.device:
        return self.live.device

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def type_of(self, name: str) -> Type:
        return self.types[self.names.index(name)]

    def dict_of(self, name: str) -> Optional[Dictionary]:
        return self.dicts.get(name)

    def select(self, names: Sequence[str]) -> "Batch":
        idx = [self.names.index(n) for n in names]
        dicts = {}
        for n in names:
            carry_dicts(self.dicts, dicts, n)
        return Batch([self.names[i] for i in idx],
                     [self.types[i] for i in idx],
                     [self.columns[i] for i in idx], self.live, dicts)

    def rename(self, names: Sequence[str]) -> "Batch":
        if len(names) != len(self.names):
            raise ValueError(f"rename to {len(names)} names, batch has "
                             f"{len(self.names)} columns")
        dicts = {}
        for old, new in zip(self.names, names):
            carry_dicts(self.dicts, dicts, old, new)
        return Batch(names, self.types, self.columns, self.live, dicts)

    def with_column(self, name: str, typ: Type, col: Column,
                    dictionary=None) -> "Batch":
        names, types, cols = list(self.names), list(self.types), list(self.columns)
        dicts = dict(self.dicts)
        if name in names:
            i = names.index(name)
            types[i] = typ
            cols[i] = col
            for k in dict_names(name):
                dicts.pop(k, None)
        else:
            names.append(name)
            types.append(typ)
            cols.append(col)
        if dictionary is not None:
            dicts[name] = dictionary
        return Batch(names, types, cols, self.live, dicts)

    def with_live(self, live: torch.Tensor) -> "Batch":
        return Batch(self.names, self.types, self.columns, live, self.dicts)

    # -- host-side materialization ---------------------------------------

    def num_live(self) -> int:
        return int(self.live.sum())

    def to_pydict(self, decode_strings: bool = True) -> dict:
        """Compact live rows to host numpy (test/output path, not hot)."""
        live = self.live.cpu().numpy()
        out = {}
        for name, t, c in zip(self.names, self.types, self.columns):
            if c.sizes is not None:
                out[name] = self._structural_to_py(name, t, c, live,
                                                   decode_strings)
                continue
            vals = c.values.cpu().numpy()[live]
            if c.hi is not None:
                his = c.hi.cpu().numpy()[live]
                vals = np.array([(int(h) << 32) + int(lo)
                                 for h, lo in zip(his, vals)], dtype=object)
            valid = (None if c.validity is None
                     else c.validity.cpu().numpy()[live])
            if t.is_string and decode_strings and name in self.dicts:
                arr = self.dicts[name].decode(
                    np.where(valid, vals, -1) if valid is not None else vals)
                if t.name == "varbinary":
                    # bytes back out of the latin-1 bijection
                    arr = np.array([None if v is None
                                    else str(v).encode("latin-1")
                                    for v in arr], dtype=object)
                elif t.name in ("ipaddress", "ipprefix"):
                    # canonical-byte entries render as address text
                    from presto_tpu_torch.expr import ip as _ip

                    fmt = (_ip.format_address if t.name == "ipaddress"
                           else _ip.format_prefix)
                    arr = np.array([None if v is None else fmt(str(v))
                                    for v in arr], dtype=object)
            else:
                if isinstance(t, DecimalType) and decode_strings:
                    q = decimal.Decimal(1).scaleb(-t.scale)
                    arr = np.array(
                        [decimal.Decimal(int(v)).scaleb(-t.scale).quantize(q)
                         for v in vals], dtype=object)
                else:
                    arr = vals
                if valid is not None:
                    arr = arr.astype(object)
                    arr[~valid] = None
            out[name] = arr
        return out

    def _structural_to_py(self, name: str, t: Type, c: Column, live,
                          decode_strings: bool) -> np.ndarray:
        """An ARRAY column as an object array of Python lists, a MAP column
        as one of dicts; NULL elements and NULL rows are None. Only the
        live rows' planes leave the device."""
        rows = torch.from_numpy(np.flatnonzero(live)).to(c.values.device)
        vals, sizes, evalid, rvalid, keys = (
            None if p is None else p[rows].cpu().numpy()
            for p in (c.values, c.sizes, c.evalid, c.validity, c.keys))

        def elem(et, x, edict):
            if et.is_string and decode_strings and edict is not None:
                return None if x < 0 else edict.values[x]
            if isinstance(et, DecimalType) and decode_strings:
                return decimal.Decimal(int(x)).scaleb(-et.scale)
            return x.item() if hasattr(x, "item") else x

        edict = self.dicts.get(name) if decode_strings else None
        kdict = self.dicts.get(key_dict_name(name)) if decode_strings else None
        is_map = isinstance(t, MapType)
        et = t.element if isinstance(t, ArrayType) else t
        rows = np.empty(len(sizes), dtype=object)
        for i in range(len(sizes)):
            if rvalid is not None and not rvalid[i]:
                rows[i] = None
                continue
            s = int(sizes[i])
            if is_map:
                rows[i] = {
                    elem(t.key, keys[i, j], kdict): (
                        elem(t.value, vals[i, j], edict)
                        if evalid is None or evalid[i, j] else None)
                    for j in range(s)}
            else:
                rows[i] = [elem(et, vals[i, j], edict)
                           if evalid is None or evalid[i, j] else None
                           for j in range(s)]
        return rows

    def to_pandas(self, decode_strings: bool = True):
        import pandas as pd

        return pd.DataFrame(self.to_pydict(decode_strings))

    def __repr__(self):
        cols = ", ".join(f"{n}:{t}" for n, t in zip(self.names, self.types))
        return f"Batch[{cols}; capacity={self.capacity}]"


def empty_batch(names: Sequence[str], types: Sequence[Type],
                device: torch.device, cap: int = 128) -> Batch:
    """A batch with the given schema and no live rows (a structural
    column as planes of width 0)."""
    def col(t: Type) -> Column:
        dt = torch_dtype(t.dtype)
        if isinstance(t, (ArrayType, MapType)):
            keys = (torch.zeros((cap, 0), dtype=torch_dtype(t.key.dtype),
                                device=device)
                    if isinstance(t, MapType) else None)
            return Column(torch.zeros((cap, 0), dtype=dt, device=device),
                          sizes=torch.zeros(cap, dtype=torch.int32,
                                            device=device), keys=keys)
        return Column(torch.zeros(cap, dtype=dt, device=device))

    return Batch(names, types, [col(t) for t in types],
                 torch.zeros(cap, dtype=torch.bool, device=device), {})
