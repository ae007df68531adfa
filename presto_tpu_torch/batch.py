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
and dictionaries. Structural (ARRAY/MAP) planes are not carried yet.
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.types import DecimalType, Type, torch_dtype


def round_up_capacity(n: int, minimum: int = 128) -> int:
    """Pad row counts into power-of-two buckets."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclass(frozen=True)
class Column:
    """values + optional validity + optional long-decimal high limb.

    `hi` is the high limb of a long-decimal column (DecimalType precision
    > 18): value = hi * 2^32 + values, with values (the low limb) kept
    canonical in [0, 2^32). None for every other type."""

    values: torch.Tensor
    validity: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.values.shape[0], dtype=torch.bool,
                              device=self.values.device)
        return self.validity

    def gather(self, idx: torch.Tensor) -> "Column":
        """Row gather preserving validity and the long-decimal limb."""
        return Column(
            self.values[idx],
            None if self.validity is None else self.validity[idx],
            None if self.hi is None else self.hi[idx],
        )

    def combined_f64(self) -> torch.Tensor:
        """Full value as float64 (exact below 2^53)."""
        if self.hi is None:
            return self.values.to(torch.float64)
        return (self.hi.to(torch.float64) * float(1 << 32)
                + self.values.to(torch.float64))


def concat_columns(cols: Sequence[Column], caps: Sequence[int]) -> Column:
    """Row-concatenate Columns preserving validity and long-decimal limbs."""
    dev = cols[0].values.device
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
    return Column(vals, valid, hi)


def slice_column(c: Column, cap: int) -> Column:
    """First-cap-rows slice preserving every plane."""
    return Column(
        c.values[:cap],
        None if c.validity is None else c.validity[:cap],
        None if c.hi is None else c.hi[:cap],
    )


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
        return Batch([self.names[i] for i in idx],
                     [self.types[i] for i in idx],
                     [self.columns[i] for i in idx], self.live,
                     {n: self.dicts[n] for n in names if n in self.dicts})

    def rename(self, names: Sequence[str]) -> "Batch":
        if len(names) != len(self.names):
            raise ValueError(f"rename to {len(names)} names, batch has "
                             f"{len(self.names)} columns")
        dicts = {new: self.dicts[old]
                 for old, new in zip(self.names, names) if old in self.dicts}
        return Batch(names, self.types, self.columns, self.live, dicts)

    def with_column(self, name: str, typ: Type, col: Column,
                    dictionary=None) -> "Batch":
        names, types, cols = list(self.names), list(self.types), list(self.columns)
        dicts = dict(self.dicts)
        if name in names:
            i = names.index(name)
            types[i] = typ
            cols[i] = col
            dicts.pop(name, None)
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

    def to_pandas(self, decode_strings: bool = True):
        import pandas as pd

        return pd.DataFrame(self.to_pydict(decode_strings))

    def __repr__(self):
        cols = ", ".join(f"{n}:{t}" for n, t in zip(self.names, self.types))
        return f"Batch[{cols}; capacity={self.capacity}]"


def empty_batch(names: Sequence[str], types: Sequence[Type],
                device: torch.device, cap: int = 128) -> Batch:
    """A batch with the given schema and no live rows."""
    return Batch(names, types,
                 [Column(torch.zeros(cap, dtype=torch_dtype(t.dtype),
                                     device=device)) for t in types],
                 torch.zeros(cap, dtype=torch.bool, device=device), {})
