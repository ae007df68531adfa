"""ARRAY / MAP expression evaluation over the dense padded layout.

The JAX package's expr/structural.py on torch. An array value is
StructVal(values [cap, W], sizes [cap], evalid, keys), W the batch's
element width: "present" elements are those at a column index below the
row's size; a present element may still be SQL NULL through `evalid`;
a map carries an aligned key plane (map keys are never NULL). Every
function is a few vector ops over the whole plane.

Sorting inside arrays is a chain of stable torch sorts along W, least
significant key first, with the absent and NULL ranks as the leading
keys. Float keys are canonicalized first (-0.0 as +0.0, every NaN one
NaN, greatest), the order the JAX package's sort compares in; the
planes themselves keep their values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from presto_tpu_torch.batch import pad_plane_width


@dataclasses.dataclass(frozen=True)
class StructVal:
    """An evaluated array or map expression: the structural planes of a
    Column. The row's validity travels beside it, as for scalars."""

    values: torch.Tensor                  # [cap, W] element values
    sizes: torch.Tensor                   # [cap] int32 cardinalities
    evalid: Optional[torch.Tensor]        # [cap, W] element validity
    keys: Optional[torch.Tensor] = None   # [cap, W] map keys

    @property
    def width(self) -> int:
        return self.values.shape[1]

    def replace(self, **kw) -> "StructVal":
        return dataclasses.replace(self, **kw)

    def present(self) -> torch.Tensor:
        """[cap, W] mask of in-size element slots."""
        j = torch.arange(self.width, dtype=torch.int32,
                         device=self.values.device)
        return j[None, :] < self.sizes[:, None]

    def element_valid(self) -> torch.Tensor:
        """[cap, W] mask of present, non-NULL elements."""
        p = self.present()
        return p if self.evalid is None else (p & self.evalid)


def _sort_key(k: torch.Tensor) -> torch.Tensor:
    if k.dtype == torch.bool:
        return k.to(torch.int32)
    if k.is_floating_point():
        k = torch.where(k == 0, torch.zeros_like(k), k)
        return torch.where(torch.isnan(k), torch.full_like(k, float("nan")),
                           k)
    return k


def sort_along_w(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """[cap, W] permutation ordering each row by `keys` (most significant
    first), ties in slot order."""
    k0 = keys[0]
    perm = torch.arange(k0.shape[1], device=k0.device).expand(
        k0.shape[0], -1).contiguous()
    for k in reversed(keys):
        kk = torch.gather(_sort_key(k), 1, perm)
        _, idx = torch.sort(kk, dim=1, stable=True)
        perm = torch.gather(perm, 1, idx)
    return perm


def _take(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(plane, 1, idx)


def _minmax_ident(dtype: torch.dtype, want_min: bool):
    if dtype.is_floating_point:
        return float("inf") if want_min else float("-inf")
    if dtype == torch.bool:
        return want_min
    info = torch.iinfo(dtype)
    return info.max if want_min else info.min


def _rows(v, cap: int) -> torch.Tensor:
    return torch.broadcast_to(v, (cap,))


def array_ctor(parts, cap: int, dtype: torch.dtype,
               device: torch.device) -> StructVal:
    """ARRAY[e1, .., eN]: N evaluated scalars stacked into a [cap, N]
    plane. parts: list of (values, validity | None)."""
    if not parts:
        return StructVal(torch.zeros((cap, 0), dtype=dtype, device=device),
                         torch.zeros(cap, dtype=torch.int32, device=device),
                         None)
    vals = torch.stack([_rows(v, cap).to(dtype) for v, _ in parts], dim=1)
    evalid = None
    if any(valid is not None for _, valid in parts):
        evalid = torch.stack(
            [torch.ones(cap, dtype=torch.bool, device=device)
             if valid is None else _rows(valid, cap) for _, valid in parts],
            dim=1)
    sizes = torch.full((cap,), len(parts), dtype=torch.int32, device=device)
    return StructVal(vals, sizes, evalid)


def _and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def subscript(sv: StructVal, idx, idx_valid, rvalid):
    """arr[i] and element_at(arr, i): 1-based, a negative index counts from
    the end; out of range (and index 0) is NULL."""
    sizes = sv.sizes.to(idx.dtype)
    cap = sv.sizes.shape[0]
    if sv.width == 0:
        return (torch.zeros(cap, dtype=sv.values.dtype,
                            device=sv.values.device),
                torch.zeros(cap, dtype=torch.bool, device=sv.values.device))
    pos = torch.where(idx >= 0, idx - 1, sizes + idx)
    in_range = (pos >= 0) & (pos < sizes)
    posc = torch.clamp(pos, 0, sv.width - 1).to(torch.int64)[:, None]
    out = _take(sv.values, posc)[:, 0]
    valid = in_range
    if sv.evalid is not None:
        valid = valid & _take(sv.evalid, posc)[:, 0]
    return out, _and(_and(valid, idx_valid), rvalid)


def map_element_at(sv: StructVal, key, key_valid, rvalid):
    """element_at(map, k): the first matching key's value, NULL if the key
    is absent."""
    cap = sv.sizes.shape[0]
    if sv.width == 0:
        return (torch.zeros(cap, dtype=sv.values.dtype,
                            device=sv.values.device),
                torch.zeros(cap, dtype=torch.bool, device=sv.values.device))
    match = (sv.keys == key[:, None]) & sv.present()
    found = torch.any(match, dim=1)
    j = torch.argmax(match.to(torch.int8), dim=1)[:, None]
    out = _take(sv.values, j)[:, 0]
    valid = found
    if sv.evalid is not None:
        valid = valid & _take(sv.evalid, j)[:, 0]
    return out, _and(_and(valid, key_valid), rvalid)


def cardinality(sv: StructVal, rvalid):
    return sv.sizes.to(torch.int64), rvalid


def _null_if_unfound_with_nulls(found, sv: StructVal, valid):
    """contains/array_position: a miss on an array that holds a NULL
    element is unknown (NULL), not FALSE or 0."""
    if sv.evalid is None:
        return valid
    has_null = torch.any(sv.present() & ~sv.evalid, dim=1)
    known = ~(~found & has_null)
    return known if valid is None else (valid & known)


def contains(sv: StructVal, x, x_valid, rvalid):
    m = (sv.values == x[:, None]) & sv.element_valid()
    out = torch.any(m, dim=1)
    valid = _and(rvalid, x_valid)
    return out, _null_if_unfound_with_nulls(out, sv, valid)


def array_position(sv: StructVal, x, x_valid, rvalid):
    m = (sv.values == x[:, None]) & sv.element_valid()
    found = torch.any(m, dim=1)
    first = (torch.argmax(m.to(torch.int8), dim=1) + 1 if sv.width
             else torch.zeros_like(found, dtype=torch.int64))
    pos = torch.where(found, first, 0).to(torch.int64)
    valid = _and(rvalid, x_valid)
    return pos, _null_if_unfound_with_nulls(found, sv, valid)


def array_minmax(sv: StructVal, rvalid, want_min: bool):
    """array_min/array_max: NULL for an empty array or one holding a NULL
    element."""
    dt = sv.values.dtype
    ev = sv.element_valid()
    vals = sv.values.to(torch.uint8) if dt == torch.bool else sv.values
    ident = _minmax_ident(dt, want_min)
    masked = torch.where(ev, vals, torch.full_like(vals, ident))
    if sv.width == 0:
        out = torch.full((vals.shape[0],), ident, dtype=vals.dtype,
                         device=vals.device)
    else:
        out = (torch.amin(masked, dim=1) if want_min
               else torch.amax(masked, dim=1))
    has_null = torch.any(sv.present() & ~ev, dim=1)
    valid = (sv.sizes > 0) & ~has_null
    return out.to(dt), _and(valid, rvalid)


def array_sum(sv: StructVal, rvalid, dtype: torch.dtype, average: bool):
    """array_sum/array_average over the non-NULL elements (an all-NULL or
    empty array is NULL)."""
    ev = sv.element_valid()
    contrib = torch.where(ev, sv.values.to(dtype),
                          torch.zeros((), dtype=dtype, device=ev.device))
    total = torch.sum(contrib, dim=1)
    n = torch.sum(ev, dim=1)
    if average:
        total = total / torch.clamp(n, min=1).to(dtype)
    return total, _and(n > 0, rvalid)


def concat_arrays(a: StructVal, b: StructVal) -> StructVal:
    """a || b: out[j] = a[j] for j < |a|, else b[j - |a|]; width Wa + Wb."""
    wa, wb = a.width, b.width
    w = wa + wb
    cap = a.sizes.shape[0]
    dev = a.values.device
    j = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    sa = a.sizes.to(torch.int64)[:, None]
    from_a = j < sa
    ja = torch.clamp(j, 0, max(wa - 1, 0)).expand(cap, w)
    jb = torch.clamp(j - sa, 0, max(wb - 1, 0))

    def plane(pa, pb, dtype):
        va = (_take(pa, ja) if wa
              else torch.zeros((cap, w), dtype=dtype, device=dev))
        vb = (_take(pb, jb) if wb
              else torch.zeros((cap, w), dtype=dtype, device=dev))
        return torch.where(from_a, va, vb)

    dt = a.values.dtype
    vals = plane(a.values, b.values.to(dt), dt)
    evalid = None
    if a.evalid is not None or b.evalid is not None:
        ea = (a.evalid if a.evalid is not None
              else torch.ones((cap, wa), dtype=torch.bool, device=dev))
        eb = (b.evalid if b.evalid is not None
              else torch.ones((cap, wb), dtype=torch.bool, device=dev))
        evalid = plane(ea, eb, torch.bool)
    return StructVal(vals, a.sizes + b.sizes, evalid)


def _sort_planes(sv: StructVal):
    """Elements along W sorted: present non-NULL ascending, NULL elements
    after them, absent slots last. Returns (rank, values) sorted."""
    p = sv.present()
    ev = sv.element_valid()
    # 0 = valid element, 1 = NULL element, 2 = absent slot
    rank = torch.where(ev, 0, torch.where(p, 1, 2)).to(torch.int32)
    perm = sort_along_w([rank, sv.values])
    return _take(rank, perm), _take(sv.values, perm)


def array_sort(sv: StructVal) -> StructVal:
    """array_sort: ascending, NULL elements last."""
    rank_s, vals_s = _sort_planes(sv)
    evalid = rank_s == 0 if sv.evalid is not None else None
    return StructVal(vals_s, sv.sizes, evalid)


def array_distinct(sv: StructVal) -> StructVal:
    """array_distinct, sorted ascending with one NULL kept last (the JAX
    package's order; within a run of equal values the first is kept)."""
    if sv.width == 0:
        return sv
    rank_s, vals_s = _sort_planes(sv)
    prev_same = torch.zeros_like(rank_s, dtype=torch.bool)
    prev_same[:, 1:] = ((vals_s[:, 1:] == vals_s[:, :-1])
                        & (rank_s[:, 1:] == rank_s[:, :-1]))
    keep = (rank_s < 2) & ~prev_same
    # dropped slots go to the end, the kept ones stay sorted
    rank2 = torch.where(keep, rank_s, 2)
    perm = sort_along_w([rank2, vals_s])
    rank_f, vals_f = _take(rank2, perm), _take(vals_s, perm)
    sizes = torch.sum(keep, dim=1).to(torch.int32)
    evalid = rank_f == 0 if sv.evalid is not None else None
    return StructVal(vals_f, sizes, evalid)


def slice_array(sv: StructVal, start, length) -> StructVal:
    """slice(arr, start, length): 1-based start, a negative start counts
    from the end; a start outside the array gives an empty array."""
    sizes = sv.sizes.to(torch.int64)
    w = sv.width
    dev = sv.values.device
    s0 = torch.where(start >= 0, start - 1, sizes + start)
    ok = (s0 >= 0) & (start != 0) & (length >= 0)
    j = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    src = s0[:, None] + j  # out slot j reads slot s0 + j
    in_src = ok[:, None] & (src < sizes[:, None]) & (j < length[:, None])
    srcc = torch.clamp(src, 0, max(w - 1, 0))
    vals = _take(sv.values, srcc)
    new_sizes = torch.sum(in_src, dim=1).to(torch.int32)
    evalid = (_take(sv.evalid, srcc) & in_src if sv.evalid is not None
              else in_src)
    return StructVal(vals, new_sizes, evalid)


def sequence(lo: int, hi: int, step: int, cap: int,
             device: torch.device) -> StructVal:
    """sequence(lo, hi[, step]) with constant bounds."""
    if step == 0:
        raise ValueError("sequence step must not be zero")
    n = max(0, (hi - lo) // step + 1) if (hi - lo) * step >= 0 else 0
    row = lo + step * torch.arange(n, dtype=torch.int64, device=device)
    return StructVal(row[None, :].expand(cap, n),
                     torch.full((cap,), n, dtype=torch.int32, device=device),
                     None)


def repeat_val(v, v_valid, n: int, cap: int, dtype: torch.dtype) -> StructVal:
    vals = _rows(v, cap).to(dtype)[:, None].expand(cap, n)
    evalid = None if v_valid is None else v_valid[:, None].expand(cap, n)
    return StructVal(vals, torch.full((cap,), n, dtype=torch.int32,
                                      device=vals.device), evalid)


def _membership(a: StructVal, b: StructVal) -> torch.Tensor:
    """[cap, Wa]: a's element equals some present non-NULL element of b."""
    if a.width == 0 or b.width == 0:
        return torch.zeros(a.values.shape, dtype=torch.bool,
                           device=a.values.device)
    eq = a.values[:, :, None] == b.values[:, None, :]
    eq = eq & b.element_valid()[:, None, :]
    return torch.any(eq, dim=2)


def array_union(a: StructVal, b: StructVal) -> StructVal:
    return array_distinct(concat_arrays(a, b))


def array_intersect(a: StructVal, b: StructVal) -> StructVal:
    keep = a.element_valid() & _membership(a, b)
    return array_distinct(filter_elements(a, keep))


def array_except(a: StructVal, b: StructVal) -> StructVal:
    keep = a.element_valid() & ~_membership(a, b)
    return array_distinct(filter_elements(a, keep))


def arrays_overlap(a: StructVal, b: StructVal) -> torch.Tensor:
    return torch.any(a.element_valid() & _membership(a, b), dim=1)


def map_concat(a: StructVal, b: StructVal) -> StructVal:
    """map_concat(m1, m2): m2 wins on a duplicate key. The aligned planes
    concatenate; a sort by (absent, key as int64, slot) puts each key's
    entries in one run, whose last entry is kept."""
    w = a.width + b.width
    cap = a.sizes.shape[0]
    if w == 0:
        return a
    dev = a.values.device
    kd, vd = a.keys.dtype, a.values.dtype
    keys = torch.cat([a.keys, b.keys.to(kd)], dim=1)
    vals = torch.cat([a.values, b.values.to(vd)], dim=1)
    present = torch.cat([a.present(), b.present()], dim=1)
    evalid = torch.cat([a.element_valid(), b.element_valid()], dim=1)
    pos = torch.arange(w, dtype=torch.int32, device=dev).expand(cap, w)
    krank = torch.where(present, 0, 1).to(torch.int64)
    k64 = keys.to(torch.int64)
    perm = sort_along_w([krank, k64, pos])
    present_s = _take(krank, perm) == 0
    keys_s = _take(k64, perm)
    next_same = torch.zeros((cap, w), dtype=torch.bool, device=dev)
    next_same[:, :-1] = (keys_s[:, :-1] == keys_s[:, 1:]) & present_s[:, 1:]
    keep = present_s & ~next_same
    # every slot counts as present here, so filter_elements sees each
    # entry's own validity; it recomputes the sizes from `keep`
    out = StructVal(_take(vals, perm),
                    torch.full((cap,), w, dtype=torch.int32, device=dev),
                    _take(evalid, perm), keys=keys_s.to(kd))
    return filter_elements(out, keep)


def filter_elements(sv: StructVal, keep: torch.Tensor) -> StructVal:
    """The elements where `keep` holds, compacted to the front in their
    order (a stable sort on the drop flag); a key plane follows."""
    if sv.width == 0:
        return sv
    _, perm = torch.sort((~keep).to(torch.int32), dim=1, stable=True)
    ev_s = _take(sv.element_valid(), perm)
    keys_s = None if sv.keys is None else _take(sv.keys, perm)
    sizes = torch.sum(keep, dim=1).to(torch.int32)
    present = (torch.arange(sv.width, dtype=torch.int32,
                            device=keep.device)[None, :] < sizes[:, None])
    return StructVal(_take(sv.values, perm), sizes, ev_s & present,
                     keys=keys_s)


def map_from_arrays(k: StructVal, v: StructVal) -> StructVal:
    """map(keys, values): aligned planes, sizes from the key array; keys
    beyond the value array's size map to NULL values (the JAX package's
    stand-in for the length-mismatch error)."""
    w = max(k.width, v.width)
    keys = pad_plane_width(k.values, w)
    vals = pad_plane_width(v.values, w)
    in_vals = v.present() if v.evalid is None else v.element_valid()
    evalid = pad_plane_width(in_vals, w, False)
    return StructVal(vals, k.sizes, evalid, keys=keys)


def map_keys(sv: StructVal) -> StructVal:
    return StructVal(sv.keys, sv.sizes, None)


def map_values(sv: StructVal) -> StructVal:
    return StructVal(sv.values, sv.sizes, sv.evalid)
