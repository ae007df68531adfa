"""Grouped aggregation — the GROUP BY kernel.

Reference: operator/MultiChannelGroupByHash.java:54 feeding
InMemoryHashAggregationBuilder.

The same four routes as the JAX package's ops/grouping.py, with the same
results and the same fixed-capacity contract:

- **no keys** (global aggregate): one masked reduction per state.
- **small static key domain** (dictionary/boolean keys, ≤ _MASK_SLOTS
  slots): the group id is the mixed-radix number of the key digits. The
  sort engine reduces states by an indexed add over that id; the hash
  engine sends the integer sums through the `grouped_sums` kernel.
- **sort engine**: lexicographic sort over (deadness, per-key null bit,
  key value)*, boundary detection, then an indexed reduction per segment
  into a table ordered by key.
- **hash engine**: group ids from the `group_insert` hash-table kernel,
  then states reduce by gid (`grouped_sums` for small all-integer tables).

The sort engine is library torch code (`torch.sort`, `cumsum`,
`searchsorted`, `index_add_`, `scatter_reduce_`); the hash engine's
kernels are in ops/hash_kernels.py and ops/groupby_kernels.py.

Integer sums are exact mod 2^64 on every route. Float sums add in another
order than the JAX package's segmented scans (and in atomics order on the
GPU), so they agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.ops import groupby_kernels as _gk
from presto_tpu_torch.ops import hash_kernels as _hk
from presto_tpu_torch.ops.hashing import hash_columns, slot_hash
from presto_tpu_torch.ops.sort import lex_sort_permutation


class StateCol(NamedTuple):
    values: torch.Tensor
    validity: Optional[torch.Tensor]  # None = all valid
    op: str  # 'sum' | 'min' | 'max' | 'count_add' (values are counts)


class KeyCol(NamedTuple):
    values: torch.Tensor
    validity: Optional[torch.Tensor]
    # exclusive upper bound of non-null values when statically known
    # (dictionary codes, booleans): enables the direct-indexed path
    domain: Optional[int] = None


def _minmax_identity(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


# Small-domain direct path: at most this many mixed-radix slots.
_MASK_SLOTS = 128
# Hash engine: tables of at most this many physical slots reduce all-integer
# states through the grouped_sums kernel; larger ones by an indexed add.
_HASH_KERNEL_SLOTS = 512


def grouped_merge(
    keys: Sequence[KeyCol],
    states: Sequence[StateCol],
    live: torch.Tensor,
    num_groups_cap: int,
    engine: str = "sort",
) -> Tuple[list, list, torch.Tensor, torch.Tensor]:
    """Group rows by `keys`, merging `states` within each group.

    Returns (key_cols_out, state_cols_out, out_live, n_groups): all output
    arrays share one capacity (num_groups_cap on the sort path; the pow2
    hash-table capacity on the hash path — callers size off the returned
    arrays) and slots with out_live=False are dead. NULL keys form their
    own group. If n_groups > num_groups_cap the caller must retry with a
    bigger capacity (on the hash engine n_groups then upper-bounds the
    true distinct count instead of equaling it).

    engine: "sort" (groups ordered by key) or "hash" (hash-slot order).
    Both produce the same group multiset."""
    if not keys:
        return _global_merge(states, live, num_groups_cap)

    if all(k.domain is not None for k in keys):
        dom_slots = [
            (k.domain + 1) if k.validity is not None else max(k.domain, 1)
            for k in keys
        ]
        total = 1
        for ds in dom_slots:
            total *= ds
        if 0 < total <= min(num_groups_cap, _MASK_SLOTS):
            return _direct_grouped_merge(keys, states, live, num_groups_cap,
                                         dom_slots, engine)

    if engine == "hash":
        return _hash_grouped_merge(keys, states, live, num_groups_cap)
    return _sort_grouped_merge(keys, states, live, num_groups_cap)


def _sort_grouped_merge(keys, states, live, cap):
    """Sort engine: lexicographic sort, boundaries, indexed reduction."""
    n = live.shape[0]
    dev = live.device
    dead = (~live).to(torch.int32)
    operands = [dead]
    for k in keys:
        if k.validity is not None:
            operands.append((~k.validity).to(torch.int32))
            operands.append(torch.where(k.validity, k.values,
                                        torch.zeros_like(k.values)))
        else:
            operands.append(k.values)
    perm = lex_sort_permutation(operands)
    sorted_keys = [op[perm] for op in operands]
    sdead = sorted_keys[0] == 1

    # boundary where any sort key changes (first row is always one)
    change = torch.zeros(n, dtype=torch.bool, device=dev)
    change[0] = True
    for sk in sorted_keys:
        change[1:] |= sk[1:] != sk[:-1]
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    n_groups = torch.where(sdead, -1, seg).max() + 1
    # groups past the capacity (caller replays) and dead rows fold into
    # one out-of-range bucket, keeping `seg` sorted
    seg = torch.where(sdead, cap, torch.clamp(seg, max=cap))

    gids = torch.arange(cap, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(seg, gids, side="left")
    ends = torch.searchsorted(seg, gids, side="right") - 1
    has = ends >= starts
    starts_c = torch.clamp(starts, 0, n - 1)

    key_out = []
    ki = 1
    for k in keys:
        if k.validity is not None:
            nullbit, vals = sorted_keys[ki], sorted_keys[ki + 1]
            ki += 2
            kv = torch.where(has, vals[starts_c], torch.zeros_like(vals[:1]))
            key_out.append(KeyCol(kv, has & (nullbit[starts_c] == 0)))
        else:
            vals = sorted_keys[ki]
            ki += 1
            kv = torch.where(has, vals[starts_c], torch.zeros_like(vals[:1]))
            key_out.append(KeyCol(kv, None))

    state_out = []
    for s in states:
        svalid = s.validity[perm] if s.validity is not None else None
        state_out.append(_segment_reduce(s.values[perm], svalid, s.op, seg,
                                         has, cap))
    out_live = gids < n_groups
    return key_out, state_out, out_live, n_groups


def _segment_reduce(sv, svalid, op: str, seg, has, nseg: int) -> StateCol:
    """One state column → per-segment aggregate over rows with seg in
    [0, nseg); rows with seg == nseg are dropped. `has` marks segments
    that hold at least one row."""
    if op in ("sum", "count_add"):
        contrib = sv if svalid is None else torch.where(
            svalid, sv, torch.zeros_like(sv))
        agg = torch.zeros(nseg + 1, dtype=sv.dtype, device=sv.device)
        agg.index_add_(0, seg, contrib)
    else:
        ident = _minmax_identity(sv.dtype, op)
        contrib = sv if svalid is None else torch.where(
            svalid, sv, torch.full_like(sv, ident))
        agg = torch.full((nseg + 1,), ident, dtype=sv.dtype, device=sv.device)
        agg.scatter_reduce_(0, seg, contrib, "amin" if op == "min" else "amax")
    agg = torch.where(has, agg[:nseg], torch.zeros_like(agg[:1]))
    if op == "count_add":
        return StateCol(agg, None, op)
    if svalid is None:
        return StateCol(agg, has, op)
    nvalid = torch.zeros(nseg + 1, dtype=torch.int64, device=sv.device)
    nvalid.index_add_(0, seg, svalid.to(torch.int64))
    return StateCol(agg, has & (nvalid[:nseg] > 0), op)


def _global_merge(states, live, num_groups_cap):
    """No GROUP BY keys: one masked reduction per state into slot 0."""
    dev = live.device
    any_live = live.any()
    slot0 = torch.arange(num_groups_cap, device=dev) == 0
    out_live = slot0 & any_live
    n_groups = any_live.to(torch.int64)
    state_out = []
    for s in states:
        sv, svalid = s.values, s.validity
        valid = live if svalid is None else (live & svalid)
        if s.op in ("sum", "count_add"):
            total = torch.where(valid, sv, torch.zeros_like(sv)).sum()
        else:
            ident = torch.full_like(sv, _minmax_identity(sv.dtype, s.op))
            masked = torch.where(valid, sv, ident)
            total = masked.min() if s.op == "min" else masked.max()
        agg = torch.zeros(num_groups_cap, dtype=sv.dtype, device=dev)
        agg[0] = total
        if s.op == "count_add":
            state_out.append(StateCol(agg, None, s.op))
        else:
            state_out.append(StateCol(agg, slot0 & valid.any(), s.op))
    return [], state_out, out_live, n_groups


def _direct_gid(keys, live, dom_slots, total):
    """Mixed-radix group id of each row; dead rows get `total`."""
    gid = torch.zeros(live.shape[0], dtype=torch.int32, device=live.device)
    for k, ds in zip(keys, dom_slots):
        v = k.values.to(torch.int32)
        if k.validity is not None:
            slot = torch.where(k.validity, torch.clamp(v, 0, ds - 2) + 1, 0)
        else:
            slot = torch.clamp(v, 0, ds - 1)
        gid = gid * ds + slot.to(torch.int32)
    return torch.where(live, gid, total)


def _decode_direct_keys(keys, dom_slots, num_groups_cap, dev):
    """Key columns decoded from the slot index itself."""
    rem = torch.arange(num_groups_cap, dtype=torch.int32, device=dev)
    digits = []
    for ds in reversed(dom_slots):
        digits.append(rem % ds)
        rem = rem // ds
    digits.reverse()
    key_out = []
    for k, d in zip(keys, digits):
        if k.validity is not None:
            kvd = d > 0
            kv = torch.where(kvd, d - 1, 0).to(k.values.dtype)
            key_out.append(KeyCol(kv, kvd, k.domain))
        else:
            key_out.append(KeyCol(d.to(k.values.dtype), None, k.domain))
    return key_out


def _widen(arr, total: int, cap: int, dtype):
    out = torch.zeros(cap, dtype=dtype, device=arr.device)
    out[:total] = arr.to(dtype)
    return out


def _direct_grouped_merge(keys, states, live, num_groups_cap, dom_slots,
                          engine: str = "sort"):
    """Small-key-domain GROUP BY: the group id IS the mixed-radix number of
    the key digits (nullable keys reserve digit 0 for NULL), so no sort is
    needed; the group table is sparse (out_live marks occupied slots) and
    its keys decode from the slot index. Π dom_slots ≤ cap, so it cannot
    overflow. The hash engine sends integer sums through `grouped_sums`."""
    total = 1
    for ds in dom_slots:
        total *= ds
    gid = _direct_gid(keys, live, dom_slots, total)
    if engine == "hash":
        return _kernel_direct_merge(keys, states, live, num_groups_cap,
                                    dom_slots, gid, total)
    dev = live.device
    idx = gid.to(torch.int64)
    counts_g = torch.bincount(idx, minlength=total + 1)[:total]
    counts = _widen(counts_g, total, num_groups_cap, torch.int32)
    out_live = counts > 0
    n_groups = out_live.sum()
    key_out = _decode_direct_keys(keys, dom_slots, num_groups_cap, dev)
    has = torch.ones(total, dtype=torch.bool, device=dev)
    state_out = []
    for s in states:
        r = _segment_reduce(s.values, s.validity, s.op, idx, has, total)
        if r.op != "count_add" and s.validity is None:
            r = StateCol(r.values, counts_g > 0, r.op)
        state_out.append(_widen_state(r, total, num_groups_cap))
    return key_out, state_out, out_live, n_groups


def _widen_state(r: StateCol, total: int, cap: int) -> StateCol:
    v = _widen(r.values, total, cap, r.values.dtype)
    valid = None if r.validity is None else _widen(r.validity, total, cap,
                                                   torch.bool)
    return StateCol(v, valid, r.op)


def _int_sum_states(states, live, int_states: list) -> list:
    """Append the `grouped_sums` states of each integer sum to int_states,
    as they lie: its values masked by its own validity, and for a sum (not
    a count) its valid-row count as a bool state. gid already drops dead
    rows, so neither needs `live`; a count state that is a tensor already
    in the list (such as `live`) is not added twice. Returns per state
    (values index, count index), (None, None) for a state that is not an
    integer sum."""
    seen = {id(t): i for i, t in enumerate(int_states)}

    def add(t):
        if id(t) not in seen:
            seen[id(t)] = len(int_states)
            int_states.append(t)
        return seen[id(t)]

    plan = []
    for s in states:
        if s.op not in ("sum", "count_add") or s.values.is_floating_point():
            plan.append((None, None))
            continue
        main = len(int_states)
        int_states.append(s.values if s.validity is None
                          else (s.values, s.validity))
        count = None if s.op == "count_add" else add(
            live if s.validity is None else s.validity)
        plan.append((main, count))
    return plan


def _kernel_direct_merge(keys, states, live, num_groups_cap, dom_slots,
                         gid, total):
    """Direct small-domain path through the grouped_sums kernel: integer
    sums (decimal money, counts) and validity counts fuse into one exact
    pass; float sums and min/max states take the indexed reduction."""
    # group occupancy ride-along: the live flags
    int_states = [live]
    plan = _int_sum_states(states, live, int_states)
    iouts = _gk.grouped_sums(gid, int_states, total)

    counts = _widen(iouts[0], total, num_groups_cap, torch.int32)
    out_live = counts > 0
    n_groups = out_live.sum()
    key_out = _decode_direct_keys(keys, dom_slots, num_groups_cap, live.device)

    idx = gid.to(torch.int64)
    has = torch.ones(total, dtype=torch.bool, device=live.device)
    state_out = []
    for s, (i, nv_i) in zip(states, plan):
        if i is None:
            r = _segment_reduce(s.values, s.validity, s.op, idx, has, total)
            if r.op != "count_add" and s.validity is None:
                r = StateCol(r.values, iouts[0] > 0, r.op)
            state_out.append(_widen_state(r, total, num_groups_cap))
            continue
        agg = _widen(iouts[i], total, num_groups_cap, s.values.dtype)
        if s.op == "count_add":
            state_out.append(StateCol(agg, None, s.op))
            continue
        nvalid = _widen(iouts[nv_i], total, num_groups_cap, torch.int32)
        state_out.append(StateCol(agg, nvalid > 0, s.op))
    return key_out, state_out, out_live, n_groups


def _hash_grouped_merge(keys, states, live, num_groups_cap):
    """General GROUP BY on the linear-probing table: encode keys into int64
    planes, assign group ids with the `group_insert` kernel, then reduce
    states by gid — through `grouped_sums` when every state is an integer
    sum and the table is small, else by an indexed reduction.

    The group table is sparse over the physical capacity (2× the pow2
    logical cap): out_live marks occupied slots, keys decode from the
    stored planes. Overflow reports n_groups > num_groups_cap so the
    caller's regrow replay fires."""
    cap = 1
    while cap < num_groups_cap:
        cap *= 2
    tcap = 2 * cap

    planes, has_nulls = _hk.encode_group_keys(
        [(k.values, k.validity) for k in keys])
    slot0 = slot_hash(hash_columns(list(planes)), tcap)
    gid, table, occ, ngroups, ovf = _hk.group_insert(planes, slot0, live, cap)
    out_live = occ > 0

    # ovf counts unplaced ROWS (an upper bound on the missing distinct
    # keys): clamp the overshoot so the regrow ladder stays geometric
    ovf64 = ovf.to(torch.int64)
    ng = torch.where(ovf64 > 0, cap + torch.clamp(ovf64, max=3 * cap),
                     ngroups.to(torch.int64))

    nullplane = table[len(keys)] if has_nulls else None
    key_out = []
    for j, k in enumerate(keys):
        kv = _hk.decode_plane(table[j], k.values.dtype)
        if k.validity is not None:
            nbit = (nullplane >> j) & 1
            key_out.append(KeyCol(kv, out_live & (nbit == 0), k.domain))
        else:
            key_out.append(KeyCol(kv, None, k.domain))

    if not states:
        return key_out, [], out_live, ng
    all_int_sums = all(s.op in ("sum", "count_add")
                       and not s.values.is_floating_point() for s in states)
    if all_int_sums and tcap <= _HASH_KERNEL_SLOTS:
        state_out = _hash_states_kernel(states, live, gid, tcap)
    else:
        state_out = _hash_states_indexed(states, gid, tcap)
    return key_out, state_out, out_live, ng


def _hash_states_kernel(states, live, gid, tcap: int):
    """All-integer-sum states reduce in one `grouped_sums` pass (gid >=
    tcap marks dead/unplaced rows)."""
    int_states = []
    plan = _int_sum_states(states, live, int_states)
    iouts = _gk.grouped_sums(gid, int_states, tcap)
    state_out = []
    for s, (mi, ni) in zip(states, plan):
        agg = iouts[mi].to(s.values.dtype)
        if s.op == "count_add":
            state_out.append(StateCol(agg, None, s.op))
        else:
            state_out.append(StateCol(agg, iouts[ni] > 0, s.op))
    return state_out


def _hash_states_indexed(states, gid, tcap: int):
    """General states reduce by gid with an indexed add / scatter-reduce —
    the counterpart of the JAX package's gid-sorted segmented scan (same
    integer results; float sums differ in addition order only). Dead and
    unplaced rows (gid == tcap) land in a dropped bucket."""
    idx = gid.to(torch.int64)
    counts = torch.bincount(idx, minlength=tcap + 1)[:tcap]
    has = counts > 0
    return [_segment_reduce(s.values, s.validity, s.op, idx, has, tcap)
            for s in states]
