"""Linear-probing hash tables — the hash breaker engine's kernels, the
counterpart of the JAX package's ops/pallas_hash.py.

- Keys are pre-encoded into int64 planes (`encode_plane`): plane equality
  ⇔ SQL key equality. Floats are bit-cast with -0.0 → +0.0; GROUP BY also
  canonicalizes NaN so all NaNs form one group. (The sort engine's `!=`
  boundary detection gives each NaN row its own group — a documented
  deviation; equi-joins exclude NaN keys on both sides.)
- The physical table is 2× the logical capacity (load ≤ 50%). Inserts stop
  at `cap` distinct keys, so overflow > 0 ⇔ more than `cap` distinct keys:
  the n_groups > cap contract the drivers replay on.
- Join probe returns a bounded-fanout match matrix mm[n, F] plus EXACT
  per-row counts; rows with more than F matches set the overflow counter
  and the driver re-probes with F doubled.

Each wrapper launches its CUDA kernel (csrc/hash_table.cu) for CUDA
tensors and takes its plain version for CPU tensors. The plain versions
are serial loops that mirror the serial TPU kernels step for step (same
slot order), so on the CPU they agree bit for bit with the JAX package.
The CUDA kernels insert in parallel: slot assignment, and so hash-engine
group order and the order of matches within a probe row, may differ from
the serial kernels'; the group multiset, gid consistency, counts and the
overflow signal do not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import counted
from presto_tpu_torch.kernels._build import check, library, stream_ptr

_NAN64_BITS = 0x7FF8000000000000
_NAN32_BITS = 0x7FC00000


# ---------------------------------------------------------------------------
# key-plane encoding


def encode_plane(values: torch.Tensor, target_dtype=None,
                 canonicalize_nan: bool = True) -> torch.Tensor:
    """One key column → an int64 plane where plane equality matches SQL
    equality under `target_dtype` (a torch dtype; the pairwise-promoted
    compare dtype for joins, the column's own dtype for GROUP BY)."""
    v = values
    if target_dtype is not None and v.dtype != target_dtype:
        v = v.to(target_dtype)
    if v.dtype == torch.bool:
        return v.to(torch.int64)
    if v.is_floating_point():
        if v.dtype != torch.float32:
            v = v.to(torch.float64)
        v = v + 0.0  # -0.0 + 0.0 == +0.0
        if v.dtype == torch.float32:
            bits = v.view(torch.int32).to(torch.int64)
            nan = _NAN32_BITS
        else:
            bits = v.view(torch.int64)
            nan = _NAN64_BITS
        if canonicalize_nan:
            bits = torch.where(torch.isnan(v), torch.full_like(bits, nan), bits)
        return bits
    return v.to(torch.int64)


def decode_plane(plane: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reverse `encode_plane` for GROUP BY key materialization."""
    if dtype == torch.bool:
        return plane != 0
    if dtype == torch.float32:
        return plane.to(torch.int32).view(torch.float32)
    if dtype.is_floating_point:
        return plane.view(torch.float64).to(dtype)
    return plane.to(dtype)


def encode_group_keys(
    cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
) -> Tuple[torch.Tensor, bool]:
    """GROUP BY keys → stacked planes [K', n]. Nullable keys zero their
    plane on NULL and set a bit in a shared trailing nullbits plane, so
    NULLs form one group per key, apart from value 0.

    Returns (planes, has_null_plane)."""
    planes = []
    nullbits = None
    for j, (v, valid) in enumerate(cols):
        p = encode_plane(v)
        if valid is not None:
            p = torch.where(valid, p, torch.zeros_like(p))
            nb = torch.where(valid, torch.zeros_like(p),
                             torch.full_like(p, 1 << j))
            nullbits = nb if nullbits is None else nullbits | nb
        planes.append(p)
    if nullbits is not None:
        planes.append(nullbits)
    return torch.stack(planes), nullbits is not None


def _check_pow2(name: str, v: int) -> None:
    if v <= 0 or v & (v - 1):
        raise ValueError(f"{name} must be a positive power of two, got {v}")


def _same_device(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# group-by insert


def group_insert_plain(planes, slot0, live, cap: int):
    """Serial linear-probing insert, step for step the TPU kernel's loop:
    rows in order, each probing (slot0 + j) & (tcap - 1) until it meets its
    key (match) or an empty slot (claim, while under `cap` distinct)."""
    k, n = planes.shape
    tcap = 2 * cap
    mask = tcap - 1
    keys = list(zip(*planes.tolist())) if k else [()] * n
    s0s = slot0.tolist()
    lives = live.tolist()
    slots = [None] * tcap
    gid = [tcap] * n
    ngroups = ovf = 0
    for i in range(n):
        if not lives[i]:
            continue
        ki = keys[i]
        s0 = s0s[i]
        kind, slot = 0, 0
        for j in range(tcap):
            slot = (s0 + j) & mask
            stored = slots[slot]
            if stored is None:
                kind = 2
                break
            if stored == ki:
                kind = 1
                break
        if kind == 2 and ngroups < cap:
            slots[slot] = ki
            ngroups += 1
            gid[i] = slot
        elif kind == 1:
            gid[i] = slot
        else:
            ovf += 1
    table = torch.zeros(k, tcap, dtype=torch.int64)
    occ = torch.zeros(tcap, dtype=torch.int32)
    used = [s for s in range(tcap) if slots[s] is not None]
    if used:
        idx = torch.tensor(used, dtype=torch.int64)
        table[:, idx] = torch.tensor([slots[s] for s in used],
                                     dtype=torch.int64).T
        occ[idx] = 1
    return (torch.tensor(gid, dtype=torch.int32), table, occ,
            torch.tensor(ngroups, dtype=torch.int32),
            torch.tensor(ovf, dtype=torch.int32))


def _group_insert_cuda(planes, slot0, live, cap: int):
    k, n = planes.shape
    tcap = 2 * cap
    dev = planes.device
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    table = torch.zeros(k, tcap, dtype=torch.int64, device=dev)
    occ = torch.zeros(tcap, dtype=torch.int32, device=dev)
    state = torch.zeros(tcap, dtype=torch.int32, device=dev)
    stat = torch.zeros(3, dtype=torch.int32, device=dev)
    lib = library("hash_table")
    group_insert.launches += 1
    check(lib.group_insert_launch(
        slot0.data_ptr(), planes.data_ptr(), live.data_ptr(), gid.data_ptr(),
        table.data_ptr(), occ.data_ptr(), state.data_ptr(), stat.data_ptr(),
        n, k, cap, stream_ptr(dev)), "group_insert")
    return gid, table, occ, stat[0], stat[1]


@counted("group_insert")
def group_insert(planes: torch.Tensor, slot0: torch.Tensor,
                 live: torch.Tensor, cap: int):
    """Assign linear-probing group ids for GROUP BY.

    planes: int64[K, n] encoded key planes; slot0: int32[n] initial slot in
    [0, 2*cap); cap: the logical pow2 group budget (table tcap = 2*cap).

    Returns (gid int32[n], table int64[K, tcap], occ int32[tcap],
    n_groups int32, overflow int32). gid == tcap marks dead or unplaced
    rows; overflow counts unplaced live rows, so overflow > 0 ⇔ more than
    cap distinct keys."""
    _check_pow2("cap", cap)
    dev = _same_device("group_insert", planes, slot0, live)
    planes = planes.to(torch.int64).contiguous()
    slot0 = slot0.to(torch.int32).contiguous()
    live = live.to(torch.bool).contiguous()
    if dev.type == "cpu":
        return group_insert_plain(planes, slot0, live, cap)
    return _group_insert_cuda(planes, slot0, live, cap)


# ---------------------------------------------------------------------------
# join build insert


def join_insert_plain(slot0, live, tcap: int):
    """Serial build insert: each live row, in order, claims the first empty
    slot of its chain."""
    mask = tcap - 1
    slot_row = [-1] * tcap
    for i, (s0, lv) in enumerate(zip(slot0.tolist(), live.tolist())):
        if not lv:
            continue
        for j in range(tcap):
            s = (s0 + j) & mask
            if slot_row[s] < 0:
                slot_row[s] = i
                break
    return torch.tensor(slot_row, dtype=torch.int32)


def _join_insert_cuda(slot0, live, tcap: int):
    dev = slot0.device
    slot_row = torch.full((tcap,), -1, dtype=torch.int32, device=dev)
    lib = library("hash_table")
    join_insert.launches += 1
    check(lib.join_insert_launch(slot0.data_ptr(), live.data_ptr(),
                                 slot_row.data_ptr(), slot0.shape[0], tcap,
                                 stream_ptr(dev)), "join_insert")
    return slot_row


@counted("join_insert")
def join_insert(slot0: torch.Tensor, live: torch.Tensor,
                tcap: int) -> torch.Tensor:
    """Build-side insert → slot_row int32[tcap], the build ROW index in
    each slot (-1 = empty). tcap must be a pow2 ≥ 2× the live row count."""
    _check_pow2("tcap", tcap)
    dev = _same_device("join_insert", slot0, live)
    slot0 = slot0.to(torch.int32).contiguous()
    live = live.to(torch.bool).contiguous()
    if dev.type == "cpu":
        return join_insert_plain(slot0, live, tcap)
    return _join_insert_cuda(slot0, live, tcap)


# ---------------------------------------------------------------------------
# join probe


def join_probe_plain(slot0, pkeys, plive, slot_row, bkeys, fanout: int):
    """Serial probe: each live row walks its chain to the first empty slot,
    recording the first `fanout` verified matches and counting them all."""
    tcap = slot_row.shape[0]
    mask = tcap - 1
    n = slot0.shape[0]
    pk = list(zip(*pkeys.tolist())) if pkeys.shape[0] else [()] * n
    bk = (list(zip(*bkeys.tolist())) if bkeys.shape[0]
          else [()] * bkeys.shape[1])
    srow = slot_row.tolist()
    mm = [[-1] * fanout for _ in range(n)]
    cnt = [0] * n
    ovf = 0
    for i, (s0, lv) in enumerate(zip(slot0.tolist(), plive.tolist())):
        if not lv:
            continue
        ki = pk[i]
        c = 0
        for j in range(tcap):
            r = srow[(s0 + j) & mask]
            if r < 0:
                break
            if bk[r] == ki:
                if c < fanout:
                    mm[i][c] = r
                c += 1
        cnt[i] = c
        ovf += c > fanout
    return (torch.tensor(mm, dtype=torch.int32).reshape(n, fanout),
            torch.tensor(cnt, dtype=torch.int32),
            torch.tensor(ovf, dtype=torch.int32))


def _join_probe_cuda(slot0, pkeys, plive, slot_row, bkeys, fanout: int):
    dev = slot0.device
    n = slot0.shape[0]
    k = pkeys.shape[0]
    # the kernel writes every entry of mm and cnt; the launch zeroes stat
    mm = torch.empty((n, fanout), dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    stat = torch.empty(1, dtype=torch.int32, device=dev)
    lib = library("hash_table")
    join_probe.launches += 1
    check(lib.join_probe_launch(
        slot0.data_ptr(), pkeys.data_ptr(), plive.data_ptr(),
        slot_row.data_ptr(), bkeys.data_ptr(), mm.data_ptr(), cnt.data_ptr(),
        stat.data_ptr(), 1, n, k, bkeys.shape[1], slot_row.shape[0], fanout,
        stream_ptr(dev)), "join_probe")
    return mm, cnt, stat[0]


@counted("join_probe")
def join_probe(slot0: torch.Tensor, pkeys: torch.Tensor, plive: torch.Tensor,
               slot_row: torch.Tensor, bkeys: torch.Tensor, fanout: int):
    """Probe-side lookup.

    slot0: int32[n]; pkeys: int64[K, n] probe planes; bkeys: int64[K, cap_b]
    build planes by build ROW; slot_row: int32[tcap] from join_insert.
    Returns (mm int32[n, fanout] first matches, -1 padded; counts int32[n]
    exact; overflow int32 = rows with counts > fanout)."""
    _check_pow2("fanout", fanout)
    dev = _same_device("join_probe", slot0, pkeys, plive, slot_row, bkeys)
    if pkeys.shape[0] != bkeys.shape[0]:
        raise ValueError("join_probe: probe and build key plane counts differ")
    slot0 = slot0.to(torch.int32).contiguous()
    pkeys = pkeys.to(torch.int64).contiguous()
    plive = plive.to(torch.bool).contiguous()
    slot_row = slot_row.to(torch.int32).contiguous()
    bkeys = bkeys.to(torch.int64).contiguous()
    if dev.type == "cpu":
        return join_probe_plain(slot0, pkeys, plive, slot_row, bkeys, fanout)
    return _join_probe_cuda(slot0, pkeys, plive, slot_row, bkeys, fanout)
