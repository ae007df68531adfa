"""Hash join kernels: two engines with one contract.

Reference: operator/HashBuilderOperator.java (build), PagesHash.java /
JoinHash + PositionLinks (probe), LookupJoinOperator.java (probe loop).

- **Sort engine** (`build_side`, `probe_*`): the build side is sorted by a
  64-bit key hash; a probe is two binary searches (searchsorted left/right)
  giving each probe row its candidate range, verified against the real
  key columns. A counts pass plus prefix sums maps output slots back to
  (probe row, ordinal) for fanout joins, chunked by the caller.
- **Hash engine** (`hash_build_side`, `hash_probe_*`): the build keeps
  input order and the `join_insert` kernel maps probe-chain slots to build
  rows; the `join_probe` kernel returns a bounded match matrix and exact
  counts (ops/hash_kernels.py).

Rows with a NULL key never match, on either side.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from presto_tpu_torch.batch import (
    Batch,
    Column,
    carry_dicts,
    round_up_capacity,
)
from presto_tpu_torch.ops import hash_kernels
from presto_tpu_torch.ops.hashing import hash_columns, slot_hash
from presto_tpu_torch.ops.sort import permute_batch

_SENTINEL = torch.iinfo(torch.int64).max


class BuildTable(NamedTuple):
    """Sorted-by-hash build side. `batch` holds payload + key columns with
    NULL-key rows live-killed; `hashes` aligned with it; `orig_live` keeps
    input liveness for the FULL OUTER remainder."""

    hashes: torch.Tensor  # int64[cap], sorted; dead lanes = int64.max
    batch: Batch
    n_rows: torch.Tensor  # device scalar
    orig_live: torch.Tensor  # bool[cap], aligned with batch


def join_hash(batch: Batch, key_names: Sequence[str]) -> torch.Tensor:
    return hash_columns([batch.column(k).values for k in key_names],
                        [batch.column(k).validity for k in key_names])


def _nonnull_live(batch: Batch, key_names: Sequence[str]) -> torch.Tensor:
    live = batch.live
    for k in key_names:
        v = batch.column(k).validity
        if v is not None:
            live = live & v
    return live


def align_probe_strings(probe: Batch, probe_keys: Sequence[str], table,
                        build_keys: Sequence[str]) -> Batch:
    """Equi-join on varchar compares dictionary codes, so probe codes are
    remapped into the build side's dictionary code space (host-built
    table, one device gather). Codes with no build-side entry become -1,
    which never equals a valid build code."""
    out = probe
    for pk, bk in zip(probe_keys, build_keys):
        if not probe.type_of(pk).is_string:
            continue
        pd_ = probe.dict_of(pk)
        bd = table.batch.dict_of(bk)
        if pd_ is None or bd is None or pd_ is bd:
            continue
        remap = torch.as_tensor(pd_.map_to(bd), device=probe.device)
        c = out.column(pk)
        out = out.with_column(
            pk, probe.type_of(pk),
            Column(remap[c.values.to(torch.int64) + 1].to(c.values.dtype),
                   c.validity),
            dictionary=bd)
    return out


def build_side(batch: Batch, key_names: Sequence[str]) -> BuildTable:
    """Sort the build input by key hash; dead and NULL-key rows sink to the
    end via a sentinel hash."""
    h = join_hash(batch, key_names)
    live = _nonnull_live(batch, key_names)
    h = torch.where(live, h, _SENTINEL)
    sorted_h, sperm = torch.sort(h, stable=True)
    sorted_batch = permute_batch(batch.with_live(live), sperm)
    return BuildTable(sorted_h, sorted_batch, live.sum(), batch.live[sperm])


def _probe_ranges(table: BuildTable, probe: Batch, key_names: Sequence[str]):
    h = join_hash(probe, key_names)
    live = _nonnull_live(probe, key_names)
    h = torch.where(live, h, _SENTINEL - 1)  # never matches a real hash
    lo = torch.searchsorted(table.hashes, h, side="left")
    hi = torch.searchsorted(table.hashes, h, side="right")
    return h, lo, hi, live


def _keys_equal(table: BuildTable, build_idx, probe: Batch,
                probe_keys: Sequence[str], build_keys: Sequence[str],
                probe_idx=None):
    """Verify actual key equality at gathered build positions."""
    ok = torch.ones(build_idx.shape, dtype=torch.bool, device=build_idx.device)
    for pk, bk in zip(probe_keys, build_keys):
        pv = probe.column(pk).values
        if probe_idx is not None:
            pv = pv[probe_idx]
        bv = table.batch.column(bk).values[build_idx]
        if pv.dtype != bv.dtype:
            t = torch.promote_types(pv.dtype, bv.dtype)
            pv, bv = pv.to(t), bv.to(t)
        ok = ok & (pv == bv)
    return ok


def probe_unique(table: BuildTable, probe: Batch, probe_keys: Sequence[str],
                 build_keys: Sequence[str], collision_scan: int = 4):
    """Fast path for unique build keys: each probe row matches ≤ 1 build
    row; `collision_scan` candidates of a wider hash range are verified.
    Returns (build_idx int64[cap], matched bool[cap])."""
    _, lo, hi, live = _probe_ranges(table, probe, probe_keys)
    cap = table.hashes.shape[0]
    width = hi - lo
    idx = torch.clamp(lo, 0, cap - 1)
    matched = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    for j in range(collision_scan):
        cand = torch.clamp(lo + j, 0, cap - 1)
        ok = ((j < width) & ~matched
              & _keys_equal(table, cand, probe, probe_keys, build_keys))
        idx = torch.where(ok, cand, idx)
        matched = matched | ok
    return idx, matched & live


def probe_counts(table: BuildTable, probe: Batch, probe_keys: Sequence[str],
                 build_keys: Sequence[str], max_fanout_scan: int = 8):
    """General path, pass 1: per-probe-row candidate ranges and counts.
    Ranges wider than `max_fanout_scan`, or that verify non-contiguously
    (distinct keys sharing a hash), count the whole range; expand's key
    verification masks the non-matches. `overflow` counts the widened rows.

    Returns (lo, counts, offsets, total, live, overflow)."""
    _, lo, hi, live = _probe_ranges(table, probe, probe_keys)
    width = hi - lo
    counts = torch.zeros(width.shape, dtype=torch.int64, device=lo.device)
    cap = table.hashes.shape[0]
    for j in range(max_fanout_scan):
        idx = torch.clamp(lo + j, 0, cap - 1)
        ok = (j < width) & _keys_equal(table, idx, probe, probe_keys,
                                       build_keys)
        counts = counts + ok.to(torch.int64)
    counts = torch.where(counts == width, counts, width)
    widened = live & (width > max_fanout_scan)
    counts = torch.where(width > max_fanout_scan, width, counts)
    counts = torch.where(live, counts, 0)
    offsets = torch.cumsum(counts, 0) - counts
    return lo, counts, offsets, counts.sum(), live, widened.sum()


def _slots_to_rows(counts, offsets, chunk_base: int, out_capacity: int):
    """Output slot i → (probe_row, ordinal, in_range) by one searchsorted
    over the inclusive ends of the per-row output ranges."""
    ends = offsets + counts
    i = (torch.arange(out_capacity, dtype=torch.int64, device=counts.device)
         + chunk_base)
    pcap = counts.shape[0]
    probe_row = torch.clamp(torch.searchsorted(ends, i, side="right"),
                            0, pcap - 1)
    ordinal = i - offsets[probe_row]
    in_range = (i < ends[-1]) & (ordinal >= 0) & (ordinal < counts[probe_row])
    return probe_row, ordinal, in_range


def probe_expand(table: BuildTable, probe: Batch, probe_keys: Sequence[str],
                 build_keys: Sequence[str], lo, counts, offsets,
                 chunk_base: int, out_capacity: int):
    """General path, pass 2: materialize output slots [chunk_base,
    chunk_base + out_capacity); the build row is lo[probe_row] + ordinal,
    verified against the real keys.

    Returns (probe_idx, build_idx, out_live)."""
    probe_row, ordinal, in_range = _slots_to_rows(counts, offsets,
                                                  chunk_base, out_capacity)
    build_idx = torch.clamp(lo[probe_row] + ordinal, 0,
                            table.hashes.shape[0] - 1)
    ok = _keys_equal(table, build_idx, probe, probe_keys, build_keys,
                     probe_idx=probe_row)
    return probe_row, build_idx, in_range & ok


# ---------------------------------------------------------------------------
# hash engine


class HashJoinTable(NamedTuple):
    """Linear-probing build side: the build batch keeps input row order and
    `slot_row` maps probe-chain slots to build ROW indices (-1 = empty).
    `planes` are the pairwise-promoted encoded key planes."""

    hashes: torch.Tensor     # int64[cap_b], per-row content hash
    batch: Batch             # NULL-key rows live-killed, input order
    n_rows: torch.Tensor     # device scalar
    orig_live: torch.Tensor  # bool[cap_b]
    slot_row: torch.Tensor   # int32[tcap], tcap = 2 * pow2(cap_b)
    planes: torch.Tensor     # int64[K, cap_b]


def join_compare_dtypes(build_batch: Batch, build_keys: Sequence[str],
                        probe_dtypes: Sequence[torch.dtype]) -> tuple:
    """Pairwise-promoted compare dtype per key position, applied at encode
    time so plane equality matches the sort engine's `==`."""
    return tuple(
        torch.promote_types(build_batch.column(k).values.dtype, d)
        for k, d in zip(build_keys, probe_dtypes))


def _encode_join_planes(batch: Batch, key_names: Sequence[str],
                        compare_dtypes: Sequence[torch.dtype]):
    """Encode one side's key columns at the promoted compare dtypes.

    Returns (planes int64[K, cap], live, matchable): `live` kills NULL-key
    rows; `matchable` also excludes NaN float keys (IEEE `==` never matches
    NaN, while equal bit patterns would)."""
    planes = []
    live = _nonnull_live(batch, key_names)
    matchable = live
    for k, dt in zip(key_names, compare_dtypes):
        v = batch.column(k).values.to(dt)
        if dt.is_floating_point:
            matchable = matchable & ~torch.isnan(v)
        planes.append(hash_kernels.encode_plane(v, canonicalize_nan=False))
    return torch.stack(planes), live, matchable


def hash_build_side(batch: Batch, key_names: Sequence[str],
                    probe_dtypes: Sequence[torch.dtype]) -> HashJoinTable:
    """Build-side insert on the `join_insert` kernel; the table holds 2×
    the batch capacity (load ≤ 50%), so every live row claims a slot."""
    compare = join_compare_dtypes(batch, key_names, probe_dtypes)
    planes, live, ins_live = _encode_join_planes(batch, key_names, compare)
    h = hash_columns(list(planes))
    tcap = 2 * round_up_capacity(batch.capacity, minimum=64)
    slot_row = hash_kernels.join_insert(slot_hash(h, tcap), ins_live, tcap)
    return HashJoinTable(h, batch.with_live(live), live.sum(), batch.live,
                         slot_row, planes)


def _hash_probe(table: HashJoinTable, probe: Batch,
                probe_keys: Sequence[str], compare_dtypes, fanout: int):
    planes, live, matchable = _encode_join_planes(probe, probe_keys,
                                                  compare_dtypes)
    slot0 = slot_hash(hash_columns(list(planes)), table.slot_row.shape[0])
    mm, cnt, ovf = hash_kernels.join_probe(slot0, planes, matchable,
                                           table.slot_row, table.planes,
                                           fanout)
    return mm, cnt, ovf, live


def hash_probe_unique(table: HashJoinTable, probe: Batch,
                      probe_keys: Sequence[str], compare_dtypes):
    """Unique-build fast path: first (only) match per probe row.
    Returns (build_idx, matched) like probe_unique."""
    mm, cnt, _ovf, _live = _hash_probe(table, probe, probe_keys,
                                       compare_dtypes, 1)
    idx = torch.clamp(mm[:, 0].to(torch.int64), 0, table.batch.capacity - 1)
    return idx, cnt > 0


def hash_probe_counts(table: HashJoinTable, probe: Batch,
                      probe_keys: Sequence[str], compare_dtypes,
                      max_fanout_scan: int = 8):
    """General path, pass 1. Counts are EXACT (the kernel counts past the
    match-matrix width); overflow = rows with more matches than the matrix
    holds, and the caller re-probes with the fanout doubled.

    Returns (mm int32[n, F], counts, offsets, total, live, overflow)."""
    mm, cnt, ovf, live = _hash_probe(table, probe, probe_keys,
                                     compare_dtypes, max_fanout_scan)
    counts = cnt.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    return mm, counts, offsets, counts.sum(), live, ovf.to(torch.int64)


def hash_probe_expand(table: HashJoinTable, mm, counts, offsets,
                      chunk_base: int, out_capacity: int):
    """General path, pass 2: the build row of output slot i is
    mm[probe_row, ordinal]. Precondition: counts ≤ F everywhere (the
    caller widened the probe on overflow).

    Returns (probe_idx, build_idx, out_live)."""
    probe_row, ordinal, in_range = _slots_to_rows(counts, offsets,
                                                  chunk_base, out_capacity)
    oc = torch.clamp(ordinal, 0, mm.shape[1] - 1)
    build_idx = mm[probe_row, oc].to(torch.int64)
    out_live = in_range & (build_idx >= 0)
    build_idx = torch.clamp(build_idx, 0, table.batch.capacity - 1)
    return probe_row, build_idx, out_live


# ---------------------------------------------------------------------------
# multiway (N-ary) probe: one probe batch walked through all N builds in a
# single pass, with no intermediate batch between legs (PAPERS.md
# 1905.13376). An output row is a probe row times one (match | left-null)
# per leg, decomposed mixed-radix over the per-leg match counts.


class MwSpec(NamedTuple):
    """One leg of a multiway probe. `sources[k]` locates probe-side key k:
    -1 = the probe batch itself, j >= 0 = the payload of earlier UNIQUE
    build j, gathered at that leg's matched row (snowflake chains).
    Non-unique legs probe through the `join_probe` kernel (`hash_engine`,
    exact counts) or the sort engine (counts may widen; inner kinds only,
    expand re-verifies keys)."""

    probe_keys: tuple
    build_keys: tuple
    sources: tuple
    kind: str                # inner | left
    unique: bool             # single-match sort-engine probe
    hash_engine: bool        # fanout leg probes through join_probe
    compare_dtypes: tuple    # hash-engine encode dtypes (else ())


def _mw_key_batch(probe: Batch, tables, spec: MwSpec, idxs, matcheds):
    """Key batch for one leg: key columns from the probe batch and/or
    earlier unique legs' payloads, with rows unmatched in the source leg
    made NULL (a NULL key never matches, the binary chain's semantics)."""
    names, types, cols, dicts = [], [], [], {}
    for sym, src in zip(spec.probe_keys, spec.sources):
        if src < 0:
            c = probe.column(sym)
            t = probe.type_of(sym)
            d = probe.dicts.get(sym)
        else:
            tb = tables[src].batch
            c = tb.column(sym).gather(idxs[src])
            v = matcheds[src] if c.validity is None else \
                (c.validity & matcheds[src])
            c = Column(c.values, v, c.hi, c.sizes, c.evalid, c.keys)
            t = tb.type_of(sym)
            d = tb.dicts.get(sym)
        names.append(sym)
        types.append(t)
        cols.append(c)
        if d is not None:
            dicts[sym] = d
    return Batch(names, types, cols, probe.live, dicts)


def _mw_unique_state(specs, state):
    """(idxs, matcheds) of the unique legs: key sources for later
    snowflake legs."""
    idxs, matcheds = {}, {}
    for i, spec in enumerate(specs):
        if spec.unique:
            idxs[i], matcheds[i] = state[i]
    return idxs, matcheds


def multiway_counts(tables, probe: Batch, specs, fanouts):
    """Pass 1 of the N-ary probe: per-leg match state, per-leg effective
    counts (a left leg floors at 1, its null-extension row), the combined
    per-probe-row product T and its exclusive prefix sum. ``ovfs[i]`` > 0
    means hash leg i truncated its match matrix: the caller doubles that
    leg's fanout and runs the pass again.

    Returns (state, chats, offsets, T, total, ovfs)."""
    state, chats, ovfs = [], [], []
    idxs, matcheds = {}, {}
    dev = probe.device
    for i, spec in enumerate(specs):
        kb = _mw_key_batch(probe, tables, spec, idxs, matcheds)
        kb = align_probe_strings(kb, spec.probe_keys, tables[i],
                                 spec.build_keys)
        if spec.unique:
            idx, matched = probe_unique(tables[i], kb, spec.probe_keys,
                                        spec.build_keys)
            idxs[i], matcheds[i] = idx, matched
            c = matched.to(torch.int64)
            state.append((idx, matched))
            ovfs.append(torch.zeros((), dtype=torch.int64, device=dev))
        elif spec.hash_engine:
            mm, c, _off, _tot, _live, ovf = hash_probe_counts(
                tables[i], kb, spec.probe_keys, spec.compare_dtypes,
                fanouts[i])
            state.append((mm, c))
            ovfs.append(ovf.reshape(()))
        else:
            lo, c, _off, _tot, _live, _ovf = probe_counts(
                tables[i], kb, spec.probe_keys, spec.build_keys,
                fanouts[i])
            state.append((lo, c))
            ovfs.append(torch.zeros((), dtype=torch.int64, device=dev))
        chats.append(torch.clamp(c, min=1) if spec.kind == "left" else c)
    T = probe.live.to(torch.int64)
    for chat in chats:
        T = T * chat
    offsets = torch.cumsum(T, 0) - T
    return (tuple(state), tuple(chats), offsets, T, T.sum(),
            torch.stack(ovfs))


def multiway_expand(tables, probe: Batch, specs, state, chats, offsets,
                    T, chunk_base: int, out_capacity: int, probe_cols,
                    build_cols):
    """Pass 2: materialize output slots [chunk_base, chunk_base +
    out_capacity). One searchsorted over the inclusive ends of T maps a
    slot to its probe row; the rest of the ordinal decomposes mixed-radix
    across legs (last leg fastest). A left leg emits its null-extension at
    digit 0 when unmatched. ``build_cols[i]`` are leg i's payload
    symbols."""
    n = len(specs)
    probe_row, r, in_range = _slots_to_rows(T, offsets, chunk_base,
                                            out_capacity)
    digits = [None] * n
    for t in range(n - 1, -1, -1):
        c = torch.clamp(chats[t][probe_row], min=1)
        digits[t] = r % c
        r = r // c
    idxs, matcheds = _mw_unique_state(specs, state)
    out_live = in_range
    bidx, bvalid = [], []
    for t, spec in enumerate(specs):
        d = digits[t]
        if spec.unique:
            idx, matched = state[t]
            bi = idx[probe_row]
            ok = matched[probe_row]
        elif spec.hash_engine:
            mm, c = state[t]
            oc = torch.clamp(d, 0, mm.shape[1] - 1)
            bi = mm[probe_row, oc].to(torch.int64)
            ok = (d < c[probe_row]) & (bi >= 0)
            bi = torch.clamp(bi, 0, tables[t].batch.capacity - 1)
        else:
            lo, c = state[t]
            bi = torch.clamp(lo[probe_row] + d, 0,
                             tables[t].hashes.shape[0] - 1)
            ok = d < c[probe_row]
            # re-verify the real keys in the leg's aligned code space
            # (hash collisions and widened counts)
            kb = align_probe_strings(
                _mw_key_batch(probe, tables, spec, idxs, matcheds),
                spec.probe_keys, tables[t], spec.build_keys)
            ok = ok & _keys_equal(tables[t], bi, kb, spec.probe_keys,
                                  spec.build_keys, probe_idx=probe_row)
        if spec.kind == "inner":
            out_live = out_live & ok
        bidx.append(bi)
        bvalid.append(ok)
    return _mw_output(probe, tables, probe_row, bidx, bvalid, out_live,
                      probe_cols, build_cols)


def _mw_output(probe: Batch, tables, probe_row, bidx, bvalid, out_live,
               probe_cols, build_cols) -> Batch:
    """The probe columns gathered at `probe_row` (None: as they are) and
    each leg's payload at its build rows, NULL where the leg did not
    match."""
    names, types, cols, dicts = [], [], [], {}
    for sym in probe_cols:
        names.append(sym)
        types.append(probe.type_of(sym))
        c = probe.column(sym)
        cols.append(c if probe_row is None else c.gather(probe_row))
        carry_dicts(probe.dicts, dicts, sym)
    for t, table in enumerate(tables):
        tb = table.batch
        for sym in build_cols[t]:
            names.append(sym)
            types.append(tb.type_of(sym))
            c = tb.column(sym).gather(bidx[t])
            v = bvalid[t] if c.validity is None else \
                (c.validity & bvalid[t])
            cols.append(Column(c.values, v, c.hi, c.sizes, c.evalid,
                               c.keys))
            carry_dicts(tb.dicts, dicts, sym)
    return Batch(names, types, cols, out_live, dicts)


def multiway_probe_unique(tables, probe: Batch, specs, probe_cols,
                          build_cols) -> Batch:
    """All-unique path, the dominant star shape: every leg matches at
    most one build row, so the output is row-aligned with the probe batch
    (probe columns pass through, each leg costs one probe and one payload
    gather)."""
    out_live = probe.live
    idxs, matcheds = {}, {}
    for i, spec in enumerate(specs):
        kb = _mw_key_batch(probe, tables, spec, idxs, matcheds)
        kb = align_probe_strings(kb, spec.probe_keys, tables[i],
                                 spec.build_keys)
        idx, matched = probe_unique(tables[i], kb, spec.probe_keys,
                                    spec.build_keys)
        idxs[i], matcheds[i] = idx, matched
        if spec.kind == "inner":
            out_live = out_live & matched
    n = len(specs)
    return _mw_output(probe, tables, None, [idxs[t] for t in range(n)],
                      [matcheds[t] for t in range(n)], out_live,
                      probe_cols, build_cols)


def gather_join_output(probe: Batch, table, probe_row, build_idx, out_live,
                       probe_cols: Sequence[str], build_cols: Sequence[str],
                       build_prefix: str = "") -> Batch:
    """Materialize an inner-join output batch from index vectors."""
    names, types, cols = [], [], []
    dicts = {}
    for c in probe_cols:
        names.append(c)
        types.append(probe.type_of(c))
        cols.append(probe.column(c).gather(probe_row))
        carry_dicts(probe.dicts, dicts, c)
    for c in build_cols:
        out_name = build_prefix + c
        names.append(out_name)
        types.append(table.batch.type_of(c))
        cols.append(table.batch.column(c).gather(build_idx))
        carry_dicts(table.batch.dicts, dicts, c, out_name)
    return Batch(names, types, cols, out_live, dicts)
