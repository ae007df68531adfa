"""Each kernel's plain version (the CPU path of its wrapper) against the
JAX package's Pallas kernel in interpret mode: every output must be equal
(tolerance: none — integer sums mod 2^64, slot ids, counts, overflow).

The plain hash-table versions mirror the serial TPU kernels step for step,
so even slot assignment and match order agree. Interpret mode is serial,
so inputs stay at n ≤ 4096.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.ops import pallas_groupby as ref_pg
from presto_tpu.ops import pallas_hash as ref_ph
from presto_tpu.ops.hashing import hash_columns as ref_hash
from presto_tpu_torch.kernels import launch_counts
from presto_tpu_torch.ops import groupby_kernels as gk
from presto_tpu_torch.ops import hash_kernels as hk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _slot0(planes, tcap):
    h = np.asarray(ref_hash([jnp.asarray(p) for p in planes]))
    return (h & (tcap - 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# grouped_sums


@pytest.mark.parametrize("n,g", [(2048, 512)])
def test_grouped_sums_exact(n, g):
    rng = np.random.default_rng(n + g)
    gid = rng.integers(0, g + 1, n).astype(np.int32)  # g marks dead rows
    states = [
        rng.integers(-(1 << 44), 1 << 44, n),
        rng.integers(-5, 6, n),
        rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True),
        np.full(n, 2**63 - 1, np.int64),  # wraps mod 2^64
        np.full(n, -2**63, np.int64),
    ]
    ref = ref_pg.grouped_sums(jnp.asarray(gid),
                              [jnp.asarray(s) for s in states], g,
                              interpret=True)
    before = launch_counts()["grouped_sums"]
    got = gk.grouped_sums(_t(gid), [_t(s) for s in states], g)
    assert launch_counts()["grouped_sums"] == before  # CPU: no launch
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int64
        _eq(a, b)


def test_grouped_sums_ignores_dead_rows():
    rng = np.random.default_rng(5)
    n, g = 500, 4
    gid = rng.integers(0, g + 1, n).astype(np.int32)
    vals = rng.integers(0, 1000, n)
    got = gk.grouped_sums(_t(gid), [_t(vals)], g)[0].numpy()
    exp = np.array([vals[gid == i].sum() for i in range(g)])
    _eq(got, exp)


def _mixed_states(rng, n, count):
    """`count` states cycling through the kernel's element kinds, every
    third one with a bool mask; returns (torch states, numpy int64 values
    as the JAX side sees them)."""
    kinds = [(np.bool_, 0, 2), (np.int32, -2**31, 2**31 - 1),
             (np.int64, -2**63, 2**63 - 1), (np.int8, -128, 127),
             (np.int16, -2**15, 2**15 - 1), (np.uint8, 0, 255)]
    states, ref = [], []
    for j in range(count):
        dt, lo, hi = kinds[j % len(kinds)]
        v = rng.integers(lo, hi, n, dtype=np.int64, endpoint=dt != np.bool_)
        v = v.astype(dt)
        wide = v.astype(np.int64)
        if j % 3 == 2:
            m = rng.random(n) < 0.7
            states.append((_t(v), _t(m)))
            wide = np.where(m, wide, 0)
        else:
            states.append(_t(v))
        ref.append(wide)
    return states, ref


# (rows, groups, states, every row dead): G on both sides of the histogram
# path's 16, more states than one launch's 64, all dead, no rows
@pytest.mark.parametrize("n,g,count,dead", [
    (1000, 6, 12, False), (777, 16, 9, False), (600, 40, 12, False),
    (300, 20, 70, False), (256, 6, 6, True), (0, 6, 6, False)])
def test_grouped_sums_widths_masks_and_edges(n, g, count, dead):
    rng = np.random.default_rng(n + 7 * g + count)
    gid = (np.full(n, g, np.int32) if dead
           else rng.integers(-1, g + 2, n).astype(np.int32))
    states, wide = _mixed_states(rng, n, count)
    got = gk.grouped_sums(_t(gid), states, g)
    assert len(got) == count and all(a.dtype == torch.int64 for a in got)
    if n == 0 or dead:
        for a in got:
            _eq(a, np.zeros(g, np.int64))
        return
    ref = ref_pg.grouped_sums(jnp.asarray(gid), [jnp.asarray(w) for w in wide],
                              g, interpret=True)
    for a, b in zip(got, ref):
        _eq(a, b)


@pytest.mark.parametrize("widths,g,want", [
    # Q1's direct path: 16 int64 states and 13 bool ones, 6 groups
    ([1] + [8, 1] * 12 + [8] * 4, 6,
     [(tuple(i for i in range(29) if i not in range(0, 26, 2)) + tuple(
         range(0, 26, 2)), "histogram", 8, 0)]),
    ([4, 1, 8], 1, [((2, 0, 1), "histogram", 2, 0)]),
    ([8, 8], 16, [((0, 1), "histogram", 16, 0)]),
    ([8] * 3, 17, [((0, 1, 2), "shared", 0, 3)]),
    ([2] * 70, 512, [(tuple(range(64)), "shared", 0, 56),
                     (tuple(range(64, 70)), "shared", 0, 6)]),
    ([1, 8] * 35, 6, [(tuple(range(1, 70, 2)) + tuple(range(0, 58, 2)),
                       "histogram", 8, 0),
                      (tuple(range(58, 70, 2)), "histogram", 8, 0)]),
])
def test_grouped_sums_launch_plan(widths, g, want):
    assert [tuple(p) for p in gk.launch_plan(tuple(widths), g)] == want


def test_grouped_sums_launch_plan_rejects_too_many_groups():
    with pytest.raises(ValueError):
        gk.launch_plan((8,), gk.MAX_GROUPS + 1)


# ---------------------------------------------------------------------------
# group_insert


def _group_insert_both(planes, slot0, live, cap):
    ref = ref_ph.group_insert(jnp.asarray(planes), jnp.asarray(slot0),
                              jnp.asarray(live), cap, interpret=True)
    got = hk.group_insert(_t(planes), _t(slot0), _t(live), cap)
    for a, b in zip(got, ref):
        _eq(a, b)
    return got


@pytest.mark.parametrize("cap", [4, 256])
def test_group_insert_across_capacities(cap):
    rng = np.random.default_rng(cap)
    n = 4 * cap
    planes = rng.integers(0, cap, (1, n)).astype(np.int64)
    live = rng.random(n) > 0.1
    _, _, _, ng, ovf = _group_insert_both(planes, _slot0(planes, 2 * cap),
                                          live, cap)
    assert int(ng) == len(set(planes[0][live])) and int(ovf) == 0


def test_group_insert_collision_heavy_single_slot():
    keys = np.stack([np.arange(24) % 12, np.arange(24) % 3]).astype(np.int64)
    live = np.ones(24, bool)
    _, _, _, ng, ovf = _group_insert_both(keys, np.zeros(24, np.int32),
                                          live, 32)
    assert int(ng) == 12 and int(ovf) == 0


def test_group_insert_overflow():
    rng = np.random.default_rng(11)
    n, cap = 1024, 64
    planes = np.stack([rng.integers(0, 300, n),
                       rng.integers(-2**62, 2**62, n)]).astype(np.int64)
    planes[1] = planes[0] * 7  # 300 distinct keys across both planes
    live = rng.random(n) > 0.05
    _, _, _, ng, ovf = _group_insert_both(planes, _slot0(planes, 2 * cap),
                                          live, cap)
    assert int(ng) == cap and int(ovf) > 0


def test_group_insert_rejects_non_pow2_cap():
    with pytest.raises(ValueError):
        hk.group_insert(torch.zeros(1, 4, dtype=torch.int64),
                        torch.zeros(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool), 48)


# ---------------------------------------------------------------------------
# join_insert / join_probe


def _join_both(bkeys, blive, pkeys, plive, fanout, bslot=None, pslot=None):
    tcap = 2 * max(64, 1 << (len(blive) - 1).bit_length())
    bslot = _slot0(bkeys, tcap) if bslot is None else bslot
    pslot = _slot0(pkeys, tcap) if pslot is None else pslot
    ref_sr = ref_ph.join_insert(jnp.asarray(bslot), jnp.asarray(blive), tcap,
                                interpret=True)
    sr = hk.join_insert(_t(bslot), _t(blive), tcap)
    _eq(sr, ref_sr)
    ref = ref_ph.join_probe(jnp.asarray(pslot), jnp.asarray(pkeys),
                            jnp.asarray(plive), ref_sr, jnp.asarray(bkeys),
                            fanout, interpret=True)
    got = hk.join_probe(_t(pslot), _t(pkeys), _t(plive), sr, _t(bkeys), fanout)
    for a, b in zip(got, ref):
        _eq(a, b)
    return got


@pytest.mark.parametrize("fanout", [1, 8])
def test_join_duplicates(fanout):
    rng = np.random.default_rng(fanout)
    bkeys = rng.integers(0, 300, (1, 1500)).astype(np.int64)
    blive = rng.random(1500) < 0.9
    pkeys = rng.integers(0, 350, (1, 2048)).astype(np.int64)
    plive = rng.random(2048) < 0.9
    mm, cnt, ovf = _join_both(bkeys, blive, pkeys, plive, fanout)
    exp = np.array([int(((bkeys[0] == k) & blive).sum()) if lv else 0
                    for k, lv in zip(pkeys[0], plive)])
    _eq(cnt, exp)
    assert int(ovf) == int((exp > fanout).sum())


# (fanout, no live build row — an empty table, every probe row dead)
@pytest.mark.parametrize("fanout,empty,dead", [
    (1, False, False), (8, False, False), (16, False, False),
    (8, True, False), (8, False, True)])
def test_join_probe_fanouts_and_edges(fanout, empty, dead):
    rng = np.random.default_rng(fanout + 2 * empty + dead)
    nb = 1200
    bkeys = rng.integers(0, 60, (1, nb)).astype(np.int64)
    blive = np.zeros(nb, bool) if empty else rng.random(nb) < 0.9
    np_ = 1024
    pkeys = rng.integers(0, 70, (1, np_)).astype(np.int64)
    plive = np.zeros(np_, bool) if dead else rng.random(np_) < 0.9
    mm, cnt, ovf = _join_both(bkeys, blive, pkeys, plive, fanout)
    mm, cnt = np.asarray(mm), np.asarray(cnt)
    exp = np.array([int(((bkeys[0] == k) & blive).sum()) if lv else 0
                    for k, lv in zip(pkeys[0], plive)], dtype=np.int64)
    _eq(cnt, exp)
    assert int(ovf) == int((exp > fanout).sum())
    past = np.arange(fanout)[None, :] >= np.minimum(cnt, fanout)[:, None]
    assert (mm[past] == -1).all() and (mm[~past] >= 0).all()


def test_join_collision_heavy_two_keys():
    rng = np.random.default_rng(21)
    bkeys = rng.integers(0, 20, (2, 300)).astype(np.int64)
    pkeys = rng.integers(0, 20, (2, 400)).astype(np.int64)
    _join_both(bkeys, np.ones(300, bool), pkeys, rng.random(400) < 0.8, 2,
               bslot=np.full(300, 5, np.int32),
               pslot=np.full(400, 5, np.int32))


def test_join_probe_rejects_non_pow2_fanout():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        hk.join_probe(z, torch.zeros(1, 4, dtype=torch.int64),
                      torch.ones(4, dtype=torch.bool), torch.full((8,), -1),
                      torch.zeros(1, 4, dtype=torch.int64), 3)


# ---------------------------------------------------------------------------
# key-plane encoders


def test_encode_planes_match_reference():
    f = np.array([0.0, -0.0, 1.5, np.nan, -np.nan, np.inf, -2.25])
    for canon in (True, False):
        ref = ref_ph.encode_plane(jnp.asarray(f), canonicalize_nan=canon)
        _eq(hk.encode_plane(_t(f), canonicalize_nan=canon), ref)
    f32 = f.astype(np.float32)
    _eq(hk.encode_plane(_t(f32)), ref_ph.encode_plane(jnp.asarray(f32)))
    rt = hk.decode_plane(hk.encode_plane(_t(f32)), torch.float32).numpy()
    np.testing.assert_array_equal(rt[~np.isnan(f32)], f32[~np.isnan(f32)])
    ints = np.array([3, -4, 2**40], np.int64)
    valid = np.array([True, False, True])
    b = np.array([True, False, True])
    ref_planes, ref_nulls = ref_ph.encode_group_keys(
        [(jnp.asarray(ints), jnp.asarray(valid)), (jnp.asarray(b), None)])
    planes, nulls = hk.encode_group_keys(
        [(_t(ints), _t(valid)), (_t(b), None)])
    assert nulls == ref_nulls
    _eq(planes, ref_planes)
