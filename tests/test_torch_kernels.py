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
