"""The port's key hashing against the JAX package's, bit for bit.

hash_columns and slot_hash decide slot0 of every hash table and every
partition id, so the port must reproduce them exactly (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.ops.hashing import hash_columns as ref_hash_columns
from presto_tpu.ops.radix import slot_hash as ref_slot_hash
from presto_tpu_torch.ops.hashing import hash_columns, slot_hash, splitmix64

_EDGE = np.array([0, 1, -1, 2, -2, 2**31 - 1, -2**31, 2**62, -2**62,
                  2**63 - 1, -2**63, 2**63 - 2, -2**63 + 1], np.int64)


def _keys(seed, n=2000):
    rng = np.random.default_rng(seed)
    small = rng.integers(-50, 50, n).astype(np.int64)
    wide = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    wide[: len(_EDGE)] = _EDGE
    return small, wide


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_columns_bit_identical(seed):
    small, wide = _keys(seed)
    for cols in ([small], [wide], [wide, small], [small, wide, small]):
        ref = np.asarray(ref_hash_columns([jnp.asarray(c) for c in cols]))
        got = hash_columns([torch.from_numpy(c) for c in cols]).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got >= 0).all()


def test_hash_columns_nulls_bit_identical():
    small, wide = _keys(2)
    rng = np.random.default_rng(3)
    v0 = rng.random(len(small)) < 0.7
    v1 = rng.random(len(small)) < 0.5
    ref = np.asarray(ref_hash_columns(
        [jnp.asarray(wide), jnp.asarray(small)],
        [jnp.asarray(v0), jnp.asarray(v1)]))
    got = hash_columns([torch.from_numpy(wide), torch.from_numpy(small)],
                       [torch.from_numpy(v0), torch.from_numpy(v1)]).numpy()
    np.testing.assert_array_equal(got, ref)
    # a NULL key hashes apart from the key value 0
    z = torch.zeros(4, dtype=torch.int64)
    nul = torch.tensor([True, False, True, False])
    h = hash_columns([z], [nul])
    assert h[0] == h[2] and h[1] == h[3] and h[0] != h[1]


@pytest.mark.parametrize("tcap", [2, 64, 1 << 17])
def test_slot_hash_bit_identical(tcap):
    _, wide = _keys(4)
    h = ref_hash_columns([jnp.asarray(wide)])
    ref = np.asarray(ref_slot_hash(h, tcap))
    got = slot_hash(torch.from_numpy(np.array(h)), tcap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_splitmix64_matches_uint64_arithmetic():
    _, wide = _keys(5, 200)
    u = wide.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (u ^ (u >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    got = splitmix64(torch.from_numpy(wide)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, x)


def test_slot_hash_rejects_non_pow2():
    with pytest.raises(ValueError):
        slot_hash(torch.zeros(4, dtype=torch.int64), 48)
