"""The port's memory pool, page format, spill files, host partition hashes
and radix ids against the JAX package's (memory.py, serde.py, spiller.py,
ops/partition.py, ops/radix.py there), on the CPU.

- The pool: the same reserve/free/revoke sequences give the same info()
  and the same revoker calls; the limit raises ExceededMemoryLimit.
- Pages: serialize_batch(compress=False) gives the JAX package's bytes for
  the same batch (carried across with presto_tpu_torch.convert): NULLs,
  dictionaries, long decimals, an ARRAY and a MAP column, the radix stamp;
  each reads back to the batch, in either package.
- Spill files: round trips, crc32 and framing failures raise
  SpillCorruption, names never collide; rows land in the same partitions,
  and grow and align the same, as the JAX package's spiller.
- Hashes: np_row_hash and np_bucket_ids (with a divisor), partition_hash,
  radix_ids and radix_child_ids are bit-equal; radix_bits refuses a
  non-power of two; a radix split partitions exactly.
Everything is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from presto_tpu import memory as ref_memory
from presto_tpu import serde as ref_serde
from presto_tpu import spiller as ref_spiller
from presto_tpu.batch import Batch as RefBatch
from presto_tpu.batch import Column as RefColumn
from presto_tpu.dictionary import Dictionary as RefDictionary
from presto_tpu.ops import radix as ref_radix
from presto_tpu.ops.partition import partition_hash as ref_partition_hash
from presto_tpu.types import parse_type as ref_parse_type
from presto_tpu_torch import convert, memory, serde, spiller
from presto_tpu_torch.ops import radix
from presto_tpu_torch.ops.partition import partition_hash

from test_torch_tpch import one_torch_thread  # noqa: F401 — autouse


# -- the pool ---------------------------------------------------------------

# (op, context index, bytes): "set" = LocalMemoryContext.set_bytes, "close",
# "revoke" = request_revoke
POOL_SEQUENCES = {
    "reserve_free_peak": (1000, 0.9, 0.5,
                          [("set", 0, 400), ("set", 0, 100), ("set", 1, 300),
                           ("close", 0, 0), ("set", 1, 50)]),
    "limit": (1000, 0.9, 0.5, [("set", 0, 600), ("set", 1, 500),
                               ("set", 1, 1500)]),
    "revocation": (1000, 0.8, 0.3, [("set", 0, 700), ("set", 1, 200)]),
    "request_revoke": (None, 0.9, 0.5, [("set", 0, 64), ("revoke", 0, 10),
                                        ("set", 1, 1 << 40)]),
}


def _drive_pool(mod, limit, threshold, target, seq):
    """Run `seq` on a pool of module `mod` whose first context is
    revocable (its revoker frees it whole). Returns the observable trail."""
    pool = mod.MemoryPool(limit, revoke_threshold=threshold,
                          revoke_target=target)
    agg = mod.AggregatedMemoryContext(pool, "task")
    ctxs = [agg.new_local("victim"), agg.new_local("other")]
    calls = []

    def revoker(need):
        calls.append(need)
        freed = ctxs[0].bytes
        ctxs[0].set_bytes(0)
        return freed

    pool.add_revoker(revoker)
    trail = []
    for op, i, n in seq:
        try:
            if op == "set":
                ctxs[i].set_bytes(n)
            elif op == "close":
                ctxs[i].close()
            else:
                trail.append(("signaled", pool.request_revoke(n)))
        except mod.ExceededMemoryLimit:
            trail.append("exceeded")
        trail.append((pool.info(), agg.bytes, list(calls)))
    agg.close()
    trail.append(pool.info())
    return trail


@pytest.mark.parametrize("name", list(POOL_SEQUENCES))
def test_pool_sequences_match_reference(name):
    limit, threshold, target, seq = POOL_SEQUENCES[name]
    got = _drive_pool(memory, limit, threshold, target, seq)
    assert got == _drive_pool(ref_memory, limit, threshold, target, seq)
    if name == "limit":
        assert "exceeded" in got
    if name == "revocation":
        assert got[-2][2], "revoker not invoked"


def test_query_scoped_pool_and_partial_revoker():
    pool = memory.MemoryPool(1000)
    q = memory.QueryScopedPool(pool, "q1")
    q.reserve(300)
    q.free(100)
    assert (pool.reserved, q.query_reserved, q.peak) == (200, 200, 300)
    marked = []
    owner = type("Owner", (), {
        "partition_sizes": lambda self: [(0, 10), (1, 50), (2, 30)],
        "revoke_partition": lambda self, p: marked.append(p) or 40})()
    fn = q.add_partial_revoker(owner)
    assert q.request_partial_revoke(60) == 2 and marked == [1, 2]
    q.remove_revoker(fn)
    assert pool.request_partial_revoke(1) == 0


def test_batch_device_bytes_match_reference():
    vals = np.arange(300, dtype=np.int64)
    live = np.ones(512, bool)
    pb = convert.batch_from_arrays(
        ["a", "b"], ["bigint", "double"],
        [np.resize(vals, 512), np.zeros(512)], [None, live], [None, None],
        live, {}, "cpu")
    rb = RefBatch(["a", "b"], [ref_parse_type("bigint"),
                               ref_parse_type("double")],
                  [RefColumn(jnp.asarray(np.resize(vals, 512))),
                   RefColumn(jnp.zeros(512), jnp.asarray(live))],
                  jnp.asarray(live), {})
    assert (memory.batch_device_bytes(pb)
            == ref_memory.batch_device_bytes(rb) == 512 * (1 + 8 + 8 + 1))


# -- pages ------------------------------------------------------------------


def _page_batches(seed: int = 5, cap: int = 256, n: int = 200):
    """(port batch, JAX package batch) with the same planes: ints with
    NULLs, doubles, a varchar dictionary, a long decimal, an ARRAY(double)
    with NULL elements and a MAP(varchar, bigint); some rows dead."""
    rng = np.random.default_rng(seed)
    live = np.zeros(cap, bool)
    live[:n] = rng.random(n) < 0.9
    w = 4
    names = ["i", "d", "s", "dec", "arr", "m"]
    types = ["bigint", "double", "varchar", "decimal(38,2)", "array(double)",
             "map(varchar,bigint)"]
    svals = np.array(sorted({f"s{v}" for v in range(12)}), dtype=object)
    kvals = np.array(["a", "b", "c"], dtype=object)
    sizes = rng.integers(0, w + 1, cap).astype(np.int32)
    planes = {
        "values": [rng.integers(-50, 50, cap).astype(np.int64),
                   rng.normal(size=cap),
                   rng.integers(0, len(svals), cap).astype(np.int32),
                   rng.integers(0, 1 << 32, cap).astype(np.int64),
                   rng.normal(size=(cap, w)),
                   rng.integers(0, 9, (cap, w)).astype(np.int64)],
        "validity": [rng.random(cap) < 0.8, None, rng.random(cap) < 0.9,
                     None, rng.random(cap) < 0.95, None],
        "hi": [None, None, None, rng.integers(-4, 4, cap).astype(np.int64),
               None, None],
        "struct": [None, None, None, None,
                   (sizes, rng.random((cap, w)) < 0.9, None),
                   (sizes, None,
                    rng.integers(0, len(kvals), (cap, w)).astype(np.int32))],
    }
    dicts = {"s": svals, "m#keys": kvals}
    pb = convert.batch_from_arrays(names, types, planes["values"],
                                   planes["validity"], planes["hi"], live,
                                   dicts, "cpu", planes["struct"])

    def j(a):
        return None if a is None else jnp.asarray(a)

    cols = []
    for v, va, h, st in zip(planes["values"], planes["validity"],
                            planes["hi"], planes["struct"]):
        st = st or (None, None, None)
        cols.append(RefColumn(j(v), j(va), j(h), *(j(p) for p in st)))
    rb = RefBatch(names, [ref_parse_type(t) for t in types], cols,
                  jnp.asarray(live),
                  {k: RefDictionary(v) for k, v in dicts.items()})
    return pb, rb


@pytest.mark.parametrize("radix_stamp", [None, (3, 8, ("i", "s"))],
                         ids=["plain", "radix_stamp"])
def test_page_bytes_match_reference(radix_stamp):
    pb, rb = _page_batches()
    page = serde.serialize_batch(pb, compress=False, radix=radix_stamp)
    assert page == ref_serde.serialize_batch(rb, compress=False,
                                             radix=radix_stamp)
    back = serde.deserialize_batch(page)
    assert isinstance(back, serde.TaggedBatch) == (radix_stamp is not None)
    if radix_stamp is not None:
        assert back.radix == radix_stamp
    live = pb.live.numpy()
    want = pb.with_live(pb.live).to_pydict()
    got = back.to_pydict()
    for name in pb.names:
        assert [repr(v) for v in got[name]] == [repr(v) for v in want[name]]
        assert len(got[name]) == live.sum()
    # the JAX package reads the port's page, and the port its compressed one
    ref_back = ref_serde.deserialize_batch(page).to_pydict()
    assert [repr(v) for v in ref_back["s"]] == [repr(v) for v in got["s"]]
    zpage = ref_serde.serialize_batch(rb)
    assert serde.deserialize_batch(zpage).to_pydict()["dec"].tolist() == \
        got["dec"].tolist()


def test_page_dictionaries_are_interned():
    pb, _ = _page_batches(seed=9)
    a = serde.deserialize_batch(serde.serialize_batch(pb))
    b = serde.deserialize_batch(serde.serialize_batch(pb))
    assert a.dicts["s"] is b.dicts["s"]
    assert list(a.dicts["s"].values) == list(pb.dicts["s"].values)
    with pytest.raises(ValueError, match="magic"):
        serde.deserialize_batch(b"XXXX" + serde.serialize_batch(pb)[4:])


# -- spill files ------------------------------------------------------------


def _kv_batch(rng, n=500):
    return convert.batch_from_arrays(
        ["k", "v"], ["bigint", "double"],
        [rng.integers(0, 50, n), rng.normal(size=n)], [None, None],
        [None, None], np.ones(n, bool), {}, "cpu")


def test_spill_file_roundtrip_and_partitions(tmp_path):
    rng = np.random.default_rng(11)
    sm = spiller.SpillManager(str(tmp_path))
    sp = sm.partitioning_spiller(["k"], 4, "t")
    b = _kv_batch(rng, 1000)
    sp.spill(b)
    sp.spill(b)
    back_k, back_v, seen = [], [], 0
    for p in range(4):
        batches = list(sp.read_partition(p))
        seen += bool(batches)
        for rb in batches:
            d = rb.to_pydict()
            back_k.extend(d["k"])
            back_v.extend(d["v"])
    assert seen > 1
    k, v = b.to_pydict()["k"], b.to_pydict()["v"]
    assert sorted(back_k) == sorted(list(k) * 2)
    assert sorted(back_v) == sorted(list(v) * 2)
    assert sm.in_use_bytes == sp.spilled_bytes > 0
    sp.close()
    assert sm.in_use_bytes == 0 and os.listdir(tmp_path) == []


def test_spill_file_names_never_collide(tmp_path):
    sm = spiller.SpillManager(str(tmp_path))
    a = sm.partitioning_spiller(["k"], 4, "t")
    paths_a = {f.path for f in a.files}
    a.close()
    b = sm.partitioning_spiller(["k"], 4, "t")
    paths_b = {f.path for f in b.files}
    b.close()
    assert len(paths_a) == len(paths_b) == 4 and not paths_a & paths_b
    f1, f2 = sm.spill_file("x"), sm.spill_file("x")
    assert f1.path != f2.path
    f1.close()
    f2.close()


def _one_spill_file(tmp_path):
    rng = np.random.default_rng(3)
    f = spiller.SpillManager(str(tmp_path)).spill_file("crc")
    b = _kv_batch(rng)
    f.append(b)
    f.append(b)
    f.finish_writing()
    return f


@pytest.mark.parametrize("damage, match", [("flip", "crc32 mismatch"),
                                           ("truncate", "truncated")])
def test_spill_corruption_detected(tmp_path, damage, match):
    f = _one_spill_file(tmp_path)
    with open(f.path, "r+b") as fh:
        if damage == "flip":
            fh.seek(40)  # inside the first page's payload
            byte = fh.read(1)
            fh.seek(40)
            fh.write(bytes([byte[0] ^ 0xFF]))
        else:
            fh.truncate(os.path.getsize(f.path) - 7)
    with pytest.raises(spiller.SpillCorruption, match=match) as ei:
        list(f.read())
    assert ei.value.path == f.path
    assert ei.value.page == (0 if damage == "flip" else 1)


def test_spill_budget_refuses_a_page(tmp_path):
    rng = np.random.default_rng(4)
    sm = spiller.SpillManager(str(tmp_path), budget_bytes=2_000)
    f = sm.spill_file("b")
    with pytest.raises(spiller.SpillLimitExceeded, match="byte budget"):
        f.append(_kv_batch(rng))
    f.close()


def _spill_tree(mod, batch, tmp_path, tag):
    """Spill `batch` into a 4-way spiller of `mod` with a budget that
    grows partitions, then a co-partitioned spiller aligned to it; the
    (depth, rows) of every leaf of both."""
    sm = mod.SpillManager(str(tmp_path / tag))
    os.makedirs(sm.dir, exist_ok=True)
    a = sm.partitioning_spiller(["k", "s"], 4, "a",
                                partition_budget_bytes=3_000, max_depth=2)
    a.spill(batch)
    b = sm.partitioning_spiller(["k", "s"], 4, "b")
    b.spill(batch)
    b.align_to(a)
    out = [[(sp.depth, sp.files[p].rows) for sp, p in s.leaf_items()]
           for s in (a, b)]
    a.close()
    b.close()
    return out


def test_spiller_routes_grows_and_aligns_like_reference(tmp_path):
    rng = np.random.default_rng(8)
    n = 2000
    k = rng.integers(0, 300, n)
    s = rng.integers(0, 7, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    svals = np.array([f"v{i}" for i in range(7)], dtype=object)
    pb = convert.batch_from_arrays(["k", "s"], ["bigint", "varchar"],
                                   [k, s], [valid, None], [None, None],
                                   np.ones(n, bool), {"s": svals}, "cpu")
    rb = RefBatch(["k", "s"], [ref_parse_type("bigint"),
                               ref_parse_type("varchar")],
                  [RefColumn(jnp.asarray(k), jnp.asarray(valid)),
                   RefColumn(jnp.asarray(s))], jnp.ones(n, bool),
                  {"s": RefDictionary(svals)})
    got = _spill_tree(spiller, pb, tmp_path, "port")
    assert got == _spill_tree(ref_spiller, rb, tmp_path, "ref")
    assert max(d for d, _ in got[0]) > 0, "no partition grew"


# -- hashes -----------------------------------------------------------------


def _hash_columns(seed: int, n: int = 1000):
    """(values, dictionary values | None, validity | None) triples: ints,
    doubles with -0.0 and NaN, and strings coded against a dictionary."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    f[::17] = -0.0
    f[::29] = np.nan
    svals = np.array(sorted({f"x{i:03d}" for i in range(40)}), dtype=object)
    return [(rng.integers(-1 << 40, 1 << 40, n), None, rng.random(n) < 0.9),
            (f, None, None),
            (rng.integers(0, 40, n).astype(np.int32), svals,
             rng.random(n) < 0.95)]


@pytest.mark.parametrize("buckets, divisor", [(8, 1), (4, 8), (16, 64)])
def test_host_hashes_match_reference(buckets, divisor):
    cols = _hash_columns(7)
    port = [(v, None if d is None else convert._dictionary(d), va)
            for v, d, va in cols]
    ref = [(v, None if d is None else RefDictionary(d), va)
           for v, d, va in cols]
    np.testing.assert_array_equal(spiller.np_row_hash(port),
                                  ref_spiller.np_row_hash(ref))
    got = spiller.np_bucket_ids(port, buckets, divisor)
    np.testing.assert_array_equal(
        got, ref_spiller.np_bucket_ids(ref, buckets, divisor))
    assert len(np.unique(got)) == buckets


def _key_batches(seed: int, dict_seed: int):
    """The same key content in both packages; the string key is coded
    against a dictionary drawn with `dict_seed` (different dictionaries,
    equal strings)."""
    rng = np.random.default_rng(seed)
    n = 512
    pool = [f"k{i:03d}" for i in range(60)]
    extra = np.random.default_rng(dict_seed).choice(200, 20, replace=False)
    svals = np.array(sorted(set(pool) | {f"z{e}" for e in extra}),
                     dtype=object)
    strings = rng.choice(pool, n)
    codes = np.searchsorted(svals, strings).astype(np.int32)
    k = rng.integers(0, 1 << 50, n)
    valid = rng.random(n) < 0.9
    live = rng.random(n) < 0.85
    pb = convert.batch_from_arrays(["k", "s"], ["bigint", "varchar"],
                                   [k, codes], [valid, None], [None, None],
                                   live, {"s": svals}, "cpu")
    rb = RefBatch(["k", "s"], [ref_parse_type("bigint"),
                               ref_parse_type("varchar")],
                  [RefColumn(jnp.asarray(k), jnp.asarray(valid)),
                   RefColumn(jnp.asarray(codes))], jnp.asarray(live),
                  {"s": RefDictionary(svals)})
    return pb, rb, strings


def test_partition_hash_and_radix_ids_match_reference():
    pb, rb, strings = _key_batches(1, 2)
    keys = ("k", "s")
    np.testing.assert_array_equal(partition_hash(pb, keys).numpy(),
                                  np.asarray(ref_partition_hash(rb, keys)))
    for P in (1, 2, 8, 64):
        np.testing.assert_array_equal(radix.radix_ids(pb, keys, P).numpy(),
                                      np.asarray(ref_radix.radix_ids(rb, keys,
                                                                     P)))
    for P, F in ((4, 4), (8, 2)):
        np.testing.assert_array_equal(
            radix.radix_child_ids(pb, keys, P, F).numpy(),
            np.asarray(ref_radix.radix_child_ids(rb, keys, P, F)))
    # equal strings under another dictionary hash alike
    other, _, strings2 = _key_batches(1, 3)
    assert list(strings2) == list(strings)
    assert other.dicts["s"].values.tolist() != pb.dicts["s"].values.tolist()
    np.testing.assert_array_equal(partition_hash(other, ["s"]).numpy(),
                                  partition_hash(pb, ["s"]).numpy())


def test_radix_bits_refuses_non_power_of_two():
    assert radix.radix_bits(8) == 3
    for bad in (0, 6, -4):
        with pytest.raises(ValueError):
            radix.radix_bits(bad)


def test_radix_split_partitions_exactly():
    pb, _, _ = _key_batches(4, 4)
    P = 4
    ids = radix.radix_ids(pb, ("k",), P).numpy()
    live = pb.live.numpy()
    sb, counts = radix.radix_sort(pb, ("k",), P)
    perm, counts2 = radix.radix_perm(pb, ("k",), P)
    cnts = counts.numpy()
    assert cnts.tolist() == counts2.numpy().tolist()
    assert cnts.sum() == live.sum()
    starts = np.concatenate([[0], np.cumsum(cnts)])
    k = pb.column("k").values.numpy()
    for p in range(P):
        n = int(cnts[p])
        want = k[live & (ids == p)]  # stable: input order kept
        for w in (radix.radix_window(sb, int(starts[p]), n, 256),
                  radix.radix_window_perm(pb, perm, int(starts[p]), n, 256)):
            wl = w.live.numpy()
            assert wl.sum() == n
            assert w.column("k").values.numpy()[wl].tolist() == want.tolist()
