"""The port's scan layer (presto_tpu_torch/scan/ and the device split
cache) against the JAX package's presto_tpu/scan/, unit by unit, with no
query:

- every value filter, and filters_from_constraints, gives the JAX
  package's masks on the same numpy inputs (NaN, NULLs, NULL codes, type
  mismatches, strings absent from the dictionary);
- AdaptiveFilterOrder gives the same order after each of the same updates;
- split_prunable gives the same verdicts;
- ORC stripe sidecars written by either package read equal in both;
- the process counters record, snapshot and reset;
- the memory connector's split cache (the DeviceSplitCache mixin) serves
  hits, stays within its byte budget and keeps a split read across an
  invalidation out of the cache.
All exact: these are integer masks, orders and verdicts.
"""

import datetime

import numpy as np
import pandas as pd
import pytest

from presto_tpu.catalog.orc import export_table_to_orc as ref_export_orc
from presto_tpu.connector import ColumnInfo as RefColumnInfo
from presto_tpu.connector import TableHandle as RefHandle
from presto_tpu.dictionary import Dictionary as RefDictionary
from presto_tpu.scan import adaptive as ref_adaptive
from presto_tpu.scan import filters as ref_filters
from presto_tpu.scan import pruning as ref_pruning
from presto_tpu.types import parse_type as ref_parse_type
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.catalog.orc import export_table_to_orc
from presto_tpu_torch.connector import ColumnInfo, Split, TableHandle
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.memory import batch_device_bytes
from presto_tpu_torch.scan import adaptive, filters, metrics, pruning
from presto_tpu_torch.types import parse_type

RNG = np.random.default_rng(20261018)
N = 257
INTS = RNG.integers(-50, 50, N)
FLOATS = RNG.normal(0, 10, N)
FLOATS[::7] = np.nan
VALID = RNG.random(N) > 0.2
CODES = RNG.integers(-1, 6, N).astype(np.int32)  # -1: a NULL code

# (name, constructor arguments, input); each filter is built the same way
# in both packages
FILTER_CASES = [
    ("bigint_both", "BigintRange", (-10, 20), INTS),
    ("bigint_lo", "BigintRange", (0, None), INTS),
    ("bigint_hi", "BigintRange", (None, -3), INTS),
    ("bigint_open", "BigintRange", (None, None), INTS),
    ("double_both", "DoubleRange", (-5.0, 5.0), FLOATS),
    ("double_lo", "DoubleRange", (1.5, None), FLOATS),
    ("double_open", "DoubleRange", (None, None), FLOATS),
    ("bytes_values", "BytesValues", ([0, 3, 5],), CODES),
    ("multi_range", "MultiRange", ([(-40, -30), (0, 4), (45, None)],), INTS),
    ("is_null", "IsNull", (), INTS),
    ("is_not_null", "IsNotNull", (), INTS),
    ("always_false", "AlwaysFalse", (), INTS),
]


@pytest.mark.parametrize("validity", [False, True], ids=["no_nulls", "nulls"])
@pytest.mark.parametrize("null_allowed", [False, True],
                         ids=["nulls_fail", "nulls_pass"])
@pytest.mark.parametrize("name, kind, args, values",
                         FILTER_CASES, ids=[c[0] for c in FILTER_CASES])
def test_value_filter_matches_reference(name, kind, args, values,
                                        null_allowed, validity):
    valid = VALID if validity else None
    kw = ({"null_allowed": True}
          if null_allowed and kind not in ("IsNull", "IsNotNull",
                                           "AlwaysFalse") else {})
    got = getattr(filters, kind)(*args, **kw).test(values, valid)
    want = getattr(ref_filters, kind)(*args, **kw).test(values, valid)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


_STRINGS = np.array(["AIR", "FOB", "MAIL", "RAIL", "SHIP", "TRUCK"])
_SCHEMA = [("k", "bigint", None), ("x", "double", None),
           ("d", "date", None), ("p", "decimal(12,2)", None),
           ("w", "decimal(38,2)", None), ("s", "varchar", _STRINGS),
           ("u", "varchar", None)]
_CONSTRAINTS = {
    "k": (-5, 30), "x": (None, 2.5), "d": (8100, 9000), "p": (500, None),
    "w": (1, 2),  # a long decimal: never compiled
    "s": ("FOB", "RAIL"), "u": ("a", "b"),  # u has no dictionary
    "missing": (1, 2),  # not a column of the table
    "open": (None, None),
}
_MISMATCH = {"k": ("a", None), "x": (None, "z"), "s": (1, 3)}
_ABSENT = {"s": ("FOO", "FOO"), "k": (None, None)}


def _handles():
    ref = RefHandle("c", "t", [
        RefColumnInfo(c, ref_parse_type(t),
                      None if v is None else RefDictionary(v))
        for c, t, v in _SCHEMA])
    port = TableHandle("c", "t", [
        ColumnInfo(c, parse_type(t), None if v is None else Dictionary(v))
        for c, t, v in _SCHEMA])
    return ref, port


@pytest.mark.parametrize("constraints", [_CONSTRAINTS, _MISMATCH, _ABSENT],
                         ids=["mixed", "type_mismatch", "absent_string"])
def test_filters_from_constraints_match_reference(constraints):
    """The same filters (by kind and bounds) on the same columns, and the
    same masks over each column's values with NULLs."""
    ref, port = _handles()
    want = ref_filters.filters_from_constraints(constraints, ref)
    got = filters.filters_from_constraints(constraints, port)
    assert sorted(got) == sorted(want)
    assert [repr(got[c]) for c in sorted(got)] == [
        repr(want[c]) for c in sorted(want)]
    inputs = {"k": INTS, "x": FLOATS, "d": INTS + 8500, "p": INTS * 20,
              "s": CODES}
    for col in got:
        m = got[col].test(inputs[col], VALID)
        np.testing.assert_array_equal(m, want[col].test(inputs[col], VALID))


def test_adaptive_order_matches_reference():
    """The same order after each of a sequence of updates, unobserved
    filters first, ties in the caller's order."""
    keys = ["a", "b", "c", "d"]
    got, want = adaptive.AdaptiveFilterOrder(), ref_adaptive.AdaptiveFilterOrder()
    rng = np.random.default_rng(3)
    assert got.order(keys) == want.order(keys) == keys
    for step in range(40):
        key = keys[step % 3]  # "d" is never observed
        rows_in = int(rng.integers(0, 5000))
        rows_out = int(rng.integers(0, rows_in + 1)) if rows_in else 0
        seconds = float(rng.random() * 1e-3) if step % 5 else 0.0
        got.update(key, rows_in, rows_out, seconds)
        want.update(key, rows_in, rows_out, seconds)
        assert got.order(keys) == want.order(keys), step
        assert [got.score(k) for k in keys] == [want.score(k) for k in keys]


_DAY = datetime.date
PRUNE_CASES = [
    ("below", {"k": (100, 200)}, {"k": (0, 99, 0)}),
    ("above", {"k": (100, 200)}, {"k": (201, 300, 0)}),
    ("overlap", {"k": (100, 200)}, {"k": (150, 300, 1)}),
    ("touch_lo", {"k": (100, 200)}, {"k": (0, 100, 0)}),
    ("open_lo", {"k": (None, 5)}, {"k": (6, 9, 0)}),
    ("unknown_stats", {"k": (100, 200)}, {"k": (None, None, 10)}),
    ("other_column", {"j": (100, 200)}, {"k": (0, 1, 0)}),
    ("dates", {"d": (_DAY(1994, 1, 1), _DAY(1994, 12, 31))},
     {"d": (_DAY(1995, 1, 1), _DAY(1995, 6, 1), 0)}),
    ("strings", {"s": ("MAIL", "MAIL")}, {"s": ("AIR", "FOB", 0)}),
    ("type_mismatch", {"k": ("a", "b")}, {"k": (0, 10, 0)}),
    ("second_column", {"k": (0, 10), "x": (5.5, None)},
     {"k": (0, 10, 0), "x": (-1.0, 5.0, 0)}),
]


@pytest.mark.parametrize("bounds, columns", [c[1:] for c in PRUNE_CASES],
                         ids=[c[0] for c in PRUNE_CASES])
def test_split_prunable_matches_reference(bounds, columns):
    got = pruning.split_prunable(pruning.SplitStats(10, columns), bounds)
    want = ref_pruning.split_prunable(ref_pruning.SplitStats(10, columns),
                                      bounds)
    assert got is want


def _orc_table():
    rng = np.random.default_rng(11)
    n = 6000
    data = {
        "k": np.sort(rng.integers(0, 1_000_000, n)),
        "v": rng.normal(0, 1, n),
        "d": np.sort(rng.integers(8000, 10000, n)).astype(np.int32),
        "s": rng.integers(0, 3, n).astype(np.int32),
    }
    valid = {"v": rng.random(n) > 0.1}
    return data, valid


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_orc_sidecar_reads_equal_in_both(tmp_path, writer):
    """An ORC file and its stripe sidecar written by one package load to
    the same per-stripe statistics in both (dates as datetime.date,
    strings as str), and a sidecar rewritten by the other package's
    writer is the same document."""
    data, valid = _orc_table()
    types = {"k": "bigint", "v": "double", "d": "date", "s": "varchar"}
    vocab = np.array(["x", "y", "z"])
    if writer == "jax":
        path = ref_export_orc(str(tmp_path), "t", data,
                              {c: ref_parse_type(t) for c, t in types.items()},
                              {"s": RefDictionary(vocab)}, stripe_size=4096,
                              validity=valid)
    else:
        path = export_table_to_orc(str(tmp_path), "t", data,
                                   {c: parse_type(t) for c, t in types.items()},
                                   {"s": Dictionary(vocab)}, stripe_size=4096,
                                   validity=valid)
    got = pruning.load_orc_sidecar(path)
    want = ref_pruning.load_orc_sidecar(path)
    assert got is not None and len(got) > 1
    assert [(s.num_rows, s.columns) for s in got] == [
        (s.num_rows, s.columns) for s in want]
    with open(pruning.sidecar_path(path)) as f:
        first = f.read()
    (pruning if writer == "jax" else ref_pruning).write_orc_sidecar(path)
    with open(pruning.sidecar_path(path)) as f:
        assert f.read() == first


def test_stale_sidecar_is_ignored_by_both(tmp_path):
    data, valid = _orc_table()
    path = export_table_to_orc(
        str(tmp_path), "t", data,
        {"k": parse_type("bigint"), "v": parse_type("double"),
         "d": parse_type("date"), "s": parse_type("integer")},
        stripe_size=4096, validity=valid)
    with open(path, "ab") as f:
        f.write(b"\0")  # the file no longer has the sidecar's size
    assert pruning.load_orc_sidecar(path) is None
    assert ref_pruning.load_orc_sidecar(path) is None


def test_scan_metrics_record_snapshot_reset():
    metrics.reset()
    metrics.record("splits_pruned", 3)
    metrics.record("bytes_skipped", 0)
    metrics.record("not_a_counter", 5)
    metrics.record("splits_pruned", 2)
    assert metrics.snapshot() == {"splits_pruned": 5,
                                  "rows_predecode_filtered": 0,
                                  "bytes_skipped": 0}
    metrics.reset()
    assert set(metrics.snapshot().values()) == {0}


def _memory_connector():
    conn = MemoryConnector()
    conn.add_table("t", pd.DataFrame({"a": np.arange(1000),
                                      "b": np.arange(1000) * 0.5}))
    return conn


def test_split_cache_hits_and_budget():
    """A repeated read is the cached batch; the cache counts every plane's
    bytes and evicts the least recently used split past its budget."""
    conn = _memory_connector()
    h = conn.get_table("t")
    splits = conn.splits(h, 4)
    first = conn.read_split(splits[0], ["a", "b"], "cpu")
    assert conn.read_split(splits[0], ["a", "b"], "cpu") is first
    one = batch_device_bytes(first)
    assert conn._split_cache_used == one
    conn.split_cache_bytes = 2 * one
    for s in splits[1:]:
        conn.read_split(s, ["a", "b"], "cpu")
    assert conn._split_cache_used <= 2 * one
    assert conn.read_split(splits[0], ["a", "b"], "cpu") is not first
    conn.invalidate_cache("t")
    assert conn._split_cache_used == 0 and not conn._split_cache


def test_split_cache_epoch_guard():
    """A split read while the table is invalidated is returned but not
    cached (it may hold the table's old rows)."""
    conn = _memory_connector()
    split = conn.splits(conn.get_table("t"), 1)[0]
    inner = conn._read_split_uncached

    def racing(*args):
        b = inner(*args)
        conn.invalidate_cache("t")
        return b

    conn._read_split_uncached = racing
    b = conn.read_split(split, ["a"], "cpu")
    assert not conn._split_cache
    del conn._read_split_uncached
    assert conn.read_split(split, ["a"], "cpu") is not b
    assert len(conn._split_cache) == 1


def test_split_stats_default_prunes_nothing():
    """A connector without statistics keeps every split."""
    conn = _memory_connector()
    h = conn.get_table("t")
    splits = conn.splits(h, 3)
    assert conn.split_stats(h, splits[0]) is None
    assert conn.prune_splits(h, splits, {"a": (5000, None)}) == splits
    assert isinstance(splits[0], Split)


def test_split_cache_under_threads():
    """Sixteen threads reading and invalidating one connector's splits (the
    prefetch threads of concurrent queries): the byte count stays the sum
    of the cached batches and within the budget."""
    import sys
    import threading

    conn = _memory_connector()
    splits = conn.splits(conn.get_table("t"), 8)
    one = batch_device_bytes(conn.read_split(splits[0], ["a", "b"], "cpu"))
    conn.split_cache_bytes = 3 * one
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(200):
                s = splits[int(rng.integers(0, len(splits)))]
                conn.read_split(s, ["a", "b"], "cpu")
                if rng.random() < 0.05:
                    conn.invalidate_cache("t")
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert conn._split_cache_used == sum(n for _, n in
                                         conn._split_cache.values())
    assert conn._split_cache_used <= conn.split_cache_bytes
