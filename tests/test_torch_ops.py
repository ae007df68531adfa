"""The port's sort, grouping and join operators against the JAX package's,
on the same inputs made with numpy (batches carried across with
presto_tpu_torch.convert).

Tolerances: integer, key, validity and count outputs must be equal; float
sums may differ by addition order only (rtol=1e-12, the tolerance the JAX
package allows between its own engines). Hash-engine group order and slot
assignment are compared exactly too: on the CPU the port's hash kernels
are serial like the TPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.batch import Batch as RefBatch
from presto_tpu.ops import grouping as rg
from presto_tpu.ops import join as rj
from presto_tpu.ops import sort as rs
from presto_tpu.types import BIGINT, INTEGER, VARCHAR
from presto_tpu_torch import convert
from presto_tpu_torch.ops import grouping as tg
from presto_tpu_torch.ops import join as tj
from presto_tpu_torch.ops import sort as ts


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _n(a):
    return None if a is None else np.asarray(a)


def to_port(b: RefBatch):
    """A JAX-package batch as a port batch on the CPU, via numpy."""
    return convert.batch_from_arrays(
        b.names, [str(t) for t in b.types],
        [np.asarray(c.values) for c in b.columns],
        [_n(c.validity) for c in b.columns], [_n(c.hi) for c in b.columns],
        np.asarray(b.live), b.dicts, "cpu")


def test_convert_round_trip():
    rb = RefBatch.from_numpy({"a": np.arange(5), "s": np.array([1, 0, 1, 2, 0])},
                             {"a": BIGINT, "s": VARCHAR})
    from presto_tpu.dictionary import Dictionary
    rb.dicts["s"] = Dictionary(np.array(["x", "y", "z"]))
    pb = to_port(rb)
    back = convert.batch_to_arrays(pb)
    assert back["names"] == ["a", "s"] and back["types"] == ["bigint", "varchar"]
    np.testing.assert_array_equal(back["values"][0], np.asarray(rb.columns[0].values))
    np.testing.assert_array_equal(back["live"], np.asarray(rb.live))
    assert list(pb.to_pandas()["s"]) == list(rb.to_pandas()["s"])


# ---------------------------------------------------------------------------
# sort


def test_sort_permutation_matches_reference():
    rng = np.random.default_rng(0)
    n = 300
    ints = rng.integers(-5, 5, n)
    flts = rng.choice([0.0, -0.0, 1.5, -2.0, np.nan, np.inf], n)
    bools = rng.random(n) < 0.5
    valid = rng.random(n) < 0.8
    live = rng.random(n) < 0.9
    for desc in (False, True):
        for nf in (False, True):
            rkeys = [rs.SortKey(jnp.asarray(ints), jnp.asarray(valid), desc, nf),
                     rs.SortKey(jnp.asarray(flts), None, not desc, nf),
                     rs.SortKey(jnp.asarray(bools), None, desc, nf)]
            tkeys = [ts.SortKey(_t(ints), _t(valid), desc, nf),
                     ts.SortKey(_t(flts), None, not desc, nf),
                     ts.SortKey(_t(bools), None, desc, nf)]
            ref = np.asarray(rs.sort_permutation(rkeys, jnp.asarray(live)))
            got = ts.sort_permutation(tkeys, _t(live)).numpy()
            np.testing.assert_array_equal(got, ref)


def test_compact_and_limit_match_reference():
    rng = np.random.default_rng(1)
    rb = RefBatch.from_numpy({"a": rng.integers(0, 9, 200)}, {"a": BIGINT})
    rb = rb.with_live(jnp.asarray(rng.random(rb.capacity) < 0.3))
    pb = to_port(rb)
    for r, p in ((rs.compact(rb), ts.compact(pb)),
                 (rs.limit_batch(rb, 17), ts.limit_batch(pb, 17))):
        np.testing.assert_array_equal(p.live.numpy(), np.asarray(r.live))
        np.testing.assert_array_equal(p.columns[0].values.numpy(),
                                      np.asarray(r.columns[0].values))


# ---------------------------------------------------------------------------
# grouped_merge, all four routes


def _states(rng, n, floats=True):
    dec = rng.integers(-10_000, 10_000, n)
    sv = rng.random(n) < 0.8
    out = [(dec, sv, "sum"), (np.ones(n, np.int64), None, "count_add"),
           (rng.integers(-2**40, 2**40, n), None, "min"),
           (dec, sv, "max")]
    if floats:
        out.append((rng.normal(size=n), sv, "sum"))
    return out


def _merge_both(keys, states, live, cap, engine):
    def ref_merge(kv, kva, sv, sva, lv):
        rk = [rg.KeyCol(v, va, d) for v, va, (_, _, d) in zip(kv, kva, keys)]
        rsx = [rg.StateCol(v, va, op)
               for v, va, (_, _, op) in zip(sv, sva, states)]
        k, st, live, ng = rg.grouped_merge(rk, rsx, lv, cap, engine=engine)
        return ([(x.values, x.validity) for x in k],
                [(x.values, x.validity) for x in st], live, ng)

    def j(a):
        return None if a is None else jnp.asarray(a)

    # jitted: the eager reference runs its associative scans op by op
    rk, rst, rlive, rng_ = jax.jit(ref_merge)([j(v) for v, _, _ in keys],
                             [j(va) for _, va, _ in keys],
                             [j(v) for v, _, _ in states],
                             [j(va) for _, va, _ in states], j(live))
    ref = ([rg.KeyCol(v, va) for v, va in rk],
           [rg.StateCol(v, va, op) for (v, va), (_, _, op) in zip(rst, states)],
           rlive, rng_)
    tk = [tg.KeyCol(_t(v), _t(va), d) for v, va, d in keys]
    tsx = [tg.StateCol(_t(v), _t(va), op) for v, va, op in states]
    got = tg.grouped_merge(tk, tsx, _t(live), cap, engine=engine)
    return ref, got


def _assert_merge_equal(ref, got):
    rk, rst, rlive, rng_ = ref
    k, st, live, ng = got
    assert int(ng) == int(rng_)
    np.testing.assert_array_equal(live.numpy(), np.asarray(rlive))
    m = np.asarray(rlive)
    for a, b in zip(k, rk):
        np.testing.assert_array_equal(a.values.numpy()[m], np.asarray(b.values)[m])
        if b.validity is not None or a.validity is not None:
            np.testing.assert_array_equal(a.validity.numpy()[m],
                                          np.asarray(b.validity)[m])
    for a, b in zip(st, rst):
        valid = m if b.validity is None else m & np.asarray(b.validity)
        if b.validity is not None:
            np.testing.assert_array_equal(a.validity.numpy()[m],
                                          np.asarray(b.validity)[m])
        av, bv = a.values.numpy()[valid], np.asarray(b.values)[valid]
        if av.dtype.kind == "f":
            np.testing.assert_allclose(av, bv, rtol=1e-12)
        else:
            np.testing.assert_array_equal(av, bv)


def test_global_merge():
    rng = np.random.default_rng(2)
    n = 512
    live = rng.random(n) < 0.9
    _assert_merge_equal(*_merge_both([], _states(rng, n), live, 4, "sort"))


@pytest.mark.parametrize("engine", ["sort", "hash"])
def test_direct_small_domain_merge(engine):
    rng = np.random.default_rng(3)
    n = 1024
    k1 = rng.integers(0, 3, n)
    k2 = rng.integers(0, 2, n)
    v2 = rng.random(n) < 0.7
    live = rng.random(n) < 0.9
    keys = [(k1, None, 3), (k2, v2, 2)]
    _assert_merge_equal(*_merge_both(keys, _states(rng, n), live, 16, engine))


@pytest.mark.parametrize("engine,cap,floats", [
    ("sort", 64, True),
    ("hash", 64, False),   # all-int states: the grouped_sums route
    # (the hash engine's indexed route runs in test_torch_tpch's Q3)
])
def test_general_merge(engine, cap, floats):
    rng = np.random.default_rng(cap)
    _assert_merge_equal(*_merge_both(*_general_case(rng, floats), cap, engine))


@pytest.mark.parametrize("engine", ["sort", "hash"])
def test_general_merge_overflow_signal(engine):
    """More groups than the capacity: n_groups reports it (exactly on the
    sort engine; as cap + unplaced rows, clamped, on the hash engine — the
    hash kernel's overflow itself is held to the TPU kernel's in
    test_torch_kernels)."""
    rng = np.random.default_rng(16)
    keys, states, live = _general_case(rng, False)
    tk = [tg.KeyCol(_t(v), _t(va), d) for v, va, d in keys]
    tsx = [tg.StateCol(_t(v), _t(va), op) for v, va, op in states]
    _, _, _, ng = tg.grouped_merge(tk, tsx, _t(live), 16, engine=engine)
    k1, (k2, v2) = keys[0][0], keys[1][:2]
    distinct = len({(a, b if c else None)
                    for a, b, c, lv in zip(k1, k2, v2, live) if lv})
    assert distinct > 16
    if engine == "sort":
        assert int(ng) == distinct
    else:
        assert 16 < int(ng) <= 4 * 16


def _general_case(rng, floats):
    n = 1024
    k1 = rng.integers(0, 6, n) * (2**40)
    k2 = rng.integers(0, 5, n).astype(np.int32)
    v2 = rng.random(n) < 0.8
    live = rng.random(n) < 0.9
    keys = [(k1, None, None), (k2, v2, None)]
    return keys, _states(rng, n, floats), live


# ---------------------------------------------------------------------------
# joins


def _join_batches(rng, nb=300, np_=700, string_keys=False):
    from presto_tpu.dictionary import Dictionary

    bk = rng.integers(0, 120, nb)
    pk = rng.integers(0, 150, np_)
    build = RefBatch.from_numpy({"bk": bk, "brow": np.arange(nb)},
                                {"bk": BIGINT, "brow": BIGINT})
    probe = RefBatch.from_numpy({"pk": pk.astype(np.int32), "prow": np.arange(np_)},
                                {"pk": INTEGER, "prow": BIGINT})
    bvalid = np.zeros(build.capacity, bool)
    bvalid[:nb] = rng.random(nb) < 0.95  # some NULL build keys
    c = build.columns[0]
    build = RefBatch(build.names, build.types,
                     [type(c)(c.values, jnp.asarray(bvalid)), build.columns[1]],
                     build.live, {})
    if string_keys:
        bd = Dictionary(np.array([f"k{i:03d}" for i in range(0, 150, 1)]))
        pd_ = Dictionary(np.array([f"k{i:03d}" for i in range(30, 180, 1)]))
        build = RefBatch(build.names, (VARCHAR, BIGINT),
                         [type(c)(jnp.asarray(np.asarray(c.values), jnp.int32),
                                  jnp.asarray(bvalid)), build.columns[1]],
                         build.live, {"bk": bd})
        probe = RefBatch(probe.names, (VARCHAR, BIGINT), probe.columns,
                         probe.live, {"pk": pd_})
    return build, probe


def _pairs(probe_b, build_b, pr, bi, live):
    prow = np.asarray(probe_b.column("prow").values)[np.asarray(pr)]
    brow = np.asarray(build_b.column("brow").values)[np.asarray(bi)]
    m = np.asarray(live)
    return sorted(zip(prow[m].tolist(), brow[m].tolist()))


# jitted once: the eager reference would compile each op separately
_ref_build = jax.jit(lambda b: rj.build_side(b, ["bk"]))
_ref_align = jax.jit(lambda p, t: rj.align_probe_strings(p, ["pk"], t, ["bk"]))
_ref_counts = jax.jit(lambda t, p: rj.probe_counts(t, p, ["pk"], ["bk"]))
_ref_unique = jax.jit(lambda t, p: rj.probe_unique(t, p, ["pk"], ["bk"]))
_EXPAND_CAP = 512
_ref_expand = jax.jit(lambda t, p, lo, c, o, base: rj.probe_expand(
    t, p, ["pk"], ["bk"], lo, c, o, base, _EXPAND_CAP))


@pytest.mark.parametrize("string_keys", [False, True])
def test_sort_engine_join(string_keys):
    rng = np.random.default_rng(5)
    rb, rp = _join_batches(rng, string_keys=string_keys)
    tb, tp = to_port(rb), to_port(rp)
    rt = _ref_build(rb)
    tt = tj.build_side(tb, ["bk"])
    np.testing.assert_array_equal(tt.hashes.numpy(), np.asarray(rt.hashes))
    assert int(tt.n_rows) == int(rt.n_rows)
    rpa = _ref_align(rp, rt)
    tpa = tj.align_probe_strings(tp, ["pk"], tt, ["bk"])
    np.testing.assert_array_equal(tpa.column("pk").values.numpy(),
                                  np.asarray(rpa.column("pk").values))
    rlo, rc, ro, rtot, _, rov = _ref_counts(rt, rpa)
    lo, c, o, tot, _, ov = tj.probe_counts(tt, tpa, ["pk"], ["bk"])
    for a, b in ((c, rc), (o, ro)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tot) == int(rtot) and int(ov) == int(rov)
    ref_pairs, got_pairs = [], []
    for base in range(0, int(tot), _EXPAND_CAP):  # two output chunks
        r = _ref_expand(rt, rpa, rlo, rc, ro, base)
        g = tj.probe_expand(tt, tpa, ["pk"], ["bk"], lo, c, o, base,
                            _EXPAND_CAP)
        ref_pairs += _pairs(rp, rt.batch, *r)
        got_pairs += _pairs(tp, tt.batch, *g)
    assert sorted(got_pairs) == sorted(ref_pairs) and ref_pairs
    # unique-build probe on a deduplicated build
    first = np.unique(np.asarray(rb.column("bk").values)[: 300],
                      return_index=True)[1]
    keep = np.zeros(rb.capacity, bool)
    keep[first] = True
    rbu = rb.with_live(jnp.asarray(np.asarray(rb.live) & keep))
    rtu, ttu = _ref_build(rbu), tj.build_side(to_port(rbu), ["bk"])
    ri, rm = _ref_unique(rtu, _ref_align(rp, rtu))
    gi, gm = tj.probe_unique(ttu, tj.align_probe_strings(tp, ["pk"], ttu, ["bk"]),
                             ["pk"], ["bk"])
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    m = np.asarray(rm)
    np.testing.assert_array_equal(gi.numpy()[m], np.asarray(ri)[m])


def test_hash_engine_join():
    rng = np.random.default_rng(6)
    rb, rp = _join_batches(rng)
    tb, tp = to_port(rb), to_port(rp)
    rt = rj.hash_build_side(rb, ("bk",), (jnp.int32,))
    tt = tj.hash_build_side(tb, ("bk",), (torch.int32,))
    for a, b in ((tt.slot_row, rt.slot_row), (tt.planes, rt.planes),
                 (tt.hashes, rt.hashes), (tt.batch.live, rt.batch.live)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cdt_r = rj.join_compare_dtypes(rb, ("bk",), (jnp.int32,))
    cdt_t = tj.join_compare_dtypes(tb, ("bk",), (torch.int32,))
    assert str(cdt_t[0]).endswith("int64") and str(cdt_r[0]) == "int64"
    for fanout in (2,):  # ~2.5 rows per build key: some rows overflow
        r = rj.hash_probe_counts(rt, rp, ("pk",), cdt_r, max_fanout_scan=fanout)
        g = tj.hash_probe_counts(tt, tp, ("pk",), cdt_t, max_fanout_scan=fanout)
        for a, b in zip(g[:4], r[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(g[5]) == int(r[5])
    mm, counts, offsets, total = g[:4]
    for base in range(0, int(total), 256):
        re = rj.hash_probe_expand(rt, r[0], r[1], r[2], base, 256)
        ge = tj.hash_probe_expand(tt, mm, counts, offsets, base, 256)
        for a, b in zip(ge, re):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # gather_join_output over the same index vectors
    pr_, bi_, ol_ = ge
    ro = rj.gather_join_output(rp, rt, jnp.asarray(pr_.numpy()),
                               jnp.asarray(bi_.numpy()), jnp.asarray(ol_.numpy()),
                               ["pk", "prow"], ["bk", "brow"])
    go = tj.gather_join_output(tp, tt, pr_, bi_, ol_, ["pk", "prow"],
                               ["bk", "brow"])
    assert go.to_pandas().equals(ro.to_pandas())


# ---------------------------------------------------------------------------
# window functions (ops/window.py)

from presto_tpu.ops import window as rw  # noqa: E402
from presto_tpu_torch.ops import window as tw  # noqa: E402

_POOL = np.array([-np.inf, -1.5, -0.0, 0.0, 1.0, 2.5, np.inf, np.nan])


def _same(got, want, where):
    """Bit for bit: equal validity, NaN where the reference has NaN, and
    every other value with the same bits (so -0.0 is not 0.0)."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, where
    if g.dtype.kind == "f" or w.dtype.kind == "f":
        g, w = g.astype(np.float64), w.astype(np.float64)
        assert (np.isnan(g) == np.isnan(w)).all(), where
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(g[ok].view(np.int64),
                                      w[ok].view(np.int64), err_msg=str(where))
    else:
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(where))


def _same_pair(got, want, where):
    _same(got[0], want[0], where)
    if want[1] is None:
        assert got[1] is None, where
    else:
        _same(got[1], want[1], (where, "validity"))


@pytest.fixture(scope="module")
def window_input():
    """Rows sorted as the window operator sorts them (partition key, then a
    float order key with NULLs, NaN, +-inf, -0.0 and ties), dead rows
    last; int and float values with NULLs."""
    rng = np.random.default_rng(5)
    n = 300
    part = rng.integers(0, 6, n)
    part_valid = rng.random(n) > 0.05
    okey = _POOL[rng.integers(0, len(_POOL), n)]
    ok_valid = rng.random(n) > 0.1
    ivals = rng.integers(-50, 50, n)
    fvals = _POOL[rng.integers(0, len(_POOL), n)] * rng.integers(1, 4, n)
    vvalid = rng.random(n) > 0.15
    live = np.arange(n) < n - 17
    keys = [rs.SortKey(jnp.asarray(part), jnp.asarray(part_valid)),
            rs.SortKey(jnp.asarray(okey), jnp.asarray(ok_valid), False,
                       False)]
    perm = np.asarray(rs.sort_permutation(keys, jnp.asarray(live)))
    cols = dict(part=part, part_valid=part_valid, okey=okey,
                ok_valid=ok_valid, ivals=ivals, fvals=fvals, vvalid=vvalid,
                live=live)
    return {k: v[perm] for k, v in cols.items()}


def _keys(d, order=True):
    ref = rw.window_keys(
        [(jnp.asarray(d["part"]), jnp.asarray(d["part_valid"]))],
        [(jnp.asarray(d["okey"]), jnp.asarray(d["ok_valid"]))] if order else [],
        jnp.asarray(d["live"]))
    port = tw.window_keys(
        [(_t(d["part"]), _t(d["part_valid"]))],
        [(_t(d["okey"]), _t(d["ok_valid"]))] if order else [],
        _t(d["live"]))
    return ref, port


@pytest.mark.parametrize("order", [True, False])
def test_window_keys_and_ranks_match_reference(window_input, order):
    rk, pk = _keys(window_input, order)
    for f in rw.WindowKeys._fields:
        _same(getattr(pk, f), getattr(rk, f), f)
    for fn in ("row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist"):
        _same_pair(getattr(tw, fn)(pk), getattr(rw, fn)(rk), fn)
    for b in (1, 3, 7, 500):
        _same_pair(tw.ntile(pk, b), rw.ntile(rk, b), ("ntile", b))


def test_window_value_functions_match_reference(window_input):
    d = window_input
    rk, pk = _keys(d)
    for vals in ("ivals", "fvals"):
        rv, rvalid = jnp.asarray(d[vals]), jnp.asarray(d["vvalid"])
        pv, pvalid = _t(d[vals]), _t(d["vvalid"])
        for off, dflt in ((1, None), (3, None), (2, -7)):
            _same_pair(tw.lag(pk, pv, pvalid, off, dflt),
                       rw.lag(rk, rv, rvalid, off, dflt), ("lag", vals, off))
            _same_pair(tw.lead(pk, pv, pvalid, off, dflt),
                       rw.lead(rk, rv, rvalid, off, dflt), ("lead", vals, off))
        _same_pair(tw.first_value(pk, pv, pvalid),
                   rw.first_value(rk, rv, rvalid), ("first", vals))
        _same_pair(tw.last_value(pk, pv, pvalid),
                   rw.last_value(rk, rv, rvalid), ("last", vals))
        for nth in (1, 2, 5):
            _same_pair(tw.nth_value(pk, pv, pvalid, nth),
                       rw.nth_value(rk, rv, rvalid, nth), ("nth", vals, nth))


@pytest.mark.parametrize("frame", ["whole", "range", "rows"])
def test_window_aggregates_match_reference(window_input, frame):
    """min/max/count exactly; int sums exactly; float sums differ by
    addition order only (rtol=1e-12 where finite)."""
    d = window_input
    rk, pk = _keys(d, order=frame != "whole")
    for vals in ("ivals", "fvals"):
        is_float = vals == "fvals"
        rv, rvalid = jnp.asarray(d[vals]), jnp.asarray(d["vvalid"])
        pv, pvalid = _t(d[vals]), _t(d["vvalid"])
        for fn in ("min", "max", "count", "sum", "avg"):
            a_rv, a_pv, a_float = rv, pv, is_float
            if fn == "avg" and not is_float:
                a_rv, a_pv, a_float = rv.astype(jnp.float64), pv.double(), True
            got = tw.agg_window(pk, fn, a_pv, pvalid, frame, a_float)
            want = rw.agg_window(rk, fn, a_rv, rvalid, frame, a_float)
            if fn in ("sum", "avg") and a_float:
                _same(got[1], want[1], (fn, vals, "validity"))
                np.testing.assert_allclose(np.asarray(got[0]),
                                           np.asarray(want[0]), rtol=1e-12)
            else:
                _same_pair(got, want, (fn, vals, frame))


# NULL placement moves only RANGE bounds: ROWS frames run once
@pytest.mark.parametrize("frame, nulls_first", [
    (f, False) for f in ("rows:p3:f2", "rows:up:cur", "rows:cur:uf",
                         "rows:f10000:f10001", "rows:p5:p1")] + [
    (f, nf) for f in ("range:p1:f1", "range:cur:f2", "range:up:p1",
                      "range:p0:f0", "range:f1:uf") for nf in (False, True)])
def test_bounded_frames_match_reference(window_input, frame, nulls_first):
    """ROWS and RANGE-offset frames over a float order key with NULLs, NaN,
    +-inf and -0.0: the frame bounds, count, min and max bit for bit (the
    sparse table's range-min query included), int sums exactly, float sums
    to rtol=1e-12 where finite."""
    d = window_input
    rk, pk = _keys(d)
    rng_r = dict(order_vals=jnp.asarray(d["okey"]),
                 order_valid=jnp.asarray(d["ok_valid"]),
                 nulls_first=nulls_first)
    rng_p = dict(order_vals=_t(d["okey"]), order_valid=_t(d["ok_valid"]),
                 nulls_first=nulls_first)
    if frame.startswith("range:"):
        got = tw.range_frame_bounds(pk, rng_p["order_vals"], frame,
                                    rng_p["order_valid"], nulls_first)
        want = rw.range_frame_bounds(rk, rng_r["order_vals"], frame,
                                     rng_r["order_valid"], nulls_first)
    else:
        got, want = tw.frame_bounds(pk, frame), rw.frame_bounds(rk, frame)
    for g, w, what in zip(got, want, ("start", "end", "nonempty")):
        _same(g, w, (frame, what))
    for vals in ("ivals", "fvals"):
        is_float = vals == "fvals"
        rv, rvalid = jnp.asarray(d[vals]), jnp.asarray(d["vvalid"])
        pv, pvalid = _t(d[vals]), _t(d["vvalid"])
        for fn in ("count", "min", "max", "sum"):
            got = tw.agg_window_bounded(pk, fn, pv, pvalid, frame, is_float,
                                        **rng_p)
            want = rw.agg_window_bounded(rk, fn, rv, rvalid, frame, is_float,
                                         **rng_r)
            if fn == "sum" and is_float:
                _same(got[1], want[1], (fn, frame, "validity"))
                g, w = np.asarray(got[0]), np.asarray(want[0])
                fin = np.isfinite(w)
                assert (np.isnan(g) == np.isnan(w)).all()
                np.testing.assert_allclose(g[fin], w[fin], rtol=1e-12)
            else:
                _same_pair(got, want, (fn, vals, frame))
        for fn in ("first_value", "last_value", "nth_value"):
            _same_pair(
                tw.value_over_frame(pk, fn, pv, pvalid, frame, 2, **rng_p),
                rw.value_over_frame(rk, fn, rv, rvalid, frame, 2, **rng_r),
                (fn, vals, frame))


def test_segmented_cummin_and_range_min_bit_exact(window_input):
    """The doubling scan equals the JAX package's associative scan, and the
    sparse table's queries (floor(log2) by compares, not clz) equal its
    clz-based ones, bit for bit, on values with NaN, +-inf and -0.0."""
    d = window_input
    rk, pk = _keys(d)
    rng = np.random.default_rng(9)
    for v in (d["fvals"], d["ivals"]):
        _same(tw._segmented_cummin(_t(v), pk),
              rw._segmented_cummin(jnp.asarray(v), rk), "cummin")
        rt = rw._range_min_table(jnp.asarray(v))
        pt = tw._range_min_table(_t(v))
        _same(pt, rt, "table")
        n = len(v)
        s = rng.integers(0, n, 500)
        e = np.minimum(s + rng.integers(0, n, 500), n - 1)
        _same(tw._range_min_query(pt, _t(s), _t(e)),
              rw._range_min_query(rt, jnp.asarray(s), jnp.asarray(e)),
              "query")
    span = np.arange(1, 1 << 12)
    np.testing.assert_array_equal(
        tw.floor_log2(_t(span), 40).numpy(),
        np.floor(np.log2(span)).astype(np.int64))
