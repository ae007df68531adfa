"""ARRAY and MAP values, UNNEST, lambdas, the built aggregates, index
joins and geometry: the port on the CPU against the JAX package.

Both packages get one pair of catalogs built from the same frames (the
tables of tests/test_structural.py, tests/test_geo.py and
tests/test_index_join.py, with the indexes declared by
`add_table(index_keys=...)` in both). Each case runs the statements of one
local test of those files (or one built aggregate) through the JAX
package's LocalRunner and through the port's on the CPU under the
`auto` and `hash` engines, and the frames must be equal:
- exactly: integers, strings, keys, counts, HyperLogLog cardinalities,
  and the elements of arrays and maps and their order;
- to rtol=1e-12: float elements and values, numeric_histogram's buckets
  and the geometry metrics (the tolerance the JAX package allows between
  its own engines, tests/test_kernels.py).
A statement the JAX package refuses must raise the same error class, with
the same message, in the port. Three TPC-H SF 0.01 queries (arrays per
customer, their UNNEST, an index join to orders) share the JAX frames of
tests/test_torch_tpch.py's helper.

A second group holds the structural planes of expr/structural.py against
the JAX package's functions directly, on seeded numpy planes with NULL
elements, NaN, -0.0 and ragged sizes.
"""

import copy
import decimal
import math

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.catalog.tpch import tpch_catalog as ref_tpch_catalog
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu_torch import convert
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.catalog.tpch import tpch_catalog
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from test_torch_tpch import one_torch_thread  # noqa: F401 — autouse
from test_torch_tpch import reference_frame, reference_frames_dir  # noqa: F401

RTOL = 1e-12
N, DIM = 5_000, 400


def _frames():
    """name → (data, add_table keyword arguments), shared by both
    packages."""
    rng = np.random.default_rng(11)
    fact = pd.DataFrame({"k": rng.integers(0, DIM * 2, N),
                         "v": rng.integers(0, 100, N)})
    dim = pd.DataFrame({"k": np.arange(DIM),
                        "name": [f"d{i % 13}" for i in range(DIM)],
                        "w": rng.normal(size=DIM).round(6)})
    rng2 = np.random.default_rng(23)
    users = pd.DataFrame({"uname": [f"user{i}" for i in range(300)],
                          "score": np.arange(300) * 2})
    events = pd.DataFrame({
        "uname": [f"user{int(i)}" for i in rng2.integers(0, 600, 2_000)],
        "cnt": rng2.integers(1, 5, 2_000)})
    rng3 = np.random.default_rng(5)
    x = rng3.normal(size=600).round(2)
    x[::17] = np.nan  # NULLs for the sketches and the histogram
    return {
        "t": ({"id": np.array([1, 2, 3, 4]),
               "arr": [[1, 2, 3], [4, 5], [], [7, None, 9]],
               "tags": [["a", "b"], ["b"], ["c", "a"], []],
               "m": [{"x": 1.5, "y": 2.5}, {"x": 10.0}, {},
                     {"z": 7.0, "x": None}]}, {}),
        "s": ({"id": np.array([1, 2, 3, 4]),
               "name": np.array(["one", "two", "three", "four"])}, {}),
        "g": ({"k": np.array(["a", "a", "b", "b", "b"]),
               "v": np.array([1, 2, 3, 4, 5])}, {}),
        "kv": ({"g": np.array([0, 0, 1, 1, 1]),
                "k": np.array(["x", "y", "x", "z", "x"]),
                "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0])}, {}),
        "pts": (pd.DataFrame({"id": [1, 2, 3, 4],
                              "x": [0.5, 2.0, 9.5, -1.0],
                              "y": [0.5, 2.0, 9.5, 0.0]}), {}),
        "zones": (pd.DataFrame({
            "name": ["unit", "big", "holed"],
            "wkt": ["POLYGON((0 0, 1 0, 1 1, 0 1, 0 0))",
                    "POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))",
                    "POLYGON((0 0, 4 0, 4 4, 0 4, 0 0),"
                    " (1 1, 3 1, 3 3, 1 3, 1 1))"]}), {}),
        "w": (pd.DataFrame({"id": [1, 2, 3],
                            "wkt": ["POINT(1 2)", None, "GARBAGE"]}), {}),
        "gt": (pd.DataFrame({"x": [0.0], "y": [9.0]}), {}),
        "fact": (fact, {}),
        "dim": (dim, {"primary_key": ["k"], "index_keys": [["k"]]}),
        "events": (events, {}),
        "users": (users, {"index_keys": [["uname"]]}),
        "h": ({"g": rng3.integers(0, 4, 600),
               "x": pd.array(np.where(np.isnan(x), None, x), dtype=object),
               "s": np.array([f"s{i % 97}" for i in range(600)]),
               "mo": rng3.integers(1, 5, 600)}, {}),
    }


def _catalogs(indexed: bool = True):
    ref, port = RefMemory(), MemoryConnector()
    for name, (data, kw) in _frames().items():
        if not indexed:
            kw = {k: v for k, v in kw.items() if k != "index_keys"}
        ref.add_table(name, data, **kw)
        port.add_table(name, data, **kw)
    rc, pc = RefCatalog(), Catalog()
    rc.register("m", ref, default=True)
    pc.register("m", port, default=True)
    return rc, pc


@pytest.fixture(scope="module")
def catalogs():
    return _catalogs()


# -- comparison ---------------------------------------------------------------


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _same(g, w) -> bool:
    """Cell equality: floats to RTOL (NaN equals NaN, as NULL), lists in
    order, maps entry by entry in order, everything else exactly."""
    if hasattr(g, "item") and not isinstance(g, (list, dict)):
        g = g.item()
    if hasattr(w, "item") and not isinstance(w, (list, dict)):
        w = w.item()
    if _is_null(g) or _is_null(w):
        return _is_null(g) and _is_null(w)
    if isinstance(w, float) and isinstance(g, float):
        return g == w or abs(g - w) <= RTOL * abs(w)
    if isinstance(w, list):
        return (isinstance(g, list) and len(g) == len(w)
                and all(_same(a, b) for a, b in zip(g, w)))
    if isinstance(w, dict):
        return (isinstance(g, dict) and len(g) == len(w)
                and all(_same(ka, kb) and _same(va, vb)
                        for (ka, va), (kb, vb) in zip(g.items(), w.items())))
    if isinstance(w, decimal.Decimal):
        return isinstance(g, decimal.Decimal) and g == w
    return type(g) is type(w) and g == w


def assert_frames_same(got: pd.DataFrame, want: pd.DataFrame, where):
    assert list(got.columns) == list(want.columns), where
    assert len(got) == len(want), where
    for c in want.columns:
        for i, (g, w) in enumerate(zip(got[c], want[c])):
            assert _same(g, w), (where, c, i, g, w)


def _outcome(run, sql):
    try:
        return run(sql), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


def run_both(rc, pc, sqls, batch_rows=None, engines=("auto", "hash")):
    """The statements through the JAX package, then through the port once
    an engine, each sequence in order (the statements of a case share
    their tables); frames equal or the same error. Returns the JAX
    package's last frame."""
    kw = {} if batch_rows is None else {"batch_rows": batch_rows}
    rr = RefRunner(rc, RefConfig(fragment_fusion=False, **kw))
    wants = [_outcome(rr.run, sql) for sql in sqls]
    for e in engines:
        pr = LocalRunner(pc, ExecConfig(breaker_engine=e, **kw), device="cpu")
        for sql, (want, werr) in zip(sqls, wants):
            got, gerr = _outcome(pr.run, sql)
            assert gerr == werr, (sql, e)
            if werr is None:
                assert_frames_same(got, want, (sql, e))
    return wants[-1][0]


# -- the cases ----------------------------------------------------------------

# One case a local test of tests/test_structural.py, tests/test_geo.py and
# tests/test_index_join.py (named after it), and one a built aggregate.
# A case with DDL runs its statements in order under each engine, so its
# statements clean up after themselves.
CASES = {
    # tests/test_structural.py
    "ctor_and_cardinality": [
        "select array[1,2,3] as a, cardinality(array[1,2,3]) as c"],
    "subscript": ["select array[10,20,30][2] as x"],
    "element_at_negative": [
        "select element_at(array[10,20,30], -1) as x, "
        "element_at(array[10,20,30], 9) as y"],
    "table_arrays": [
        "select id, cardinality(arr) as c, arr[1] as h from t order by id"],
    "contains_position": [
        "select id, contains(arr, 5) as c5, array_position(arr, 5) as p5 "
        "from t order by id"],
    "contains_found_with_null_element": [
        "select contains(arr, 7) as c7, array_position(arr, 9) as p9 "
        "from t where id = 4"],
    "string_arrays": [
        "select id, contains(tags, 'a') as ha, tags from t order by id"],
    "min_max_sum_avg": [
        "select array_min(array[3,1,2]) as mn, array_max(array[3,1,2]) as mx,"
        " array_sum(array[3,1,2]) as s, array_average(array[3,1,3]) as av"],
    "min_with_null_element": [
        "select id, array_min(arr) as mn from t order by id"],
    "concat_slice": [
        "select array[1,2] || array[3] as c, "
        "slice(array[1,2,3,4], 2, 2) as s"],
    "distinct_sort": [
        "select array_distinct(array[3,1,3,2,1]) as d, "
        "array_sort(array[3,1,2]) as s"],
    "sequence_repeat": [
        "select sequence(2, 6, 2) as s, repeat(7, 3) as r"],
    "map_ctor_element_at": [
        "select element_at(map(array['a','b'], array[1.5,2.5]), 'b') as v"],
    "table_map": [
        "select id, cardinality(m) as c, element_at(m, 'x') as x "
        "from t order by id"],
    "map_keys_values": [
        "select map_keys(m) as mk, map_values(m) as mv from t where id = 1"],
    "constant_unnest": [
        "select x from unnest(array[10,20,30]) as u(x)"],
    "with_ordinality": [
        "select x, o from unnest(array[7,8]) with ordinality as u(x, o)"],
    "lateral_cross_join": [
        "select id, e from t cross join unnest(arr) as u(e) order by id, e"],
    "unnest_map": [
        "select id, k, v from t cross join unnest(m) as u(k, v) "
        "where id = 1 order by k"],
    "unnest_join_downstream": [
        "select s.name, count(*) as n from t cross join unnest(arr) as u(e) "
        "join s on u.e = s.id group by s.name order by s.name"],
    "unnest_aggregate": [
        "select sum(e) as s from t cross join unnest(arr) as u(e)"],
    "array_agg_global": ["select array_agg(id) as a from t"],
    "array_agg_grouped": [
        "select k, array_agg(v) as vs, count(*) as n from g group by k "
        "order by k"],
    "cardinality_of_array_agg": [
        "select cardinality(array_agg(id)) as c from t"],
    "array_through_join": [
        "select s.name, t.arr from t join s on t.id = s.id where s.id = 2"],
    "array_through_sort_limit": [
        "select id, arr from t order by id desc limit 2"],
    "map_through_filter": [
        "select m from t where element_at(m, 'x') > 2"],
    "ctas_array_roundtrip": [
        "drop table if exists ctas_arr",
        "create table ctas_arr as select id, arr, tags, m from t",
        "select id, arr, tags, cardinality(m) as cm, m from ctas_arr "
        "order by id",
        "drop table ctas_arr"],
    "ctas_array_agg_roundtrip": [
        "drop table if exists ctas_agg",
        "create table ctas_agg as select array_agg(id) as ids from t",
        "select cardinality(ids) as c from ctas_agg",
        "drop table ctas_agg"],
    "map_cardinality_mismatch_yields_null": [
        "select element_at(map(array[1,2], array[9]), 2) as v, "
        "element_at(map(array[1,2], array[9]), 1) as w"],
    "array_literal_not_in_column_dict": [
        "select array['zzz_total', name][1] as x, "
        "array['zzz_total', name][2] as y from s where id = 1"],
    "slice_negative_out_of_range_empty": [
        "select slice(array[1,2,3], -4, 3) as a, "
        "slice(array[1,2,3], -2, 2) as b"],
    "array_comparison_rejected": ["select * from t where arr = arr"],
    "group_by_array_rejected": ["select count(*) from t group by arr"],
    "transform": ["select transform(array[1,2,3], x -> x * 10) as a"],
    "transform_captures_outer_column": [
        "select id, transform(arr, x -> x + id) as a from t where id = 2"],
    "transform_null_elements": [
        "select transform(arr, x -> coalesce(x, 0)) as a from t "
        "where id = 4"],
    "transform_string_body": [
        "select transform(tags, x -> upper(x)) as a from t where id = 1"],
    "filter": ["select filter(array[5,1,8,2], x -> x > 3) as a"],
    "filter_keeps_order_and_sizes": [
        "select id, cardinality(filter(arr, x -> x > 2)) as c from t "
        "order by id"],
    "reduce": [
        "select reduce(array[1,2,3,4], 0, (s, x) -> s + x) as s, "
        "reduce(array[2,3], 1, (s, x) -> s * x) as p"],
    "match_functions": [
        "select any_match(array[1,2,3], x -> x > 2) as a, "
        "all_match(array[1,2,3], x -> x > 0) as b, "
        "none_match(array[1,2,3], x -> x > 9) as c, "
        "any_match(array[1,2,3], x -> x > 9) as d"],
    "lambda_param_shadows_column": [
        "select transform(arr, id -> id * 0) as a from t where id = 1"],
    "nested_higher_order": [
        "select reduce(filter(arr, x -> x is not null), 0, "
        "(s, x) -> s + x) as s from t order by id"],
    "transform_values": [
        "select transform_values(map(array['a','b'], array[1.0, 2.0]), "
        "(k, v) -> v * 10) as m"],
    "map_filter": [
        "select map_filter(map(array['a','b','c'], array[1, 2, 3]), "
        "(k, v) -> v > 1) as m"],
    "map_filter_on_key": [
        "select map_filter(m, (k, v) -> k = 'x') as mm from t where id = 1"],
    "transform_values_on_table_map": [
        "select id, transform_values(m, (k, v) -> v + id) as mm from t "
        "where id = 2"],
    "union_intersect_except": [
        "select array_union(array[1,2,2], array[2,3]) as u, "
        "array_intersect(array[1,2,3], array[2,3,4]) as i, "
        "array_except(array[1,2,3], array[2]) as e, "
        "arrays_overlap(array[1,2], array[2,9]) as o1, "
        "arrays_overlap(array[1,2], array[8,9]) as o2"],
    "string_array_set_ops_cross_dictionary": [
        "select id, array_intersect(tags, array['a', 'zzz']) as i from t "
        "order by id"],
    "map_concat": [
        "select map_concat(map(array['a','b'], array[1,2]), "
        "map(array['b','c'], array[20,30])) as m"],
    "map_agg": ["select map_agg(name, id) as m from s"],
    "map_agg_grouped": [
        "select g, map_agg(k, v) as m from kv group by g order by g"],
    "zip_with": [
        "select zip_with(array[1,2,3], array[10,20,30], (x, y) -> x + y) "
        "as z"],
    "zip_with_uneven_pads_null": [
        "select zip_with(array[1,2,3], array[10], "
        "(x, y) -> coalesce(y, 0) + x) as z"],
    "zip_with_table_columns": [
        "select id, zip_with(arr, arr, (x, y) -> x * y) as sq from t "
        "where id = 2"],
    # tests/test_geo.py
    "scalar_metrics": [
        "select name, st_area(st_geometryfromtext(wkt)) a,"
        " st_perimeter(st_geometryfromtext(wkt)) p,"
        " st_npoints(st_geometryfromtext(wkt)) n,"
        " st_xmin(st_geometryfromtext(wkt)) x0,"
        " st_xmax(st_geometryfromtext(wkt)) x1 from zones order by name"],
    "point_in_polygon_join_with_holes": [
        "select p.id, z.name from pts p, zones z"
        " where st_contains(st_geometryfromtext(z.wkt), st_point(p.x, p.y))"
        " order by p.id, z.name"],
    "within_and_intersects": [
        "select p.id from pts p, zones z where z.name = 'unit' and"
        " st_within(st_point(p.x, p.y), st_geometryfromtext(z.wkt))"
        " order by p.id",
        "select p.id from pts p, zones z where z.name = 'unit' and"
        " st_intersects(st_point(p.x, p.y), st_geometryfromtext(z.wkt))"
        " order by p.id"],
    "distance": [
        "select id, st_distance(st_point(x, y), st_point(0, 0)) d,"
        " st_distance(st_geometryfromtext("
        "'POLYGON((0 0, 1 0, 1 1, 0 1, 0 0))'), st_point(x, y)) dp"
        " from pts order by id"],
    "multipolygon_linestring_centroid": [
        "select st_area(st_geometryfromtext('MULTIPOLYGON(((0 0, 1 0, 1 1,"
        " 0 1, 0 0)), ((5 5, 7 5, 7 7, 5 7, 5 5)))')) a,"
        " st_length(st_geometryfromtext('LINESTRING(0 0, 3 0, 3 4)')) l,"
        " st_x(st_centroid(st_geometryfromtext("
        "'POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))'))) cx,"
        " st_y(st_point(3.5, -2.5)) py",
        "select st_contains(st_geometryfromtext('MULTIPOLYGON(((0 0, 1 0,"
        " 1 1, 0 1, 0 0)), ((5 5, 7 5, 7 7, 5 7, 5 5)))'), st_point(6, 6))"
        " c1, st_contains(st_geometryfromtext('MULTIPOLYGON(((0 0, 1 0,"
        " 1 1, 0 1, 0 0)), ((5 5, 7 5, 7 7, 5 7, 5 5)))'), st_point(3, 3))"
        " c2"],
    "astext_and_great_circle": [
        "select st_astext(st_geometryfromtext(wkt)) t,"
        " great_circle_distance(36.12, -86.67, 33.94, -118.40) gc"
        " from zones where name = 'unit'"],
    "geo_errors": [
        "select st_geometryfromtext(wkt) g from zones",
        "select st_contains(st_point(1, 1), 2) c from pts",
        "select st_area(st_geometryfromtext(id)) a from pts",
        "select st_point(1) p from pts"],
    "geo_review_regressions": [
        "select id, st_x(st_geometryfromtext(wkt)) x from w order by id",
        "select st_distance(st_geometryfromtext("
        "'LINESTRING(0 0, 10 0, 10 10)'), st_point(0, 9)) d,"
        " st_contains(st_geometryfromtext("
        "'LINESTRING(0 0, 10 0, 10 10)'), st_point(5, 2)) c from gt",
        "select st_contains(st_point(x, y), st_geometryfromtext("
        "'POLYGON((0 0, 1 0, 1 1, 0 1, 0 0))')) c from gt",
        "select cast(wkt as geometry) g from w",
        "create table m.geo_t (g geometry)"],
    # the built aggregates
    "agg_array_agg": [
        "select g, array_agg(x) as xs, array_agg(s) as ss, "
        "cardinality(array_agg(mo)) as n from h group by g order by g"],
    "agg_map_agg": [
        "select g, map_agg(s, x) as m, map_agg(mo, s) as ms from h "
        "group by g order by g"],
    "agg_numeric_histogram": [
        "select g, numeric_histogram(6, x) as hist from h group by g "
        "order by g",
        "select numeric_histogram(3, x) as hist from h where x is null"],
    "agg_tdigest_agg": [
        "select g, value_at_quantile(tdigest_agg(x), 0.5) as q50, "
        "value_at_quantile(tdigest_agg(x), 0.9) as q90 from h "
        "group by g order by g"],
    "agg_approx_set": [
        "select g, cardinality(approx_set(s)) as c, "
        "cardinality(approx_set(x)) as cx from h group by g order by g"],
    "agg_merge": [
        "select mo, cardinality(merge(a)) as c, "
        "value_at_quantile(merge(d), 0.5) as q from (select mo, g, "
        "approx_set(s) a, tdigest_agg(x) d from h group by mo, g) u "
        "group by mo order by mo"],
}

INDEX_SQL = ("select name, sum(v) as sv, count(*) as n from fact "
             "join dim on fact.k = dim.k group by name order by name")
INDEX_LEFT_SQL = ("select count(*) as n, count(w) as nw from fact "
                  "left join dim on fact.k = dim.k")
INDEX_STRING_SQL = ("select sum(cnt * score) as s from events e "
                    "join users u on e.uname = u.uname")


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_reference(catalogs, case):
    rc, pc = catalogs
    run_both(rc, pc, CASES[case],
             batch_rows=256 if case in ("point_in_polygon_join_with_holes",
                                         "within_and_intersects") else None)


def test_type_parsing():
    from presto_tpu.types import parse_type as ref_parse
    from presto_tpu_torch.types import parse_type

    for s in ("array(bigint)", "map(varchar, array(bigint))",
              "row(a bigint, b varchar)", "map(bigint,double)"):
        assert str(parse_type(s)) == str(ref_parse(s))
        assert type(parse_type(s)).__name__ == type(ref_parse(s)).__name__


# tests/test_index_join.py, its four local tests


def _strip_marks(text: str):
    import re

    return [re.sub(r"\s+\[fragment=[^\]]*\]", "", ln)
            for ln in text.splitlines()]


def test_explain_shows_index_join(catalogs):
    rc, pc = catalogs
    pr = LocalRunner(pc, ExecConfig(batch_rows=1 << 10), device="cpu")
    rr = RefRunner(rc, RefConfig(batch_rows=1 << 10))
    plan = pr.explain(INDEX_SQL)
    assert "IndexJoin" in plan and "dim" in plan
    assert plan.splitlines() == _strip_marks(rr.explain(INDEX_SQL))
    _, plain = _catalogs(indexed=False)
    assert "IndexJoin" not in LocalRunner(
        plain, ExecConfig(batch_rows=1 << 10), device="cpu").explain(INDEX_SQL)


@pytest.mark.parametrize("sql", [INDEX_SQL, INDEX_LEFT_SQL],
                         ids=["results_match_hash_join",
                              "left_index_join_preserves_probe_rows"])
def test_index_join_matches_reference_and_hash_join(catalogs, sql):
    rc, pc = catalogs
    want = run_both(rc, pc, [sql], batch_rows=1 << 10)
    _, plain = _catalogs(indexed=False)
    got = LocalRunner(plain, ExecConfig(batch_rows=1 << 10),
                      device="cpu").run(sql)
    assert_frames_same(got, want, sql)
    if sql == INDEX_LEFT_SQL:
        assert int(want.n[0]) == N


def test_string_key_index(catalogs):
    rc, pc = catalogs
    pr = LocalRunner(pc, ExecConfig(batch_rows=1 << 9), device="cpu")
    assert "IndexJoin" in pr.explain(INDEX_STRING_SQL)
    run_both(rc, pc, [INDEX_STRING_SQL], batch_rows=1 << 9)


@pytest.mark.parametrize("keys", [["i"], ["s"], ["s", "i"], ["f"]],
                         ids=["int", "string", "string_int", "float_nan"])
def test_index_lookup_matches_reference(keys):
    """A connector index's lookup, called directly: duplicate keys, NULL
    and NaN keys in the table, probes that repeat, miss or are NaN; the
    same rows in the same order as the JAX package's index."""
    rng = np.random.default_rng(23)
    n = 400
    s = np.array([f"s{i}" for i in rng.integers(0, 40, n)], dtype=object)
    s[rng.random(n) < 0.1] = None
    f = rng.integers(0, 30, n) / 2
    f[rng.random(n) < 0.05] = np.nan
    df = pd.DataFrame({"i": rng.integers(0, 60, n), "s": s, "f": f,
                       "v": rng.integers(0, 1000, n)})
    m = 80
    probe = {"i": rng.integers(-5, 70, m),
             "s": np.array([f"s{i}" for i in rng.integers(0, 50, m)],
                           dtype=object),
             "f": np.where(rng.random(m) < 0.1, np.nan,
                           rng.integers(-2, 34, m) / 2)}
    probe = {c: probe[c] for c in keys}
    frames = []
    for conn in (RefMemory(), MemoryConnector()):
        conn.add_table("t", df, index_keys=[keys])
        idx = conn.get_index(conn.get_table("t"), keys)
        frames.append(idx.lookup(probe, list(df.columns)).to_pandas())
    want, got = frames
    assert len(want) > 0, keys
    assert_frames_same(got, want, keys)


# TPC-H SF 0.01: the shapes chip_smoke.py's structural phase runs at SF 1

CUST_ARRAYS = """
    select o_custkey, cardinality(ks) as n, array_max(ps) as top,
           contains(ks, 7) as has7, array_sort(ks)[1] as first_key,
           slice(array_sort(ps), 1, 2) as low2,
           cardinality(array_distinct(transform(ks, k -> k % 4))) as mods,
           cardinality(filter(ks, k -> k % 2 = 0)) as evens,
           reduce(ks, 0, (s, k) -> s + k) as ksum,
           zip_with(ks, ps, (k, p) -> k + p)[1] as kp
    from (select o_custkey, array_agg(o_orderkey) as ks,
                 array_agg(o_totalprice) as ps
          from orders group by o_custkey) t
    order by o_custkey
"""
UNNEST_BACK = """
    select count(*) as n, sum(k) as sk, max(o) as mo
    from (select o_custkey, array_agg(o_orderkey) as ks
          from orders group by o_custkey) t
    cross join unnest(ks) with ordinality as u(k, o)
"""
IX_INNER = """
    select o_orderpriority, count(*) as n,
           sum(l_extendedprice * l_discount) as revenue
    from lineitem join idx.orders on l_orderkey = o_orderkey
    where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
      and l_discount between 0.05 and 0.07 and l_quantity < 24
    group by o_orderpriority order by o_orderpriority
"""
TPCH_CASES = {"cust_arrays": CUST_ARRAYS, "unnest_back": UNNEST_BACK,
              "ix_inner": IX_INNER}


@pytest.fixture(scope="module")
def tpch_catalogs():
    """SF 0.01 TPC-H in both packages, plus a catalog `idx` holding orders
    with an index on o_orderkey."""
    ref, port = ref_tpch_catalog(0.01), tpch_catalog(0.01)
    ref.connectors["tpch"].get_table("orders")
    orders = copy.copy(ref.connectors["tpch"].tables["orders"])
    orders.index_keys = [["o_orderkey"]]
    rconn = RefMemory("idx")
    rconn.tables["orders"] = orders
    ref.register("idx", rconn)
    port.register("idx", convert.connector_from_tables({"orders": orders},
                                                       name="idx"))
    return ref, port


@pytest.mark.parametrize("q", list(TPCH_CASES))
def test_tpch_structural_matches_reference(tpch_catalogs,
                                           reference_frames_dir, q):
    ref, port = tpch_catalogs
    sql = TPCH_CASES[q]
    want = reference_frame(ref, f"structural_{q}", reference_frames_dir,
                           sql=sql)
    assert len(want) > 0
    for engine in ("auto", "hash"):
        pr = LocalRunner(port, ExecConfig(breaker_engine=engine),
                         device="cpu")
        if q == "ix_inner":
            assert "IndexJoin" in pr.explain(sql)
        assert_frames_same(pr.run(sql), want, (q, engine))


# -- structural planes against the JAX package's functions ---------------------


def _planes(seed: int, cap: int = 64, w: int = 6, dtype=np.float64):
    """Seeded [cap, w] planes: ragged sizes (0..w), NULL elements, and for
    floats NaN, -0.0 and +0.0 among repeated values."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.0, 3.0, 1.5, 7.25])
        vals = rng.choice(pool, size=(cap, w)).astype(dtype)
    else:
        vals = rng.integers(-3, 4, size=(cap, w)).astype(dtype)
    sizes = rng.integers(0, w + 1, size=cap).astype(np.int32)
    evalid = rng.random((cap, w)) > 0.2
    return vals, sizes, evalid


def _as_lists(values, sizes, evalid):
    """Each row's present elements, NULL as None and NaN as 'nan' (so -0.0
    and +0.0 compare equal and NaN equals NaN)."""
    values, sizes = np.asarray(values), np.asarray(sizes)
    ev = (np.ones(values.shape, bool) if evalid is None
          else np.asarray(evalid))
    out = []
    for i in range(len(sizes)):
        row = []
        for j in range(int(sizes[i])):
            if not ev[i, j]:
                row.append(None)
            elif isinstance(values[i, j], float) and np.isnan(values[i, j]):
                row.append("nan")
            else:
                row.append(float(values[i, j]))
        out.append(row)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_planes_match_reference_functions(dtype):
    from presto_tpu.expr import structural as R
    from presto_tpu_torch.expr import structural as P

    def both(seed):
        v, s, e = _planes(seed, dtype=dtype)
        return (R.StructVal(jnp.asarray(v), jnp.asarray(s), jnp.asarray(e)),
                P.StructVal(torch.from_numpy(v), torch.from_numpy(s),
                            torch.from_numpy(e)))

    def same(r, p):
        assert _as_lists(r.values, r.sizes, r.evalid) == _as_lists(
            p.values.numpy(), p.sizes.numpy(),
            None if p.evalid is None else p.evalid.numpy())

    ra, pa = both(1)
    rb, pb = both(2)
    same(R.array_sort(ra), P.array_sort(pa))
    same(R.array_distinct(ra), P.array_distinct(pa))
    same(R.array_union(ra, rb), P.array_union(pa, pb))
    same(R.array_intersect(ra, rb), P.array_intersect(pa, pb))
    same(R.array_except(ra, rb), P.array_except(pa, pb))
    same(R.concat_arrays(ra, rb), P.concat_arrays(pa, pb))
    np.testing.assert_array_equal(np.asarray(R.arrays_overlap(ra, rb)),
                                  P.arrays_overlap(pa, pb).numpy())
    keep = np.random.default_rng(3).random(pa.values.shape) > 0.5
    same(R.filter_elements(ra, jnp.asarray(keep)),
         P.filter_elements(pa, torch.from_numpy(keep)))
    for want_min in (True, False):
        rv, rvalid = R.array_minmax(ra, None, want_min)
        pv, pvalid = P.array_minmax(pa, None, want_min)
        np.testing.assert_array_equal(np.asarray(rvalid), pvalid.numpy())
        ok = np.asarray(rvalid)
        np.testing.assert_array_equal(np.asarray(rv)[ok], pv.numpy()[ok])
    # a map's planes: integer keys with duplicates across the two maps
    kr = np.random.default_rng(4).integers(0, 5, pa.values.shape)
    rm = R.StructVal(ra.values, ra.sizes, ra.evalid, jnp.asarray(kr))
    pm = P.StructVal(pa.values, pa.sizes, pa.evalid, torch.from_numpy(kr))
    rmc, pmc = R.map_concat(rm, rm), P.map_concat(pm, pm)
    same(rmc, pmc)
    assert _as_lists(rmc.keys, rmc.sizes, None) == _as_lists(
        pmc.keys.numpy(), pmc.sizes.numpy(), None)


def test_unnest_and_concat_columns_match_reference():
    from presto_tpu.batch import Batch as RBatch
    from presto_tpu.batch import Column as RColumn
    from presto_tpu.batch import concat_columns as ref_concat
    from presto_tpu.exec.runtime import unnest_expand as ref_unnest
    from presto_tpu.plan.nodes import TableScan as RScan
    from presto_tpu.plan.nodes import Unnest as RUnnest
    from presto_tpu.types import ArrayType as RArray
    from presto_tpu.types import BIGINT as RBIGINT
    from presto_tpu.types import DOUBLE as RDOUBLE
    from presto_tpu_torch.batch import Batch, Column, concat_columns
    from presto_tpu_torch.exec.runtime import unnest_expand
    from presto_tpu_torch.plan.nodes import TableScan, Unnest
    from presto_tpu_torch.types import BIGINT, DOUBLE, ArrayType

    va, sa, ea = _planes(5, cap=32, w=4)
    vb, sb, eb = _planes(6, cap=32, w=6, dtype=np.int64)
    ids = np.arange(32, dtype=np.int64)
    live = np.random.default_rng(7).random(32) > 0.25
    rvalid = np.random.default_rng(8).random(32) > 0.1

    def build(B, C, asarr, at, a_elem, b_elem, bigint):
        b = B(["id", "a", "b"], [bigint, at(a_elem), at(b_elem)],
              [C(asarr(ids)),
               C(asarr(va), asarr(rvalid), None, asarr(sa), asarr(ea)),
               C(asarr(vb), None, None, asarr(sb), asarr(eb))],
              asarr(live), {})
        return b

    rb = build(RBatch, RColumn, jnp.asarray, RArray, RDOUBLE, RBIGINT,
               RBIGINT)
    pb = build(Batch, Column, torch.from_numpy, ArrayType, DOUBLE, BIGINT,
               BIGINT)

    def node(U, S, at, de, bi):
        child = S(catalog="m", table="x", assignments={},
                  output=[("id", bi), ("a", at(de)), ("b", at(bi))])
        return U(child=child, sources=["a", "b"], replicate=["id"],
                 out_syms=[["ea"], ["eb"]], out_types=[[de], [bi]],
                 ordinality_sym="o")

    want = ref_unnest(node(RUnnest, RScan, RArray, RDOUBLE, RBIGINT),
                      rb).to_pandas()
    got = unnest_expand(node(Unnest, TableScan, ArrayType, DOUBLE, BIGINT),
                        pb).to_pandas()
    assert_frames_same(got, want, "unnest")

    rc = ref_concat([rb.column("a"), rb.column("b")], [32, 32])
    pc = concat_columns([pb.column("a"), pb.column("b")], [32, 32])
    assert tuple(pc.values.shape) == tuple(rc.values.shape)
    assert _as_lists(rc.values, rc.sizes, rc.evalid) == _as_lists(
        pc.values.numpy(), pc.sizes.numpy(), pc.evalid.numpy())
    np.testing.assert_array_equal(np.asarray(rc.validity),
                                  pc.validity.numpy())


def test_numeric_histogram_rounds_equal_sequential_merges():
    """The port's round-wise histogram merges make the JAX package's
    sequential closest-pair merges, to the bit, on ties and repeats."""
    from presto_tpu_torch.exec.runtime import merge_buckets

    def sequential(xs, b):
        u, cnt = np.unique(np.asarray(xs), return_counts=True)
        u, cnt = u.astype(np.float64), cnt.astype(np.float64)
        while len(u) > b:
            i = int(np.argmin(np.diff(u)))
            tot = cnt[i] + cnt[i + 1]
            merged = (u[i] * cnt[i] + u[i + 1] * cnt[i + 1]) / tot
            u = np.concatenate([u[:i], [merged], u[i + 2:]])
            cnt = np.concatenate([cnt[:i], [tot], cnt[i + 2:]])
        return u, cnt

    rng = np.random.default_rng(0)
    for t in range(300):
        n, b = int(rng.integers(1, 120)), int(rng.integers(1, 25))
        xs = [rng.normal(size=n), rng.integers(0, 15, n).astype(float),
              np.round(rng.uniform(0, 5, n), 1),
              np.cumsum(rng.integers(0, 3, n)).astype(float) ** 1.5][t % 4]
        u, cnt = np.unique(xs, return_counts=True)
        want, got = sequential(xs, b), merge_buckets(u, cnt, b)
        assert np.array_equal(want[0], got[0]), (t, n, b)
        assert np.array_equal(want[1], got[1]), (t, n, b)
