"""The port's SemiJoin, outer joins, aggregates, expressions, scalar
subqueries, LIMIT and column-less scans against the JAX package, on small
in-memory tables (the same data registered in both packages' memory
connectors).

Each SQL runs once through the JAX package's per-batch path and through
the port under breaker_engine sort and hash; every frame must equal the
JAX package's, row for row (every query orders its rows completely).
Tolerance: exact for integers, decimals, dates, strings, booleans, keys
and counts; the float columns (`f`'s min/max and the `avg` of
scalar_value's subquery) at rtol=1e-12, the tolerance the JAX package
allows between its own engines (tests/test_kernels.py).
Scan batches hold 128 rows, so every table but `e` spans several batches
or shares one with a join's other side.
"""

import numpy as np
import pytest

from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.types import parse_type
from test_torch_tpch import assert_frames_equal

BATCH_ROWS = 128


def _dates(days):
    return np.array([np.datetime64("1970-01-01") + np.timedelta64(d, "D")
                     for d in days], dtype="datetime64[D]")


def _tables():
    """name -> (columns, {column: SQL type}) for the columns whose type is
    not inferred."""
    a = {
        "id": list(range(12)),
        "k": [1, 2, 2, 3, None, 5, 6, 7, 8, None, 10, 11],
        "v": ["1.50", "-2.25", None, "3.00", "4.75", "0.10", "-7.00", None,
              "12.34", "5.55", "0.00", "9.99"],
        "s": ["apple", "banana", None, "a%b", "cherry", "apple", "x_y", "bx",
              None, "date", "ab", "b!c"],
        "d": _dates([0, -1, 59, 789, 10957, 11016, -719162, 20000, 365,
                     730, 1095, 11322]),
        "f": [0.5, 1.5, 2.5, -1.0, 3.25, 0.0, 7.5, 1.0, 2.0, -3.5, 4.0, 1.25],
        "b": [True, False, True, True, False, False, True, False, True,
              False, True, True],
    }
    b = {
        "id": list(range(9)),
        "k": [1, 1, 2, None, 3, 3, 3, 12, 5],
        "s": ["apple", "kiwi", "banana", "x_y", None, "apple", "zz", "cherry",
              "ab"],
        "w": [10, 11, 20, 30, 40, 41, 42, 50, 60],
    }
    i = np.arange(400)
    r = {"id": i, "k": i % 25, "w": i % 9}
    j = np.arange(200)
    p = {"id": j, "k": j % 30, "w": j % 5}
    e = {"k": np.array([], np.int64), "w": np.array([], np.int64)}
    return {"a": (a, {"v": "decimal(12,2)", "d": "date"}), "b": (b, {}),
            "r": (r, {}), "p": (p, {}), "e": (e, {})}


@pytest.fixture(scope="module")
def catalogs():
    rc, pc = RefMemory(), MemoryConnector()
    for name, (data, types) in _tables().items():
        rc.add_table(name, dict(data), {c: ref_type(t) for c, t in types.items()})
        pc.add_table(name, dict(data), {c: parse_type(t) for c, t in types.items()})
    ref, port = RefCatalog(), Catalog()
    ref.register("m", rc, default=True)
    port.register("m", pc, default=True)
    return ref, port


CASES = {
    # -- SemiJoin ----------------------------------------------------------
    "in_duplicate_build_keys":
        "select id, k from a where k in (select k from b) order by id",
    "exists": "select id from a where exists "
              "(select * from b where b.k = a.k) order by id",
    "not_in_null_probe_keys":
        "select id from a where k not in "
        "(select k from b where k is not null) order by id",
    "not_in_null_build_key":
        "select id from a where k not in (select k from b) order by id",
    "not_exists_null_keys": "select id from a where not exists "
                            "(select * from b where b.k = a.k) order by id",
    "in_empty_table": "select id from a where k in (select k from e) order by id",
    "not_in_empty_table":
        "select id from a where k not in (select k from e) order by id",
    "in_no_build_batch":
        "select id from a where k in "
        "(select b.k from b join e on b.w = e.w) order by id",
    "not_in_no_build_batch":
        "select id from a where k not in "
        "(select b.k from b join e on b.w = e.w) order by id",
    "in_strings_other_dictionary":
        "select id, s from a where s in (select s from b) order by id",
    "exists_residual_chunks":
        "select p.w, count(*) c from p where exists (select * from r "
        "where r.k = p.k and r.w <> p.w) group by p.w order by p.w",
    "not_exists_residual_chunks":
        "select id from p where not exists (select * from r "
        "where r.k = p.k and r.w > p.w + 4) order by id",
    # -- outer joins --------------------------------------------------------
    "left_duplicate_build_keys":
        "select a.id, b.w from a left join b on a.k = b.k "
        "order by a.id, b.w",
    "left_unique_build":
        "select a.id, x.m from a left join "
        "(select k, max(w) m from b group by k) x on a.k = x.k order by a.id",
    "right": "select a.id, b.id bid from a right join b on a.k = b.k "
             "order by b.id, a.id",
    "full": "select a.id, b.id bid, b.w from a full join b on a.k = b.k "
            "order by a.id, b.id",
    "full_unique_build":
        "select a.id, x.k, x.m from a full join "
        "(select k, max(w) m from b group by k) x on a.k = x.k "
        "order by a.id, x.k",
    "left_string_key": "select b.id, a.id aid, a.s from b left join a "
                       "on b.s = a.s order by b.id, a.id",
    "left_empty_build":
        "select a.id, x.w from a left join (select k, w from b where w < 0) x "
        "on a.k = x.k order by a.id",
    "full_empty_build":
        "select a.id, x.w from a full join (select k, w from b where w < 0) x "
        "on a.k = x.k order by a.id",
    "left_no_build_batch":
        "select a.id, x.w from a left join "
        "(select b.k, b.w from b join e on b.k = e.k) x on a.k = x.k "
        "order by a.id",
    # -- aggregates ---------------------------------------------------------
    "min_max_global": "select min(k) k0, max(k) k1, min(f) f0, max(f) f1, "
                      "min(v) v0, max(v) v1, min(d) d0, max(d) d1, "
                      "min(s) s0, max(s) s1 from a",
    "min_max_grouped": "select b, min(s) s0, max(s) s1, min(v) v0, "
                       "max(d) d1, min(k) k0 from a group by b order by b",
    "min_max_hash_keys": "select k, min(w) w0, max(s) s1, count(s) n from b "
                         "group by k order by k",
    "counts": "select count(k) nk, count(s) ns, count(v) nv, count(*) n, "
              "count_if(f > 1) nf from a",
    "counts_grouped": "select s, count(k) nk, count_if(f > 1) nf, "
                      "count(*) n from a group by s order by s",
    "aggregates_of_no_row": "select min(k) k0, max(s) s1, count(k) nk, "
                            "count_if(b) nb, count(*) n from a where k > 100",
    "bool_and_or_arbitrary": "select b, bool_and(f > 0) ba, "
                             "bool_or(f > 5) bo, arbitrary(id) i "
                             "from a group by b order by b",
    "distinct": "select distinct s from a order by s",
    "distinct_two_keys": "select distinct k, b from a order by k, b",
    "group_by_without_aggregates": "select k from b group by k order by k",
    "count_distinct": "select b, count(distinct k) n from a group by b "
                      "order by b",
    # -- expressions --------------------------------------------------------
    "null_functions": "select id, k is null kn, s is not null sn, "
                      "coalesce(k, -1) ck, coalesce(v, 0) cv, "
                      "nullif(k, 2) nk from a order by id",
    "case": "select id, case when f > 2 then 'hi' when f > 1 then 'mid' "
            "else 'lo' end c, case when k is null then 0 else k * 2 end n "
            "from a order by id",
    "case_group_key": "select case when f > 2 then 'hi' else 'lo' end c, "
                      "count(*) n from a group by 1 order by 1",
    "like": "select id, s like 'a%' l1, s like '_a%' l2, "
            "s like '%!%%' escape '!' l3, s not like '%a%' l4, "
            "s like 'b!!c' escape '!' l5 from a order by id",
    "substr_group_key": "select substr(s, 1, 2) p, count(*) n from a "
                        "group by 1 order by 1",
    "substr_negative_and_in": "select id, substr(s, -2) t from a "
                              "where substr(s, 2, 1) in ('p', 'a', '%') "
                              "order by id",
    "year_month_day": "select id, year(d) y, month(d) m, day(d) dd from a "
                      "order by id",
    # -- scalar subqueries, LIMIT, scans of no column -----------------------
    "scalar_over_no_row_binds_null":
        "select count(*) c from a where k > (select max(k) from b where w < 0)",
    "scalar_null_in_select_list":
        "select id, (select max(w) from b where w < 0) m from a order by id",
    "scalar_value": "select id from a where f > (select avg(f) from a) "
                    "order by id",
    "limit": "select id, k from a limit 4",
    "limit_after_filter": "select id from r where k > 20 limit 7",
    "count_star_reads_no_column": "select count(*) n from r",
}


@pytest.mark.parametrize("name", list(CASES))
def test_sql_matches_reference(catalogs, name):
    ref, port = catalogs
    sql = CASES[name]
    cfg = dict(batch_rows=BATCH_ROWS)
    want = RefRunner(ref, RefConfig(fragment_fusion=False, **cfg)).run(sql)
    assert want.columns.is_unique  # every output column is compared
    for engine in ("sort", "hash"):
        got = LocalRunner(port, ExecConfig(breaker_engine=engine, **cfg),
                          device="cpu").run(sql)
        assert_frames_equal(got, want, (name, engine))


@pytest.mark.parametrize("sql, rows", [
    ("select id from a where k = (select k from b where w < 0)", 0),
    ("select id from a where k = (select k from b)", 9),
], ids=["no_row", "many_rows"])
def test_scalar_subquery_of_not_one_row_raises(catalogs, sql, rows):
    """As in the JAX package: a scalar subquery must give exactly one row."""
    ref, port = catalogs
    with pytest.raises(RuntimeError, match=f"returned {rows} rows"):
        RefRunner(ref, RefConfig(fragment_fusion=False)).run(sql)
    for engine in ("sort", "hash"):
        with pytest.raises(RuntimeError, match=f"returned {rows} rows"):
            LocalRunner(port, ExecConfig(breaker_engine=engine),
                        device="cpu").run(sql)


def test_residual_semijoin_spans_chunks(catalogs):
    """Each probe batch of the residual cases expands to more candidate
    pairs than one chunk (the probe batch's capacity) holds, so the
    any-reduction really runs across chunks."""
    _, port = catalogs
    tbl = port.connectors["m"].tables
    pk, rk = tbl["p"].arrays["k"], tbl["r"].arrays["k"]
    assert len(pk) > BATCH_ROWS  # two probe batches
    for lo in range(0, len(pk), BATCH_ROWS):
        pairs = sum(int((rk == k).sum()) for k in pk[lo:lo + BATCH_ROWS])
        assert pairs > 2 * BATCH_ROWS
