"""The port's SemiJoin, outer joins, aggregates, expressions, scalar
subqueries, LIMIT, column-less scans, windows, set operations, nested-loop
joins, numeric and date functions, string functions and compares, casts
from and to varchar, SELECT without FROM and VALUES, approx_distinct,
geometric_mean and checksum, and varbinary, ipaddress and ipprefix
columns against the JAX package, on small in-memory tables (the same data
registered in both packages' memory connectors).

Each SQL runs once through the JAX package's per-batch path and through
the port under breaker_engine sort and hash; every frame must equal the
JAX package's, row for row (a query without ORDER BY gives its rows in
the order both packages produce them: the window's sort, the set
operation's, the scan's). Tolerance: exact for integers, decimals, dates,
strings, booleans, keys and counts; float columns at rtol=1e-12, the
tolerance the JAX package allows between its own engines
(tests/test_kernels.py).
Scan batches hold 128 rows, so every table but the smallest spans several
batches or shares one with a join's other side; the window, set-operation
and nested-loop cases take their source file's batch size (256, 1,024 and
256 rows).

The window, set-operation and nested-loop cases are the LocalRunner
queries of tests/test_window.py, tests/test_setops.py and
tests/test_nljoin.py over the same generated tables (renamed w*, s*/m*
and n*), plus NaN, +-inf and -0.0 keys; the SQL those files expect the
planner to refuse raises the same error in the port. The string, cast,
sketch and column-type cases take their SQL and tables from
tests/test_functions.py, test_function_breadth.py, test_function_batch2.py,
test_host_project.py, test_time_varbinary.py, test_ipaddress.py,
test_sketches.py and test_hll_values.py, several functions to a SELECT.
approx_distinct and checksum are exact here: both packages compute the
same 64-bit hashes.
"""

import numpy as np
import pytest
import torch

from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.types import parse_type
from test_torch_tpch import assert_frames_equal, one_torch_thread  # noqa: F401

BATCH_ROWS = 128
# the batch sizes of tests/test_window.py, test_setops.py, test_nljoin.py
SOURCE_BATCH_ROWS = {"win": 256, "set": 1 << 10, "nl": 1 << 8}


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
    out = {"a": (a, {"v": "decimal(12,2)", "d": "date"}), "b": (b, {}),
           "r": (r, {}), "p": (p, {}), "e": (e, {})}
    out.update(_window_tables())
    out.update(_setop_tables())
    out.update(_nljoin_tables())
    out.update(_surface_tables())
    return out


def _surface_tables():
    """The tables of tests/test_time_varbinary.py, test_ipaddress.py,
    test_functions.py (its URL table and varchar casts),
    test_function_breadth.py (its JSON table), and a float32 NaN beside
    NULLs."""
    return {
        "blobs": ({"k": [1, 2, 3, 4],
                   "data": [b"hello", b"\x00\xff\x10", b"caf\xc3\xa9",
                            None]}, {}),
        "ips": ({"id": list(range(7)),
                 "ip": ["10.0.0.1", "::ffff:10.0.0.1", "10.0.0.2",
                        "10.0.255.255", "10.1.0.0", "2001:db8::1", None]},
                {"ip": "ipaddress"}),
        "nets": ({"net": ["10.0.0.0/8", "10.0.0.0/16", "192.168.0.0/16",
                          "9.0.0.0/8"]}, {"net": "ipprefix"}),
        "raw": ({"s": ["1.2.3.4", "not-an-ip", "999.1.1.1"]}, {}),
        "u": ({"id": [0, 1, 2, 3],
               "url": ["https://example.com/a/b?x=1#frag",
                       "http://presto.io/docs",
                       "https://example.com/?q=hello%20world", "not a url"],
               "s": ["abc", "hello", "abc", ""]}, {}),
        "j": ({"id": [0, 1, 2],
               "js": ['{"a": 1, "b": {"c": "hi"}, "arr": [1,2,3]}',
                      '{"a": 2, "arr": []}', 'not json'],
               "ja": ['[1,2,3]', '[]', '{"x":1}']}, {}),
        "c": ({"id": [0, 1, 2, 3, 4],
               "s": ["42", "3.5", "oops", "7", ""],
               "ds": ["2021-01-02", "bad", "1999-12-31", "2000-02-29",
                      "2020-06-15"],
               "bs": ["true", "FALSE", "1", "nope", "t"],
               "ts": ["2021-03-04 05:06:07", "1999-12-31 23:59:59",
                      "not a date", "2021-03-04 05:06:07",
                      "1970-01-01 00:00:00"]}, {}),
        "nanx": ({"x": [1.0, np.float32("nan"), None, 2.0]}, {}),
    }


def _window_tables():
    """tests/test_window.py's tables, and keys with NaN, +-inf and -0.0."""
    rng = np.random.default_rng(11)
    n = 1000
    w = {"g": np.asarray(["a", "b", "c", "d"])[rng.integers(0, 4, n)],
         "k": rng.integers(0, 50, n),
         "v": rng.integers(-100, 100, n),
         "x": rng.normal(0, 10, n)}
    nan, inf = float("nan"), float("inf")
    return {
        "w": (w, {"g": "varchar", "k": "bigint", "v": "bigint",
                  "x": "double"}),
        "wn": ({"g": list("aabbab"), "k": [1, 2, 2, 5, nan, 9],
                "v": [1., 2., 3., 4., 5., 6.]}, {}),
        "wr": ({"i": [1, 2, 3, 4], "k": [1.0, 2.0, 0.0, 0.0],
                "v": [1, 2, 4, 8]}, {}),
        "wd": ({"k": np.array([0.10, 1.10]), "v": np.array([1, 2], np.int64)},
               {"k": "decimal(4,2)", "v": "bigint"}),
        "wide": ({"k": np.array([1.0, 2.0]), "v": np.array([1, 2], np.int64)},
                 {"k": "decimal(38,2)", "v": "bigint"}),
        "wz": ({"i": list(range(12)),
                "g": list("aabbaabbaabb"),
                "z": [-0.0, 0.0, nan, inf, -inf, 1.0, nan, -0.0, 0.0, None,
                      -inf, 2.5],
                "v": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]},
               {"z": "double"}),
        "wts": ({"t": np.array(["2024-01-01", "2024-01-02"],
                               dtype="datetime64[ns]"), "v": [1, 2]}, {}),
    }


def _setop_tables():
    """tests/test_setops.py's tables (its LocalRunner fixture and its
    INTERSECT ALL / EXCEPT ALL class)."""
    rng = np.random.default_rng(11)
    n = 4_000
    sa = {"k": rng.integers(0, 500, n),
          "s": rng.choice(["ash", "bay", "elm", "fir", "oak"], n),
          "x": np.where(rng.random(n) < 0.1, None,
                        rng.integers(-50, 50, n).astype(object))}
    sb = {"k": rng.integers(250, 750, n),
          "s": rng.choice(["bay", "elm", "oak", "yew"], n),
          "x": np.where(rng.random(n) < 0.1, None,
                        rng.integers(-50, 50, n).astype(object))}
    sdim = {"dk": np.arange(0, 900, 3),
            "label": [f"d{i}" for i in range(0, 900, 3)]}
    rng = np.random.default_rng(13)
    n = 2000
    ma = {"k": rng.integers(0, 30, n), "s": rng.choice(["x", "y", "z"], n)}
    mb = {"k": rng.integers(10, 40, n), "s": rng.choice(["y", "z", "w"], n)}
    return {"sa": (sa, {"x": "bigint"}), "sb": (sb, {"x": "bigint"}),
            "sdim": (sdim, {}), "ma": (ma, {}), "mb": (mb, {})}


def _nljoin_tables():
    """tests/test_nljoin.py's tables."""
    rng = np.random.default_rng(21)
    n = 700
    na = {"ak": rng.integers(0, 60, n), "av": rng.integers(-100, 100, n)}
    nb = {"bk": rng.integers(0, 60, 50), "lo": rng.integers(-80, 0, 50),
          "hi": rng.integers(0, 80, 50)}
    return {"na": (na, {}), "nb": (nb, {})}


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
    # -- variance, covariance, DISTINCT beside others, sorted aggregates ------
    "variance_family": "select g, var_samp(x) vs, var_pop(x) vp, "
                       "stddev_samp(v) ss, stddev_pop(v) sp, variance(k) vk, "
                       "stddev(x) sx from w group by g order by g",
    "variance_decimal_nulls": "select b, stddev(v) s, var_pop(v) vp, "
                              "var_samp(k) vk from a group by b order by b",
    "variance_of_one_row": "select id, stddev_samp(k) s, var_pop(k) v "
                           "from a group by id order by id",
    "covariance_correlation": "select g, covar_pop(x, v) cp, "
                              "covar_samp(x, k) cs, corr(x, v) c "
                              "from w group by g order by g",
    "covariance_nulls_global": "select covar_samp(f, v) cs, corr(f, k) c, "
                               "covar_pop(k, f) cp from a",
    "distinct_beside_others": "select g, count(distinct k) dk, "
                              "sum(distinct v) sv, avg(distinct v) av, "
                              "count(*) n, max(x) mx from w group by g "
                              "order by g",
    "distinct_decimal_nulls_global": "select count(distinct v) c, "
                                     "sum(distinct v) s, avg(distinct v) a, "
                                     "count(*) n from a",
    "max_by_min_by": "select g, max_by(k, x) mk, min_by(v, x) mv, "
                     "max_by(x, x) mx, count(*) n from w group by g "
                     "order by g",
    "max_by_strings_nulls": "select b, max_by(s, f) ms, min_by(id, f) mi, "
                            "min_by(s, f) ns from a group by b order by b",
    "approx_percentile_sketch": "select g, approx_percentile(x, 0.5) p50, "
                                "approx_percentile(x, 0.9) p90 from w "
                                "group by g order by g",
    "approx_percentile_beside_others": "select g, approx_percentile(v, 0.25) "
                                       "p, count(*) n from w group by g "
                                       "order by g",
    "approx_percentile_global": "select approx_percentile(f, 0.5) p, "
                                "approx_percentile(f, 0.9) q from a",
    # -- numeric and date functions -------------------------------------------
    "numeric_functions": "select id, abs(k) ak, -k nk, abs(v) av, "
                         "sqrt(f) sq, exp(f) e, ln(abs(f) + 1) l, floor(f) fl, "
                         "ceil(f) ce, floor(v) fv, ceil(v) cv, sign(f) sg, "
                         "sign(k) sk, truncate(f) tr, power(f, 2) pw, "
                         "power(k, 0.5) pk from a order by id",
    "trig_and_rounding": "select id, atan2(f, 2.0) at, greatest(k, id) gr, "
                         "least(f, 1.0) le, greatest(v, 1.00) gv, round(f) r0, "
                         "round(f, 1) r1, round(v, 1) rv, round(v) rv0, "
                         "degrees(f) dg, radians(f) rd, sin(f) si, cos(f) co, "
                         "tan(f) ta, atan(f) an, tanh(f) th, cbrt(f) cb, "
                         "log2(abs(f) + 1) l2, log10(abs(f) + 1) lg "
                         "from a order by id",
    "round_half_away": "select k, x, round(x, 0) r0, round(x, 1) r1, "
                       "round(x * 10.0 + 0.5) r2 from w where k < 5 "
                       "order by x",
    "bitwise": "select id, bitwise_and(id, 6) ba, bitwise_or(id, 9) bo, "
               "bitwise_xor(id, k) bx, bitwise_not(id) bn, "
               "bitwise_left_shift(id, 3) bl, bitwise_right_shift(-id, 60) br, "
               "bitwise_right_shift(id, 1) b1 from a order by id",
    "float_tests": "select id, is_nan(sqrt(f)) n, is_finite(ln(f)) fi, "
                   "is_infinite(ln(f)) inf from a order by id",
    "time_parts": "select id, hour(from_unixtime(id * 4000)) h, "
                  "minute(from_unixtime(id * 4000)) mi, "
                  "second(from_unixtime(id * 4001)) s, "
                  "to_unixtime(from_unixtime(id * 3600.5)) u, "
                  "width_bucket(f, -2.0, 8.0, 5) wb from a order by id",
    "date_parts": "select id, quarter(d) q, day_of_week(d) dw, "
                  "day_of_year(d) dy, dow(d) dw2, doy(d) dy2 from a "
                  "order by id",
    "date_trunc_units": "select id, date_trunc('day', d) td, "
                        "date_trunc('week', d) tw, date_trunc('month', d) tm, "
                        "date_trunc('quarter', d) tq, date_trunc('year', d) ty "
                        "from a order by id",
    "date_diff_units": "select id, date_diff('day', d, date '2001-01-01') dd, "
                       "date_diff('week', d, date '2001-01-01') dw, "
                       "date_diff('month', d, date '2001-03-15') dm, "
                       "date_diff('quarter', d, date '2001-03-15') dq, "
                       "date_diff('year', d, date '2001-03-15') dy "
                       "from a order by id",
    "date_add_units": "select id, date_add('day', 3, d) ad, "
                      "date_add('week', -2, d) aw, date_add('month', 1, d) am, "
                      "date_add('quarter', 2, d) aq, date_add('year', -1, d) ay, "
                      "d + interval '5' day p5, d - interval '1' day m1 "
                      "from a order by id",
    # -- windows (tests/test_window.py) ---------------------------------------
    "win_rank_family": "select g, k, v, row_number() over (partition by g "
                       "order by k, v) rn, rank() over (partition by g order "
                       "by k) rk, dense_rank() over (partition by g order by "
                       "k) dr from w",
    "win_partition_aggregates": "select g, k, v, sum(v) over (partition by g) "
                                "total, count(*) over (partition by g) cnt, "
                                "max(v) over (partition by g order by k, v) "
                                "runmax, min(v) over (partition by g order by "
                                "k, v) runmin, avg(x) over (partition by g) ax "
                                "from w",
    "win_running_sum_peers": "select g, k, sum(v) over (partition by g order "
                             "by k) rs from w",
    "win_lag_lead_first": "select g, k, v, lag(v) over (partition by g order "
                          "by k, v) lg, lead(v, 2) over (partition by g order "
                          "by k, v) ld, first_value(v) over (partition by g "
                          "order by k, v) fv from w",
    "win_ntile_percent_rank_cume_dist":
        "select g, k, v, ntile(4) over (partition by g order by k, v) nt, "
        "percent_rank() over (partition by g order by k, v) pr, "
        "cume_dist() over (partition by g order by k, v) cd from w",
    "win_after_aggregation": "select g, k, rank() over (order by s desc) r "
                             "from (select g, k, sum(v) s from w group by "
                             "g, k) sub order by r, g, k limit 10",
    "win_multiple_specs": "select g, k, v, row_number() over (partition by g "
                          "order by v) a, sum(v) over (partition by k) b "
                          "from w",
    "win_rows_running": "select g, k, v, sum(v) over (partition by g order "
                        "by k, v rows between unbounded preceding and current "
                        "row) rs from w",
    "win_rows_preceding_following":
        "select k, v, sum(v) over (order by k, v rows between 3 preceding "
        "and 2 following) s, count(*) over (order by k, v rows between 3 "
        "preceding and 2 following) c from w",
    "win_rows_partitioned_minmax":
        "select g, k, v, min(v) over (partition by g order by k, v rows "
        "between 5 preceding and current row) mn, max(v) over (partition by "
        "g order by k, v rows between current row and 4 following) mx from w",
    "win_rows_avg_unbounded_following":
        "select g, k, x, avg(x) over (partition by g order by k, x rows "
        "between 2 preceding and 2 following) a, sum(x) over (partition by g "
        "order by k, x rows between current row and unbounded following) sf "
        "from w",
    "win_rows_shorthand_values":
        "select g, k, v, sum(v) over (partition by g order by k, v rows 4 "
        "preceding) s4, first_value(v) over (partition by g order by k, v "
        "rows between 3 preceding and 1 following) fv, last_value(v) over "
        "(partition by g order by k, v rows between 3 preceding and 1 "
        "following) lv from w",
    "win_rows_empty_frame":
        "select g, k, sum(v) over (partition by g order by k, v rows between "
        "10000 following and 10001 following) s, count(v) over (partition by "
        "g order by k, v rows between 10000 following and 10001 following) c "
        "from w",
    "win_lag_lead_defaults":
        "select g, k, v, lag(v, 1, -999) over (partition by g order by k, v) "
        "lg, lead(v, 2, -999) over (partition by g order by k, v) ld from w",
    "win_lag_float_default": "select g, k, x, lag(x, 1, -0.5) over "
                             "(partition by g order by k, x) lx from w",
    "win_value_functions": "select g, k, v, last_value(v) over (partition by "
                           "g order by k) lv, nth_value(v, 3) over (partition "
                           "by g order by k, v) n3, first_value(x) over "
                           "(partition by g) fx, count(x) over (partition by "
                           "g order by k) cx, max(x) over (partition by g) mx "
                           "from w",
    "win_range_preceding_following":
        "select g, k, v, sum(v) over (partition by g order by k range between "
        "5 preceding and 3 following) s, count(*) over (partition by g order "
        "by k range between 5 preceding and 3 following) c from w",
    "win_range_single_sided":
        "select g, k, v, sum(v) over (partition by g order by k range 10 "
        "preceding) sp, sum(v) over (partition by g order by k range between "
        "current row and 7 following) sf, sum(v) over (partition by g order "
        "by k range between unbounded preceding and 2 following) su from w",
    "win_range_desc_minmax":
        "select g, k, v, min(v) over (partition by g order by k desc range "
        "between 4 preceding and 4 following) mn, max(v) over (partition by "
        "g order by k desc range between 4 preceding and current row) mx "
        "from w",
    "win_range_double_key":
        "select g, x, avg(x) over (partition by g order by x range between 5 "
        "preceding and 5 following) a, count(x) over (partition by g order "
        "by x range between 5 preceding and 5 following) c from w",
    "win_range_first_last_value":
        "select g, k, v, first_value(k) over (partition by g order by k range "
        "between 8 preceding and 8 following) fv, last_value(k) over "
        "(partition by g order by k range between 8 preceding and 8 "
        "following) lv from w",
    "win_range_unbounded_current":
        "select g, k, sum(v) over (partition by g order by k range between "
        "unbounded preceding and current row) rs from w",
    "win_range_empty_frame":
        "select g, k, sum(v) over (partition by g order by k range between "
        "1000 following and 2000 following) s, count(v) over (partition by g "
        "order by k range between 1000 following and 2000 following) c from w",
    "win_range_nan_key": "select g, k, sum(v) over (partition by g order by "
                         "k range between 1 preceding and 1 following) s "
                         "from wn order by g, k",
    "win_range_nan_key_desc": "select g, k, sum(v) over (partition by g "
                              "order by k desc range between 1 preceding and "
                              "1 following) s from wn order by g, k",
    "win_range_no_order_key": "select sum(v) over (range between current row "
                              "and unbounded following) s from wr",
    "win_range_decimal_boundary": "select k, sum(v) over (order by k range "
                                  "between 1 preceding and current row) s "
                                  "from wd",
    "win_range_date_key": "select sum(v) over (order by t range between 1 "
                          "preceding and current row) s from wts",
    "win_range_null_nan_last":
        "select i, sum(v) over (order by k2 nulls last range between 1 "
        "preceding and 1 following) s from (select i, case when i = 4 then "
        "null when i = 3 then sqrt(-1.0) else k end k2, v from wr) x",
    "win_range_null_nan_first":
        "select i, sum(v) over (order by k2 nulls first range between 1 "
        "preceding and 1 following) s from (select i, case when i = 4 then "
        "null when i = 3 then sqrt(-1.0) else k end k2, v from wr) x",
    "win_range_null_first_offset_unbounded":
        "select i, sum(v) over (order by k2 nulls first range between 1 "
        "preceding and unbounded following) s from (select i, case when "
        "i = 4 then null else k end k2, v from wr) x",
    "win_range_null_first_current_unbounded":
        "select i, sum(v) over (order by k2 nulls first range between current "
        "row and unbounded following) s from (select i, case when i = 4 then "
        "null else k end k2, v from wr) x",
    "win_range_inf_nan_peers":
        "select i, sum(v) over (order by k2 range between 0 preceding and 0 "
        "following) s from (select i, case when i = 4 then 1.0 / 0.0 when "
        "i = 3 then sqrt(-1.0) else k end k2, v from wr) x",
    "win_duplicate_nan_peers":
        "select i, sum(v) over (order by k2 range between 1 preceding and 1 "
        "following) s, rank() over (order by k2) rk, dense_rank() over "
        "(order by k2) dr from (select i, case when i >= 3 then sqrt(-1.0) "
        "else k end k2, v from wr) x",
    "win_signed_zero_inf_nan_keys":
        "select i, z, rank() over (order by z) rk, dense_rank() over "
        "(order by z desc) dr, sum(v) over (partition by z) ps, sum(v) over "
        "(order by z range between 1 preceding and 1 following) rs, "
        "min(z) over (partition by g) mn, max(z) over (partition by g order "
        "by i) mx, min(z) over (partition by g order by i rows between 1 "
        "preceding and 1 following) bm, max(z) over (order by i rows between "
        "2 preceding and current row) bx from wz",
    # -- set operations (tests/test_setops.py) --------------------------------
    "set_union_all": "select k, s from sa union all select k, s from sb",
    "set_union": "select k, s from sa union select k, s from sb",
    "set_union_nulls": "select k, x from sa union select k, x from sb",
    "set_intersect": "select k, s from sa intersect select k, s from sb",
    "set_except": "select k, s from sa except select k, s from sb",
    "set_intersect_nulls": "select k, x from sa intersect select k, x from sb",
    "set_except_nulls": "select x, s from sa except select x, s from sb",
    "set_chained_union_order_limit": "select k from sa union select k from sb "
                                     "union select dk as k from sdim order "
                                     "by k limit 20",
    "set_union_through_aggregation":
        "select s, count(*) as c from (select k, s from sa union all select "
        "k, s from sb) u group by s",
    "set_full_outer_join": "select sa.k as k, sdim.label as label from sa "
                           "full outer join sdim on sa.k = sdim.dk "
                           "order by k, label",
    "set_full_outer_join_aggregated":
        "select count(*) as c, count(label) as cl, count(k) as ck from "
        "(select sa.k as k, sdim.label as label from sa full join sdim on "
        "sa.k = sdim.dk) t",
    "set_left_join_decomposition": "select sa.k as k, sdim.dk as dk from sa "
                                   "left join sdim on sa.k = sdim.dk",
    "set_anti_decomposition": "select dk from sdim where dk not in "
                              "(select k from sa)",
    "set_intersect_all": "select k, s from ma intersect all select k, s from mb",
    "set_except_all": "select k, s from ma except all select k, s from mb",
    "set_except_all_empty_right": "select k, s from ma except all select k, s "
                                  "from mb where 1 = 0",
    "set_signed_zero_nan": "select z from wz union select z from wz",
    "set_cube": "select b, k, count(*) c, grouping(b) gb, grouping(k) gk "
                "from a group by cube(b, k) order by gb, gk, b, k",
    "set_grouping_sets": "select b, s, sum(k) sk, min(v) mv from a "
                         "group by grouping sets ((b), (s), ()) "
                         "order by b, s",
    # -- nested-loop joins (tests/test_nljoin.py) -----------------------------
    "nl_cross_count": "select count(*) as c from na cross join nb",
    "nl_cross_projection": "select na.ak, nb.bk from na cross join nb "
                           "where na.ak = 0 and nb.bk = 0",
    "nl_range_join": "select na.ak, na.av, nb.bk from na join nb "
                     "on na.av > nb.lo and na.av < nb.hi where nb.bk < 5",
    "nl_inequality": "select count(*) as c from na join nb on na.ak <> nb.bk",
    "nl_comma_between": "select count(*) as c, sum(na.av) as s from na, nb "
                        "where na.av between nb.lo and nb.hi",
    "nl_cross_aggregate": "select nb.bk, count(*) as n from na cross join nb "
                          "group by nb.bk order by nb.bk",
    "nl_strings_nulls": "select a.id, b.id bid, a.s, b.s bs from a, b "
                        "where a.k < b.k order by a.id, b.id",
    # -- string functions (tests/test_functions.py, test_function_breadth.py,
    # test_function_batch2.py) ------------------------------------------------
    "str_transforms": "select id, upper(s) up, lower(s) lo, trim(s) t, "
                      "reverse(s) r, substr(s, 2, 3) sub, "
                      "replace(s, 'a', '/') rep, length(s) n, "
                      "strpos(s, 'a') p, 'pre:' || s || ':post' c, "
                      "concat('a', s, 'b') c2, lpad(s, 6, '*') lp, "
                      "rpad(s, 6, '*') rp, s || null cn from a order by id",
    "str_predicates_regexp": "select id, starts_with(s, 'a') sw, "
                             "ends_with(s, 'y') ew, regexp_like(s, '^[a-c]') "
                             "rx, regexp_extract(s, '(a)(.)', 2) re, "
                             "regexp_replace(s, 'a+', 'A') rr, "
                             "split_part(s, '_', 2) sp, codepoint(substr("
                             "s || 'z', 1, 1)) cp, levenshtein_distance(s, "
                             "'apple') ld from a where contains(s, 'a') "
                             "or s is null order by id",
    "str_transform_group_key": "select upper(substr(s, 1, 1)) k, count(*) n, "
                               "min(lower(s)) lo from a group by 1 order by 1",
    "str_split_pieces": "select id, split(s, '_')[1] p1, "
                        "element_at(split(s, 'a'), -1) pl, "
                        "cardinality(split(s, 'a')) n, "
                        "element_at(regexp_split(s, '[ab]'), 2) r2, "
                        "element_at(split(s, 'a', 2), 5) oob from a "
                        "order by id",
    "str_url_hash_base64": "select id, url_extract_host(url) h, "
                           "url_extract_path(url) p, "
                           "url_extract_protocol(url) pr, "
                           "url_extract_query(url) q, "
                           "url_decode(url_encode(s)) r, md5(s) m, "
                           "sha256(s) sh, to_base64(s) b64, "
                           "from_base64(to_base64(s)) rb from u order by id",
    "str_json": "select id, json_extract_scalar(js, '$.a') a, "
                "json_extract_scalar(js, '$.b.c') c, json_array_length(ja) n, "
                "json_extract(js, '$.b') jb, json_array_get(ja, 0) a0, "
                "json_size(js, '$.arr') nsz, json_format(json_parse(ja)) fmt, "
                "json_array_contains(ja, 2) has2, is_json_scalar(ja) sc "
                "from j order by id",
    # -- string compares --------------------------------------------------
    "str_range_literal": "select count_if(s < 'c') lt, "
                         "count_if(s <= 'banana') le, count_if(s > 'b') gt, "
                         "count_if(s >= 'bx') ge, "
                         "count_if(s between 'a' and 'c') bt, "
                         "count_if('c' > s) flipped, count(*) n from a",
    "str_compare_columns": "select a.id, b.id bid, a.s = b.s eq, "
                           "a.s <> b.s ne from a join b on a.k = b.k "
                           "order by a.id, b.id",
    "str_range_same_dictionary": "select x.id, y.id yid, x.s < y.s lt, "
                                 "x.s >= y.s ge from a x join a y "
                                 "on x.k = y.k order by x.id, y.id",
    # -- casts from and to varchar (tests/test_functions.py,
    # test_host_project.py) --------------------------------------------------
    "cast_from_varchar": "select id, cast(s as bigint) i, cast(s as double) d, "
                         "try(cast(s as bigint)) ti, cast(bs as boolean) bb, "
                         "cast(ds as date) dd, try_cast(s as decimal(10,2)) "
                         "dec, date_parse(ts, '%Y-%m-%d %H:%i:%s') dp, "
                         "from_iso8601_date(ds) fd from c order by id",
    "cast_from_varchar_aggregated": "select sum(cast(s as double)) t, "
                                    "count_if(cast(ds as date) >= "
                                    "date '2020-01-01') n from c",
    "cast_to_varchar": "select id, cast(k as varchar) ks, cast(d as varchar) "
                       "ds, cast(v as varchar) vs, cast(f as varchar) fs, "
                       "cast(b as varchar) bs, date_format(d, '%Y/%m/%d') df "
                       "from a order by id",
    "cast_to_varchar_over_aggregate": "select date_format(d, '%Y-%m') ym, "
                                      "cast(sum(v) as varchar) sv, "
                                      "cast(count(*) as varchar) n from a "
                                      "group by d order by d",
    # -- SELECT without FROM, VALUES ------------------------------------------
    "no_from": "select 1 + 2 x, 'x' || 'y' s, upper('abc') u, "
               "bit_length('\u00e9') bl, cast(timestamp '2021-03-04 "
               "05:06:07.25' as varchar) ts",
    "values": "select * from (values (1, 'a'), (2, 'b'), "
              "(3, cast(null as varchar))) as v(k, s) order by k",
    # -- approx_distinct, geometric_mean, checksum (tests/test_sketches.py,
    # test_hll_values.py, test_function_breadth.py) --------------------------
    "hll_grouped_nulls": "select s, approx_distinct(k) d from a group by s "
                         "order by s",
    "hll_doubles": "select approx_distinct(f) d from a",
    "hll_strings": "select b, approx_distinct(s) d from a group by b "
                   "order by b",
    "geomean_checksum": "select b, geometric_mean(f) gm, checksum(k) ck, "
                        "checksum(s) cs, checksum(f) cf, checksum(v) cv, "
                        "count(*) n from a group by b order by b",
    "geomean_checksum_beside_distinct":
        "select w, approx_distinct(k) d, geometric_mean(k + 1) g, "
        "checksum(k) c from r group by w order by w",
    # -- varbinary, ipaddress, ipprefix (tests/test_time_varbinary.py,
    # test_ipaddress.py) -------------------------------------------------------
    "varbinary": "select k, data, length(data) n, to_hex(data) hx, "
                 "from_utf8(data) s, to_hex(sha256(data)) sh, "
                 "to_hex(to_utf8(from_utf8(data))) rt from blobs order by k",
    "varbinary_join_group": "select b1.data d, count(*) c from blobs b1 "
                            "join blobs b2 on b1.data = b2.data "
                            "group by b1.data order by c desc, d",
    "ipaddress": "select id, cast(ip as varchar) v, "
                 "cast(ip_prefix(ip, 16) as varchar) p, "
                 "ip = cast('10.0.0.1' as ipaddress) one from ips order by id",
    "ipaddress_group": "select cast(ip as varchar) v, count(*) c from ips "
                       "group by ip order by ip",
    "ipprefix": "select cast(net as varchar) v, "
                "is_subnet_of(net, cast('10.0.1.1' as ipaddress)) sub, "
                "cast(ip_subnet_min(net) as varchar) lo from nets "
                "order by net",
    "ip_counts": "select count(*) c, count(distinct ip) d, count_if("
                 "is_subnet_of(cast('10.0.0.0/16' as ipprefix), ip)) s "
                 "from ips",
    "ip_from_varchar": "select cast(cast(s as ipaddress) as varchar) v "
                       "from raw order by s",
    # -- a float32 NaN is a value, not a NULL -----------------------------------
    "float32_nan_counts": "select count(x) nx, count(*) n from nanx",
}


# Float windows over a bounded frame are differences of one global cumsum
# (cs[end] - cs[start - 1]); torch adds in another order than XLA, and the
# difference cancels to the magnitude of the running total (about 1e3 here)
# against results near 1, so these columns hold to 1e-9, the tolerance
# tests/test_window.py allows the same query against sqlite.
FLOAT_WINDOW_RTOL = {"win_range_double_key": 1e-9}


@pytest.mark.parametrize("name", list(CASES))
def test_sql_matches_reference(catalogs, name):
    ref, port = catalogs
    sql = CASES[name]
    cfg = dict(batch_rows=SOURCE_BATCH_ROWS.get(name.split("_")[0],
                                                BATCH_ROWS))
    want = RefRunner(ref, RefConfig(fragment_fusion=False, **cfg)).run(sql)
    assert want.columns.is_unique  # every output column is compared
    for engine in ("sort", "hash"):
        got = LocalRunner(port, ExecConfig(breaker_engine=engine, **cfg),
                          device="cpu").run(sql)
        assert_frames_equal(got, want, (name, engine),
                            rtol=FLOAT_WINDOW_RTOL.get(name, 1e-12))


# SQL refused in both packages (the error cases of tests/test_window.py,
# tests/test_nljoin.py and tests/test_host_project.py; a range compare of
# strings on two dictionaries; a cast to varchar below the SELECT list,
# which has no dictionary to cast back from)
@pytest.mark.parametrize("sql, error", [
    ("select lag(g, 1, 0) over (partition by g order by k) x from w",
     "AnalysisError"),
    ("select lag(k, 1, 2.5) over (partition by g order by k) x from w",
     "AnalysisError"),
    ("select sum(v) over (order by k, v range between 3 preceding and "
     "current row) s from w", "AnalysisError"),
    ("select sum(v) over (order by g range between 3 preceding and current "
     "row) s from w", "AnalysisError"),
    ("select sum(v) over (order by cast(t as timestamp) range between 1 "
     "preceding and current row) s from wts", "AnalysisError"),
    ("select sum(v) over (order by k range between 1 preceding and current "
     "row) s from wide", "AnalysisError"),
    ("select sum(v) over (order by k range 3 following) s from wr",
     "ParseError"),
    ("select sum(v) over (order by k rows 2 following) s from wr",
     "ParseError"),
    ("select * from na left join nb on na.av < nb.lo", "AnalysisError"),
    ("select a.s < b.s from a join b on a.k = b.k", "NotImplementedError"),
    ("select distinct cast(k as varchar) from a", "AnalysisError"),
    ("select id from a where date_format(d, '%Y') = '2021'", "ValueError"),
    ("select sum(cast(cast(k as varchar) as bigint)) s from a", "ValueError"),
], ids=["lag_string_default", "lag_fractional_default", "range_two_keys",
        "range_string_key", "range_timestamp_key", "range_wide_decimal",
        "range_shorthand_following", "rows_shorthand_following",
        "outer_non_equi", "string_range_across_dictionaries",
        "distinct_host_projection", "host_projection_in_filter",
        "varchar_cast_inside_an_expression"])
def test_refused_sql_raises_like_reference(catalogs, sql, error):
    ref, port = catalogs
    with pytest.raises(Exception) as want:
        RefRunner(ref, RefConfig(fragment_fusion=False)).run(sql)
    assert type(want.value).__name__ == error
    with pytest.raises(Exception) as got:
        LocalRunner(port, device="cpu").run(sql)
    assert type(got.value).__name__ == error


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


def test_float32_nan_is_a_value(catalogs):
    """In an object column a float32 NaN is a value; None and a Python
    float NaN are NULL, as the JAX package ingests them."""
    _, port = catalogs
    got = LocalRunner(port, device="cpu").run(
        "select count(x) nx, count(*) n from nanx")
    assert (got.nx[0], got.n[0]) == (3, 4)


def test_nljoin_last_chunk_clamps_like_reference():
    """1,200 build rows in 256-row scan batches make a build capacity of
    1,280, which the 512-row chunk does not divide: the last chunk starts
    at capacity - 512 and re-reads rows of the chunk before it, as the JAX
    package's clamped slice does, so both count those pairs twice (a
    reference fault the port keeps). At 512-row batches the capacity is
    1,536 and both count each pair once."""
    rng = np.random.default_rng(5)
    t = {"h": rng.integers(0, 2, 3000), "x": rng.random(3000) * 0.01}
    u = {"uw": rng.integers(0, 2, 1200), "uk": rng.integers(0, 1000, 1200)}
    rc, pc = RefMemory(), MemoryConnector()
    for name, data in (("t", t), ("u", u)):
        rc.add_table(name, data)
        pc.add_table(name, data)
    ref, port = RefCatalog(), Catalog()
    ref.register("m", rc, default=True)
    port.register("m", pc, default=True)
    sql = ("select count(*) c from t, u where t.h = 0 and u.uw = 1 "
           "and t.x > u.uk / 1000.0")
    counts = {}
    for rows in (256, 512):
        want = int(RefRunner(ref, RefConfig(fragment_fusion=False,
                                            batch_rows=rows)).run(sql).c[0])
        got = LocalRunner(port, ExecConfig(batch_rows=rows),
                          device="cpu").run(sql)
        assert int(got.c[0]) == want, rows
        counts[rows] = want
    assert counts == {256: 56_848, 512: 44_880}


def test_hll_register_and_rank_bit_exact():
    """approx_distinct's register and rank of each row, the port's against
    the JAX package's, bit for bit, over more distinct values than the
    estimator's linear-counting range (where the ranks decide the
    estimate): int64 keys, doubles with -0.0, NaN and infinities, and
    strings by their content."""
    from presto_tpu.batch import Batch as RefBatch
    from presto_tpu.dictionary import Dictionary as RefDictionary
    from presto_tpu.expr import compile as rc
    from presto_tpu.expr import ir as rir
    from presto_tpu_torch.batch import Batch
    from presto_tpu_torch.dictionary import Dictionary
    from presto_tpu_torch.expr import compile as pc
    from presto_tpu_torch.expr import ir as pir

    rng = np.random.default_rng(3)
    n = 20_000
    x = rng.normal(0, 1e6, n)
    x[:5] = [-0.0, 0.0, np.nan, np.inf, -np.inf]
    words = np.array([f"user-{i:06d}" for i in rng.integers(0, 15_000, n)])
    data = {"k": rng.integers(-(1 << 62), 1 << 62, n), "x": x}
    rdict, codes = RefDictionary.encode(words)
    pdict, _ = Dictionary.encode(words)
    data["s"] = codes
    names = {"k": "bigint", "x": "double", "s": "varchar"}
    rb = RefBatch.from_numpy(data, {c: ref_type(t) for c, t in names.items()},
                             dicts={"s": rdict})
    pb = Batch.from_numpy(data, {c: parse_type(t) for c, t in names.items()},
                          torch.device("cpu"), dicts={"s": pdict})
    for col, t in names.items():
        for fn in ("__hll_reg", "__hll_rank"):
            want, _ = rc.compile_expr(rir.Call(ref_type("bigint"), fn, (
                rir.InputRef(ref_type(t), col),)))(rb)
            got, _ = pc.compile_expr(pir.Call(parse_type("bigint"), fn, (
                pir.InputRef(parse_type(t), col),)))(pb)
            np.testing.assert_array_equal(got.numpy()[:n],
                                          np.asarray(want)[:n],
                                          err_msg=f"{fn}({col})")
