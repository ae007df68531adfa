"""Statements other than queries through the port's LocalRunner, against
the JAX package: the statement sequences of tests/test_writes.py (CTAS
round trip, INSERT appends, an INSERT whose schema does not match,
CTAS of strings and NULLs, DROP TABLE, CTAS then a join against it,
views, DELETE ... WHERE, TRUNCATE and CREATE TABLE of a schema) and one
over the string functions of this slice.

Each sequence runs on its own memory catalogs, one per package (and one
per breaker engine of the port, sort and hash). Every statement gives
the JAX package's frame (a statement's one `rows` count, or a query's
rows, exactly; floats to rtol=1e-12) or raises the same exception type;
at the end every table holds the same rows.
"""

import numpy as np
import pandas as pd
import pytest

from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from test_torch_tpch import assert_frames_equal, one_torch_thread  # noqa: F401

BATCH_ROWS = 1 << 10  # tests/test_writes.py's


def _table() -> pd.DataFrame:
    """tests/test_writes.py's table t: 5,000 rows, strings with NULLs."""
    rng = np.random.default_rng(9)
    n = 5_000
    return pd.DataFrame({
        "g": rng.integers(0, 20, n),
        "s": rng.choice(["ash", "bay", "elm", None], n),
        "v": np.round(rng.random(n) * 100, 2),
    })


SEQUENCES = {
    "ctas_round_trip": [
        "create table agg as select g, count(*) as c, sum(v) as sv "
        "from t group by g",
        "select g, c, sv from agg order by g",
        "create table if not exists agg as select g from t",
        "create table agg as select g from t",
    ],
    "insert_appends": [
        "create table cp as select g, v from t",
        "insert into cp select g + 100 as g, v from t",
        "select count(*) as c, min(g) as lo, max(g) as hi, sum(v) sv from cp",
    ],
    "insert_schema_mismatch_rejected": [
        "create table one as select g from t",
        "insert into one select g, v from t",
        "insert into one select s from t",
        "insert into missing select g from t",
    ],
    "ctas_strings_and_nulls": [
        "create table st as select s, count(*) as c from t group by s",
        "select s, c from st order by s",
        # codes of another dictionary re-encode into the table's
        "insert into st select upper(s), count(*) from t group by 1",
        "select s, c from st order by s",
    ],
    "drop_table": [
        "create table dead as select g from t",
        "drop table dead",
        "drop table if exists dead",
        "drop table dead",
        "select count(*) n from dead",
    ],
    "ctas_then_join": [
        "create table gsum as select g, sum(v) as sv from t group by g",
        "select t.g, count(*) as c, min(gsum.sv) sv from t join gsum "
        "on t.g = gsum.g group by t.g order by t.g",
    ],
    "views": [
        "create view big as select g, v from t where v >= 10",
        "select g, count(*) as n from big group by g order by g",
        "select count(*) as n from big where g = 1",
        "create view big as select v from t",
        "create or replace view big as select v from t where v < 5",
        "select count(*) as n from big",
        "drop view big",
        "select * from big",
        "drop view if exists big",
        "drop view big",
    ],
    "delete_where": [
        "delete from t where v < 5",
        "select count(*) as n from t",
        # a NULL predicate keeps its row
        "delete from t where nullif(v, v) > 0",
        "delete from t where s = 'elm'",
        "select count(*) as n, count(s) ns, sum(v) sv from t",
    ],
    "truncate_and_create_schema": [
        "truncate table t",
        "select count(*) as n from t",
        "create table fresh (a bigint, b varchar, c double)",
        "insert into fresh select g, 'x', v from t",
        "select count(*) as n from fresh",
        "create table money (a decimal(10,2))",
        "select count(*) as n from money",
        "create table if not exists money (a bigint)",
    ],
    "string_functions_and_casts": [
        "create table sv as select g, s, upper(s) us, length(s) n, "
        "s || '-' sg, cast(g as varchar) gs from t where g < 5",
        "insert into sv select g + 1, s, lower(us), n + 1, sg, gs from sv "
        "where s < 'c'",
        "delete from sv where us is null or n > 3",
        "select us, count(*) c, approx_distinct(g) d from sv group by us "
        "order by us",
        "select count(*) c, checksum(sg) ck, geometric_mean(g + 1) gm, "
        "sum(cast(gs as bigint)) sg from sv",
    ],
}


def _catalogs():
    df = _table()
    rc = RefMemory()
    rc.add_table("t", df)
    ref = RefCatalog()
    ref.register("m", rc, default=True)
    ports = {}
    for engine in ("sort", "hash"):
        pc = MemoryConnector()
        pc.add_table("t", df)
        cat = Catalog()
        cat.register("m", pc, default=True)
        ports[engine] = LocalRunner(
            cat, ExecConfig(breaker_engine=engine, batch_rows=BATCH_ROWS),
            device="cpu")
    return RefRunner(ref, RefConfig(fragment_fusion=False,
                                    batch_rows=BATCH_ROWS)), ports


def _outcome(runner, sql):
    try:
        return runner.run(sql)
    except Exception as e:  # noqa: BLE001 — the refusal is the outcome
        return e


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_statements_match_reference(name):
    ref, ports = _catalogs()
    for sql in SEQUENCES[name]:
        want = _outcome(ref, sql)
        for engine, runner in ports.items():
            got = _outcome(runner, sql)
            where = (name, sql, engine)
            if isinstance(want, Exception) or isinstance(got, Exception):
                assert type(got).__name__ == type(want).__name__, (
                    where, want, got)
                continue
            assert_frames_equal(got, want, where)
    # a table's rows in the order of all its columns: a grouped CTAS stores
    # its groups in the order its engine makes them
    tables = ref.catalog.connectors["m"].tables
    for engine, runner in ports.items():
        assert sorted(runner.catalog.connectors["m"].tables) == sorted(tables)
        for table, mt in tables.items():
            order = ", ".join(str(i + 1) for i in range(len(mt.types)))
            sql = f"select * from {table} order by {order}"
            assert_frames_equal(runner.run(sql), ref.run(sql),
                                (name, table, engine))


def test_statements_return_one_row_on_the_runner_device():
    """The `rows` count of a statement is one row, as a Batch on the
    runner's device."""
    _, ports = _catalogs()
    out = ports["hash"].run_batch("create table c2 as select g from t")
    assert out.device.type == "cpu" and list(out.names) == ["rows"]
    assert out.to_pandas().rows.tolist() == [5_000]
