"""The port's cluster against the JAX package, on the CPU at TPC-H SF 0.01.

- Answers: the 22 TPC-H queries through the port's DistributedRunner (a
  coordinator and two workers over localhost HTTP, `device="cpu"`) under
  breaker_engine auto equal the JAX package's frames (the ones
  tests/test_torch_tpch.py shares, `reference_frame`); Q1, Q3, Q5, Q9,
  Q13 and Q18 also under hash with every join partitioned, and Q3 and Q5
  under phased scheduling. A join of two bucketed tables runs colocated
  (grouped execution, also recoverable) and gives the JAX package's rows
  (the frame tests/test_torch_connectors.py shares).
- Aggregate steps: every aggregate the port has runs grouped and global
  through the cluster (partial → final where it decomposes, gathered
  single-step where it does not) and equals the port's LocalRunner; one
  query also equals a JAX frame computed once (`shared`). GRACE's
  partial pass-through and grouped execution over buckets are included.
- Protocol and clients: /v1/statement paging, DATE and DECIMAL wire
  values (each response's rows equal the JAX package's
  `result_rows_json` of the same result), errors, SET/SHOW SESSION,
  SHOW TABLES/COLUMNS, EXPLAIN, prepared statements, cancel, the query
  history, the port's dbapi and cli, and the JAX package's own client
  reading the port's coordinator.
- Statements: CTAS, INSERT and a scaled-writer CTAS into Parquet.
- The launcher: `python -m presto_tpu_torch.server` as a coordinator and
  a worker process on the CPU, and its CUDA default.

Tolerance: ROADMAP's — decimals, integers, dates, strings, keys and counts
exactly; doubles at rtol=1e-12; row order exactly under ORDER BY, the
multiset otherwise. Every cluster here bounds each HTTP call by 30 s and
a query's wait for its result by 60 s, so a hang fails one test.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import presto_tpu_torch.dbapi as dbapi
from presto_tpu.catalog.tpch import tpch_catalog as ref_tpch_catalog
from presto_tpu.client import execute as ref_execute
from presto_tpu.cli import format_table as ref_format_table
from presto_tpu.cli import split_statements as ref_split_statements
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.server.protocol import result_rows_json as ref_rows_json
from presto_tpu.server.querymanager import QueryResult as RefQueryResult
from presto_tpu_torch import cli
from presto_tpu_torch.catalog import parquet
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.catalog.tpch import tpch_catalog
from presto_tpu_torch.client import (
    ClientSession,
    QueryError,
    StatementClient,
    execute,
)
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.exec import runtime
from presto_tpu_torch.plan.nodes import plan_to_string
from presto_tpu_torch.server.coordinator import DistributedRunner, QueryFailed
from presto_tpu_torch.server.querymanager import batch_to_result
from presto_tpu_torch.server.session import Session
from test_torch_connectors import bucketed_join_tables
from test_torch_tpch import (  # noqa: F401 — fixtures
    REPO,
    TPCH,
    assert_frames_equal,
    one_torch_thread,
    reference_frame,
    reference_frames_dir,
    shared,
)

SF = 0.01
TIMEOUTS = dict(timeout_s=30.0, query_timeout_s=60.0)


def cluster_of(cat, config=None, **kw):
    return DistributedRunner(cat, n_workers=2, config=config, device="cpu",
                             **TIMEOUTS, **kw)


def assert_result(got, want, sql, where):
    """ORDER BY fixes the order; without it the multiset is compared."""
    if "order by" not in sql.lower():
        got = got.sort_values(list(got.columns), ignore_index=True)
        want = want.sort_values(list(want.columns), ignore_index=True)
    assert_frames_equal(got, want, where)


@pytest.fixture(scope="module")
def port_cat():
    return tpch_catalog(SF)


@pytest.fixture(scope="module")
def ref_cat():
    return ref_tpch_catalog(SF)


@pytest.fixture(scope="module")
def cluster(port_cat):
    dr = cluster_of(port_cat)
    yield dr
    dr.close()


@pytest.fixture(scope="module")
def hash_cluster(port_cat):
    """breaker_engine hash, every join partitioned."""
    dr = cluster_of(port_cat, ExecConfig(breaker_engine="hash"),
                    broadcast_threshold_rows=0)
    yield dr
    dr.close()


# -- answers -----------------------------------------------------------------


@pytest.mark.parametrize("q", list(TPCH))
def test_tpch_query_through_cluster(cluster, ref_cat, reference_frames_dir,
                                    q):
    want = reference_frame(ref_cat, q, reference_frames_dir)
    assert len(want) > 0
    assert_result(cluster.run(TPCH[q]), want, TPCH[q], (q, "cluster"))


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q9", "q13", "q18"])
def test_tpch_hash_partitioned_through_cluster(hash_cluster, ref_cat,
                                               reference_frames_dir, q):
    """Under hash with every hash join partitioned: a hash exchange on
    each side of each join (a SemiJoin's build is broadcast, as in the
    JAX package), partial/final aggregation."""
    plan = hash_cluster.explain_distributed(TPCH[q])
    assert "→ hash(" in plan
    assert plan.count("→ hash(") >= 2 * plan.count("HashJoin[")
    want = reference_frame(ref_cat, q, reference_frames_dir)
    assert_result(hash_cluster.run(TPCH[q]), want, TPCH[q], (q, "hash"))


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_tpch_phased_through_protocol(cluster, ref_cat, reference_frames_dir,
                                      q):
    """execution_policy=phased over the statement protocol: build stages
    run (spooled) before their probes start; the rows are the JAX
    package's, as JSON."""
    session = ClientSession()
    session.properties["execution_policy"] = "phased"
    client = StatementClient(cluster.coordinator.url, TPCH[q], session)
    rows = list(client.rows())
    want = reference_frame(ref_cat, q, reference_frames_dir)
    assert [c["name"] for c in client.columns] == list(want.columns)
    types = [c["type"] for c in client.columns]
    assert rows == ref_rows_json(RefQueryResult(
        list(want.columns), types,
        list(want.itertuples(index=False, name=None))))


def test_bucketed_join_through_cluster(tmp_path, reference_frames_dir):
    """The bucketed join of tests/test_torch_connectors.py, through the
    cluster: the fragment keeps both scans (no exchange under the join),
    the join is colocated over 4 buckets, each task sweeps its buckets,
    and the rows are the JAX package's (that file's shared frame);
    recoverable grouped execution (one task a bucket) gives them too."""
    sql, compute = bucketed_join_tables(str(tmp_path))
    want = shared(reference_frames_dir, "scan_bucketed_join", compute)
    cat = Catalog()
    cat.register("pq", parquet.ParquetConnector(str(tmp_path)), default=True)
    for cfg in (ExecConfig(batch_rows=1 << 13, agg_capacity=1 << 10),
                ExecConfig(batch_rows=1 << 13, agg_capacity=1 << 10,
                           recoverable_grouped_execution=True,
                           breaker_engine="hash")):
        dr = cluster_of(cat, cfg)
        try:
            plan = dr.explain_distributed(sql)
            assert "colocated=4 buckets" in plan
            # the join's fragment scans both tables itself
            join_frag = [f for f in dr.plan_distributed(sql).fragments.values()
                         if "colocated=4" in plan_to_string(f.root)]
            assert len(join_frag) == 1 and join_frag[0].partitioning == \
                "source"
            assert "RemoteSource" not in plan_to_string(join_frag[0].root)
            assert_frames_equal(dr.run(sql), want, ("bucketed", cfg))
        finally:
            dr.close()


def test_grouped_aggregation_over_buckets(tmp_path, monkeypatch):
    """An aggregation whose keys cover a colocated join's keys runs bucket
    by bucket with the join (grouped execution: each bucket's groups are
    final before the next bucket builds), in the cluster and locally; the
    rows are those of the same tables unbucketed in a memory catalog."""
    sql, _ = bucketed_join_tables(str(tmp_path))
    sql = ("select a.k, count(*) n, sum(b.y) s, max(a.x) mx from a join b "
           "on a.k = b.k group by a.k order by a.k")
    pq_ = parquet.ParquetConnector(str(tmp_path))
    cat = Catalog()
    cat.register("pq", pq_, default=True)
    mem = MemoryConnector("m")
    for t in ("a", "b"):
        h = pq_.get_table(t)
        cols = [c.name for c in h.columns]
        parts = [pq_.read_split(sp, cols, torch.device("cpu"))
                 for sp in pq_.splits(h, 8)]
        mem.create_table_from(t, parts)
    plain = Catalog()
    plain.register("m", mem, default=True)
    want = LocalRunner(plain, device="cpu").run(sql)
    seen = []
    sweep = runtime._lifespan_sweep

    def spy(ctx, buckets, run, sizes_state=False):
        seen.append((buckets, sizes_state))
        return sweep(ctx, buckets, run, sizes_state)

    monkeypatch.setattr(runtime, "_lifespan_sweep", spy)
    dr = cluster_of(cat, ExecConfig(batch_rows=1 << 13))
    try:
        assert_frames_equal(dr.run(sql), want, "grouped cluster")
        assert (4, True) in seen  # the aggregation's sweep
        seen.clear()
        assert_frames_equal(LocalRunner(cat, device="cpu").run(sql), want,
                            "grouped local")
        assert (4, True) in seen
    finally:
        dr.close()


# -- aggregate steps ---------------------------------------------------------


def agg_table(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 40, n)
    x = rng.integers(-50, 1000, n).astype(object)
    x[::11] = None
    f = rng.normal(10.0, 3.0, n)
    s = np.array([f"v{int(v) % 23:02d}" for v in rng.integers(0, 999, n)],
                 object)
    s[::13] = None
    return pd.DataFrame({
        "g": g, "x": x, "f": f, "y": rng.normal(size=n),
        "b": rng.integers(0, 2, n).astype(bool), "s": s,
        "k": rng.integers(0, 60, n), "w": rng.uniform(0.5, 2.0, n)})


AGGS = {
    "sums": "sum(x), avg(x), count(x), count(*), count_if(b), "
            "sum(f), avg(f), checksum(s)",
    "minmax": "min(x), max(x), min(f), max(f), min(s), max(s), "
              "arbitrary(g) is not null, bool_and(b), bool_or(b)",
    "decimal": "sum(cast(x as decimal(12,2))), "
               "avg(cast(x as decimal(12,2))), "
               "sum(cast(x as decimal(38,3))), "
               "avg(cast(x as decimal(38,3))), "
               "min(cast(x as decimal(12,2)))",
    "variance": "var_samp(f), var_pop(f), stddev_samp(f), stddev_pop(f), "
                "covar_pop(f, y), covar_samp(f, y), corr(f, y), "
                "geometric_mean(w)",
    "distinct": "count(distinct k), sum(distinct k), avg(distinct k)",
    "approx_distinct": "approx_distinct(k), approx_distinct(s)",
    "by_order": "approx_percentile(f, 0.5), max_by(k, f), min_by(k, f), "
                "approx_percentile(x, 0.9)",
    "built": "cardinality(array_agg(k)), "
             "cardinality(map_agg(k, f)), "
             "cardinality(numeric_histogram(4, f))",
}


@pytest.fixture(scope="module")
def agg_clusters():
    """The aggregate table in a memory catalog, a two-worker cluster over
    it and the port's LocalRunner (the oracle)."""
    conn = MemoryConnector("m")
    conn.add_table("t", agg_table())
    cat = Catalog()
    cat.register("m", conn, default=True)
    cfg = ExecConfig(batch_rows=1 << 9, agg_capacity=1 << 6)
    dr = cluster_of(cat, cfg)
    yield dr, LocalRunner(cat, cfg, device="cpu")
    dr.close()


@pytest.mark.parametrize("family", list(AGGS))
def test_aggregates_through_partial_and_final(agg_clusters, family):
    """Grouped and global: the cluster's answer is the port's LocalRunner's
    (floats to rtol=1e-12: partial sums add in another order); a
    decomposable family runs partial → exchange → final, the others are
    gathered and run single-step."""
    dr, local = agg_clusters
    decomposable = family not in ("distinct", "approx_distinct", "by_order",
                                  "built")
    for sql in (f"select g, {AGGS[family]} from t group by g order by g",
                f"select {AGGS[family]} from t"):
        plan = dr.explain_distributed(sql)
        assert ("Aggregate[partial" in plan) == decomposable, plan
        assert ("Aggregate[final" in plan) == decomposable, plan
        assert_frames_equal(dr.run(sql), local.run(sql), (family, sql))


def test_aggregates_empty_input_through_cluster(agg_clusters):
    """A global aggregation over no row still gives its one row (count 0,
    sums NULL) after partial → final; a grouped one gives none."""
    dr, local = agg_clusters
    for sql in ("select count(*), sum(x), avg(f), min(s) from t where g < 0",
                "select g, count(*) from t where g < 0 group by g"):
        got = dr.run(sql)
        assert_frames_equal(got, local.run(sql), sql)
        assert len(got) == (0 if "group by" in sql else 1)


def test_aggregates_match_reference_frame(agg_clusters,
                                          reference_frames_dir):
    """One grouped query of several families through the cluster against
    the JAX package's LocalRunner on the same table (one JAX run a
    session, `shared`)."""
    sql = ("select g, sum(x), avg(f), count(*), min(s), max(x), "
           "stddev_samp(f), count(distinct k), checksum(s) "
           "from t group by g order by g")

    def compute():
        conn = RefMemory("m")
        conn.add_table("t", agg_table())
        cat = RefCatalog()
        cat.register("m", conn, default=True)
        return RefRunner(cat, RefConfig(batch_rows=1 << 9,
                                        agg_capacity=1 << 6)).run(sql)

    want = shared(reference_frames_dir, "cluster_aggregates", compute)
    dr, _ = agg_clusters
    assert_frames_equal(dr.run(sql), want, "aggregates vs JAX")


def test_grace_partial_passthrough(monkeypatch):
    """A presize past agg_cap_ceiling makes the partial step pass each
    row's states through unmerged (the JAX package's adaptive partial
    bypass) and the final step merge once, GRACE-partitioned; the answer
    is the in-memory one (tests/test_grace_agg.py's table and query)."""
    rng = np.random.default_rng(23)
    n, ndv = 40_000, 9_000
    g = rng.integers(0, ndv, n)
    conn = MemoryConnector("m")
    conn.add_table("t", pd.DataFrame({
        "g": g, "x": rng.integers(0, 1000, n), "f": rng.normal(size=n),
        "s": np.array([f"name{v % 97}" for v in g])}))
    cat = Catalog()
    cat.register("m", conn, default=True)
    sql = ("select g, count(*) as c, sum(x) as sx, min(f) as mn, "
           "max(s) as mx from t group by g")
    seen = []
    presize = runtime._agg_presize

    def spy(node, ctx):
        out = presize(node, ctx)
        seen.append((node.step, out[3]))
        return out

    monkeypatch.setattr(runtime, "_agg_presize", spy)
    want = LocalRunner(cat, ExecConfig(batch_rows=1 << 12,
                                       agg_capacity=1 << 14,
                                       agg_cap_ceiling=1 << 22),
                       device="cpu").run(sql)
    dr = cluster_of(cat, ExecConfig(batch_rows=1 << 12, agg_capacity=1 << 8,
                                    agg_cap_ceiling=1 << 9,
                                    spill_partitions=4))
    try:
        seen.clear()
        got = dr.run(sql)
    finally:
        dr.close()
    # the partial step passes rows through; the final one has no estimate
    # behind its exchange and goes GRACE once its table outgrows the
    # ceiling
    assert ("partial", True) in seen, seen
    assert len(got) > ndv * 0.95
    assert_result(got, want, sql, "grace passthrough")


# -- protocol and clients ----------------------------------------------------


def json_rows_of(batch):
    """The JAX package's wire rows of a port result (result_rows_json is
    host-only)."""
    r = batch_to_result(batch)
    return ref_rows_json(RefQueryResult(r.columns, r.types, r.rows))


def test_statement_paging_and_wire_values(cluster, port_cat):
    """A result of several pages (DATE, DECIMAL, VARCHAR, BIGINT columns)
    arrives page by page; the rows are result_rows_json's of the same
    result computed locally, value for value."""
    sql = ("select l_orderkey, l_linenumber, l_shipdate, l_extendedprice, "
           "l_returnflag, l_discount * 2 d from lineitem "
           "where l_orderkey < 700 order by l_orderkey, l_linenumber")
    local = LocalRunner(port_cat, device="cpu").run_batch(sql)
    want = json_rows_of(local)
    assert len(want) > 2 * 100
    cluster.coordinator.protocol.page_rows = 100
    try:
        client = StatementClient(cluster.coordinator.url, sql,
                                 ClientSession())
        pages = [len(client._current_data)]
        while client._advance():
            pages.append(len(client._current_data))
        client = StatementClient(cluster.coordinator.url, sql,
                                 ClientSession())
        rows = list(client.rows())
    finally:
        cluster.coordinator.protocol.page_rows = 1000
    assert sum(1 for p in pages if p) >= 3
    assert rows == want
    assert [c["type"] for c in client.columns] == [str(t)
                                                   for t in local.types]
    d, p = rows[0][2], rows[0][3]
    assert isinstance(d, str) and len(d.split("-")) == 3  # ISO date
    assert isinstance(p, str) and "." in p  # exact decimal text


def test_errors_and_session(cluster):
    """Analysis and parse errors fail the statement as USER_ERRORs;
    SET/RESET SESSION ride the X-Presto-Set/Clear-Session headers and
    SHOW SESSION lists the JAX package's properties; a property whose
    feature the port lacks refuses any value, naming its ROADMAP item."""
    from presto_tpu.server.session import SYSTEM_PROPERTIES as REF_PROPS

    url = cluster.coordinator.url
    with pytest.raises(QueryError) as ei:
        execute(url, "select nonexistent_col from nation")
    assert "nonexistent_col" in str(ei.value)
    assert ei.value.error_type == "USER_ERROR"
    with pytest.raises(QueryError) as ei:
        execute(url, "selec 1")
    assert ei.value.error_name == "ParseError"
    session = ClientSession()
    list(StatementClient(url, "set session batch_rows = 4096",
                         session).rows())
    assert session.properties.get("batch_rows") == "4096"
    rows = list(StatementClient(url, "show session", session).rows())
    by_name = {r[0]: r for r in rows}
    assert by_name["batch_rows"][1] == "4096"
    assert set(by_name) == {n for n in REF_PROPS.names()
                            if not REF_PROPS.metadata(n).hidden}
    for name, row in by_name.items():
        meta = REF_PROPS.metadata(name)
        assert row[2:4] == [str(meta.default), meta.py_type.__name__], name
    list(StatementClient(url, "reset session batch_rows", session).rows())
    assert "batch_rows" not in session.properties
    traced = ClientSession()
    list(StatementClient(url, "set session tracing = false", traced).rows())
    assert traced.properties.get("tracing") == "false"
    bad = ClientSession()
    bad.properties["fragment_fusion"] = "false"
    with pytest.raises(QueryError, match="ROADMAP item 12"):
        execute(url, "select 1", bad)
    with pytest.raises(QueryError, match="batch_rows"):
        execute(url, "set session batch_rows = -3")


def test_metadata_and_explain(cluster, port_cat):
    url = cluster.coordinator.url
    _, tables = execute(url, "show tables")
    assert [t[0] for t in tables] == sorted(
        port_cat.connectors["tpch"].table_names())
    _, cols = execute(url, "describe nation")
    assert ["n_name", "varchar"] in cols
    _, cats = execute(url, "show catalogs")
    assert cats == [["tpch"]]
    _, schemas = execute(url, "show schemas")
    assert schemas == [["default"]]
    _, stats = execute(url, "show stats for nation")
    assert stats[-1][0] is None and float(stats[-1][4]) == 25.0
    sql = "select count(*) as c from orders join customer on o_custkey = c_custkey"
    _, rows = execute(url, f"explain {sql}")
    assert "\n".join(r[0] for r in rows) == \
        cluster.coordinator.plan_distributed(sql).to_string()
    _, rows = execute(url, f"explain (type validate) {sql}")
    assert rows == [["VALID"]]
    _, rows = execute(url, f"explain (type logical) {sql}")
    assert "Fragment" not in rows[0][0]
    _, rows = execute(url, f"explain analyze {sql}")
    text = "\n".join(r[0] for r in rows)
    assert "-- task execution profile --" in text
    # the join's output rows, summed over its tasks, are the count
    _, count = execute(url, sql)
    assert sum(int(n.replace(",", "")) for n in re.findall(
        r"HashJoin +rows= *([\d,]+)", text)) == int(count[0][0]), text
    with pytest.raises(QueryError, match="ROADMAP item 17"):
        execute(url, "show functions")
    part = Session(properties={"join_distribution_type": "PARTITIONED"})
    bc = Session(properties={"join_distribution_type": "BROADCAST"})
    assert "broadcast" in cluster.coordinator.plan_distributed(
        sql, bc).to_string()
    assert "broadcast" not in cluster.coordinator.plan_distributed(
        sql, part).to_string()


def test_prepared_statements(cluster):
    url = cluster.coordinator.url
    execute(url, "prepare region_nations from "
                 "select n_name from nation where n_regionkey = ? "
                 "order by n_name")
    _, r1 = execute(url, "execute region_nations using 1")
    _, r2 = execute(url, "execute region_nations using 2")
    assert len(r1) == len(r2) == 5 and r1 != r2
    execute(url, "prepare limited from "
                 "select n_name from nation order by n_name limit ?")
    _, r3 = execute(url, "execute limited using 3")
    assert r3 == sorted(execute(url, "select n_name from nation")[1])[:3]
    with pytest.raises(QueryError):
        execute(url, "execute region_nations using 1, 2")
    execute(url, "deallocate prepare region_nations")
    with pytest.raises(QueryError):
        execute(url, "execute region_nations using 1")


def test_cancel_and_history(cluster):
    """A canceled query reports USER_CANCELED over the protocol (DELETE
    /v1/statement/{id}); /v1/query and /v1/cluster show the history."""
    qm = cluster.coordinator.query_manager
    qe = qm.create_query(Session(), "select 1",
                         execute_fn=lambda s, q: time.sleep(20))
    req = urllib.request.Request(
        f"{cluster.coordinator.url}/v1/statement/{qe.query_id}",
        method="DELETE")
    urllib.request.urlopen(req, timeout=10).read()
    out = cluster.coordinator.protocol.poll(qe.query_id, 0)
    assert out["error"]["errorName"] == "USER_CANCELED"
    execute(cluster.coordinator.url, "select 1 as one from region limit 1")
    with urllib.request.urlopen(f"{cluster.coordinator.url}/v1/query",
                                timeout=10) as r:
        queries = json.loads(r.read())
    states = {q["query_id"]: q["state"] for q in queries}
    assert states[qe.query_id] == "CANCELED"
    assert "FINISHED" in states.values()
    with urllib.request.urlopen(f"{cluster.coordinator.url}/v1/cluster",
                                timeout=10) as r:
        assert json.loads(r.read())["activeWorkers"] == 2


def test_task_failure_fails_the_query(cluster, monkeypatch):
    """A worker task that raises fails the query with its message (a
    deterministic error is not retried)."""
    conn = cluster.catalog.connectors["tpch"]
    calls = []

    def broken(split, columns, device, capacity=None):
        calls.append(1)
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(conn, "read_split", broken)
    with pytest.raises(QueryFailed, match="disk on fire"):
        cluster.run("select count(*) from region where r_regionkey > 1")
    assert calls


def test_worker_revocation_and_graceful_shutdown(port_cat):
    """POST /v1/memory/revoke answers with the revokers it signaled; PUT
    /v1/info/state "SHUTTING_DOWN" drains a worker, which the coordinator
    then takes out of rotation, and queries run on the one left."""
    dr = cluster_of(port_cat)
    try:
        w0 = dr.workers[0]
        for body in (b"{}", b'{"partial": true}'):
            req = urllib.request.Request(
                f"{w0.url}/v1/memory/revoke", data=body, method="POST",
                headers={"X-Presto-Cluster-Secret": w0.cluster_secret})
            with urllib.request.urlopen(req, timeout=10) as r:
                doc = json.loads(r.read())
            assert doc["nodeId"] == "worker-0"
        req = urllib.request.Request(f"{w0.url}/v1/info/state",
                                     data=b'"SHUTTING_DOWN"', method="PUT",
                                     headers={"X-Presto-Cluster-Secret":
                                              w0.cluster_secret})
        urllib.request.urlopen(req, timeout=10).read()
        deadline = time.monotonic() + 20
        while w0.node_state != "shut_down":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        nm = dr.coordinator.node_manager
        assert [n.node_id for n in nm.active_nodes()] == ["worker-1"]
        dr.coordinator.size_monitor.min_workers = 1
        sql = "select count(*) c, sum(o_totalprice) p from orders"
        assert_frames_equal(dr.run(sql),
                            LocalRunner(port_cat, device="cpu").run(sql),
                            "one worker left")
    finally:
        dr.close()


def test_dbapi_and_cli(cluster, port_cat, capsys):
    url = cluster.coordinator.url
    conn = dbapi.connect(url, user="alice", timeout_s=30)
    cur = conn.cursor()
    cur.execute("select n_name, n_regionkey from nation "
                "where n_regionkey = ? and n_name <> '?' order by n_name",
                (1,))
    rows = cur.fetchall()
    want = LocalRunner(port_cat, device="cpu").run(
        "select n_name, n_regionkey from nation where n_regionkey = 1 "
        "order by n_name")
    assert rows == list(want.itertuples(index=False, name=None))
    assert [d[0] for d in cur.description] == ["n_name", "n_regionkey"]
    cur.execute("select count(*) from region")
    assert cur.fetchone() == (5,) and cur.fetchone() is None
    with pytest.raises(dbapi.DatabaseError):
        cur.execute("select bogus from nation")
        cur.fetchall()
    with pytest.raises(dbapi.ProgrammingError):
        cur.execute("select 1 from nation where n_name = ?", ("a", "b"))
    conn.close()
    capsys.readouterr()
    assert cli.main(["--server", url, "--execute",
                     "select r_name, r_regionkey from region "
                     "order by r_name"]) == 0
    out = capsys.readouterr().out.splitlines()
    _, rrows = ref_execute(url, "select r_name, r_regionkey from region "
                                "order by r_name")
    assert out[:-1] == ref_format_table(["r_name", "r_regionkey"],
                                        rrows).split("\n")
    assert out[-1].startswith("(5 rows, ")
    script = "select 'a;b' as x; select 2;\n-- nothing\n"
    assert cli.split_statements(script) == ref_split_statements(script)
    assert cli.main(["--server", url, "--execute", "select bogus"]) == 1


def test_jax_client_reads_port_coordinator(cluster):
    """The JAX package's presto_tpu.client.execute against the port's
    coordinator: the same columns and rows as the port's client."""
    sql = ("select o_orderpriority, count(*) as n, sum(o_totalprice) as p, "
           "min(o_orderdate) as d from orders group by o_orderpriority "
           "order by o_orderpriority")
    assert ref_execute(cluster.coordinator.url, sql) == execute(
        cluster.coordinator.url, sql)


def test_statements_through_cluster(tmp_path):
    """CTAS and INSERT into a memory catalog (source queries run on the
    cluster), and CTAS into Parquet by scaled writers (each root task
    writes its own part, committed by one rename): the tables read back
    as the LocalRunner's."""
    cat = tpch_catalog(SF)
    mem = MemoryConnector("mem")
    cat.register("mem", mem)
    pq_dir = tmp_path / "pq"
    pq_dir.mkdir()
    cat.register("pq", parquet.ParquetConnector(str(pq_dir)))
    src = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice "
           "from orders where o_orderkey < 20000")
    cfg = ExecConfig(batch_rows=1 << 12)
    local = LocalRunner(cat, cfg, device="cpu")
    more = src.replace("o_orderkey < 20000",
                       "o_orderkey between 20000 and 20100")
    n, m = (int(local.run(f"select count(*) c from ({q}) s")["c"][0])
            for q in (src, more))
    dr = cluster_of(cat, cfg)
    try:
        assert dr.run(f"create table mem.t as {src}")["rows"][0] == n
        assert dr.run(f"insert into mem.t {more}")["rows"][0] == m > 0
        # two source tasks, each writing its part of the scan
        assert dr.run(f"create table pq.w as {src}")["rows"][0] == n
        parts = os.listdir(pq_dir / "w.parts")
        assert len(parts) == 2 and not os.path.exists(pq_dir / "w.parts.tmp")
        for t in ("mem.t", "pq.w"):
            sql = f"select * from {t} order by o_orderkey"
            assert_frames_equal(dr.run(sql), local.run(sql), t)
        with pytest.raises(Exception, match="already exists"):
            dr.run(f"create table pq.w as {src}")
    finally:
        dr.close()


# -- launchers and the device default ----------------------------------------


def _launch(args, env):
    p = subprocess.Popen([sys.executable, "-m", "presto_tpu_torch.server",
                          *args], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=REPO)
    return p


def _url_of(p, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = p.stdout.readline()
        if not line:
            break
        if "listening on" in line:
            return line.split("listening on ")[1].split(",")[0].strip()
    raise AssertionError(f"{what} did not start: {line!r}")


def test_launcher_processes_answer_through_dbapi(port_cat):
    """`python -m presto_tpu_torch.server --coordinator --device cpu` and
    one `--worker --device cpu` process: a query through the port's dbapi
    gives the in-process LocalRunner's rows; both processes end in the
    finally."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    with socket.socket() as sk:  # a free port, so both start at once
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    procs = []
    try:
        for args in (["--coordinator", "--port", str(port)],
                     ["--worker", "--coordinator-url", url]):
            procs.append(_launch([*args, "--device", "cpu", "--catalog",
                                  "tpch:sf=0.01", "--timeout-s", "30"], env))
        assert _url_of(procs[0], "coordinator") == url
        _url_of(procs[1], "worker")
        sql = ("select n_regionkey, count(*) as n from nation "
               "group by n_regionkey order by n_regionkey")
        cur = dbapi.connect(url, timeout_s=30).cursor()
        deadline = time.monotonic() + 30
        while True:  # the worker's first announcement may still be on its way
            try:
                cur.execute(sql)
                rows = cur.fetchall()
                break
            except dbapi.DatabaseError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        want = LocalRunner(port_cat, device="cpu").run(sql)
        assert rows == list(want.itertuples(index=False, name=None))
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def test_cluster_runs_on_cuda_unless_asked_for_the_cpu(port_cat):
    """DistributedRunner and the launcher default to CUDA: without a card
    they refuse to start rather than run on the CPU."""
    if torch.cuda.is_available():
        dr = DistributedRunner(port_cat, n_workers=1, **TIMEOUTS)
        try:
            assert dr.coordinator.device.type == "cuda"
            assert dr.workers[0].device.type == "cuda"
        finally:
            dr.close()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedRunner(port_cat, n_workers=1)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.server", "--worker",
         "--catalog", "tpch:sf=0.01"], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=60)
    assert out.returncode != 0 and "CUDA" in out.stderr
