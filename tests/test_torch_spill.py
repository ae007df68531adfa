"""Memory-bounded execution of the port against the JAX package, through
LocalRunner on the CPU: GRACE aggregation, the memory pool and spilled
hash joins, radix partitioning and the multiway join (the cases of the JAX
package's tests/test_grace_agg.py, test_memory_spill.py, test_radix.py and
test_multiway_join.py without their distributed, HBO and plan-check
cases), under the breaker engines sort and hash.

Each port configuration is held to ONE frame of the JAX package a query
and table, computed once in the session under its default configuration
and shared between the test processes (`Reference`; the TPC-H ones are
tests/test_torch_tpch.py's frames). An inner and a LEFT join are held to
the rows of the same tables' FULL join frame where both sides, or the
probe side, are present, and a global aggregate to the totals of a
grouped frame. A few JAX runs under the spill configurations, on tables
of a few thousand rows, give the spill.* counters the port's must equal
(and one of them its table's frame).
The multiway parity matrix holds every cell's multiway run and the port's
binary run of the same query (join_mode "off") to the JAX package's frame
of that query, cut from its frame of the all-LEFT four-join chain on the
same tables (`_mw_cell`); two cells are also run by the JAX package
itself, which checks the cut. Floats at rtol=1e-12, everything else
exact; rows compared as sorted multisets unless the query's ORDER BY
fixes them.
"""

import os

import numpy as np
import pandas as pd
import pytest

from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.types import DecimalType as RefDecimal
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.catalog.tpch import tpch_catalog
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.exec.runtime import ExecContext, execute_node, run_plan
from presto_tpu_torch.memory import ExceededMemoryLimit
from presto_tpu_torch.spiller import SpillLimitExceeded
from presto_tpu_torch.types import DecimalType

from test_torch_tpch import (  # noqa: F401 — fixtures
    TPCH,
    assert_frames_equal,
    one_torch_thread,
    reference_frame,
    reference_frames_dir,
    shared,
)

ENGINES = ("sort", "hash")
COUNTERS = ("spill.partitions", "spill.repartitions", "spill.revocations",
            "spill.role_reversals")


def _canon(v):
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return None
    if isinstance(v, np.generic):
        return v.item()
    return v


def assert_same_rows(got: pd.DataFrame, want: pd.DataFrame, where,
                     rtol=1e-12):
    """The same columns and the same rows as multisets: rows sorted by
    their non-float columns, then their floats; floats to rtol."""
    assert list(got.columns) == list(want.columns), where
    assert len(got) == len(want), (where, len(got), len(want))

    def rows(df):
        cols = [[_canon(v) for v in df[c]] for c in df.columns]
        floats = [i for i, col in enumerate(cols)
                  if any(isinstance(v, float) for v in col)]
        order = [i for i in range(len(cols)) if i not in floats] + floats
        out = [tuple(col[r] for col in cols) for r in range(len(df))]
        return sorted(out, key=lambda t: tuple(
            (t[i] is None, t[i] if t[i] is not None else 0) for i in order))

    g, w = rows(got), rows(want)
    for c, name in enumerate(got.columns):
        gc, wc = [r[c] for r in g], [r[c] for r in w]
        present = [v for v in gc + wc if v is not None]
        if present and all(isinstance(v, float) for v in present):
            assert [v is None for v in gc] == [v is None for v in wc], \
                (where, name)
            np.testing.assert_allclose(
                np.array([np.nan if v is None else v for v in gc], float),
                np.array([np.nan if v is None else v for v in wc], float),
                rtol=rtol, atol=0, err_msg=f"{where} {name}")
        else:
            assert gc == wc, (where, name)


def _catalogs(build):
    """(JAX package catalog, port catalog) over the same tables:
    `build(conn)` adds them to a connector of either package."""
    rc, rconn = RefCatalog(), RefMemory()
    build(rconn)
    rc.register("m", rconn, default=True)
    pc, pconn = Catalog(), MemoryConnector()
    build(pconn)
    pc.register("m", pconn, default=True)
    return rc, pc


class Reference:
    """The JAX package's answers over one group of tables: each frame
    (and each run's spill.* counters) computed once in the session and
    shared between the test processes."""

    def __init__(self, rc, frames_dir, group: str):
        self.rc, self.frames_dir, self.group = rc, frames_dir, group
        self._memo = {}

    def _get(self, name, compute):
        key = f"{self.group}_{name}"
        if key not in self._memo:
            self._memo[key] = shared(self.frames_dir,
                                     f"spill_reference_{key}", compute)
        return self._memo[key]

    def frame(self, name: str, sql: str, **cfg):
        """The frame of `sql` under `cfg`."""
        return self._get(name, lambda: RefRunner(self.rc,
                                                 RefConfig(**cfg)).run(sql))

    def spilled(self, name: str, sql: str, **cfg):
        """(frame, spill.* counters) of `sql` under the spill config `cfg`
        on the per-batch path with one merge in flight (the port merges
        synchronously, so its pool sees what that path accounts)."""
        def run():
            r = RefRunner(self.rc, RefConfig(fragment_fusion=False,
                                             agg_pipeline_depth=1, **cfg))
            frame = r.run(sql)
            return frame, {k: r.last_stats.get(k, 0) for k in COUNTERS}
        return self._get(f"spilled_{name}", run)


def _port(pc, sql, engine, **cfg):
    r = LocalRunner(pc, ExecConfig(breaker_engine=engine, **cfg),
                    device="cpu")
    return r.run(sql), r.last_stats


def _counters(stats):
    return {k: stats.get(k, 0) for k in COUNTERS}


def _rows_where(frame: pd.DataFrame, columns, present):
    """The rows of a FULL join's frame where every column of `present`
    holds a value, cut to `columns`: its inner (both sides present) or
    LEFT (the probe side present) join."""
    keep = np.ones(len(frame), bool)
    for c in present:
        keep &= np.array([_canon(v) is not None for v in frame[c]])
    return frame[list(columns)][keep].reset_index(drop=True)


# ---------------------------------------------------------------------------
# GRACE aggregation (tests/test_grace_agg.py)

GRACE_N, GRACE_NDV = 8_000, 3_000
GRACE_SQL = ("select g, count(*) as c, count(x) as cx, sum(x) as sx, "
             "min(f) as mn, max(s) as mx from t group by g")
GRACE_SMALL_SQL = "select g, count(*) as c, sum(v) as s from small group by g"
GRACE_SMALL_CFG = dict(batch_rows=1 << 11, agg_capacity=1 << 7,
                       agg_cap_ceiling=1 << 8, spill_partitions=4)


def _grace_tables(conn):
    rng = np.random.default_rng(23)
    g = rng.integers(0, GRACE_NDV, GRACE_N)
    g[rng.random(GRACE_N) < 0.25] = 7  # a hot group: a quarter of the rows
    g = pd.array(g, dtype="Int64")
    g[::17] = pd.NA  # NULL keys: one group, in one partition
    x = pd.array(rng.integers(0, 1000, GRACE_N), dtype="Int64")
    x[::11] = pd.NA
    conn.add_table("t", pd.DataFrame({
        "g": g, "x": x, "f": rng.normal(size=GRACE_N),
        "s": np.array([f"name{v % 97}" for v in
                       rng.integers(0, GRACE_NDV, GRACE_N)])}))
    rng = np.random.default_rng(41)
    conn.add_table("small", pd.DataFrame({
        "g": rng.permutation(1_200), "v": rng.integers(0, 9, 1_200)}))


@pytest.fixture(scope="module")
def grace_catalogs():
    return _catalogs(_grace_tables)


@pytest.fixture(scope="module")
def grace_refs(grace_catalogs, reference_frames_dir):
    return Reference(grace_catalogs[0], reference_frames_dir, "grace")


GRACE_CONFIGS = {
    # presize past the ceiling: GRACE from the start, and ~700 groups a
    # partition against a 512 ceiling force recursive repartitioning
    "from_start": dict(batch_rows=1 << 12, agg_capacity=1 << 8,
                       agg_cap_ceiling=1 << 9, spill_partitions=4),
    # growth crosses the ceiling mid-stream: accumulator to state pages,
    # the rest of the input to raw partitions
    "midstream": dict(batch_rows=1 << 11, agg_capacity=1 << 6,
                      agg_cap_ceiling=1 << 10, spill_partitions=4),
    "tight_pool": dict(batch_rows=1 << 11, agg_capacity=1 << 8,
                       agg_cap_ceiling=1 << 10, memory_pool_bytes=24_000_000,
                       spill_partitions=16),
    # no GRACE: the table passes the pool's revoke threshold and spills
    # as state pages
    "pool": dict(batch_rows=1 << 11, agg_capacity=1 << 10,
                 memory_pool_bytes=200 << 10, spill_partitions=4),
    # the table passes the revoke threshold (state pages), then outgrows
    # the ceiling mid-stream (raw GRACE)
    "pool_revocation": dict(batch_rows=1 << 11, agg_capacity=1 << 7,
                            agg_cap_ceiling=1 << 10,
                            memory_pool_bytes=160 << 10,
                            memory_revoking_threshold=0.5,
                            memory_revoking_target=0.2),
    "spill_off": dict(batch_rows=1 << 11, agg_capacity=1 << 7,
                      agg_cap_ceiling=1 << 9, spill_enabled=False),
    # the presize (~3,500 groups) passes agg_capacity: radix engages
    "radix": dict(batch_rows=1 << 11, agg_capacity=1 << 10,
                  radix_partitions=8),
    "radix_forced_spill": dict(batch_rows=1 << 11, agg_capacity=1 << 10,
                               radix_partitions=4,
                               join_spill_budget_bytes=1),
    # a 16-group ceiling: the hot group alone fills its partition, which
    # never splits (one key), while ~2,800 others split two levels down
    "skewed_tiny_ceiling": dict(batch_rows=1 << 12, agg_capacity=1 << 4,
                                agg_cap_ceiling=1 << 4, spill_partitions=16),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("config", list(GRACE_CONFIGS))
def test_grace_matches_reference(grace_catalogs, grace_refs, config, engine):
    """GRACE from the start, in mid-stream, under pools and under a
    ceiling the hot group alone fills (with NULL keys and NULL values),
    radix-partitioned (a high-NDV group-by, NULL keys; every partition to
    host files where forced), against the JAX package's in-memory
    frame."""
    _, pc = grace_catalogs
    want = grace_refs.frame("t", GRACE_SQL)
    assert len(want) > GRACE_NDV * 0.8  # far above every ceiling here
    got, stats = _port(pc, GRACE_SQL, engine, **GRACE_CONFIGS[config])
    assert_same_rows(got, want, (config, engine))
    spills = stats.get("spill.partitions", 0)
    if config in ("from_start", "midstream", "tight_pool", "pool",
                  "pool_revocation", "skewed_tiny_ceiling"):
        assert spills > 0, config
    if config in ("from_start", "skewed_tiny_ceiling"):
        assert stats.get("spill.repartitions", 0) > 0
    if config.startswith("radix"):
        assert stats.get("radix.agg_engaged") == 1
    if config == "radix_forced_spill":
        assert stats.get("radix.partitions_spilled", 0) >= 1
    if config == "spill_off":
        assert spills == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_grace_config_global_aggregate(grace_catalogs, grace_refs, engine):
    """A global aggregate under the GRACE configuration never spills; its
    totals are those of the JAX package's grouped frame."""
    _, pc = grace_catalogs
    want = grace_refs.frame("t", GRACE_SQL)
    got, stats = _port(pc, "select count(*) as c, count(x) as cx, "
                       "sum(x) as sx from t", engine,
                       **GRACE_CONFIGS["from_start"])
    assert got.to_dict("records") == [{
        "c": int(want["c"].sum()), "cx": int(want["cx"].sum()),
        "sx": int(sum(v for v in want["sx"] if _canon(v) is not None))}]
    assert "spill.partitions" not in stats


def test_grace_counters_match_reference(grace_catalogs, grace_refs):
    """GRACE from the start with recursive repartitioning on a table of
    1,200 rows: the port's spill counters are the JAX package's."""
    _, pc = grace_catalogs
    _, want = grace_refs.spilled("small", GRACE_SMALL_SQL, **GRACE_SMALL_CFG)
    assert want["spill.repartitions"] > 0
    for engine in ENGINES:
        _, stats = _port(pc, GRACE_SMALL_SQL, engine, **GRACE_SMALL_CFG)
        assert _counters(stats) == want, engine


def test_grace_depth_bound_fails_structured(grace_catalogs):
    """spill_max_depth=0 forbids recursive repartitioning: a partition over
    the ceiling fails with SpillLimitExceeded, and no spill file stays."""
    _, pc = grace_catalogs
    r = LocalRunner(pc, ExecConfig(
        batch_rows=1 << 12, agg_capacity=1 << 8, agg_cap_ceiling=1 << 9,
        spill_partitions=4, spill_max_depth=0), device="cpu")
    ctx = ExecContext(pc, r.config, r.device)
    with pytest.raises(SpillLimitExceeded, match="grace ceiling"):
        run_plan(r.plan(GRACE_SQL), ctx)
    assert ctx.spill_manager.in_use_bytes == 0
    assert os.listdir(ctx.spill_manager.dir) == []


def test_tiny_pool_without_spill_fails(grace_catalogs):
    _, pc = grace_catalogs
    r = LocalRunner(pc, ExecConfig(batch_rows=1 << 11, agg_capacity=1 << 7,
                                   spill_enabled=False,
                                   memory_pool_bytes=64 << 10), device="cpu")
    with pytest.raises(ExceededMemoryLimit, match="memory limit"):
        r.run(GRACE_SQL)


# ---------------------------------------------------------------------------
# the pool and spilled hash joins (tests/test_memory_spill.py)


def _spill_tables(conn):
    rng = np.random.default_rng(1234)
    n = 20_000
    conn.add_table("facts", pd.DataFrame({
        "g": rng.integers(0, 7_000, n), "v": rng.normal(size=n),
        "k": rng.integers(0, 5_000, n)}))
    conn.add_table("dim", pd.DataFrame({"id": np.arange(5_000),
                                        "w": rng.normal(size=5_000)}))
    # string keys on two dictionaries: the build's is a superset
    conn.add_table("sf", pd.DataFrame({
        "sk": [f"k{i:05d}" for i in rng.integers(0, 3000, 20_000)],
        "v": rng.normal(size=20_000)}))
    conn.add_table("sd", pd.DataFrame({
        "dk": [f"k{i:05d}" for i in range(4000)],
        "w": rng.normal(size=4000)}))
    # one-hot build keys: 95% of the build rows share one key, the rest
    # six others (fewer keys than partitions); the probe's keys range over
    # twenty (build partitions empty where the probe's are not)
    bk = np.where(rng.random(400) < 0.95, 7,
                  rng.integers(0, 6, 400)).astype(np.int64)
    conn.add_table("hp", pd.DataFrame({
        "k": rng.integers(0, 20, 800).astype(np.int64),
        "v": rng.normal(size=800)}))
    conn.add_table("hb", pd.DataFrame({"bk": bk,
                                       "w": rng.normal(size=400)}))
    conn.add_table("za", pd.DataFrame({"k": np.zeros(10_000, np.int64),
                                       "v": rng.normal(size=10_000)}))
    conn.add_table("zb", pd.DataFrame({"j": np.zeros(10_000, np.int64),
                                       "w": rng.normal(size=10_000)}))


@pytest.fixture(scope="module")
def spill_catalogs():
    return _catalogs(_spill_tables)


@pytest.fixture(scope="module")
def spill_refs(spill_catalogs, reference_frames_dir):
    return Reference(spill_catalogs[0], reference_frames_dir, "spill")


FACTS = "(select k, v from facts where g < 1000) f"
# the inner and LEFT joins' frames are the FULL join's rows where both
# sides, or the probe side, are present (f.v and dim.w are never NULL)
JOIN_KINDS = {"inner": ("join", ("v", "w")), "left": ("left join", ("v",)),
              "full": ("full join", ())}
POOL = dict(memory_pool_bytes=100 << 10, spill_partitions=4)
SPILL_CASES = {
    # name: (FROM clause, port config); each runs under both engines
    "inner_pool": ("inner", POOL),
    "inner_radix": ("inner", dict(radix_partitions=8)),
    "inner_radix_forced_spill": ("inner", dict(radix_partitions=4,
                                               join_spill_budget_bytes=1)),
    "left_pool": ("left", POOL),
    "full_pool": ("full", POOL),
    "full_radix_forced_spill": ("full", dict(radix_partitions=4,
                                             join_spill_budget_bytes=1)),
}
HOT_SQL = "select hp.v, hb.w from hp join hb on hp.k = hb.bk"
OTHER_JOINS = {
    # name: (SQL, port config)
    "strings_cross_dictionary": ("select sd.w, sf.v from sf join sd "
                                 "on sf.sk = sd.dk",
                                 dict(memory_pool_bytes=48 << 10,
                                      spill_partitions=4)),
    "role_reversal": (HOT_SQL, dict(memory_pool_bytes=8 << 10,
                                    spill_partitions=4, spill_max_depth=2)),
    # a pool just under the build batch (it spills) and over its hot
    # partition replayed (8,704 bytes at capacity 512)
    "zero_row_partitions": (HOT_SQL, dict(memory_pool_bytes=9 << 10,
                                          spill_partitions=8,
                                          join_spill_budget_bytes=8 << 10)),
}


def _facts_join(kind):
    return (f"select f.k, f.v, dim.id, dim.w from {FACTS} "
            f"{JOIN_KINDS[kind][0]} dim on f.k = dim.id")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(SPILL_CASES))
def test_join_kinds_spill_like_reference(spill_catalogs, spill_refs, case,
                                         engine):
    """Inner, LEFT and FULL joins under a pool that spills both sides, and
    radix-partitioned (every partition to host files where forced): a
    FULL join's unmatched build rows come out of every partition."""
    _, pc = spill_catalogs
    kind, cfg = SPILL_CASES[case]
    full = spill_refs.frame("facts_full", _facts_join("full"),
                            batch_rows=1 << 13)
    want = _rows_where(full, full.columns, JOIN_KINDS[kind][1])
    got, stats = _port(pc, _facts_join(kind), engine, batch_rows=1 << 13,
                       **cfg)
    assert_same_rows(got, want, (case, engine))
    if "pool" in case:
        assert stats.get("spill.partitions", 0) > 0, "did not spill"
    if case.endswith("forced_spill"):
        assert stats.get("radix.partitions_spilled", 0) >= 1


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(OTHER_JOINS))
def test_spilled_join_matches_reference(spill_catalogs, spill_refs, case,
                                        engine):
    """String keys on two dictionaries (partitioned by content); one-hot
    build keys (role reversal after repartitioning) and empty partitions
    on either side. (Many thin keys: the dim joins above.)"""
    _, pc = spill_catalogs
    sql, cfg = OTHER_JOINS[case]
    if sql == HOT_SQL:
        # the JAX package's run under the role-reversal spill config
        rr_sql, rr_cfg = OTHER_JOINS["role_reversal"]
        want, _ = spill_refs.spilled("hot", rr_sql, batch_rows=1 << 13,
                                     **rr_cfg)
    else:
        want = spill_refs.frame(case, sql, batch_rows=1 << 13)
    got, stats = _port(pc, sql, engine, batch_rows=1 << 13, **cfg)
    assert_same_rows(got, want, (case, engine))
    assert stats.get("spill.partitions", 0) > 0, "did not spill"
    if case == "role_reversal":
        assert stats.get("spill.role_reversals", 0) > 0
        assert stats.get("spill.repartitions", 0) > 0


def test_join_spill_counters_match_reference(spill_catalogs, spill_refs):
    """Role reversal and recursive repartitioning of a skewed spilled
    join: the port's spill counters are the JAX package's."""
    _, pc = spill_catalogs
    sql, cfg = OTHER_JOINS["role_reversal"]
    _, want = spill_refs.spilled("hot", sql, batch_rows=1 << 13, **cfg)
    assert want["spill.role_reversals"] > 0
    for engine in ENGINES:
        _, stats = _port(pc, sql, engine, batch_rows=1 << 13, **cfg)
        assert _counters(stats) == want, engine


def test_memory_limit_without_spill_fails(spill_catalogs):
    _, pc = spill_catalogs
    r = LocalRunner(pc, ExecConfig(batch_rows=1 << 13,
                                   memory_pool_bytes=128 << 10,
                                   spill_enabled=False), device="cpu")
    with pytest.raises(ExceededMemoryLimit):
        r.run("select g, sum(v) as s from facts group by g")


def test_spilled_join_depth_bound_fails_structured(spill_catalogs):
    """Identical keys on both sides: no hash bit splits the partition and
    reversal cannot help; recursion stops at spill_max_depth with
    SpillLimitExceeded, and no spill file stays."""
    _, pc = spill_catalogs
    r = LocalRunner(pc, ExecConfig(batch_rows=1 << 13,
                                   memory_pool_bytes=128 << 10,
                                   spill_partitions=4, spill_max_depth=2),
                    device="cpu")
    ctx = ExecContext(pc, r.config, r.device)
    with pytest.raises(SpillLimitExceeded, match="max recursion depth"):
        run_plan(r.plan("select za.v, zb.w from za join zb on za.k = zb.j"),
                 ctx)
    assert os.listdir(ctx.spill_manager.dir) == []


def test_spill_leak_guard_on_mid_spill_failure(spill_catalogs):
    """A query killed mid-spill (the spill directory's byte budget) leaves
    no spill file: run_plan closes every spill resource it opened."""
    _, pc = spill_catalogs
    r = LocalRunner(pc, ExecConfig(
        batch_rows=1 << 13, memory_pool_bytes=100 << 10, spill_partitions=4,
        spill_dir_budget_bytes=24 << 10), device="cpu")
    ctx = ExecContext(pc, r.config, r.device)
    with pytest.raises(SpillLimitExceeded, match="byte budget"):
        run_plan(r.plan("select dim.w, facts.v from facts join dim "
                        "on facts.k = dim.id"), ctx)
    assert ctx.spill_manager.in_use_bytes == 0
    assert os.listdir(ctx.spill_manager.dir) == []


def test_spill_leak_guard_on_cancel(spill_catalogs, tmp_path):
    """An abandoned query leaves its spill generators open; cleanup_spill
    still unlinks every file (here in a spill_dir the caller names)."""
    _, pc = spill_catalogs
    cfg = ExecConfig(batch_rows=1 << 13, memory_pool_bytes=100 << 10,
                     spill_partitions=4, spill_dir=str(tmp_path))
    r = LocalRunner(pc, cfg, device="cpu")
    qp = r.plan("select dim.w, facts.v from facts join dim "
                "on facts.k = dim.id")
    ctx = ExecContext(pc, cfg, r.device)
    stream = execute_node(qp.root.child, ctx)
    next(stream)  # the join has spilled and is replaying
    assert ctx.spill_resources and ctx.spill_manager.in_use_bytes > 0
    assert os.listdir(tmp_path)
    ctx.cleanup_spill()
    assert ctx.spill_manager.in_use_bytes == 0
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# radix partitioning (tests/test_radix.py: QUERIES x VARIANTS)


def _radix_tables(conn):
    rng = np.random.default_rng(7)
    n, m = 1_500, 300
    build_id = rng.integers(0, 200, m).tolist()
    for i in range(0, m, 9):  # NULL build keys never match
        build_id[i] = None
    conn.add_table("build", {
        "id": build_id,
        "name": rng.choice(["alpha", "beta", "gamma", "delta"], m).tolist()})
    probe_fk = rng.integers(0, 260, n).tolist()
    for i in range(0, n, 11):  # NULL probe keys never match
        probe_fk[i] = None
    conn.add_table("probe", {"fk": probe_fk, "v": rng.normal(size=n).tolist(),
                             "g": rng.choice(["x", "y", "z", "w", "q"],
                                             n).tolist()})
    # long-decimal sums past int64
    cents = rng.integers(89_000_000_000_000_000, 90_000_000_000_000_000,
                         2_400)
    dec = (RefDecimal if isinstance(conn, RefMemory) else DecimalType)(15, 2)
    conn.add_generated("big", {"g": rng.integers(0, 20, 2_400),
                               "dv": ("raw_decimal", dec, cents)})


@pytest.fixture(scope="module")
def radix_catalogs():
    return _catalogs(_radix_tables)


@pytest.fixture(scope="module")
def radix_refs(radix_catalogs, reference_frames_dir):
    return Reference(radix_catalogs[0], reference_frames_dir, "radix")


RADIX_FULL = ("select p.fk, p.v, b.id, b.name from probe p "
              "full outer join build b on p.fk = b.id")
RADIX_QUERIES = {
    "inner": "select p.fk, p.v, b.name from probe p "
             "join build b on p.fk = b.id",
    "left": "select p.fk, p.v, b.name from probe p "
            "left join build b on p.fk = b.id",
    "full_outer": RADIX_FULL,
    "varchar_key": "select p.g, count(*) as c from probe p "
                   "join build b on p.fk = b.id group by p.g",
    "groupby_dict_key": "select g, count(*) as c, avg(v) as a "
                        "from probe group by g",
    "long_decimal_sum": "select g, sum(dv) as s, count(*) as c "
                        "from big group by g",
}
# (the JAX package's two other radix queries, a high-NDV group-by and NULL
# group keys, are GRACE_SQL's "radix" and "radix_forced_spill" above)
# the inner and LEFT joins' frames are the FULL join's rows with both
# sides, or the probe side, present (p.v is never NULL, and a build row
# that matched has its id)
RADIX_FROM_FULL = {"inner": ("v", "id"), "left": ("v",)}
RADIX_VARIANTS = {
    "radix": dict(radix_partitions=8),
    # a 1-byte budget: every partition takes the hybrid spill
    "forced_spill": dict(radix_partitions=4, join_spill_budget_bytes=1),
}


def _radix_want(refs, query):
    if query in RADIX_FROM_FULL:
        full = refs.frame("full_outer", RADIX_FULL, batch_rows=1 << 11)
        return _rows_where(full, ["fk", "v", "name"], RADIX_FROM_FULL[query])
    return refs.frame(query, RADIX_QUERIES[query], batch_rows=1 << 11)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", list(RADIX_VARIANTS))
@pytest.mark.parametrize("query", list(RADIX_QUERIES))
def test_radix_matches_reference(radix_catalogs, radix_refs, query, variant,
                                 engine):
    _, pc = radix_catalogs
    want = _radix_want(radix_refs, query)
    got, _ = _port(pc, RADIX_QUERIES[query], engine, batch_rows=1 << 11,
                   **RADIX_VARIANTS[variant])
    assert_same_rows(got, want, (query, variant, engine))


def test_radix_agg_gate(radix_catalogs):
    """A presize within agg_capacity (5 distinct g) keeps the radix
    group-by off without a spill budget; one past it (about 260 distinct
    fk against 256), or any budget, opens it; a forced spill spills."""
    _, pc = radix_catalogs
    r = LocalRunner(pc, ExecConfig(batch_rows=1 << 11, radix_partitions=8,
                                   agg_capacity=1 << 8), device="cpu")
    r.run(RADIX_QUERIES["groupby_dict_key"])
    assert "radix.agg_engaged" not in r.last_stats
    r.run("select fk, count(*) as c from probe group by fk")
    assert r.last_stats.get("radix.agg_engaged")
    rb = LocalRunner(pc, ExecConfig(batch_rows=1 << 11, radix_partitions=8,
                                    join_spill_budget_bytes=1 << 30),
                     device="cpu")
    rb.run(RADIX_QUERIES["groupby_dict_key"])
    assert rb.last_stats.get("radix.agg_engaged")
    rs = LocalRunner(pc, ExecConfig(batch_rows=1 << 11, radix_partitions=4,
                                    join_spill_budget_bytes=1), device="cpu")
    rs.run(RADIX_QUERIES["inner"])
    assert rs.last_stats.get("radix.partitions_spilled", 0) >= 1
    assert rs.last_stats.get("radix.spill_bytes", 0) > 0
    with pytest.raises(ValueError, match="power of two"):
        LocalRunner(pc, ExecConfig(radix_partitions=6),
                    device="cpu").run(RADIX_QUERIES["inner"])


# ---------------------------------------------------------------------------
# the multiway join (tests/test_multiway_join.py)


def _star_tables(n_fact=600, ndv=211, skew=False, nulls=False,
                 dup_dims=False, seed=11):
    """Fact table f(rid, k1..k4, v) and dims d1..d4(p_i, a_i), as in the
    JAX package's test: `skew` puts 90% of the fact keys on one value,
    `nulls` NULL fact keys, `dup_dims` two payload rows a dim key (fanout
    legs); 10% of the fact keys miss every dim."""
    def build(conn):
        rng = np.random.default_rng(seed)
        f = {"rid": np.arange(n_fact), "v": rng.normal(0.0, 10.0, n_fact)}
        for i in range(1, 5):
            k = rng.integers(0, ndv, size=n_fact)
            if skew:
                k = np.where(rng.random(n_fact) < 0.9, ndv // 2, k)
            k = np.where(rng.random(n_fact) < 0.1, ndv + 17, k)
            col = pd.array(k, dtype="Int64")
            if nulls:
                col[rng.random(n_fact) < 0.08] = pd.NA
            f[f"k{i}"] = col
        conn.add_table("f", pd.DataFrame(f))
        for i in range(1, 5):
            p = np.arange(ndv)
            if dup_dims:
                p = np.repeat(p, 2)
            conn.add_table(f"d{i}", pd.DataFrame({
                f"p{i}": p,
                f"a{i}": [f"d{i}_{int(x)}_{j % 2}" for j, x in enumerate(p)]}))
    return build


def _chain_sql(n_joins, kinds):
    sel = ["f.rid", "f.v"] + [f"d{i}.a{i}" for i in range(1, n_joins + 1)]
    joins = "".join(f" {k} join d{i} on f.k{i} = d{i}.p{i}"
                    for i, k in zip(range(1, n_joins + 1), kinds))
    return f"select {', '.join(sel)} from f{joins}"


SHAPES = {
    "plain": dict(ndv=211),
    "skew+dup": dict(ndv=7, skew=True, dup_dims=True),
    "nulls": dict(ndv=97, nulls=True),
}
# the cells that the JAX package also runs itself: NULL keys, and skewed
# fanout legs, inner and LEFT
REF_CELLS = {("nulls", 3, "inner"), ("skew+dup", 2, "mixed")}


@pytest.fixture(scope="module")
def star_catalogs():
    return {s: _catalogs(_star_tables(**kw)) for s, kw in SHAPES.items()}


def _kind_list(n_joins, kinds):
    return (["inner"] * n_joins if kinds == "inner"
            else [("left" if i % 2 else "inner") for i in range(n_joins)])


@pytest.fixture(scope="module")
def mw_refs(star_catalogs, reference_frames_dir):
    return {shape: Reference(star_catalogs[shape][0], reference_frames_dir,
                             f"mw_{shape}") for shape in SHAPES}


def _mw_want(mw_refs, shape, n_joins, kinds):
    sql = _chain_sql(n_joins, _kind_list(n_joins, kinds))
    return mw_refs[shape].frame(f"{n_joins}_{kinds}", sql,
                                batch_rows=1 << 11)


def _mw_cell(mw_refs, shape, n_joins, kinds):
    """The JAX package's frame of a chain of `n_joins` legs, cut from its
    frame of the four-leg chain with every leg LEFT. The legs are
    independent (each keyed on its own fact column), so that frame holds,
    for every fact row, each leg's matches (or one NULL where it has none)
    in every combination: the first n legs' columns, without repeats,
    with a non-NULL payload on every inner leg, are the chain's rows (a
    fact row's combinations are distinct, as rid is unique and a dim key's
    payloads differ)."""
    full = mw_refs[shape].frame("4_left", _chain_sql(4, ["left"] * 4),
                                batch_rows=1 << 11)
    legs = _kind_list(n_joins, kinds)
    cols = ["rid", "v"] + [f"a{i}" for i in range(1, n_joins + 1)]
    inner = [f"a{i}" for i, k in enumerate(legs, 1) if k == "inner"]
    return (_rows_where(full, cols, inner).drop_duplicates()
            .reset_index(drop=True))


# each shape under one engine, and the fanout legs (skew+dup) under both:
# sort sends a LEFT fanout leg to the binary cascade, hash runs it fused
MATRIX_ENGINES = [("plain", "hash"), ("nulls", "sort"), ("skew+dup", "sort"),
                  ("skew+dup", "hash")]


@pytest.mark.parametrize("shape, engine", MATRIX_ENGINES)
@pytest.mark.parametrize("kinds", ["inner", "mixed"])
@pytest.mark.parametrize("n_joins", [2, 3, 4])
def test_multiway_parity_matrix(star_catalogs, mw_refs, n_joins, kinds, shape,
                                engine):
    _, pc = star_catalogs[shape]
    sql = _chain_sql(n_joins, _kind_list(n_joins, kinds))
    where = (n_joins, kinds, shape, engine)
    want = _mw_cell(mw_refs, shape, n_joins, kinds)
    if (shape, n_joins, kinds) in REF_CELLS:
        assert_same_rows(want, _mw_want(mw_refs, shape, n_joins, kinds),
                         ("cut", *where))
    base = dict(batch_rows=1 << 10)
    off, _ = _port(pc, sql, engine, join_mode="off", **base)
    assert_same_rows(off, want, ("off", *where))
    got, stats = _port(pc, sql, engine, join_mode="multiway", **base)
    assert_same_rows(got, want, where)
    assert stats.get("multiway.joins", 0) >= 1
    assert stats.get("multiway.legs", 0) >= n_joins
    fanout_left = shape == "skew+dup" and kinds == "mixed"
    if fanout_left and engine == "sort":
        # a LEFT fanout leg without exact counts: the binary cascade
        assert stats.get("multiway.cascade_fallbacks", 0) >= 1
    if fanout_left and engine == "hash":
        assert stats.get("multiway.fused_dispatches", 0) >= 1


@pytest.mark.parametrize("engine", ENGINES)
def test_multiway_build_pressure_falls_back_to_cascade(star_catalogs, mw_refs,
                                                      engine):
    """A build past the pool while collecting: the node hands what it
    collected to the binary cascade, whose legs spill."""
    _, pc = star_catalogs["nulls"]
    sql = _chain_sql(3, _kind_list(3, "inner"))
    want = _mw_want(mw_refs, "nulls", 3, "inner")
    got, stats = _port(pc, sql, engine, batch_rows=1 << 10,
                       join_mode="multiway", memory_pool_bytes=5 << 10)
    assert_same_rows(got, want, engine)
    assert stats.get("multiway.cascade_fallbacks", 0) >= 1
    assert stats.get("spill.partitions", 0) >= 1


def test_multiway_explain_and_modes(star_catalogs):
    _, pc = star_catalogs["plain"]
    sql = _chain_sql(2, ["inner", "inner"])
    out = LocalRunner(pc, ExecConfig(join_mode="multiway"),
                      device="cpu").explain(sql)
    assert "MultiwayJoin" in out and "[join=multiway" in out
    assert "session join_mode=multiway" in out
    out = LocalRunner(pc, ExecConfig(join_mode="off"),
                      device="cpu").explain(sql)
    assert "MultiwayJoin" not in out and "[join=" not in out
    out = LocalRunner(pc, ExecConfig(join_mode="binary"),
                      device="cpu").explain(sql)
    assert "[join=binary: session join_mode=binary]" in out
    single = "select f.rid, d1.a1 from f join d1 on f.k1 = d1.p1"
    assert "MultiwayJoin" not in LocalRunner(
        pc, ExecConfig(join_mode="multiway"), device="cpu").explain(single)


def test_residual_join_not_collapsed():
    """A chain join with a residual is never collapsed (the one-pass probe
    has no residual slot), even under forced multiway."""
    from presto_tpu_torch.expr.ir import Constant
    from presto_tpu_torch.plan.multiway import collapse_multiway
    from presto_tpu_torch.plan.nodes import HashJoin, MultiwayJoin, TableScan
    from presto_tpu_torch.types import BIGINT, BOOLEAN

    def scan(cols):
        return TableScan(catalog="m", table="t",
                         assignments={s: s for s, _ in cols},
                         output=list(cols))

    def tree(residual):
        j0 = HashJoin("inner", scan([("k1", BIGINT), ("k2", BIGINT)]),
                      scan([("p1", BIGINT)]), ["k1"], ["p1"])
        return HashJoin("inner", j0, scan([("p2", BIGINT)]), ["k2"], ["p2"],
                        residual=residual)

    assert isinstance(collapse_multiway(tree(None), None, mode="multiway"),
                      MultiwayJoin)
    kept = collapse_multiway(tree(Constant(BOOLEAN, True)), None,
                             mode="multiway")
    assert isinstance(kept, HashJoin) and not isinstance(kept.left,
                                                         MultiwayJoin)


# ---------------------------------------------------------------------------
# TPC-H at SF 0.01, held to tests/test_torch_tpch.py's shared frames


@pytest.fixture(scope="module")
def tpch_catalogs():
    from presto_tpu.catalog.tpch import tpch_catalog as ref_tpch_catalog

    return ref_tpch_catalog(0.01), tpch_catalog(0.01)


TPCH_CASES = {
    # name: (query, port config)
    "q3_multiway": ("q3", dict(join_mode="multiway")),
    "q5_multiway": ("q5", dict(join_mode="multiway")),
    "q9_multiway": ("q9", dict(join_mode="multiway")),
    "q10_multiway": ("q10", dict(join_mode="multiway")),
    "q7_multiway": ("q7", dict(join_mode="multiway")),
    "q8_multiway": ("q8", dict(join_mode="multiway")),
    "q3_radix": ("q3", dict(radix_partitions=4)),
    "q9_radix": ("q9", dict(radix_partitions=4)),
    "q18_grace": ("q18", dict(agg_cap_ceiling=1 << 9, agg_capacity=1 << 8,
                              spill_partitions=4)),
    "q3_pool": ("q3", dict(memory_pool_bytes=1 << 20, spill_partitions=2)),
}
# at SF 0.01 these chains are right-deep: neither package collapses them,
# so under join_mode=multiway they run the binary plan that
# tests/test_torch_tpch.py runs under both engines; one engine here
BINARY_AT_SF001 = ("q3_multiway", "q5_multiway", "q9_multiway",
                   "q10_multiway")


@pytest.mark.parametrize("case, engine", [
    pytest.param(case, engine, id=f"{case}-{engine}")
    for case in TPCH_CASES for engine in ENGINES
    if case not in BINARY_AT_SF001 or engine == "hash"])
def test_tpch_modes_match_reference(tpch_catalogs, reference_frames_dir, case,
                                    engine):
    ref, port = tpch_catalogs
    q, cfg = TPCH_CASES[case]
    want = reference_frame(ref, q, reference_frames_dir)
    r = LocalRunner(port, ExecConfig(breaker_engine=engine, **cfg),
                    device="cpu")
    got = r.run(TPCH[q])
    assert len(want) > 0
    assert_frames_equal(got, want, (case, engine))
    stats = r.last_stats
    if case in BINARY_AT_SF001:
        assert stats.get("multiway.joins", 0) == 0
    elif "multiway" in case:
        assert stats.get("multiway.joins", 0) >= 1
    if case in ("q18_grace", "q3_pool"):
        assert stats.get("spill.partitions", 0) > 0, case


def test_snowflake_key_through_unique_build_payload(tpch_catalogs,
                                                    reference_frames_dir):
    """nation's probe key comes from customer's payload, which the
    collapse allows because customer's build is unique."""
    ref, port = tpch_catalogs
    sql = ("select o.o_orderkey, c.c_name, n.n_name from orders o "
           "join customer c on o.o_custkey = c.c_custkey "
           "left join nation n on c.c_nationkey = n.n_nationkey")
    want = reference_frame(ref, "mw_snowflake", reference_frames_dir, sql)
    for engine in ENGINES:
        r = LocalRunner(port, ExecConfig(breaker_engine=engine,
                                         join_mode="multiway",
                                         batch_rows=1 << 13), device="cpu")
        got = r.run(sql)
        assert_same_rows(got, want, engine)
        assert r.last_stats.get("multiway.fused_dispatches", 0) >= 1
        assert "MultiwayJoin" in r.explain(sql)
