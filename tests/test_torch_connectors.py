"""The port's storage connectors and scan path against the JAX package's.

(b) Split by split, with no query: Parquet (a 40,000-row lineitem sorted
    by l_shipdate in row groups of 5,000 rows, a table with NULLs, long
    decimals and a ROW column written by pyarrow itself, part-file,
    bucketed and hive-partitioned tables), ORC, local files, SQLite and a
    remote table service on loopback. Files are written by each package
    and read by both; splits, pruned splits, split statistics, the CBO's
    column statistics, decoded batches (values, validity, long-decimal
    limbs, dictionary codes and dictionaries, at the batch's capacity)
    and selective reads with their counters must be equal, exactly.
(c) TPC-H Q1, Q3, Q6, Q12, Q14 and Q18 over a Parquet export of the SF 0.01
    generator, under auto and hash, equal the JAX package's frames that
    tests/test_torch_tpch.py shares (the same generator streams, so the
    same rows); floats to rtol=1e-12, everything else exactly.
(d) The selective scan on and off give bit-identical results (decimals
    included), and splits_pruned, rows_predecode_filtered and
    bytes_skipped equal the JAX package's on the same files.
(e) The statements of tests/test_hive_partitions.py through the port's
    LocalRunner, and the same writes through the JAX package's connector:
    equal directory listings and files, equal frames, the same errors; a
    join of two bucketed tables gives the JAX package's rows.
(f) Federation: SQLite, CSV, JSON-lines and remote tables joined with a
    memory table give the JAX package's rows.
Each JAX query run is computed once a session and shared between the
test processes (`shared`, tests/test_torch_tpch.py).
"""

import dataclasses
import datetime
import os
import sqlite3
from decimal import Decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from presto_tpu.catalog import jdbc as ref_jdbc
from presto_tpu.catalog import localfile as ref_localfile
from presto_tpu.catalog import orc as ref_orc
from presto_tpu.catalog import parquet as ref_parquet
from presto_tpu.catalog import remote as ref_remote
from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.catalog.tpch import tpch_catalog as ref_tpch_catalog
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.dictionary import Dictionary as RefDictionary
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.scan import filters as ref_filters
from presto_tpu.types import parse_type as ref_parse_type
from presto_tpu_torch import convert
from presto_tpu_torch.catalog import jdbc, localfile, orc, parquet, remote
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.dictionary import Dictionary
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.scan import filters
from presto_tpu_torch.scan import metrics as scan_metrics
from presto_tpu_torch.types import parse_type
from test_torch_tpch import (  # noqa: F401 — fixtures
    TPCH,
    assert_frames_equal,
    one_torch_thread,
    reference_frame,
    reference_frames_dir,
    shared,
)

N = 40_000
LINEITEM_TYPES = {"l_shipdate": "date", "l_discount": "decimal(12,2)",
                  "l_quantity": "bigint", "l_extendedprice": "decimal(12,2)",
                  "l_returnflag": "varchar"}
FLAGS = np.array(["A", "N", "R"])
Q6 = """
select sum(l_extendedprice * l_discount) as revenue from lineitem
where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07 and l_quantity < 24
"""
FLAG_QUERY = ("select count(*) as c from lineitem "
              "where l_returnflag = 'N' and l_quantity < 5")
Q6_BOUNDS = {"l_shipdate": (datetime.date(1994, 1, 1),
                            datetime.date(1994, 12, 31)),
             "l_discount": (5, 7), "l_quantity": (None, 23)}
SMALL = dict(batch_rows=1 << 13, agg_capacity=1 << 10)


def lineitem_data():
    """tests/test_selective_scan.py's table: sorted ship dates, so row
    groups have disjoint date ranges."""
    rng = np.random.default_rng(7)
    return {
        "l_shipdate": np.sort(rng.integers(8000, 10500, N)),
        "l_discount": rng.integers(0, 11, N),
        "l_quantity": rng.integers(1, 51, N).astype(np.int64),
        "l_extendedprice": rng.integers(90_000, 10_000_000, N),
        "l_returnflag": rng.integers(0, 3, N).astype(np.int32),
    }


def ref_types(types):
    return {c: ref_parse_type(t) for c, t in types.items()}


def port_types(types):
    return {c: parse_type(t) for c, t in types.items()}


# -- comparing the two packages ---------------------------------------------


def split_key(s):
    return (s.table, s.part, s.total, s.bucket)


def assert_batches_equal(got, want, where):
    """Two batches (port, JAX) plane for plane at their capacity."""
    g, w = convert.batch_to_arrays(got), convert.batch_to_arrays(want)
    assert g["names"] == w["names"] and g["types"] == w["types"], where
    assert g["live"].tobytes() == w["live"].tobytes(), where
    for kind in ("values", "validity", "hi"):
        for name, a, b in zip(g["names"], g[kind], w[kind]):
            assert (a is None) == (b is None), (where, kind, name)
            if a is not None:
                assert a.dtype == b.dtype, (where, kind, name)
                assert a.tobytes() == b.tobytes(), (where, kind, name)
    assert sorted(g["dicts"]) == sorted(w["dicts"]), where
    for k, v in g["dicts"].items():
        np.testing.assert_array_equal(v, w["dicts"][k], err_msg=str(where))


def assert_handles_equal(ph, rh):
    """Names, types, dictionaries and the CBO's column statistics."""
    assert ph.row_count == rh.row_count and ph.bucketing == rh.bucketing
    assert [(c.name, str(c.type)) for c in ph.columns] == [
        (c.name, str(c.type)) for c in rh.columns]
    for pc, rc in zip(ph.columns, rh.columns):
        assert (pc.dictionary is None) == (rc.dictionary is None), pc.name
        if pc.dictionary is not None:
            np.testing.assert_array_equal(pc.dictionary.values,
                                          rc.dictionary.values)
        assert (None if pc.stats is None else dataclasses.asdict(pc.stats)) \
            == (None if rc.stats is None else dataclasses.asdict(rc.stats)), \
            pc.name


def assert_scans_equal(port, ref, table, columns, desired=(1, 8),
                       bounds=(), capacity=None):
    """Handle, splits, pruned splits, split statistics and every split's
    batch of the two connectors over the same files."""
    ph, rh = port.get_table(table), ref.get_table(table)
    assert_handles_equal(ph, rh)
    for d in desired:
        ps, rs = port.splits(ph, d), ref.splits(rh, d)
        assert [split_key(s) for s in ps] == [split_key(s) for s in rs]
        for b in bounds:
            assert [split_key(s) for s in port.prune_splits(ph, ps, b)] == [
                split_key(s) for s in ref.prune_splits(rh, rs, b)], (d, b)
        for p, r in zip(ps, rs):
            pst, rst = port.split_stats(ph, p), ref.split_stats(rh, r)
            assert (pst is None) == (rst is None)
            if pst is not None:
                assert (pst.num_rows, pst.columns) == (rst.num_rows,
                                                       rst.columns)
            assert_batches_equal(
                port.read_split(p, columns, "cpu", capacity),
                ref.read_split(r, columns, capacity), (table, d, p.part))
    return ph, rh


def assert_selective_equal(port, ref, table, columns, constraints,
                           capacity=None):
    """read_split_selective of every split with both packages' filters
    compiled from the same constraints: equal batches, equal counters."""
    ph, rh = port.get_table(table), ref.get_table(table)
    pf = filters.filters_from_constraints(constraints, ph)
    rf = ref_filters.filters_from_constraints(constraints, rh)
    assert [repr(pf[c]) for c in sorted(pf)] == [repr(rf[c])
                                                 for c in sorted(rf)]
    pc, rc = {}, {}

    def counter(box):
        return lambda k, v: box.__setitem__(k, box.get(k, 0) + v)

    for p, r in zip(port.splits(ph, 8), ref.splits(rh, 8)):
        assert_batches_equal(
            port.read_split_selective(p, columns, pf, "cpu", capacity,
                                      counters=counter(pc)),
            ref.read_split_selective(r, columns, rf, capacity,
                                     counters=counter(rc)),
            (table, "selective", p.part))
    assert pc == rc and pc.get("rows_predecode_filtered", 0) > 0
    return pc


# -- Parquet, split by split -------------------------------------------------


@pytest.fixture(scope="module")
def lineitem_dirs(tmp_path_factory):
    """The 40,000-row lineitem, once written by each package."""
    data = lineitem_data()
    out = {}
    for writer in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(f"li_{writer}"))
        path = os.path.join(d, "lineitem.parquet")
        if writer == "jax":
            ref_parquet.write_table(path, data, ref_types(LINEITEM_TYPES),
                                    {"l_returnflag": RefDictionary(FLAGS)},
                                    row_group_rows=5_000)
        else:
            parquet.write_table(path, data, port_types(LINEITEM_TYPES),
                                {"l_returnflag": Dictionary(FLAGS)},
                                row_group_rows=5_000)
        out[writer] = d
    return out


def test_parquet_writers_write_the_same_file(lineitem_dirs):
    a, b = (pq.ParquetFile(os.path.join(lineitem_dirs[w], "lineitem.parquet"))
            for w in ("jax", "port"))
    assert a.schema_arrow.equals(b.schema_arrow, check_metadata=True)
    assert a.metadata.num_row_groups == b.metadata.num_row_groups == 8
    assert a.read().equals(b.read())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_lineitem_split_by_split(lineitem_dirs, writer):
    d = lineitem_dirs[writer]
    port, ref = parquet.ParquetConnector(d), ref_parquet.ParquetConnector(d)
    cols = list(LINEITEM_TYPES)
    assert_scans_equal(port, ref, "lineitem", cols, desired=(1, 8, 20),
                       bounds=(Q6_BOUNDS, {"l_returnflag": ("N", "N")},
                               {"l_quantity": (60, None)}))
    assert_selective_equal(port, ref, "lineitem", cols,
                           {"l_shipdate": (8766, 9130), "l_discount": (5, 7),
                            "l_quantity": (None, 23)})
    # a string constraint (dictionary codes) on a column not read
    assert_selective_equal(port, ref, "lineitem", ["l_quantity"],
                           {"l_returnflag": ("N", "N"),
                            "l_quantity": (None, 4)}, capacity=8192)


def foreign_parquet(path):
    """A file neither package wrote: narrow ints, float32, plain and large
    strings, decimal128 values past 18 digits, NULLs everywhere, a ROW
    column, in three row groups."""
    rng = np.random.default_rng(31)
    n = 900
    nulls = rng.random(n) < 0.15
    big = [None if nulls[i] else Decimal(int(rng.integers(-10**6, 10**6)))
           * Decimal(10) ** 15 + Decimal(i) / 100 for i in range(n)]
    t = pa.table({
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "i32": pa.array(rng.integers(-9, 9, n).astype(np.int32), mask=nulls),
        "f32": pa.array(rng.normal(0, 1, n).astype(np.float32)),
        "x": pa.array(np.where(rng.random(n) < .1, np.nan,
                               rng.normal(0, 1, n)), mask=nulls),
        "s": pa.array([None if m else f"v{v}" for m, v in
                       zip(nulls, rng.integers(0, 40, n))], pa.string()),
        "ls": pa.array([f"w{v}" for v in rng.integers(0, 5, n)],
                       pa.large_string()),
        "d": pa.array(rng.integers(8000, 9000, n).astype(np.int32),
                      mask=nulls).cast(pa.date32()),
        "p": pa.array(big, pa.decimal128(38, 2)),
        "q": pa.array([None if m else Decimal(int(v)) / 100 for m, v in
                       zip(nulls, rng.integers(-10**6, 10**6, n))],
                      pa.decimal128(12, 2)),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls),
        "r": pa.StructArray.from_arrays(
            [pa.array(rng.integers(0, 9, n)),
             pa.array([f"t{v}" for v in rng.integers(0, 3, n)])],
            ["a", "tag"]),
    })
    pq.write_table(t, path, row_group_size=300)


def test_parquet_foreign_file_split_by_split(tmp_path):
    foreign_parquet(str(tmp_path / "f.parquet"))
    port = parquet.ParquetConnector(str(tmp_path))
    ref = ref_parquet.ParquetConnector(str(tmp_path))
    cols = [c.name for c in ref.get_table("f").columns]
    assert "r.tag" in cols and "r.a" in cols
    assert_scans_equal(port, ref, "f", cols, desired=(1, 5),
                       bounds=({"i32": (0, 3)}, {"s": ("v1", "v3")},
                               {"d": (datetime.date(2000, 1, 1), None)}))
    assert_selective_equal(port, ref, "f", cols,
                           {"i32": (0, 5), "x": (-1.0, None),
                            "s": ("v1", "v5")})


def memory_pair(frames):
    """The same frames in a memory connector of each package, and one batch
    of each table from each (a whole-table split, read with no query)."""
    pm, rm = MemoryConnector(), RefMemory()
    for name, df in frames.items():
        pm.add_table(name, df)
        rm.add_table(name, df)

    def batches(name):
        ph, rh = pm.get_table(name), rm.get_table(name)
        cols = [c.name for c in rh.columns]
        return ([pm.read_split(pm.splits(ph, 1)[0], cols, "cpu")],
                [rm.read_split(rm.splits(rh, 1)[0], cols)])
    return batches


def leaf_rows(root):
    """{directory relative to root: sorted rows of its parquet files},
    whatever the files' names."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        rows = []
        for f in sorted(x for x in files if x.endswith(".parquet")):
            t = pq.read_table(os.path.join(dirpath, f))
            rows += list(zip(*[t.column(c).to_pylist()
                               for c in t.column_names]))
        if rows:
            out[os.path.relpath(dirpath, root)] = sorted(rows, key=repr)
    return out


def listing(root):
    return sorted((os.path.relpath(dp, root), sorted(
        "part-*" if f.startswith("part-") else f for f in fs))
        for dp, _ds, fs in os.walk(root))


def test_parquet_write_api_in_both_packages(tmp_path):
    """CTAS (one file), INSERT (rewrite), CREATE TABLE, TRUNCATE, DELETE's
    rewrite and DROP through each package's connector on the same rows:
    the same files, read equal by both; a long decimal keeps its limb."""
    rng = np.random.default_rng(2)
    df = pd.DataFrame({
        "k": rng.integers(0, 100, 500),
        "v": np.where(rng.random(500) < .2, None,
                      rng.normal(0, 1, 500)).astype(object),
        "s": rng.choice(["x", "y", "z"], 500),
        "d": pd.to_datetime("1995-01-01") + pd.to_timedelta(
            rng.integers(0, 900, 500), unit="D"),
    })
    batches = memory_pair({"t": df})
    dirs = {w: tmp_path / w for w in ("jax", "port")}
    conns = {"jax": ref_parquet.ParquetConnector(str(dirs["jax"])),
             "port": parquet.ParquetConnector(str(dirs["port"]))}
    for w in dirs:
        os.makedirs(dirs[w])
    pb, rb = batches("t")
    for w, b in (("jax", rb), ("port", pb)):
        c = conns[w]
        assert c.create_table_from("t", b) == 500
        assert c.insert_into("t", b) == 500
        cols = [(x.name, x.type) for x in c.get_table("t").columns]
        c.create_empty("e", cols)
        assert c.create_table_from("t", b, if_not_exists=True) == 0
        with pytest.raises(ValueError, match="already exists"):
            c.create_table_from("t", b)
        c.create_table_from("r", b)
        c.replace_table_from("r", b)
        c.create_table_from("z", b)
        c.truncate_table("z")
        c.create_table_from("gone", b)
        c.drop_table("gone")
        c.drop_table("gone", if_exists=True)
        with pytest.raises(KeyError):
            c.drop_table("gone")
    assert sorted(os.listdir(dirs["jax"])) == sorted(os.listdir(dirs["port"]))
    assert leaf_rows(dirs["jax"]) == leaf_rows(dirs["port"])
    for w, d in dirs.items():
        port = parquet.ParquetConnector(str(d))
        ref = ref_parquet.ParquetConnector(str(d))
        for t in ("t", "e", "r", "z"):
            cols = [c.name for c in ref.get_table(t).columns]
            assert_scans_equal(port, ref, t, cols)
        assert port.table_names() == ref.table_names() == ["e", "r", "t", "z"]


def test_null_strings_of_the_writer_fail_alike(tmp_path):
    """A fault of the JAX package that the port keeps: the writer stores a
    VARCHAR column with NULLs as a dictionary array with NULL indices,
    and the reader's code remap indexes with their float NaNs, so neither
    package reads the column back (the same IndexError)."""
    batches = memory_pair({"t": pd.DataFrame({"s": ["x", None, "y"]})})
    pb, rb = batches("t")
    parquet.ParquetConnector(str(tmp_path)).create_table_from("p", pb)
    ref_parquet.ParquetConnector(str(tmp_path)).create_table_from("r", rb)
    for t in ("p", "r"):
        port = parquet.ParquetConnector(str(tmp_path))
        ref = ref_parquet.ParquetConnector(str(tmp_path))
        ph, rh = port.get_table(t), ref.get_table(t)
        with pytest.raises(IndexError, match="must be of integer"):
            port.read_split(port.splits(ph, 1)[0], ["s"], "cpu")
        with pytest.raises(IndexError, match="must be of integer"):
            ref.read_split(ref.splits(rh, 1)[0], ["s"])


def test_parquet_parts_and_buckets_in_both_packages(tmp_path):
    """A part-file table made by the JAX package's scaled writers, appended
    to by the port's INSERT; bucketed tables written by each package
    (bucket ids from each package's np_bucket_ids): the same files, and
    the same splits (with their buckets) and batches in both."""
    rng = np.random.default_rng(9)
    df = pd.DataFrame({"k": rng.integers(0, 50, 3000),
                       "s": rng.choice(["a", "b", "c", "d"], 3000),
                       "v": rng.normal(0, 1, 3000)})
    batches = memory_pair({"t": df})
    pb, rb = batches("t")
    d = str(tmp_path)
    ref = ref_parquet.ParquetConnector(d)
    assert ref.begin_scaled_create("p")
    ref.write_part("p", "0", rb)
    ref.write_part("p", "1", rb)
    ref.finish_scaled_create("p")
    port = parquet.ParquetConnector(d)
    cols = ["k", "s", "v"]
    assert_scans_equal(port, ref, "p", cols, desired=(1, 4),
                       bounds=({"k": (10, 20)},))
    assert port.insert_into("p", pb) == 3000
    ref = ref_parquet.ParquetConnector(d)
    ph, _ = assert_scans_equal(port, ref, "p", cols, desired=(1,))
    assert ph.row_count == 9000
    data = {"k": df.k.to_numpy(), "s": pb[0].columns[1].values.numpy()[:3000],
            "v": df.v.to_numpy()}
    types = {"k": "bigint", "s": "varchar", "v": "double"}
    dicts = pb[0].dicts
    for name, mod, tmap, dd in (
            ("bj", ref_parquet, ref_types(types),
             {"s": RefDictionary(dicts["s"].values)}),
            ("bp", parquet, port_types(types), dicts)):
        mod.write_bucketed_table(d, name, data, tmap, ["k", "s"], 4, dd)
    assert leaf_rows(os.path.join(d, "bj.buckets")) == leaf_rows(
        os.path.join(d, "bp.buckets"))
    for name in ("bj", "bp"):
        ph, _ = assert_scans_equal(port, ref, name, cols, desired=(1, 8),
                                   bounds=({"k": (0, 5)},))
        assert ph.bucketing == (("k", "s"), 4)
        assert {s.bucket for s in port.splits(ph, 8)} == {0, 1, 2, 3}


# -- ORC ---------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_orc_split_by_split(tmp_path, writer):
    """Stripes as splits, sidecar statistics, pruning, batches and the
    selective read, over a file (and its sidecar) from either package;
    CTAS and DROP (which removes the sidecar) in both."""
    data = lineitem_data()
    d = str(tmp_path)
    if writer == "jax":
        ref_orc.export_table_to_orc(d, "lineitem", data,
                                    ref_types(LINEITEM_TYPES),
                                    {"l_returnflag": RefDictionary(FLAGS)},
                                    stripe_size=64 << 10)
    else:
        orc.export_table_to_orc(d, "lineitem", data,
                                port_types(LINEITEM_TYPES),
                                {"l_returnflag": Dictionary(FLAGS)},
                                stripe_size=64 << 10)
    port, ref = orc.OrcConnector(d), ref_orc.OrcConnector(d)
    cols = list(LINEITEM_TYPES)
    ph, _ = assert_scans_equal(port, ref, "lineitem", cols, desired=(1, 16),
                               bounds=(Q6_BOUNDS,))
    assert port.splits(ph, 1)[0].total > 1
    pruned = port.prune_splits(ph, port.splits(ph, 1), Q6_BOUNDS)
    assert 0 < len(pruned) < port.splits(ph, 1)[0].total
    assert_selective_equal(port, ref, "lineitem", cols,
                           {"l_shipdate": (8766, 9130), "l_discount": (5, 7),
                            "l_quantity": (None, 23)})
    # a fault the port keeps: a split past the scan's capacity does not
    # fit its batch in either package (ROADMAP §3)
    p, r = port.splits(ph, 1)[0], ref.splits(ref.get_table("lineitem"), 1)[0]
    with pytest.raises(ValueError, match="could not broadcast"):
        port.read_split(p, cols, "cpu", 128)
    with pytest.raises(ValueError, match="could not broadcast"):
        ref.read_split(r, cols, 128)
    batches = memory_pair({"m": pd.DataFrame({
        "a": [1, 2, None, 4], "s": ["x", None, "y", "x"]}).astype(
            {"a": "Int64"})})
    pb, rb = batches("m")
    conn = port if writer == "port" else ref
    assert conn.create_table_from("c", pb if writer == "port" else rb) == 4
    assert_scans_equal(orc.OrcConnector(d), ref_orc.OrcConnector(d), "c",
                       ["a", "s"])
    with pytest.raises(ValueError, match="does not support table properties"):
        conn.create_table_from("c2", pb if writer == "port" else rb,
                               properties={"x": 1})
    conn.drop_table("c")
    assert sorted(os.listdir(d)) == ["lineitem.orc", "lineitem.orc.stats.json"]


# -- local files, SQLite, the remote service --------------------------------


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    """tests/test_federation.py's tables: orders in SQLite (with NULL
    statuses), customers in CSV, events in JSON lines."""
    d = tmp_path_factory.mktemp("fed")
    rng = np.random.default_rng(17)
    n = 3000
    orders = pd.DataFrame({
        "oid": np.arange(n),
        "cust": rng.integers(0, 40, n),
        "amount": rng.random(n).round(4) * 100,
        "status": rng.choice(["open", "shipped", "returned", None], n,
                             p=[0.3, 0.5, 0.15, 0.05]),
    })
    db = sqlite3.connect(str(d / "shop.db"))
    orders.to_sql("orders", db, index=False)
    db.close()
    custs = pd.DataFrame({
        "cust": np.arange(40),
        "name": [f"cust-{i:02d}" for i in range(40)],
        "tier": [["gold", "silver", "bronze"][i % 3] for i in range(40)],
    })
    custs.to_csv(d / "customers.csv", index=False)
    events = pd.DataFrame({"cust": np.arange(0, 40, 2),
                           "score": np.linspace(0, 1, 20).round(3)})
    events.to_json(d / "events.jsonl", orient="records", lines=True)
    return str(d), orders, custs, events


def test_localfile_split_by_split(fed):
    d, *_ = fed
    port = localfile.LocalFileConnector(d, "files")
    ref = ref_localfile.LocalFileConnector(d, "files")
    assert port.table_names() == ref.table_names() == ["customers", "events"]
    assert_scans_equal(port, ref, "customers", ["cust", "name", "tier"],
                       desired=(1, 3), bounds=({"cust": (30, None)},
                                               {"tier": ("gold", "gold")}))
    assert_scans_equal(port, ref, "events", ["score", "cust"],
                       desired=(2,), bounds=({"score": (None, 0.2)},))


def test_localfile_rereads_a_rewritten_file(tmp_path):
    (tmp_path / "t.csv").write_text("a,b\n1,x\n2,y\n")
    port = localfile.LocalFileConnector(str(tmp_path))
    ref = ref_localfile.LocalFileConnector(str(tmp_path))
    assert_scans_equal(port, ref, "t", ["a", "b"])
    (tmp_path / "t.csv").write_text("a,b\n1,x\n2,y\n3,z\n")
    ph, _ = assert_scans_equal(port, ref, "t", ["a", "b"])
    assert ph.row_count == 3


def test_jdbc_split_by_split(fed):
    d, orders, *_ = fed
    path = os.path.join(d, "shop.db")
    port = jdbc.sqlite_connector(path, "shop")
    ref = ref_jdbc.sqlite_connector(path, "shop")
    cols = ["oid", "cust", "amount", "status"]
    ph, rh = assert_scans_equal(port, ref, "orders", cols)
    bounds = {"amount": (10.0, 20.0), "cust": (3, None)}
    assert port.read_table_sql("orders", cols, bounds) == ref.read_table_sql(
        "orders", cols, bounds)
    bounds["status"] = ("a", "b")  # not numeric: stays with the engine
    p, r = port.splits(ph, 1)[0], ref.splits(rh, 1)[0]
    assert_batches_equal(
        port.read_split_constrained(p, cols, "cpu", constraints=bounds),
        ref.read_split_constrained(r, cols, constraints=bounds), "where")
    # the index lookup an IndexJoin makes, one key and two keys
    port._index_keys = ref._index_keys = {"orders": [["oid"],
                                                     ["cust", "status"]]}
    assert port.get_index(ph, ["amount"]) is None
    keys = {"oid": np.array([5, 7, 5, 2999, 4000])}
    assert_batches_equal(
        port.get_index(ph, ["oid"]).lookup(keys, cols, device="cpu"),
        ref.get_index(rh, ["oid"]).lookup(keys, cols), "index")
    keys = {"cust": np.array([1, 2, 3]),
            "status": np.array(["open", "shipped", "open"], dtype=object)}
    assert_batches_equal(
        port.get_index(ph, ["status", "cust"]).lookup(keys, cols,
                                                      device="cpu"),
        ref.get_index(rh, ["status", "cust"]).lookup(keys, cols), "index2")


@pytest.fixture(scope="module")
def services(fed):
    """The orders table behind each package's in-process service."""
    _, orders, *_ = fed
    svcs = {"jax": ref_remote.RemoteTableService({"orders": orders},
                                                 n_splits=3),
            "port": remote.RemoteTableService({"orders": orders},
                                              n_splits=3)}
    yield svcs
    for s in svcs.values():
        s.close()


@pytest.mark.parametrize("service", ["jax", "port"])
def test_remote_split_by_split(services, service):
    """Each package's client against one service, paging by continuation
    tokens: splits, batches and the pushed-down ranges."""
    svc = services[service]
    port = remote.RemoteServiceConnector(svc.url, "rs", page_rows=512)
    ref = ref_remote.RemoteServiceConnector(svc.url, "rs", page_rows=512)
    assert port.table_names() == ref.table_names() == ["orders"]
    cols = ["oid", "status", "amount"]
    ph, rh = assert_scans_equal(port, ref, "orders", cols, desired=(1, 4))
    bounds = {"amount": (None, 25.5), "cust": (4, 9), "status": ("a", "z")}
    for p, r in zip(port.splits(ph, 3), ref.splits(rh, 3)):
        n = len(svc.requests)
        assert_batches_equal(
            port.read_split_constrained(p, cols, "cpu", constraints=bounds),
            ref.read_split_constrained(r, cols, constraints=bounds), "rows")
        sent = svc.requests[n:]
        half = len(sent) // 2
        assert sent[:half] == sent[half:]
        assert sent[0]["constraints"] == {"amount": [None, 25.5],
                                          "cust": [4, 9]}


# -- queries -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_parquet(tmp_path_factory):
    """The SF 0.01 generator's tables as Parquet files (export_tpch: the
    memory catalog's generator streams, so the same rows)."""
    d = str(tmp_path_factory.mktemp("tpch_pq"))
    parquet.export_tpch(d, 0.01)
    cat = Catalog()
    cat.register("tpch", parquet.ParquetConnector(d), default=True)
    return d, cat


def test_tpch_exports_read_equal_in_both(tpch_parquet, tmp_path):
    """export_tpch writes the JAX package's files; export_tpch_chunked
    (orders and lineitem from per-chunk generator streams, as in the JAX
    package) writes the JAX package's chunked files."""
    d, _ = tpch_parquet
    ref_parquet.export_tpch(str(tmp_path / "whole"), 0.01)
    ref_parquet.export_tpch_chunked(str(tmp_path / "jax"), 0.01,
                                    orders_per_chunk=6000)
    parquet.export_tpch_chunked(str(tmp_path / "port"), 0.01,
                                orders_per_chunk=6000)
    for a, b in ((d, tmp_path / "whole"), (tmp_path / "port",
                                           tmp_path / "jax")):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and len(names) == 8
        for f in names:
            ta, tb = pq.read_table(os.path.join(a, f)), pq.read_table(
                os.path.join(b, f))
            assert ta.schema.equals(tb.schema, check_metadata=True), f
            assert ta.equals(tb), f
    port = parquet.ParquetConnector(str(tmp_path / "port"))
    ref = ref_parquet.ParquetConnector(str(tmp_path / "port"))
    assert_scans_equal(port, ref, "orders",
                       [c.name for c in ref.get_table("orders").columns])


QUERIES = ["q1", "q3", "q6", "q12", "q14", "q18"]


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_over_parquet_matches_reference(tpch_parquet,
                                             reference_frames_dir, q):
    """The port over the Parquet export, under auto and hash, against the
    JAX package's frame of the memory catalog (tests/test_torch_tpch.py's,
    computed once a session; the JAX catalog generates its tables only if
    this process computes the frame)."""
    _, cat = tpch_parquet
    want = reference_frame(ref_tpch_catalog(0.01), q, reference_frames_dir)
    assert len(want) > 0
    for engine in ("auto", "hash"):
        got = LocalRunner(cat, ExecConfig(breaker_engine=engine),
                          device="cpu").run(TPCH[q])
        assert_frames_equal(got, want, (q, engine, "parquet"))


@pytest.fixture(scope="module")
def orc_lineitem(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("orc_li"))
    orc.export_table_to_orc(d, "lineitem", lineitem_data(),
                            port_types(LINEITEM_TYPES),
                            {"l_returnflag": Dictionary(FLAGS)},
                            stripe_size=64 << 10)
    return d


@pytest.mark.parametrize("fmt, query", [
    ("parquet", "q6"), ("parquet", "flag"), ("orc", "q6")],
    ids=["parquet-q6", "parquet-flag", "orc-q6"])
def test_selective_scan_matches_reference(lineitem_dirs, orc_lineitem,
                                          reference_frames_dir, fmt, query):
    """Selective scan on and off: the same frame (Decimal exact) as the
    JAX package's run with it on, and the JAX package's counters, in
    ctx.stats and in scan/metrics; off, only the pruning counter."""
    sql = Q6 if query == "q6" else FLAG_QUERY
    d, conn_cls, ref_cls = (
        (lineitem_dirs["port"], parquet.ParquetConnector,
         ref_parquet.ParquetConnector) if fmt == "parquet" else
        (orc_lineitem, orc.OrcConnector, ref_orc.OrcConnector))

    def compute():
        cat = RefCatalog()
        cat.register("pq", ref_cls(d), default=True)
        r = RefRunner(cat, RefConfig(**SMALL))
        return r.run(sql), scan_stats(r.last_stats)

    want, want_counters = shared(reference_frames_dir,
                                 f"scan_{fmt}_{query}", compute)
    cat = Catalog()
    cat.register("pq", conn_cls(d), default=True)
    frames = {}
    for on in (True, False):
        scan_metrics.reset()
        r = LocalRunner(cat, ExecConfig(selective_scan=on, **SMALL),
                        device="cpu")
        frames[on] = r.run(sql)
        got = scan_stats(r.last_stats)
        if on:
            assert got == want_counters
            assert scan_metrics.snapshot() == want_counters
            assert got["rows_predecode_filtered"] > 0
        else:
            assert got == {"splits_pruned": want_counters["splits_pruned"]}
    assert want_counters["splits_pruned"] > 0 or query == "flag"
    for c in want.columns:
        assert list(frames[True][c]) == list(frames[False][c]) == list(
            want[c]), c


def scan_stats(stats):
    return {k.rsplit(".", 1)[1]: v for k, v in stats.items()
            if k.startswith("scan.")}


def test_prefetch_depths_give_the_same_batches(lineitem_dirs):
    """scan_prefetch 0, 1 and 2 (the default): the same frame; an early
    exit (LIMIT) stops the producer thread."""
    import threading

    cat = Catalog()
    cat.register("pq", parquet.ParquetConnector(lineitem_dirs["port"]),
                 default=True)
    sql = ("select l_returnflag, count(*) c, sum(l_quantity) q from lineitem "
           "group by l_returnflag order by l_returnflag")
    frames = [LocalRunner(cat, ExecConfig(scan_prefetch=p, **SMALL),
                          device="cpu").run(sql) for p in (0, 1, 2)]
    for f in frames[1:]:
        assert f.equals(frames[0])
    got = LocalRunner(cat, ExecConfig(**SMALL), device="cpu").run(
        "select l_quantity from lineitem limit 3")
    assert len(got) == 3
    producers = [t for t in threading.enumerate()
                 if t.name == "scan-prefetch"]
    for t in producers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in producers)


def test_prefetch_hands_a_read_error_to_the_query(lineitem_dirs):
    conn = parquet.ParquetConnector(lineitem_dirs["port"])
    cat = Catalog()
    cat.register("pq", conn, default=True)
    inner = conn._read_split_uncached
    calls = []

    def failing(split, *args):
        calls.append(split.part)
        if len(calls) == 3:
            raise OSError("disk went away")
        return inner(split, *args)

    conn._read_split_uncached = failing
    with pytest.raises(OSError, match="disk went away"):
        LocalRunner(cat, ExecConfig(**SMALL), device="cpu").run(
            "select sum(l_quantity) q from lineitem")


# -- hive partitions -----------------------------------------------------------


def hive_sources():
    rng = np.random.default_rng(5)
    n = 2000
    return {
        "src": pd.DataFrame({
            "v": rng.normal(0, 1, n), "k": rng.integers(0, 1000, n),
            "region": np.asarray(["asia", "emea", "amer"])[
                rng.integers(0, 3, n)],
            "yr": rng.integers(2020, 2024, n)}),
        "chars": pd.DataFrame({"v": [1.0, 2.0, 3.0, 4.0, 5.0],
                               "cat": ["a/b", "x=y", None, "plain", "a/b"]}),
        "dsrc": pd.DataFrame({"v": [1, 2, 3, 4, 5], "dt": pd.to_datetime(
            ["2024-01-01", "2024-02-01", "2024-01-01", "2024-03-01",
             "2024-02-01"])}),
        "b": pd.DataFrame({"v": [1, 2, 3, 4],
                           "flag": [True, False, True, True]}),
        "neg": pd.DataFrame({"v": [1.0, 2.0, 3.0], "k": [-1, None, -1]}
                            ).astype({"k": "Int64"}),
    }


# (table, source, partitioned_by): the CTAS of tests/test_hive_partitions.py
HIVE_CTAS = [("sales", "src", ["region", "yr"]), ("t1", "chars", ["cat"]),
             ("t2", "dsrc", "dt"), ("tb", "b", ["flag"]),
             ("tn", "neg", ["k"])]


def test_hive_partitions_match_reference(tmp_path):
    """The partitioned CTAS, INSERT and errors of
    tests/test_hive_partitions.py: the port through LocalRunner, the JAX
    package through its connector on the same rows. Equal listings and
    rows; each table read equal by both connectors split by split, with
    equal partition pruning; the port's frames equal the reference test's
    expectations; the same errors in both."""
    srcs = hive_sources()
    batches = memory_pair(srcs)
    mem = MemoryConnector()
    for name, df in srcs.items():
        mem.add_table(name, df)
    dirs = {w: tmp_path / w for w in ("jax", "port")}
    for d in dirs.values():
        os.makedirs(d)
    port_conn = parquet.ParquetConnector(str(dirs["port"]), "pq")
    ref_conn = ref_parquet.ParquetConnector(str(dirs["jax"]), "pq")
    cat = Catalog()
    cat.register("m", mem, default=True)
    cat.register("pq", port_conn)
    r = LocalRunner(cat, ExecConfig(batch_rows=512), device="cpu")

    def pby(p):
        return (f"'{p}'" if isinstance(p, str)
                else "array[" + ", ".join(f"'{c}'" for c in p) + "]")

    for t, src, p in HIVE_CTAS:
        got = r.run(f"create table pq.{t} with (partitioned_by = {pby(p)})"
                    f" as select * from {src}")
        want = ref_conn.create_table_from(
            t, batches(src)[1], properties={"partitioned_by": p})
        assert got.rows[0] == want == len(srcs[src])
    r.run("insert into pq.sales select * from src where yr = 2021")
    ref_conn.insert_into("sales", [_ref_filtered(batches("src")[1][0],
                                                 srcs["src"].yr == 2021)])
    empty = srcs["b"].v > 100
    r.run("create table pq.tz with (partitioned_by = array['flag'])"
          " as select * from b where v > 100")
    ref_conn.create_table_from("tz", [_ref_filtered(batches("b")[1][0],
                                                    empty)],
                               properties={"partitioned_by": ["flag"]})
    r.run("insert into pq.tz select * from b")
    ref_conn.insert_into("tz", batches("b")[1])
    for t in ("sales", "t1", "t2", "tb", "tn", "tz"):
        a, b = (os.path.join(dirs[w], f"{t}.hive") for w in ("jax", "port"))
        assert listing(a) == listing(b), t
        assert leaf_rows(a) == leaf_rows(b), t
        with open(os.path.join(a, "_meta.json")) as fa, \
                open(os.path.join(b, "_meta.json")) as fb:
            assert fa.read() == fb.read()
    assert sorted(p for p in os.listdir(dirs["port"] / "t1.hive")
                  if p != "_meta.json") == [
        "cat=__HIVE_DEFAULT_PARTITION__", "cat=a%2Fb", "cat=plain",
        "cat=x%3Dy"]
    # both connectors over each writer's tables, split by split
    bounds = ({"region": ("emea", "emea"), "yr": (2022, 2023)},
              {"v": (0.5, None)}, {"cat": ("a/b", "a/b")},
              {"dt": (datetime.date(2024, 2, 1), datetime.date(2024, 2, 1))},
              {"flag": (True, True)}, {"k": (-1, -1)})
    for d in dirs.values():
        pc = parquet.ParquetConnector(str(d), "pq")
        rc = ref_parquet.ParquetConnector(str(d), "pq")
        for t in ("sales", "t1", "t2", "tb", "tn", "tz"):
            cols = [c.name for c in rc.get_table(t).columns]
            assert_scans_equal(pc, rc, t, cols, desired=(1, 6),
                               bounds=bounds)
    h = port_conn.get_table("sales")
    assert [c.name for c in h.columns] == ["v", "k", "region", "yr"]
    assert len(port_conn.prune_splits(h, port_conn.splits(h, 8), bounds[0])
               ) < len(port_conn.splits(h, 8))
    # the port's frames: the reference test's expectations
    src = srcs["src"]
    ins = src[src.yr == 2021]
    assert r.run("select count(*) c from pq.sales").c[0] == 2000 + len(ins)
    got = r.run("select count(*) c from pq.sales"
                " where region = 'emea' and yr >= 2022")
    both = pd.concat([src, ins])
    assert got.c[0] == ((both.region == "emea") & (both.yr >= 2022)).sum()
    assert r.last_stats["scan.sales.splits_pruned"] > 0
    g = r.run("select region, yr, count(*) c, sum(k) s from pq.sales"
              " group by region, yr").sort_values(["region", "yr"],
                                                  ignore_index=True)
    e = both.groupby(["region", "yr"], as_index=False).agg(
        c=("k", "size"), s=("k", "sum"))
    assert g.c.tolist() == e.c.tolist() and g.s.tolist() == e.s.tolist()
    assert r.run("select sum(v) s from pq.t1 where cat = 'a/b'").s[0] == 6.0
    assert r.run("select sum(v) s from pq.t1 where cat is null").s[0] == 3.0
    assert r.run("select sum(v) s from pq.t2 where dt = date '2024-02-01'"
                 ).s[0] == 7
    got = r.run("select flag, sum(v) s from pq.tb group by flag"
                ).sort_values("s", ignore_index=True)
    assert got.flag.tolist() == [False, True] and got.s.tolist() == [2, 8]
    assert r.run("select sum(v) s from pq.tn where k is null").s[0] == 2.0
    assert r.run("select sum(v) s from pq.tn where k = -1").s[0] == 4.0
    assert r.run("select sum(v) s from pq.tz where flag = true").s[0] == 8
    assert [c.name for c in port_conn.get_table("tz").columns] == [
        "v", "flag"]
    # the same errors in both packages
    sb_p, sb_r = batches("src")
    for props, cols, frag in (
            ({"partitioned_by": ["v"]}, None, "must be integer"),
            ({"bogus": 1}, None, "unknown table properties"),
            ({"partitioned_by": ["nope"]}, None, "not in table schema"),
            ({"partitioned_by": ["region"]}, ["region", "v"], "trailing")):
        sql_cols = "*" if cols is None else ", ".join(cols)
        with pytest.raises(ValueError, match=frag):
            r.run(f"create table pq.bad with ({_props_sql(props)})"
                  f" as select {sql_cols} from src")
        rb = sb_r if cols is None else [sb_r[0].select(cols)]
        with pytest.raises(ValueError, match=frag):
            ref_conn.create_table_from("bad", rb, properties=props)
    with pytest.raises(ValueError, match="does not support table properties"):
        r.run("create table bad2 with (partitioned_by = array['region'])"
              " as select * from src")
    with pytest.raises(ValueError, match="does not support table properties"):
        RefMemory().create_table_from("bad2", sb_r,
                                      properties={"partitioned_by": ["k"]})
    for conn in (port_conn, ref_conn):
        with pytest.raises(NotImplementedError):
            conn.truncate_table("sales")
        with pytest.raises(NotImplementedError):
            conn.replace_table_from("sales", [])
    with pytest.raises(NotImplementedError):
        r.run("truncate table pq.sales")
    with pytest.raises(NotImplementedError):
        r.run("delete from pq.sales where k = 1")
    with pytest.raises(ValueError, match="schema mismatch"):
        r.run("insert into pq.sales select k, v, region, yr from src")
    with pytest.raises(ValueError, match="schema mismatch"):
        ref_conn.insert_into("sales", [sb_r[0].select(
            ["k", "v", "region", "yr"])])
    fresh = parquet.ParquetConnector(str(dirs["port"]), "pq")
    assert [c.name for c in fresh.get_table("sales").columns] == [
        "v", "k", "region", "yr"]


def _props_sql(props):
    out = []
    for k, v in props.items():
        out.append(f"{k} = " + (
            "array[" + ", ".join(f"'{c}'" for c in v) + "]"
            if isinstance(v, list) else str(v)))
    return ", ".join(out)


def _ref_filtered(b, mask):
    """A JAX batch with the rows of `mask` (a host boolean Series) live."""
    import jax.numpy as jnp

    live = np.zeros(b.capacity, bool)
    live[:len(mask)] = np.asarray(mask)
    return dataclasses.replace(b, live=jnp.asarray(live)) \
        if dataclasses.is_dataclass(b) else type(b)(
            b.names, b.types, b.columns, jnp.asarray(live), b.dicts)


def test_bucketed_join_matches_reference(tmp_path, reference_frames_dir):
    """A join of two tables bucketed on their join key: the JAX package's
    rows (both run it as an ordinary join here; grouped execution over
    buckets comes with the fragmenter)."""
    rng = np.random.default_rng(13)
    d = str(tmp_path)
    a = {"k": rng.integers(0, 300, 2000), "x": rng.integers(0, 9, 2000)}
    b = {"k": np.arange(300), "y": rng.integers(0, 100, 300)}
    for name, data in (("a", a), ("b", b)):
        parquet.write_bucketed_table(
            d, name, data, port_types({c: "bigint" for c in data}), ["k"], 4)
    sql = ("select a.x, count(*) n, sum(b.y) s from a join b on a.k = b.k "
           "group by a.x order by a.x")

    def compute():
        cat = RefCatalog()
        cat.register("pq", ref_parquet.ParquetConnector(d), default=True)
        return RefRunner(cat, RefConfig(**SMALL)).run(sql)

    want = shared(reference_frames_dir, "scan_bucketed_join", compute)
    cat = Catalog()
    cat.register("pq", parquet.ParquetConnector(d), default=True)
    for engine in ("auto", "hash"):
        got = LocalRunner(cat, ExecConfig(breaker_engine=engine, **SMALL),
                          device="cpu").run(sql)
        assert_frames_equal(got, want, ("bucketed", engine))


def test_federation_matches_reference(fed, services, reference_frames_dir):
    """SQLite orders x CSV customers x JSON-lines events, the remote
    service's orders, and a memory table, in one catalog: the JAX
    package's rows for the three-system join, pandas' for the rest (as
    tests/test_federation.py and tests/test_remote_connector.py hold
    them), and an index join into SQLite."""
    d, orders, custs, events = fed
    path = os.path.join(d, "shop.db")

    def catalog(pkg):
        db, lf, rs, mem = ((ref_jdbc, ref_localfile, ref_remote, RefMemory)
                           if pkg == "jax" else
                           (jdbc, localfile, remote, MemoryConnector))
        cat = RefCatalog() if pkg == "jax" else Catalog()
        cat.register("shop", db.sqlite_connector(path, name="shop"),
                     default=True)
        cat.register("files", lf.LocalFileConnector(d, name="files"))
        cat.register("rs", rs.RemoteServiceConnector(
            services[pkg].url, "rs", page_rows=1024))
        m = mem()
        m.add_table("nation", pd.DataFrame({
            "cust": np.arange(40), "nation": [f"N{i % 25:02d}"
                                              for i in range(40)]}))
        cat.register("m", m)
        return cat

    join = ("select c.tier, count(*) as n, sum(o.amount) as s "
            "from orders o join files.customers c on o.cust = c.cust "
            "join files.events e on c.cust = e.cust "
            "group by c.tier order by c.tier")
    want = shared(reference_frames_dir, "scan_federation", lambda: RefRunner(
        catalog("jax"), RefConfig(batch_rows=1 << 10)).run(join))
    r = LocalRunner(catalog("port"), ExecConfig(batch_rows=1 << 10),
                    device="cpu")
    assert_frames_equal(r.run(join), want, "federation", rtol=1e-9)
    got = r.run("select count(*) as n, sum(amount) as s from orders"
                " where amount >= 10")
    sel = orders[orders.amount >= 10]
    assert got.n[0] == len(sel)
    np.testing.assert_allclose(got.s[0], sel.amount.sum(), rtol=1e-9)
    got = r.run("select status, count(*) as n from orders "
                "group by status order by status")
    exp = orders.groupby("status").size()
    assert {s: int(n) for s, n in zip(got.status, got.n)
            if isinstance(s, str)} == dict(exp)
    got = r.run("select m.nation, count(*) n, sum(o.amount) s "
                "from rs.orders o join m.nation m on o.cust = m.cust "
                "where o.cust < 10 group by m.nation order by m.nation")
    nat = pd.DataFrame({"cust": np.arange(40),
                        "nation": [f"N{i % 25:02d}" for i in range(40)]})
    e = orders[orders.cust < 10].merge(nat, on="cust").groupby(
        "nation", as_index=False).agg(n=("amount", "size"),
                                      s=("amount", "sum"))
    assert got.nation.tolist() == e.nation.tolist()
    assert got.n.tolist() == e.n.tolist()
    np.testing.assert_allclose(got.s.astype(float), e.s, rtol=1e-9)
    got = r.run("select c.tier, count(*) n from files.customers c "
                "join m.nation m on c.cust = m.cust group by c.tier "
                "order by c.tier")
    assert dict(zip(got.tier, got.n)) == dict(custs.groupby("tier").size())
    assert len(events) == r.run("select count(*) n from files.events").n[0]
