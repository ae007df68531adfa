"""The port's distributed planning and wire formats against the JAX
package's, with no query run by either.

- Fragments: for each of the 22 TPC-H queries (the texts of
  tests/test_tpch.py) at SF 0.01, the port's `fragment_plan` cuts the
  JAX package's fragments, compared as the codec's JSON, character for
  character, under the default broadcast threshold and under one of 0
  rows (every join partitioned). The 44 TPC-DS queries are held the same
  way in tests/test_torch_tpcds.py, over that file's catalogs.
- `tag_colocated_joins` marks the same joins over two bucketed Parquet
  tables, and a TaskUpdate written by either package reads back equal in
  the other.
- Pages with dictionaries by reference: the same bytes from both
  packages, and each package reads the other's, resolving a dictionary it
  has not seen through the other's `lookup_dictionary`.
- The exchange's partition ids, radix stamps and lane layout are the JAX
  package's for the same batch, exactly.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from presto_tpu.catalog.memory import MemoryConnector as RefMemory
from presto_tpu.catalog import parquet as ref_parquet
from presto_tpu.catalog.tpch import tpch_catalog as ref_tpch_catalog
from presto_tpu.connector import Catalog as RefCatalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.ops import partition as ref_partition
from presto_tpu.ops.radix import radix_ids as ref_radix_ids
from presto_tpu.plan import codec as ref_codec
from presto_tpu.plan.builder import plan_query as ref_plan_query
from presto_tpu.plan.fragmenter import fragment_plan as ref_fragment_plan
from presto_tpu.plan.fragmenter import tag_colocated_joins as ref_tag
from presto_tpu.plan.multiway import apply_join_mode as ref_join_mode
from presto_tpu.plan.optimizer import optimize as ref_optimize
from presto_tpu import serde as ref_serde
from presto_tpu.server.worker import TaskUpdate as RefTaskUpdate
from presto_tpu_torch import serde
from presto_tpu_torch.catalog import parquet
from presto_tpu_torch.catalog.memory import MemoryConnector
from presto_tpu_torch.catalog.tpch import tpch_catalog
from presto_tpu_torch.connector import Catalog
from presto_tpu_torch.exec import ExecConfig
from presto_tpu_torch.ops import partition
from presto_tpu_torch.ops.radix import radix_ids
from presto_tpu_torch.plan import codec
from presto_tpu_torch.plan.builder import plan_query
from presto_tpu_torch.plan.fragmenter import fragment_plan, tag_colocated_joins
from presto_tpu_torch.plan.multiway import apply_join_mode
from presto_tpu_torch.plan.nodes import plan_to_string
from presto_tpu_torch.plan.optimizer import optimize
from presto_tpu_torch.server.worker import TaskUpdate
from test_torch_tpch import TPCH, one_torch_thread  # noqa: F401

SF = 0.01
THRESHOLDS = {"default": 1_000_000, "partitioned": 0}


def ref_fragments(cat, sql, threshold):
    qp = ref_optimize(ref_plan_query(sql, cat), cat)
    ref_join_mode(qp, cat, RefConfig())
    return ref_fragment_plan(qp, cat, broadcast_threshold_rows=threshold)


def port_fragments(cat, sql, threshold):
    qp = optimize(plan_query(sql, cat), cat)
    apply_join_mode(qp, cat, ExecConfig())
    return fragment_plan(qp, cat, broadcast_threshold_rows=threshold)


def assert_same_fragments(ref_cat, port_cat, sql, threshold, where):
    """Both packages cut `sql` into the same fragments: the same codec
    JSON, the same root and output names, the same estimates."""
    rd = ref_fragments(ref_cat, sql, threshold)
    pd_ = port_fragments(port_cat, sql, threshold)
    assert (rd.root_fid, rd.output_names) == (pd_.root_fid,
                                              pd_.output_names), where
    want = {f: json.dumps(ref_codec.fragment_to_json(x), sort_keys=True)
            for f, x in rd.fragments.items()}
    got = {f: json.dumps(codec.fragment_to_json(x), sort_keys=True)
           for f, x in pd_.fragments.items()}
    assert got == want, where
    assert ([f.est_rows for f in pd_.fragments.values()]
            == [f.est_rows for f in rd.fragments.values()]), where
    assert pd_.to_string() == rd.to_string(), where


@pytest.fixture(scope="module")
def catalogs():
    return ref_tpch_catalog(SF), tpch_catalog(SF)


@pytest.mark.parametrize("q, how", [
    pytest.param(q, how, id=f"{q}-{how}")
    for how in THRESHOLDS for q in TPCH])
def test_tpch_fragments_match_reference(catalogs, q, how):
    ref, port = catalogs
    assert_same_fragments(ref, port, TPCH[q], THRESHOLDS[how], (q, how))


def test_partitioned_plans_cut_every_join():
    """A threshold of 0 rows partitions every join of Q3: each side of
    each HashJoin is a hash exchange on its keys (no broadcast), and the
    aggregation runs partial → hash exchange → final."""
    cat = tpch_catalog(SF)
    dp = port_fragments(cat, TPCH["q3"], 0)
    outs = [f.output_partitioning for f in dp.fragments.values()]
    assert outs.count("hash") == 5 and "broadcast" not in outs
    text = dp.to_string()
    assert text.count("RemoteSource") == 6
    assert "Aggregate[partial; keys=" in text
    assert "Aggregate[final; keys=" in text


def _bucketed_pair(d, mod, write):
    rng = np.random.default_rng(7)
    a = {"k": rng.integers(0, 50, 400), "x": rng.integers(0, 5, 400)}
    b = {"k": np.arange(50), "y": rng.integers(0, 9, 50)}
    for name, data in (("a", a), ("b", b)):
        write(d, name, data, {c: mod.parse_type("bigint") for c in data},
              ["k"], 4)


def test_tag_colocated_joins_matches_reference(tmp_path):
    """Two tables bucketed alike on the join key (written by the port):
    both packages mark the join colocated over 4 buckets, and the tagged
    plans encode alike; a join on another column stays untagged."""
    from presto_tpu_torch import types as port_types

    d = str(tmp_path)
    _bucketed_pair(d, port_types, parquet.write_bucketed_table)
    ref, port = RefCatalog(), Catalog()
    ref.register("pq", ref_parquet.ParquetConnector(d), default=True)
    port.register("pq", parquet.ParquetConnector(d), default=True)
    for sql, buckets in (
            ("select a.x, b.y from a join b on a.k = b.k", 4),
            ("select a.x, b.y from a join b on a.x = b.y", 0)):
        rq = ref_optimize(ref_plan_query(sql, ref), ref)
        pq_ = optimize(plan_query(sql, port), port)
        ref_tag(rq.root, ref)
        tag_colocated_joins(pq_.root, port)
        assert (json.dumps(codec.node_to_json(pq_.root), sort_keys=True)
                == json.dumps(ref_codec.node_to_json(rq.root),
                              sort_keys=True)), sql
        assert (f"colocated={buckets} buckets"
                in plan_to_string(pq_.root)) == bool(buckets), sql


def test_task_updates_cross_both_ways(catalogs):
    """A TaskUpdate (Q3's partitioned build fragment, split assignment,
    upstreams, config) written by either package reads back in the other
    and writes the same JSON again."""
    ref, port = catalogs
    rd = ref_fragments(ref, TPCH["q3"], 0)
    pd_ = port_fragments(port, TPCH["q3"], 0)
    fid = sorted(rd.fragments)[1]
    kw = dict(task_index=1, n_tasks=2, n_out_partitions=2,
              upstreams={0: ["http://127.0.0.1:1/v1/task/q1.0.0/results/1"]},
              spool=True, split_assignment={"orders": [0, 2]},
              split_counts={"orders": 3})
    ru = RefTaskUpdate(fragment=rd.fragments[fid],
                       config={"batch_rows": 8192}, **kw)
    pu = TaskUpdate(fragment=pd_.fragments[fid],
                    config={"batch_rows": 8192}, **kw)
    rj, pj = ref_codec.task_update_to_json(ru), codec.task_update_to_json(pu)
    assert json.dumps(pj, sort_keys=True) == json.dumps(rj, sort_keys=True)
    # each package reads the other's JSON and writes it back unchanged
    wire_r = json.loads(json.dumps(rj))
    wire_p = json.loads(json.dumps(pj))
    back_p = codec.task_update_to_json(codec.task_update_from_json(wire_r))
    back_r = ref_codec.task_update_to_json(
        ref_codec.task_update_from_json(wire_p))
    assert back_p == rj and back_r == pj
    got = codec.task_update_from_json(wire_r)
    assert isinstance(got, TaskUpdate) and got.split_counts == {"orders": 3}


def _string_frame(tag: str, n_values: int, rows: int = 300):
    """A frame whose string column has `n_values` distinct values no other
    test makes (so neither package has interned its dictionary)."""
    rng = np.random.default_rng(n_values)
    vals = np.array([f"{tag}-{i:04d}" for i in range(n_values)], object)
    s = vals[rng.integers(0, n_values, rows)]
    s[::7] = None
    return pd.DataFrame({"s": s, "k": rng.integers(-5, 50, rows),
                         "d": rng.normal(size=rows)})


def _batches(df):
    """The same frame as one batch of each package (memory connectors)."""
    rc, pc = RefMemory("m"), MemoryConnector("m")
    rc.add_table("t", df)
    pc.add_table("t", df)
    rh, ph = rc.get_table("t"), pc.get_table("t")
    cols = list(df.columns)
    rb = rc.read_split(rc.splits(rh, 1)[0], cols)
    pb = pc.read_split(pc.splits(ph, 1)[0], cols, torch.device("cpu"))
    return rb, pb


def test_pages_with_dictionary_refs_match_reference():
    """The same batch serialized with dict_refs by both packages: the same
    bytes; a dictionary of 64 values or fewer stays inline, a larger one
    goes as its digest, which lookup_dictionary resolves in both."""
    for n_values, by_ref in ((40, False), (200, True)):
        rb, pb = _batches(_string_frame("same", n_values))
        rp = ref_serde.serialize_batch(rb, dict_refs=True)
        pp = serde.serialize_batch(pb, dict_refs=True)
        assert pp == rp, n_values
        assert (b'"ref":' in pp) == by_ref
        if by_ref:
            hlen = int.from_bytes(pp[5:9], "little")  # after magic, flags
            digest = json.loads(pp[13:13 + hlen])["dicts"]["s"]["ref"]
            assert (serde.lookup_dictionary(digest)
                    == ref_serde.lookup_dictionary(digest))
    assert serde.lookup_dictionary("00" * 32) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pages_cross_with_the_other_package_resolving(writer):
    """A page whose dictionary goes by reference, written by one package,
    reads back in the other, which has never interned that dictionary:
    the reader's resolver fetches its values from the writer's
    lookup_dictionary (the /v1/dict side channel), once."""
    rb, pb = _batches(_string_frame(f"cross-{writer}", 150 + len(writer)))
    if writer == "jax":
        page, lookup = ref_serde.serialize_batch(rb, dict_refs=True), \
            ref_serde.lookup_dictionary
    else:
        page, lookup = serde.serialize_batch(pb, dict_refs=True), \
            serde.lookup_dictionary
    asked = []

    def resolver(digest):
        asked.append(digest)
        return lookup(digest)

    if writer == "jax":
        got = serde.deserialize_batch(page, dict_resolver=resolver)
        want = ref_serde.deserialize_batch(page).to_pydict()
        assert got.to_pydict().keys() == want.keys()
        for c in want:
            assert list(got.to_pydict()[c]) == list(want[c]), c
    else:
        got = ref_serde.deserialize_batch(page, dict_resolver=resolver)
        want = serde.deserialize_batch(page).to_pydict()
        for c in want:
            assert list(got.to_pydict()[c]) == list(want[c]), c
    assert len(asked) == 1
    with pytest.raises(ValueError, match="no resolver"):
        other = (_batches(_string_frame(f"unseen-{writer}", 99))[0]
                 if writer == "jax" else
                 _batches(_string_frame(f"unseen-{writer}", 98))[1])
        page2 = (ref_serde.serialize_batch(other, dict_refs=True)
                 if writer == "jax" else
                 serde.serialize_batch(other, dict_refs=True))
        (serde if writer == "jax" else ref_serde).deserialize_batch(page2)


@pytest.mark.parametrize("keys", [["k"], ["s"], ["s", "k"], ["d"]])
def test_exchange_ids_match_reference(keys):
    """partition_ids (the worker's hash sink) for 2 and 3 consumers,
    radix stamps for 4 and 8 partitions, and partition_layout /
    partition_for_exchange's lanes: the JAX package's, exactly, for the
    same batch (string keys by content, NULL keys included)."""
    rb, pb = _batches(_string_frame("ids", 80, rows=256))
    for n in (2, 3):
        want = np.asarray(ref_partition.partition_ids(rb, keys, n))
        got = partition.partition_ids(pb, keys, n).numpy()
        np.testing.assert_array_equal(got, want)
    for r in (4, 8):
        np.testing.assert_array_equal(
            radix_ids(pb, keys, r).numpy(),
            np.asarray(ref_radix_ids(rb, keys, r)))
    for want, got in zip(ref_partition.partition_layout(rb, keys, 3, 64),
                         partition.partition_layout(pb, keys, 3, 64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rout, rcounts, rover = ref_partition.partition_for_exchange(
        rb, keys, 3, 64)
    pout, pcounts, pover = partition.partition_for_exchange(pb, keys, 3, 64)
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(rcounts))
    assert int(pover) == int(rover) > 0
    np.testing.assert_array_equal(pout.live.numpy(), np.asarray(rout.live))
    for pc, rc in zip(pout.columns, rout.columns):
        np.testing.assert_array_equal(pc.values.numpy(),
                                      np.asarray(rc.values))
        if rc.validity is not None:
            np.testing.assert_array_equal(pc.validity.numpy(),
                                          np.asarray(rc.validity))
