"""The port end to end against the JAX package on TPC-DS at SF 0.01.

- The port's generated tables equal the JAX package's, array for array.
- Each of the 44 TPC-DS queries of presto_tpu_torch/catalog/tpcds_queries.py
  gives the JAX package's frame (its per-batch path, breaker_engine auto,
  computed once a query) under the port's breaker_engine auto and hash, in
  the same row order. Tolerance: exact for decimals, integers, dates,
  strings, keys and counts; float columns (averages, stddev, percentiles
  over doubles, float windows) at rtol=1e-12, the tolerance the JAX
  package allows between its own engines (tests/test_kernels.py).
- EXPLAIN marks the same breaker engines as the JAX package's.
"""

import ast
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from presto_tpu.catalog.tpcds import tpcds_catalog as ref_tpcds_catalog
from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu_torch.catalog.tpcds import tpcds_catalog
from presto_tpu_torch.catalog.tpcds_queries import (
    ANALYTIC,
    ANSWERS,
    QUERIES,
    SHAPES,
)
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from test_torch_tpch import assert_frames_equal, one_torch_thread  # noqa: F401

SF = 0.01
# the session of tests/test_tpcds_answers.py and tests/test_tpcds_queries.py
CFG = dict(batch_rows=1 << 15, agg_capacity=1 << 14)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def catalogs():
    return ref_tpcds_catalog(SF), tpcds_catalog(SF)


def test_tables_identical(catalogs):
    ref, port = catalogs
    rc, pc = ref.connectors["tpcds"], port.connectors["tpcds"]
    names = rc.table_names()
    assert names == pc.table_names() and len(names) == 24
    for name in names:
        rh, ph = rc.get_table(name), pc.get_table(name)
        assert rh.row_count == ph.row_count and rh.primary_key == ph.primary_key
        rt, pt = rc.tables[name], pc.tables[name]
        assert list(rt.arrays) == list(pt.arrays)
        for col, arr in rt.arrays.items():
            assert str(rt.types[col]) == str(pt.types[col])
            assert arr.dtype == pt.arrays[col].dtype
            assert arr.tobytes() == pt.arrays[col].tobytes(), (name, col)
            assert (rt.validity[col] is None) == (pt.validity[col] is None)
            if rt.validity[col] is not None:
                np.testing.assert_array_equal(pt.validity[col],
                                              rt.validity[col])
            if col in rt.dicts:
                np.testing.assert_array_equal(pt.dicts[col].values,
                                              rt.dicts[col].values)
            assert (dataclasses.asdict(rt.column_stats(col))
                    == dataclasses.asdict(pt.column_stats(col)))


@pytest.mark.parametrize("q", list(QUERIES))
def test_tpcds_query_matches_reference(catalogs, q):
    """One query: the JAX package's frame once, the port's under auto and
    under hash held to it."""
    ref, port = catalogs
    want = RefRunner(ref, RefConfig(fragment_fusion=False, **CFG)).run(
        QUERIES[q])
    assert want.columns.is_unique  # every output column is compared
    for engine in ("auto", "hash"):
        got = LocalRunner(port, ExecConfig(breaker_engine=engine, **CFG),
                          device="cpu").run(QUERIES[q])
        assert_frames_equal(got, want, (q, engine))


def _sql_of_test_functions(path):
    """`sql = "..."` of each test function of a test file, by name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_"):
            for st in fn.body:
                if (isinstance(st, ast.Assign)
                        and getattr(st.targets[0], "id", None) == "sql"):
                    out[fn.name[len("test_"):]] = ast.literal_eval(st.value)
    return out


def test_port_carries_the_query_texts():
    """chip_smoke.py runs the port's copy of the texts: the answer-level
    queries as tests/test_tpcds_answers.py holds them, the shapes of
    tests/test_tpcds_queries.py (up to line breaks), and the 17 analytic
    queries."""
    from test_tpcds_answers import Q

    assert ANSWERS == Q
    shapes = _sql_of_test_functions(os.path.join(HERE,
                                                 "test_tpcds_queries.py"))
    assert {k: " ".join(v.split()) for k, v in SHAPES.items()} == {
        k: " ".join(v.split()) for k, v in shapes.items()}
    assert len(ANALYTIC) == 17
    assert len(QUERIES) == len(ANSWERS) + len(SHAPES) + len(ANALYTIC) == 44


def test_explain_marks_engines_like_reference(catalogs):
    """EXPLAIN of each query, breaker engine marks included, line for
    line."""
    ref, port = catalogs
    for engine in ("auto", "hash"):
        rr = RefRunner(ref, RefConfig(breaker_engine=engine, **CFG))
        pr = LocalRunner(port, ExecConfig(breaker_engine=engine, **CFG),
                         device="cpu")
        for q, sql in QUERIES.items():
            # the port has no whole-fragment fusion; the multiway
            # verdicts ([join=]) are the JAX package's
            want = [re.sub(r"\s+\[fragment=[^\]]*\]", "", ln)
                    for ln in rr.explain(sql).splitlines()]
            assert pr.explain(sql).splitlines() == want, (q, engine)


def test_runner_needs_cuda_unless_asked_for_the_cpu(catalogs):
    """Over TPC-DS too, LocalRunner runs on the card unless the caller asks
    for the CPU."""
    _, port = catalogs
    if torch.cuda.is_available():
        assert LocalRunner(port).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalRunner(port)
    assert LocalRunner(port, device="cpu").device.type == "cpu"
