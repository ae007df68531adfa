"""The port's observability plane (presto_tpu_torch/obs/) against the JAX
package's, on the CPU at TPC-H SF 0.01.

- The exposition linter gives the same errors in both packages for the
  same documents, valid and each kind of invalid; the port's /v1/metrics
  documents lint clean under both linters.
- Histogram renders the same text for the same observations; build_tree
  gives the same tree for the same spans.
- runstats.node_fingerprint equals the JAX package's for every node of the
  22 TPC-H plans (planning only).
- LocalRunner.explain_analyze of Q1 and Q3 (auto) and Q3 under the hash
  engine equals the JAX package's text with wall and bytes masked, and
  with them the JAX package's compile-plane annotations (fragment fusion,
  compiles, shapes), which belong to its program cache (ROADMAP item 12):
  operator names, rows, batches, the engine verdicts and HBO's
  est/actual/drift match exactly. The HBO store after those runs equals
  the JAX package's over (site, op, est, actual).
- A Limit query's operator spans have the JAX package's names and kinds.
- devprof on the CPU is honestly unavailable, and reconcile declines.

Four JAX query executions in all (three EXPLAIN ANALYZE, one Limit).
"""

import re

import pytest
import torch

from presto_tpu.exec import ExecConfig as RefConfig
from presto_tpu.exec import LocalRunner as RefRunner
from presto_tpu.memory import MemoryPool as RefPool
from presto_tpu.obs import devprof as ref_devprof
from presto_tpu.obs import exposition as ref_exposition
from presto_tpu.obs import metrics as ref_metrics
from presto_tpu.obs import runstats as ref_runstats
from presto_tpu.obs import trace as ref_trace
from presto_tpu_torch.exec import ExecConfig, LocalRunner
from presto_tpu_torch.memory import MemoryPool
from presto_tpu_torch.obs import devprof, exposition, runstats, trace
from presto_tpu_torch.obs import metrics as obs_metrics
from presto_tpu_torch.server import metrics as server_metrics
from test_torch_tpch import Q1, Q3, TPCH, catalogs, one_torch_thread  # noqa: F401

VALID = """# HELP m_total things
# TYPE m_total counter
m_total{a="x\\"y"} 3
# HELP h latency
# TYPE h histogram
h_bucket{le="0.1"} 1
h_bucket{le="1"} 2
h_bucket{le="+Inf"} 2
h_sum 0.5
h_count 2
"""
INVALID = {
    "duplicate_help": "# HELP g a\n# HELP g b\n# TYPE g gauge\ng 1\n",
    "bad_type": "# HELP g a\n# TYPE g meter\ng 1\n",
    "type_after_sample": "# HELP g a\ng 1\n# TYPE g gauge\n",
    "bad_name": "# HELP 9g a\n# TYPE 9g gauge\n9g 1\n",
    "bad_escape": '# HELP g a\n# TYPE g gauge\ng{a="\\q"} 1\n',
    "unquoted_label": "# HELP g a\n# TYPE g gauge\ng{a=1} 1\n",
    "missing_help": "# TYPE g gauge\ng 1\n",
    "histogram_suffix": "# HELP h a\n# TYPE h histogram\nh 1\n",
    "unsorted_le": ('# HELP h a\n# TYPE h histogram\nh_bucket{le="1"} 1\n'
                    'h_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 1\n'
                    'h_sum 1\nh_count 1\n'),
    "not_monotone": ('# HELP h a\n# TYPE h histogram\nh_bucket{le="0.1"} 2\n'
                     'h_bucket{le="1"} 1\nh_bucket{le="+Inf"} 2\n'
                     'h_sum 1\nh_count 2\n'),
    "missing_inf": ('# HELP h a\n# TYPE h histogram\nh_bucket{le="1"} 1\n'
                    'h_sum 1\nh_count 1\n'),
    "count_mismatch": ('# HELP h a\n# TYPE h histogram\nh_bucket{le="1"} 1\n'
                       'h_bucket{le="+Inf"} 1\nh_sum 1\nh_count 2\n'),
    "unparseable": "# HELP g a\n# TYPE g gauge\ng one two\n",
}


@pytest.mark.parametrize("name", ["valid"] + sorted(INVALID))
def test_linter_agrees_with_reference(name):
    doc = VALID if name == "valid" else INVALID[name]
    got = exposition.lint_exposition(doc)
    assert got == ref_exposition.lint_exposition(doc)
    assert bool(got) == (name != "valid")


def test_port_metrics_documents_lint_clean():
    """The worker and coordinator documents of the port's /v1/metrics, with
    every family armed, lint clean under both linters."""
    from types import SimpleNamespace

    from presto_tpu_torch.obs import inflight, lifecycle

    lifecycle.arm()
    inflight.arm()
    obs_metrics.QUERY_LATENCY.observe(0.25, plane="coordinator",
                                      state="FINISHED")
    obs_metrics.EXCHANGE_WAIT.observe(0.001, plane="worker")
    worker = SimpleNamespace(status=lambda: {
        "nodeId": 'w"1', "tasks": 2, "runningTasks": 1,
        "memory": {"reservedBytes": 10, "limitBytes": None},
        "spillInUseBytes": 0})
    qm = SimpleNamespace(queries=lambda: [
        SimpleNamespace(state="FINISHED"), SimpleNamespace(state="FAILED")])
    nm = SimpleNamespace(active_nodes=lambda: [1, 2], nodes={1: 0, 2: 0})
    coord = SimpleNamespace(query_manager=qm, node_manager=nm,
                            _dplan_cache={})
    for doc in (server_metrics.worker_metrics(worker),
                server_metrics.coordinator_metrics(coord)):
        assert "presto_tpu_stats_drift_ratio_bucket" in doc
        assert exposition.lint_exposition(doc) == []
        assert ref_exposition.lint_exposition(doc) == []


def test_histogram_renders_like_reference():
    args = ("t_seconds", "a test family", obs_metrics.log_buckets(0.01, 10))
    assert args[2] == ref_metrics.log_buckets(0.01, 10)
    mine, ref = obs_metrics.Histogram(*args), ref_metrics.Histogram(*args)
    for v, labels in ((0.005, {"plane": "worker"}), (0.5, {"plane": "worker"}),
                      (50.0, {"plane": "worker", "op": 'a"b'}),
                      (0.2, {"plane": "coordinator"})):
        mine.observe(v, **labels)
        ref.observe(v, **labels)
    for plane in ("worker", "coordinator", "none"):
        assert mine.render(plane) == ref.render(plane)


def test_build_tree_like_reference():
    rows = [("r", None, "query", "query", 1.0, 9.0, None),
            ("s", "r", "stage-0", "stage", 2.0, 8.0, {"fragment": 0}),
            ("t2", "s", "task", "task", 3.5, 7.0, None),
            ("t1", "s", "task", "task", 3.0, 7.5, {"node": "w0"}),
            ("o", "t1", "Aggregate", "operator", 3.1, 7.4, {"batches": 2}),
            ("x", "gone", "exchange_wait", "exchange_wait", 0.5, 0.6, None)]
    mine = trace.build_tree([trace.Span(*r) for r in rows])
    assert mine == ref_trace.build_tree([ref_trace.Span(*r) for r in rows])
    assert [d["spanId"] for d in mine] == ["x", "r"]


def test_trace_token_round_trip():
    assert trace.TRACE_HEADER == ref_trace.TRACE_HEADER
    tok = trace.format_token("q7", "s1")
    assert tok == ref_trace.format_token("q7", "s1")
    assert trace.parse_token(tok) == ref_trace.parse_token(tok) == ("q7", "s1")


def _walk_pair(a, b):
    yield a, b
    ca, cb = a.children(), b.children()
    assert len(ca) == len(cb), (type(a).__name__, type(b).__name__)
    for x, y in zip(ca, cb):
        yield from _walk_pair(x, y)


def test_node_fingerprints_equal_reference(catalogs):
    """Every node of the 22 TPC-H plans keys HBO history alike in both
    packages (planning only)."""
    ref_cat, cat = catalogs
    ref, port = RefRunner(ref_cat), LocalRunner(cat, device="cpu")
    n = 0
    for q, sql in TPCH.items():
        for a, b in _walk_pair(ref.plan(sql).root, port.plan(sql).root):
            fa = ref_runstats.node_fingerprint(a, ref_cat)
            assert fa is not None, (q, type(a).__name__)
            assert runstats.node_fingerprint(b, cat) == fa, \
                (q, type(b).__name__)
            n += 1
    assert n > 300


# the JAX package's compile-plane annotations (ROADMAP item 12) and the
# measured quantities, masked on both sides
_MASKS = [
    (re.compile(r"   \[fragment=[^\]]*\]"), ""),
    (re.compile(r"   \[programs=[^\]]*\]"), ""),
    (re.compile(r", compiles=\d+, compile=[\d.]+s, execute=[\d.]+s"), ""),
    (re.compile(r", shapes=\d+/\d+"), ""),
    (re.compile(r"wall=[\d.]+ms"), "wall=*"),
    (re.compile(r", bytes=\d+"), ""),
]


def _masked(text: str) -> str:
    for pat, rep in _MASKS:
        text = pat.sub(rep, text)
    return text


def _hbo_view(snap, drift):
    """(history key → (est, actual, n)) and the drift histogram's
    (op, site) → observation count."""
    hist = {k: (v.get("est"), v["actual"], v["n"])
            for k, v in snap["history"].items()}
    ops = {}
    for key, s in drift.snapshot("worker").items():
        lab = dict(key)
        ops[(lab["op"], lab["site"])] = s["count"]
    return hist, ops


def test_explain_analyze_and_hbo_match_reference(catalogs, monkeypatch):
    """Q1 and Q3 under auto and Q3 under hash: the annotated plans equal
    the JAX package's (masked as above), and so do the HBO stores they
    leave behind."""
    monkeypatch.delenv("PRESTO_TPU_CACHE_DIR", raising=False)
    ref_cat, cat = catalogs
    runstats.reset()
    ref_runstats.reset()
    obs_metrics.STATS_DRIFT.reset()
    ref_metrics.STATS_DRIFT.reset()
    for sql, engine in ((Q1, "auto"), (Q3, "auto"), (Q3, "hash")):
        want = RefRunner(ref_cat, RefConfig(breaker_engine=engine)) \
            .explain_analyze(sql)
        got = LocalRunner(cat, ExecConfig(breaker_engine=engine),
                          device="cpu").explain_analyze(sql)
        assert "est=" in got and "actual=" in got and "drift=" in got
        assert _masked(got) == _masked(want), (engine, got, want)
    assert _hbo_view(runstats.snapshot(), obs_metrics.STATS_DRIFT) == \
        _hbo_view(ref_runstats.snapshot(), ref_metrics.STATS_DRIFT)


def _operator_spans(tracer):
    return sorted((s.name, s.kind) for s in tracer.spans()
                  if s.kind in ("operator", "query"))


def test_limit_query_spans_match_reference(catalogs):
    """A Limit over a multi-split scan stops its stream early: the spans
    the open generators close in `finally` name the same operators."""
    ref_cat, cat = catalogs
    sql = "select l_orderkey, l_quantity from lineitem limit 5"
    ref = RefRunner(ref_cat, RefConfig(batch_rows=8192))
    port = LocalRunner(cat, ExecConfig(batch_rows=8192), device="cpu")
    assert len(port.run(sql)) == len(ref.run(sql)) == 5
    got, want = _operator_spans(port.last_trace), \
        _operator_spans(ref.last_trace)
    assert got == want
    assert ("Limit", "operator") in got and ("TableScan", "operator") in got
    tree = port.last_trace.to_json()["tree"]
    assert [r["kind"] for r in tree] == ["query"]


def test_devprof_is_honest_on_the_cpu():
    """Without a card the memory sample says why it has no numbers, and
    reconcile declines rather than observe fabricated ones — as the JAX
    package does on its CPU."""
    for mod, pool in ((devprof, MemoryPool(1 << 20)),
                      (ref_devprof, RefPool(1 << 20))):
        mod.reset()
        try:
            mod.activate()
            doc = mod.sample_hbm()
            assert doc["available"] is False and doc["reason"]
            assert "bytesInUse" not in doc
            pool.reserve(1000, tag="q")
            assert mod.reconcile(pool) is None
        finally:
            mod.reset()
    devprof.activate(torch.device("cpu"))
    try:
        assert devprof.sample_hbm()["platform"] == "cpu"
        assert devprof.summary()["programs"] == 0
    finally:
        devprof.reset()


def test_devprof_fake_provider_reconciles():
    """An injected provider's watermark feeds reconcile and the ledger
    drift histogram as in the JAX package."""
    devprof.reset()
    try:
        devprof.activate()
        devprof.set_provider(lambda: {"bytes_in_use": 900,
                                      "peak_bytes_in_use": 1800,
                                      "bytes_limit": 10_000})
        pool = MemoryPool(1 << 20)
        pool.reserve(1000, tag="q")
        before = sum(s["count"] for s in
                     obs_metrics.LEDGER_DRIFT.snapshot("worker").values())
        rec = devprof.reconcile(pool, plane="worker", site="unit")
        assert rec["driftRatio"] == pytest.approx(1.8)
        after = sum(s["count"] for s in
                    obs_metrics.LEDGER_DRIFT.snapshot("worker").values())
        assert after == before + 1
    finally:
        devprof.set_provider(None)
        devprof.reset()
