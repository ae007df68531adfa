"""The port's observability plane over the cluster, on the CPU at TPC-H
SF 0.01 (one in-process cluster of two workers for the module).

- /v1/query/{id}/trace stitches query → stage → task → operator, with
  exchange_wait spans; EXPLAIN ANALYZE answers over /v1/statement.
- Lifecycle segments sum to the e2e wall and progress ends at 1.0;
  /v1/events carries the transitions in order.
- inflight=on gives a snapshot and a doctor verdict; the stall detector
  fires on an injected stall (its clock is the test's argument, so load
  cannot flip it).
- `--query-event-log` writes JSON lines through the launcher; a
  coordinator's slow-query log and events log write theirs.
- /v1/metrics of every node lints clean under both packages' linters.
- Session validation: the ten observability properties are accepted
  with the JAX package's defaults; hbo=correct is refused naming ROADMAP
  item 12; a bad inflight value is refused.

No JAX query runs here; every wait is bounded.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from presto_tpu.server.session import SYSTEM_PROPERTIES as REF_PROPS
from presto_tpu_torch.client import ClientSession, QueryError, StatementClient
from presto_tpu_torch.obs import events, inflight
from presto_tpu_torch.server.coordinator import DistributedRunner
from presto_tpu_torch.server.session import SYSTEM_PROPERTIES
from test_torch_tpch import Q3, one_torch_thread  # noqa: F401
from presto_tpu_torch.catalog.tpch import tpch_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_PROPS = ("collect_stats", "tracing", "devprof", "profile", "lifecycle",
             "slo_objectives", "latency_regression_factor", "inflight",
             "stall_threshold_s", "straggler_factor")


@pytest.fixture(scope="module")
def cluster():
    dr = DistributedRunner(tpch_catalog(0.01), n_workers=2, device="cpu",
                           timeout_s=30.0, query_timeout_s=60.0)
    yield dr
    dr.close()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _statement(base: str, sql: str, session: str = ""):
    """POST a statement and follow nextUri to the end: (last doc, rows)."""
    headers = {"X-Presto-User": "u"}
    if session:
        headers["X-Presto-Session"] = session
    req = urllib.request.Request(f"{base}/v1/statement", data=sql.encode(),
                                 method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        doc = json.loads(r.read())
    rows = []
    deadline = time.monotonic() + 60
    while True:
        rows += doc.get("data") or []
        if "nextUri" not in doc:
            return doc, rows
        assert time.monotonic() < deadline, "statement did not finish"
        with urllib.request.urlopen(doc["nextUri"], timeout=30) as r:
            doc = json.loads(r.read())


def _levels(node, depth=0, out=None):
    out = [] if out is None else out
    out.append((depth, node["kind"]))
    for c in node["children"]:
        _levels(c, depth + 1, out)
    return out


def test_stitched_trace_lifecycle_progress_and_events(cluster):
    base = cluster.coordinator.url
    doc, rows = _statement(base, Q3)
    assert doc["stats"]["state"] == "FINISHED" and len(rows) == 10
    qid = doc["id"]
    tr = _get(doc["traceUri"])
    assert [r["kind"] for r in tr["tree"]] == ["query"]
    levels = set(_levels(tr["tree"][0]))
    for lv in ((0, "query"), (1, "stage"), (2, "task"), (3, "operator"),
               (1, "exchange_wait"), (3, "exchange_wait")):
        assert lv in levels, (lv, sorted(levels))
    seg = _get(f"{base}/v1/query/{qid}")["stats"]["lifecycle"]["segments"]
    parts = ("queue_wait", "plan", "compile", "exec", "drain")
    assert abs(sum(seg[k] for k in parts) - seg["e2e"]) < 1e-5
    prog = _get(doc["progressUri"])
    assert prog["fraction"] == 1.0 and prog["state"] == "FINISHED"
    ev = _get(f"{base}/v1/events?queryId={qid}&kind=lifecycle")["events"]
    states = [e["state"] for e in ev]
    assert states[0] == "created" and states[-1] == "finished"
    assert states.index("planning") < states.index("executing") \
        < states.index("draining")
    assert all(e["traceToken"] == qid for e in ev)


def test_metrics_endpoints_lint_clean(cluster):
    """After a query, /v1/metrics of the coordinator and of each worker
    lint clean under both packages' linters and carry the obs families."""
    from presto_tpu.obs.exposition import lint_exposition as ref_lint
    from presto_tpu_torch.obs.exposition import lint_exposition

    _statement(cluster.coordinator.url, Q3)
    for url in [cluster.coordinator.url] + [w.url for w in cluster.workers]:
        with urllib.request.urlopen(f"{url}/v1/metrics", timeout=30) as r:
            doc = r.read().decode()
        assert "presto_tpu_stats_drift_ratio" in doc, url
        assert lint_exposition(doc) == [], url
        assert ref_lint(doc) == [], url
    with urllib.request.urlopen(f"{cluster.coordinator.url}/v1/metrics",
                                timeout=30) as r:
        assert "presto_tpu_query_latency_seconds" in r.read().decode()


def test_explain_analyze_over_the_protocol(cluster):
    doc, rows = _statement(cluster.coordinator.url, "explain analyze " + Q3)
    assert doc["stats"]["state"] == "FINISHED", doc.get("error")
    text = "\n".join(r[0] for r in rows)
    assert "-- task execution profile --" in text
    assert "HashJoin" in text and "Aggregate" in text


def test_inflight_snapshot_and_doctor(cluster):
    base = cluster.coordinator.url
    doc, _ = _statement(base, Q3, session="inflight=on")
    qid = doc["id"]
    snap = _get(f"{base}/v1/query/{qid}/inflight")
    assert snap["queryId"] == qid and snap["fragments"]
    doctor = _get(f"{base}/v1/query/{qid}/doctor")
    assert doctor["verdict"] and doctor["causes"]


def test_stall_detector_fires_on_an_injected_stall():
    qid = "stall-probe"
    entry = inflight.register(qid, stall_threshold_s=1000.0)
    try:
        task = inflight.task(qid, f"{qid}.0.0")
        task.publish("Aggregate", rows_in=5, batches=1)
        since = events.EVENTS.last_seq()
        inflight._check_stall(entry, entry.last_publish_ts + 10.0)
        assert not events.EVENTS.events(since=since, kind="stall_detected",
                                        query_id=qid)
        inflight._check_stall(entry, entry.last_publish_ts + 2000.0)
        fired = events.EVENTS.events(since=since, kind="stall_detected",
                                     query_id=qid)
        assert len(fired) == 1 and fired[0]["operator"] == "Aggregate"
        assert entry.stalls == 1
    finally:
        inflight.finish(qid)


def test_query_event_log_through_the_launcher(tmp_path):
    """`--query-event-log` on a launched coordinator: a statement's created
    and completed events land as JSON lines."""
    log = tmp_path / "events.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    p = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.server", "--coordinator",
         "--device", "cpu", "--catalog", "memory:", "--min-workers", "0",
         "--query-event-log", str(log)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        line = p.stdout.readline()
        assert "listening on" in line, line
        url = line.split("listening on ")[1].strip()
        doc, rows = _statement(url, "show catalogs")
        assert rows == [["memory"]]
        recs = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert [r["event"] for r in recs] == ["queryCreated",
                                              "queryCompleted"]
        assert recs[-1]["query_id"] == doc["id"]
        assert recs[-1]["state"] == "FINISHED"
    finally:
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def test_slow_query_log_and_events_log(tmp_path):
    """A coordinator's slow-query log (threshold 0: every completion)
    records the query with its trace's top spans inline, and its events
    log receives the query's lifecycle transitions as JSON lines."""
    from presto_tpu_torch.server.coordinator import Coordinator
    from presto_tpu_torch.server.worker import Worker

    slow, evlog = tmp_path / "slow.jsonl", tmp_path / "events.jsonl"
    cat = tpch_catalog(0.01)
    coord = Coordinator(cat, min_workers=1, device="cpu",
                        slow_query_log=str(slow), events_log=str(evlog))
    w = Worker(cat, node_id="w0", coordinator_url=coord.url, device="cpu")
    try:
        deadline = time.monotonic() + 30
        while not coord.node_manager.active_nodes():
            assert time.monotonic() < deadline, "the worker did not join"
            time.sleep(0.05)
        qe = coord.query_manager.create_query(
            coord.protocol.session_from_headers({}),
            "select count(*) as n from nation")
        assert qe.wait(60)
        assert qe.state == "FINISHED", qe.error
        rec = [json.loads(ln) for ln in slow.read_text().splitlines()][-1]
        assert rec["queryId"] == qe.query_id and rec["state"] == "FINISHED"
        assert rec["topSpans"]
        assert all("durationS" in t for t in rec["topSpans"])
        states = [e["state"] for e in map(json.loads,
                                          evlog.read_text().splitlines())
                  if e.get("queryId") == qe.query_id
                  and e["kind"] == "lifecycle"]
        assert states[0] == "created" and states[-1] == "finished"
    finally:
        events.EVENTS.path = None  # the event stream is process-wide
        w.close()
        coord.close()


def test_observability_properties_validate(cluster):
    url = cluster.coordinator.url
    for name in OBS_PROPS:
        mine, ref = SYSTEM_PROPERTIES.metadata(name), \
            REF_PROPS.metadata(name)
        assert (mine.default, mine.py_type) == (ref.default, ref.py_type)
    session = ClientSession()
    for name, value in (("collect_stats", "true"), ("tracing", "false"),
                        ("devprof", "'on'"), ("profile", "false"),
                        ("lifecycle", "'off'"),
                        ("slo_objectives", "'e2e=1.5'"),
                        ("latency_regression_factor", "2.0"),
                        ("inflight", "'on'"), ("stall_threshold_s", "3.0"),
                        ("straggler_factor", "5.0"), ("hbo", "'off'")):
        list(StatementClient(url, f"set session {name} = {value}",
                             session).rows())
        assert name in session.properties
    with pytest.raises(QueryError, match="ROADMAP item 12"):
        list(StatementClient(url, "set session hbo = 'correct'",
                             ClientSession()).rows())
    with pytest.raises(QueryError, match="inflight"):
        list(StatementClient(url, "set session inflight = 'maybe'",
                             ClientSession()).rows())
