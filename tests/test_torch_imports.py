"""Static guard: no module of the port, and not chip_smoke.py, imports jax
or the JAX package (presto_tpu). One case per file."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "presto_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "presto_tpu")


@pytest.mark.parametrize("path", _port_files())
def test_port_module_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_guard_covers_tpcds_and_window_modules():
    """The TPC-DS generator and queries and the window module are among
    the files guarded above."""
    files = set(_port_files())
    for path in ("presto_tpu_torch/catalog/tpcds.py",
                 "presto_tpu_torch/catalog/tpcds_queries.py",
                 "presto_tpu_torch/ops/window.py"):
        assert path in files, path


def test_guard_covers_structural_and_geo_modules():
    """The ARRAY/MAP functions and the geometry functions are among the
    files guarded above."""
    files = set(_port_files())
    for path in ("presto_tpu_torch/expr/structural.py",
                 "presto_tpu_torch/expr/geo.py"):
        assert path in files, path


def test_guard_covers_memory_modules():
    """The memory pool, page format, spiller, partition hash, radix and
    multiway modules are among the files guarded above."""
    files = set(_port_files())
    for path in ("presto_tpu_torch/memory.py", "presto_tpu_torch/serde.py",
                 "presto_tpu_torch/spiller.py",
                 "presto_tpu_torch/ops/partition.py",
                 "presto_tpu_torch/ops/radix.py",
                 "presto_tpu_torch/plan/multiway.py"):
        assert path in files, path


def test_guard_covers_scan_modules():
    """The scan layer and the file, SQLite and remote connectors are among
    the files guarded above."""
    files = set(_port_files())
    for path in ("presto_tpu_torch/scan/filters.py",
                 "presto_tpu_torch/scan/adaptive.py",
                 "presto_tpu_torch/scan/pruning.py",
                 "presto_tpu_torch/scan/selective.py",
                 "presto_tpu_torch/scan/metrics.py",
                 "presto_tpu_torch/catalog/parquet.py",
                 "presto_tpu_torch/catalog/orc.py",
                 "presto_tpu_torch/catalog/localfile.py",
                 "presto_tpu_torch/catalog/jdbc.py",
                 "presto_tpu_torch/catalog/remote.py"):
        assert path in files, path


def test_guard_covers_cluster_modules():
    """The cluster, its planning and wire modules and the client surface
    are among the files guarded above."""
    files = set(_port_files())
    for path in ("presto_tpu_torch/plan/codec.py",
                 "presto_tpu_torch/plan/fragmenter.py",
                 "presto_tpu_torch/server/__main__.py",
                 "presto_tpu_torch/server/buffers.py",
                 "presto_tpu_torch/server/coordinator.py",
                 "presto_tpu_torch/server/exchange.py",
                 "presto_tpu_torch/server/protocol.py",
                 "presto_tpu_torch/server/querymanager.py",
                 "presto_tpu_torch/server/session.py",
                 "presto_tpu_torch/server/worker.py",
                 "presto_tpu_torch/client.py",
                 "presto_tpu_torch/dbapi.py",
                 "presto_tpu_torch/cli.py"):
        assert path in files, path


def test_guard_covers_obs_modules():
    """The observability plane and its /v1/metrics renderer are among the
    files guarded above."""
    files = set(_port_files())
    for name in ("__init__", "devprof", "events", "exposition", "inflight",
                 "lifecycle", "metrics", "runstats", "trace"):
        assert f"presto_tpu_torch/obs/{name}.py" in files, name
    assert "presto_tpu_torch/server/metrics.py" in files
