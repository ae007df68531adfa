"""Standalone cluster launchers:

    python -m presto_tpu_torch.server --coordinator --port 8080 \
        --catalog tpch:sf=1 [--min-workers 2] [--secret S] [--device cuda]
    python -m presto_tpu_torch.server --worker --coordinator-url http://host:8080 \
        --catalog tpch:sf=1 [--node-id w1] [--secret S] [--device cuda]

Reference: server/PrestoServer.java:69-119 — one binary, role decided by
config (coordinator=true/false); here by flag. Workers announce to the
coordinator (airlift discovery analog) and serve the /v1/task data plane;
the coordinator serves /v1/statement + introspection and schedules
fragments. Both sides must be configured with the same catalogs (the
reference distributes etc/catalog/*.properties the same way). Each node
runs on the device `--device` names, CUDA by default (a node without a
GPU refuses to start unless given `--device cpu`).

Catalog specs (repeatable --catalog):
    tpch:sf=<N>           deterministic TPC-H generator connector
    tpcds:sf=<N>          deterministic TPC-DS generator connector
    parquet:dir=<path>    directory of <table>.parquet files
    orc:dir=<path>        directory of <table>.orc files
    memory:               empty in-memory connector
Optionally prefix with a name: `--catalog warehouse=parquet:dir=/data`.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def build_catalog(specs):
    from presto_tpu_torch.connector import Catalog

    cat = Catalog()
    if not specs:
        specs = ["tpch:sf=0.01"]
    for i, spec in enumerate(specs):
        name = None
        if "=" in spec.split(":", 1)[0]:
            name, spec = spec.split("=", 1)
        kind, _, argstr = spec.partition(":")
        args = {}
        for kv in filter(None, argstr.split(",")):
            k, _, v = kv.partition("=")
            args[k] = v
        if kind == "tpch":
            from presto_tpu_torch.catalog.tpch import TpchConnector

            conn = TpchConnector(float(args.get("sf", 1.0)))
        elif kind == "tpcds":
            from presto_tpu_torch.catalog.tpcds import TpcdsConnector

            conn = TpcdsConnector(float(args.get("sf", 1.0)))
        elif kind == "parquet":
            from presto_tpu_torch.catalog.parquet import ParquetConnector

            conn = ParquetConnector(args["dir"])
        elif kind == "orc":
            from presto_tpu_torch.catalog.orc import OrcConnector

            conn = OrcConnector(args["dir"])
        elif kind == "memory":
            from presto_tpu_torch.catalog.memory import MemoryConnector

            conn = MemoryConnector()
        else:
            # plugin connectors: any importable module exposing
            # create_connector(**args) -> Connector (the PluginManager /
            # ConnectorFactory SPI analog — discovery by module path
            # instead of a plugin directory scan)
            import importlib

            try:
                mod = importlib.import_module(kind)
            except ImportError:
                raise SystemExit(f"unknown catalog kind: {kind}")
            factory = getattr(mod, "create_connector", None)
            if factory is None:
                raise SystemExit(
                    f"plugin module {kind} has no create_connector()")
            conn = factory(**args)
        cat.register(name or kind, conn, default=(i == 0))
    return cat


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m presto_tpu_torch.server")
    role = p.add_mutually_exclusive_group(required=True)
    role.add_argument("--coordinator", action="store_true")
    role.add_argument("--worker", action="store_true")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral, printed on start)")
    p.add_argument("--catalog", action="append", default=[],
                   help="catalog spec, repeatable (see module docstring)")
    p.add_argument("--coordinator-url", default=None,
                   help="(worker) coordinator to announce to")
    p.add_argument("--node-id", default=None, help="(worker) node id")
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--secret", default=None,
                   help="shared cluster secret for task endpoints")
    p.add_argument("--batch-rows", type=int, default=1 << 17)
    p.add_argument("--run-slots", type=int, default=4,
                   help="(worker) fair-executor run slots per worker")
    p.add_argument("--memory-pool-bytes", type=int, default=None)
    p.add_argument("--spill-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device the node runs on (default cuda; a "
                        "node without one refuses to start)")
    p.add_argument("--timeout-s", type=float, default=30.0,
                   help="timeout of each HTTP call between the nodes")
    p.add_argument("--query-event-log", default=None,
                   help="(coordinator) append query-completion events as "
                        "JSON lines to this file (EventListener analog)")
    args = p.parse_args(argv)

    from presto_tpu_torch import default_device

    # "cuda" resolves like an entry point's default: it raises when there
    # is no CUDA device
    device = default_device(None if args.device == "cuda" else args.device)
    catalog = build_catalog(args.catalog)

    if args.coordinator:
        from presto_tpu_torch.exec.runtime import ExecConfig
        from presto_tpu_torch.server.coordinator import Coordinator

        coord = Coordinator(
            catalog, port=args.port,
            config=ExecConfig(batch_rows=args.batch_rows,
                              memory_pool_bytes=args.memory_pool_bytes,
                              spill_dir=args.spill_dir),
            min_workers=args.min_workers,
            cluster_secret=args.secret, device=device,
            timeout_s=args.timeout_s,
            query_event_log=args.query_event_log,
        )
        print(f"coordinator listening on {coord.url}", flush=True)
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        try:
            while not stop:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        coord.close()
        return 0

    import os
    import socket

    from presto_tpu_torch.server.worker import Worker

    # default id must be unique per process — the requested port is 0
    # (ephemeral) by default and NodeManager keys announcements by node_id
    node_id = args.node_id or (
        f"worker-{socket.gethostname()}-{os.getpid()}")
    w = Worker(
        catalog, node_id=node_id, port=args.port,
        coordinator_url=args.coordinator_url,
        memory_pool_bytes=args.memory_pool_bytes,
        spill_dir=args.spill_dir,
        cluster_secret=args.secret,
        run_slots=args.run_slots,
        device=device, timeout_s=args.timeout_s,
    )
    print(f"worker {node_id} listening on {w.url}"
          + (f", announcing to {args.coordinator_url}"
             if args.coordinator_url else ""), flush=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop and w.node_state != "shut_down":
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    w.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
