"""Session + system session properties.

Analog of presto-main's Session.java + SystemSessionProperties.java (1,099
lines of typed PropertyMetadata definitions: join_distribution_type:59,
grouped_execution_*:66-69, pushdown_subfields_enabled:132, ...). A Session
carries the per-query identity, catalog/schema defaults, and a bag of typed
property overrides; `exec_config()` lowers the system properties into the
engine's ExecConfig the way Presto lowers them into TaskManagerConfig /
FeaturesConfig-derived per-query settings.

The JAX package's server/session.py: the same property names, types,
defaults and checks. A property whose feature the port does not have yet
(`MISSING`: the compile plane, adaptive execution, the cluster services)
is listed like the others but refuses any value with a
SessionPropertyError naming the ROADMAP item that brings it; `hbo`
refuses only `correct`, the history-corrected optimizer.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

from presto_tpu_torch.exec.runtime import ExecConfig


class SessionPropertyError(ValueError):
    pass


_ITEM_12 = "program caching, adaptive execution and HBO (ROADMAP item 12)"
_ITEM_17 = "the cluster services (ROADMAP item 17)"
# property -> what the port lacks for it
MISSING: Dict[str, str] = {
    "join_out_capacity": "a join output chunk other than the probe "
                         "batch's capacity",
    "donate_stepping": _ITEM_12, "precompile_workers": _ITEM_12,
    "max_compiled_shapes_scan": _ITEM_12,
    "max_compiled_shapes_breaker": _ITEM_12, "fragment_fusion": _ITEM_12,
    "fragment_window": _ITEM_12,
    "shape_bucketing": _ITEM_12, "compile_farm": _ITEM_12,
    "adaptive": _ITEM_12,
    "query_priority": _ITEM_17, "result_cache": _ITEM_17,
}


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    """Typed session property (reference: spi/session/PropertyMetadata)."""

    name: str
    description: str
    py_type: type
    default: Any
    hidden: bool = False
    decoder: Optional[Callable[[str], Any]] = None
    validator: Optional[Callable[[Any], None]] = None

    def decode(self, raw: Any) -> Any:
        if self.name in MISSING:
            raise SessionPropertyError(
                f"{self.name}: not supported by presto_tpu_torch yet — "
                f"needs {MISSING[self.name]}")
        if isinstance(raw, str) and self.py_type is not str:
            if self.decoder is not None:
                v = self.decoder(raw)
            elif self.py_type is bool:
                low = raw.strip().lower()
                if low not in ("true", "false"):
                    raise SessionPropertyError(
                        f"{self.name}: expected boolean, got {raw!r}"
                    )
                v = low == "true"
            elif self.py_type is int:
                try:
                    v = int(raw.strip())
                except ValueError:
                    raise SessionPropertyError(
                        f"{self.name}: expected integer, got {raw!r}"
                    )
            elif self.py_type is float:
                try:
                    v = float(raw.strip())
                except ValueError:
                    raise SessionPropertyError(
                        f"{self.name}: expected number, got {raw!r}"
                    )
            else:
                v = raw
        else:
            v = raw
            if self.py_type is float and isinstance(v, int):
                v = float(v)
            if not isinstance(v, self.py_type) and v is not None:
                raise SessionPropertyError(
                    f"{self.name}: expected {self.py_type.__name__}, got {type(v).__name__}"
                )
        if self.validator is not None:
            self.validator(v)
        return v


def _enum(name: str, allowed: List[str]) -> Callable[[Any], None]:
    def check(v):
        if v is not None and v.upper() not in allowed:
            raise SessionPropertyError(f"{name}: must be one of {allowed}, got {v!r}")

    return check


def _hbo(v) -> None:
    """The JAX package's hbo values; `correct` feeds history back into
    the optimizer, which the port does not have yet."""
    _enum("hbo", ["OFF", "OBSERVE", "CORRECT"])(v)
    if v is not None and v.upper() == "CORRECT":
        raise SessionPropertyError(
            "hbo: correct is not supported by presto_tpu_torch yet — "
            f"needs {_ITEM_12}")


def _objectives(name: str) -> Callable[[Any], None]:
    def check(v):
        if not v:
            return
        from presto_tpu_torch.obs.lifecycle import parse_objectives
        try:
            parse_objectives(v)
        except ValueError as e:
            raise SessionPropertyError(f"{name}: {e}")

    return check


def _positive(name: str) -> Callable[[Any], None]:
    def check(v):
        if v is not None and v <= 0:
            raise SessionPropertyError(f"{name}: must be positive, got {v}")

    return check


def _nonneg(name: str) -> Callable[[Any], None]:
    def check(v):
        if v is not None and v < 0:
            raise SessionPropertyError(
                f"{name}: must be non-negative, got {v}")

    return check


def _pow2_or_off(name: str) -> Callable[[Any], None]:
    def check(v):
        if v is None or v in (0, 1):
            return
        if v < 0 or v & (v - 1):
            raise SessionPropertyError(
                f"{name}: must be a power of two (or 0/1 to disable), "
                f"got {v}")

    return check


class SystemSessionProperties:
    """The engine's per-query flag registry (SystemSessionProperties.java)."""

    def __init__(self):
        self._props: Dict[str, PropertyMetadata] = {}
        for p in self._defaults():
            self._props[p.name] = p

    @staticmethod
    def _defaults() -> List[PropertyMetadata]:
        return [
            # engine execution shape (reference: TaskManagerConfig + task_concurrency)
            PropertyMetadata("batch_rows", "Rows per scan batch", int, 1 << 17,
                             validator=_positive("batch_rows")),
            PropertyMetadata("agg_capacity", "Initial group-table capacity", int, 1 << 12,
                             validator=_positive("agg_capacity")),
            PropertyMetadata("join_out_capacity",
                             "Join output chunk capacity (default: probe batch)",
                             int, None),
            PropertyMetadata("max_growth_retries",
                             "Max geometric capacity growth retries", int, 24),
            PropertyMetadata("collect_stats",
                             "Per-operator stats (EXPLAIN ANALYZE)", bool, False),
            PropertyMetadata("tracing",
                             "Record query-lifecycle spans "
                             "(/v1/query/{id}/trace)", bool, True),
            PropertyMetadata("scan_prefetch",
                             "Background split-prefetch depth (0 disables)",
                             int, 2),
            PropertyMetadata("query_retry_count",
                             "Query-level retries on worker loss", int, 1),
            # distribution (reference: join_distribution_type:59, hash_partition_count)
            PropertyMetadata("join_distribution_type",
                             "AUTOMATIC | PARTITIONED | BROADCAST", str, "AUTOMATIC",
                             validator=_enum("join_distribution_type",
                                             ["AUTOMATIC", "PARTITIONED", "BROADCAST"])),
            PropertyMetadata("hash_partition_count",
                             "Default partitions for hash exchanges", int, 8,
                             validator=_positive("hash_partition_count")),
            PropertyMetadata("redistribute_writes", "Redistribute before write",
                             bool, True),
            # resource limits (reference: query_max_memory, query_max_run_time)
            PropertyMetadata("query_max_memory_mb",
                             "Per-query device memory limit (MB)", int, 16384),
            PropertyMetadata("query_max_run_time_s",
                             "Wall-clock limit per query (s)", float, 3600.0),
            PropertyMetadata("query_priority", "Priority within resource group",
                             int, 1),
            # spill (reference: spill_enabled / MemoryRevokingScheduler thresholds)
            PropertyMetadata("spill_enabled", "Allow spilling to host", bool, True),
            PropertyMetadata("memory_revoking_threshold",
                             "Pool fraction that triggers revocation", float, 0.9),
            PropertyMetadata("memory_revoking_target",
                             "Pool fraction revocation aims for", float, 0.5),
            # dynamic hybrid hash spill (spiller.py recursive repartitioning)
            PropertyMetadata("spill_max_depth",
                             "Recursive-repartition depth bound for spilled "
                             "hybrid hash joins/aggregations",
                             int, 4, validator=_positive("spill_max_depth")),
            PropertyMetadata("spill_dir_budget_mb",
                             "Live-byte budget for the worker spill "
                             "directory (0 = unbounded)",
                             int, 0, validator=_nonneg("spill_dir_budget_mb")),
            # planner
            PropertyMetadata("optimize_plan", "Run optimizer passes", bool, True),
            PropertyMetadata("execution_policy", "all-at-once | phased", str,
                             "all-at-once"),
            # SystemSessionProperties.java:69
            PropertyMetadata("recoverable_grouped_execution",
                             "Re-run only lost lifespans of colocated joins",
                             bool, False),
            # scheduler/NodeScheduler soft-affinity placement
            PropertyMetadata("split_affinity",
                             "Rendezvous-hash split→worker placement",
                             bool, True),
            # radix-partitioned pipeline breakers
            PropertyMetadata("radix_partitions",
                             "Within-worker radix fanout at joins and "
                             "group-bys (power of two; 0/1 disables)",
                             int, 0, validator=_pow2_or_off("radix_partitions")),
            PropertyMetadata("join_spill_budget_bytes",
                             "Per-partition device-byte budget beyond which "
                             "a radix partition spills to host (0 = never)",
                             int, 0, validator=_nonneg("join_spill_budget_bytes")),
            # compile plane (exec/programs.py)
            PropertyMetadata("donate_stepping",
                             "Donate accumulator buffers on linearly-"
                             "threaded stepping programs", bool, True),
            PropertyMetadata("precompile_workers",
                             "Ahead-of-stream precompile thread count "
                             "(0 disables)", int, 0,
                             validator=_nonneg("precompile_workers")),
            PropertyMetadata("max_compiled_shapes_scan",
                             "Compiled-shape budget override for scan-class "
                             "nodes (0 = inherit global)", int, 0,
                             validator=_nonneg("max_compiled_shapes_scan")),
            PropertyMetadata("max_compiled_shapes_breaker",
                             "Compiled-shape budget override for breaker-"
                             "class nodes (0 = inherit global)", int, 0,
                             validator=_nonneg("max_compiled_shapes_breaker")),
            PropertyMetadata("fragment_fusion",
                             "Fold eligible leaf fragments into one fused "
                             "lax.scan program per batch window", bool, True),
            PropertyMetadata("fragment_window",
                             "Max batches stacked per fused fragment "
                             "dispatch", int, 8,
                             validator=_positive("fragment_window")),
            PropertyMetadata("breaker_engine",
                             "Keyed-agg/join breaker engine: auto lets the "
                             "CBO pick per breaker from derived stats; "
                             "sort/hash force one engine", str, "auto",
                             validator=_enum("breaker_engine",
                                             ["AUTO", "SORT", "HASH"])),
            PropertyMetadata("join_mode",
                             "Star-schema join chain collapse: auto lets the "
                             "CBO fold eligible inner/left equi-join chains "
                             "into one multiway probe program from HBO-"
                             "corrected build sizes and selectivities; "
                             "multiway forces every eligible chain; binary "
                             "declines but stamps the verdict in EXPLAIN; "
                             "off skips the pass (pre-collapse plan "
                             "bit-for-bit)", str, "auto",
                             validator=_enum("join_mode",
                                             ["AUTO", "MULTIWAY", "BINARY",
                                              "OFF"])),
            PropertyMetadata("hbo",
                             "History-based optimization: off disables even "
                             "observation (pre-HBO behavior bit-for-bit); "
                             "observe records estimate-vs-actual drift keyed "
                             "on structural fingerprints; correct also feeds "
                             "observed values back into the CBO on a repeat "
                             "of the same structure", str, "observe",
                             validator=_hbo),
            # device memory accounting plane (obs/devprof.py)
            PropertyMetadata("devprof",
                             "Device memory accounting: off reproduces "
                             "pre-devprof behavior bit-for-bit; on samples "
                             "the card's allocator watermark and reconciles "
                             "it against the memory-pool ledger",
                             str, "OFF",
                             validator=_enum("devprof", ["OFF", "ON"])),
            PropertyMetadata("profile",
                             "Capture a torch.profiler Chrome trace per "
                             "query under PRESTO_TPU_CACHE_DIR (profileUri "
                             "in the statement response; no-op with a "
                             "warning when the cache dir is unavailable)",
                             bool, False),
            # serving-plane SLO telemetry (obs/lifecycle.py)
            PropertyMetadata("lifecycle",
                             "Query lifecycle timeline + live progress + "
                             "cluster events: off reproduces the pre-"
                             "lifecycle serving path bit-for-bit (no "
                             "timeline, no progressUri, no new metric "
                             "families); on decomposes e2e wall into "
                             "queue/plan/compile/exec/drain segments and "
                             "feeds the per-group SLO histograms",
                             str, "on",
                             validator=_enum("lifecycle", ["OFF", "ON"])),
            PropertyMetadata("slo_objectives",
                             "Comma list of segment=seconds latency "
                             "objectives (segments: queue_wait, plan, "
                             "compile, exec, drain, e2e); a completed query "
                             "whose segment exceeds its bound increments "
                             "presto_tpu_slo_violations_total{group,segment}",
                             str, "", validator=_objectives("slo_objectives")),
            PropertyMetadata("latency_regression_factor",
                             "Flag a completed query as a latency regression "
                             "when its e2e wall is at least this many times "
                             "the fingerprint's HBO baseline wall (0 "
                             "disables)", float, 3.0,
                             validator=_nonneg("latency_regression_factor")),
            # semantic result cache (server/result_cache.py)
            PropertyMetadata("result_cache",
                             "Fingerprint-keyed result reuse: off "
                             "reproduces the pre-cache serving path "
                             "bit-for-bit (no consult, no metric families, "
                             "no events); query memoizes final results "
                             "keyed on structural plan sha + catalog "
                             "snapshot token; subplan additionally reuses "
                             "materialized breaker-subplan results",
                             str, "off",
                             validator=_enum("result_cache",
                                             ["OFF", "QUERY", "SUBPLAN"])),
            # compile farm (exec/farm.py)
            PropertyMetadata("shape_bucketing",
                             "pow2 pads merging-output flushes and partial "
                             "jit windows up to their power-of-two bucket so "
                             "each stream compiles one shape instead of a "
                             "per-flush ladder (results identical — padding "
                             "is dead lanes); off reproduces today's shapes "
                             "bit-for-bit", str, "off",
                             validator=_enum("shape_bucketing",
                                             ["OFF", "POW2"])),
            PropertyMetadata("compile_farm",
                             "on records installed plans into the persistent "
                             "farm corpus under PRESTO_TPU_CACHE_DIR and "
                             "arms queue-wait speculative precompile; off "
                             "is a strict no-op (no corpus IO, no claims, "
                             "no metric families)", str, "off",
                             validator=_enum("compile_farm", ["OFF", "ON"])),
            # mid-flight telemetry plane (obs/inflight.py)
            PropertyMetadata("inflight",
                             "Live operator telemetry: off reproduces the "
                             "pre-inflight serving path bit-for-bit (no "
                             "publishes, no watcher thread, no metric "
                             "families); on makes drivers publish operator "
                             "watermarks at window boundaries, arms the "
                             "stall/straggler watcher, and enables "
                             "/v1/query/{id}/inflight and /doctor", str,
                             "off", validator=_enum("inflight",
                                                    ["OFF", "ON"])),
            # in-run adaptation layer (exec/adaptive.py)
            PropertyMetadata("adaptive",
                             "In-run adaptation: off reproduces the "
                             "pre-adaptive engine bit-for-bit (no "
                             "decisions, no events, no metric families); "
                             "observe evaluates every decision point and "
                             "logs what it would do without acting; on "
                             "acts — engine flips between replay waves, "
                             "forward-propagating presize/lane sizing, "
                             "device-radix partition growth, "
                             "largest-partition-first partial revocation",
                             str, "off",
                             validator=_enum("adaptive",
                                             ["OFF", "OBSERVE", "ON"])),
            PropertyMetadata("stall_threshold_s",
                             "Stall detector bound: row watermarks frozen "
                             "this many seconds while the query executes "
                             "fires stall_detected plus a forensics dump",
                             float, 2.0,
                             validator=_positive("stall_threshold_s")),
            PropertyMetadata("straggler_factor",
                             "Straggler detector bound: a fragment site "
                             "this many times behind its siblings' window "
                             "watermark fires straggler_detected", float,
                             4.0, validator=_positive("straggler_factor")),
        ]

    def names(self) -> List[str]:
        return sorted(self._props)

    def metadata(self, name: str) -> PropertyMetadata:
        if name not in self._props:
            raise SessionPropertyError(f"unknown session property: {name}")
        return self._props[name]

    def default(self, name: str) -> Any:
        return self.metadata(name).default

    def decode(self, name: str, raw: Any) -> Any:
        return self.metadata(name).decode(raw)

    def register(self, prop: PropertyMetadata):
        self._props[prop.name] = prop


SYSTEM_PROPERTIES = SystemSessionProperties()

_query_counter = itertools.count(1)


def new_query_id() -> str:
    """Presto query ids look like 20190101_000000_00000_abcde; ours carry a
    date bucket + counter (reference: QueryIdGenerator)."""
    n = next(_query_counter)
    return f"{time.strftime('%Y%m%d_%H%M%S')}_{n:05d}"


@dataclasses.dataclass
class Session:
    """Per-query session (reference: Session.java — identity, defaults,
    property overrides, start time)."""

    user: str = "user"
    source: str = ""
    catalog: Optional[str] = None
    schema: Optional[str] = None
    query_id: str = ""
    start_time: float = 0.0
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # catalog_name -> {prop: value} (reference: per-connector session props)
    connector_properties: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    resource_group: Optional[str] = None

    def __post_init__(self):
        if not self.query_id:
            self.query_id = new_query_id()
        if not self.start_time:
            self.start_time = time.time()

    def get(self, name: str) -> Any:
        if name in self.properties:
            return self.properties[name]
        return SYSTEM_PROPERTIES.default(name)

    def set(self, name: str, raw: Any):
        self.properties[name] = SYSTEM_PROPERTIES.decode(name, raw)

    def unset(self, name: str):
        SYSTEM_PROPERTIES.metadata(name)  # validate the name
        self.properties.pop(name, None)

    def child(self) -> "Session":
        """A fresh query-scoped session inheriting this session's overrides
        (the client session persists across queries; each query gets its own
        id/start time)."""
        return Session(
            user=self.user,
            source=self.source,
            catalog=self.catalog,
            schema=self.schema,
            properties=dict(self.properties),
            connector_properties={k: dict(v) for k, v in self.connector_properties.items()},
            resource_group=self.resource_group,
        )

    def exec_config(self) -> ExecConfig:
        """The engine's config from the properties the port has (the
        others refuse every value, so they stay at their defaults)."""
        qmax = self.get("query_max_memory_mb")
        return ExecConfig(
            batch_rows=self.get("batch_rows"),
            agg_capacity=self.get("agg_capacity"),
            max_growth_retries=self.get("max_growth_retries"),
            memory_pool_bytes=(qmax * (1 << 20)) if qmax else None,
            spill_enabled=self.get("spill_enabled"),
            memory_revoking_threshold=self.get("memory_revoking_threshold"),
            memory_revoking_target=self.get("memory_revoking_target"),
            scan_prefetch=self.get("scan_prefetch"),
            query_retry_count=self.get("query_retry_count"),
            execution_policy=self.get("execution_policy"),
            recoverable_grouped_execution=self.get(
                "recoverable_grouped_execution"),
            split_affinity=self.get("split_affinity"),
            radix_partitions=self.get("radix_partitions"),
            join_spill_budget_bytes=(self.get("join_spill_budget_bytes")
                                     or None),
            spill_max_depth=self.get("spill_max_depth"),
            spill_dir_budget_bytes=(
                self.get("spill_dir_budget_mb") * (1 << 20)
                if self.get("spill_dir_budget_mb") else None),
            breaker_engine=self.get("breaker_engine").lower(),
            join_mode=self.get("join_mode").lower(),
            collect_stats=self.get("collect_stats"),
            tracing=self.get("tracing"),
            hbo=self.get("hbo").lower(),
            devprof=self.get("devprof").lower(),
            profile=self.get("profile"),
            lifecycle=self.get("lifecycle").lower(),
            inflight=self.get("inflight").lower(),
            stall_threshold_s=self.get("stall_threshold_s"),
            straggler_factor=self.get("straggler_factor"),
        )
