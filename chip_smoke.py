#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Build: print the card's name and power limit, build the CUDA kernels
   from presto_tpu_torch/csrc (one nvcc per source, all at once).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   on synthetic inputs at the main path's widths (the serial plain versions
   of the three hash kernels bound those cases to 65,536 rows), and the two
   inserts' partitioned path forced on small tables: chains across range
   ends, chains that wrap from the last slot to slot 0, all rows on one
   slot, more distinct keys than cap. The insert checks are torch on the
   card (group_invariants, join_invariants) and, on these cases, also the
   serial plain versions.
3. Query phase: LocalRunner on CUDA over TPC-H SF 1 runs Q1, Q6 and Q3
   under breaker_engine=auto and Q3 under breaker_engine=hash; each result
   must equal a numpy oracle computed on the unscaled integers. The same
   four at SF 0.01 must give identical frames on the card and on the CPU.
   Launch counts are reset just before and read just after the SF 1 runs;
   every kernel must have launched.
   Then the 22 TPC-H queries (presto_tpu_torch/catalog/tpch_queries.py) at
   SF 1 under breaker_engine=auto and hash: the two engines must give the
   same frame (row for row where ORDER BY fixes the order; where it ties,
   the ordering columns row for row and the rows as a multiset), and Q1,
   Q3, Q4, Q6, Q13, Q18 and Q21 must equal numpy/pandas oracles. Each
   query's launch counts are reset just before its first run and read
   just after; Q18 under hash must launch join_insert and join_probe (its
   SemiJoin) and group_insert (its GROUP BY l_orderkey). Each prints its
   warm median of 3, lineitem rows/s and the device time of one more run
   (torch.profiler); Q17, Q18 and Q20 only their first run (the memory
   phase times Q18 in the same config). Every query must return rows (Q11 with TPC-H's
   FRACTION = 0.0001 / SF). One more run of each query under hash records
   each kernel's largest input, which is launched again and held to its
   contract (grouped_sums against its plain version, the others by their
   invariants). At SF 0.01 the 44 runs must give the same frames on the
   card as on the CPU.
   Then the SQL surface beyond TPC-H and TPC-DS (`phase_surface`) on the
   same SF 1 catalog, with a fresh memory catalog as the statements'
   target: string functions over customer and part, a string range, a
   compare of two string columns across lineitem ⋈ orders, casts to
   varchar (HostProject over 133,104 orders) and from it, SELECT without
   FROM, approx_distinct/geometric_mean/checksum over lineitem, and CTAS
   of 1.5 M groups, INSERT, DELETE, a view read back and the drops, under
   auto and hash, each against a numpy/pandas oracle (approx_distinct
   within 5 % of the exact count); launches, warm median of 3 and device
   time of each; each kernel's largest input of the phase held to its
   contract; the same at SF 0.01 on the card against the CPU.
   Then index joins, ARRAY/MAP values, lambdas, the built aggregates and
   geometry (`phase_structural`) on the same SF 1 catalog plus three
   memory catalogs: Q6's lineitem rows joined through an index on orders
   (inner, and LEFT to the orders of 1994), array_agg per customer stored
   by CTAS and read back through the array functions and lambdas, its
   UNNEST WITH ORDINALITY, map_agg per order with the map functions and
   an UNNEST of the maps, map_agg of the return flags per order stored by
   CTAS (the stored arrays and maps compared element by element with the
   generated tables), approx_set/tdigest_agg/numeric_histogram per
   (returnflag, linestatus) and merge of per-month sets stored by CTAS,
   and a spatial join of 1,000,000 points and 64 polygons with distance
   sums; under auto and hash, each against a numpy/pandas oracle
   (approx_set within 5 %, the t-digest median at a rank within 0.02 of
   0.5, the histogram by its invariants); under hash the index joins must launch join_insert
   and join_probe; launches, warm median of 3 and device time of each;
   each kernel's largest input of the phase held to its contract; the
   same at SF 0.01 on the card against the CPU.
   Then memory-bounded execution (`phase_memory`) on the same SF 1
   catalog, spilling into a `.spill-*` directory under the checkout that
   must be empty after every run and is removed at the end: Q18 and Q13
   under the default config take GRACE (their aggregates' presize passes
   agg_cap_ceiling) and equal their spill-off runs and oracles, both
   walls printed; Q3 and Q18's inner aggregate under a pool of half Q3's
   largest build spill (Q3's spilled build repartitions) and equal their
   default runs and oracles, and the same pool with spill off raises
   ExceededMemoryLimit; Q3, Q5 and Q18 with 8 radix partitions and Q3
   with every partition spilled (Q9 with 8 and Q18 spilled at SF 0.01
   only) equal their default runs; Q2,
   Q3, Q5, Q7, Q8, Q9, Q10 and a customer-orders fanout chain under
   join_mode=multiway equal their binary runs (the fanout leg's
   join_probe ladder under hash, the binary cascade under auto), then a
   join_probe case at the largest F the ladder reached; the first runs
   profiled, warm medians of 3 under hash (and both engines for GRACE);
   the largest inputs held to their contracts; the configurations at SF
   0.01 on the card against the CPU. The 22-query and TPC-DS lines say
   whether a query took GRACE (`grace`).
   Then TPC-DS (`phase_tpcds`): the 44 queries of
   presto_tpu_torch/catalog/tpcds_queries.py at SF 1 under auto and hash
   (engines agree; nine numpy/pandas oracles; every query returns rows;
   q37 and ds_q47 only their first runs;
   each of the four kernels launches under hash; each kernel's largest
   input held to its contract), INTERSECT ALL at SF 1 against its oracle,
   and the 88 runs at SF 0.01 on the card against the CPU.
   Before TPC-DS, the cluster (`phase_cluster`) on the same SF 1 catalog:
   DistributedRunner (a coordinator and two workers in this process over
   localhost HTTP, all on the card) runs Q1, Q6, Q3 and Q18 under auto and
   hash, and Q3 and Q18 with every join partitioned under hash, each
   equal to the LocalRunner's frame and the oracle (first run,
   launches, exchange bytes; but for Q18 warm median of 3 and busy
   share); Q18 under hash
   must launch join_insert, join_probe and group_insert, Q1 grouped_sums;
   the 22 queries at SF 0.01 through a cluster on the card against one on
   the CPU; and `python -m presto_tpu_torch.server` started as a
   coordinator and a worker process on the card, answering through the
   port's dbapi as the in-process cluster does.
4. Timing phase: each kernel on the largest inputs its launcher saw in
   the query phase, three CUDA-event times: the kernel alone (the bare
   C launch, its memsets included, on outputs allocated once, events
   around each launch after a spin kernel), warm and — where its inputs
   and outputs fit under the 50 MB L2 — cold, with the L2 flushed before
   each launch by a 128 MB write and a 128 MB read; the launcher (the
   kernel plus its outputs' allocation); the public wrapper. Beside them
   the plain version's time and result, the bound (bytes of the distinct
   inputs read once and outputs written once, over 3.35 TB/s; of
   join_probe's table only the slots and keys its walks reach,
   `probe_bytes`), which the cold time must not beat, and for grouped_sums
   one `index_add_` call.
   Then group_insert and join_insert at large shapes built on the card
   (Q18's GROUP BY l_orderkey at SF 1 in one call, twice: cap 2^21 and,
   overflowing, 2^20; the merge steps LocalRunner's aggregate gives it for
   that query, at caps 2^19 to 2^21: the previous group table, then a scan
   batch; Q3's orders build side at SF 10), checked by their invariants
   and timed the same way, cold and warm; their serial plain versions are
   not run there. Last, each kernel on the 22-query phase's inputs (per
   kernel the largest of the 22 queries under hash, and join_insert's and
   join_probe's in the queries with a hash SemiJoin), timed the same way.
5. Last, the observability plane (`phase_obs`) on the SF 1 TPC-H
   catalog, after every other phase's timing (its profile capture with
   CPU activity, its devprof sampler and its cluster come after them):
   EXPLAIN ANALYZE of Q1 (auto) and Q3 and Q18 (hash) on the card, whose
   top operator's rows equal the result's (and the result its oracle),
   whose keyed Aggregates and HashJoins show HBO's est/actual/drift
   unless they spilled, and whose runs launch all four kernels; Q3 and
   Q18 under hash with tracing off and on (warm median of 3 and busy
   share each, the tracer's cost); the cluster's stitched
   trace (query, stage, task, operator), EXPLAIN ANALYZE over
   /v1/statement, /v1/metrics clean under the port's linter, /v1/events
   and /progress; a devprof=on run (the allocator's peak above 0 and
   below the card's memory, the reconcile ratio); a profile=true
   statement whose Chrome trace lands under a temporary
   PRESTO_TPU_CACHE_DIR.

Prints a `tpch22` JSON line (each query and engine: rows, warm median,
first run, lineitem rows/s, launches, device time), a `surface` JSON line
(each statement and engine: rows, warm median, launches, device time and
busy share), a `structural` JSON line (the same for the structural
phase), a `memory` JSON line (each unit, run and engine: rows, warm
median, first run, launches, busy share, the spill counters), a `scan`
and a `cluster` JSON line (each query, engine and join distribution:
rows, first run, warm median, exchange bytes, launches, busy share), a
`tpcds` JSON line
(the same with store_sales rows/s, and INTERSECT ALL's), an `obs` JSON
line (EXPLAIN ANALYZE launches, tracing off/on walls and busy shares, the
trace's levels, the devprof peak and ratio), a `kernels` JSON
line (with each kernel's launches on the TPC-DS path and in the
structural, memory, scan and cluster phases' first runs under hash, and
in the observability phase's EXPLAIN ANALYZE runs)
(`ms` is the cold kernel-alone time where one was taken; `large` holds the
large shapes, `ms` cold and `ms_warm`), the run's duration, then as its
last line
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit,
no ok line). Exits non-zero at once without CUDA or without the package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
L2_BYTES = 50_000_000  # H100 L2; smaller kernels are also timed cold
FLUSH_BYTES = 128 * 2**20  # one write of this much evicts the L2
SPIN_CYCLES = 100_000  # spin kernel before a timed launch (~50 µs)
SF = 1.0
SMALL_SF = 0.01
HASH_CHECK_ROWS = 65536  # serial plain versions bound the synthetic cases
REPLACES = {
    "grouped_sums": "presto_tpu/ops/pallas_groupby.py:82",
    "group_insert": "presto_tpu/ops/pallas_hash.py:205",
    "join_insert": "presto_tpu/ops/pallas_hash.py:262",
    "join_probe": "presto_tpu/ops/pallas_hash.py:331",
}
SOURCES = {
    "grouped_sums": "presto_tpu_torch/csrc/grouped_sums.cu",
    "group_insert": "presto_tpu_torch/csrc/hash_table.cu",
    "join_insert": "presto_tpu_torch/csrc/hash_table.cu",
    "join_probe": "presto_tpu_torch/csrc/hash_table.cu",
}

QUERIES = {
    "q1": """
        select l_returnflag, l_linestatus,
               sum(l_quantity) as sum_qty,
               sum(l_extendedprice) as sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
               avg(l_quantity) as avg_qty,
               avg(l_extendedprice) as avg_price,
               avg(l_discount) as avg_disc,
               count(*) as count_order
        from lineitem
        where l_shipdate <= date '1998-12-01' - interval '90' day
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus
        """,
    "q6": """
        select sum(l_extendedprice * l_discount) as revenue
        from lineitem
        where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
          and l_discount between 0.05 and 0.07 and l_quantity < 24
        """,
    "q3": """
        select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
               o_orderdate, o_shippriority
        from customer, orders, lineitem
        where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
          and l_orderkey = o_orderkey
          and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
        group by l_orderkey, o_orderdate, o_shippriority
        order by revenue desc, o_orderdate
        limit 10
        """,
}
# (label, query, breaker_engine)
RUNS = [("q1", "q1", "auto"), ("q6", "q6", "auto"), ("q3", "q3", "auto"),
        ("q3_hash", "q3", "hash")]


class CheckFailed(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# ---------------------------------------------------------------------------
# phase 1: card and build


def phase_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from presto_tpu_torch.kernels._build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(sorted(logs))}")
    for name, log in sorted(logs.items()):
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                # the kernel's name and template argument, out of the
                # mangled name
                m = re.search(r"(grouped_sums_(?:small|large)|[a-z_]+_kernel)"
                              r"(?:ILi(\d+)E)?", line)
                fn = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                      if m else "")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {fn}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def q1_state_ops():
    """(sums, counts) of Q1's aggregate state layout: each sum (limb) goes
    to grouped_sums with its valid count, each count alone."""
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.plan.agg_states import agg_state_layout
    from presto_tpu_torch.plan.builder import plan_query
    from presto_tpu_torch.plan.nodes import Aggregate
    from presto_tpu_torch.plan.optimizer import optimize

    cat = tpch_catalog(SMALL_SF)
    qp = optimize(plan_query(QUERIES["q1"], cat), cat)
    node = qp.root
    while not isinstance(node, Aggregate):
        node = node.children()[0]
    layout = agg_state_layout(node.aggs, dict(node.child.output))
    counts = sum(op == "count_add" for _, op, _ in layout)
    return len(layout) - counts, counts


def check_grouped_sums(torch, gid, states, n_groups):
    from presto_tpu_torch.ops import groupby_kernels as gk

    got = torch.stack(gk.grouped_sums(gid, list(states), n_groups))
    want = gk.grouped_sums_plain(gid, states, n_groups)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    require(torch.equal(got, want),
            f"grouped_sums differs from its plain version (G={n_groups})")
    return err


# (dtype, low, high) of each element kind grouped_sums takes
STATE_KINDS = (("bool", 0, 1), ("uint8", 0, 255), ("int8", -128, 127),
               ("int16", -2**15, 2**15 - 1), ("int32", -2**31, 2**31 - 1),
               ("int64", -2**63, 2**63 - 1))


def synthetic_states(torch, rng, n, layout, dev, offset=0):
    """States for grouped_sums: `layout` lists (dtype name, masked) per
    state, or ("mask", j) for the mask of state j itself (as the aggregate
    passes each sum's validity as its count). `offset` > 0 makes every
    tensor a view that starts `offset` elements into its storage."""
    import numpy as np

    bounds = {name: (lo, hi) for name, lo, hi in STATE_KINDS}
    out = []
    for kind, arg in layout:
        if kind == "mask":
            out.append(out[arg][1])
            continue
        lo, hi = bounds[kind]
        v = rng.integers(lo, hi, n + offset, dtype=np.int64, endpoint=True)
        t = torch.from_numpy(v).to(dev).to(getattr(torch, kind))[offset:]
        if arg:
            m = torch.from_numpy(rng.random(n + offset) < 0.7).to(dev)
            out.append((t, m[offset:]))
        else:
            out.append(t)
    return out


def q1_state_layout():
    """The states Q1's aggregate hands grouped_sums in a merge: the live
    flags, each sum masked by its validity, each sum's validity as its
    count, and the counts (int64)."""
    sums, counts = q1_state_ops()
    return ([("bool", False)] + [("int64", True)] * sums
            + [("mask", 1 + j) for j in range(sums)]
            + [("int64", False)] * counts)


def grouped_sums_cases():
    """(label, rows, groups, layout, every row dead, view offset)."""
    q1 = q1_state_layout()
    kinds = [(name, j % 2 == 1) for j, (name, _, _) in
             enumerate(STATE_KINDS + STATE_KINDS)]
    many = [(STATE_KINDS[j % 6][0], j % 3 == 0) for j in range(70)]
    ragged = (1 << 17) + 77  # not a multiple of any row tile or vector
    return [("Q1 layout", ragged, 6, q1, False, 0),
            ("Q1 layout", ragged, 512, q1, False, 0),
            ("every width, masked and not", 65536 + 5, 6, kinds, False, 0),
            ("every width, masked and not", 65536 + 5, 40, kinds, False, 0),
            ("70 states (two launches)", 40000 + 3, 6, many, False, 0),
            ("70 states (two launches)", 40000 + 3, 512, many, False, 0),
            ("unaligned views", 50000, 16, kinds, False, 1),
            ("unaligned views", 50000, 100, kinds, False, 1),
            ("every row dead", 30000, 6, kinds, True, 0),
            ("every row dead", 30000, 512, kinds, True, 0),
            ("few rows", 100, 3, kinds, False, 0)]


def _distinct(torch, rows):
    """Distinct rows of a [m, K] tensor."""
    if rows.shape[0] == 0:
        return 0
    if rows.shape[1] == 1:
        return torch.unique(rows[:, 0]).numel()
    return torch.unique(rows, dim=0).shape[0]


def _any_shared(torch, a, b):
    """Whether a row of b [m, K] is also a row of a [m', K]."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return False
    if a.shape[1] == 1:
        return bool(torch.isin(b[:, 0], a[:, 0]).any())
    _, inv = torch.unique(torch.cat([a, b]), dim=0, return_inverse=True)
    in_a = torch.zeros(int(inv.max()) + 1, dtype=torch.bool, device=a.device)
    in_a[inv[:a.shape[0]]] = True
    return bool(in_a[inv[a.shape[0]:]].any())


def group_invariants(torch, planes, live, cap, out):
    """group_insert's contract, checked on the card with torch alone (no
    serial version): dead rows get tcap; a placed row's slot is occupied
    and holds the row's key; occ is 0 or 1 and every occupied slot is a
    placed row's; free slots hold zero keys; one slot per key; no unplaced
    row's key holds a slot; n_groups = min(distinct, cap) = occupied
    slots; overflow = the unplaced live rows, > 0 exactly when distinct >
    cap. Returns (n_groups, overflow, distinct)."""
    gid, table, occ, ng, ovf = out
    tcap = 2 * cap
    keys = planes.T
    require(bool(((gid >= 0) & (gid <= tcap)).all()), "gid out of range")
    require(bool((gid[~live] == tcap).all()), "dead rows got a slot")
    placed = live & (gid < tcap)
    pg = gid[placed].long()
    require(bool((occ[pg] == 1).all()), "a placed row's slot is not occupied")
    require(bool((table[:, pg].T == keys[placed]).all()),
            "a placed row's slot holds another key")
    require(bool(((occ == 0) | (occ == 1)).all()), "occ is not 0 or 1")
    occupied = occ == 1
    used = torch.zeros_like(occupied)
    used[pg] = True
    require(torch.equal(used, occupied),
            "occupied slots differ from the placed rows' slots")
    require(bool((table[:, ~occupied] == 0).all()), "a free slot holds a key")
    slot_keys = table[:, occupied].T
    n_slots = slot_keys.shape[0]
    require(_distinct(torch, slot_keys) == n_slots, "one key holds two slots")
    unplaced = live & (gid == tcap)
    require(not _any_shared(torch, slot_keys, keys[unplaced]),
            "an unplaced row's key holds a slot")
    distinct = _distinct(torch, keys[live])
    ngi, ovi = int(ng), int(ovf)
    require(ngi == min(distinct, cap) == n_slots,
            f"n_groups {ngi} vs distinct {distinct} / cap {cap} / occupied "
            f"slots {n_slots}")
    require(ovi == int(unplaced.sum()),
            "overflow differs from the unplaced live rows")
    require((ovi > 0) == (distinct > cap),
            "overflow signal differs from distinct > cap")
    return ngi, ovi, distinct


def check_group_insert(torch, planes, slot0, live, cap, shift=None,
                       plain=True):
    """group_invariants on the launch (the wrapper's plan, or the path
    `shift` names); with `plain`, also against the serial version:
    n_groups and the overflow signal equal, and without overflow the same
    group keys. Returns the discrepancy to the serial version."""
    from presto_tpu_torch.ops import hash_kernels as hk

    if shift is not None:
        require(hk.group_insert_shift(planes.shape[1], planes.shape[0], cap,
                                      shift) == shift,
                f"group_insert: cap {cap} cannot take ranges of 2^{shift}")
    out = (hk.group_insert(planes, slot0, live, cap) if shift is None
           else hk._group_insert_cuda(planes, slot0, live, cap, shift))
    torch.cuda.synchronize()
    ngi, ovi, distinct = group_invariants(torch, planes, live, cap, out)
    if not plain:
        return 0
    p = hk.group_insert_plain(planes.cpu(), slot0.cpu(), live.cpu(), cap)
    require(ngi == int(p[3]), f"n_groups {ngi} vs plain {int(p[3])}")
    require((ovi > 0) == (int(p[4]) > 0),
            "overflow signal differs from the serial version")
    if distinct <= cap:
        # no overflow: the group multisets agree exactly with the serial one
        _, table, occ, _, _ = out
        pk = p[1].T[p[2] > 0]
        require(torch.equal(torch.unique(pk, dim=0),
                            torch.unique(table[:, occ > 0].T.cpu(), dim=0)),
                "group keys differ from the serial version")
    return max(abs(ngi - int(p[3])),
               0 if distinct > cap else abs(ovi - int(p[4])))


def occupied_runs(torch, occ):
    """run[t]: occupied slots in a row ending at slot t, cyclically (0 at
    a free slot), from a cumulative max over the free slots' indices."""
    tcap = occ.shape[0]
    idx = torch.arange(tcap, device=occ.device)
    free = torch.nonzero(~occ).flatten()
    if free.numel() == 0:
        return torch.full((tcap,), tcap, dtype=torch.long, device=occ.device)
    last_free = torch.where(occ, -1, idx).cummax(0).values
    # before the first free slot, the run comes round from the last one
    last_free = torch.where(last_free < 0, free[-1] - tcap, last_free)
    return idx - last_free


def join_invariants(torch, slot0, live, sr):
    """join_insert's contract, checked on the card with torch alone: every
    live row sits in exactly one slot, reachable from its slot0 over
    occupied slots (with wrap-around); no dead row is in the table; free
    slots hold -1. Returns the rows missing, doubled, dead or unreachable,
    and the occupied slots past the live rows."""
    tcap = sr.shape[0]
    occ = sr >= 0
    require(bool((sr[~occ] == -1).all()), "a free slot is not -1")
    rows = sr[occ].long()
    doubled = rows.numel() - torch.unique(rows).numel()
    dead = int((~live[rows]).sum())
    slot_of = torch.full((live.shape[0],), -1, dtype=torch.long,
                         device=sr.device)
    slot_of[rows] = torch.nonzero(occ).flatten()
    placed = live & (slot_of >= 0)
    n_live = int(live.sum())
    missing = n_live - int(placed.sum())
    extra = abs(rows.numel() - n_live)
    run = occupied_runs(torch, occ)
    dist = (slot_of[placed] - slot0.long()[placed]) % tcap
    unreachable = int((run[slot_of[placed]] <= dist).sum())
    err = missing + doubled + dead + unreachable + extra
    require(err == 0, f"join_insert: rows missing {missing}, in two slots "
            f"{doubled}, dead {dead}, unreachable from slot0 {unreachable}; "
            f"occupied slots past the live rows {extra}")
    return err


def check_join_insert(torch, slot0, live, tcap, shift=None, plain=True):
    """join_invariants on the launch (the wrapper's plan, or the path
    `shift` names); with `plain`, also as many occupied slots as the
    serial version. Returns (slot_row, the discrepancy)."""
    from presto_tpu_torch.ops import hash_kernels as hk

    if shift is not None:
        require(hk.join_insert_shift(tcap, shift) == shift,
                f"join_insert: tcap {tcap} cannot take ranges of 2^{shift}")
    sr = (hk.join_insert(slot0, live, tcap) if shift is None
          else hk._join_insert_cuda(slot0, live, tcap, shift))
    torch.cuda.synchronize()
    err = join_invariants(torch, slot0, live, sr)
    if plain:
        p = hk.join_insert_plain(slot0.cpu(), live.cpu(), tcap)
        gap = abs(int((sr >= 0).sum()) - int((p >= 0).sum()))
        require(gap == 0, f"join_insert: occupied-slot gap {gap} to the "
                f"serial version")
        err += gap
    return sr, err


def check_join_probe(torch, slot0, pkeys, plive, slot_row, bkeys, fanout,
                     plain_slot_row=None):
    """Exact counts and overflow against the serial version; per-row match
    sets equal where count ≤ fanout, else the first `fanout` matches are
    true matches."""
    from presto_tpu_torch.ops import hash_kernels as hk

    mm, cnt, ovf = hk.join_probe(slot0, pkeys, plive, slot_row, bkeys, fanout)
    torch.cuda.synchronize()
    psr = plain_slot_row if plain_slot_row is not None else slot_row.cpu()
    pmm, pcnt, povf = hk.join_probe_plain(slot0.cpu(), pkeys.cpu(),
                                          plive.cpu(), psr, bkeys.cpu(),
                                          fanout)
    cnt_h, mm_h = cnt.cpu(), mm.cpu()
    err = int((cnt_h - pcnt).abs().max()) if cnt_h.numel() else 0
    err = max(err, abs(int(ovf) - int(povf)))
    require(torch.equal(cnt_h, pcnt), "join_probe counts differ")
    require(int(ovf) == int(povf), "join_probe overflow differs")
    past = (torch.arange(fanout)[None, :]
            >= torch.clamp(cnt_h, max=fanout)[:, None])
    require(bool((mm_h[past] == -1).all()), "join_probe: padding is not -1")
    full = cnt_h <= fanout
    require(torch.equal(mm_h[full].sort(dim=1).values,
                        pmm[full].sort(dim=1).values),
            "join_probe match sets differ")
    over = ~full
    if over.any():
        got = mm_h[over]
        pk = pkeys.cpu().T[over]
        bk = bkeys.cpu().T
        require(bool((got >= 0).all()), "an overflowing row lost a match")
        require(bool((bk[got.long()] == pk[:, None, :]).all()),
                "an overflowing row recorded a non-match")
    return err


def probe_invariants(torch, slot0, pkeys, plive, slot_row, bkeys, fanout,
                     out):
    """join_probe's contract, checked on the card with torch alone (the
    serial walk, vectorised): a live probe row counts the build rows with
    its key in the slots reachable from its slot0 over occupied slots
    (with wrap-around), a dead row 0; the overflow is the number of rows
    counting more than fanout; a row's first min(count, fanout) entries
    are distinct such build rows, the rest -1. Returns (live probe rows,
    matches)."""
    mm, cnt, ovf = out
    dev = slot0.device
    n, m, tcap = slot0.shape[0], bkeys.shape[1], slot_row.shape[0]
    occ = slot_row >= 0
    run = occupied_runs(torch, occ)
    slots = torch.nonzero(occ).flatten()
    rows = slot_row[slots].long()
    # one id per distinct key over the probe rows and the table's rows
    both = torch.cat([pkeys.T, bkeys.T[rows]])
    ids = (both[:, 0] if both.shape[1] == 1
           else torch.unique(both, dim=0, return_inverse=True)[1])
    pid, bid = ids[:n], ids[n:]
    order = torch.argsort(bid)
    bid, bslot = bid[order], slots[order]
    lo = torch.searchsorted(bid, pid)
    span = torch.where(plive, torch.searchsorted(bid, pid, right=True) - lo,
                       0)
    pr = torch.repeat_interleave(torch.arange(n, device=dev), span)
    first = torch.cumsum(span, 0) - span
    at = torch.arange(pr.numel(), device=dev) - first[pr] + lo[pr]
    ps = bslot[at]
    reach = run[ps] > (ps - slot0.long()[pr]) % tcap
    want = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, pr[reach], torch.ones_like(pr[reach]))
    require(torch.equal(cnt.long(), want), "join_probe: counts differ from "
            "the build rows reachable with the probe's key")
    require(int(ovf) == int((want > fanout).sum()),
            "join_probe: overflow differs from the rows past fanout")
    filled = (torch.arange(fanout, device=dev)[None, :]
              < torch.clamp(want, max=fanout)[:, None])
    require(bool((mm[~filled] == -1).all()), "join_probe: padding is not -1")
    got = mm[filled].long()
    grow = torch.arange(n, device=dev)[:, None].expand(n, fanout)[filled]
    require(bool(((got >= 0) & (got < m)).all()),
            "join_probe: a match is not a build row")
    slot_of = torch.full((m,), -1, dtype=torch.long, device=dev)
    slot_of[rows] = slots
    s = slot_of[got]
    require(bool((s >= 0).all()), "join_probe: a match is not in the table")
    require(bool((bkeys[:, got] == pkeys[:, grow]).all()),
            "join_probe: a match has another key")
    require(bool((run[s] > (s - slot0.long()[grow]) % tcap).all()),
            "join_probe: a match is not reachable from the row's slot0")
    require(torch.unique(grow * m + got).numel() == got.numel(),
            "join_probe: a row records one match twice")
    return int(plive.sum()), int(want.sum())


def synthetic_planes(torch, rng, n, k, distinct, dev):
    import numpy as np

    base = rng.integers(-2**62, 2**62, size=(distinct, k), dtype=np.int64)
    base[0] = [2**63 - 1] + [-2**63] * (k - 1)  # near-limit key
    pick = rng.integers(0, distinct, n)
    return torch.from_numpy(np.ascontiguousarray(base[pick].T)).to(dev)


# Forced range size of the partitioned cases: small tables, many ranges
# (a table takes ranges from 64 of them: 2^16 slots).
SMALL_RANGE_BITS = 10


def group_insert_cases():
    """(label, rows, key planes, cap, distinct keys, path: None for the
    wrapper's plan or the range shift, slot0: "hash", "range ends" (the
    last slots of each range), "table end" (the last slots of the table,
    chains wrap to slot 0) or "one slot")."""
    m, r = HASH_CHECK_ROWS, SMALL_RANGE_BITS
    return [("global, tickets", m, 3, 4096, 3000, None, "hash"),
            ("global, distinct > cap", m, 3, 1024, 3000, None, "hash"),
            ("global, one slot", 8192, 2, 256, 200, None, "one slot"),
            ("global, no more rows than cap", 4096, 3, 8192, 3000, None,
             "hash"),
            ("chains across range ends", 20000, 2, 1 << 15, 3000, r,
             "range ends"),
            ("chains wrap from tcap - 1 to 0", 20000, 1, 1 << 15, 2000, r,
             "table end"),
            ("all rows on one slot", 8192, 2, 1 << 15, 300, r, "one slot"),
            ("distinct > cap", m, 1, 1 << 15, 40000, r, "hash")]


def join_insert_cases():
    """(label, rows, tcap, range shift, slot0 as in group_insert_cases).
    On one slot, more rows come to one range than its bucket holds."""
    r = SMALL_RANGE_BITS
    return [("chains across range ends", 8000, 1 << 16, r, "range ends"),
            ("chains wrap from tcap - 1 to 0", 8000, 1 << 16, r, "table end"),
            ("all rows on one slot", 2048, 1 << 16, r, "one slot"),
            ("hashed", 30000, 1 << 16, r, "hash")]


def boundary_slots(torch, rng, planes, tcap, shift, where, n=None):
    """slot0 for a case of group_insert_cases (from the key planes, so
    that equal keys share a slot) or of join_insert_cases (n rows)."""
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    dev = torch.device("cuda")
    if planes is not None:
        h = hash_columns(list(planes))
        n = planes.shape[1]
    else:
        h = torch.from_numpy(rng.integers(0, 2**62, n)).to(dev)
    if where == "hash":
        return slot_hash(h, tcap)
    if where == "one slot":
        # the last slot of a range (of the first one on the global path)
        return torch.full((n,), ((1 << (shift or 10)) - 1) % tcap,
                          dtype=torch.int32, device=dev)
    if where == "range ends":
        ranges = tcap >> shift
        ends = ((h % ranges) + 1) * (1 << shift) - 1
        return (ends - (h // ranges) % 48).to(torch.int32)
    return (tcap - 1 - h % 64).to(torch.int32)  # "table end"


def join_probe_case(torch, rng, bn, dup, fanouts, collide=False):
    """join_insert of `bn` build rows over `dup` distinct keys (all on one
    slot when `collide`), checked by its invariants, then join_probe of as
    many probe rows (half of them build keys) at each fanout against the
    plain version. Returns (join_insert error, join_probe error)."""
    from presto_tpu_torch.ops import hash_kernels as hk
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    dev = torch.device("cuda")
    bkeys = synthetic_planes(torch, rng, bn, 1, dup, dev)
    blive = torch.from_numpy(rng.random(bn) < 0.9).to(dev)
    tcap = 2 * bn
    bslot = (torch.full((bn,), 7, dtype=torch.int32, device=dev) if collide
             else slot_hash(hash_columns(list(bkeys)), tcap))
    sr, ji_err = check_join_insert(torch, bslot, blive, tcap)
    print(f"kernel join_insert: n={bn} tcap={tcap} distinct={dup}"
          f"{' one-slot collisions' if collide else ''} invariants hold "
          f"(rows cut: the plain version is serial)")
    psr = hk.join_insert_plain(bslot.cpu(), blive.cpu(), tcap)
    pkeys = synthetic_planes(torch, rng, bn, 1, dup, dev)
    hit = torch.from_numpy(rng.integers(0, bn, bn // 2)).to(dev)
    pkeys[0, : bn // 2] = bkeys[0, hit]
    plive = torch.from_numpy(rng.random(bn) < 0.9).to(dev)
    pslot = (torch.full((bn,), 7, dtype=torch.int32, device=dev) if collide
             else slot_hash(hash_columns(list(pkeys)), tcap))
    jp_err = 0
    for f in fanouts:
        jp_err = max(jp_err, check_join_probe(torch, pslot, pkeys, plive, sr,
                                              bkeys, f, psr))
        print(f"kernel join_probe: n={bn} F={f} build={bn}"
              f"{' one-slot collisions' if collide else ''}: counts, "
              f"overflow, match sets and -1 padding equal to plain (exact)")
    return ji_err, jp_err


def phase_kernels(torch):
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    gs_err = 0
    for label, n, g, layout, dead, offset in grouped_sums_cases():
        gid = torch.from_numpy(
            np.full(n + offset, g, np.int32) if dead
            else rng.integers(-1, g + 2, n + offset).astype(np.int32)
        ).to(dev)[offset:]
        states = synthetic_states(torch, rng, n, layout, dev, offset)
        gs_err = max(gs_err, check_grouped_sums(torch, gid, states, g))
        print(f"kernel grouped_sums [{label}]: n={n} G={g} S={len(states)} "
              f"equal to plain (exact)")

    m = HASH_CHECK_ROWS
    gi_err = 0
    for label, n_rows, k, cap, distinct, shift, where in group_insert_cases():
        planes = synthetic_planes(torch, rng, n_rows, k, distinct, dev)
        live = torch.from_numpy(rng.random(n_rows) < 0.9).to(dev)
        slot0 = boundary_slots(torch, rng, planes, 2 * cap, shift, where)
        gi_err = max(gi_err, check_group_insert(torch, planes, slot0, live,
                                                cap, shift))
        path = "wrapper's plan" if shift is None else f"ranges of 2^{shift}"
        print(f"kernel group_insert [{label}]: n={n_rows} K={k} cap={cap} "
              f"distinct={distinct} ({path}): invariants hold, equal to "
              f"plain (rows cut: the plain version is serial)")
    ji_err = 0
    for label, n_rows, tcap, shift, where in join_insert_cases():
        slot0 = boundary_slots(torch, rng, None, tcap, shift, where, n_rows)
        live = torch.from_numpy(rng.random(n_rows) < 0.9).to(dev)
        _, err = check_join_insert(torch, slot0, live, tcap, shift)
        ji_err = max(ji_err, err)
        print(f"kernel join_insert [{label}]: n={n_rows} tcap={tcap} (ranges "
              f"of 2^{shift}): invariants hold, as many slots as plain")

    jp_err = 0
    # (build rows, distinct build keys, fanouts, all rows on one slot); the
    # third case has about 46 matches a key, so F = 16 and 32 overflow and
    # F = 32 and 64 take the kernel's branch for fanouts past 16
    for bn, dup, fanouts, collide in ((m, 20000, (8, 1, 16), False),
                                      (2048, 300, (8, 16), True),
                                      (4096, 80, (16, 32, 64), False)):
        errs = join_probe_case(torch, rng, bn, dup, fanouts, collide)
        ji_err, jp_err = max(ji_err, errs[0]), max(jp_err, errs[1])
    # the launch refuses a fanout that is not a power of two, as the
    # wrapper does (it checks F before it reads any pointer)
    from presto_tpu_torch.kernels._build import library, stream_ptr

    rc = library("hash_table").join_probe_launch(
        0, 0, 0, 0, 0, 0, 0, 0, 0, 16, 1, 16, 32, 12, stream_ptr(dev))
    require(rc != 0, "join_probe launched with F=12")
    print("kernel join_probe: F=12 refused (fanouts are powers of two)")
    torch.cuda.synchronize()
    return {"grouped_sums": gs_err, "group_insert": gi_err,
            "join_insert": ji_err, "join_probe": jp_err}


# ---------------------------------------------------------------------------
# phase 3: queries


def _days(y, m, d):
    from presto_tpu_torch.expr.host import days_from_civil

    return days_from_civil(y, m, d)


def oracle(conn, label):
    """The query's expected frame from the table's unscaled integers
    (l_quantity is BIGINT; prices, discounts and taxes are DECIMAL(15, 2)).
    Averages divide in float64 as the engine does: unscale (multiply by
    the reciprocal of 10^scale), then divide by the count."""
    import numpy as np
    import pandas as pd
    from decimal import Decimal

    def table(name):
        conn.get_table(name)
        return conn.tables[name]

    def dec(v, scale):
        return Decimal(int(v)).scaleb(-scale).quantize(Decimal(1).scaleb(-scale))

    li = table("lineitem")
    a = li.arrays
    if label == "q1":
        m = a["l_shipdate"] <= _days(1998, 9, 2)
        rf, ls = a["l_returnflag"][m], a["l_linestatus"][m]
        qty, ep = a["l_quantity"][m], a["l_extendedprice"][m]
        disc, tax = a["l_discount"][m], a["l_tax"][m]
        rows = []
        rfd, lsd = li.dicts["l_returnflag"], li.dicts["l_linestatus"]
        for r in np.unique(rf):
            for s in np.unique(ls):
                g = (rf == r) & (ls == s)
                n = int(g.sum())
                if not n:
                    continue
                sq, sp = int(qty[g].sum()), int(ep[g].sum())
                sd = int((ep[g] * (100 - disc[g])).sum())
                sc = int((ep[g] * (100 - disc[g]) * (100 + tax[g])).sum())
                sdisc = int(disc[g].sum())
                rows.append({
                    "l_returnflag": rfd.values[r], "l_linestatus": lsd.values[s],
                    "sum_qty": sq, "sum_base_price": dec(sp, 2),
                    "sum_disc_price": dec(sd, 4), "sum_charge": dec(sc, 6),
                    "avg_qty": np.float64(sq) / n,
                    "avg_price": np.float64(sp) * (1.0 / 100) / n,
                    "avg_disc": np.float64(sdisc) * (1.0 / 100) / n,
                    "count_order": n})
        return pd.DataFrame(rows).sort_values(
            ["l_returnflag", "l_linestatus"], ignore_index=True)
    if label == "q6":
        m = ((a["l_shipdate"] >= _days(1994, 1, 1))
             & (a["l_shipdate"] < _days(1995, 1, 1))
             & (a["l_discount"] >= 5) & (a["l_discount"] <= 7)
             & (a["l_quantity"] < 24))
        rev = int((a["l_extendedprice"][m] * a["l_discount"][m]).sum())
        return pd.DataFrame({"revenue": [dec(rev, 4)]})
    cu, od = table("customer"), table("orders")
    seg = cu.dicts["c_mktsegment"].code_of("BUILDING")
    custs = cu.arrays["c_custkey"][cu.arrays["c_mktsegment"] == seg]
    cut = _days(1995, 3, 15)
    om = (od.arrays["o_orderdate"] < cut) & np.isin(od.arrays["o_custkey"], custs)
    orders = pd.DataFrame({"l_orderkey": od.arrays["o_orderkey"][om],
                           "o_orderdate": od.arrays["o_orderdate"][om],
                           "o_shippriority": od.arrays["o_shippriority"][om]})
    lm = a["l_shipdate"] > cut
    lines = pd.DataFrame({
        "l_orderkey": a["l_orderkey"][lm],
        "rev": a["l_extendedprice"][lm] * (100 - a["l_discount"][lm])})
    j = lines.merge(orders, on="l_orderkey")
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False)["rev"].sum()
    g = g.sort_values(["rev", "o_orderdate"], ascending=[False, True],
                      kind="stable").head(10)
    return pd.DataFrame({
        "l_orderkey": g["l_orderkey"].to_numpy(),
        "revenue": [dec(v, 4) for v in g["rev"]],
        "o_orderdate": g["o_orderdate"].to_numpy(),
        "o_shippriority": g["o_shippriority"].to_numpy()})


def frames_equal(got, want, label) -> None:
    require(list(got.columns) == list(want.columns),
            f"{label}: columns {list(got.columns)} vs {list(want.columns)}")
    require(len(got) == len(want), f"{label}: {len(got)} rows vs {len(want)}")
    for c in want.columns:
        g, w = list(got[c]), list(want[c])
        require(g == w, f"{label}: column {c} differs: {g[:4]} vs {w[:4]}")


def _tensors(obj):
    """Every tensor in a launcher's arguments (lists and tuples opened)."""
    if hasattr(obj, "numel"):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)


def _clone(obj, memo):
    """Deep copy of a launcher's arguments: a tensor passed twice (a mask
    that is also a count state) stays one tensor."""
    if hasattr(obj, "clone"):
        if id(obj) not in memo:
            memo[id(obj)] = obj.clone()
        return memo[id(obj)]
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(x, memo) for x in obj)
    return obj


class Recorder:
    """Keeps the largest inputs each kernel launcher saw (for the timing
    phase), by wrapping the modules' private CUDA launchers; the launch
    counts stay in the public wrappers."""

    def __init__(self, torch):
        from presto_tpu_torch.ops import groupby_kernels as gk
        from presto_tpu_torch.ops import hash_kernels as hk

        self.torch = torch
        self.inputs = {}
        self._patches = [(gk, "_grouped_sums_cuda", "grouped_sums"),
                         (hk, "_group_insert_cuda", "group_insert"),
                         (hk, "_join_insert_cuda", "join_insert"),
                         (hk, "_join_probe_cuda", "join_probe")]
        self._orig = {}
        for mod, attr, name in self._patches:
            fn = getattr(mod, attr)
            self._orig[(mod, attr)] = fn
            setattr(mod, attr, self._wrap(fn, name))

    def _wrap(self, fn, name):
        def rec(*args):
            size = max(t.numel() for t in _tensors(args))
            if size > self.inputs.get(name, (0, None))[0]:
                self.inputs[name] = (size, _clone(args, {}))
            return fn(*args)
        return rec

    def close(self):
        for (mod, attr), fn in self._orig.items():
            setattr(mod, attr, fn)


def record_run(torch, run):
    """name -> (size, arguments): the largest input each kernel launcher
    saw during one call of `run`."""
    rec = Recorder(torch)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        rec.close()
    return rec.inputs


def warm_runs(torch, runner, sql, reps=3):
    """The last of `reps` timed runs of a warm runner, and their median
    wall time."""
    ts = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run(sql)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def timed_runs(torch, runner, sql, reps=3):
    runner.run(sql)  # warm-up
    return warm_runs(torch, runner, sql, reps)


def phase_queries(torch):
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    cat = tpch_catalog(SF)
    conn = cat.connectors["tpch"]
    for t in ("lineitem", "orders", "customer"):
        conn.get_table(t)
    n_lineitem = conn.tables["lineitem"].num_rows
    print(f"data: TPC-H SF {SF} generated in {time.perf_counter() - t0:.1f} s "
          f"({n_lineitem} lineitem rows)")
    runners = {e: LocalRunner(cat, ExecConfig(breaker_engine=e))
               for e in ("auto", "hash")}
    oracles = {q: oracle(conn, q) for q in QUERIES}

    recorder = Recorder(torch)
    reset_launch_counts()
    results = {}
    try:
        for label, q, eng in RUNS:
            results[label] = runners[eng].run(QUERIES[q])
        torch.cuda.synchronize()
    finally:
        recorder.close()
    launches = launch_counts()
    print(f"launches during the SF {SF} query phase: {json.dumps(launches)}")
    for label, q, eng in RUNS:
        check_oracle(results[label], oracles[q], q, f"{label} SF {SF}")
        print(f"query {label} (breaker_engine={eng}) SF {SF}: "
              f"{len(results[label])} rows equal to the numpy oracle (exact)")

    timings = {}
    for label, q, eng in RUNS:
        out, sec = timed_runs(torch, runners[eng], QUERIES[q])
        check_oracle(out, oracles[q], q, f"{label} SF {SF} warm")
        timings[label] = sec
        print(f"query {label} (breaker_engine={eng}) SF {SF}: warm median of 3 "
              f"{sec * 1e3:.1f} ms, {n_lineitem / sec:.4g} lineitem rows/s")

    small = tpch_catalog(SMALL_SF)
    for label, q, eng in RUNS:
        cfg = ExecConfig(breaker_engine=eng)
        on_gpu = LocalRunner(small, cfg).run(QUERIES[q])
        on_cpu = LocalRunner(small, cfg, device="cpu").run(QUERIES[q])
        require(on_gpu.equals(on_cpu),
                f"{label} SF {SMALL_SF}: card and CPU results differ")
        print(f"query {label} SF {SMALL_SF}: card result identical to the CPU")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the query path")
    return launches, recorder.inputs, timings, cat


# ---------------------------------------------------------------------------
# phase 3b: the 22 TPC-H queries

# the output columns of each query's ORDER BY (None: one row)
ORDER_KEYS = {
    "q1": ["l_returnflag", "l_linestatus"],
    "q2": ["s_acctbal", "n_name", "s_name", "p_partkey"],
    "q3": ["revenue", "o_orderdate"], "q4": ["o_orderpriority"],
    "q5": ["revenue"], "q6": None,
    "q7": ["supp_nation", "cust_nation", "l_year"], "q8": ["o_year"],
    "q9": ["nation", "o_year"], "q10": ["revenue"], "q11": ["value"],
    "q12": ["l_shipmode"], "q13": ["custdist", "c_count"], "q14": None,
    "q15": ["s_suppkey"], "q16": ["supplier_cnt", "p_brand", "p_type", "p_size"],
    "q17": None, "q18": ["o_totalprice", "o_orderdate"], "q19": None,
    "q20": ["s_name"], "q21": ["numwait", "s_name"], "q22": ["cntrycode"],
}
ENGINES = ("auto", "hash")
# queries whose SF 1 runs in the 22-query phase keep their first run, so
# that the script stays inside its time limit: Q18, which the memory
# phase's grace_default unit runs in the same (default) config with warm
# medians and device time, and Q17 and Q20, the phase's longest after it
# (GRACE too, PERF.md §5)
TPCH_FIRST_RUN_ONLY = ("q17", "q18", "q20")
# the queries whose SemiJoins take the hash engine (no residual): their
# join_insert builds keep duplicate keys (Q4's lineitem, Q22's orders)
SEMI_HASH = ("q4", "q16", "q18", "q20", "q22")
# Q11's HAVING fraction: the query text's constant leaves no row at SF 1;
# the SF run takes TPC-H's FRACTION = 0.0001 / SF instead
Q11_FRACTION = "* 0.0005"


def at_scale(q, sql, sf):
    """The text of query q as run at scale factor sf."""
    if q != "q11":
        return sql
    require(sql.count(Q11_FRACTION) == 1, "q11: its fraction is not in the "
            "text")
    return sql.replace(Q11_FRACTION, f"* {0.0001 / sf!r}")


def check_recorded(torch, inputs, errs):
    """Each kernel's largest input in one hash-engine run of a query,
    launched again and held to its contract on the card: grouped_sums
    against its plain version, the others by their invariants (their
    serial plain versions are too slow at these sizes). Returns
    name -> text of what was checked."""
    from presto_tpu_torch.ops import hash_kernels as hk

    done = {}
    for name, (_, args) in inputs.items():
        if name == "grouped_sums":
            errs[name] = max(errs[name], check_grouped_sums(torch, *args))
            done[name] = f"n={args[0].shape[0]} S={len(args[1])} G={args[2]}"
        elif name == "group_insert":
            planes, _, live, cap = args
            ng, ovf, _ = group_invariants(
                torch, planes, live, cap, hk._group_insert_cuda(*args))
            done[name] = (f"n={planes.shape[1]} K={planes.shape[0]} "
                          f"cap={cap} groups={ng} overflow={ovf}")
        elif name == "join_insert":
            slot0, live, tcap = args
            join_invariants(torch, slot0, live, hk._join_insert_cuda(*args))
            done[name] = (f"n={slot0.shape[0]} tcap={tcap} "
                          f"live={int(live.sum())} distinct live slot0="
                          f"{torch.unique(slot0[live]).numel()}")
        else:
            slot0, pkeys, plive, slot_row, bkeys, f = args
            rows, matches = probe_invariants(
                torch, slot0, pkeys, plive, slot_row, bkeys, f,
                hk._join_probe_cuda(*args))
            done[name] = (f"n={slot0.shape[0]} K={pkeys.shape[0]} F={f} "
                          f"build={bkeys.shape[1]} live={rows} "
                          f"matches={matches}")
        torch.cuda.synchronize()
    return done


def _nulls_as_none(col):
    return [None if v is None or (isinstance(v, float) and v != v) else v
            for v in col]


def columns_equal(got, want, label, rtol=1e-12) -> None:
    """Column by column: floats to rtol (1e-12: the JAX package's tolerance
    between its own engines), everything else exactly."""
    import numpy as np

    require(list(got.columns) == list(want.columns),
            f"{label}: columns {list(got.columns)} vs {list(want.columns)}")
    require(len(got) == len(want), f"{label}: {len(got)} rows vs {len(want)}")
    for c in want.columns:
        if got[c].reset_index(drop=True).equals(
                want[c].reset_index(drop=True)):
            continue  # the same dtype, values and NULLs: at C speed
        g, w = _nulls_as_none(got[c]), _nulls_as_none(want[c])
        present = [v for v in g + w if v is not None]
        if present and all(isinstance(v, float) for v in present):
            ok = ([v is None for v in g] == [v is None for v in w]
                  and np.allclose([0.0 if v is None else v for v in g],
                                  [0.0 if v is None else v for v in w],
                                  rtol=rtol, atol=0.0))
        else:
            ok = g == w
        require(ok, f"{label}: column {c} differs: {g[:4]} vs {w[:4]}")


def _as_multiset(df):
    """The frame's rows in an order of their own values (floats to 9
    digits), so two frames with the same rows line up."""
    import pandas as pd

    key = pd.DataFrame({c: (df[c].map(lambda v: f"{v:.9g}")
                            if df[c].dtype.kind == "f" else df[c].astype(str))
                        for c in df.columns})
    return df.loc[key.sort_values(list(key.columns), kind="stable").index
                  ].reset_index(drop=True)


def frames_agree(got, want, keys, label, rtol=1e-12) -> str:
    """Identical frames, or (where the ORDER BY ties) the ordering columns
    row for row and the rows as a multiset. Returns which held."""
    if got.equals(want):
        return "identical"
    if keys:
        columns_equal(got[keys], want[keys], f"{label} (ordering columns)",
                      rtol)
    columns_equal(_as_multiset(got), _as_multiset(want), f"{label} (rows)",
                  rtol)
    return "equal up to ties" if keys else "equal"


def check_oracle(got, want, q, label) -> None:
    """Q1 and Q6 exactly (one row or groups in key order); the others where
    their ORDER BY may tie: the ordering columns row for row, the rows as a
    multiset."""
    if q in ("q1", "q6"):
        frames_equal(got, want, label)
    else:
        frames_agree(got, want, ORDER_KEYS[q], label)


def oracle22(conn, label):
    """Q4, Q13, Q18 and Q21 from the tables' unscaled integers and
    dictionary codes with numpy and pandas: EXISTS, LEFT JOIN with
    count(col) and NOT LIKE, IN with GROUP BY ... HAVING, and EXISTS /
    NOT EXISTS with a residual."""
    import numpy as np
    import pandas as pd
    from decimal import Decimal

    def table(name):
        conn.get_table(name)
        return conn.tables[name]

    def strings(t, col, codes):
        return [str(v) for v in t.dicts[col].values[codes]]

    li, od = table("lineitem"), table("orders")
    a, o = li.arrays, od.arrays
    if label == "q4":
        late = a["l_orderkey"][a["l_commitdate"] < a["l_receiptdate"]]
        m = ((o["o_orderdate"] >= _days(1993, 7, 1))
             & (o["o_orderdate"] < _days(1993, 10, 1))
             & np.isin(o["o_orderkey"], np.unique(late)))
        codes, n = np.unique(o["o_orderpriority"][m], return_counts=True)
        return pd.DataFrame({
            "o_orderpriority": strings(od, "o_orderpriority", codes),
            "order_count": n.astype(np.int64)})
    if label == "q13":
        cu = table("customer").arrays
        special = np.array(["comment 1" in str(v)
                            for v in od.dicts["o_comment"].values])
        keep = ~special[o["o_comment"]]
        per = np.bincount(o["o_custkey"][keep],
                          minlength=int(cu["c_custkey"].max()) + 1)
        c_count, custdist = np.unique(per[cu["c_custkey"]], return_counts=True)
        df = pd.DataFrame({"c_count": c_count.astype(np.int64),
                           "custdist": custdist.astype(np.int64)})
        return df.sort_values(["custdist", "c_count"], ascending=False,
                              ignore_index=True)
    if label == "q18":
        cu = table("customer")
        qty = pd.Series(a["l_quantity"]).groupby(a["l_orderkey"]).sum()
        big = qty[qty > 250]
        m = np.isin(o["o_orderkey"], big.index.to_numpy())
        df = pd.DataFrame({"c_custkey": o["o_custkey"][m],
                           "o_orderkey": o["o_orderkey"][m],
                           "o_orderdate": o["o_orderdate"][m],
                           "price": o["o_totalprice"][m]})
        crow = pd.Series(np.arange(cu.num_rows), index=cu.arrays["c_custkey"])
        df["c_name"] = strings(cu, "c_name", cu.arrays["c_name"][
            crow[df["c_custkey"]].to_numpy()])
        df["total_qty"] = big[df["o_orderkey"]].to_numpy()
        df = df.sort_values(["price", "o_orderdate"], ascending=[False, True],
                            kind="stable").head(100)
        return pd.DataFrame({
            "c_name": df["c_name"].to_numpy(),
            "c_custkey": df["c_custkey"].to_numpy(),
            "o_orderkey": df["o_orderkey"].to_numpy(),
            "o_orderdate": df["o_orderdate"].to_numpy(),
            "o_totalprice": [Decimal(int(v)).scaleb(-2) for v in df["price"]],
            "total_qty": df["total_qty"].to_numpy()})
    assert label == "q21", label
    su, na = table("supplier"), table("nation")
    saudi = na.arrays["n_nationkey"][
        na.arrays["n_name"] == na.dicts["n_name"].code_of("SAUDI ARABIA")]
    supp = su.arrays["s_suppkey"][np.isin(su.arrays["s_nationkey"], saudi)]
    final = o["o_orderkey"][
        o["o_orderstatus"] == od.dicts["o_orderstatus"].code_of("F")]
    lines = pd.DataFrame({"o": a["l_orderkey"], "s": a["l_suppkey"],
                          "late": a["l_receiptdate"] > a["l_commitdate"]})
    l1 = lines[lines["late"] & np.isin(lines["s"], supp)
               & np.isin(lines["o"], final)]
    # lines of the order, and of the order by the same supplier: all and late
    n_o = lines.groupby("o").size().rename("n_o")
    n_os = lines.groupby(["o", "s"]).size().rename("n_os")
    late = lines[lines["late"]]
    k_o = late.groupby("o").size().rename("k_o")
    k_os = late.groupby(["o", "s"]).size().rename("k_os")
    l1 = (l1.join(n_o, on="o").join(n_os, on=["o", "s"])
          .join(k_o, on="o").join(k_os, on=["o", "s"]).fillna(0))
    keep = (l1["n_o"] > l1["n_os"]) & ~(l1["k_o"] > l1["k_os"])
    numwait = l1[keep].groupby("s").size()
    srow = pd.Series(np.arange(su.num_rows), index=su.arrays["s_suppkey"])
    df = pd.DataFrame({"s_name": strings(su, "s_name", su.arrays["s_name"][
        srow[numwait.index].to_numpy()]),
        "numwait": numwait.to_numpy().astype(np.int64)})
    return df.sort_values(["numwait", "s_name"], ascending=[False, True],
                          ignore_index=True).head(100)


# the port's CUDA kernels, by the names of their __global__ functions
PORT_KERNELS = ("grouped_sums", "group_insert", "group_range", "join_insert",
                "join_probe", "join_range", "range_count", "range_scatter")


def device_profile(torch, run, check=False):
    """Device time of one call of `run` by torch.profiler (CUDA activity):
    every kernel, memset and copy, in ms; the port's kernels' share; the
    three largest entries. The times are summed from the profiler's device
    activity records: `key_averages()` builds a Python object an event,
    seconds of host time for a query of thousands of launches; with
    `check` the two totals must agree to 1e-3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    times = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            times[e.name()] = times.get(e.name(), 0.0) + e.duration_ns() / 1e6
    if check:
        slow = 0.0
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            slow += (e.cuda_time_total if t is None else t) / 1e3
        fast = sum(times.values())
        print(f"device_profile: {fast:.4f} ms from the activity records, "
              f"{slow:.4f} ms from key_averages()")
        require(abs(fast - slow) <= 1e-3 * slow, "device_profile: the "
                "activity records and key_averages() disagree")
    ours = sum(t for k, t in times.items()
               if any(n in k for n in PORT_KERNELS))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:3]
    return {"device_ms": sum(times.values()), "port_kernels_ms": ours,
            "top": [[k[:48], t] for k, t in top]}


def phase_tpch22(torch, cat, errs):
    """The 22 TPC-H queries on the card under breaker_engine auto and hash:
    each returns rows (Q11 with TPC-H's fraction for the scale factor, see
    `at_scale`); the engines must agree; Q1, Q3, Q4, Q6, Q13, Q18 and Q21
    must equal their oracles; each query's launches come from its first
    run (counts reset just before it, read just after), and Q18 under hash
    must have run its SemiJoin on join_insert and join_probe and its GROUP
    BY l_orderkey on group_insert; then (but for TPCH_FIRST_RUN_ONLY) the
    warm median of 3 and lineitem rows/s, and the device time of one more
    run (torch.profiler): all of it, the port's kernels' part, and the
    three largest entries. One more
    run under hash records each kernel's largest input, which
    `check_recorded` holds to its contract. At SF 0.01 every query under
    both engines must give the same frame on the card as on the CPU.
    Returns name -> [(label, arguments)]: the inputs the timing phase
    times, per kernel the largest of the 22 queries and, for join_insert
    and join_probe, those of the SEMI_HASH queries."""
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.catalog.tpch_queries import QUERIES as TPCH
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    conn = cat.connectors["tpch"]
    t0 = time.perf_counter()
    for t in conn.table_names():
        conn.get_table(t)
    n_lineitem = conn.tables["lineitem"].num_rows
    oracles = {q: oracle(conn, q) for q in ("q1", "q3", "q6")}
    oracles.update({q: oracle22(conn, q) for q in ("q4", "q13", "q18", "q21")})
    print(f"tpch22: tables and oracles ready in {time.perf_counter() - t0:.1f} s")
    runners = {e: LocalRunner(cat, ExecConfig(breaker_engine=e))
               for e in ENGINES}
    summary = []
    largest, semi = {}, {}
    for q, text in TPCH.items():
        sql = at_scale(q, text, SF)
        outs = {}
        for eng in ENGINES:
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = runners[eng].run(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t1
            launches = {k: v for k, v in launch_counts().items() if v}
            grace = runners[eng].last_stats.get("spill.partitions", 0) > 0
            if q == "q18" and eng == "hash":
                for k in ("join_insert", "join_probe", "group_insert"):
                    require(launches.get(k, 0) > 0,
                            f"q18 hash: {k} did not launch")
            require(len(out) > 0, f"{q} {eng} SF {SF}: no row")
            outs[eng] = out
            if q in SCAN_QUERIES:
                MEMORY_FRAMES[(sql, eng)] = out
            if q in oracles:
                check_oracle(out, oracles[q], q, f"{q} {eng} SF {SF} oracle")
            if q in TPCH_FIRST_RUN_ONLY:
                summary.append({"query": q, "engine": eng, "rows": len(out),
                                "first_ms": first * 1e3, "grace": grace,
                                "launches": launches})
                print(f"tpch {q} {eng} SF {SF}: grace {grace}; {len(out)} "
                      f"rows; first run {first * 1e3:.1f} ms (warm runs in "
                      f"the memory phase's grace_default); launches "
                      f"{json.dumps(launches)}"
                      + ("; equal to the oracle (exact)" if q in oracles
                         else ""))
                continue
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                again = runners[eng].run(sql)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t1)
            frames_agree(again, out, ORDER_KEYS[q], f"{q} {eng} rerun")
            sec = statistics.median(ts)
            dev = device_profile(torch, lambda: runners[eng].run(sql),
                                 check=q == "q1")
            summary.append({"query": q, "engine": eng, "rows": len(out),
                            "warm_ms": sec * 1e3, "first_ms": first * 1e3,
                            "lineitem_rows_per_s": n_lineitem / sec,
                            "grace": grace, "launches": launches, **dev})
            print(f"tpch {q} {eng} SF {SF}: grace {grace}; {len(out)} rows; "
                  f"warm median of 3 "
                  f"{sec * 1e3:.1f} ms, {n_lineitem / sec:.4g} lineitem "
                  f"rows/s; first run {first * 1e3:.1f} ms; launches "
                  f"{json.dumps(launches)}; device time of one run "
                  f"{dev['device_ms']:.2f} ms ({dev['device_ms'] / sec / 10:.1f} "
                  f"% of the warm median), the port's kernels "
                  f"{dev['port_kernels_ms']:.3f} ms; largest "
                  f"{json.dumps(dev['top'])}"
                  + ("; equal to the oracle (exact)" if q in oracles else ""))
        how = frames_agree(outs["hash"], outs["auto"], ORDER_KEYS[q],
                           f"{q} SF {SF} hash vs auto")
        print(f"tpch {q} SF {SF}: hash and auto {how}")
        inputs = record_run(torch, lambda: runners["hash"].run(sql))
        done = check_recorded(torch, inputs, errs)
        print(f"tpch {q} hash SF {SF}: each kernel's largest input holds its "
              f"contract: {json.dumps(done)}")
        for name, (size, args) in inputs.items():
            if size > largest.get(name, (0, None, None))[0]:
                largest[name] = (size, q, args)
            if q in SEMI_HASH and name in ("join_insert", "join_probe"):
                semi.setdefault(name, []).append((q, args))
        del inputs

    small = tpch_catalog(SMALL_SF)
    hows = {}
    for q, sql in TPCH.items():
        for eng in ENGINES:
            cfg = ExecConfig(breaker_engine=eng)
            on_gpu = LocalRunner(small, cfg).run(sql)
            on_cpu = LocalRunner(small, cfg, device="cpu").run(sql)
            hows[f"{q} {eng}"] = frames_agree(
                on_gpu, on_cpu, ORDER_KEYS[q],
                f"{q} {eng} SF {SMALL_SF} card vs CPU")
    print(f"tpch22 SF {SMALL_SF}: card against CPU for {len(hows)} runs: "
          f"{json.dumps(hows)}")
    print(f"tpch22: phase took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"tpch22": summary}))
    timed = {}
    for name, (_, q, args) in largest.items():
        timed[name] = [(f"{q} hash SF {SF}, the largest of the 22", args)]
        timed[name] += [(f"{sq} hash SF {SF} (hash SemiJoin), its largest",
                         a) for sq, a in semi.get(name, []) if sq != q]
    return timed


# ---------------------------------------------------------------------------
# phase 3b': the SQL surface beyond TPC-H and TPC-DS

# name -> SQL over TPC-H: string functions over dictionaries of real size,
# string compares, casts from and to varchar, SELECT without FROM, and
# approx_distinct/geometric_mean/checksum. `li_aggs` mixes approx_distinct
# with other aggregates, which the planner computes exactly (count
# DISTINCT); `li_hll` alone takes the HyperLogLog lowering, whose GROUP BY
# (flag, register) runs group_insert under hash.
SURFACE = {
    "upper_length": "select upper(c_mktsegment) seg, count(*) n, "
                    "sum(length(c_name)) ln from customer group by 1 "
                    "order by 1",
    "phone_prefix": "select substr(c_phone, 1, 2) || '-' cc, count(*) n "
                    "from customer group by 1 order by 1",
    "type_word_regexp": "select split_part(p_type, ' ', 2) t, count(*) n, "
                        "count_if(regexp_like(p_name, '^[a-f]')) rl "
                        "from part group by 1 order by 1",
    "promo_range": "select count(*) n, sum(p_size) s from part "
                   "where p_type between 'PROMO' and 'PROMOZ'",
    "status_columns": "select count(*) n from orders, lineitem "
                      "where o_orderkey = l_orderkey "
                      "and l_linestatus <> o_orderstatus",
    "orderkey_text": "select cast(o_orderkey as varchar) k from orders "
                     "where o_orderdate >= date '1998-01-01'",
    "clerk_number": "select sum(cast(substr(o_clerk, 7) as bigint)) s, "
                    "count_if(cast(substr(o_clerk, 7) as bigint) < 500) lo "
                    "from orders",
    "no_from": "select 1 + 2 x, 'x' || 'y' s",
    "li_aggs": "select l_returnflag, approx_distinct(l_orderkey) d, "
               "geometric_mean(l_extendedprice) gm, checksum(l_partkey) ck "
               "from lineitem group by 1 order by 1",
    "li_hll": "select l_returnflag, approx_distinct(l_orderkey) d "
              "from lineitem group by 1 order by 1",
}
# the statements, one sequence a run: CTAS into a fresh memory catalog,
# INSERT of one more slice, DELETE, a view read back, DROPs
STATEMENTS = [
    ("ctas", "create table mem.li_agg as select l_orderkey, "
             "sum(l_quantity) q from tpch.lineitem group by l_orderkey"),
    ("insert", "insert into mem.li_agg select l_orderkey, sum(l_quantity) q "
               "from tpch.lineitem where l_shipdate >= date '1998-08-01' "
               "group by l_orderkey"),
    ("delete", "delete from mem.li_agg where q > 200"),
    ("view", "create view big_orders as select l_orderkey, q "
             "from mem.li_agg where q > 150"),
    ("read_back", "select count(*) n, sum(q) s, min(l_orderkey) lo "
                  "from big_orders"),
    ("drop_view", "drop view big_orders"),
    ("drop_table", "drop table mem.li_agg"),
]
HLL_RTOL = 0.05  # approx_distinct against the exact count
GM_RTOL = 1e-9  # geometric_mean: a sum of logs in another order


def surface_oracles(conn):
    """Each SURFACE query's and statement's expected result from the
    generated tables (dictionary values, unscaled integers) with numpy and
    pandas; li_aggs and li_hll give their exact distinct counts, which
    approx_distinct is held to within HLL_RTOL."""
    import re as _re

    import numpy as np
    import pandas as pd

    def table(name):
        conn.get_table(name)
        return conn.tables[name]

    def text(t, col):
        return t.dicts[col].values[t.arrays[col]]

    cu, pa, od, li = (table(n) for n in ("customer", "part", "orders",
                                         "lineitem"))
    out = {}
    seg = pd.DataFrame({"seg": pd.Series(text(cu, "c_mktsegment")).str.upper(),
                        "ln": pd.Series(text(cu, "c_name")).str.len()})
    g = seg.groupby("seg", sort=True)
    out["upper_length"] = pd.DataFrame({
        "seg": g.size().index.to_list(), "n": g.size().to_list(),
        "ln": g["ln"].sum().to_list()})
    cc = pd.Series(text(cu, "c_phone")).str[:2] + "-"
    vc = cc.value_counts().sort_index()
    out["phone_prefix"] = pd.DataFrame({"cc": vc.index.to_list(),
                                        "n": vc.to_list()})
    pt = pd.DataFrame({
        "t": [s.split(" ")[1] for s in text(pa, "p_type")],
        "rl": [_re.search("^[a-f]", s) is not None
               for s in text(pa, "p_name")]})
    g = pt.groupby("t", sort=True)
    out["type_word_regexp"] = pd.DataFrame({
        "t": g.size().index.to_list(), "n": g.size().to_list(),
        "rl": g["rl"].sum().to_list()})
    types = text(pa, "p_type")
    m = (types >= "PROMO") & (types <= "PROMOZ")
    out["promo_range"] = pd.DataFrame({
        "n": [int(m.sum())], "s": [int(pa.arrays["p_size"][m].sum())]})
    order = np.argsort(od.arrays["o_orderkey"])
    pos = np.searchsorted(od.arrays["o_orderkey"][order],
                          li.arrays["l_orderkey"])
    ostat = text(od, "o_orderstatus")[order][pos]
    out["status_columns"] = pd.DataFrame({
        "n": [int((text(li, "l_linestatus") != ostat).sum())]})
    keep = od.arrays["o_orderdate"] >= _days(1998, 1, 1)
    out["orderkey_text"] = pd.DataFrame({
        "k": [str(int(k)) for k in od.arrays["o_orderkey"][keep]]})
    clerk = np.array([int(s[6:]) for s in od.dicts["o_clerk"].values])[
        od.arrays["o_clerk"]]
    out["clerk_number"] = pd.DataFrame({"s": [int(clerk.sum())],
                                        "lo": [int((clerk < 500).sum())]})
    out["no_from"] = pd.DataFrame({"x": [3], "s": ["xy"]})
    flag = text(li, "l_returnflag")
    ep = li.arrays["l_extendedprice"].astype(np.float64) * (1.0 / 100)
    with np.errstate(over="ignore"):
        h = li.arrays["l_partkey"].astype(np.int64) * np.int64(
            -7070675565921424023)
        h ^= h >> 31
    rows = []
    for f in sorted(set(flag)):
        sel = flag == f
        rows.append({"l_returnflag": f,
                     "d": len(np.unique(li.arrays["l_orderkey"][sel])),
                     "gm": float(np.exp(np.log(ep[sel]).mean())),
                     "ck": int(h[sel].sum(dtype=np.int64))})
    out["li_aggs"] = pd.DataFrame(rows)
    out["li_hll"] = out["li_aggs"][["l_returnflag", "d"]]
    q = pd.Series(li.arrays["l_quantity"]).groupby(
        li.arrays["l_orderkey"]).sum()
    late = li.arrays["l_shipdate"] >= _days(1998, 8, 1)
    q2 = pd.Series(li.arrays["l_quantity"][late]).groupby(
        li.arrays["l_orderkey"][late]).sum()
    both = pd.concat([q, q2])
    kept = both[both <= 200]
    big = kept[kept > 150]
    out["statements"] = {
        "ctas": len(q), "insert": len(q2),
        "delete": int((both > 200).sum()), "view": 0,
        "read_back": pd.DataFrame({"n": [len(big)], "s": [int(big.sum())],
                                   "lo": [int(big.index.min())]}),
        "drop_view": 0, "drop_table": 0}
    return out


def check_surface(name, got, want, label) -> None:
    """Exact, but approx_distinct within HLL_RTOL of the exact count and
    geometric_mean to GM_RTOL."""
    import numpy as np

    if name not in ("li_aggs", "li_hll"):
        frames_equal(got, want, label)
        return
    require(list(got.columns) == list(want.columns)
            and len(got) == len(want), f"{label}: shape differs")
    require(list(got["l_returnflag"]) == list(want["l_returnflag"]),
            f"{label}: groups differ")
    err = np.abs(got["d"].to_numpy(np.float64) / want["d"].to_numpy() - 1)
    require(err.max() <= HLL_RTOL, f"{label}: approx_distinct off by "
            f"{err.max():.4f} of the exact count")
    if name == "li_aggs":
        require(np.allclose(got["gm"].to_numpy(np.float64), want["gm"],
                            rtol=GM_RTOL, atol=0),
                f"{label}: geometric_mean differs")
        require(list(got["ck"]) == list(want["ck"]), f"{label}: checksum "
                "differs")


def run_statements(torch, runner, want=None, label="", each=None):
    """One pass of STATEMENTS: name -> (seconds, frame, what `each` gave).
    `each(run)` runs one statement and returns (frame, extra); each `rows`
    count, and the read-back frame, are held to `want` when given."""
    out = {}
    for name, sql in STATEMENTS:
        def run(sql=sql):
            return runner.run(sql)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df, extra = (run(), None) if each is None else each(run)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0, df, extra)
        if want is None:
            continue
        if name == "read_back":
            frames_equal(df, want[name], f"{label} {name}")
        else:
            require(list(df["rows"]) == [want[name]],
                    f"{label} {name}: {list(df['rows'])} rows, "
                    f"want {want[name]}")
    return out


def phase_surface(torch, cat, errs):
    """The SQL surface beyond TPC-H and TPC-DS on the TPC-H SF 1 catalog,
    with a fresh memory catalog `mem` as the CTAS/INSERT target: each
    SURFACE query and the STATEMENTS sequence under auto and hash, held to
    surface_oracles; launches of the first run (counts reset just before,
    read just after; under hash group_insert must launch on li_hll's and
    the CTAS's GROUP BY), warm median of 3 after it, and the device time
    of one more run. One more run under hash records each kernel's largest
    input, held to its contract (`check_recorded`). At SF 0.01 every
    query and statement gives the same frames on the card as on the CPU
    (geometric_mean to GM_RTOL: its sum of logs adds in each device's
    order). Prints a `surface` JSON line."""
    from presto_tpu_torch.catalog.memory import MemoryConnector
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    conn = cat.connectors["tpch"]
    want = surface_oracles(conn)
    print(f"surface: oracles ready in {time.perf_counter() - t0:.1f} s")
    cat.register("mem", MemoryConnector())
    runners = {e: LocalRunner(cat, ExecConfig(breaker_engine=e))
               for e in ENGINES}
    summary = []

    def report(name, eng, first_launches, warm, dev, rows):
        summary.append({"statement": name, "engine": eng, "rows": rows,
                        "warm_ms": warm * 1e3, "launches": first_launches,
                        "busy": dev["device_ms"] / (warm * 1e3), **dev})
        print(f"surface {name} {eng} SF {SF}: {rows} rows; warm median of 3 "
              f"{warm * 1e3:.1f} ms; launches {json.dumps(first_launches)}; "
              f"device time of one run {dev['device_ms']:.2f} ms "
              f"({dev['device_ms'] / warm / 10:.1f} % of the warm median); "
              f"largest {json.dumps(dev['top'])}")

    for name, sql in SURFACE.items():
        for eng in ENGINES:
            reset_launch_counts()
            out = runners[eng].run(sql)
            torch.cuda.synchronize()
            launches = {k: v for k, v in launch_counts().items() if v}
            check_surface(name, out, want[name], f"surface {name} {eng}")
            if name == "li_hll" and eng == "hash":
                require(launches.get("group_insert", 0) > 0,
                        "surface li_hll hash: group_insert did not launch")
            again, warm = timed_runs(torch, runners[eng], sql)
            check_surface(name, again, want[name], f"surface {name} {eng} "
                          "warm")
            dev = device_profile(torch, lambda: runners[eng].run(sql))
            report(name, eng, launches, warm, dev, len(out))

    def counted(run):
        reset_launch_counts()
        df = run()
        torch.cuda.synchronize()
        return df, {k: v for k, v in launch_counts().items() if v}

    def profiled(run):
        box = {}
        dev = device_profile(torch, lambda: box.setdefault("df", run()))
        return box["df"], dev

    for eng in ENGINES:
        label = f"surface statements {eng}"
        first = run_statements(torch, runners[eng], want["statements"],
                               label, counted)
        passes = [run_statements(torch, runners[eng], want["statements"],
                                 label) for _ in range(3)]
        prof = run_statements(torch, runners[eng], want["statements"],
                              label, profiled)
        if eng == "hash":
            require(first["ctas"][2].get("group_insert", 0) > 0,
                    "surface ctas hash: group_insert did not launch")
        for name, _ in STATEMENTS:
            report(f"statement_{name}", eng, first[name][2],
                   statistics.median(p[name][0] for p in passes),
                   prof[name][2], len(first[name][1]))

    inputs = record_run(torch, lambda: (
        [runners["hash"].run(q) for q in SURFACE.values()],
        run_statements(torch, runners["hash"])))
    done = check_recorded(torch, inputs, errs)
    print(f"surface hash SF {SF}: each kernel's largest input holds its "
          f"contract: {json.dumps(done)}")

    small = tpch_catalog(SMALL_SF)
    small.register("mem", MemoryConnector())
    same = 0
    for eng in ENGINES:
        cfg = ExecConfig(breaker_engine=eng)
        on_gpu, on_cpu = LocalRunner(small, cfg), LocalRunner(
            small, cfg, device="cpu")
        for name, sql in SURFACE.items():
            # geometric_mean sums logs in the order each device adds them
            columns_equal(on_gpu.run(sql), on_cpu.run(sql),
                          f"surface {name} {eng} SF {SMALL_SF} card vs CPU",
                          rtol=GM_RTOL)
            same += 1
        gpu = run_statements(torch, on_gpu)
        cpu = run_statements(torch, on_cpu)
        for name, _ in STATEMENTS:
            require(gpu[name][1].equals(cpu[name][1]),
                    f"surface statement {name} {eng} SF {SMALL_SF}: card "
                    "and CPU differ")
            same += 1
    print(f"surface SF {SMALL_SF}: {same} runs equal on the card and the "
          f"CPU (exact; geometric_mean to {GM_RTOL})")
    del cat.connectors["mem"]
    print(f"surface: phase took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"surface": summary}))


# ---------------------------------------------------------------------------
# phase 3b'': index joins, ARRAY/MAP values, lambdas, the built aggregates
# and geometry

Q6_WHERE = ("l_shipdate >= date '1994-01-01' "
            "and l_shipdate < date '1995-01-01' "
            "and l_discount between 0.05 and 0.07 and l_quantity < 24")
LINE_MAPS = ("(select l_orderkey, map_agg(l_linenumber, l_quantity) m "
             "from tpch.lineitem group by l_orderkey) t")
GEO_POINTS = 1_000_000  # points of the spatial join (10,000 at SF 0.01)
GEO_ZONES = 64
GEO_SEED = 20261017
GEO_RTOL = 1e-9  # float sums over a million rows, in another order
SKETCH_RANK = 0.02  # the t-digest median's rank, off 0.5 by at most this
# name -> the statements one run of it executes, in order; each query is
# held to its oracle, and the ARRAY and MAP columns that cust_arrays and
# line_maps store by CTAS element by element (`check_stored`). Catalogs:
# tpch (the TPC-H tables), idx (orders, and orders of 1994, indexed on
# o_orderkey), mem (the CTAS targets), geo (points and zones).
STRUCTURAL = {
    "ix_inner": [
        "select o_orderpriority, count(*) n, "
        "sum(l_extendedprice * l_discount) revenue "
        "from tpch.lineitem join idx.orders on l_orderkey = o_orderkey "
        f"where {Q6_WHERE} group by o_orderpriority order by o_orderpriority"],
    "ix_left": [
        "select count(*) n, count(o_totalprice) nt, sum(o_totalprice) st "
        "from tpch.lineitem left join idx.orders_1994 "
        f"on l_orderkey = o_orderkey where {Q6_WHERE}"],
    "cust_arrays": [
        "drop table if exists mem.cust_arrays",
        "create table mem.cust_arrays as select o_custkey, "
        "array_agg(o_orderkey) ks, array_agg(o_totalprice) ps "
        "from tpch.orders group by o_custkey",
        "select count(*) n, sum(cardinality(ks)) nk, sum(array_max(ps)) top, "
        "count_if(contains(ks, 7)) has7, sum(array_sort(ks)[1]) firsts, "
        "sum(cardinality(slice(ks, 2, 3))) sliced, "
        "sum(cardinality(array_distinct(transform(ks, k -> k % 4)))) mods, "
        "sum(cardinality(filter(ks, k -> k % 2 = 0))) evens, "
        "sum(reduce(ks, 0, (s, k) -> s + k)) ksum, "
        "sum(array_max(zip_with(ks, ps, (k, p) -> k))) lastk, "
        "sum(ks[1]) k1, sum(ps[1]) p1, sum(element_at(ps, -1)) plast "
        "from mem.cust_arrays"],
    "unnest_back": [
        "select count(*) n, sum(k) sk, sum(o) so, max(o) mo "
        "from mem.cust_arrays cross join unnest(ks) with ordinality "
        "as u(k, o)"],
    "line_maps": [
        "select count(*) n, sum(cardinality(m)) nm, sum(element_at(m, 1)) q1, "
        "count(element_at(m, 7)) n7, sum(cardinality(map_keys(m))) nk, "
        "sum(cardinality(map_filter(m, (k, v) -> v > 25))) big, "
        "sum(element_at(transform_values(m, (k, v) -> k * 10), 2)) t2 "
        f"from {LINE_MAPS}",
        "select count(*) n, sum(k) sk, sum(v) sv "
        f"from {LINE_MAPS} cross join unnest(m) as u(k, v)",
        "drop table if exists mem.flag_maps",
        "create table mem.flag_maps as select l_orderkey, "
        "map_agg(l_returnflag, l_quantity) m from tpch.lineitem "
        "group by l_orderkey",
        "select count(*) n, sum(cardinality(m)) nm, "
        "sum(element_at(m, 'A')) qa, sum(element_at(m, 'N')) qn, "
        "sum(element_at(m, 'R')) qr, sum(map_values(m)[1]) v1, "
        "count_if(map_keys(m)[1] = 'N') k1n from mem.flag_maps"],
    "sketches": [
        "select l_returnflag, l_linestatus, count(*) n, "
        "cardinality(approx_set(l_partkey)) c, "
        "value_at_quantile(tdigest_agg(l_extendedprice), 0.5) med, "
        "numeric_histogram(20, l_extendedprice) h from tpch.lineitem "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"],
    "sketch_merge": [
        "drop table if exists mem.month_sets",
        "create table mem.month_sets as select "
        "year(l_shipdate) * 100 + month(l_shipdate) ym, "
        "approx_set(l_partkey) s from tpch.lineitem group by 1",
        "select count(*) months, cardinality(merge(s)) c "
        "from mem.month_sets"],
    "geo_join": [
        "select z.zone, count(*) n from geo.pts p, geo.zones z "
        "where st_contains(st_geometryfromtext(z.wkt), st_point(p.x, p.y)) "
        "group by z.zone order by z.zone"],
    "geo_metrics": [
        "select count(*) n, "
        "sum(st_distance(st_point(x, y), st_point(50, 50))) d, "
        "sum(great_circle_distance(y - 50, x - 50, 0, 0)) gc, "
        "sum(st_distance(st_geometryfromtext("
        "'POLYGON((40 40, 60 40, 60 60, 40 60, 40 40))'), st_point(x, y))) dp "
        "from geo.pts"],
}
# the statements whose index joins must launch join_insert and join_probe
# under hash
INDEX_STATEMENTS = ("ix_inner", "ix_left")
# unit -> the table it stores by CTAS and `check_stored` reads back
STORED = {"cust_arrays": "cust_arrays", "line_maps": "flag_maps"}


def geo_tables(n_points: int):
    """The spatial join's tables from GEO_SEED: points uniform in
    [0, 100)^2, and GEO_ZONES squares of side 5-20 inside [0, 100)^2 with
    two-decimal corners, every fourth with a centred square hole of half
    its side. Returns (points frame, zones frame, zone rings)."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(GEO_SEED)
    pts = pd.DataFrame({"id": np.arange(n_points),
                        "x": rng.uniform(0, 100, n_points),
                        "y": rng.uniform(0, 100, n_points)})
    side = np.round(rng.uniform(5, 20, GEO_ZONES), 2)
    x0 = np.round(rng.uniform(0, 100 - side), 2)
    y0 = np.round(rng.uniform(0, 100 - side), 2)

    def square(x, y, s):
        return [(x, y), (x + s, y), (x + s, y + s), (x, y + s), (x, y)]

    def text(ring):
        return "(" + ", ".join(f"{float(a)!r} {float(b)!r}"
                               for a, b in ring) + ")"

    rings, wkts = [], []
    for i in range(GEO_ZONES):
        rs = [square(x0[i], y0[i], side[i])]
        if i % 4 == 0:
            h = side[i] / 2
            rs.append(square(x0[i] + h / 2, y0[i] + h / 2, h))
        rings.append(rs)
        wkts.append("POLYGON(" + ", ".join(text(r) for r in rs) + ")")
    zones = pd.DataFrame({"zone": np.arange(GEO_ZONES), "wkt": wkts})
    return pts, zones, rings


def add_structural_catalogs(cat, n_points: int):
    """`cat` (a TPC-H catalog) with the catalogs STRUCTURAL reads: idx
    (orders, and orders_1994 made by CTAS, both indexed on o_orderkey),
    mem (empty) and geo (geo_tables). Returns (cat, (points, rings))."""
    from presto_tpu_torch import convert
    from presto_tpu_torch.catalog.memory import MemoryConnector
    from presto_tpu_torch.exec import LocalRunner

    conn = cat.connectors["tpch"]
    conn.get_table("orders")
    idx = convert.connector_from_tables({"orders": conn.tables["orders"]},
                                        name="idx")
    cat.register("idx", idx)
    cat.register("mem", MemoryConnector("mem"))
    LocalRunner(cat, device="cpu").run(
        "create table idx.orders_1994 as select * from tpch.orders "
        "where o_orderdate >= date '1994-01-01' "
        "and o_orderdate < date '1995-01-01'")
    for t in ("orders", "orders_1994"):
        idx.tables[t].index_keys = [["o_orderkey"]]
    pts, zones, rings = geo_tables(n_points)
    geo = MemoryConnector("geo")
    geo.add_table("pts", pts)
    geo.add_table("zones", zones)
    cat.register("geo", geo)
    return cat, (pts, rings)


def structural_oracles(conn, geo):
    """Each STRUCTURAL statement's expected result from the generated
    tables with numpy and pandas (name -> [frame or None a statement]);
    sketches and sketch_merge give exact distinct counts and each group's
    sorted values, which approx_set and the t-digest median are held to
    (`check_structural`)."""
    import numpy as np
    import pandas as pd
    from decimal import Decimal

    def table(name):
        conn.get_table(name)
        return conn.tables[name]

    def dec(v, scale):
        return Decimal(int(v)).scaleb(-scale).quantize(
            Decimal(1).scaleb(-scale))

    li, od = table("lineitem"), table("orders")
    la, oa = li.arrays, od.arrays
    out = {}
    m = ((la["l_shipdate"] >= _days(1994, 1, 1))
         & (la["l_shipdate"] < _days(1995, 1, 1))
         & (la["l_discount"] >= 5) & (la["l_discount"] <= 7)
         & (la["l_quantity"] < 24))
    order = np.argsort(oa["o_orderkey"])
    pos = order[np.searchsorted(oa["o_orderkey"][order],
                                la["l_orderkey"][m])]
    prio = od.dicts["o_orderpriority"].values[oa["o_orderpriority"][pos]]
    rev = la["l_extendedprice"][m] * la["l_discount"][m]
    f = pd.DataFrame({"p": prio, "r": rev}).groupby("p", sort=True)["r"]
    out["ix_inner"] = [pd.DataFrame({
        "o_orderpriority": f.size().index.to_list(),
        "n": f.size().to_list(), "revenue": [dec(v, 4) for v in f.sum()]})]
    d94 = ((oa["o_orderdate"][pos] >= _days(1994, 1, 1))
           & (oa["o_orderdate"][pos] < _days(1995, 1, 1)))
    out["ix_left"] = [pd.DataFrame({
        "n": [int(m.sum())], "nt": [int(d94.sum())],
        "st": [dec(oa["o_totalprice"][pos][d94].sum(), 2)]})]
    o = pd.DataFrame({"c": oa["o_custkey"], "k": oa["o_orderkey"],
                      "p": oa["o_totalprice"]})
    g = o.groupby("c")
    sizes = g.size()
    out["cust_arrays"] = [None, None, pd.DataFrame({
        "n": [len(sizes)], "nk": [int(sizes.sum())],
        "top": [dec(g["p"].max().sum(), 2)],
        "has7": [int((o["k"] == 7).sum())],
        "firsts": [int(g["k"].min().sum())],
        "sliced": [int(np.minimum(np.maximum(sizes - 1, 0), 3).sum())],
        "mods": [int((o["k"] % 4).groupby(o["c"]).nunique().sum())],
        "evens": [int((o["k"] % 2 == 0).sum())],
        "ksum": [int(o["k"].sum())], "lastk": [int(g["k"].max().sum())],
        "k1": [int(g["k"].first().sum())],
        "p1": [dec(g["p"].first().sum(), 2)],
        "plast": [dec(g["p"].last().sum(), 2)]})]
    out["unnest_back"] = [pd.DataFrame({
        "n": [int(sizes.sum())], "sk": [int(o["k"].sum())],
        "so": [int((sizes * (sizes + 1) // 2).sum())],
        "mo": [int(sizes.max())]})]
    lm = pd.DataFrame({"o": la["l_orderkey"], "k": la["l_linenumber"],
                       "v": la["l_quantity"]})
    first = lm.drop_duplicates(["o", "k"])
    per = first.groupby("o")
    fm = first_flags(li)
    head = fm.groupby("o").head(1)  # each map's first entry
    qf = fm.groupby("f")["v"].sum()
    out["line_maps"] = [pd.DataFrame({
        "n": [per.ngroups], "nm": [len(first)],
        "q1": [int(first["v"][first["k"] == 1].sum())],
        "n7": [int((first["k"] == 7).sum())], "nk": [len(first)],
        "big": [int((first["v"] > 25).sum())],
        "t2": [int(20 * (first["k"] == 2).sum())]}),
        pd.DataFrame({"n": [len(first)], "sk": [int(first["k"].sum())],
                      "sv": [int(first["v"].sum())]}),
        None, None,
        pd.DataFrame({"n": [len(head)], "nm": [len(fm)],
                      **{f"q{f.lower()}": [int(qf.get(f, 0))]
                         for f in "ANR"},
                      "v1": [int(head["v"].sum())],
                      "k1n": [int((head["f"] == "N").sum())]})]
    flag = li.dicts["l_returnflag"].values[la["l_returnflag"]]
    stat = li.dicts["l_linestatus"].values[la["l_linestatus"]]
    ep = la["l_extendedprice"] * (1.0 / 100)
    sk = pd.DataFrame({"f": flag, "s": stat, "p": la["l_partkey"], "e": ep})
    rows = []
    for (fv, sv), grp in sk.groupby(["f", "s"], sort=True):
        rows.append({"l_returnflag": fv, "l_linestatus": sv,
                     "n": len(grp), "c": grp["p"].nunique(),
                     "med": np.sort(grp["e"].to_numpy()),
                     "h": (len(grp), float(grp["e"].sum()),
                           float(grp["e"].min()), float(grp["e"].max()))})
    out["sketches"] = [pd.DataFrame(rows)]
    ym = np.unique(np.array([_year_month(int(d)) for d in
                             np.unique(la["l_shipdate"])]))
    out["sketch_merge"] = [None, None, pd.DataFrame({
        "months": [len(ym)], "c": [len(np.unique(la["l_partkey"]))]})]
    pts, rings = geo
    x, y = pts["x"].to_numpy(), pts["y"].to_numpy()
    counts = []
    for rs in rings:
        inside = np.zeros(len(x), bool)
        for ring in rs:  # even-odd over every ring's edges
            for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
                if y1 == y2:
                    continue
                straddle = (y1 > y) != (y2 > y)
                xc = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
                inside ^= straddle & (x < xc)
        counts.append(int(inside.sum()))
    zone = np.arange(GEO_ZONES)
    keep = np.array(counts) > 0
    out["geo_join"] = [pd.DataFrame({"zone": zone[keep],
                                     "n": np.array(counts)[keep]})]
    lat1, lon1 = np.radians(y - 50), np.radians(x - 50)
    a = (np.sin(-lat1 / 2) ** 2
         + np.cos(lat1) * np.sin(-lon1 / 2) ** 2)
    gc = 2 * 6371.01 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    dx = np.maximum(np.maximum(40 - x, 0), x - 60)
    dy = np.maximum(np.maximum(40 - y, 0), y - 60)
    out["geo_metrics"] = [pd.DataFrame({
        "n": [len(x)], "d": [float(np.hypot(x - 50, y - 50).sum())],
        "gc": [float(gc.sum())], "dp": [float(np.hypot(dx, dy).sum())]})]
    return out


def first_flags(li):
    """map_agg(l_returnflag, l_quantity) per order as rows of lineitem `li`:
    each order's first row of each return flag, in table order (map_agg
    keeps a key's first value), as (o, v, f) with the flag decoded."""
    import pandas as pd

    a = li.arrays
    fm = pd.DataFrame({"o": a["l_orderkey"], "v": a["l_quantity"],
                       "f": a["l_returnflag"]}).drop_duplicates(["o", "f"])
    return fm.assign(
        f=li.dicts["l_returnflag"].values[fm["f"].to_numpy()])


def stored_planes(conn):
    """What cust_arrays and line_maps store by CTAS, element by element,
    from the generated tables in table order: table -> (group key column,
    {column: (group keys ascending, sizes, elements in group order and
    within a group in input order, a map's decoded keys likewise or
    None)})."""
    import numpy as np

    def planes(keys, **cols):
        order = np.argsort(keys, kind="stable")
        gk, sizes = np.unique(keys, return_counts=True)
        return {c: (gk, sizes, v[order], None if k is None else k[order])
                for c, (v, k) in cols.items()}

    oa = conn.tables["orders"].arrays
    fm = first_flags(conn.tables["lineitem"])
    return {
        "cust_arrays": ("o_custkey", planes(
            oa["o_custkey"], ks=(oa["o_orderkey"], None),
            ps=(oa["o_totalprice"], None))),
        "flag_maps": ("l_orderkey", planes(
            fm["o"].to_numpy(), m=(fm["v"].to_numpy(), fm["f"].to_numpy()))),
    }


def check_stored(mem, table, want, label) -> None:
    """`table` as the memory connector `mem` holds it against its entry of
    `stored_planes`, element by element: the group keys, each row's size,
    every element's value and validity in order, and a map's keys."""
    import numpy as np

    from presto_tpu_torch.batch import key_dict_name

    key, cols = want
    t = mem.tables[table]
    ro = np.argsort(t.arrays[key], kind="stable")
    for col, (gk, sizes, vals, keys) in cols.items():
        where = f"{label}: {table}.{col}"
        got_sizes, evalid, kplane = t.struct[col]
        require(np.array_equal(t.arrays[key][ro], gk)
                and np.array_equal(got_sizes[ro], sizes),
                f"{where}: groups or sizes differ")
        w = t.arrays[col].shape[1]
        inside = np.arange(w)[None, :] < got_sizes[ro][:, None]
        require(np.array_equal(t.arrays[col][ro][inside], vals),
                f"{where}: elements differ")
        require(evalid is None or bool(evalid[ro][inside].all()),
                f"{where}: an element is NULL")
        if keys is not None:
            d = np.asarray(t.dicts[key_dict_name(col)].values)
            require(np.array_equal(d[kplane[ro][inside]], keys),
                    f"{where}: map keys differ")


def _year_month(days: int) -> int:
    import datetime

    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    return d.year * 100 + d.month


def check_structural(name, i, got, want, label) -> None:
    """Statement i of `name` against its oracle: exact, but approx_set
    within HLL_RTOL of the exact distinct count, the t-digest median at a
    rank within SKETCH_RANK of 0.5, numeric_histogram by its
    invariants (20 buckets ascending inside the group's range, counts
    summing to its rows, centres weighted by counts summing to its
    values to GEO_RTOL) and the geometry sums to GEO_RTOL."""
    import numpy as np

    if want is None:
        return
    if name in ("geo_metrics",):
        columns_equal(got, want, label, rtol=GEO_RTOL)
        return
    if name not in ("sketches", "sketch_merge"):
        frames_equal(got, want, label)
        return
    require(list(got.columns) == list(want.columns)
            and len(got) == len(want), f"{label}: shape differs")
    for c in got.columns:
        g, w = list(got[c]), list(want[c])
        if c == "c":
            err = max(abs(a / b - 1) for a, b in zip(g, w))
            require(err <= HLL_RTOL, f"{label}: approx_set cardinality "
                    f"off by {err:.4f} of the exact count")
        elif c == "med":
            for med, vals in zip(g, w):
                lo = np.searchsorted(vals, med, "left") / len(vals)
                hi = np.searchsorted(vals, med, "right") / len(vals)
                require(lo <= 0.5 + SKETCH_RANK and hi >= 0.5 - SKETCH_RANK,
                        f"{label}: t-digest median {med} at rank "
                        f"[{lo:.4f}, {hi:.4f}]")
        elif c == "h":
            for hist, (n, total, lo, hi) in zip(g, w):
                keys = list(hist)
                cnts = [hist[k] for k in keys]
                require(len(keys) == min(20, n) and keys == sorted(keys)
                        and lo <= keys[0] and keys[-1] <= hi
                        and sum(cnts) == n
                        and np.isclose(sum(k * v for k, v in hist.items()),
                                       total, rtol=GEO_RTOL, atol=0),
                        f"{label}: numeric_histogram breaks its "
                        "invariants")
        else:
            require(g == w, f"{label}: column {c} differs: {g[:4]} vs "
                    f"{w[:4]}")


def run_unit(torch, runner, sqls, each=None):
    """The statements of one STRUCTURAL entry, in order: (seconds, frames,
    what `each(run)` gave for the whole sequence)."""
    def run():
        return [runner.run(sql) for sql in sqls]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, extra = (run(), None) if each is None else each(run)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, frames, extra


def phase_structural(torch, cat, errs):
    """Index joins, ARRAY/MAP values, lambdas, the built aggregates and
    geometry on the TPC-H SF 1 catalog (plus idx, mem and geo,
    `add_structural_catalogs`): each STRUCTURAL entry under auto and hash,
    every statement held to structural_oracles and each STORED table to
    stored_planes; launches of the first run
    (counts reset just before, read just after; under hash the index
    joins must launch join_insert and join_probe), warm median of 3 after
    it, and the device time of one more run. One more run under hash
    records each kernel's largest input, held to its contract
    (`check_recorded`). At SF 0.01 (10,000 points) every statement gives
    the same frames on the card as on the CPU (float sums to GEO_RTOL).
    Prints a `structural` JSON line; returns the first runs' launches
    under hash, summed."""
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    _, geo = add_structural_catalogs(cat, GEO_POINTS)
    t1 = time.perf_counter()
    want = structural_oracles(cat.connectors["tpch"], geo)
    stored = stored_planes(cat.connectors["tpch"])
    t2 = time.perf_counter()
    idx = cat.connectors["idx"]
    handles = [idx.get_table(t) for t in ("orders", "orders_1994")]
    t3 = time.perf_counter()
    for h in handles:  # build each index's sorted codes
        idx.get_index(h, ["o_orderkey"]).lookup(
            {"o_orderkey": [1]}, ["o_orderkey"])
    print(f"structural: catalogs {t1 - t0:.1f} s, oracles {t2 - t1:.1f} s, "
          f"index tables' statistics {t3 - t2:.2f} s, index builds "
          f"{time.perf_counter() - t3:.2f} s (set-up); "
          f"{int(want['ix_left'][0]['n'][0])} probe rows, "
          f"{idx.tables['orders_1994'].num_rows} orders of 1994, "
          f"{int(want['cust_arrays'][2]['n'][0])} customers' arrays of "
          f"{int(want['unnest_back'][0]['mo'][0])} at most, "
          f"{int(want['line_maps'][0]['n'][0])} maps, "
          f"{len(geo[0])} points")
    runners = {e: LocalRunner(cat, ExecConfig(breaker_engine=e))
               for e in ENGINES}
    summary = []
    hash_launches = {}

    def counted(run):
        reset_launch_counts()
        df = run()
        torch.cuda.synchronize()
        return df, {k: v for k, v in launch_counts().items() if v}

    def profiled(run):
        box = {}
        dev = device_profile(torch, lambda: box.setdefault("df", run()))
        return box["df"], dev

    def check(name, frames, label):
        for i, (got, w) in enumerate(zip(frames, want[name])):
            check_structural(name, i, got, w, f"{label} statement {i}")

    for name, sqls in STRUCTURAL.items():
        for eng in ENGINES:
            label = f"structural {name} {eng}"
            _, frames, launches = run_unit(torch, runners[eng], sqls,
                                           counted)
            check(name, frames, label)
            if name in STORED:
                t4 = time.perf_counter()
                check_stored(cat.connectors["mem"], STORED[name],
                             stored[STORED[name]], label)
                print(f"{label}: mem.{STORED[name]} equals the generated "
                      "tables element by element (checked in "
                      f"{time.perf_counter() - t4:.2f} s)")
            if eng == "hash":
                for k, v in launches.items():
                    hash_launches[k] = hash_launches.get(k, 0) + v
                if name in INDEX_STATEMENTS:
                    for k in ("join_insert", "join_probe"):
                        require(launches.get(k, 0) > 0,
                                f"{label}: {k} did not launch")
            passes = [run_unit(torch, runners[eng], sqls) for _ in range(3)]
            for _, frames, _ in passes:
                check(name, frames, f"{label} warm")
            warm = statistics.median(p[0] for p in passes)
            _, frames, dev = run_unit(torch, runners[eng], sqls, profiled)
            rows = len(frames[-1])
            summary.append({"statement": name, "engine": eng, "rows": rows,
                            "warm_ms": warm * 1e3, "launches": launches,
                            "busy": dev["device_ms"] / (warm * 1e3), **dev})
            print(f"structural {name} {eng} SF {SF}: {rows} rows; warm "
                  f"median of 3 {warm * 1e3:.1f} ms; launches "
                  f"{json.dumps(launches)}; device time of one run "
                  f"{dev['device_ms']:.2f} ms ({dev['device_ms'] / warm / 10:.1f}"
                  f" % of the warm median); largest {json.dumps(dev['top'])}")

    inputs = record_run(torch, lambda: [
        run_unit(torch, runners["hash"], sqls)
        for sqls in STRUCTURAL.values()])
    done = check_recorded(torch, inputs, errs)
    print(f"structural hash SF {SF}: each kernel's largest input holds its "
          f"contract: {json.dumps(done)}")

    small, _ = add_structural_catalogs(tpch_catalog(SMALL_SF),
                                       GEO_POINTS // 100)
    same = 0
    for eng in ENGINES:
        cfg = ExecConfig(breaker_engine=eng)
        on_gpu, on_cpu = LocalRunner(small, cfg), LocalRunner(
            small, cfg, device="cpu")
        for name, sqls in STRUCTURAL.items():
            _, gpu, _ = run_unit(torch, on_gpu, sqls)
            _, cpu, _ = run_unit(torch, on_cpu, sqls)
            for i, (g, c) in enumerate(zip(gpu, cpu)):
                columns_equal(g, c, f"structural {name} {eng} statement {i} "
                              f"SF {SMALL_SF} card vs CPU", rtol=GEO_RTOL)
                same += 1
    print(f"structural SF {SMALL_SF}: {same} statements equal on the card "
          f"and the CPU (exact; float sums to {GEO_RTOL})")
    for c in ("idx", "mem", "geo"):
        del cat.connectors[c]
    print(f"structural: phase took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"structural": summary}))
    return hash_launches


# ---------------------------------------------------------------------------
# phase 3b''': memory-bounded execution

# a fanout multiway leg: customer's orders (TPC-H gives some customers
# dozens), LEFT so that only exact counts (hash) run it in one pass
MW_FANOUT = ("select c.c_custkey, o.o_orderkey, n.n_name from customer c "
             "left join orders o on c.c_custkey = o.o_custkey "
             "left join nation n on c.c_nationkey = n.n_nationkey")
# outside grace_default the memory phase times a unit's first entry under
# hash (warm median of 3, the device time of one more run) and each other
# entry under hash whose first run took under this many seconds
WARM_LIMIT_S = 1.5
# Q18's inner aggregate (the repo's Q18 text): 1.5 M groups at SF 1
Q18_INNER = ("select l_orderkey, sum(l_quantity) as total_qty from lineitem "
             "group by l_orderkey having sum(l_quantity) > 250")
SPILL_STATS = ("spill.partitions", "spill.repartitions", "spill.revocations",
               "spill.role_reversals", "spill.bytes", "spill.rows",
               "radix.partitions_spilled", "multiway.cascade_fallbacks")


def memory_units(pool, sf):
    """unit -> [(label, query, config, base config)]: `query` names a TPC-H
    query of the port's texts, MW_FANOUT or Q18_INNER; each run is held to
    the same query under `base` (and to its oracle where there is one).
    At SF 1 the radix unit leaves out Q9 with 8 partitions and Q18 with
    every partition spilled (the longest runs of the unit; they run at SF
    0.01)."""
    grace = [(q, q, {}, {"spill_enabled": False}) for q in ("q18", "q13")]
    # Q3 takes two spill partitions, so that its spilled build
    # repartitions. Q18's aggregate (GRACE, 1.5 M groups) replays group
    # tables of up to 2^17 groups, 2^18 slots under hash, which the pool
    # accounts: it gets the whole build's bytes (with two partitions it
    # would split six levels down: a split takes the next bits of the JAX
    # package's host hash, which for one integer key is the key itself,
    # and bits 3 and 4 of every TPC-H order key are 0)
    radix8 = {"radix_partitions": 8}
    forced = {"radix_partitions": 4, "join_spill_budget_bytes": 1}
    mw = {"join_mode": "multiway"}
    return {
        "grace_default": grace,
        "pool_spill": [("q3", "q3", {"memory_pool_bytes": pool,
                                     "spill_partitions": 2}, {}),
                       ("q18_inner", "q18_inner",
                        {"memory_pool_bytes": 2 * pool}, {})],
        "radix": ([(f"{q}_radix8", q, radix8, {})
                   for q in ("q3", "q5", "q9", "q18")
                   if not (q == "q9" and sf == SF)]
                  + [(f"{q}_forced_spill", q, forced, {})
                     for q in ("q3", "q18")
                     if not (q == "q18" and sf == SF)]),
        "multiway": [(q, q, mw, {"join_mode": "off"})
                     for q in ("q2", "q3", "q5", "q7", "q8", "q9", "q10",
                               "mw_fanout")],
    }


def memory_sql(q, sf):
    from presto_tpu_torch.catalog.tpch_queries import QUERIES as TPCH

    if q == "mw_fanout":
        return MW_FANOUT
    if q == "q18_inner":
        return Q18_INNER
    return at_scale(q, TPCH[q], sf)


def q18_inner_oracle(conn):
    import numpy as np
    import pandas as pd

    conn.get_table("lineitem")
    a = conn.tables["lineitem"].arrays
    qty = pd.Series(a["l_quantity"]).groupby(a["l_orderkey"]).sum()
    big = qty[qty > 250]  # l_quantity is BIGINT
    return pd.DataFrame({"l_orderkey": big.index.to_numpy(np.int64),
                         "total_qty": big.to_numpy(np.int64)})


def largest_build_bytes(runner, sql):
    """batch_device_bytes of the largest build side of the query's hash
    joins, each built once on the card."""
    from presto_tpu_torch.exec.runtime import ExecContext, execute_node
    from presto_tpu_torch.memory import batch_device_bytes
    from presto_tpu_torch.plan.nodes import HashJoin

    best = 0

    def walk(n):
        nonlocal best
        if isinstance(n, HashJoin):
            ctx = ExecContext(runner.catalog, runner.config, runner.device)
            best = max(best, sum(batch_device_bytes(b)
                                 for b in execute_node(n.right, ctx)))
        for c in n.children():
            walk(c)

    walk(runner.plan(sql).root)
    return best


def phase_memory(torch, cat, errs):
    """Memory-bounded execution on the TPC-H SF 1 catalog, each unit of
    `memory_units` under auto and hash, spilling into a directory under
    the run's root that must be empty after every run (every spill file
    closed and unlinked) and is removed at the end:
    - grace_default: Q18 and Q13 under the default config take GRACE
      (`spill.partitions` > 0) and equal the same queries with spill off
      (in-memory growth) and their oracles; both walls printed;
    - pool_spill: Q3 under a pool of half its largest build
      (`largest_build_bytes`) and two spill partitions (its build spills
      and repartitions), Q18's inner aggregate (GRACE) under a pool of the
      whole build; equal to the default runs and the oracles; the same
      pool with spill off raises ExceededMemoryLimit on Q3;
    - radix: Q3, Q5 and Q18 with 8 radix partitions, Q3 with 4 and a
      1-byte budget (every partition spills), and at SF 0.01 also Q9 with
      8 and Q18 with every partition spilled: equal to the default runs;
    - multiway: Q2, Q3, Q5, Q7, Q8, Q9, Q10 and MW_FANOUT under
      join_mode=multiway equal join_mode=off; the phase prints which
      plans show a MultiwayJoin (the JAX package's rule collapses a
      left-deep chain; which queries give one depends on the plan at
      this scale) and requires MW_FANOUT and at least one TPC-H query
      among them; MW_FANOUT under hash runs one pass whose fanout leg
      launches join_probe up a ladder from F = 16, under auto it falls
      back to the binary cascade; join_probe is then checked against its
      plain version at the largest F reached (`join_probe_case`).
    Per run: the first run (its launches, counts reset just before it and
    read just after; under hash each kernel's largest input recorded), and
    spill.* with the bytes and rows spilled; then, in grace_default under
    both engines and elsewhere under hash for a unit's first entry and
    where the first run took under WARM_LIMIT_S, the warm median of 3 and
    the device time of one more run (torch.profiler) over it, the busy
    share. The largest inputs of the hash first runs are held to their
    contracts. At SF 0.01 every entry's configuration gives the same
    frames on the card and the CPU. Prints the seconds each unit took, a
    `memory` JSON line; returns the first runs' launches under hash,
    summed."""
    import shutil
    import tempfile

    import numpy as np

    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts
    from presto_tpu_torch.memory import ExceededMemoryLimit
    from presto_tpu_torch.ops import hash_kernels as hk

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    spill_dir = tempfile.mkdtemp(prefix=".spill-", dir=root)
    conn = cat.connectors["tpch"]
    oracles = {"q3": oracle(conn, "q3"), "q18_inner": q18_inner_oracle(conn)}
    oracles.update({q: oracle22(conn, q) for q in ("q13", "q18")})
    pool = largest_build_bytes(
        LocalRunner(cat, ExecConfig()), memory_sql("q3", SF)) // 2
    units = memory_units(pool, SF)
    print(f"memory: oracles and Q3's largest build ready in "
          f"{time.perf_counter() - t0:.1f} s; pool of {pool} bytes (half "
          f"of it); spill directory {os.path.basename(spill_dir)}")
    ladder = []  # the fanouts join_probe launched at
    real_probe = hk._join_probe_cuda

    def probe_at(*args):
        ladder.append(args[-1])
        return real_probe(*args)

    def runner(cfg, eng, sf_cat=cat, device=None):
        return LocalRunner(sf_cat, ExecConfig(breaker_engine=eng,
                                              spill_dir=spill_dir, **cfg),
                           device=device)

    def no_spill_left(label):
        left = os.listdir(spill_dir)
        require(not left, f"{label}: spill files left: {left[:4]}")

    summary = []
    hash_launches = {}
    largest = {}  # kernel -> (size, arguments): its largest input
    collapsed = set()  # the multiway runs whose plan has a MultiwayJoin
    frames = {}  # (sql, engine, config) -> the frame of its first run

    def config_key(sql, eng, cfg):
        return sql, eng, tuple(sorted(cfg.items()))

    unit_s = {}  # unit -> seconds of the SF 1 runs
    try:
        for unit, entries in units.items():
            t_unit = time.perf_counter()
            for label, q, cfg, base_cfg in entries:
                sql = memory_sql(q, SF)
                for eng in ENGINES:
                    name = f"memory {unit} {label} {eng}"
                    r = runner(cfg, eng)
                    key = config_key(sql, eng, base_cfg)
                    base_runner = runner(base_cfg, eng)
                    if key not in frames:
                        frames[key] = base_runner.run(sql)
                        no_spill_left(f"{name} base")
                    base = frames[key]
                    if label == "mw_fanout":
                        hk._join_probe_cuda = probe_at
                    # the first run; under hash each kernel's inputs
                    # recorded
                    box = {}
                    reset_launch_counts()
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    try:
                        if eng == "hash":
                            inputs = record_run(torch, lambda: box.update(
                                out=r.run(sql)))
                            for k, (size, args) in inputs.items():
                                if size > largest.get(k, (0, None))[0]:
                                    largest[k] = (size, args)
                            del inputs
                        else:
                            box["out"] = r.run(sql)
                            torch.cuda.synchronize()
                    finally:
                        hk._join_probe_cuda = real_probe
                    first = time.perf_counter() - t1
                    out = box["out"]
                    launches = {k: v for k, v in launch_counts().items()
                                if v}
                    frames.setdefault(config_key(sql, eng, cfg), out)
                    stats = {k: r.last_stats.get(k, 0) for k in SPILL_STATS}
                    no_spill_left(name)
                    if eng == "hash":
                        for k, v in launches.items():
                            hash_launches[k] = hash_launches.get(k, 0) + v
                    keys = ORDER_KEYS.get(q)
                    how = frames_agree(out, base, keys, f"{name} vs base")
                    if q in ORDER_KEYS and q in oracles:
                        check_oracle(out, oracles[q], q, f"{name} oracle")
                    elif q in oracles:
                        frames_agree(out, oracles[q], None, f"{name} oracle")
                    check_memory_unit(unit, label, eng, r, sql, stats,
                                      launches, collapsed)
                    if unit == "pool_spill" and label == "q3":
                        try:
                            runner(dict(cfg, spill_enabled=False),
                                   eng).run(sql)
                        except ExceededMemoryLimit as e:
                            print(f"{name}: spill off under the pool "
                                  f"raised ExceededMemoryLimit ({e})")
                        else:
                            raise CheckFailed(f"{name}: spill off under the "
                                              "pool did not raise")
                        no_spill_left(f"{name} spill off")
                    # timed: GRACE (the default path) under both engines,
                    # the other units under hash: the first entry, and
                    # the others where a run takes under WARM_LIMIT_S (the
                    # script's time limit)
                    warm, dev = None, {}
                    if unit == "grace_default" or eng == "hash" and (
                            label == entries[0][0] or first < WARM_LIMIT_S):
                        again, warm = warm_runs(torch, r, sql)
                        frames_agree(again, out, keys, f"{name} rerun")
                        dev = device_profile(torch, lambda: r.run(sql))
                        no_spill_left(f"{name} warm")
                    summary.append({
                        "unit": unit, "run": label, "engine": eng,
                        "rows": len(out),
                        "warm_ms": None if warm is None else warm * 1e3,
                        "first_ms": first * 1e3, "launches": launches,
                        "busy": (None if warm is None
                                 else dev["device_ms"] / (warm * 1e3)),
                        "stats": stats, **dev})
                    timing = ("" if warm is None else
                              f"; warm median of 3 {warm * 1e3:.1f} ms; "
                              f"device time of one more run "
                              f"{dev['device_ms']:.2f} ms, busy "
                              f"{dev['device_ms'] / warm / 10:.1f} %")
                    print(f"{name} SF {SF}: {len(out)} rows, {how} to the "
                          f"base run{'; equal to the oracle' if q in oracles else ''}"
                          f"; first run {first * 1e3:.1f} ms{timing}; "
                          f"launches {json.dumps(launches)}; "
                          f"{json.dumps(stats)}")
                    if unit == "grace_default":
                        # the base run (spill off) warmed its runner
                        _, off_warm = warm_runs(torch, base_runner, sql)
                        summary[-1]["spill_off_warm_ms"] = off_warm * 1e3
                        print(f"{name} SF {SF}: GRACE {warm * 1e3:.1f} ms "
                              f"against {off_warm * 1e3:.1f} ms in memory "
                              "(spill off), warm medians of 3")
            unit_s[unit] = time.perf_counter() - t_unit
            print(f"memory {unit}: {unit_s[unit]:.1f} s at SF {SF}")
        # which chains the JAX package's rule collapses depends on the
        # plan's shape at this scale (a right-deep chain stays binary)
        print(f"memory multiway: EXPLAIN shows a MultiwayJoin for "
              f"{sorted(collapsed)}")
        require("mw_fanout" in collapsed and len(collapsed) > 1,
                "memory multiway: no TPC-H chain or MW_FANOUT collapsed")
        require(ladder, "memory mw_fanout hash: join_probe did not launch")
        top = max(ladder)
        print(f"memory mw_fanout hash: join_probe launched at F = "
              f"{sorted(set(ladder))}")
        rng = np.random.default_rng(20261018)
        ji, jp = join_probe_case(torch, rng, 4096, 4096 // top, (top,))
        errs["join_insert"] = max(errs["join_insert"], ji)
        errs["join_probe"] = max(errs["join_probe"], jp)

        done = check_recorded(torch, largest, errs)
        del largest
        print(f"memory hash SF {SF}: each kernel's largest input of the "
              f"first runs holds its contract: {json.dumps(done)}")

        t_small = time.perf_counter()
        small = tpch_catalog(SMALL_SF)
        hows = {}
        # the group tables' base capacity (agg_capacity) does not shrink
        # with the scale factor: at SF 0.01 the pool is 4 MiB
        for unit, entries in memory_units(1 << 22, SMALL_SF).items():
            for label, q, cfg, _ in entries:
                sql = memory_sql(q, SMALL_SF)
                for eng in ENGINES:
                    on_gpu = runner(cfg, eng, small).run(sql)
                    on_cpu = runner(cfg, eng, small, "cpu").run(sql)
                    hows[f"{unit} {label} {eng}"] = frames_agree(
                        on_gpu, on_cpu, ORDER_KEYS.get(q),
                        f"memory {unit} {label} {eng} SF {SMALL_SF} card "
                        "vs CPU")
        no_spill_left("memory SF 0.01")
        unit_s[f"SF {SMALL_SF}"] = time.perf_counter() - t_small
        print(f"memory SF {SMALL_SF}: card against CPU for {len(hows)} runs "
              f"in {unit_s[f'SF {SMALL_SF}']:.1f} s: {json.dumps(hows)}")
    finally:
        hk._join_probe_cuda = real_probe
        shutil.rmtree(spill_dir)
    print(f"memory: phase took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"memory": summary, "seconds": unit_s}))
    return hash_launches


def check_memory_unit(unit, label, eng, runner, sql, stats, launches,
                      collapsed):
    """What each unit must show beyond its frames; a multiway run whose
    EXPLAIN shows a MultiwayJoin adds its label to `collapsed`."""
    name = f"memory {unit} {label} {eng}"
    if unit == "grace_default":
        require(stats["spill.partitions"] > 0, f"{name}: no GRACE")
    elif unit == "pool_spill":
        require(stats["spill.partitions"] > 0, f"{name}: did not spill")
        require(stats["spill.repartitions"] > 0,
                f"{name}: no partition repartitioned")
    elif unit == "radix" and label.endswith("forced_spill"):
        require(stats["radix.partitions_spilled"] > 0,
                f"{name}: no partition spilled")
    elif unit == "multiway":
        if "MultiwayJoin" in runner.explain(sql):
            collapsed.add(label)
        if label == "mw_fanout" and eng == "hash":
            require(launches.get("join_probe", 0) > 0,
                    f"{name}: join_probe did not launch")
            require(stats["multiway.cascade_fallbacks"] == 0,
                    f"{name}: fell back to the cascade")
        if label == "mw_fanout" and eng == "auto":
            require(stats["multiway.cascade_fallbacks"] > 0,
                    f"{name}: no cascade fallback")


# ---------------------------------------------------------------------------
# phase 3b'''': scans from files

# The card's Python has pyarrow with its ORC and Parquet modules (24.0.0
# beside torch 2.11.0+cu128), so this phase runs the Parquet and ORC
# connectors there; without pyarrow it fails at the import.
SCAN_QUERIES = ("q1", "q6", "q3", "q18")
# the Parquet copy's row groups: under the scan's 2^17-row batch, so a
# split is one row group, decoded once (a larger group is split into
# parts that each decode the whole group, as in the JAX package)
SCAN_ROW_GROUP_ROWS = 100_000
# the memory catalog's frames of SCAN_QUERIES, kept by the 22-query phase:
# (sql, engine) -> frame
MEMORY_FRAMES = {}
SCAN_COUNTERS = ("splits_pruned", "rows_predecode_filtered", "bytes_skipped")
# a partitioned CTAS of orders, a pruned query, an INSERT and a read back,
# into a fresh directory (catalog `hv`) each time
HIVE_STATEMENTS = [
    ("ctas", "create table hv.orders_p with (partitioned_by = "
             "array['o_orderstatus']) as select o_orderkey, o_custkey, "
             "o_totalprice, o_orderdate, o_orderstatus from orders"),
    ("pruned", "select count(*) n, sum(o_totalprice) s from hv.orders_p "
               "where o_orderstatus = 'F'"),
    ("insert", "insert into hv.orders_p select o_orderkey, o_custkey, "
               "o_totalprice, o_orderdate, o_orderstatus from orders "
               "where o_orderdate >= date '1998-01-01'"),
    ("read_back", "select o_orderstatus, count(*) n, sum(o_totalprice) s "
                  "from hv.orders_p group by o_orderstatus "
                  "order by o_orderstatus"),
]
# a CSV, a SQLite and a remote-service table, each joined with the memory
# catalog's tables
FEDERATION = {
    "csv_nation": "select f.n_name, count(*) n from customer c "
                  "join files.nation f on c.c_nationkey = f.n_nationkey "
                  "group by f.n_name order by f.n_name",
    "sqlite_supplier": "select n.n_name, count(*) n, sum(s.s_acctbal) b "
                       "from db.supplier s join nation n "
                       "on s.s_nationkey = n.n_nationkey "
                       "group by n.n_name order by n.n_name",
    "remote_orders": "select count(*) n, sum(l.l_quantity) q "
                     "from rs.big_orders b join lineitem l "
                     "on l.l_orderkey = b.o_orderkey",
}
BIG_ORDER_QUANTILE = 0.99  # the remote table: orders above it by price
FED_RTOL = 1e-9  # SQLite's float account balances, summed in another order
# ORC stripes of about 43 K lineitem rows (pyarrow's writer cuts a stripe
# at this many bytes): the ORC connector splits every stripe into the
# same number of parts, and a part larger than the scan's 2^17-row batch
# does not fit it in either package (ROADMAP §3); the writer's default
# (64 MB) gives parts past 2^17 rows at SF 1
ORC_STRIPE_BYTES = 4 << 20


def scan_files(conn, root):
    """Files of the generator's tables (`conn`, a memory connector) under
    `root`: every table as Parquet (the memory catalog's rows, row groups
    of SCAN_ROW_GROUP_ROWS), lineitem sorted by l_shipdate in row groups of 2^17, lineitem
    and orders as ORC (stripes of ORC_STRIPE_BYTES) with their stripe
    sidecars, nation as CSV, supplier
    in SQLite, and the dearest orders (`big_orders`) behind an in-process
    table service on loopback. Returns the directories and the service."""
    import sqlite3

    import numpy as np
    import pandas as pd

    from presto_tpu_torch.catalog.orc import export_table_to_orc
    from presto_tpu_torch.catalog.parquet import write_table
    from presto_tpu_torch.catalog.remote import RemoteTableService

    dirs = {k: os.path.join(root, k) for k in ("pq", "sorted", "orc", "fed")}
    for d in dirs.values():
        os.makedirs(d)
    for t in conn.table_names():
        conn.get_table(t)
        mt = conn.tables[t]
        write_table(os.path.join(dirs["pq"], f"{t}.parquet"), mt.arrays,
                    mt.types, mt.dicts, row_group_rows=SCAN_ROW_GROUP_ROWS)
    li = conn.tables["lineitem"]
    order = np.argsort(li.arrays["l_shipdate"], kind="stable")
    write_table(os.path.join(dirs["sorted"], "lineitem.parquet"),
                {c: a[order] for c, a in li.arrays.items()}, li.types,
                li.dicts, row_group_rows=1 << 17)
    for t in ("lineitem", "orders"):
        mt = conn.tables[t]
        export_table_to_orc(dirs["orc"], t, mt.arrays, mt.types, mt.dicts,
                            stripe_size=ORC_STRIPE_BYTES)
    na, su, od = (conn.tables[t] for t in ("nation", "supplier", "orders"))
    pd.DataFrame({
        "n_nationkey": na.arrays["n_nationkey"],
        "n_name": na.dicts["n_name"].decode(na.arrays["n_name"]),
    }).to_csv(os.path.join(dirs["fed"], "nation.csv"), index=False)
    db = sqlite3.connect(os.path.join(dirs["fed"], "shop.db"))
    pd.DataFrame({
        "s_suppkey": su.arrays["s_suppkey"],
        "s_nationkey": su.arrays["s_nationkey"],
        "s_acctbal": su.arrays["s_acctbal"] / 100.0,
    }).to_sql("supplier", db, index=False)
    db.close()
    big = big_orders(od)
    svc = RemoteTableService({"big_orders": pd.DataFrame({
        "o_orderkey": od.arrays["o_orderkey"][big],
        "o_totalprice": od.arrays["o_totalprice"][big] / 100.0})})
    return dirs, svc


def big_orders(od):
    """The orders above BIG_ORDER_QUANTILE of o_totalprice (a mask)."""
    import numpy as np

    p = od.arrays["o_totalprice"]
    return p > np.quantile(p, BIG_ORDER_QUANTILE)


def files_catalog(fmt, d):
    """A fresh connector (no split cache, no decode cache) over directory
    `d`, Parquet or ORC, as the default catalog."""
    from presto_tpu_torch.catalog.orc import OrcConnector
    from presto_tpu_torch.catalog.parquet import ParquetConnector
    from presto_tpu_torch.connector import Catalog

    cat = Catalog()
    cat.register(fmt, (ParquetConnector if fmt == "parquet"
                       else OrcConnector)(d), default=True)
    return cat


def mem_catalog(mem, dirs=None, svc=None, hive=None):
    """The memory connector `mem` as the default catalog, with the
    federation's connectors (`dirs`, `svc`) or a hive target directory."""
    from presto_tpu_torch.catalog.jdbc import sqlite_connector
    from presto_tpu_torch.catalog.localfile import LocalFileConnector
    from presto_tpu_torch.catalog.parquet import ParquetConnector
    from presto_tpu_torch.catalog.remote import RemoteServiceConnector
    from presto_tpu_torch.connector import Catalog

    cat = Catalog()
    cat.register("tpch", mem, default=True)
    if hive is not None:
        os.makedirs(hive)
        cat.register("hv", ParquetConnector(hive))
    if dirs is not None:
        cat.register("files", LocalFileConnector(dirs["fed"]))
        cat.register("db", sqlite_connector(
            os.path.join(dirs["fed"], "shop.db")))
        cat.register("rs", RemoteServiceConnector(svc.url))
    return cat


def scan_oracles(conn):
    """The hive statements' and the federation's expected results from the
    generated tables (unscaled integers, dictionary values)."""
    from decimal import Decimal

    import numpy as np
    import pandas as pd

    od = conn.tables["orders"]
    a = od.arrays
    st = od.dicts["o_orderstatus"]

    def dec(v):
        return Decimal(int(v)).scaleb(-2)

    f = st.code_of("F")
    late = a["o_orderdate"] >= _days(1998, 1, 1)
    rows = []
    for code, s in enumerate(st.values):
        m = a["o_orderstatus"] == code
        both = np.concatenate([a["o_totalprice"][m],
                               a["o_totalprice"][m & late]])
        if len(both):
            rows.append({"o_orderstatus": s, "n": len(both),
                         "s": dec(both.sum())})
    out = {
        "ctas": pd.DataFrame({"rows": [len(a["o_orderkey"])]}),
        "pruned": pd.DataFrame({
            "n": [int((a["o_orderstatus"] == f).sum())],
            "s": [dec(a["o_totalprice"][a["o_orderstatus"] == f].sum())]}),
        "insert": pd.DataFrame({"rows": [int(late.sum())]}),
        "read_back": pd.DataFrame(rows),
    }
    na, cu, su = (conn.tables[t] for t in ("nation", "customer", "supplier"))
    names = na.dicts["n_name"].decode(na.arrays["n_name"])
    by_key = dict(zip(na.arrays["n_nationkey"], names))
    c = pd.Series([by_key[k] for k in cu.arrays["c_nationkey"]])
    g = c.value_counts().sort_index()
    out["csv_nation"] = pd.DataFrame({"n_name": g.index.to_numpy(),
                                      "n": g.to_numpy()})
    s = pd.DataFrame({"n_name": [by_key[k] for k in su.arrays["s_nationkey"]],
                      "b": su.arrays["s_acctbal"] / 100.0})
    g = s.groupby("n_name", as_index=False).agg(n=("b", "size"),
                                                b=("b", "sum"))
    out["sqlite_supplier"] = g
    li = conn.tables["lineitem"]
    big = a["o_orderkey"][big_orders(od)]
    m = np.isin(li.arrays["l_orderkey"], big)
    out["remote_orders"] = pd.DataFrame({
        "n": [int(m.sum())], "q": [int(li.arrays["l_quantity"][m].sum())]})
    return out


def run_hive(torch, mem, d, device=None):
    """The HIVE_STATEMENTS in order into a fresh directory `d`: name ->
    (frame, seconds, splits pruned)."""
    from presto_tpu_torch.exec import ExecConfig, LocalRunner

    r = LocalRunner(mem_catalog(mem, hive=d), ExecConfig(), device=device)
    out = {}
    for name, sql in HIVE_STATEMENTS:
        if device is None:
            torch.cuda.synchronize()
        t = time.perf_counter()
        f = r.run(sql)
        if device is None:
            torch.cuda.synchronize()
        out[name] = (f, time.perf_counter() - t,
                     r.last_stats.get("scan.orders_p.splits_pruned", 0))
    return out


def scan_units(sf_sql, sf):
    """(unit, label, catalog kind, sql, config) of the phase's query runs:
    the four queries over Parquet under both engines (Q18, whose GRACE
    runs took most of the phase, at SF 0.01 alone), Q6 on the sorted copy
    with the selective scan on and off, Q1 and Q6 over ORC."""
    units = []
    for q in SCAN_QUERIES:
        if q == "q18" and sf == SF:
            continue
        for eng in ENGINES:
            units.append(("parquet", f"{q} {eng}", "pq", sf_sql(q),
                          {"breaker_engine": eng}))
    for on in (True, False):
        units.append(("sorted", f"q6 selective_scan={on}", "sorted",
                      sf_sql("q6"), {"selective_scan": on}))
    for q in ("q1", "q6"):
        units.append(("orc", f"{q} auto", "orc", sf_sql(q), {}))
    return units


def phase_scan(torch, cat, errs):
    """Scans from files on the TPC-H SF 1 catalog:
    - set-up (printed apart): the memory catalog's tables written as
      Parquet, a copy of lineitem sorted by l_shipdate in row groups of
      2^17, ORC copies of lineitem and orders, CSV, SQLite and a remote
      table service (`scan_files`), under a `.scan-*` directory of the
      checkout removed at the end;
    - Q1, Q6 and Q3 over Parquet under auto and hash (Q18 too at SF
      0.01), each equal to
      its numpy oracle and to the memory catalog's frame of the same run
      (the 22-query phase's, where it ran; MEMORY_FRAMES):
      the cold first run (a fresh connector: no device split cache, no host
      decode cache; the files are in the page cache, written just before),
      the first run with caches (a new runner over the same connector),
      the warm median of 3, lineitem rows/s and the busy share (device
      time of one more run, torch.profiler, over the warm median); the
      cold run's launches (counts reset just before it, read just after):
      Q3 under hash must launch group_insert, join_insert and join_probe,
      Q1 grouped_sums;
    - Q6 on the sorted copy with the selective scan on and off: equal, and
      splits_pruned, rows_predecode_filtered and bytes_skipped above 0
      with it on;
    - Q1 and Q6 over ORC equal to Parquet's;
    - a hive-partitioned CTAS of orders, a pruned query, an INSERT and a
      read back, each against an oracle;
    - a CSV, a SQLite and a remote-service table each joined with the
      memory catalog, each against an oracle;
    - all of it at SF 0.01 on the card against the CPU, and Q1 and Q6 over
      the chunked export (export_tpch_chunked) at SF 0.01 too.
    Prints a `scan` JSON line; returns the launches of the cold runs under
    hash, summed."""
    import shutil
    import tempfile

    from presto_tpu_torch.catalog.parquet import export_tpch_chunked
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.catalog.tpch_queries import QUERIES as TPCH
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix=".scan-", dir=os.path.dirname(
        os.path.abspath(__file__)))
    conn = cat.connectors["tpch"]

    def sf_sql(q, sf=SF):
        return at_scale(q, TPCH[q], sf)

    svc = small_svc = None
    try:
        dirs, svc = scan_files(conn, root)
        setup_s = time.perf_counter() - t0
        n_lineitem = conn.tables["lineitem"].num_rows
        oracles = {q: oracle(conn, q) for q in ("q1", "q3", "q6")}
        oracles.update(scan_oracles(conn))
        print(f"scan: set-up {setup_s:.1f} s (Parquet, sorted copy, ORC, "
              f"CSV, SQLite, remote service at SF {SF}); oracles ready "
              f"{time.perf_counter() - t0 - setup_s:.1f} s later")
        summary = []
        hash_launches = {}
        frames = {}  # (unit, label) -> the first run's frame
        t_queries = time.perf_counter()
        for unit, label, kind, sql, cfg in scan_units(sf_sql, SF):
            q = label.split()[0]
            name = f"scan {unit} {label}"
            cfg = ExecConfig(**cfg)
            fmt = "orc" if kind == "orc" else "parquet"
            r = LocalRunner(files_catalog(fmt, dirs[kind]), cfg)
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = r.run(sql)
            torch.cuda.synchronize()
            cold = time.perf_counter() - t1
            launches = {k: v for k, v in launch_counts().items() if v}
            stats = {c: r.last_stats.get(f"scan.lineitem.{c}", 0)
                     for c in SCAN_COUNTERS}
            frames[(unit, label)] = out
            check_oracle(out, oracles[q], q, f"{name} oracle")
            row = {"unit": unit, "run": label, "rows": len(out),
                   "cold_ms": cold * 1e3, "launches": launches,
                   "stats": stats}
            note = ""
            if unit == "parquet":
                eng = cfg.breaker_engine
                if eng == "hash":
                    for k, v in launches.items():
                        hash_launches[k] = hash_launches.get(k, 0) + v
                if q == "q3" and eng == "hash":
                    for k in ("join_insert", "join_probe", "group_insert"):
                        require(launches.get(k, 0) > 0,
                                f"{name}: {k} did not launch")
                mem = MEMORY_FRAMES.get((sql, eng))
                if mem is None:
                    mem = LocalRunner(cat, ExecConfig(
                        breaker_engine=eng)).run(sql)
                how = frames_agree(out, mem, ORDER_KEYS[q],
                                   f"{name} vs the memory catalog")
                r2 = LocalRunner(r.catalog, cfg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                again = r2.run(sql)
                torch.cuda.synchronize()
                cached = time.perf_counter() - t1
                frames_agree(again, out, ORDER_KEYS[q], f"{name} cached")
                again, warm = warm_runs(torch, r2, sql)
                frames_agree(again, out, ORDER_KEYS[q], f"{name} warm")
                dev = device_profile(torch, lambda: r2.run(sql))
                row.update({"cached_ms": cached * 1e3, "warm_ms": warm * 1e3,
                            "lineitem_rows_per_s": n_lineitem / warm,
                            "busy": dev["device_ms"] / (warm * 1e3), **dev})
                note = (f"; {how} to the memory catalog; cold first run "
                        f"{cold * 1e3:.1f} ms ({n_lineitem / cold:.4g} "
                        f"lineitem rows/s), first run with caches "
                        f"{cached * 1e3:.1f} ms, warm median of 3 "
                        f"{warm * 1e3:.1f} ms ({n_lineitem / warm:.4g} "
                        f"lineitem rows/s); device time of one more run "
                        f"{dev['device_ms']:.2f} ms, busy "
                        f"{dev['device_ms'] / warm / 10:.1f} %")
            elif unit == "sorted":
                if cfg.selective_scan:
                    for c in SCAN_COUNTERS:
                        require(stats[c] > 0, f"{name}: {c} is {stats[c]}")
                else:
                    frames_equal(out, frames[("sorted",
                                              "q6 selective_scan=True")],
                                 f"{name} vs selective_scan=True")
                    note = "; equal to the run with it on"
                note += f"; cold first run {cold * 1e3:.1f} ms"
            else:
                frames_equal(out, frames[("parquet", f"{q} auto")],
                             f"{name} vs Parquet")
                note = (f"; equal to Parquet's; cold first run "
                        f"{cold * 1e3:.1f} ms")
            summary.append(row)
            print(f"{name} SF {SF}: {len(out)} rows, equal to the oracle"
                  f"{note}; launches {json.dumps(launches)}; "
                  f"{json.dumps(stats)}")
        q1_launched = [u["run"] for u in summary if u["unit"] == "parquet"
                       and u["run"].startswith("q1 ")
                       and u["launches"].get("grouped_sums", 0)]
        require(q1_launched, "scan parquet q1: grouped_sums did not launch")
        queries_s = time.perf_counter() - t_queries

        t_units = time.perf_counter()
        hive = run_hive(torch, conn, os.path.join(root, "hive"))
        for label, (f, sec, pruned) in hive.items():
            columns_equal(f, oracles[label], f"scan hive {label}")
            summary.append({"unit": "hive", "run": label, "rows": len(f),
                            "ms": sec * 1e3, "splits_pruned": pruned})
            print(f"scan hive {label} SF {SF}: {len(f)} rows, equal to the "
                  f"oracle; {sec * 1e3:.1f} ms; splits pruned {pruned}")
        require(hive["pruned"][2] > 0, "scan hive pruned: no split pruned")
        fed = LocalRunner(mem_catalog(conn, dirs, svc), ExecConfig())
        for label, sql in FEDERATION.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            f = fed.run(sql)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            columns_equal(f, oracles[label], f"scan federation {label}",
                          rtol=FED_RTOL)
            summary.append({"unit": "federation", "run": label,
                            "rows": len(f), "ms": sec * 1e3})
            print(f"scan federation {label} SF {SF}: {len(f)} rows, equal "
                  f"to the oracle; {sec * 1e3:.1f} ms")
        units_s = time.perf_counter() - t_units

        t_small = time.perf_counter()
        small = tpch_catalog(SMALL_SF).connectors["tpch"]
        sdirs, small_svc = scan_files(small, os.path.join(root, "small"))
        export_tpch_chunked(os.path.join(root, "chunked"), SMALL_SF,
                            orders_per_chunk=6000)
        sdirs["chunked"] = os.path.join(root, "chunked")
        hows = {}
        runs = scan_units(lambda q: sf_sql(q, SMALL_SF), SMALL_SF)
        runs += [("chunked", f"{q} {eng}", "chunked", sf_sql(q, SMALL_SF),
                  {"breaker_engine": eng})
                 for q in ("q1", "q6") for eng in ENGINES]
        for unit, label, kind, sql, cfg in runs:
            fmt = "orc" if kind == "orc" else "parquet"
            outs = [LocalRunner(files_catalog(fmt, sdirs[kind]),
                                ExecConfig(**cfg), device=dev).run(sql)
                    for dev in (None, "cpu")]
            hows[f"{unit} {label}"] = frames_agree(
                outs[0], outs[1], ORDER_KEYS[label.split()[0]],
                f"scan {unit} {label} SF {SMALL_SF} card vs CPU")
        on_card, on_cpu = (run_hive(torch, small, os.path.join(root, f"h{i}"),
                                    dev)
                           for i, dev in enumerate((None, "cpu")))
        for label in on_card:
            frames_equal(on_card[label][0], on_cpu[label][0],
                         f"scan hive {label} SF {SMALL_SF} card vs CPU")
            hows[f"hive {label}"] = "equal"
        fed_runs = [LocalRunner(mem_catalog(small, sdirs, small_svc),
                                ExecConfig(), device=dev)
                    for dev in (None, "cpu")]
        for label, sql in FEDERATION.items():
            a, b = (r.run(sql) for r in fed_runs)
            columns_equal(a, b, f"scan federation {label} SF {SMALL_SF} "
                          "card vs CPU", rtol=FED_RTOL)
            hows[f"federation {label}"] = "equal"
        small_s = time.perf_counter() - t_small
        print(f"scan SF {SMALL_SF}: card against CPU for {len(hows)} runs "
              f"in {small_s:.1f} s: {json.dumps(hows)}")
    finally:
        for s in (svc, small_svc):
            if s is not None:
                s.close()
        shutil.rmtree(root)
    seconds = {"setup": setup_s, "queries": queries_s, "hive_federation":
               units_s, f"SF {SMALL_SF}": small_s,
               "phase": time.perf_counter() - t0}
    print(f"scan: phase took {seconds['phase']:.1f} s (set-up "
          f"{setup_s:.1f} s)")
    print(json.dumps({"scan": summary, "seconds": seconds}))
    return hash_launches


# ---------------------------------------------------------------------------
# phase 3b''''': the cluster

CLUSTER_QUERIES = ("q1", "q6", "q3", "q18")
CLUSTER_PARTITIONED = ("q3", "q18")  # every join partitioned, under hash
# first run only: Q18's 5.8 s a run made half the phase (its warm walls
# are in PERF.md §5)
CLUSTER_FIRST_RUN_ONLY = ("q18",)
CLUSTER_TIMEOUTS = dict(timeout_s=60.0, query_timeout_s=600.0)
LAUNCHER_SQL = ("select n_regionkey, count(*) as n, sum(n_nationkey) as s "
                "from nation group by n_regionkey order by n_regionkey")


def exchange_bytes(dr) -> int:
    """Page bytes every task of an in-process cluster has queued for its
    consumers so far (what the exchange moves over HTTP)."""
    return sum(t.buffer.sent_bytes for w in dr.workers
               for t in list(w.task_manager.tasks.values()))


def run_launchers(torch, frame):
    """`python -m presto_tpu_torch.server --coordinator` and one
    `--worker`, both on the card (their default device) over TPC-H SF
    0.01; LAUNCHER_SQL through the port's dbapi must give `frame`'s rows.
    Both processes end in the finally. Returns the seconds it took."""
    import presto_tpu_torch.dbapi as dbapi

    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    with socket.socket() as sk:  # a free port, so both start at once
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    procs = []

    def start(args):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "presto_tpu_torch.server", *args,
             "--catalog", f"tpch:sf={SMALL_SF}", "--timeout-s", "60"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root))

    def wait_up(p, what):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            if "listening on" in line:
                return
        raise CheckFailed(f"cluster launcher: the {what} did not start "
                          f"(exit {p.poll()})")

    try:
        # the worker announces until the coordinator answers
        start(["--coordinator", "--port", str(port)])
        start(["--worker", "--coordinator-url", url])
        wait_up(procs[0], "coordinator")
        wait_up(procs[1], "worker")
        cur = dbapi.connect(url, timeout_s=60).cursor()
        deadline = time.monotonic() + 60
        while True:  # the worker's first announcement may be on its way
            try:
                cur.execute(LAUNCHER_SQL)
                rows = cur.fetchall()
                break
            except dbapi.DatabaseError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        want = list(frame.itertuples(index=False, name=None))
        require([tuple(int(v) for v in r) for r in rows]
                == [tuple(int(v) for v in r) for r in want],
                f"cluster launcher: {rows} != {want}")
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
    return time.perf_counter() - t0


def phase_cluster(torch, cat, errs):
    """The cluster on the card: DistributedRunner (a coordinator and two
    workers in this process, over localhost HTTP, all on the card) over
    the SF 1 catalog runs Q1, Q6, Q3 and Q18 under auto and hash (joins
    broadcast where the CBO's threshold allows), and Q3 and Q18 with
    every join partitioned under hash; each result equals the
    LocalRunner's frame of the 22-query phase (MEMORY_FRAMES) and the
    numpy oracle. For each: the first run's wall, launches (counts reset
    just before it, read just after) and exchange bytes, and but for Q18
    (CLUSTER_FIRST_RUN_ONLY) the warm median of 3, lineitem rows/s, and
    the device time of one more run (torch.profiler) over the warm
    median. Q18 under hash must launch
    join_insert, join_probe and group_insert, Q1 grouped_sums. Then the
    22 queries at SF 0.01 through a cluster on the card against one on
    the CPU, and the launcher processes (`run_launchers`). Prints a
    `cluster` JSON line; returns the launches of the first runs under
    hash, summed."""
    from presto_tpu_torch.catalog.tpch import tpch_catalog
    from presto_tpu_torch.catalog.tpch_queries import QUERIES as TPCH
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts
    from presto_tpu_torch.server.coordinator import DistributedRunner

    t0 = time.perf_counter()
    conn = cat.connectors["tpch"]
    n_lineitem = int(conn.get_table("lineitem").row_count)
    oracles = {q: oracle(conn, q) for q in ("q1", "q3", "q6")}
    oracles["q18"] = oracle22(conn, "q18")
    runs = ([(q, eng, "broadcast") for q in CLUSTER_QUERIES
             for eng in ENGINES]
            + [(q, "hash", "partitioned") for q in CLUSTER_PARTITIONED])
    clusters = {}
    summary = []
    hash_launches = {}
    try:
        for q, eng, how in runs:
            dr = clusters.get((eng, how))
            if dr is None:
                dr = clusters[(eng, how)] = DistributedRunner(
                    cat, n_workers=2, config=ExecConfig(breaker_engine=eng),
                    broadcast_threshold_rows=(0 if how == "partitioned"
                                              else 1_000_000),
                    **CLUSTER_TIMEOUTS)
            name = f"cluster {q} {eng} {how}"
            sql = at_scale(q, TPCH[q], SF)
            reset_launch_counts()
            b0 = exchange_bytes(dr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = dr.run(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t1
            launches = {k: v for k, v in launch_counts().items() if v}
            moved = exchange_bytes(dr) - b0
            local = MEMORY_FRAMES.get((sql, eng))
            if local is None:
                local = LocalRunner(cat, ExecConfig(breaker_engine=eng)).run(
                    sql)
            how_eq = frames_agree(out, local, ORDER_KEYS[q],
                                  f"{name} vs LocalRunner")
            check_oracle(out, oracles[q], q, f"{name} oracle")
            if eng == "hash":
                for k, v in launches.items():
                    hash_launches[k] = hash_launches.get(k, 0) + v
                if q == "q18":
                    for k in ("join_insert", "join_probe", "group_insert"):
                        require(launches.get(k, 0) > 0,
                                f"{name}: {k} did not launch")
            if q == "q1":
                require(launches.get("grouped_sums", 0) > 0,
                        f"{name}: grouped_sums did not launch")
            if q in CLUSTER_FIRST_RUN_ONLY:
                summary.append({"query": q, "engine": eng, "joins": how,
                                "rows": len(out), "first_ms": first * 1e3,
                                "exchange_bytes": moved,
                                "launches": launches})
                print(f"{name} SF {SF}: {len(out)} rows, {how_eq} to the "
                      f"LocalRunner's and equal to the oracle; first run "
                      f"{first * 1e3:.1f} ms (first run only); exchange "
                      f"{moved} bytes; launches {json.dumps(launches)}")
                continue
            again, warm = warm_runs(torch, dr, sql)
            frames_agree(again, out, ORDER_KEYS[q], f"{name} warm")
            dev = device_profile(torch, lambda: dr.run(sql))
            summary.append({"query": q, "engine": eng, "joins": how,
                            "rows": len(out), "first_ms": first * 1e3,
                            "warm_ms": warm * 1e3,
                            "lineitem_rows_per_s": n_lineitem / warm,
                            "exchange_bytes": moved, "launches": launches,
                            "busy": dev["device_ms"] / (warm * 1e3), **dev})
            print(f"{name} SF {SF}: {len(out)} rows, {how_eq} to the "
                  f"LocalRunner's and equal to the oracle; first run "
                  f"{first * 1e3:.1f} ms, warm median of 3 "
                  f"{warm * 1e3:.1f} ms ({n_lineitem / warm:.4g} lineitem "
                  f"rows/s); exchange {moved} bytes; launches "
                  f"{json.dumps(launches)}; device time of one run "
                  f"{dev['device_ms']:.2f} ms, busy "
                  f"{dev['device_ms'] / warm / 10:.1f} %, the port's kernels "
                  f"{dev['port_kernels_ms']:.3f} ms")
        queries_s = time.perf_counter() - t0

        t_small = time.perf_counter()
        small = tpch_catalog(SMALL_SF)
        clusters["small card"] = DistributedRunner(small, n_workers=2,
                                                   **CLUSTER_TIMEOUTS)
        clusters["small cpu"] = DistributedRunner(small, n_workers=2,
                                                  device="cpu",
                                                  **CLUSTER_TIMEOUTS)
        hows = {}
        for q, sql in TPCH.items():
            on_gpu = clusters["small card"].run(sql)
            on_cpu = clusters["small cpu"].run(sql)
            hows[q] = frames_agree(on_gpu, on_cpu, ORDER_KEYS[q],
                                   f"cluster {q} SF {SMALL_SF} card vs CPU")
        small_s = time.perf_counter() - t_small
        print(f"cluster SF {SMALL_SF}: card against CPU for {len(hows)} "
              f"queries in {small_s:.1f} s: {json.dumps(hows)}")
        launcher_s = run_launchers(
            torch, clusters["small card"].run(LAUNCHER_SQL))
        print(f"cluster launcher: coordinator and worker processes on the "
              f"card answered through dbapi like the in-process cluster "
              f"({launcher_s:.1f} s with their start-up)")
    finally:
        for dr in clusters.values():
            dr.close()
    seconds = {"queries": queries_s, f"SF {SMALL_SF}": small_s,
               "launcher": launcher_s, "phase": time.perf_counter() - t0}
    from presto_tpu_torch import serde

    zstd = serde._zstd is not None
    print(f"cluster: phase took {seconds['phase']:.1f} s; exchange pages "
          f"{'zstd-compressed' if zstd else 'uncompressed (no zstandard)'}")
    print(json.dumps({"cluster": summary, "seconds": seconds,
                      "pages_compressed": zstd}))
    return hash_launches


# ---------------------------------------------------------------------------
# phase 3b': the observability plane

OBS_EXPLAIN = (("q1", "auto"), ("q3", "hash"), ("q18", "hash"))
OBS_TIMED = ("q3", "q18")  # under hash, tracing on against off
OBS_KERNELS = ("grouped_sums", "group_insert", "join_insert", "join_probe")


def _first_rows(text: str) -> int:
    """The rows of the top operator of an EXPLAIN ANALYZE text."""
    m = re.search(r"\[rows=(\d+),", text)
    require(m is not None, "explain analyze: no operator row count")
    return int(m.group(1))


def _check_hbo_lines(text: str, label: str) -> int:
    """Every keyed Aggregate and every HashJoin that ran unspilled carries
    HBO's estimate against its actual; returns how many lines did."""
    n = 0
    for line in text.splitlines():
        if not re.search(r"\b(Aggregate|HashJoin)\[", line) \
                or "[rows=" not in line:
            continue
        if "keys=[]" in line or "[spill:" in line:
            continue
        require("est=" in line and "actual=" in line and "drift=" in line,
                f"{label}: no HBO est/actual on {line.strip()[:120]}")
        n += 1
    return n


def _levels(node, depth=0, out=None):
    out = set() if out is None else out
    out.add((depth, node["kind"]))
    for c in node["children"]:
        _levels(c, depth + 1, out)
    return out


def _statement(base: str, sql: str, session: str):
    """POST a statement and follow nextUri: (last doc, rows)."""
    import urllib.request

    req = urllib.request.Request(
        f"{base}/v1/statement", data=sql.encode(), method="POST",
        headers={"X-Presto-User": "smoke", "X-Presto-Session": session})
    with urllib.request.urlopen(req, timeout=120) as r:
        doc = json.loads(r.read())
    rows = []
    deadline = time.monotonic() + 300
    while True:
        rows += doc.get("data") or []
        if "nextUri" not in doc:
            return doc, rows
        require(time.monotonic() < deadline, f"statement {sql[:40]!r} "
                "did not finish")
        with urllib.request.urlopen(doc["nextUri"], timeout=120) as r:
            doc = json.loads(r.read())


def _get(url: str, text: bool = False):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
    return body.decode() if text else json.loads(body)


def phase_obs(torch, cat, errs):
    """The observability plane on the card over the SF 1 catalog.
    EXPLAIN ANALYZE through LocalRunner on CUDA of Q1 (auto) and Q3 and
    Q18 (hash): the top operator's rows equal the result's and the result
    its oracle; every keyed Aggregate and HashJoin that ran unspilled
    shows HBO's est/actual/drift; launch counts reset just before the
    three and read just after must show all four kernels. Then Q3 and Q18
    under hash with tracing on and off in this call: warm median of 3
    each and the busy share of one more run (torch.profiler), the
    tracer's cost on the card. Then a DistributedRunner (two workers on
    the card) over the protocol: Q3 under hash, its stitched trace with
    query, stage, task and operator spans, EXPLAIN ANALYZE, /v1/metrics
    clean under the port's linter, /v1/events and /progress. Then a
    devprof=on run (the card's allocator peak above 0 and below the
    card's memory; the reconcile ratio against the pool ledger) and, after
    every other profiler window of the phase, a profile=true statement
    whose Chrome trace must exist under a temporary PRESTO_TPU_CACHE_DIR.
    Prints an `obs` JSON line; returns the EXPLAIN ANALYZE launches."""
    import tempfile

    from presto_tpu_torch.catalog.tpch_queries import QUERIES as TPCH
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.obs.exposition import lint_exposition
    from presto_tpu_torch.server.coordinator import DistributedRunner

    t0 = time.perf_counter()
    conn = cat.connectors["tpch"]
    oracles = {"q1": oracle(conn, "q1"), "q3": oracle(conn, "q3"),
               "q18": oracle22(conn, "q18")}
    runners = {eng: LocalRunner(cat, ExecConfig(breaker_engine=eng))
               for eng in ("auto", "hash")}
    explained = {}
    texts = {}
    for q, eng in OBS_EXPLAIN:
        sql = at_scale(q, TPCH[q], SF)
        out = runners[eng].run(sql)
        check_oracle(out, oracles[q], q, f"obs {q} {eng} oracle")
        explained[q] = len(out)
    reset_launch_counts()
    for q, eng in OBS_EXPLAIN:
        sql = at_scale(q, TPCH[q], SF)
        text = runners[eng].explain_analyze(sql)
        texts[q] = text
        top = _first_rows(text)
        require(top == explained[q], f"obs {q}: explain analyze's top "
                f"operator has {top} rows, the result {explained[q]}")
        n = _check_hbo_lines(text, f"obs {q} {eng}")
        print(f"obs explain analyze {q} {eng} SF {SF}: top operator "
              f"{top} rows = the result's; {n} Aggregate/HashJoin lines "
              f"with HBO est/actual")
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    for k in OBS_KERNELS:
        require(launches.get(k, 0) > 0,
                f"obs explain analyze: {k} did not launch")
    print("obs explain analyze of Q18 hash:\n" + texts["q18"])
    print(f"obs explain analyze launches: {json.dumps(launches)}")

    tracing = {}
    for q in OBS_TIMED:
        sql = at_scale(q, TPCH[q], SF)
        pair = {flag: LocalRunner(cat, ExecConfig(breaker_engine="hash",
                                                  tracing=flag))
                for flag in (False, True)}
        row = {}
        # the catalog and the kernels are warm from the phases before;
        # the cheap Q3 alternates off and on twice, Q18 once
        order = (False, True) * (2 if q == "q3" else 1)
        for flag in order:
            _, warm = warm_runs(torch, pair[flag], sql)
            row.setdefault(flag, []).append(warm * 1e3)
        for flag in (False, True):
            dev = device_profile(torch, lambda: pair[flag].run(sql))
            warm = statistics.median(row[flag])
            row[flag] = {"warm_ms": warm, "warm_ms_each": row[flag],
                         "device_ms": dev["device_ms"],
                         "busy": dev["device_ms"] / warm}
        spans = len(pair[True].last_trace.spans())
        tracing[q] = {"off": row[False], "on": row[True], "spans": spans}
        print(f"obs tracing {q} hash SF {SF}: warm medians of 3 "
              f"off {row[False]['warm_ms_each']} ms "
              f"(busy {row[False]['busy'] * 100:.1f} %), on "
              f"{row[True]['warm_ms_each']} ms (busy "
              f"{row[True]['busy'] * 100:.1f} %, {spans} spans); "
              f"on/off {row[True]['warm_ms'] / row[False]['warm_ms']:.4f}")

    dr = DistributedRunner(cat, n_workers=2, **CLUSTER_TIMEOUTS)
    try:
        base = dr.coordinator.url
        sql = at_scale("q3", TPCH["q3"], SF)
        doc, rows = _statement(base, sql, "breaker_engine=hash")
        require(doc["stats"]["state"] == "FINISHED",
                f"obs cluster q3: {doc.get('error')}")
        require(len(rows) == explained["q3"], "obs cluster q3: row count")
        qid = doc["id"]
        tr = _get(doc["traceUri"])
        levels = _levels(tr["tree"][0])
        for lv in ((0, "query"), (1, "stage"), (2, "task"), (3, "operator")):
            require(lv in levels, f"obs cluster trace lacks {lv}")
        prog = _get(doc["progressUri"])
        require(prog["fraction"] == 1.0, "obs cluster progress not at 1.0")
        ev = _get(f"{base}/v1/events?queryId={qid}")["events"]
        require([e["state"] for e in ev if e["kind"] == "lifecycle"][-1]
                == "finished", "obs cluster events: no finished transition")
        edoc, erows = _statement(base, "explain analyze " + sql,
                                 "breaker_engine=hash")
        require(edoc["stats"]["state"] == "FINISHED" and any(
            "-- task execution profile --" in r[0] for r in erows),
            f"obs cluster explain analyze: {edoc.get('error')}")
        metrics = {"coordinator": _get(f"{base}/v1/metrics", text=True)}
        metrics.update({w.node_id: _get(f"{w.url}/v1/metrics", text=True)
                        for w in dr.workers})
        for node, text in metrics.items():
            bad = lint_exposition(text)
            require(not bad, f"obs /v1/metrics of {node}: {bad[:3]}")
        cluster = {"spans": len(tr["spans"]),
                   "levels": sorted(f"{d}:{k}" for d, k in levels),
                   "events": len(ev), "progress": prog["fraction"]}
        print(f"obs cluster q3 hash SF {SF}: {len(tr['spans'])} spans "
              f"stitched over {len(levels)} (depth, kind) pairs, "
              f"{len(ev)} events, progress {prog['fraction']}; explain "
              f"analyze {len(erows)} lines; /v1/metrics of "
              f"{len(metrics)} nodes lint clean")

        sql3 = at_scale("q3", TPCH["q3"], SF)
        dp = LocalRunner(cat, ExecConfig(breaker_engine="hash",
                                         devprof="on"))
        dp.run(sql3)
        stats = dp.last_stats
        doc = devprof.device_memory_doc()
        _free, total = torch.cuda.mem_get_info()
        require(doc.get("platform") == "cuda" and doc.get("available"),
                f"obs devprof: {doc}")
        require(0 < doc["peakBytesInUse"] < total,
                f"obs devprof: peak {doc.get('peakBytesInUse')} of {total}")
        ratio = stats.get("devprof.drift_ratio")
        require(ratio is not None, "obs devprof: no reconciliation")
        dev_doc = {"peak_bytes": doc["peakBytesInUse"],
                   "peak_reserved_bytes": doc["peakBytesReserved"],
                   "total_bytes": total, "drift_ratio": ratio,
                   "query_peak_delta_bytes":
                       stats.get("devprof.peak_delta_bytes")}
        print(f"obs devprof q3 hash SF {SF}: platform cuda, allocator "
              f"peak {doc['peakBytesInUse']} B (reserved "
              f"{doc['peakBytesReserved']} B) of {total} B; query peak "
              f"delta {dev_doc['query_peak_delta_bytes']} B; device peak "
              f"over pool-ledger peak {ratio:.4g}")
        devprof.deactivate()

        with tempfile.TemporaryDirectory() as d:
            os.environ["PRESTO_TPU_CACHE_DIR"] = d
            try:
                pdoc, _ = _statement(base, sql, "breaker_engine=hash,"
                                     "profile=true")
            finally:
                del os.environ["PRESTO_TPU_CACHE_DIR"]
            uri = pdoc.get("profileUri") or ""
            path = uri[len("file://"):]
            require(uri.startswith("file://") and os.path.getsize(path) > 0,
                    f"obs profile: no Chrome trace ({uri!r})")
            print(f"obs profile=true: Chrome trace of "
                  f"{os.path.getsize(path)} bytes under the cache dir")
    finally:
        dr.close()
    seconds = time.perf_counter() - t0
    print(f"obs: phase took {seconds:.1f} s")
    print(json.dumps({"obs": {"explain_launches": launches,
                              "tracing": tracing, "cluster": cluster,
                              "devprof": dev_doc, "seconds": seconds}}))
    return launches


# ---------------------------------------------------------------------------
# phase 3c: TPC-DS

# the output columns of each TPC-DS query's ORDER BY (None: one row, or an
# ORDER BY on an expression)
DS_ORDER_KEYS = {
    "q1_returns_above_store_avg": ["ctr_customer_sk", "ctr_store_sk"],
    "q13_demographic_averages": None, "q15_catalog_by_zip": ["ca_zip"],
    "q19_brand_by_manufact": ["s", "i_brand_id"],
    "q21_inventory_before_after": ["w_warehouse_name", "i_item_id"],
    "q25_store_catalog_chain": ["i_item_id", "s_store_id"],
    "q26_catalog_demographics": ["i_item_id"],
    "q33_cross_channel_by_manufact": ["total_sales", "i_manufact_id"],
    "q37_item_inventory_window": ["i_item_id"],
    "q43_store_by_dow": ["s_store_name", "s_store_id"],
    "q46_tickets_by_city": ["ss_ticket_number"],
    "q48_or_banded_quantity": None,
    "q52_brand_by_eom": ["d_year", "ext_price", "i_brand_id"],
    "q55_brand_for_manager": ["ext_price", "i_brand_id"],
    "q62_web_ship_buckets": ["w_warehouse_name", "sm_type", "web_name"],
    "q65_store_item_vs_avg": ["s_store_name", "i_item_id"],
    "q73_ticket_counts": ["cnt", "c_customer_sk"],
    "q88_hour_buckets": None, "q92_web_above_item_avg": None,
    "q96_hour_window_count": None,
    "q99_catalog_ship_buckets": ["w_warehouse_name", "sm_type", "cc_name"],
    "q3_shape_brand_by_year": ["d_year", "s", "i_brand_id"],
    "q7_shape_demographics_filter": ["i_item_id"],
    "q42_shape_category_by_year": ["s", "d_year", "i_category_id",
                                   "i_category"],
    "cross_channel_union": ["i_brand_id"],
    "q22_shape_inventory_rollup": ["qoh", "i_product_name"],
    "web_channel_site_rollup": ["web_name"],
    "ds_q98_window_ratio": ["i_category", "i_size", "i_item_id",
                            "revenueratio"],
    "ds_q89_window_avg": None, "ds_q47_rank_selfjoin": None,
    "ds_q51_rows_running_sum": ["item_sk", "d_date"],
    "ds_lag_lead": ["ss_item_sk", "d_moy"],
    "ds_q44_global_rank": ["rnk", "item_sk"],
    "ds_q86_rollup": ["lochierarchy", "i_category", "i_size"],
    "ds_q86_rollup_rank": ["lochierarchy", "r", "i_category", "i_size"],
    "ds_q38_intersect": None, "ds_q87_except": None,
    "ds_union_distinct": None, "ds_q28_cross_distinct": None,
    "ds_nonequi_nljoin": None, "ds_q17_stddev": ["i_item_id", "s_state"],
    "ds_maxby_percentile": ["i_category"], "ds_date_functions": ["m"],
    "ds_round_sqrt": ["i_category"],
}
# Float columns on the card against the CPU and engine against engine:
# float sums and averages reduce with atomics (index_add_) and parallel
# scans on the card, in another order than on the CPU or the other engine,
# and a variance subtracts two such sums; 1e-9 covers that rounding
# (relative error up to about n * 2^-53 for n rows a group, times the
# cancellation) with room, where TPC-H's float columns (quotients of exact
# integer sums) hold to 1e-12.
DS_RTOL = 1e-9
# (query, engine) runs at SF 1 kept to their first run (no warm median, no
# device profile): q37 is the phase's longest (about 5 s a run, PERF.md
# §5) and ds_q47 the next, and the script must stay inside its time limit
DS_FIRST_RUN_ONLY = {(q, eng) for q in ("q37_item_inventory_window",
                                        "ds_q47_rank_selfjoin")
                     for eng in ENGINES}
# max_by over a hash join: the card's probe order is not deterministic, so
# a group's tied maxima may give another row; the oracle holds the key
DS_TIES = {"ds_maxby_percentile": "top_item"}


def ds_agree(got, want, q, label, ties=None) -> str:
    """frames_agree at DS_RTOL, where `ties` names a column that may hold
    another of a group's tied rows (checked against the oracle apart)."""
    if ties is not None:
        got, want = got.drop(columns=[ties]), want.drop(columns=[ties])
    return frames_agree(got, want, DS_ORDER_KEYS[q], label, DS_RTOL)


def ds_oracles(conn):
    """Nine of the TPC-DS queries from the tables' arrays with numpy and
    pandas: INTERSECT, EXCEPT and UNION as set operations on pairs, lag/
    lead as a groupby shift, the ROWS running sum as a groupby cumsum, the
    global rank as rank(method="min"), the rollup as three groupbys
    concatenated, the cross join of three aggregates with masks and
    nunique, the non-equi join as a broadcast compare. Decimals on their
    unscaled integers."""
    import numpy as np
    import pandas as pd
    from decimal import Decimal

    def table(name):
        conn.get_table(name)
        return conn.tables[name]

    def dec(v):
        return Decimal(int(v)).scaleb(-2)

    dd, it = table("date_dim").arrays, table("item")
    ss, cs = table("store_sales").arrays, table("catalog_sales").arrays
    ws = table("web_sales").arrays
    items = pd.DataFrame({"item": it.arrays["i_item_sk"],
                          "brand": it.arrays["i_brand"],
                          "cat": it.arrays["i_category"],
                          "size": it.arrays["i_size"]})

    def dates(mask):
        return pd.DataFrame({"date": dd["d_date_sk"][mask],
                             "moy": dd["d_moy"][mask],
                             "d_date": dd["d_date"][mask]})

    y2000 = dd["d_year"] == 2000

    def brand_moy(fact, date_col, item_col, mask):
        f = pd.DataFrame({"date": fact[date_col], "item": fact[item_col]})
        m = f.merge(dates(mask), on="date").merge(items, on="item")
        return set(zip(m["brand"], m["moy"]))

    out = {}
    sales = brand_moy(ss, "ss_sold_date_sk", "ss_item_sk", y2000)
    out["ds_q38_intersect"] = pd.DataFrame({"n": [len(
        sales & brand_moy(cs, "cs_sold_date_sk", "cs_item_sk", y2000))]})
    out["ds_q87_except"] = pd.DataFrame({"n": [len(sales - brand_moy(
        cs, "cs_sold_date_sk", "cs_item_sk", y2000 & (dd["d_dom"] < 3)))]})
    out["ds_union_distinct"] = pd.DataFrame({"n": [len(np.union1d(
        ss["ss_item_sk"], cs["cs_item_sk"]))]})

    f = pd.DataFrame({"date": ss["ss_sold_date_sk"], "item": ss["ss_item_sk"],
                      "qty": ss["ss_quantity"], "price": ss["ss_sales_price"]})
    f = f.merge(dates(y2000), on="date")
    g = (f[f["item"] < 50].groupby(["item", "moy"])["qty"].sum()
         .reset_index().sort_values(["item", "moy"], ignore_index=True))
    by = g.groupby("item")["qty"]

    def shifted(k):
        return [None if v != v else int(v) for v in by.shift(k)]

    out["ds_lag_lead"] = pd.DataFrame({
        "ss_item_sk": g["item"], "d_moy": g["moy"], "s": g["qty"],
        "p": shifted(1), "nx": shifted(-1)})
    g = (f[f["item"] < 200].groupby(["item", "d_date"])["price"].sum()
         .reset_index().sort_values(["item", "d_date"], ignore_index=True))
    g["cume"] = g.groupby("item")["price"].cumsum()
    g = g.head(100)
    out["ds_q51_rows_running_sum"] = pd.DataFrame({
        "item_sk": g["item"], "d_date": g["d_date"],
        "cume_sales": [dec(v) for v in g["cume"]]})

    st4 = ss["ss_store_sk"] == 4
    g = pd.DataFrame({"item": ss["ss_item_sk"][st4],
                      "p": ss["ss_net_profit"][st4]}).groupby("item")["p"]
    avg = g.sum().astype(np.float64) * (1.0 / 100.0) / g.size()
    r = avg.rank(method="min", ascending=False).astype(np.int64)
    g = pd.DataFrame({"item_sk": avg.index, "rank_col": avg.to_numpy(),
                      "rnk": r.to_numpy()})
    out["ds_q44_global_rank"] = g[g["rnk"] < 11].sort_values(
        ["rnk", "item_sk"], ignore_index=True)

    w = pd.DataFrame({"date": ws["ws_sold_date_sk"], "item": ws["ws_item_sk"],
                      "paid": ws["ws_net_paid"]})
    w = w.merge(dates(y2000), on="date").merge(items, on="item")
    cat_d, size_d = it.dicts["i_category"], it.dicts["i_size"]
    rows = [(int(w["paid"].sum()), None, None, 2)]
    for c, v in w.groupby("cat")["paid"].sum().items():
        rows.append((int(v), str(cat_d.values[c]), None, 1))
    for (c, z), v in w.groupby(["cat", "size"])["paid"].sum().items():
        rows.append((int(v), str(cat_d.values[c]), str(size_d.values[z]), 0))
    rows.sort(key=lambda t: (-t[3], t[1] is None, t[1] or "", t[2] is None,
                             t[2] or ""))
    rows = rows[:100]
    out["ds_q86_rollup"] = pd.DataFrame({
        "total_sum": [dec(t[0]) for t in rows],
        "i_category": [t[1] for t in rows], "i_size": [t[2] for t in rows],
        "lochierarchy": [t[3] for t in rows]})

    qty, lp, wc = ss["ss_quantity"], ss["ss_list_price"], ss["ss_wholesale_cost"]
    row = {}
    for b, (q0, q1, l0, l1, w0, w1) in enumerate(
            [(0, 5, 8, 18, 57, 77), (6, 10, 90, 100, 31, 51),
             (11, 15, 142, 152, 79, 99)], start=1):
        m = ((qty >= q0) & (qty <= q1)
             & (((lp >= l0 * 100) & (lp <= l1 * 100))
                | ((wc >= w0 * 100) & (wc <= w1 * 100))))
        v = lp[m]
        row[f"b{b}_lp"] = [float(v.sum()) * (1.0 / 100.0) / len(v)]
        row[f"b{b}_cnt"] = [len(v)]
        row[f"b{b}_cntd"] = [len(np.unique(v))]
    out["ds_q28_cross_distinct"] = pd.DataFrame(row)

    emp = table("store").arrays["s_number_employees"]
    man = it.arrays["i_manufact_id"]
    out["ds_nonequi_nljoin"] = pd.DataFrame({"n": [int(
        ((emp[:, None] >= man[None, :]) & (emp[:, None] <= man[None, :] + 1))
        .sum())]})
    return out


def ds_max_ties(conn):
    """i_category -> the i_item_ids of the store sales at that category's
    highest ss_sales_price: the rows max_by may take."""
    import pandas as pd

    it = conn.tables["item"]
    ss = conn.tables["store_sales"].arrays
    f = pd.DataFrame({"item": ss["ss_item_sk"], "price": ss["ss_sales_price"]})
    f = f.merge(pd.DataFrame({"item": it.arrays["i_item_sk"],
                              "cat": it.arrays["i_category"],
                              "id": it.arrays["i_item_id"]}), on="item")
    top = f[f["price"] == f.groupby("cat")["price"].transform("max")]
    cat_d, id_d = it.dicts["i_category"], it.dicts["i_item_id"]
    return {str(cat_d.values[c]): {str(id_d.values[i]) for i in g["id"]}
            for c, g in top.groupby("cat")}


def check_ties(got, ties, label) -> None:
    for c, top in zip(got["i_category"], got["top_item"]):
        require(top in ties.get(c, ()), f"{label}: max_by gave {top} for "
                f"{c}, not one of its top-priced items")


def ds_intersect_all(torch, runner, conn):
    """INTERSECT ALL at SF 1, whose count runs on the host (as the JAX
    package's does): against a Counter-style oracle, and timed."""
    import numpy as np

    sql = ("select ss_item_sk k from store_sales where ss_quantity < 10 "
           "intersect all select cs_item_sk from catalog_sales "
           "where cs_quantity < 10")
    ss = conn.tables["store_sales"].arrays
    cs = conn.tables["catalog_sales"].arrays
    a = np.bincount(ss["ss_item_sk"][ss["ss_quantity"] < 10])
    b = np.bincount(cs["cs_item_sk"][cs["cs_quantity"] < 10])
    n = min(len(a), len(b))
    want = np.repeat(np.arange(n), np.minimum(a[:n], b[:n]))
    out, sec = timed_runs(torch, runner, sql)
    got = np.sort(out["k"].to_numpy().astype(np.int64))
    require(np.array_equal(got, want), "INTERSECT ALL at SF 1 differs from "
            "its oracle")
    dev = device_profile(torch, lambda: runner.run(sql))
    print(f"tpcds intersect_all SF {SF}: {len(got)} rows equal to the oracle; "
          f"warm median of 3 {sec * 1e3:.1f} ms (the row count on the host), "
          f"device time {dev['device_ms']:.2f} ms")
    return {"rows": len(got), "warm_ms": sec * 1e3, **dev}


def phase_tpcds(torch, errs):
    """TPC-DS at SF 1 on the card: all 44 queries of
    presto_tpu_torch/catalog/tpcds_queries.py under breaker_engine auto and
    hash. Each returns rows; the engines agree (`ds_agree`); nine equal
    numpy/pandas oracles (`ds_oracles`) and ds_maxby_percentile's max_by
    takes one of its category's tied rows. Per query and engine: launches
    of the first run (counts reset just before it, read just after), the
    warm median of 3, store_sales rows/s, and the device time of one more
    run (torch.profiler), but for the runs of DS_FIRST_RUN_ONLY, which
    keep their first run. Under hash each of the four kernels must launch
    somewhere on this path. One more hash run a query records each
    kernel's largest input, held to its contract by `check_recorded`. At
    SF 0.01 all 88 runs give the same frame on the card as on the CPU.
    Returns (launches under hash by kernel, summary, name -> [(label,
    arguments)] for the timing phase: each kernel's largest TPC-DS
    input)."""
    from presto_tpu_torch.catalog.tpcds import tpcds_catalog
    from presto_tpu_torch.catalog.tpcds_queries import QUERIES as TPCDS
    from presto_tpu_torch.exec import ExecConfig, LocalRunner
    from presto_tpu_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    cat = tpcds_catalog(SF)
    conn = cat.connectors["tpcds"]
    for t in conn.table_names():
        conn.get_table(t)
    n_ss = conn.tables["store_sales"].num_rows
    nbytes = sum(a.nbytes for t in conn.tables.values()
                 for a in t.arrays.values())
    oracles = ds_oracles(conn)
    ties = ds_max_ties(conn)
    print(f"tpcds: SF {SF} tables ({len(conn.tables)}, {nbytes} bytes of "
          f"columns, {n_ss} store_sales rows) and oracles ready in "
          f"{time.perf_counter() - t0:.1f} s")
    runners = {e: LocalRunner(cat, ExecConfig(breaker_engine=e))
               for e in ENGINES}
    summary = []
    largest = {}
    hash_launches = {}
    for q, sql in TPCDS.items():
        outs = {}
        for eng in ENGINES:
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = runners[eng].run(sql)
            torch.cuda.synchronize()
            first = time.perf_counter() - t1
            launches = {k: v for k, v in launch_counts().items() if v}
            grace = runners[eng].last_stats.get("spill.partitions", 0) > 0
            if eng == "hash":
                for k, v in launches.items():
                    hash_launches[k] = hash_launches.get(k, 0) + v
            require(len(out) > 0, f"{q} {eng} SF {SF}: no row")
            outs[eng] = out
            if q in oracles:
                ds_agree(out, oracles[q], q, f"{q} {eng} SF {SF} oracle")
            if (q, eng) in DS_FIRST_RUN_ONLY:
                summary.append({"query": q, "engine": eng, "rows": len(out),
                                "first_ms": first * 1e3, "grace": grace,
                                "launches": launches})
                print(f"tpcds {q} {eng} SF {SF}: grace {grace}; {len(out)} "
                      f"rows; first run {first * 1e3:.1f} ms (no warm runs)"
                      f"; launches {json.dumps(launches)}"
                      + ("; equal to the oracle" if q in oracles else ""))
                continue
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                again = runners[eng].run(sql)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t1)
            ds_agree(again, out, q, f"{q} {eng} rerun", DS_TIES.get(q))
            sec = statistics.median(ts)
            dev = device_profile(torch, lambda: runners[eng].run(sql))
            if q in DS_TIES:
                check_ties(out, ties, f"{q} {eng} SF {SF}")
            summary.append({"query": q, "engine": eng, "rows": len(out),
                            "warm_ms": sec * 1e3, "first_ms": first * 1e3,
                            "store_sales_rows_per_s": n_ss / sec,
                            "grace": grace, "launches": launches, **dev})
            print(f"tpcds {q} {eng} SF {SF}: grace {grace}; {len(out)} rows; "
                  f"warm median of 3 {sec * 1e3:.1f} ms, {n_ss / sec:.4g} "
                  f"store_sales "
                  f"rows/s; first run {first * 1e3:.1f} ms; launches "
                  f"{json.dumps(launches)}; device time of one run "
                  f"{dev['device_ms']:.2f} ms ({dev['device_ms'] / sec / 10:.1f}"
                  f" % of the warm median), the port's kernels "
                  f"{dev['port_kernels_ms']:.3f} ms; largest "
                  f"{json.dumps(dev['top'])}"
                  + ("; equal to the oracle" if q in oracles else "")
                  + ("; max_by took a top-priced row" if q in DS_TIES
                     else ""))
        how = ds_agree(outs["hash"], outs["auto"], q,
                       f"{q} SF {SF} hash vs auto", DS_TIES.get(q))
        print(f"tpcds {q} SF {SF}: hash and auto {how}")
        inputs = record_run(torch, lambda: runners["hash"].run(sql))
        done = check_recorded(torch, inputs, errs)
        print(f"tpcds {q} hash SF {SF}: each kernel's largest input holds its "
              f"contract: {json.dumps(done)}")
        for name, (size, args) in inputs.items():
            if size > largest.get(name, (0, None, None))[0]:
                largest[name] = (size, q, args)
        del inputs
    for name in REPLACES:
        require(hash_launches.get(name, 0) > 0,
                f"kernel {name} never launched on the TPC-DS path under hash")
    print(f"tpcds: launches of the 44 first runs under hash: "
          f"{json.dumps(hash_launches)}")
    setop = ds_intersect_all(torch, runners["hash"], conn)
    del runners, cat, conn

    print(f"tpcds: SF {SF} queries done at {time.perf_counter() - t0:.1f} s")
    small = tpcds_catalog(SMALL_SF)
    small_ties = None
    hows = {}
    for q, sql in TPCDS.items():
        for eng in ENGINES:
            cfg = ExecConfig(breaker_engine=eng)
            on_gpu = LocalRunner(small, cfg).run(sql)
            on_cpu = LocalRunner(small, cfg, device="cpu").run(sql)
            if q in DS_TIES:
                if small_ties is None:
                    small_ties = ds_max_ties(small.connectors["tpcds"])
                check_ties(on_gpu, small_ties, f"{q} {eng} SF {SMALL_SF}")
            hows[f"{q} {eng}"] = ds_agree(
                on_gpu, on_cpu, q, f"{q} {eng} SF {SMALL_SF} card vs CPU",
                DS_TIES.get(q))
    print(f"tpcds SF {SMALL_SF}: card against CPU for {len(hows)} runs: "
          f"{json.dumps(hows)}")
    print(json.dumps({"tpcds": summary, "intersect_all": setop}))
    print(f"tpcds: phase took {time.perf_counter() - t0:.1f} s")
    timed = {name: [(f"{q} hash SF {SF}, the largest of the TPC-DS queries",
                     args)] for name, (_, q, args) in largest.items()}
    return hash_launches, timed


# ---------------------------------------------------------------------------
# phase 4: timing


def cuda_ms(torch, fn, iters=100, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, reps=1):
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def distinct_bytes(*ts):
    """Bytes of the distinct tensors among ts (a tensor passed twice is
    read once)."""
    seen = {}
    for t in ts:
        seen[(t.data_ptr(), t.numel(), t.element_size())] = \
            t.numel() * t.element_size()
    return sum(seen.values())


def kernel_alone_ms(torch, launch, flush=None, reps=50):
    """Median CUDA-event time of one bare launch, events around each
    launch. Before each: `flush` (evicting the L2: the cold reading;
    without it the inputs stay where the previous launch left them) and a
    spin kernel that keeps the card busy while the host enqueues, so no
    host time falls between the events. (Events around back-to-back
    launches would time the host: one Python-side launch takes longer
    than these kernels.) Every launch writes or zeroes all of its outputs
    itself, so nothing is reset between launches, and the time covers
    everything the C launch does, its memsets included."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _rc(err, what):
    require(err == 0, f"bare launch of {what} failed: cudaError {err}")


def _bare_grouped_sums(torch, lib, sp, gid, states, g):
    from presto_tpu_torch.ops import groupby_kernels as gk

    n = gid.shape[0]
    tables, parts = gk.state_tables(gid, states, g)
    out = torch.zeros(len(states), g, dtype=torch.int64, device=gid.device)

    # each call keeps its descriptor array alive beside the arguments
    calls = [(arr, (gid.data_ptr(), arr.buffer_info()[0], len(plan.states),
                    out.data_ptr(), 0, n, g, plan.groups_tile,
                    plan.states_tile, sp))
             for plan, arr in tables]

    def launch():
        for _arr, args in calls:
            _rc(lib.grouped_sums_launch(*args), "grouped_sums")
    return (launch, distinct_bytes(gid, *_tensors(parts))
            + out.numel() * 8, f"n={n} S={len(states)} G={g}", out)


def _path(shift):
    return "global" if not shift else f"ranges of 2^{shift} slots"


def _bare_group_insert(torch, lib, sp, planes, slot0, live, cap, shift=None):
    """The launch zeroes or writes every output itself."""
    from presto_tpu_torch.ops import hash_kernels as hk

    k, n = planes.shape
    tcap = 2 * cap
    shift = lib.group_insert_shift(
        k, cap, hk.group_insert_plan(n) if shift is None else shift)
    gid, table, occ, stat, scratch = hk.group_insert_buffers(
        k, n, cap, shift, planes.device)
    args = (slot0.data_ptr(), planes.data_ptr(), live.data_ptr(),
            gid.data_ptr(), table.data_ptr(), occ.data_ptr(),
            stat.data_ptr(), hk._ptr(scratch), n, k, cap, shift, sp)

    def launch():
        _rc(lib.group_insert_launch(*args), "group_insert")
    return (launch, distinct_bytes(planes, slot0, live) + n * 4
            + k * tcap * 8 + tcap * 4 + 8,
            f"n={n} K={k} cap={cap}, {_path(shift)}",
            (gid, table, occ, stat[0], stat[1]))


def _bare_join_insert(torch, lib, sp, slot0, live, tcap, shift=None):
    """The launch writes every slot (its -1 fill included in its time)."""
    from presto_tpu_torch.ops import hash_kernels as hk

    n = slot0.shape[0]
    shift = lib.join_insert_shift(
        tcap, hk.join_insert_plan(tcap) if shift is None else shift)
    slot_row, scratch = hk.join_insert_buffers(n, tcap, shift, slot0.device)
    args = (slot0.data_ptr(), live.data_ptr(), slot_row.data_ptr(),
            hk._ptr(scratch), n, tcap, shift, sp)

    def launch():
        _rc(lib.join_insert_launch(*args), "join_insert")
    return (launch, distinct_bytes(slot0, live) + tcap * 4,
            f"n={n} tcap={tcap}, {_path(shift)}", slot_row)


def probe_bytes(torch, slot0, pkeys, plive, slot_row, bkeys, f):
    """Bytes join_probe must move on these inputs: the probe rows' slot0,
    keys and live flags read once, its outputs written once, and of the
    table only what the live rows' walks reach: each distinct slot visited
    (up to the free slot that ends a walk) read once, and the key of each
    distinct occupied slot visited."""
    k, n = pkeys.shape
    tcap = slot_row.shape[0]
    moved = (n * (slot0.element_size() + k * pkeys.element_size()
                  + plive.element_size()) + n * f * 4 + n * 4 + 4)
    occ = slot_row >= 0
    free = torch.nonzero(~occ).flatten()
    s = slot0[plive].long()
    if s.numel() == 0:
        return moved
    if free.numel() == 0:
        return moved + tcap * (slot_row.element_size()
                               + k * bkeys.element_size())
    idx = torch.arange(tcap, device=slot0.device)
    # the first free slot at or after each slot, past tcap where it wraps
    nxt = torch.where(occ, 2 * tcap, idx).flip(0).cummin(0).values.flip(0)
    nxt = torch.where(nxt >= 2 * tcap, free[0] + tcap, nxt)
    end = nxt[s]
    # each walk ends at a free slot; the walks that end at one cover the
    # slots from the farthest start to it
    far = torch.zeros(tcap, dtype=torch.long, device=slot0.device)
    far.scatter_reduce_(0, end % tcap, end - s, "amax")
    ends = torch.unique(end % tcap)
    visited = int((far[ends] + 1).sum())
    occupied = visited - ends.numel()
    return (moved + visited * slot_row.element_size()
            + occupied * k * bkeys.element_size())


def _bare_join_probe(torch, lib, sp, slot0, pkeys, plive, slot_row, bkeys, f):
    k, n = pkeys.shape
    dev = slot0.device
    mm = torch.empty((n, f), dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    stat = torch.empty(1, dtype=torch.int32, device=dev)

    args = (slot0.data_ptr(), pkeys.data_ptr(), plive.data_ptr(),
            slot_row.data_ptr(), bkeys.data_ptr(), mm.data_ptr(),
            cnt.data_ptr(), stat.data_ptr(), 0, n, k, bkeys.shape[1],
            slot_row.shape[0], f, sp)

    def launch():
        _rc(lib.join_probe_launch(*args), "join_probe")
    return (launch, probe_bytes(torch, slot0, pkeys, plive, slot_row, bkeys,
                                f),
            f"n={n} K={k} F={f} build={bkeys.shape[1]} "
            f"tcap={slot_row.shape[0]}", (mm, cnt, stat))


def bare_launches(torch, inputs):
    """name → (launch, bytes, shape, outputs): the bare `lib.*_launch`
    call of each kernel on the largest inputs the query phase handed its
    launcher, with outputs allocated once; bytes are the distinct inputs
    read once plus the outputs written once."""
    from presto_tpu_torch.kernels._build import library, stream_ptr

    gsl, htl = library("grouped_sums"), library("hash_table")
    sp = stream_ptr(torch.device("cuda"))
    return {
        "grouped_sums": _bare_grouped_sums(torch, gsl, sp,
                                           *inputs["grouped_sums"][1]),
        "group_insert": _bare_group_insert(torch, htl, sp,
                                           *inputs["group_insert"][1]),
        "join_insert": _bare_join_insert(torch, htl, sp,
                                         *inputs["join_insert"][1]),
        "join_probe": _bare_join_probe(torch, htl, sp,
                                       *inputs["join_probe"][1]),
    }


def l2_flush(torch):
    """(flush, its own CUDA-event time in ms): one write of a scratch
    tensor larger than the L2, then a read of another, so that the L2 is
    left holding clean lines (after the write alone, the timed kernel would
    pay for writing the flush's dirty lines back)."""
    dev = torch.device("cuda")
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    clean = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)

    def flush():
        scratch.fill_(1.0)
        torch.sum(clean, dim=0, out=total)
    return flush, cuda_ms(torch, flush, iters=20)


# Large shapes of the two inserts, built on the card from a fixed seed
# (synthetic inputs of the timing phase, not query inputs):
# - group_insert: TPC-H Q18's GROUP BY l_orderkey over lineitem at SF 1:
#   6,001,215 live rows, K = 1, 1,500,000 orders of 1-7 lines listed
#   together (runs of equal keys), cap 2^21; and cap 2^20 (overflow);
# - join_insert: the build side of Q3's orders join at SF 10: 15,000,000
#   unique keys, live where o_orderdate < 1995-03-15 over the generator's
#   dates (about 48.6 %), tcap = 2 x round_up_capacity(15,000,000).
LARGE_SEED = 20261017
Q18_LINES, Q18_ORDERS = 6_001_215, 1_500_000
Q18_CAPS = (1 << 21, 1 << 20)
Q3_SF10_ORDERS = 15_000_000


def large_group_input(torch):
    """(planes int64[1, n], live) of the Q18 shape: each order's lines
    1-7 (uniform), then the first orders short of 7 lines (or over 1)
    given one more (or one fewer) so that the lines total Q18_LINES."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(LARGE_SEED)
    lines = torch.randint(1, 8, (Q18_ORDERS,), generator=g, device=dev)
    diff = Q18_LINES - int(lines.sum())
    if diff > 0:
        lines[torch.nonzero(lines < 7).flatten()[:diff]] += 1
    elif diff < 0:
        lines[torch.nonzero(lines > 1).flatten()[:-diff]] -= 1
    okey = (torch.arange(Q18_ORDERS, device=dev) + 1) * 4  # sparse, sorted
    planes = torch.repeat_interleave(okey, lines).view(1, -1)
    require(planes.shape[1] == Q18_LINES, "Q18 shape: wrong row count")
    return planes, torch.ones(Q18_LINES, dtype=torch.bool, device=dev)


MERGE_BATCH_ROWS = 1 << 17  # ExecConfig.batch_rows: one scan batch a step
MERGE_CAPS = (1 << 19, 1 << 20, 1 << 21)


def merge_group_input(torch, planes, cap):
    """(planes, slot0, live, runs) of one merge step of LocalRunner's
    aggregate (exec/runtime.py merge_step) for Q18's GROUP BY l_orderkey
    at cap: the previous group table (2 cap rows in slot order, its keys,
    live where occupied), then the next MERGE_BATCH_ROWS lines of
    lineitem in orderkey order. The orders are the first cap / 2^21 of
    Q18's SF 1 orders (lineitem at a scale factor of cap / 2^21, which
    the table holds at SF 1's load), the batch the last full batch of
    their lines, the table the groups of the lines before it. runs: the
    share of live rows whose key equals the row's before it."""
    from presto_tpu_torch.ops import hash_kernels as hk
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    keys = planes[0]
    orders = Q18_ORDERS * cap // Q18_CAPS[0]
    new = torch.ones_like(keys, dtype=torch.bool)
    new[1:] = keys[1:] != keys[:-1]
    m = int(torch.nonzero(new).flatten()[orders]) if orders < int(
        new.sum()) else keys.numel()
    acc = planes[:, :m - MERGE_BATCH_ROWS].contiguous()
    tcap = 2 * cap
    acc_live = torch.ones(acc.shape[1], dtype=torch.bool, device=acc.device)
    acc_slot0 = slot_hash(hash_columns(list(acc)), tcap)
    out = hk.group_insert(acc, acc_slot0, acc_live, cap)
    group_invariants(torch, acc, acc_live, cap, out)
    _, table, occ, _, _ = out
    merged = torch.cat([table[0], keys[m - MERGE_BATCH_ROWS:m]]).view(1, -1)
    live = torch.cat([occ > 0, torch.ones(MERGE_BATCH_ROWS, dtype=torch.bool,
                                          device=acc.device)])
    batch = keys[m - MERGE_BATCH_ROWS:m]
    runs = int((batch[1:] == batch[:-1]).sum()) / int(live.sum())
    return (merged, slot_hash(hash_columns(list(merged)), tcap), live, runs)


def large_join_input(torch):
    """(slot0, live, tcap) of Q3's orders build side at SF 10."""
    from presto_tpu_torch.batch import round_up_capacity
    from presto_tpu_torch.catalog.tpch import _EPOCH_1992, _EPOCH_1998_END
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(LARGE_SEED + 1)
    n = Q3_SF10_ORDERS
    okey = (torch.arange(n, device=dev) + 1) * 4
    odate = torch.randint(_EPOCH_1992, _EPOCH_1998_END - 151, (n,),
                          generator=g, device=dev)
    tcap = 2 * round_up_capacity(n, minimum=64)
    return (slot_hash(hash_columns([okey]), tcap),
            odate < _days(1995, 3, 15), tcap)


def _large_row(torch, bare, flush, launcher, wrapper):
    """Kernel alone, cold (the L2 flushed before each launch: `ms`) and
    warm (what the previous launch left in the L2: `ms_warm`), launcher
    and wrapper of one large shape."""
    launch, b, shape, _outs = bare
    return {"shape": shape, "bytes": b,
            "bound": b / HBM_BYTES_PER_S * 1e3,
            "ms": kernel_alone_ms(torch, launch, flush),
            "ms_warm": kernel_alone_ms(torch, launch),
            "launcher": cuda_ms(torch, launcher, iters=20),
            "wrapper": cuda_ms(torch, wrapper, iters=20)}


def _large_group(torch, lib, sp, flush, label, planes, slot0, live, cap):
    """One large group_insert shape: the bare launch and the wrapper hold
    group_invariants, then _large_row."""
    from presto_tpu_torch.ops import hash_kernels as hk

    bare = _bare_group_insert(torch, lib, sp, planes, slot0, live, cap)
    bare[0]()
    torch.cuda.synchronize()
    ng, ovf, distinct = group_invariants(torch, planes, live, cap, bare[3])
    group_invariants(torch, planes, live, cap,
                     hk.group_insert(planes, slot0, live, cap))
    r = _large_row(torch, bare, flush,
                   lambda: hk._group_insert_cuda(planes, slot0, live, cap),
                   lambda: hk.group_insert(planes, slot0, live, cap))
    r["shape"] = f"{label}: {r['shape']}"
    r["check"] = f"distinct={distinct} n_groups={ng} overflow={ovf}"
    return r


def time_large(torch, flush):
    """Check and time group_insert and join_insert at the large shapes:
    Q18's lineitem in one call (caps 2^21 and 2^20), Q18's merge steps
    (merge_group_input, caps MERGE_CAPS) and Q3's orders build side at SF
    10. Each bare launch's result, and the wrapper's, must hold the
    kernel's invariants (group_invariants, join_invariants: the serial
    plain versions are not run at these sizes)."""
    from presto_tpu_torch.kernels._build import library, stream_ptr
    from presto_tpu_torch.ops import hash_kernels as hk
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    lib = library("hash_table")
    sp = stream_ptr(torch.device("cuda"))
    rows = {"group_insert": [], "join_insert": []}
    planes, live = large_group_input(torch)
    for cap in Q18_CAPS:
        slot0 = slot_hash(hash_columns(list(planes)), 2 * cap)
        rows["group_insert"].append(_large_group(
            torch, lib, sp, flush, "Q18 SF 1", planes, slot0, live, cap))
    for cap in MERGE_CAPS:
        mp, ms, ml, runs = merge_group_input(torch, planes, cap)
        rows["group_insert"].append(_large_group(
            torch, lib, sp, flush, f"Q18 merge step (live rows in runs "
            f"{runs:.4f})", mp, ms, ml, cap))
    del planes, live, slot0, mp, ms, ml
    slot0, live, tcap = large_join_input(torch)
    bare = _bare_join_insert(torch, lib, sp, slot0, live, tcap)
    bare[0]()
    torch.cuda.synchronize()
    join_invariants(torch, slot0, live, bare[3])
    join_invariants(torch, slot0, live, hk.join_insert(slot0, live, tcap))
    r = _large_row(torch, bare, flush,
                   lambda: hk._join_insert_cuda(slot0, live, tcap),
                   lambda: hk.join_insert(slot0, live, tcap))
    r["shape"] = f"Q3 orders SF 10: {r['shape']}"
    r["check"] = f"live={int(live.sum())}"
    rows["join_insert"].append(r)
    for name, rs in rows.items():
        for r in rs:
            print_large(name, r)
    return rows


def print_large(name, r):
    print(f"timing {name} [large: {r['shape']}; {r['check']}]: "
          f"kernel alone cold {r['ms']:.4f} ms, warm "
          f"{r['ms_warm']:.4f} ms; launcher {r['launcher']:.4f} ms; "
          f"wrapper {r['wrapper']:.4f} ms; plain: not run (serial); "
          f"bound {r['bound']:.5f} ms ({r['bytes']} bytes); "
          f"invariants hold")
    require(r["ms"] >= r["bound"], f"{name} large: kernel-alone time "
            f"{r['ms']:.5f} ms beats its byte bound")


def time_tpch22(torch, flush, timed, family="tpch"):
    """Time each kernel on the inputs a query phase kept (`phase_tpch22`,
    `phase_tpcds`; already held to their contracts there), cold and warm,
    as time_large does."""
    from presto_tpu_torch.kernels._build import library, stream_ptr
    from presto_tpu_torch.ops import groupby_kernels as gk
    from presto_tpu_torch.ops import hash_kernels as hk

    libs = {"grouped_sums": library("grouped_sums")}
    libs.update(dict.fromkeys(("group_insert", "join_insert", "join_probe"),
                              library("hash_table")))
    bares = {"grouped_sums": _bare_grouped_sums,
             "group_insert": _bare_group_insert,
             "join_insert": _bare_join_insert, "join_probe": _bare_join_probe}
    launchers = {"grouped_sums": (gk._grouped_sums_cuda, gk.grouped_sums),
                 "group_insert": (hk._group_insert_cuda, hk.group_insert),
                 "join_insert": (hk._join_insert_cuda, hk.join_insert),
                 "join_probe": (hk._join_probe_cuda, hk.join_probe)}
    sp = stream_ptr(torch.device("cuda"))
    rows = {}
    for name, cases in timed.items():
        for label, args in cases:
            r = _large_row(torch, bares[name](torch, libs[name], sp, *args),
                           flush, _call(launchers[name][0], args),
                           _call(launchers[name][1], args))
            r["shape"] = f"{family} {label}: {r['shape']}"
            r["check"] = "held to its contract in the query phase"
            print_large(name, r)
            rows.setdefault(name, []).append(r)
    return rows


def _call(fn, args):
    return lambda: fn(*args)


def phase_timing(torch, inputs, timed, ds_timed, errs):
    """Each kernel on the inputs the query phase handed its launcher:
    - kernel alone: the bare `lib.*_launch` on outputs allocated once
      (`bare_launches`), warm (inputs as the last launch left them in L2)
      and, for kernels whose inputs and outputs fit under the L2, cold (the
      L2 flushed before each launch); the cold time is the one held
      against the byte bound. Each reading covers everything the C launch
      does, its memsets included, since the bound counts those bytes;
    - launcher: the module's private `_*_cuda` (the kernel plus the
      allocation of its outputs);
    - wrapper: the public function (plus its input conversions);
    - plain: the plain version on the same inputs; for grouped_sums also
      one `index_add_` call on the states stacked as int64.
    Then group_insert and join_insert at their large shapes (`time_large`,
    cold and warm at every shape), and each kernel on the 22-query inputs
    `timed` and on its largest TPC-DS input `ds_timed` (`time_tpch22`),
    where the serial plain versions are not run."""
    from presto_tpu_torch.ops import groupby_kernels as gk
    from presto_tpu_torch.ops import hash_kernels as hk

    flush, flush_ms = l2_flush(torch)
    print(f"timing: L2 flush (write of {FLUSH_BYTES} B, read of as many) "
          f"{flush_ms:.4f} ms, outside the events of the cold launches")
    bare = bare_launches(torch, inputs)
    rows = {}
    for name, (launch, b, shape, _outs) in bare.items():
        warm = kernel_alone_ms(torch, launch)
        cold = (kernel_alone_ms(torch, launch, flush)
                if b < L2_BYTES else None)
        rows[name] = {"ms_warm": warm, "ms_cold": cold, "bytes": b,
                      "shape": shape}

    gid, states, g = inputs["grouped_sums"][1]
    r = rows["grouped_sums"]
    r["launcher"] = cuda_ms(torch, lambda: gk._grouped_sums_cuda(gid, states,
                                                                  g))
    r["wrapper"] = cuda_ms(torch, lambda: gk.grouped_sums(gid, states, g))
    r["plain"] = cuda_ms(torch, lambda: gk.grouped_sums_plain(gid, states, g))
    # the library call's input: the states widened and stacked, untimed
    vals = torch.stack([v.to(torch.int64) if m is None
                        else torch.where(m, v.to(torch.int64), 0)
                        for v, m in map(gk._split, states)])
    idx = torch.where((gid >= 0) & (gid < g), gid.long(), g)
    r["library"] = cuda_ms(torch, lambda: torch.zeros(
        len(states), g + 1, dtype=torch.int64, device=gid.device)
        .index_add_(1, idx, vals))
    n = gid.shape[0]
    r["stacked_bytes"] = n * (4 + 8 * len(states)) + len(states) * g * 8
    errs["grouped_sums"] = max(errs["grouped_sums"],
                               check_grouped_sums(torch, gid, states, g))

    planes, slot0, live, cap = inputs["group_insert"][1]
    r = rows["group_insert"]
    r["launcher"] = cuda_ms(torch, lambda: hk._group_insert_cuda(
        planes, slot0, live, cap))
    r["wrapper"] = cuda_ms(torch, lambda: hk.group_insert(planes, slot0, live,
                                                          cap))
    r["plain"] = host_ms(torch, lambda: hk.group_insert_plain(
        planes.cpu(), slot0.cpu(), live.cpu(), cap))
    r["library"] = None
    errs["group_insert"] = max(errs["group_insert"], check_group_insert(
        torch, planes, slot0, live, cap))

    bslot, blive, tcap = inputs["join_insert"][1]
    r = rows["join_insert"]
    r["launcher"] = cuda_ms(torch, lambda: hk._join_insert_cuda(bslot, blive,
                                                                tcap))
    r["wrapper"] = cuda_ms(torch, lambda: hk.join_insert(bslot, blive, tcap))
    r["plain"] = host_ms(torch, lambda: hk.join_insert_plain(
        bslot.cpu(), blive.cpu(), tcap))
    r["library"] = None
    errs["join_insert"] = max(errs["join_insert"], check_join_insert(
        torch, bslot, blive, tcap)[1])

    pslot, pkeys, plive, slot_row, bkeys, f = inputs["join_probe"][1]
    r = rows["join_probe"]
    r["launcher"] = cuda_ms(torch, lambda: hk._join_probe_cuda(
        pslot, pkeys, plive, slot_row, bkeys, f))
    r["wrapper"] = cuda_ms(torch, lambda: hk.join_probe(
        pslot, pkeys, plive, slot_row, bkeys, f))
    r["plain"] = host_ms(torch, lambda: hk.join_probe_plain(
        pslot.cpu(), pkeys.cpu(), plive.cpu(), slot_row.cpu(), bkeys.cpu(),
        f))
    r["library"] = None
    errs["join_probe"] = max(errs["join_probe"], check_join_probe(
        torch, pslot, pkeys, plive, slot_row, bkeys, f))

    for name, r in rows.items():
        r["bound"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        cold = ("" if r["ms_cold"] is None
                else f"cold {r['ms_cold']:.4f} ms, ")
        print(f"timing {name} [{r['shape']}]: kernel alone {cold}warm "
              f"{r['ms_warm']:.4f} ms; launcher {r['launcher']:.4f} ms; "
              f"wrapper {r['wrapper']:.4f} ms; plain {r['plain']:.4f} ms; "
              f"bound {r['bound']:.5f} ms ({r['bytes']} bytes)"
              + ("" if r["library"] is None
                 else f"; index_add_ {r['library']:.4f} ms")
              + ("" if "stacked_bytes" not in r else
                 f"; bound with the states stacked as int64 "
                 f"{r['stacked_bytes'] / HBM_BYTES_PER_S * 1e3:.5f} ms "
                 f"({r['stacked_bytes']} bytes)"))
        for what in ("ms_cold", "ms_warm"):
            if r[what] is not None:
                require(r[what] >= r["bound"],
                        f"{name}: kernel-alone time {what} {r[what]:.5f} ms "
                        f"beats its byte bound {r['bound']:.5f} ms")
    for name, rs in time_large(torch, flush).items():
        rows[name]["large"] = rs
    for name, rs in time_tpch22(torch, flush, timed).items():
        rows[name].setdefault("large", []).extend(rs)
    for name, rs in time_tpch22(torch, flush, ds_timed, "tpcds").items():
        rows[name].setdefault("large", []).extend(rs)
        for r in rs:
            print(f"timing {name} [tpcds largest]: cold over bound "
                  f"{r['ms'] / r['bound']:.1f}x")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import presto_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: presto_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    phase_build(torch)
    errs = phase_kernels(torch)
    launches, inputs, _, cat = phase_queries(torch)
    timed = phase_tpch22(torch, cat, errs)
    phase_surface(torch, cat, errs)
    st_launches = phase_structural(torch, cat, errs)
    mem_launches = phase_memory(torch, cat, errs)
    scan_launches = phase_scan(torch, cat, errs)
    cluster_launches = phase_cluster(torch, cat, errs)
    ds_launches, ds_timed = phase_tpcds(torch, errs)
    rows = phase_timing(torch, inputs, timed, ds_timed, errs)
    # last: its profile=true capture (CPU and CUDA activity), devprof
    # sampler and extra cluster must not run before another phase's timing
    obs_launches = phase_obs(torch, cat, errs)
    del cat
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "tpcds_launches": ds_launches.get(name, 0),
            "structural_launches": st_launches.get(name, 0),
            "memory_launches": mem_launches.get(name, 0),
            "scan_launches": scan_launches.get(name, 0),
            "cluster_launches": cluster_launches.get(name, 0),
            "obs_launches": obs_launches.get(name, 0),
            "max_abs_err": errs[name],
            "ms": r["ms_warm"] if r["ms_cold"] is None else r["ms_cold"],
            "cold": r["ms_cold"] is not None, "ms_warm": r["ms_warm"],
            "launcher_ms": r["launcher"], "wrapper_ms": r["wrapper"],
            "plain_ms": r["plain"], "bound_ms": r["bound"],
            "bound_by": "bytes", "library_ms": r["library"],
            "large": [{"shape": x["shape"], "ms": x["ms"],
                       "ms_warm": x["ms_warm"], "bound_ms": x["bound"],
                       "launcher_ms": x["launcher"],
                       "wrapper_ms": x["wrapper"], "plain_ms": None}
                      for x in r.get("large", [])]})
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
