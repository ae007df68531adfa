#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Build: print the card's name and power limit, build the CUDA kernels
   from presto_tpu_torch/csrc (one nvcc per source, all at once).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   on synthetic inputs at the main path's widths (the serial plain versions
   of the three hash kernels bound those cases to 65,536 rows).
3. Query phase: LocalRunner on CUDA over TPC-H SF 1 runs Q1, Q6 and Q3
   under breaker_engine=auto and Q3 under breaker_engine=hash; each result
   must equal a numpy oracle computed on the unscaled integers. The same
   four at SF 0.01 must give identical frames on the card and on the CPU.
   Launch counts are reset just before and read just after the SF 1 runs;
   every kernel must have launched.
4. Timing phase: each kernel on the largest inputs its launcher saw in
   the query phase — CUDA-event time of the launcher (the kernel and its
   outputs' fill) and of the public wrapper, its plain version's time and
   result, the bound (bytes moved over 3.35 TB/s) and, for grouped_sums,
   one `index_add_` call.

Prints a `kernels` JSON line, then as its last line
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit,
no ok line). Exits non-zero at once without CUDA or without the package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def q1_state_count() -> int:
    """Integer states Q1's aggregate sends through grouped_sums: one
    occupancy column, each sum limb and its valid count, each count."""
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
    return 1 + sum(1 if op == "count_add" else 2 for _, op, _ in layout)


def check_grouped_sums(torch, gid, vals, n_groups):
    from presto_tpu_torch.ops import groupby_kernels as gk

    got = torch.stack(gk.grouped_sums(gid, list(vals), n_groups))
    want = gk.grouped_sums_plain(gid, vals, n_groups)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    require(torch.equal(got, want),
            f"grouped_sums differs from its plain version (G={n_groups})")
    return err


def _slot_keys(table, gid, tcap):
    return table[:, gid.clamp(max=tcap - 1).long()]


def check_group_insert(torch, planes, slot0, live, cap):
    """Invariants: placed rows find their own key in their slot; one slot
    per distinct key; the occupied slots hold exactly the placed keys;
    n_groups = min(distinct, cap) as in the serial version; overflow counts
    unplaced live rows and is > 0 exactly when distinct > cap."""
    from presto_tpu_torch.ops import hash_kernels as hk

    gid, table, occ, ng, ovf = hk.group_insert(planes, slot0, live, cap)
    torch.cuda.synchronize()
    p = hk.group_insert_plain(planes.cpu(), slot0.cpu(), live.cpu(), cap)
    tcap = 2 * cap
    keys = planes.T
    distinct = torch.unique(keys[live], dim=0).shape[0] if live.any() else 0
    placed = live & (gid < tcap)
    require(bool((gid[~live] == tcap).all()), "dead rows got a slot")
    require(bool((_slot_keys(table, gid, tcap).T[placed] == keys[placed]).all()),
            "a placed row's slot holds another key")
    require(bool((occ[gid[placed].long()] == 1).all()),
            "a placed row's slot is not occupied")
    slot_keys = table.T[occ > 0]
    require(torch.unique(slot_keys, dim=0).shape[0] == slot_keys.shape[0],
            "one key holds two slots")
    placed_keys = torch.unique(keys[placed], dim=0) if placed.any() else slot_keys
    require(placed_keys.shape[0] == slot_keys.shape[0],
            "occupied slots differ from the placed keys")
    ngi, ovi = int(ng), int(ovf)
    require(ngi == min(distinct, cap) == int(p[3]) == int(occ.sum()),
            f"n_groups {ngi} vs distinct {distinct} / cap {cap} / plain "
            f"{int(p[3])}")
    require(ovi == int((live & (gid == tcap)).sum()),
            "overflow differs from the unplaced live rows")
    require((ovi > 0) == (distinct > cap) == (int(p[4]) > 0),
            "overflow signal differs from distinct > cap")
    if distinct <= cap:
        require(ovi == int(p[4]) == 0, "overflow without excess keys")
        # no overflow: the group multisets agree exactly with the serial one
        pk = p[1].T[p[2] > 0]
        require(torch.equal(torch.unique(pk, dim=0),
                            torch.unique(slot_keys.cpu(), dim=0)),
                "group keys differ from the serial version")
    return max(abs(ngi - int(p[3])), 0 if distinct > cap else abs(ovi - int(p[4])))


def check_join_insert(torch, slot0, live, tcap):
    """Invariants: every live row sits in exactly one slot, reachable from
    its slot0 over occupied slots; no dead row is in the table; as many
    slots are occupied as in the serial version. Returns (slot_row, the
    discrepancy: the sum of the occupied-slot gap to the serial version
    and the rows that are missing, doubled, dead or unreachable)."""
    from presto_tpu_torch.ops import hash_kernels as hk

    sr = hk.join_insert(slot0, live, tcap)
    torch.cuda.synchronize()
    plain = hk.join_insert_plain(slot0.cpu(), live.cpu(), tcap)
    sr_h, lv = sr.cpu(), live.cpu()
    occ = sr_h >= 0
    rows = sr_h[occ].long()
    occ_gap = abs(int(occ.sum()) - int((plain >= 0).sum()))
    doubled = rows.numel() - torch.unique(rows).numel()
    dead = int((~lv[rows]).sum())
    slot_of = torch.full((lv.shape[0],), -1, dtype=torch.long)
    slot_of[rows] = torch.nonzero(occ).flatten()
    placed = lv & (slot_of >= 0)
    missing = int(lv.sum()) - int(placed.sum())
    # run[t]: occupied slots in a row ending at slot t (cyclic); a row is
    # reachable iff its slot's run covers the walk from its slot0
    occ_l = occ.tolist()
    run = [0] * tcap
    for _ in range(2):
        for t in range(tcap):
            run[t] = run[t - 1] + 1 if occ_l[t] else 0
    run = torch.tensor(run)
    dist = (slot_of[placed] - slot0.cpu().long()[placed]) % tcap
    unreachable = int((run[slot_of[placed]] <= dist).sum())
    err = occ_gap + missing + doubled + dead + unreachable
    require(err == 0, f"join_insert: occupied-slot gap {occ_gap}, rows "
            f"missing {missing}, in two slots {doubled}, dead {dead}, "
            f"unreachable from slot0 {unreachable}")
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


def synthetic_planes(torch, rng, n, k, distinct, dev):
    import numpy as np

    base = rng.integers(-2**62, 2**62, size=(distinct, k), dtype=np.int64)
    base[0] = [2**63 - 1] + [-2**63] * (k - 1)  # near-limit key
    pick = rng.integers(0, distinct, n)
    return torch.from_numpy(np.ascontiguousarray(base[pick].T)).to(dev)


def phase_kernels(torch):
    import numpy as np

    from presto_tpu_torch.ops import hash_kernels as hk
    from presto_tpu_torch.ops.hashing import hash_columns, slot_hash

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    s = q1_state_count()
    n = 1 << 17
    gs_err = 0
    for g in (128, 512):
        gid = torch.from_numpy(rng.integers(0, g + 1, n).astype(np.int32)).to(dev)
        vals = torch.from_numpy(
            rng.integers(-2**63, 2**63 - 1, (s, n), dtype=np.int64,
                         endpoint=True)).to(dev)
        gs_err = max(gs_err, check_grouped_sums(torch, gid, vals, g))
        print(f"kernel grouped_sums: n={n} G={g} S={s} equal to plain (exact)")

    m = HASH_CHECK_ROWS
    gi_err = 0
    # (rows, key planes, cap, distinct keys, all rows on one slot)
    for n_rows, k, cap, distinct, collide in ((m, 3, 4096, 3000, False),
                                              (m, 3, 1024, 3000, False),
                                              (8192, 2, 256, 200, True)):
        planes = synthetic_planes(torch, rng, n_rows, k, distinct, dev)
        live = torch.from_numpy(rng.random(n_rows) < 0.9).to(dev)
        slot0 = (torch.zeros(n_rows, dtype=torch.int32, device=dev) if collide
                 else slot_hash(hash_columns(list(planes)), 2 * cap))
        gi_err = max(gi_err, check_group_insert(torch, planes, slot0, live, cap))
        print(f"kernel group_insert: n={n_rows} K={k} cap={cap} "
              f"distinct={distinct}{' one-slot collisions' if collide else ''}"
              f" invariants hold (rows cut: the plain version is serial)")

    ji_err = jp_err = 0
    # (build rows, distinct build keys, fanouts, all rows on one slot)
    for bn, dup, fanouts, collide in ((m, 20000, (8, 1), False),
                                      (2048, 300, (8,), True)):
        bkeys = synthetic_planes(torch, rng, bn, 1, dup, dev)
        blive = torch.from_numpy(rng.random(bn) < 0.9).to(dev)
        tcap = 2 * bn
        bslot = (torch.full((bn,), 7, dtype=torch.int32, device=dev) if collide
                 else slot_hash(hash_columns(list(bkeys)), tcap))
        sr, err = check_join_insert(torch, bslot, blive, tcap)
        ji_err = max(ji_err, err)
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
        for f in fanouts:
            jp_err = max(jp_err, check_join_probe(torch, pslot, pkeys, plive,
                                                  sr, bkeys, f, psr))
            print(f"kernel join_probe: n={bn} F={f} build={bn}"
                  f"{' one-slot collisions' if collide else ''}: counts, "
                  f"overflow and match sets equal to plain (exact)")
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


def frames_equal_q3(got, want, label) -> None:
    """Q3's ORDER BY may tie: the ordering keys must match row for row and
    the rows as a set."""
    frames_equal(got[["revenue", "o_orderdate"]],
                 want[["revenue", "o_orderdate"]], label)
    key = ["revenue", "o_orderdate", "l_orderkey"]
    frames_equal(got.sort_values(key, ignore_index=True),
                 want.sort_values(key, ignore_index=True), label)


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
            size = max(a.numel() for a in args if hasattr(a, "numel"))
            if size > self.inputs.get(name, (0, None))[0]:
                self.inputs[name] = (size, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args))
            return fn(*args)
        return rec

    def close(self):
        for (mod, attr), fn in self._orig.items():
            setattr(mod, attr, fn)


def timed_runs(torch, runner, sql, reps=3):
    runner.run(sql)  # warm-up
    ts = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run(sql)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


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
        check = frames_equal_q3 if q == "q3" else frames_equal
        check(results[label], oracles[q], f"{label} SF {SF}")
        print(f"query {label} (breaker_engine={eng}) SF {SF}: "
              f"{len(results[label])} rows equal to the numpy oracle (exact)")

    timings = {}
    for label, q, eng in RUNS:
        out, sec = timed_runs(torch, runners[eng], QUERIES[q])
        check = frames_equal_q3 if q == "q3" else frames_equal
        check(out, oracles[q], f"{label} SF {SF} warm")
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
    return launches, recorder.inputs, timings


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_timing(torch, inputs, errs):
    """Each kernel timed through its launcher (the module's private
    `_*_cuda` function) on the inputs the query phase handed that launcher:
    the kernel plus the allocation and fill of its outputs. The public
    wrapper's time is printed beside it; the difference is the wrapper's
    input conversions (for grouped_sums, the stack of the S states)."""
    from presto_tpu_torch.ops import groupby_kernels as gk
    from presto_tpu_torch.ops import hash_kernels as hk

    rows = {}
    # grouped_sums: (gid, vals[S, n], G)
    gid, vals, g = inputs["grouped_sums"][1]
    s, n = vals.shape
    ms = cuda_ms(torch, lambda: gk._grouped_sums_cuda(gid, vals, g))
    wrapper = cuda_ms(torch, lambda: gk.grouped_sums(gid, list(vals), g))
    plain = cuda_ms(torch, lambda: gk.grouped_sums_plain(gid, vals, g))
    idx = torch.where(gid < g, gid.long(), g)
    lib = cuda_ms(torch, lambda: torch.zeros(s, g + 1, dtype=torch.int64,
                                             device=vals.device)
                  .index_add_(1, idx, vals))
    errs["grouped_sums"] = max(errs["grouped_sums"],
                               check_grouped_sums(torch, gid, vals, g))
    rows["grouped_sums"] = (ms, wrapper, plain, nbytes(gid, vals) + s * g * 8,
                            lib, f"n={n} S={s} G={g}")

    # group_insert: (planes[K, n], slot0, live, cap)
    planes, slot0, live, cap = inputs["group_insert"][1]
    k, n = planes.shape
    ms = cuda_ms(torch, lambda: hk._group_insert_cuda(planes, slot0, live,
                                                      cap))
    wrapper = cuda_ms(torch, lambda: hk.group_insert(planes, slot0, live, cap))
    plain = host_ms(torch, lambda: hk.group_insert_plain(
        planes.cpu(), slot0.cpu(), live.cpu(), cap))
    errs["group_insert"] = max(errs["group_insert"], check_group_insert(
        torch, planes, slot0, live, cap))
    tcap = 2 * cap
    rows["group_insert"] = (ms, wrapper, plain, nbytes(planes, slot0, live)
                            + n * 4 + k * tcap * 8 + tcap * 4 + 8, None,
                            f"n={n} K={k} cap={cap}")

    # join_insert: (slot0, live, tcap)
    bslot, blive, tcap = inputs["join_insert"][1]
    n = bslot.shape[0]
    ms = cuda_ms(torch, lambda: hk._join_insert_cuda(bslot, blive, tcap))
    wrapper = cuda_ms(torch, lambda: hk.join_insert(bslot, blive, tcap))
    plain = host_ms(torch, lambda: hk.join_insert_plain(
        bslot.cpu(), blive.cpu(), tcap))
    errs["join_insert"] = max(errs["join_insert"], check_join_insert(
        torch, bslot, blive, tcap)[1])
    rows["join_insert"] = (ms, wrapper, plain, nbytes(bslot, blive) + tcap * 4,
                           None, f"n={n} tcap={tcap}")

    # join_probe: (slot0, pkeys, plive, slot_row, bkeys, fanout)
    pslot, pkeys, plive, slot_row, bkeys, f = inputs["join_probe"][1]
    k, n = pkeys.shape
    ms = cuda_ms(torch, lambda: hk._join_probe_cuda(pslot, pkeys, plive,
                                                    slot_row, bkeys, f))
    wrapper = cuda_ms(torch, lambda: hk.join_probe(pslot, pkeys, plive,
                                                   slot_row, bkeys, f))
    plain = host_ms(torch, lambda: hk.join_probe_plain(
        pslot.cpu(), pkeys.cpu(), plive.cpu(), slot_row.cpu(), bkeys.cpu(), f))
    errs["join_probe"] = max(errs["join_probe"], check_join_probe(
        torch, pslot, pkeys, plive, slot_row, bkeys, f))
    rows["join_probe"] = (ms, wrapper, plain,
                          nbytes(pslot, pkeys, plive, slot_row, bkeys)
                          + n * f * 4 + n * 4 + 4,
                          None, f"n={n} K={k} F={f} build={bkeys.shape[1]} "
                          f"tcap={slot_row.shape[0]}")
    for name, (ms, wrapper, plain, b, lib, shape) in rows.items():
        print(f"timing {name} [{shape}]: launcher {ms:.4f} ms on the card "
              f"(wrapper {wrapper:.4f} ms), plain {plain:.4f} ms, bound "
              f"{b / HBM_BYTES_PER_S * 1e3:.5f} ms ({b} bytes)"
              + ("" if lib is None else f", index_add_ {lib:.4f} ms"))
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

    phase_build(torch)
    errs = phase_kernels(torch)
    launches, inputs, _ = phase_queries(torch)
    rows = phase_timing(torch, inputs, errs)
    kernels = []
    for name, (ms, _wrapper, plain, b, lib, _shape) in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
