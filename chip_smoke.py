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
   the query phase, three CUDA-event times: the kernel alone (the bare
   C launch on outputs allocated once, events around each launch after a
   spin kernel), warm and — where its inputs and outputs fit under the
   50 MB L2 — cold, with the L2 flushed before each launch by a 128 MB
   write and a 128 MB read; the launcher (the kernel plus its outputs'
   allocation and fill); the public wrapper. Beside them the plain
   version's time and result, the bound (bytes of the distinct inputs
   read once and outputs written once, over 3.35 TB/s), which the cold
   time must not beat, and for grouped_sums one `index_add_` call.

Prints a `kernels` JSON line (`ms` is the cold kernel-alone time where
one was taken), then as its last line
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
    # (build rows, distinct build keys, fanouts, all rows on one slot); the
    # third case has about 46 matches a key, so F = 16 and 32 overflow and
    # F = 32 and 64 take the kernel's branch for fanouts past 16
    for bn, dup, fanouts, collide in ((m, 20000, (8, 1, 16), False),
                                      (2048, 300, (8, 16), True),
                                      (4096, 80, (16, 32, 64), False)):
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
                  f"overflow, match sets and -1 padding equal to plain "
                  f"(exact)")
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


def frames_equal_q3(got, want, label) -> None:
    """Q3's ORDER BY may tie: the ordering keys must match row for row and
    the rows as a set."""
    frames_equal(got[["revenue", "o_orderdate"]],
                 want[["revenue", "o_orderdate"]], label)
    key = ["revenue", "o_orderdate", "l_orderkey"]
    frames_equal(got.sort_values(key, ignore_index=True),
                 want.sort_values(key, ignore_index=True), label)


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


def distinct_bytes(*ts):
    """Bytes of the distinct tensors among ts (a tensor passed twice is
    read once)."""
    seen = {}
    for t in ts:
        seen[(t.data_ptr(), t.numel(), t.element_size())] = \
            t.numel() * t.element_size()
    return sum(seen.values())


def kernel_alone_ms(torch, launch, prep=None, flush=None, reps=50):
    """Median CUDA-event time of one bare launch, events around each
    launch. Before each: `prep` (resetting outputs the kernel updates),
    `flush` (evicting the L2: the cold reading; without it the inputs stay
    where the previous launch left them) and a spin kernel that keeps the
    card busy while the host enqueues, so no host time falls between the
    events. (Events around back-to-back launches would time the host:
    one Python-side launch takes longer than these kernels.)"""
    for _ in range(3):
        if prep:
            prep()
        launch()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if prep:
            prep()
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
    return (launch, None, distinct_bytes(gid, *_tensors(parts))
            + out.numel() * 8, f"n={n} S={len(states)} G={g}", out)


def _bare_group_insert(torch, lib, sp, planes, slot0, live, cap):
    k, n = planes.shape
    tcap = 2 * cap
    dev = planes.device
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    table = torch.zeros(k, tcap, dtype=torch.int64, device=dev)
    occ = torch.zeros(tcap, dtype=torch.int32, device=dev)
    state = torch.zeros(tcap, dtype=torch.int32, device=dev)
    stat = torch.zeros(3, dtype=torch.int32, device=dev)

    def prep():
        for t in (table, occ, state, stat):
            t.zero_()

    args = (slot0.data_ptr(), planes.data_ptr(), live.data_ptr(),
            gid.data_ptr(), table.data_ptr(), occ.data_ptr(),
            state.data_ptr(), stat.data_ptr(), n, k, cap, sp)

    def launch():
        _rc(lib.group_insert_launch(*args), "group_insert")
    return (launch, prep, distinct_bytes(planes, slot0, live) + n * 4
            + k * tcap * 8 + tcap * 4 + 8, f"n={n} K={k} cap={cap}",
            (gid, table, occ, stat))


def _bare_join_insert(torch, lib, sp, slot0, live, tcap):
    n = slot0.shape[0]
    slot_row = torch.full((tcap,), -1, dtype=torch.int32, device=slot0.device)

    args = (slot0.data_ptr(), live.data_ptr(), slot_row.data_ptr(), n, tcap,
            sp)

    def launch():
        _rc(lib.join_insert_launch(*args), "join_insert")
    return (launch, lambda: slot_row.fill_(-1),
            distinct_bytes(slot0, live) + tcap * 4, f"n={n} tcap={tcap}",
            slot_row)


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
    return (launch, None, distinct_bytes(slot0, pkeys, plive, slot_row, bkeys)
            + n * f * 4 + n * 4 + 4,
            f"n={n} K={k} F={f} build={bkeys.shape[1]} "
            f"tcap={slot_row.shape[0]}", (mm, cnt, stat))


def bare_launches(torch, inputs):
    """name → (launch, prep, bytes, shape, outputs): the bare
    `lib.*_launch` call of each kernel on the largest inputs the query
    phase handed its launcher, with outputs allocated once; `prep` resets
    the outputs a kernel must find empty; bytes are the distinct inputs
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


def phase_timing(torch, inputs, errs):
    """Each kernel on the inputs the query phase handed its launcher:
    - kernel alone: the bare `lib.*_launch` on outputs allocated once
      (`bare_launches`), warm (inputs as the last launch left them in L2)
      and, for kernels whose inputs and outputs fit under the L2, cold (the
      L2 flushed before each launch); the cold time is the one held
      against the byte bound;
    - launcher: the module's private `_*_cuda` (the kernel plus the
      allocation and fill of its outputs);
    - wrapper: the public function (plus its input conversions);
    - plain: the plain version on the same inputs; for grouped_sums also
      one `index_add_` call on the states stacked as int64."""
    from presto_tpu_torch.ops import groupby_kernels as gk
    from presto_tpu_torch.ops import hash_kernels as hk

    flush, flush_ms = l2_flush(torch)
    print(f"timing: L2 flush (write of {FLUSH_BYTES} B, read of as many) "
          f"{flush_ms:.4f} ms, outside the events of the cold launches")
    bare = bare_launches(torch, inputs)
    rows = {}
    for name, (launch, prep, b, shape, _outs) in bare.items():
        warm = kernel_alone_ms(torch, launch, prep)
        cold = (kernel_alone_ms(torch, launch, prep, flush)
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
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": r["ms_warm"] if r["ms_cold"] is None else r["ms_cold"],
            "cold": r["ms_cold"] is not None, "ms_warm": r["ms_warm"],
            "launcher_ms": r["launcher"], "wrapper_ms": r["wrapper"],
            "plain_ms": r["plain"], "bound_ms": r["bound"],
            "bound_by": "bytes", "library_ms": r["library"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
