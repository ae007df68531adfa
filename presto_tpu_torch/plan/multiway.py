"""Multiway join collapse: left-deep chains of inner/left equi-joins
sharing one probe pipeline (the star-schema shape of q3/q5/q9/q64) fold
into a single MultiwayJoin node — N resident builds, one probe pass
instead of one per join (PAPERS.md 1905.13376). The JAX package's pass,
rule for rule.

Runs AFTER optimize(), when a runner installs the plan, because the
verdict depends on the session's `join_mode`: the same SQL collapses
differently per session. `join_mode=off` skips the pass entirely — the
plan is the pre-collapse tree.

Eligibility is structural; the binary-vs-multiway choice is
plan/stats.choose_join_mode's. A chain join is collapsible when it is an
inner/left HashJoin with no residual and no colocated bucketing, and
every probe key resolves against the base probe's output or the payload
of an EARLIER build with `build_unique` — a probe row then has at most
one match there, so the key value is well-defined per probe row without
materializing the intermediate (snowflake chains like
lineitem⋈orders⋈customer)."""

from __future__ import annotations

from presto_tpu_torch.plan.nodes import HashJoin, MultiwayJoin, PlanNode
from presto_tpu_torch.plan.stats import choose_join_mode, invalidate

# child attributes rewritten in place while walking (plan nodes are
# dataclasses; `builds` is MultiwayJoin's own list attr)
_CHILD_ATTRS = ("child", "left", "right", "probe")


def _chain_join_ok(j: HashJoin) -> bool:
    return (isinstance(j, HashJoin) and j.kind in ("inner", "left")
            and j.residual is None and not j.colocated)


def _gather_chain(top: HashJoin):
    """(base, chain bottom-up) for the maximal left spine of collapsible
    joins under `top`; chain[0] probes `base`."""
    chain = []
    cur: PlanNode = top
    while _chain_join_ok(cur):
        chain.append(cur)
        cur = cur.left
    chain.reverse()
    return cur, chain


def _eligible_prefix(base: PlanNode, chain):
    """Length of the longest bottom-up prefix whose probe keys all
    resolve against the base output or an earlier unique build's
    payload."""
    avail = {s for s, _ in base.output}
    unique_payload = set()
    m = 0
    for j in chain:
        ok = all(k in avail or k in unique_payload for k in j.left_keys)
        if not ok:
            break
        m += 1
        if j.build_unique:
            unique_payload |= {s for s, _ in j.right.output}
        # non-unique payload is never a later key source, but it IS part
        # of the probe pipeline's passthrough output — no avail update
    return m


def _key_source(sym: str, base: PlanNode, chain_prefix):
    """-1 when `sym` is a base-probe column, else the 0-based index of
    the (unique) build whose payload carries it."""
    if sym in {s for s, _ in base.output}:
        return -1
    for i, j in enumerate(chain_prefix):
        if sym in {s for s, _ in j.right.output}:
            return i
    raise KeyError(sym)


def _collapse(top: HashJoin, catalog, mode: str, hbo: str):
    """One collapse attempt at `top`. Returns the replacement node (the
    MultiwayJoin, possibly still nested under the chain's upper
    non-collapsed joins) or None to keep the binary tree."""
    base, chain = _gather_chain(top)
    m = _eligible_prefix(base, chain)
    if m < 2:
        return None
    chain_m = chain[:m]
    verdict, why = choose_join_mode(chain_m, catalog, override=mode,
                                    hbo=hbo)
    if verdict != "multiway":
        top.__dict__["_join_mode"] = "binary"
        top.__dict__["_join_mode_why"] = why
        return None
    node = MultiwayJoin(
        probe=base,
        builds=[j.right for j in chain_m],
        kinds=[j.kind for j in chain_m],
        probe_keys=[list(j.left_keys) for j in chain_m],
        build_keys=[list(j.right_keys) for j in chain_m],
        build_unique=[bool(j.build_unique) for j in chain_m],
    )
    node.__dict__["_join_mode"] = "multiway"
    node.__dict__["_join_mode_why"] = why
    from presto_tpu_torch.obs import runstats

    # local-only provenance for HBO: the top collapsed join's structural
    # fingerprint, and the original binary joins' leg by leg, so the
    # multiway run feeds build rows and probe selectivity back to the
    # fingerprints choose_join_mode consults
    node.__dict__["_origin_fp"] = runstats.node_fingerprint(
        chain_m[-1], catalog)
    node.__dict__["_leg_fps"] = [
        runstats.node_fingerprint(j, catalog) for j in chain_m]
    # joins above the eligible prefix stay binary on top of the collapse
    for j in chain[m:]:
        j.left = node
        node = j
    return node


def collapse_multiway(root: PlanNode, catalog, mode: str = "auto",
                      hbo: str = "off") -> PlanNode:
    """Walk the tree collapsing eligible chains (top-down: the outermost
    chain wins its full length). Mutates children in place like the
    optimizer passes; returns the (possibly new) root."""
    if isinstance(root, HashJoin):
        replaced = _collapse(root, catalog, mode, hbo)
        if replaced is not None:
            root = replaced
    for attr in _CHILD_ATTRS:
        c = getattr(root, attr, None)
        if isinstance(c, PlanNode):
            setattr(root, attr, collapse_multiway(c, catalog, mode, hbo))
    if isinstance(root, MultiwayJoin):
        root.builds = [collapse_multiway(b, catalog, mode, hbo)
                       for b in root.builds]
    return root


def apply_join_mode(qp, catalog, config) -> None:
    """Config-gated entry point: rewrite a QueryPlan in place after
    optimize(). `join_mode=off` leaves the plan untouched (bit-for-bit
    the pre-collapse path)."""
    mode = getattr(config, "join_mode", "auto")
    if mode == "off":
        return
    hbo = getattr(config, "hbo", "observe")
    root = collapse_multiway(qp.root, catalog, mode, hbo)
    invalidate(root)
    qp.root = root
