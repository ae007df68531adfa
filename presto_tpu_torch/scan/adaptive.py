"""Adaptive filter ordering — Aria's hallmark.

Reference: the oerling fork's FilterFunction scoring in
OrcSelectiveRecordReader (reorderFilters / "filter order adapts to
observed selectivity and cost"): after each split, filters re-sort so the
one that kills the most rows per unit cost runs first, shrinking the
selection vector fastest. Stats decay exponentially across splits of the
same scan, so a filter whose selectivity drifts (sorted data!) loses its
advantage within a few splits instead of never.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class _FilterStat:
    __slots__ = ("pass_rate", "cost_per_row")

    def __init__(self, pass_rate: float, cost_per_row: float):
        self.pass_rate = pass_rate
        self.cost_per_row = cost_per_row


class AdaptiveFilterOrder:
    """Decayed per-filter selectivity/cost tracker for one scan.

    score = (1 - pass_rate) / cost_per_row — expected rows killed per
    second of filter work; higher runs earlier. Filters with no
    observations yet sort first (explore before exploit), breaking ties by
    the caller's original order.
    """

    def __init__(self, decay: float = 0.8):
        self.decay = decay
        self._stats: Dict[str, _FilterStat] = {}

    def update(self, key: str, rows_in: int, rows_out: int,
               seconds: float) -> None:
        if rows_in <= 0:
            return
        pass_rate = rows_out / rows_in
        # floor the cost: a sub-microsecond numpy pass on a tiny slice
        # would otherwise make its filter's score explode
        cost = max(seconds / rows_in, 1e-12)
        st = self._stats.get(key)
        if st is None:
            self._stats[key] = _FilterStat(pass_rate, cost)
        else:
            a = self.decay
            st.pass_rate = a * st.pass_rate + (1 - a) * pass_rate
            st.cost_per_row = a * st.cost_per_row + (1 - a) * cost

    def score(self, key: str) -> float:
        st = self._stats.get(key)
        if st is None:
            return float("inf")
        return (1.0 - st.pass_rate) / st.cost_per_row

    def order(self, keys: Sequence[str]) -> List[str]:
        return sorted(keys, key=self.score, reverse=True)
