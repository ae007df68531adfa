"""Selective scan subsystem — the Aria machinery between connectors and
the exec runtime (the JAX package's scan/, on the host as there).

Reference: the oerling fork's presto-orc selective readers
(OrcSelectiveRecordReader.java, TupleDomainFilter.java,
reader/SelectiveStreamReaders). Four pieces:

- filters:   vectorized numpy value filters (TupleDomainFilter analogs)
             compiled from planner constraints, applied per-column on the
             HOST batch before device upload
- pruning:   per-split min/max/null-count stats; parquet row-group stats
             read natively, ORC stripe stats from a sidecar written at
             CTAS (pyarrow exposes none)
- adaptive:  observed selectivity/cost per filter, re-sorted so the most
             selective-per-cost filter runs first (Aria's hallmark)
- selective: lazy column materialization — decode filter columns first,
             shrink a row-index selection vector through the cascade,
             decode payload columns only for surviving rows
"""

from presto_tpu_torch.scan.adaptive import AdaptiveFilterOrder
from presto_tpu_torch.scan.filters import ValueFilter, filters_from_constraints
from presto_tpu_torch.scan.pruning import SplitStats, split_prunable
from presto_tpu_torch.scan.selective import selective_read

__all__ = [
    "AdaptiveFilterOrder",
    "ValueFilter",
    "filters_from_constraints",
    "SplitStats",
    "split_prunable",
    "selective_read",
]
