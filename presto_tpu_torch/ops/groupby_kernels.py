"""Exact grouped int64 sums — the counterpart of the JAX package's
ops/pallas_groupby.py.

`grouped_sums` launches csrc/grouped_sums.cu for CUDA tensors and takes
its plain version (a masked int64 `index_add_`) for CPU tensors. Both are
exact mod 2^64 for any inputs, so they agree bit for bit with each other
and with the TPU kernel.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from presto_tpu_torch.kernels import counted
from presto_tpu_torch.kernels._build import check, library, stream_ptr

MAX_GROUPS = 6144  # one state's [G] tile must fit 48 KB of shared memory


def grouped_sums_plain(gid: torch.Tensor, vals: torch.Tensor,
                       n_groups: int) -> torch.Tensor:
    """vals int64[S, n] → int64[S, G]; rows with gid outside [0, G) are
    ignored."""
    ok = (gid >= 0) & (gid < n_groups)
    idx = torch.where(ok, gid.to(torch.int64), n_groups)
    out = torch.zeros(vals.shape[0], n_groups + 1, dtype=torch.int64,
                      device=vals.device)
    out.index_add_(1, idx, vals)
    return out[:, :n_groups]


def _grouped_sums_cuda(gid: torch.Tensor, vals: torch.Tensor,
                       n_groups: int) -> torch.Tensor:
    if n_groups > MAX_GROUPS:
        raise ValueError(f"grouped_sums takes at most {MAX_GROUPS} groups, "
                         f"got {n_groups}")
    s, n = vals.shape
    out = torch.zeros(s, n_groups, dtype=torch.int64, device=vals.device)
    lib = library("grouped_sums")
    grouped_sums.launches += 1
    check(lib.grouped_sums_launch(gid.data_ptr(), vals.data_ptr(),
                                  out.data_ptr(), n, s, n_groups,
                                  stream_ptr(vals.device)), "grouped_sums")
    return out


@counted("grouped_sums")
def grouped_sums(gid: torch.Tensor, int_states: Sequence[torch.Tensor],
                 n_groups: int) -> List[torch.Tensor]:
    """Fused multi-state exact grouped int64 sums.

    gid: int32[n]; values >= n_groups mark dead rows. int_states: int64[n]
    each (masked to 0 on dead rows by the caller). Returns one int64[G]
    per state, exact mod 2^64."""
    if not int_states:
        return []
    gid = gid.to(torch.int32).contiguous()
    vals = torch.stack([v.to(torch.int64) for v in int_states]).contiguous()
    if gid.device != vals.device or gid.shape[0] != vals.shape[1]:
        raise ValueError("grouped_sums: gid and states differ in device "
                         "or length")
    if vals.device.type == "cpu":
        out = grouped_sums_plain(gid, vals, n_groups)
    elif vals.device.type == "cuda":
        out = _grouped_sums_cuda(gid, vals, n_groups)
    else:
        raise ValueError(f"grouped_sums: unsupported device {vals.device}")
    return list(out.unbind(0))
