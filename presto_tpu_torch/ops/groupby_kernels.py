"""Exact grouped int64 sums — the counterpart of the JAX package's
ops/pallas_groupby.py.

`grouped_sums` launches csrc/grouped_sums.cu for CUDA tensors and takes
its plain version (a masked int64 `index_add_`) for CPU tensors. Both are
exact mod 2^64 for any inputs, so they agree bit for bit with each other
and with the TPU kernel fed the same values as int64.

A state is an integer tensor[n] (bool, uint8, int8, int16, int32 or
int64) or a pair (values, mask) whose bool mask zeroes the rows it does
not hold. The kernel reads each state where it lies, at its own width:
nothing is stacked or widened first.
"""

from __future__ import annotations

import array
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from presto_tpu_torch.kernels import counted
from presto_tpu_torch.kernels._build import check, library, stream_ptr

MAX_GROUPS = 512  # the hash engine's largest kernel table (_HASH_KERNEL_SLOTS)
MAX_STATES = 64  # descriptors in one launch's kernel-parameter table
SMALL_GROUPS = 16  # up to here, per-lane histograms in shared memory
SMEM_BYTES = 232448  # dynamic shared memory a block may opt in to (227 KB)

# element kind of each state dtype in the kernel's descriptor (how its
# bytes widen to int64: zero-extended for bool/uint8, else sign-extended),
# and its width in bytes
KINDS = {torch.bool: (0, 1), torch.uint8: (0, 1), torch.int8: (1, 1),
         torch.int16: (2, 2), torch.int32: (3, 4), torch.int64: (4, 8)}

State = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class Launch(NamedTuple):
    """One kernel launch: which states its descriptor table holds (indices
    into the caller's list, widest first) and which path sums them."""
    states: Tuple[int, ...]
    path: str  # "histogram" (G <= SMALL_GROUPS) | "shared"
    groups_tile: int  # histogram slots per lane (pow2 ≥ G), or 0 on "shared"
    states_tile: int  # states per shared-memory tile on "shared", else 0


@functools.lru_cache(maxsize=256)
def launch_plan(widths: Tuple[int, ...], n_groups: int) -> List[Launch]:
    """How `grouped_sums` splits its states into launches on the card:
    states ordered by element width, widest first (the histogram path
    hands work to warps in table order, heaviest first), in tables of at
    most MAX_STATES; the histogram path for n_groups ≤ SMALL_GROUPS, else
    the shared-memory path with as many states per tile as 227 KB hold."""
    if n_groups > MAX_GROUPS:
        raise ValueError(f"grouped_sums takes at most {MAX_GROUPS} groups on "
                         f"the card, got {n_groups}")
    order = sorted(range(len(widths)), key=lambda i: -widths[i])
    plans = []
    for a in range(0, len(order), MAX_STATES):
        idx = tuple(order[a:a + MAX_STATES])
        if n_groups <= SMALL_GROUPS:
            gt = 2
            while gt < n_groups:
                gt *= 2
            plans.append(Launch(idx, "histogram", gt, 0))
        else:
            tile = min(len(idx), SMEM_BYTES // (8 * n_groups))
            plans.append(Launch(idx, "shared", 0, tile))
    return plans


def _split(state: State) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if isinstance(state, tuple):
        return state
    return state, None


def grouped_sums_plain(gid: torch.Tensor, int_states: Sequence[State],
                       n_groups: int) -> torch.Tensor:
    """→ int64[S, G]; rows with gid outside [0, G) are ignored. Widens each
    state to int64 (zero where its mask is False) and adds by index."""
    vals = []
    for state in int_states:
        v, m = _split(state)
        v = v.to(torch.int64)
        vals.append(v if m is None else torch.where(m, v, 0))
    vals = torch.stack(vals) if vals else torch.zeros(
        0, gid.shape[0], dtype=torch.int64, device=gid.device)
    ok = (gid >= 0) & (gid < n_groups)
    idx = torch.where(ok, gid.to(torch.int64), n_groups)
    out = torch.zeros(vals.shape[0], n_groups + 1, dtype=torch.int64,
                      device=vals.device)
    out.index_add_(1, idx, vals)
    return out[:, :n_groups]


def state_tables(gid: torch.Tensor, int_states: Sequence[State],
                 n_groups: int):
    """Check the states against the kernel's contract and lay out one
    descriptor table per launch of `launch_plan`: per state its values'
    and mask's device pointers and (output row << 32 | element kind), as
    csrc/grouped_sums.cu's GsStateHost. Returns [(Launch, int64 array)]
    and the tensors the tables point into (the caller keeps them alive up
    to the launch)."""
    shape, dev = gid.shape, gid.get_device()
    parts, rows, widths = [], [], []
    for state in int_states:
        v, m = _split(state)
        kind, width = KINDS.get(v.dtype, (None, 0))
        if kind is None:
            raise ValueError(f"grouped_sums: state dtype {v.dtype} is not "
                             f"one of {sorted(map(str, KINDS))}")
        if v.shape != shape or v.get_device() != dev:
            raise ValueError("grouped_sums: every state must be an [n] "
                             "tensor on gid's device")
        if not v.is_contiguous():
            v = v.contiguous()
        mptr = 0
        if m is not None:
            if (m.dtype != torch.bool or m.shape != shape
                    or m.get_device() != dev):
                raise ValueError("grouped_sums: a state's mask must be a bool "
                                 "[n] tensor on gid's device")
            if not m.is_contiguous():
                m = m.contiguous()
            mptr = m.data_ptr()
        parts.append((v, m))
        rows.append((v.data_ptr(), mptr, kind))
        widths.append(width)
    tables = []
    for plan in launch_plan(tuple(widths), n_groups):
        flat = array.array("q")
        for i in plan.states:
            vptr, mptr, kind = rows[i]
            flat.extend((vptr, mptr, i << 32 | kind))
        tables.append((plan, flat))
    return tables, parts


def _grouped_sums_cuda(gid: torch.Tensor, int_states: Sequence[State],
                       n_groups: int) -> torch.Tensor:
    tables, _parts = state_tables(gid, int_states, n_groups)
    # the first launch zeroes the output
    out = torch.empty(len(int_states), n_groups, dtype=torch.int64,
                      device=gid.device)
    lib = library("grouped_sums")
    stream = stream_ptr(gid.device)
    zero_rows = out.shape[0]
    for plan, arr in tables:
        grouped_sums.launches += 1
        check(lib.grouped_sums_launch(
            gid.data_ptr(), arr.buffer_info()[0], len(plan.states),
            out.data_ptr(), zero_rows, gid.shape[0], n_groups,
            plan.groups_tile, plan.states_tile, stream), "grouped_sums")
        zero_rows = 0
    return out


@counted("grouped_sums")
def grouped_sums(gid: torch.Tensor, int_states: Sequence[State],
                 n_groups: int) -> List[torch.Tensor]:
    """Fused multi-state exact grouped int64 sums.

    gid: int32[n]; values outside [0, n_groups) mark dead rows (their
    state values are ignored, so the caller need not zero them).
    int_states: integer tensors[n], or (values, bool mask) pairs. Returns
    one int64[G] per state, exact mod 2^64."""
    if not int_states:
        return []
    gid = gid.to(torch.int32).contiguous()
    if gid.device.type == "cpu":
        out = grouped_sums_plain(gid, int_states, n_groups)
    elif gid.device.type == "cuda":
        out = _grouped_sums_cuda(gid, int_states, n_groups)
    else:
        raise ValueError(f"grouped_sums: unsupported device {gid.device}")
    return list(out.unbind(0))
