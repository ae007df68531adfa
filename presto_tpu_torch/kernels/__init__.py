"""Hand-written CUDA kernels: build/load (kernels/_build.py) and the launch
counts of their wrappers.

Every kernel wrapper (ops/groupby_kernels.py, ops/hash_kernels.py) takes
its plain PyTorch version for CPU tensors and launches its CUDA kernel for
CUDA tensors, adding one to its `launches` count where it launches and
nowhere else. A run shows it went through a kernel by reading the counts.
"""

from __future__ import annotations

from typing import Callable, Dict

WRAPPERS: Dict[str, Callable] = {}


def counted(name: str):
    """Register a kernel wrapper under `name` with a `launches` count."""
    def wrap(fn):
        fn.launches = 0
        WRAPPERS[name] = fn
        return fn
    return wrap


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
