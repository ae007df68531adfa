"""Build and load the CUDA kernels of csrc/.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with nvcc for Hopper (sm_90a) into `presto_tpu_torch/_build/`, under a file
name that carries a hash of the source, and loaded with ctypes. Nothing is
built when a module is imported, and nothing is built for CPU tensors.
A source that fails to build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signature of every kernel entry point: (argtypes); all return int
# (the cudaError_t of the launch).
SIGNATURES = {
    "grouped_sums": {"grouped_sums_launch": [_P, _P, _I, _P, _I, _I, _I, _I,
                                             _I, _P]},
    "hash_table": {
        "group_insert_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _P],
        "join_insert_launch": [_P, _P, _P, _I, _I, _P],
        "join_probe_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _L, _I, _I, _P],
    },
}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC, f"{name}.cu")
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for one build; returns nvcc's report (register and shared
    memory use per kernel, from -Xptxas -v)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(_target(name) + ".tmp", _target(name))
    return log


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named source at once (one nvcc per source, all
    started together) and load them. Returns nvcc's report per source."""
    names = list(names)
    with _lock:
        procs = {n: _start_build(n) for n in names if n not in _libs}
        logs = {n: _finish_build(n, p) for n, p in procs.items()}
    for n in names:
        library(n)
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(_target(name))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of `device`, as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
