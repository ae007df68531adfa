"""presto_tpu_torch — the SQL engine of presto_tpu on PyTorch and CUDA.

A second package beside the JAX package `presto_tpu`: the same SQL in, the
same answers out, on one NVIDIA GPU. Plain tensor work is PyTorch run
eagerly; the hash-table and grouped-sum kernels that the JAX package writes
in Pallas are CUDA C++ kernels (csrc/), built at first use.

Entry points run on the GPU unless the caller asks for the CPU: a device
argument of None means CUDA, and raises when CUDA is absent. On the CPU
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Resolve an entry point's device: None → CUDA (raises when CUDA is
    absent); anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "presto_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


__all__ = ["default_device", "__version__"]
