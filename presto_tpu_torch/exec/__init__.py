"""Execution: the per-batch runtime and the LocalRunner entry point."""

from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.runtime import ExecConfig, ExecContext, run_plan

__all__ = ["LocalRunner", "ExecConfig", "ExecContext", "run_plan"]
