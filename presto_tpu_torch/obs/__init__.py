"""Observability plane: span tracing (trace), histogram metric families
(metrics), exposition-format lint (exposition), and query-event sinks
(events)."""

from presto_tpu_torch.obs import trace  # noqa: F401
