"""Relational kernels on fixed-capacity batches: hashing, sort, grouping,
join, and the hand-written CUDA kernels of the hash breaker engine."""
