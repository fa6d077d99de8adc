"""Benchmarks of the torch port (op-level: microbench2)."""
