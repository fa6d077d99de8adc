"""Fault injection and preemption grace (port of the
gamesmanmpi_tpu/resilience/ modules the checkpointed solve uses:
``faults`` and ``preempt``). Stdlib only."""
