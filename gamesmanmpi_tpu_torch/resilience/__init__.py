"""Fault injection, level-step retry and preemption grace (port of the
gamesmanmpi_tpu/resilience/ modules the solve and serving paths use:
``faults``, ``retry`` and ``preempt``). Stdlib only."""
