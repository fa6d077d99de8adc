"""Fault injection, level-step retry, preemption grace, the per-level
watchdog and the host-memory guard (port of the gamesmanmpi_tpu/
resilience/ modules the solve and serving paths use: ``faults``,
``retry``, ``preempt``, ``supervisor``, ``memguard`` and
``coordination``). Stdlib only."""
