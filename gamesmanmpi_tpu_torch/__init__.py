"""PyTorch/CUDA port of the gamesmanmpi_tpu strong solver.

A second package beside the JAX reference (``gamesmanmpi_tpu``): the same
games and game compiler (``gamedsl/``), value algebra, classic, dense,
sharded and hybrid engines and their checkpoint/resume (in the
reference's directory format), the solve's instrumentation (``obs/``)
and watchdogs (``resilience/``), the solved-position DB and its HTTP
serving fleet (``serve/``), written against torch tensors, with the
reference's Pallas kernels rewritten by hand in CUDA C++ for Hopper
(``kernels/csrc``).

Rules this package keeps (ROADMAP.md, "the port"):

* it imports torch, numpy and the standard library only — never ``jax``
  and never anything from ``gamesmanmpi_tpu``; what it needs of the
  reference's numpy-only code it carries as its own copy;
* entry points run on ``cuda`` unless the caller asks for the CPU, and
  fail with :class:`~gamesmanmpi_tpu_torch.utils.device.DeviceUnavailable`
  (exit 2 from the CLI) rather than fall back when there is no card;
* bitboards, ranks and flat indices are signed ``int64`` (torch has no
  ``>>`` for its unsigned 32/64-bit types); packed cells stay ``uint8``.

Importing the package imports no torch module beyond this docstring: the
subpackages are imported where they are used.
"""

__all__: list = []
