"""compat: run unmodified reference-style game modules (port of
gamesmanmpi_tpu/compat/).

A reference-style module (scalar `initial_position` / `gen_moves` /
`do_move` / `primitive`) can be:

  - solved directly on host (solve_module) — the memoized-negamax oracle,
    correct for any acyclic game, deliberately simple and not a
    benchmarked path;
  - lifted onto the batched TensorGame protocol (TensorizedModule), so
    the port's classic engine drives it on one device
    (solve_module_tensorized) — the boundary proof, used by the parity
    tests and by `solve module.py` for modules that declare `level_of`.
"""

from gamesmanmpi_tpu_torch.compat.shim import (
    TensorizedModule,
    load_game_module,
    solve_module,
    solve_module_tensorized,
)

__all__ = [
    "load_game_module",
    "solve_module",
    "solve_module_tensorized",
    "TensorizedModule",
]
