"""parallel: the hash-partitioned sharded engine (port of
gamesmanmpi_tpu/parallel/): the shard mesh and process group (mesh.py),
the exchange (exchange.py), the solver (sharded.py) and the process
launcher (launch.py)."""

from gamesmanmpi_tpu_torch.parallel.mesh import (
    Mesh,
    backend_for,
    init_distributed,
    make_mesh,
)
from gamesmanmpi_tpu_torch.parallel.sharded import ShardedSolver

__all__ = ["Mesh", "ShardedSolver", "backend_for", "init_distributed",
           "make_mesh"]
