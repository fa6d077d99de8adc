"""parallel: the hash-partitioned sharded engine (port of
gamesmanmpi_tpu/parallel/): the shard mesh and process group (mesh.py),
the exchange (exchange.py), the solver (sharded.py) and the process
launcher (launch.py).

The engine's names load lazily (PEP 562): mesh.py and sharded.py import
torch, while launch.py does not, so a campaign that only starts worlds of
CLI children (resilience/campaign.py) never brings torch into its own
process.
"""

_LAZY = {
    "Mesh": "gamesmanmpi_tpu_torch.parallel.mesh",
    "backend_for": "gamesmanmpi_tpu_torch.parallel.mesh",
    "init_distributed": "gamesmanmpi_tpu_torch.parallel.mesh",
    "make_mesh": "gamesmanmpi_tpu_torch.parallel.mesh",
    "ShardedSolver": "gamesmanmpi_tpu_torch.parallel.sharded",
}

__all__ = ["Mesh", "ShardedSolver", "backend_for", "init_distributed",
           "make_mesh"]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
