"""serve: batched HTTP query serving over solved-position databases
(port of gamesmanmpi_tpu/serve/).

A stdlib ThreadingHTTPServer whose concurrent requests coalesce through a
micro-batching queue (with an LRU hot-position cache) into single
vectorized DbReader probes, and, at fleet scale, a supervisor that runs N
such servers as supervised worker processes over ONE shared listening
socket and many game DBs (`supervisor.py` / `worker.py` / `manifest.py`
— docs/SERVING.md "Fleet serving"). Each worker's reader canonicalizes
and expands on the worker's device, the card unless the caller asks for
the CPU.
"""

from gamesmanmpi_tpu_torch.serve.batcher import (
    Batcher,
    BatcherClosed,
    BatcherOverloaded,
    BatcherTimeout,
    BatcherTripped,
    BatcherUnavailable,
)
from gamesmanmpi_tpu_torch.serve.manifest import (
    FleetEntry,
    load_fleet_manifest,
    single_db_entries,
)
from gamesmanmpi_tpu_torch.serve.server import QueryServer
from gamesmanmpi_tpu_torch.serve.supervisor import ServeSupervisor

__all__ = [
    "Batcher",
    "BatcherUnavailable",
    "BatcherClosed",
    "BatcherTimeout",
    "BatcherOverloaded",
    "BatcherTripped",
    "QueryServer",
    "ServeSupervisor",
    "FleetEntry",
    "load_fleet_manifest",
    "single_db_entries",
]
