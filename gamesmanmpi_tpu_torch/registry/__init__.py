"""registry: trustworthy distribution of solved-position databases (port
of gamesmanmpi_tpu/registry/).

A registry server publishes immutable DB epochs as a sha256-sealed
catalog (server.py); replicas pull them with resumable ranged fetches
into a quarantine staging dir and verify every byte before an atomic
install and the admission gate (pull.py); a query for a game nobody has
solved yet becomes a durable job that a runner drives through the
port's campaign, export and publish (jobs.py). Every failure shape has a
named fault point (``registry.fetch``, ``registry.publish``,
``registry.install``, ``jobs.claim``). The package imports no torch: the
solves happen in child processes.
"""

from gamesmanmpi_tpu_torch.registry.jobs import (
    JobQueue,
    QueueRefused,
    run_pending,
)
from gamesmanmpi_tpu_torch.registry.pull import PullError, pull_db, sync_fleet
from gamesmanmpi_tpu_torch.registry.server import (
    RegistryServer,
    catalog_seal,
    load_catalog,
    publish_db,
)

__all__ = [
    "JobQueue",
    "PullError",
    "QueueRefused",
    "RegistryServer",
    "catalog_seal",
    "load_catalog",
    "publish_db",
    "pull_db",
    "run_pending",
    "sync_fleet",
]
