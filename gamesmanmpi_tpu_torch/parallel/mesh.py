"""The shard mesh and the process group (port of
gamesmanmpi_tpu/parallel/mesh.py).

The reference's world is a 1-D JAX device mesh, brought up across hosts
by ``jax.distributed.initialize``. The port's is a :class:`Mesh`: S
shards, each with a ``torch.device``, the ids of the shards this process
holds, and the ``torch.distributed`` process group, or None in one
process.

* **One process** holds every shard. On the card the shards sit on the
  visible cards round-robin; with fewer cards than shards they share
  them, which ``GAMESMAN_FAKE_DEVICES`` must allow (the reference's faked
  mesh: N logical devices on fewer physical ones). On the CPU every
  shard is on the CPU, as the reference's ``--device cpu`` run fakes
  ``--devices`` host devices.
* **A world** of P processes (:func:`init_distributed`): process p holds
  the contiguous shards ``[p*S/P, (p+1)*S/P)``, all on its one card
  (``cuda:(p mod cards)``) or on the CPU.

The backend rule lives in :func:`backend_for`, in one place: ``nccl``
when every rank has a card of its own, ``gloo`` otherwise (the CPU, or
ranks sharing a card: NCCL refuses two ranks on one GPU, while gloo
moves CUDA tensors through pinned host memory).
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gamesmanmpi_tpu_torch.parallel.exchange import Traffic
from gamesmanmpi_tpu_torch.utils.env import env_float, env_int, env_opt


class Mesh:
    """S shards over this process's devices (see the module docstring).

    ``devices[i]`` is the device of local shard ``local[i]``; ``home`` is
    the first one's, where control rows and gathered tables meet;
    ``traffic`` accounts every exchange over the mesh.
    """

    def __init__(self, num_shards: int, local: Tuple[int, ...],
                 devices: Tuple[torch.device, ...], group=None,
                 rank: int = 0, world: int = 1,
                 backend: Optional[str] = None):
        self.S = int(num_shards)
        self.local = tuple(local)
        self.devices = tuple(devices)
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.backend = backend
        self.home = self.devices[0]
        self.traffic = Traffic()

    def shards_of(self, process: int) -> range:
        """The shard ids process `process` holds."""
        n = self.S // self.world
        return range(process * n, (process + 1) * n)


def backend_for(device: torch.device, world: int) -> str:
    """The process group's backend: ``nccl`` when each of the `world`
    ranks has a card of its own, ``gloo`` otherwise. One host is assumed:
    a rank's card is ``cuda:(rank mod cards)``."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _fake_devices() -> int:
    return env_int("GAMESMAN_FAKE_DEVICES", 0)


def make_mesh(num_shards: int, device) -> Mesh:
    """A mesh of `num_shards` shards over `device` ("cuda" or "cpu"), in
    this process's world (one process unless :func:`init_distributed`
    ran). Raises ValueError when the shards do not fit: fewer devices
    than shards (the reference's message), or a shard count the world
    does not divide."""
    device = torch.device(device)
    S = int(num_shards)
    world, rank, group = 1, 0, None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world, rank = dist.get_world_size(), dist.get_rank()
    if S < 1 or S % world:
        raise ValueError(
            f"requested {S} shards over {world} processes: the shard count "
            "must be a positive multiple of the number of processes")
    per = S // world
    local = tuple(range(rank * per, (rank + 1) * per))
    if device.type == "cpu":
        devices = (torch.device("cpu"),) * per
    else:
        cards = torch.cuda.device_count()
        if world == 1:
            physical = [torch.device("cuda", i % cards) for i in range(per)]
            have = cards
        else:
            physical = [torch.device("cuda", rank % cards)] * per
            have = 1
        logical = max(have, _fake_devices())
        if per > logical:
            raise ValueError(
                f"requested {S} shards but only {logical * world} devices")
        devices = tuple(physical)
    backend = dist.get_backend(group) if group is not None else None
    return Mesh(S, local, devices, group, rank, world, backend)


def process_identity(coordinator=None, num_processes=None, process_id=None
                     ) -> Tuple[Optional[str], int, int]:
    """(coordinator "host:port" or None, world size, rank): the flags
    first, then the env twins ``GAMESMAN_COORDINATOR`` /
    ``GAMESMAN_NUM_PROCESSES`` / ``GAMESMAN_PROCESS_ID`` (how
    parallel/launch.py configures its children)."""
    if coordinator is None:
        coordinator = env_opt("GAMESMAN_COORDINATOR")
    if num_processes is None:
        num_processes = env_int("GAMESMAN_NUM_PROCESSES", 1)
    if process_id is None:
        process_id = env_int("GAMESMAN_PROCESS_ID", 0)
    return coordinator, int(num_processes), int(process_id)


def init_distributed(device, coordinator=None, num_processes=None,
                     process_id=None) -> str:
    """Join the process group: ``torch.distributed.init_process_group``
    over TCP at the coordinator, with the identity triple from argv, then
    env (:func:`process_identity`). Sets this rank's card first (gloo
    stages CUDA tensors on the current device). The group's timeout is
    ``GAMESMAN_COLLECTIVE_TIMEOUT`` when set, so a collective blocked on
    a dead peer raises within it. Returns the backend."""
    device = torch.device(device)
    coordinator, world, rank = process_identity(coordinator, num_processes,
                                                process_id)
    if not coordinator:
        raise ValueError("init_distributed needs a coordinator host:port")
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend_for(device, world)
    kwargs = {}
    secs = env_float("GAMESMAN_COLLECTIVE_TIMEOUT", 0.0)
    if secs > 0:
        kwargs["timeout"] = datetime.timedelta(seconds=secs)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, **kwargs)
    return backend
