"""The port's collectives over a :class:`~.mesh.Mesh`: its
``lax.all_to_all`` and ``all_gather``.

Eager torch has no static shapes, so the exchange moves **exact splits**:
the caller first all-gathers every shard's per-destination counts (one
control row per shard, :func:`all_gather`), which gives every rank the
same ``[S, S]`` count matrix, and then :func:`all_to_all` moves exactly
those rows. The reference instead routes through fixed ``[S, route_cap]``
buffers and retries an overflow at a doubled capacity; that capacity, its
spill loop and ``GAMESMAN_ROUTE_HEADROOM`` are not ported, by design, for
the reason the classic engine drops power-of-two buckets: eager torch
runs every level at its exact size.

Layouts, as the reference's tiled ``all_to_all``: a send buffer is
destination-major (its first ``counts[s, 0]`` rows go to shard 0, and so
on; rows past ``counts[s].sum()`` are ignored), and a received buffer is
source-major. The reply to an exchange with ``counts`` is an exchange
with ``counts.T``, and it lands back in the sender's layout.

* Inside one process the exchange is copies between local shards: for
  each destination one ``torch.cat`` of views of the senders' buffers,
  so each row is copied once and no ``[S, S]`` staging exists. On one
  card that is a permutation on the device.
* Across processes each process packs its rows for every other process
  into one buffer and calls ``torch.distributed.all_to_all_single`` with
  the exact splits, then cuts the received buffer into views. Tensors
  stay on their device: gloo stages CUDA tensors through pinned host
  memory itself, NCCL moves them card to card.

Only int32 and int64 travel (gloo has no uint32): callers view packed
cells as int32. :class:`Traffic` counts the bytes that leave their shard
and times each exchange (CUDA events on the card, read once at the end).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Traffic:
    """Bytes that left their shard, calls and seconds, by direction
    ("route": states or queries to their owners; "reply": indices or
    cells back; "gather": tables and control rows)."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self._secs: Dict[str, float] = {}
        self._events: Dict[str, list] = {}

    def start(self, device: torch.device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, direction: str, token, nbytes: int) -> None:
        self.bytes[direction] = self.bytes.get(direction, 0) + int(nbytes)
        self.calls[direction] = self.calls.get(direction, 0) + 1
        if isinstance(token, float):
            self._secs[direction] = (self._secs.get(direction, 0.0)
                                     + time.perf_counter() - token)
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.setdefault(direction, []).append((token, end))

    def seconds(self) -> Dict[str, float]:
        """Seconds per direction (synchronises the recorded events)."""
        out = dict(self._secs)
        for direction, pairs in self._events.items():
            if pairs:
                pairs[-1][1].synchronize()
            out[direction] = out.get(direction, 0.0) + sum(
                a.elapsed_time(b) for a, b in pairs) / 1e3
        return out


def _offsets(counts: np.ndarray) -> np.ndarray:
    """[S, S] counts -> [S, S+1] row prefix sums (send offsets)."""
    off = np.zeros((counts.shape[0], counts.shape[1] + 1), dtype=np.int64)
    np.cumsum(counts, axis=1, out=off[:, 1:])
    return off


def all_to_all(mesh, parts: Sequence[torch.Tensor], counts: np.ndarray,
               direction: str = "route") -> List[torch.Tensor]:
    """Send ``parts[i]`` (local shard ``mesh.local[i]``'s destination-major
    buffer) by the global ``counts[src, dst]``; returns, per local shard,
    its received rows, source-major, on its device."""
    counts = np.asarray(counts, dtype=np.int64)
    S = mesh.S
    off = _offsets(counts)
    moved = int(counts.sum() - np.trace(counts))
    token = mesh.traffic.start(mesh.home)
    if mesh.group is None:
        out = []
        for d, dev in zip(mesh.local, mesh.devices):
            chunks = [parts[s][off[s, d]:off[s, d + 1]].to(dev)
                      for s in range(S)]
            out.append(torch.cat(chunks) if S > 1 else chunks[0])
    else:
        out = _all_to_all_world(mesh, parts, counts, off)
    itemsize = parts[0].element_size() if parts else 0
    mesh.traffic.stop(direction, token, moved * itemsize)
    return out


def _all_to_all_world(mesh, parts, counts, off):
    """The cross-process exchange: one ``all_to_all_single`` with exact
    splits. Process p's buffer for process q holds, for each shard d of
    q and then each local shard s of p, the rows s sends d."""
    P, local = mesh.world, mesh.local
    chunks, in_splits = [], []
    for q in range(P):
        n = 0
        for d in mesh.shards_of(q):
            for i, s in enumerate(local):
                chunks.append(parts[i][off[s, d]:off[s, d + 1]])
                n += int(counts[s, d])
        in_splits.append(n)
    out_splits = [int(counts[np.ix_(list(mesh.shards_of(p)),
                                    list(local))].sum()) for p in range(P)]
    send = torch.cat(chunks)
    recv = torch.empty(sum(out_splits), dtype=send.dtype,
                       device=send.device)
    dist.all_to_all_single(recv, send, out_splits, in_splits,
                           group=mesh.group)
    per_dest = {d: [None] * mesh.S for d in local}
    pos = 0
    for p in range(P):
        for d in local:
            for s in mesh.shards_of(p):
                n = int(counts[s, d])
                per_dest[d][s] = recv[pos:pos + n]
                pos += n
    return [torch.cat(per_dest[d]) for d in local]


def all_gather(mesh, parts: Sequence[torch.Tensor], sizes: Sequence[int],
               direction: str = "gather") -> torch.Tensor:
    """Concatenate every shard's 1-D part, in shard order, on
    ``mesh.home`` of every process. ``sizes[s]`` is shard s's length,
    the same on every rank (the control plane told it). Across processes
    each process's parts are padded to the largest process total, and
    one ``all_gather`` moves them."""
    token = mesh.traffic.start(mesh.home)
    local = torch.cat([p.to(mesh.home) for p in parts])
    if mesh.group is None:
        out = local
    else:
        totals = [sum(int(sizes[s]) for s in mesh.shards_of(p))
                  for p in range(mesh.world)]
        width = max(totals)
        buf = torch.zeros(width, dtype=local.dtype, device=local.device)
        buf[:local.numel()] = local
        got = [torch.empty_like(buf) for _ in range(mesh.world)]
        dist.all_gather(got, buf, group=mesh.group)
        out = torch.cat([g[:n] for g, n in zip(got, totals)])
    moved = (int(sum(sizes)) - local.numel()) * local.element_size()
    mesh.traffic.stop(direction, token, moved)
    return out
