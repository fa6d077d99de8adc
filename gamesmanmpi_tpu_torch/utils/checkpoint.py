"""Per-level checkpoint / resume and solved-table files (port of
gamesmanmpi_tpu/utils/checkpoint.py).

The unit of persistence is one solved level: its sorted states and its
packed uint32 cells, one npz per level, sealed in a JSON manifest. The
directory format is the reference's, so a directory one package sealed
resumes in the other:

* ``manifest.json`` keys ``game``, ``levels``, ``crc``, ``forward_levels``,
  ``frontiers_complete``, ``frontiers``, ``dense_levels``;
* files ``level_NNNN.npz`` (``states``, ``cells``), ``frontier_NNNN.npz``
  (``states``), ``frontiers.npz`` (``level_NNNN``), ``dense_NNNN.npz``
  (``cells``);
* the reference's dtypes on disk: states uint32 for games of up to 31
  state bits and uint64 above, cells uint32, dense cells uint8.

The port's solvers hand this module int64-carrier states
(core/bitops.py); it writes them in the game's reference dtype (bound by
:meth:`LevelCheckpointer.bind_game`) and reads them back into int64. A
state file never holds the port's sentinel.

Every payload write is atomic (tmp + os.replace, :func:`_savez`); a file
is sealed (listed, with its crc32) in the manifest only after it landed,
and the manifest itself is replaced atomically. Loads verify the crc32;
a torn or mismatching level is quarantined (renamed ``.corrupt`` and
unsealed) and the solver recomputes it. Reads go through the block store
(store/): its cache, prefetch hints and ``io_wait_secs`` accounting.

The sharded engine (parallel/sharded.py) writes one file per (level,
shard), per (forward level, shard), per (edge level, shard) and one
frontier snapshot per shard, each through the store's write-behind
queue, and seals a set only once its payloads landed (``finish_*``,
rank 0 after a barrier in a world). Elastic resume: a tree sealed at
another shard count re-partitions its rows through the owner hash on
load (:func:`reshard_shard_stream`) unless ``GAMESMAN_RESHARD=0`` pins
the sealed geometry, and then :class:`CheckpointGeometryError` names
both geometries. Sealed edge shards never reshard: a level whose edges
carry another geometry takes the lookup backward.

Not ported yet (ROADMAP): ``artifact_kind``, ``disk_usage``,
``quarantine_inventory``, ``referenced_files`` and ``gc_superseded``
(the campaign's disk budget), and the JSONL observability hooks.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np

from gamesmanmpi_tpu_torch.compress import (
    CELL_CANDIDATES,
    DEFAULT_BLOCK_POSITIONS,
    GENERIC_CANDIDATES,
    KEY_CANDIDATES,
    encode_array,
)
from gamesmanmpi_tpu_torch.core.bitops import (
    SENTINEL,
    from_reference,
    to_reference,
)
from gamesmanmpi_tpu_torch.core.codec import pack_cells_np, unpack_cells_np
from gamesmanmpi_tpu_torch.core.hashing import owner_shard_np
from gamesmanmpi_tpu_torch.core.probe import probe_sorted_np
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.store import (
    BLOCKS_META_MEMBER,
    CorruptSealError as CorruptCheckpointError,
    TORN_SEAL_ERRORS as TORN_NPZ_ERRORS,
    default_store,
    file_crc32,
    file_key,
    read_npz_members,
)
from gamesmanmpi_tpu_torch.utils.env import env_int, env_str

#: zip-level DEFLATE applies below this many raw bytes in ``auto`` mode.
_COMPRESS_BELOW = 64 << 20



def _verify_enabled() -> bool:
    return env_str("GAMESMAN_CKPT_VERIFY", "1") not in ("0", "off", "false")


def reshard_enabled() -> bool:
    """GAMESMAN_RESHARD (default on): may a resume adopt a tree sealed at
    another geometry (shard count, world size) by re-partitioning rows
    through the owner hash on load? Off pins resume to the sealed
    geometry, and a mismatch raises :class:`CheckpointGeometryError`."""
    return env_str("GAMESMAN_RESHARD", "1") not in ("0", "off", "false")


class CheckpointGeometryError(ValueError):
    """A tree's sealed geometry cannot (or, with GAMESMAN_RESHARD=0, may
    not) serve the requested one. The message names the sealed and the
    requested (shards, world, epoch)."""


def repartition_rows(states, num_shards: int, *payloads):
    """Bucket rows by the owner hash at ``num_shards``.

    -> ``[(states_t, *payloads_t) for t in range(num_shards)]``: every
    payload column stays row-aligned, and the input order is kept inside
    each bucket. The hash is the live solve's (core/hashing.py)."""
    states = np.asarray(states)
    payloads = tuple(np.asarray(p) for p in payloads)
    owners = owner_shard_np(states, num_shards)
    out = []
    for t in range(num_shards):
        sel = owners == t
        out.append((states[sel],) + tuple(p[sel] for p in payloads))
    return out


def reshard_shard_stream(load_shard, old_count: int, new_count: int):
    """One sealed shard set at ``old_count`` shards -> per-shard arrays at
    ``new_count``.

    ``load_shard(s) -> (states, *payloads)`` (or a bare states array)
    pulls one old shard at a time, so one decoded file is resident. Rows
    bucket by the owner hash at ``new_count``, and each new shard's
    columns are sorted by state, the per-shard invariant every consumer
    relies on; payloads ride along row-aligned."""
    frags: list = [[] for _ in range(new_count)]
    width = None
    for s in range(old_count):
        arrs = load_shard(s)
        if not isinstance(arrs, tuple):
            arrs = (arrs,)
        width = len(arrs)
        for t, part in enumerate(
                repartition_rows(arrs[0], new_count, *arrs[1:])):
            frags[t].append(part)
    out = []
    for t in range(new_count):
        cols = [np.concatenate([f[i] for f in frags[t]])
                for i in range(width or 1)]
        order = np.argsort(cols[0], kind="stable")
        out.append(tuple(c[order] for c in cols))
    return out


def _block_candidates(name: str, arr: np.ndarray):
    """Codec candidates by member: packed uint32 cells split value and
    remoteness, sorted unsigned states delta-code, anything else gets
    DEFLATE (raw always competes, so compression can only tie or win)."""
    if arr.dtype == np.uint32 and name.startswith("cells"):
        return CELL_CANDIDATES
    if arr.dtype.kind == "u":
        return KEY_CANDIDATES
    return GENERIC_CANDIDATES


def _savez(path, allow_block_framing=True, **arrays) -> tuple[int, int]:
    """Atomic npz write: tmp + os.replace. -> (raw bytes, stored bytes).

    GAMESMAN_CKPT_COMPRESS picks the layout:

    * ``auto`` (default): zip-level DEFLATE below 64 MB of raw bytes, a
      plain npz above;
    * ``0`` / ``1``: force plain / force DEFLATE;
    * ``blocks``: each 1-D member framed into independently decodable
      blocks (compress/: keydelta for states, cellpack for cells, raw when
      compression loses) inside an uncompressed npz, the per-member index
      in a ``__blocks__`` JSON member. store/sealed.loadz decodes it.

    allow_block_framing=False keeps ``blocks`` from reshaping files read
    by plain np.load elsewhere (``--table-out``): they get ``auto``.
    An extension-less path gets ``.npz`` appended, as np.savez does. The
    tmp name is per writer (pid).
    """
    total = sum(np.asarray(a).nbytes for a in arrays.values())
    flag = env_str("GAMESMAN_CKPT_COMPRESS", "auto")
    if flag == "auto" or (flag == "blocks" and not allow_block_framing):
        compress = total < _COMPRESS_BELOW
    else:
        compress = flag not in ("0", "off", "false")
    path = pathlib.Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    try:
        if flag == "blocks" and allow_block_framing:
            members, meta = {}, {}
            bp = env_int("GAMESMAN_DB_BLOCK", DEFAULT_BLOCK_POSITIONS)
            if bp <= 0:
                warnings.warn(f"GAMESMAN_DB_BLOCK={bp} is not positive; "
                              f"using {DEFAULT_BLOCK_POSITIONS}")
                bp = DEFAULT_BLOCK_POSITIONS
            for name, a in arrays.items():
                arr = np.asarray(a)
                if arr.ndim != 1 or arr.dtype.hasobject:
                    members[name] = arr  # stored plain, absent from meta
                    continue
                index, blobs = encode_array(arr, bp,
                                            _block_candidates(name, arr))
                members[name] = np.frombuffer(b"".join(blobs), dtype=np.uint8)
                meta[name] = index
            members[BLOCKS_META_MEMBER] = np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)
            # Uncompressed zip: the blocks are already entropy-coded.
            np.savez(tmp, **members)
        elif compress:
            np.savez_compressed(tmp, **arrays)
        else:
            np.savez(tmp, **arrays)
        stored = tmp.stat().st_size
        os.replace(tmp, path)
        return total, stored
    finally:
        tmp.unlink(missing_ok=True)


class LevelCheckpointer:
    """Saves solved levels as they complete; loads them for resume.

    Sealed reads go through the block store (``store=``, default the
    process-wide store), so a hinted level is decoded before the solver
    asks for it. A solver calls :meth:`begin_solve` first and reports
    :meth:`solve_stats` last.
    """

    def __init__(self, directory: str, store=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        self._store = store
        self.state_dtype = None
        self.bytes_raw = 0  # array bytes this solve's saves wrote
        self.bytes_stored = 0  # file bytes they took on disk
        self.save_secs = 0.0  # seconds its seals took (write, crc, manifest)
        self._io0 = 0.0

    @property
    def store(self):
        """The block store serving this checkpointer (late-bound, so a
        change of GAMESMAN_STORE_* between solves takes effect)."""
        return self._store if self._store is not None else default_store()

    def begin_solve(self) -> None:
        """Zero the per-solve counters."""
        self.bytes_raw = self.bytes_stored = 0
        self.save_secs = 0.0
        self._io0 = self.store.stats()["io_wait_secs"]

    def solve_stats(self) -> dict:
        """What the checkpoint cost the solve since begin_solve: bytes
        written (array bytes, file bytes; the reference's sharded engine's
        names), the seconds its seals took on the solve thread, and the
        seconds the solve thread waited on store I/O (sealed reads)."""
        return {
            "ckpt_bytes_raw": self.bytes_raw,
            "ckpt_bytes_stored": self.bytes_stored,
            "ckpt_save_secs": self.save_secs,
            "io_wait_secs": self.store.stats()["io_wait_secs"] - self._io0,
        }

    # ------------------------------------------------------ dtypes on disk

    def _disk_states(self, states) -> np.ndarray:
        """int64-carrier states -> the reference dtype bound by bind_game."""
        if self.state_dtype is None:
            raise RuntimeError("bind_game(name, state_dtype) before saving "
                               "states")
        a = np.asarray(states, dtype=np.int64)
        if a.size and int(a.max()) >= SENTINEL:
            raise ValueError("a checkpoint state file never holds the "
                             "padding sentinel")
        return a.astype(self.state_dtype)

    @staticmethod
    def _carrier_states(states) -> np.ndarray:
        """Reference-dtype states from disk -> int64 carrier."""
        return from_reference(states).numpy()

    def _save(self, path, **arrays) -> None:
        raw, stored = _savez(path, **arrays)
        self.bytes_raw += raw
        self.bytes_stored += stored

    # ------------------------------------------------------ sealed reads

    def _npz_read_plan(self, path, names, manifest=None):
        """(key, loader) of one sealed npz; the same plan for hints and
        reads, so a hinted load is a later cache hit."""
        want = None
        if _verify_enabled():
            if manifest is None:
                manifest = self.load_manifest()
            want = manifest.get("crc", {}).get(pathlib.Path(path).name)
        return file_key(path), (
            lambda: read_npz_members(path, names, crc=want))

    def _read_npz(self, path, names, manifest=None):
        key, loader = self._npz_read_plan(path, names, manifest)
        return self.store.read(key, loader)

    def _hint_npz(self, path, names, manifest=None) -> None:
        key, loader = self._npz_read_plan(path, names, manifest)
        self.store.hint(key, loader)

    def _level_path(self, level: int) -> pathlib.Path:
        return self.dir / f"level_{level:04d}.npz"

    def load_manifest(self) -> dict:
        if self.manifest_path.exists():
            return json.loads(self.manifest_path.read_text())
        return {}

    def _write_manifest(self, manifest: dict) -> None:
        """Atomic replace, never truncate in place: readers see the old
        or the new manifest, never a partial one. The tmp name is per
        writer (pid)."""
        tmp = self.manifest_path.with_suffix(f".json.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, self.manifest_path)

    # ----------------------------------------------------------- integrity

    def quarantine_level(self, level: int) -> None:
        """Rename a sealed level's file(s) to ``.corrupt`` and unseal it;
        the level recomputes (its frontier is still known) and re-seals
        over the quarantine. Idempotent: ranks of a world may race."""
        self.flush_writes()  # never quarantine around an in-flight write
        manifest = self.load_manifest()
        paths = [self._level_path(level)]
        num = manifest.get("sharded_levels", {}).get(str(level))
        if num:
            paths += [self._shard_level_path(level, s) for s in range(num)]
        crc = manifest.get("crc", {})
        for p in paths:
            if p.exists():
                try:
                    p.rename(p.with_name(p.name + ".corrupt"))
                except OSError:
                    pass  # a peer rank won the rename race
            crc.pop(p.name, None)
        if level in manifest.get("levels", []):
            manifest["levels"] = [x for x in manifest["levels"] if x != level]
        manifest.get("sharded_levels", {}).pop(str(level), None)
        self._write_manifest(manifest)

    def quarantine_and_log(self, level: int, exc) -> None:
        """The one degrade contract of every resume path: quarantine the
        level and say so on stderr (the reference's ``ckpt_degraded``
        record; the port has no JSONL logger yet)."""
        self.quarantine_level(level)
        print(f"[checkpoint] level {int(level)} degraded, recomputing: "
              f"{str(exc)[:200]}", file=sys.stderr)

    def _quarantine_frontier(self, level: int) -> None:
        """Quarantine one frontier level and truncate the discovery prefix
        there: deeper frontiers are unsealed too (resume is contiguous
        from the root) and ``frontiers_complete`` drops."""
        manifest = self.load_manifest()
        crc = manifest.get("crc", {})
        kept = []
        for k in manifest.get("forward_levels", []):
            k = int(k)
            p = self.dir / f"frontier_{k:04d}.npz"
            if k < level:
                kept.append(k)
                continue
            if k == level and p.exists():
                p.rename(p.with_name(p.name + ".corrupt"))
            crc.pop(p.name, None)
        manifest["forward_levels"] = sorted(kept)
        manifest.pop("frontiers_complete", None)
        self._write_manifest(manifest)

    # ------------------------------------------------------------- binding

    def bind_game(self, name: str, state_dtype=None) -> None:
        """Record/validate which game this directory belongs to (game
        names encode every parameter, so a resume with another spec fails
        here instead of mixing tables). ``state_dtype`` is the game's
        reference state dtype, which state files are written in."""
        manifest = self.load_manifest()
        bound = manifest.get("game")
        if bound is None:
            manifest["game"] = name
            self._write_manifest(manifest)
        elif bound != name:
            raise ValueError(
                f"checkpoint directory {self.dir} belongs to game {bound!r}, "
                f"not {name!r} — use a fresh --checkpoint-dir")
        if state_dtype is not None:
            self.state_dtype = np.dtype(state_dtype)

    # -------------------------------------------------------- solved levels

    def save_level(self, level: int, table) -> None:
        """Seal one solved level (a solve/engine.LevelTable)."""
        t0 = time.perf_counter()
        path = self._level_path(level)
        self._save(path, states=self._disk_states(table.states),
                   cells=pack_cells_np(table.values, table.remoteness))
        manifest = self.load_manifest()
        manifest["levels"] = sorted(set(manifest.get("levels", [])) | {level})
        # Seal and crc land in ONE manifest write.
        manifest.setdefault("crc", {})[path.name] = file_crc32(path)
        self._write_manifest(manifest)
        self.save_secs += time.perf_counter() - t0
        faults.fire("ckpt.save_level", path=str(path), level=level)

    def load_level(self, level: int):
        """The sealed table of one level (a solve/engine.LevelTable,
        int64 states). A crc mismatch quarantines the level and raises
        CorruptCheckpointError, a TORN_NPZ_ERRORS member."""
        from gamesmanmpi_tpu_torch.solve.engine import LevelTable

        faults.fire("ckpt.load_level", level=level)
        path = self._level_path(level)
        if path.exists():
            try:
                states, cells = self._read_npz(path, ("states", "cells"))
            except CorruptCheckpointError:
                self.quarantine_level(level)
                raise
            values, remoteness = unpack_cells_np(cells)
            return LevelTable(self._carrier_states(states), values,
                              remoteness)
        # A sharded level: its shard files, merged into one sorted table.
        manifest = self.load_manifest()
        num = manifest.get("sharded_levels", {}).get(str(level))
        if num is None:
            raise FileNotFoundError(f"no checkpoint for level {level}")
        parts = [self.load_level_shard(level, s, manifest)
                 for s in range(num)]
        states = np.concatenate([p[0] for p in parts])
        cells = np.concatenate([p[1] for p in parts])
        order = np.argsort(states)
        values, remoteness = unpack_cells_np(cells[order])
        return LevelTable(states[order], values, remoteness)

    def completed_levels(self) -> list[int]:
        manifest = self.load_manifest()
        levels = set(manifest.get("levels", []))
        levels |= {int(k) for k in manifest.get("sharded_levels", {})}
        return sorted(levels)

    def lookup_level_state(self, level: int, state):
        """(value, remoteness) of one canonical state from the level's
        global file, or from the ONE shard file its owner hash names, or
        None when the level or the state is absent. The last file read
        is memoized: point queries cluster by level."""
        path = self._level_path(level)
        if path.exists():
            key = (level, None)
        else:
            num = self.level_shard_count(level)
            if num is None:
                return None
            key = (level, int(owner_shard_np(
                np.asarray([state], dtype=np.uint64), num)[0]))
        cache = getattr(self, "_lookup_cache", None)
        if cache is not None and cache[0] == key:
            states, cells = cache[1]
        elif key[1] is None:
            states, cells = self._read_npz(path, ("states", "cells"))
        else:
            states, cells = self.load_level_shard(level, key[1])
        self._lookup_cache = (key, (states, cells))
        idx, hit = probe_sorted_np(states,
                                   np.asarray([state], dtype=states.dtype))
        if not hit[0]:
            return None
        values, remoteness = unpack_cells_np(cells[idx[0]:idx[0] + 1])
        return int(values[0]), int(remoteness[0])

    # ------------------------------------------------------------ frontiers

    def save_frontier_level(self, level: int, states) -> None:
        """One discovered level's frontier, saved the moment its count is
        known; listed in the manifest only once the file is written."""
        t0 = time.perf_counter()
        path = self.dir / f"frontier_{level:04d}.npz"
        self._save(path, states=self._disk_states(states))
        manifest = self.load_manifest()
        manifest["forward_levels"] = sorted(
            set(manifest.get("forward_levels", [])) | {level})
        manifest.setdefault("crc", {})[path.name] = file_crc32(path)
        self._write_manifest(manifest)
        self.save_secs += time.perf_counter() - t0
        faults.fire("ckpt.save_frontier", path=str(path), level=level)

    def load_forward_levels(self) -> dict:
        """-> {level: sorted int64 states} saved during a (possibly
        interrupted) forward sweep; {} when none. A torn or mismatching
        level is quarantined there, keeping the intact prefix below it."""
        out = {}
        manifest = self.load_manifest()
        ks = sorted(int(k) for k in manifest.get("forward_levels", []))
        for k in ks:  # readahead over the whole prefix before the first read
            self._hint_npz(self.dir / f"frontier_{k:04d}.npz", ("states",),
                           manifest)
        for k in ks:
            path = self.dir / f"frontier_{k:04d}.npz"
            try:
                (states,) = self._read_npz(path, ("states",), manifest)
            except TORN_NPZ_ERRORS:
                self._quarantine_frontier(k)
                break
            out[k] = self._carrier_states(states)
        return out

    def mark_frontiers_complete(self) -> None:
        """Forward discovery finished; every level is on disk."""
        manifest = self.load_manifest()
        manifest["frontiers_complete"] = True
        self._write_manifest(manifest)

    def save_frontiers(self, pools) -> None:
        """Every level's pool in one file (the generic path's snapshot)."""
        t0 = time.perf_counter()
        path = self.dir / "frontiers.npz"
        self._save(path, **{f"level_{k:04d}": self._disk_states(v)
                            for k, v in pools.items()})
        manifest = self.load_manifest()
        manifest["frontiers"] = True
        manifest.setdefault("crc", {})[path.name] = file_crc32(path)
        self._write_manifest(manifest)
        self.save_secs += time.perf_counter() - t0
        faults.fire("ckpt.save_frontier", path=str(path))

    def load_frontiers(self):
        """-> {level: sorted int64 states} of a complete forward, or None:
        the generic path's snapshot, else the fast path's per-level files
        once ``frontiers_complete``. A corrupt snapshot is quarantined."""
        manifest = self.load_manifest()
        if manifest.get("frontiers"):
            path = self.dir / "frontiers.npz"
            if path.exists():
                try:
                    members = self._read_npz(path, None, manifest)
                    return {int(name.split("_")[1]): self._carrier_states(a)
                            for name, a in members.items()}
                except TORN_NPZ_ERRORS:
                    path.rename(path.with_name(path.name + ".corrupt"))
                    manifest.pop("frontiers", None)
                    manifest.get("crc", {}).pop(path.name, None)
                    self._write_manifest(manifest)
        if manifest.get("frontiers_complete"):
            out = self.load_forward_levels()
            if self.load_manifest().get("frontiers_complete"):
                return out
            # A level was quarantined mid-load: resume as a partial forward.
            return None
        num = manifest.get("frontier_shards")
        if num is None:
            return None
        # A sharded run's per-shard snapshot, assembled.
        shards = self.load_frontier_shards(int(num))
        return {k: np.sort(np.concatenate(arrs))
                for k, arrs in shards.items()}

    # ---------------------------------------------------------- dense levels
    # The dense engine's unit is one level's flat uint8 cell array. Only a
    # contiguous run ending at the top level is resumable; the engine
    # computes that run itself. (The reference seals no crc for these.)

    def save_dense_level(self, level: int, cells) -> None:
        t0 = time.perf_counter()
        self._save(self.dir / f"dense_{level:04d}.npz",
                   cells=np.asarray(cells, dtype=np.uint8).reshape(-1))
        manifest = self.load_manifest()
        manifest["dense_levels"] = sorted(
            set(manifest.get("dense_levels", [])) | {level})
        self._write_manifest(manifest)
        self.save_secs += time.perf_counter() - t0

    def dense_levels(self) -> list:
        return sorted(self.load_manifest().get("dense_levels", []))

    def load_dense_level(self, level: int) -> np.ndarray:
        (cells,) = self._read_npz(self.dir / f"dense_{level:04d}.npz",
                                  ("cells",))
        return cells

    # ------------------------------------------- runs, epochs and geometry
    # A seal records the run epoch it was taken in and which rank owned
    # each shard file; resume checks that every rank digests the same
    # directory, and compares the sealed geometry with the requested one.

    def flush_writes(self) -> None:
        """Wait for the store's pending write-behind payloads (re-raising
        the first failure)."""
        self.store.drain()

    def stamp_run(self, num_processes: int, ranks=None) -> int:
        """Increment the manifest's run epoch (rank 0, solve start)."""
        manifest = self.load_manifest()
        epoch = int(manifest.get("run", {}).get("epoch", 0)) + 1
        manifest["run"] = {
            "epoch": epoch,
            "num_processes": int(num_processes),
            "ranks": list(ranks) if ranks is not None else [],
        }
        self._write_manifest(manifest)
        return epoch

    def run_info(self) -> dict:
        """{"epoch", "num_processes", "ranks"} of the last stamped run
        ({} when none was stamped)."""
        return self.load_manifest().get("run", {})

    @staticmethod
    def _stamp_seal(manifest: dict, table: str, level: int,
                    ranks=None) -> None:
        """Record one seal's (epoch, ranks) in ``manifest``; the caller
        writes it, so seal and stamp land in one manifest write."""
        manifest.setdefault(table, {})[str(level)] = {
            "epoch": int(manifest.get("run", {}).get("epoch", 0)),
            "ranks": list(ranks) if ranks is not None else [],
        }

    def resume_digest(self, num_shards: int) -> str:
        """sha1 of everything resume decisions read: the sealed level
        sets, the frontier snapshots, the edge levels and the run epoch.
        Every rank computes it and barriers on it. With GAMESMAN_RESHARD
        on, the requested shard count drops out, so a world of another
        shape can adopt the tree; off, it stays in."""
        manifest = self.load_manifest()
        completed = self.completed_levels()
        view = {
            "deepest_sealed": max(completed) if completed else None,
            "completed": completed,
            "sharded": sorted(manifest.get("sharded_levels", {})),
            "forward": sorted(manifest.get("forward_level_shards", {})),
            "frontier_shards": manifest.get("frontier_shards"),
            "frontiers": bool(manifest.get("frontiers")),
            "edges": sorted(manifest.get("edge_levels", {})),
            "epoch": manifest.get("run", {}).get("epoch", 0),
            "num_shards": None if reshard_enabled() else num_shards,
        }
        blob = json.dumps(view, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()

    def sealed_geometry(self, manifest=None) -> dict:
        """The geometry the tree's shard artifacts were sealed at:
        ``{"shard_counts": every sealed shard count, sorted (a tree
        mid-reshard mixes them), "num_shards": the one count or None,
        "num_processes": the last stamped run's world or None, "epoch"}``.
        Global artifacts carry no geometry, and neither do edge shards
        (they never reshard: such a level takes the lookup backward)."""
        if manifest is None:
            manifest = self.load_manifest()
        counts = set()
        if manifest.get("frontier_shards"):
            counts.add(int(manifest["frontier_shards"]))
        for v in manifest.get("forward_level_shards", {}).values():
            counts.add(int(v))
        for v in manifest.get("sharded_levels", {}).values():
            counts.add(int(v))
        counts.discard(0)
        run = manifest.get("run", {})
        return {
            "shard_counts": sorted(counts),
            "num_shards": next(iter(counts)) if len(counts) == 1 else None,
            "num_processes": (int(run["num_processes"])
                              if "num_processes" in run else None),
            "epoch": int(run.get("epoch", 0)),
        }

    def check_resume_geometry(self, num_shards: int,
                              num_processes: int = 1) -> dict:
        """The elastic-resume gate at solve start -> ``{"status": "fresh" |
        "match" | "reshard", "sealed", "requested"}``. With
        GAMESMAN_RESHARD=0 a mismatch raises
        :class:`CheckpointGeometryError` naming both geometries."""
        sealed = self.sealed_geometry()
        requested = {"num_shards": int(num_shards),
                     "num_processes": int(num_processes)}
        if not sealed["shard_counts"]:
            return {"status": "fresh", "sealed": sealed,
                    "requested": requested}
        if (sealed["shard_counts"] == [int(num_shards)]
                and sealed["num_processes"] in (None, int(num_processes))):
            return {"status": "match", "sealed": sealed,
                    "requested": requested}
        if not reshard_enabled():
            raise CheckpointGeometryError(
                f"checkpoint {self.dir} is sealed at "
                f"shards={sealed['shard_counts']} "
                f"world={sealed['num_processes']} "
                f"epoch={sealed['epoch']} but this solve requested "
                f"shards={num_shards} world={num_processes}, and "
                "GAMESMAN_RESHARD=0 pins resume to the sealed geometry — "
                "rerun with the sealed geometry, or unset GAMESMAN_RESHARD "
                "to reshard on load")
        return {"status": "reshard", "sealed": sealed,
                "requested": requested}

    # ------------------------------------------------- sharded (per shard)
    # One file per (level, shard): no global array is assembled to WRITE
    # a checkpoint. Each process saves the shards it holds, through the
    # store's write-behind queue; `finish_*` seals a set once complete.

    def _shard_level_path(self, level: int, shard: int) -> pathlib.Path:
        return self.dir / f"level_{level:04d}.shard_{shard:04d}.npz"

    def _edges_path(self, level: int, shard: int) -> pathlib.Path:
        return self.dir / f"edges_{level:04d}.shard_{shard:04d}.npz"

    def _forward_shard_path(self, level: int, shard: int) -> pathlib.Path:
        return self.dir / f"frontier_{level:04d}.shard_{shard:04d}.npz"

    def _savez_behind(self, path, **arrays):
        """Write-behind _savez -> the store's WriteTicket, resolving to
        (raw, stored) bytes. Arrays are materialized on the calling
        thread; with write-behind off the write runs inline."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}

        def job(path=path, arrays=arrays):
            return _savez(path, **arrays)

        return self.store.write(job, path=str(path))

    def _seal_crcs(self, manifest: dict, paths) -> None:
        """The sealer records each landed file's crc32 (the set is known
        complete only now)."""
        crc = manifest.setdefault("crc", {})
        for p in paths:
            if p.exists():
                crc[p.name] = file_crc32(p)

    def save_level_shard(self, level: int, shard: int, states, cells):
        """One shard of one solved level (int64-carrier states, packed
        uint32 cells) -> WriteTicket."""
        return self._savez_behind(
            self._shard_level_path(level, shard),
            states=self._disk_states(states),
            cells=np.asarray(cells, dtype=np.uint32))

    def finish_level_shards(self, level: int, num_shards: int, ranks=None,
                            drain: bool = True) -> None:
        """Seal one level's shard set. ``drain=False``: the caller already
        waited on this level's tickets (a global drain would stall on
        newer levels' queued payloads)."""
        if drain:
            self.flush_writes()
        manifest = self.load_manifest()
        manifest.setdefault("sharded_levels", {})[str(level)] = num_shards
        self._seal_crcs(manifest, [self._shard_level_path(level, s)
                                   for s in range(num_shards)])
        self._stamp_seal(manifest, "level_seals", level, ranks)
        self._write_manifest(manifest)
        faults.fire("ckpt.save_level",
                    path=str(self._shard_level_path(level, 0)), level=level)

    def level_shard_count(self, level: int):
        """The shard count a level was sealed at, or None."""
        return self.load_manifest().get("sharded_levels", {}).get(str(level))

    def load_level_shard(self, level: int, shard: int, manifest=None):
        """-> (int64 states, packed uint32 cells) of one shard of one
        level. A crc mismatch quarantines the whole level and raises."""
        path = self._shard_level_path(level, shard)
        try:
            states, cells = self._read_npz(path, ("states", "cells"),
                                           manifest)
        except CorruptCheckpointError:
            self.quarantine_level(level)
            raise
        return self._carrier_states(states), cells

    def prefetch_level_shards(self, level: int, num_shards: int,
                              manifest=None) -> None:
        """Readahead hint for one sealed level's shard files."""
        if manifest is None:
            manifest = self.load_manifest()
        for s in range(num_shards):
            self._hint_npz(self._shard_level_path(level, s),
                           ("states", "cells"), manifest)

    def prefetch_level(self, level: int) -> None:
        """Readahead hint for one sealed global level file."""
        path = self._level_path(level)
        if path.exists():
            self._hint_npz(path, ("states", "cells"))

    # --------------------------------------------------- edges (per shard)
    # The forward's edge provenance in the reference's layout: per (level,
    # shard) ``eidx`` [S*ecap] int32 (row o: each child's index within
    # owner o's next-level slice, in routing order, -1 padded) and
    # ``slot`` [cap*M] int32 (where child lane j's answer sits in the
    # [S, ecap] reply, -1 for none), sealed with the geometry the
    # backward validates: shards, ecap, slot_len.

    def save_edges_shard(self, level: int, shard: int, eidx, slot):
        """-> WriteTicket, like save_level_shard."""
        return self._savez_behind(
            self._edges_path(level, shard),
            eidx=np.asarray(eidx, dtype=np.int32),
            slot=np.asarray(slot, dtype=np.int32))

    def finish_edges_level(self, level: int, num_shards: int, ecap: int,
                           slot_len: int, ranks=None,
                           drain: bool = True) -> None:
        """Seal one level's edge-shard set."""
        if drain:
            self.flush_writes()
        manifest = self.load_manifest()
        manifest.setdefault("edge_levels", {})[str(level)] = {
            "shards": num_shards, "ecap": int(ecap),
            "slot_len": int(slot_len)}
        self._stamp_seal(manifest, "edge_seals", level, ranks)
        self._write_manifest(manifest)

    def edge_level_info(self, level: int):
        """{"shards", "ecap", "slot_len"} of a sealed edge level, or None."""
        return self.load_manifest().get("edge_levels", {}).get(str(level))

    def load_edges_shard(self, level: int, shard: int, manifest=None):
        """-> (eidx [S*ecap] int32, slot [cap*M] int32) of one shard."""
        return self._read_npz(self._edges_path(level, shard),
                              ("eidx", "slot"), manifest)

    def prefetch_edges_level(self, level: int, num_shards: int,
                             manifest=None) -> None:
        """Readahead hint for one sealed level's edge-shard files."""
        if manifest is None:
            manifest = self.load_manifest()
        for s in range(num_shards):
            self._hint_npz(self._edges_path(level, s), ("eidx", "slot"),
                           manifest)

    # ------------------------------------ forward levels and frontiers
    # Each discovered level's shard rows are saved as the forward finds
    # them; the per-shard snapshot sealed at the end of the forward
    # supersedes them, and they are deleted.

    def save_forward_level_shard(self, level: int, shard: int, states):
        """-> WriteTicket, like save_level_shard."""
        return self._savez_behind(self._forward_shard_path(level, shard),
                                  states=self._disk_states(states))

    def finish_forward_level(self, level: int, num_shards: int, ranks=None,
                             drain: bool = True) -> None:
        """Seal one forward level's shard set, with each file's crc."""
        if drain:
            self.flush_writes()
        manifest = self.load_manifest()
        manifest.setdefault("forward_level_shards", {})[str(level)] = (
            num_shards)
        self._seal_crcs(manifest, [self._forward_shard_path(level, s)
                                   for s in range(num_shards)])
        self._stamp_seal(manifest, "forward_seals", level, ranks)
        self._write_manifest(manifest)

    def _quarantine_forward_shard_level(self, level: int,
                                        num_shards: int) -> None:
        """Quarantine one forward level's shard files and unseal it with
        every deeper forward level (resume is contiguous from the root).
        Each dropped level's files are enumerated at its own sealed
        count. Idempotent: every rank of a world walks the same tear."""
        manifest = self.load_manifest()
        crc = manifest.get("crc", {})
        rec = manifest.get("forward_level_shards", {})
        for k in [k for k in rec if int(k) >= level]:
            sealed_count = int(rec.pop(k) or num_shards)
            manifest.get("forward_seals", {}).pop(k, None)
            for s in range(sealed_count):
                p = self._forward_shard_path(int(k), s)
                if int(k) == level and p.exists():
                    try:
                        p.rename(p.with_name(p.name + ".corrupt"))
                    except OSError:
                        pass  # a peer rank won the rename race
                crc.pop(p.name, None)
        self._write_manifest(manifest)

    def _geometry_refused(self, what: str, sealed, num_shards: int):
        geom = self.sealed_geometry()
        return CheckpointGeometryError(
            f"{what} in {self.dir} are sealed at shards={sealed} (epoch "
            f"{geom['epoch']}) but this solve requested shards={num_shards}, "
            "and GAMESMAN_RESHARD=0 pins resume to the sealed geometry")

    def load_forward_level_shards(self, num_shards: int) -> dict:
        """-> {level: [per-shard int64 arrays at ``num_shards``]} of the
        sealed forward prefix; {} when none. A level sealed at another
        count reshards on load (streamed, one shard file at a time), per
        level, so a mixed tree resumes too. A torn level truncates the
        prefix there."""
        manifest = self.load_manifest()
        rec = manifest.get("forward_level_shards", {})
        mismatched = sorted({int(v) for v in rec.values()
                             if int(v) != num_shards})
        if mismatched and not reshard_enabled():
            raise self._geometry_refused("forward checkpoint levels",
                                         mismatched, num_shards)
        for k in sorted(rec, key=int):  # readahead over the whole prefix
            for s in range(int(rec[k])):
                self._hint_npz(self._forward_shard_path(int(k), s),
                               ("states",), manifest)
        out: dict = {}
        for k in sorted(rec, key=int):
            sealed_count = int(rec[k])

            def one(s, k=int(k)):
                (states,) = self._read_npz(self._forward_shard_path(k, s),
                                           ("states",), manifest)
                return self._carrier_states(states)

            try:
                if sealed_count == num_shards:
                    arrs = [one(s) for s in range(num_shards)]
                else:
                    arrs = [part[0] for part in reshard_shard_stream(
                        one, sealed_count, num_shards)]
            except TORN_NPZ_ERRORS:
                self._quarantine_forward_shard_level(int(k), sealed_count)
                break
            out[int(k)] = arrs
        return out

    def drop_forward_level_shards(self) -> None:
        """The per-shard snapshot is sealed: the incremental files are a
        redundant copy. Manifest first, unlinks second (a death between
        leaves orphans, never sealed entries pointing at nothing)."""
        manifest = self.load_manifest()
        dropped = manifest.pop("forward_level_shards", {})
        manifest.pop("forward_seals", None)
        self._write_manifest(manifest)
        for k in dropped:
            for path in self.dir.glob(f"frontier_{int(k):04d}.shard_*.npz"):
                path.unlink(missing_ok=True)

    def save_frontier_shard(self, shard: int, pools):
        """One shard's slice of every frontier level, one file ->
        WriteTicket."""
        return self._savez_behind(
            self.dir / f"frontiers.shard_{shard:04d}.npz",
            **{f"level_{k:04d}": self._disk_states(v)
               for k, v in pools.items()})

    def finish_frontier_shards(self, num_shards: int,
                               drain: bool = True) -> None:
        if drain:
            self.flush_writes()
        manifest = self.load_manifest()
        manifest["frontier_shards"] = num_shards
        self._write_manifest(manifest)

    def load_frontier_shards(self, num_shards: int):
        """-> {level: [per-shard int64 arrays at ``num_shards``]} from the
        per-shard snapshot, or None without one. A snapshot sealed at
        another count reshards on load, one sealed file at a time."""
        manifest = self.load_manifest()
        sealed_count = manifest.get("frontier_shards")
        if sealed_count is None:
            return None
        sealed_count = int(sealed_count)
        if sealed_count != num_shards and not reshard_enabled():
            raise self._geometry_refused("frontier snapshot shards",
                                         [sealed_count], num_shards)
        paths = [self.dir / f"frontiers.shard_{s:04d}.npz"
                 for s in range(sealed_count)]
        for path in paths:  # readahead before the first read
            self._hint_npz(path, None, manifest)
        out: dict = {}
        for s, path in enumerate(paths):
            for name, arr in self._read_npz(path, None, manifest).items():
                k = int(name.split("_")[1])
                arr = self._carrier_states(arr)
                if sealed_count == num_shards:
                    out.setdefault(k, [None] * num_shards)[s] = arr
                    continue
                tgt = out.setdefault(k, [[] for _ in range(num_shards)])
                for t, (part,) in enumerate(repartition_rows(arr,
                                                             num_shards)):
                    tgt[t].append(part)
        if sealed_count != num_shards:
            # Disjoint fragments per new shard: the sort is a merge.
            out = {k: [np.sort(np.concatenate(f)) for f in per]
                   for k, per in out.items()}
        return out


def save_table_npz(path, table: dict) -> None:
    """Dump a host-solve table ({pos: (value, remoteness)}, the compat
    oracle's) as one npz: uint64 ``states`` in ascending order and their
    uint32 ``cells``, as the reference writes it. Never block-framed
    (``--table-out`` is read by plain np.load)."""
    states = np.array(sorted(table), dtype=np.uint64)
    values = np.array([table[int(s)][0] for s in states], dtype=np.uint8)
    rems = np.array([table[int(s)][1] for s in states], dtype=np.int32)
    _savez(path, allow_block_framing=False, states=states,
           cells=pack_cells_np(values, rems))


def save_result_npz(path, result) -> pathlib.Path:
    """Dump a SolveResult's tables as one npz; returns the path written.

    One plain npz (``--table-out``) with ``states_LLLL`` (the reference's
    state dtype) and ``cells_LLLL`` (uint32 packed cells) per level: the
    same keys, dtypes and arrays as the reference's file. The write is
    atomic (tmp + os.replace); an extension-less path gets ``.npz``
    appended, as np.savez does; zip-level DEFLATE applies below 64 MB, as
    in the reference's default.
    """
    arrays = {}
    for level, table in sorted(result.levels.items()):
        arrays[f"states_{level:04d}"] = to_reference(table.states, result.game)
        arrays[f"cells_{level:04d}"] = pack_cells_np(table.values,
                                                     table.remoteness)
    path = pathlib.Path(path)
    if path.suffix != ".npz":  # np.savez's contract for such paths
        path = path.with_name(path.name + ".npz")
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    total = sum(a.nbytes for a in arrays.values())
    save = np.savez_compressed if total < _COMPRESS_BELOW else np.savez
    try:
        save(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path
