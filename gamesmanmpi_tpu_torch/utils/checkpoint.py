"""Per-level checkpoint / resume and solved-table files (port of
gamesmanmpi_tpu/utils/checkpoint.py, the single-device surface).

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

Not ported yet (ROADMAP): the per-shard, edge, reshard, GC and disk-usage
methods (with the multi-GPU engine), and the observability hooks. A
directory sealed by the reference's sharded engine is refused at
:meth:`LevelCheckpointer.bind_game`.
"""

from __future__ import annotations

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

#: Manifest keys only the reference's sharded engine writes.
SHARDED_KEYS = ("sharded_levels", "forward_level_shards", "frontier_shards",
                 "edge_levels")


def _verify_enabled() -> bool:
    return env_str("GAMESMAN_CKPT_VERIFY", "1") not in ("0", "off", "false")


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
        """Rename a sealed level's file to ``.corrupt`` and unseal it; the
        level recomputes (its frontier is still known) and re-seals over
        the quarantine. Idempotent."""
        manifest = self.load_manifest()
        p = self._level_path(level)
        if p.exists():
            p.rename(p.with_name(p.name + ".corrupt"))
        manifest.get("crc", {}).pop(p.name, None)
        if level in manifest.get("levels", []):
            manifest["levels"] = [x for x in manifest["levels"] if x != level]
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
        sharded = [k for k in SHARDED_KEYS if manifest.get(k)]
        if sharded:
            raise RuntimeError(
                f"checkpoint directory {self.dir} was sealed by the sharded "
                f"engine ({', '.join(sharded)}), which the torch port does "
                "not have yet")
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
        try:
            states, cells = self._read_npz(path, ("states", "cells"))
        except CorruptCheckpointError:
            self.quarantine_level(level)
            raise
        values, remoteness = unpack_cells_np(cells)
        return LevelTable(self._carrier_states(states), values, remoteness)

    def completed_levels(self) -> list[int]:
        return sorted(set(self.load_manifest().get("levels", [])))

    def lookup_level_state(self, level: int, state):
        """(value, remoteness) of one canonical state from the level's
        file, or None when the level or the state is absent. The last
        level read is memoized: point queries cluster by level."""
        path = self._level_path(level)
        if not path.exists():
            return None
        cache = getattr(self, "_lookup_cache", None)
        if cache is not None and cache[0] == level:
            states, cells = cache[1]
        else:
            states, cells = self._read_npz(path, ("states", "cells"))
            self._lookup_cache = (level, (states, cells))
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
