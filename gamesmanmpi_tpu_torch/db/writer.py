"""DbWriter: build an immutable solved-position database (port of
gamesmanmpi_tpu/db/writer.py; the same files, byte for byte).

Two feeds, one format (db/format.py):

* **Live solve** — `Solver(game, level_sink=writer.add_level_table,
  store_tables=False)` streams each resolved level into the writer the
  moment the backward pass finishes it, so an export never holds more
  than the write-behind pipeline's few levels in host memory (the
  big-run contract).
* **Existing checkpoint** — `export_checkpoint` converts a classic
  `--checkpoint-dir` that either package sealed (global per-level
  files; the sharded engine's directories wait for the port's
  multi-GPU engine) so past solves become servable without re-solving.

The solver hands over int64-carrier states (core/bitops.py);
:meth:`DbWriter.add_level_table` converts them to the game's reference
dtype, so the files are the reference's, byte for byte.

The writer is strict where the reader is fast: keys must be strictly
ascending (sorted AND unique — the probe's contract), must not contain
the padding sentinel, and remoteness must fit the 30-bit cell field
un-clipped (a clipped remoteness would round-trip as the wrong answer;
better to refuse the export).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from gamesmanmpi_tpu_torch.compress import (
    CELL_CANDIDATES,
    DEFAULT_BLOCK_POSITIONS,
    KEY_CANDIDATES,
    encode_array,
)
from gamesmanmpi_tpu_torch.core.bitops import sentinel_for, to_reference
from gamesmanmpi_tpu_torch.core.codec import pack_cells_np
from gamesmanmpi_tpu_torch.core.values import MAX_REMOTENESS
from gamesmanmpi_tpu_torch.db.format import (
    FORMAT_NAME,
    FORMAT_VERSION,
    FORMAT_VERSION_BLOCKS,
    DbFormatError,
    level_cell_blocks_name,
    level_cell_name,
    level_key_blocks_name,
    level_key_name,
    save_blocks_hashed,
    save_npy_hashed,
    write_manifest,
)
from gamesmanmpi_tpu_torch.store import WriteTicket, default_store
from gamesmanmpi_tpu_torch.utils.env import env_int

#: Export pipeline depth: at most this many levels' arrays parked
#: behind the write-behind worker before add_level blocks on the
#: oldest. Bounds export memory at O(depth) levels — the whole point of
#: the streaming level_sink — while the encode+DEFLATE+hash of level k
#: overlaps the solver resolving level k-1.
_EXPORT_PIPELINE = 2


class DbWriter:
    """Writes per-level shards, then seals the DB with a manifest.

    The manifest lands last (atomically): a crash mid-export leaves a
    directory the reader refuses, never a torn database.
    """

    def __init__(self, directory, game, spec: str, *,
                 overwrite: bool = False, compress: bool = False,
                 block_positions: int | None = None, store=None):
        """compress=True writes format v2: each level's keys/cells as
        independently-decodable blocks (compress/) with the per-block
        index in the manifest. block_positions overrides the block
        size (positions per block; default GAMESMAN_DB_BLOCK).

        Payload writes ride the block store's write-behind worker
        (ISSUE 11): ``add_level`` validates on the calling thread, then
        enqueues the encode+write+hash and returns — the solver's
        backward loop (level_sink feeds add_level synchronously) no
        longer waits on export DEFLATE. The manifest (the seal) is
        written at finalize AFTER every ticket resolves, preserving the
        write-then-seal discipline bit for bit."""
        self.compress = bool(compress)
        self.block_positions = int(
            block_positions
            if block_positions is not None
            else env_int("GAMESMAN_DB_BLOCK", DEFAULT_BLOCK_POSITIONS)
        )
        if self.compress and self.block_positions <= 0:
            raise DbFormatError(
                f"block size must be positive, got {self.block_positions}"
            )
        self.final_dir = pathlib.Path(directory)
        self.dir = self.final_dir
        if (self.final_dir / "manifest.json").exists():
            if not overwrite:
                raise DbFormatError(
                    f"{self.final_dir} already holds a finalized database "
                    "(pass overwrite=True to replace it)"
                )
            # Re-exports STAGE into a sibling directory and swap at
            # finalize: the export behind --overwrite may be an hours-long
            # solve, and a crash mid-way must leave the old database
            # serving, not a destroyed directory. The swap (rmtree + rename
            # at finalize) is the only window where neither DB exists, and
            # it is milliseconds, not the solve. The staging name is FIXED
            # (no pid): a rerun after a crash reclaims the leftover
            # instead of stranding one multi-GB orphan per attempt —
            # concurrent exports into one --out were never coherent anyway
            # (they would race the swap itself).
            import shutil

            self.dir = self.final_dir.with_name(
                f"{self.final_dir.name}.staging"
            )
            if self.dir.exists():
                shutil.rmtree(self.dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.game = game
        self.spec = spec
        self.store = store if store is not None else default_store()
        self._levels: dict = {}  # level -> record dict | WriteTicket
        self._finalized = False

    def level_record(self, level: int) -> dict:
        """The manifest record of one written level, waiting on its
        write-behind ticket if still in flight (export progress logging
        reads per-level stored bytes through this)."""
        rec = self._levels[level]
        if isinstance(rec, WriteTicket):
            rec = self._levels[level] = rec.result()
        return rec

    def _enqueue_level(self, level: int, job, path_name: str) -> None:
        """Park one level's encode+write+hash behind the store's worker
        and bound the pipeline: beyond _EXPORT_PIPELINE unresolved
        levels, block on the oldest — export memory stays O(depth)
        levels, exactly what the streaming level_sink contract
        promises. ``path_name`` is the level's REAL on-disk keys file
        (v1 .npy or v2 .gmb) — the store.writebehind torn-fault target
        must name a file the job actually writes."""
        self._levels[level] = self.store.write(
            job, path=str(self.dir / path_name)
        )
        # Insertion order == enqueue order == the worker's FIFO order.
        pending = [k for k in self._levels
                   if isinstance(self._levels[k], WriteTicket)]
        for k in pending[:-_EXPORT_PIPELINE]:
            self.level_record(k)

    def add_level(self, level: int, states, values=None, remoteness=None,
                  *, cells=None) -> None:
        """Write one level's (sorted states, packed cells) shard pair.

        Pass values+remoteness (packed here via pack_cells_np) or
        pre-packed cells. Validates the probe invariants at write time —
        a served wrong answer is far costlier than a failed export.
        """
        if self._finalized:
            raise DbFormatError("database already finalized")
        level = int(level)
        if level in self._levels:
            raise DbFormatError(f"level {level} written twice")
        states = np.asarray(states)
        dt = np.dtype(self.game.state_dtype)
        if states.dtype != dt:
            raise DbFormatError(
                f"level {level}: keys dtype {states.dtype} != game state "
                f"dtype {dt}"
            )
        if states.ndim != 1:
            raise DbFormatError(f"level {level}: keys must be 1-D")
        if states.shape[0] and states[-1] == sentinel_for(dt):
            raise DbFormatError(
                f"level {level}: keys contain the padding sentinel — "
                "pass only real states"
            )
        if not np.all(states[1:] > states[:-1]):
            raise DbFormatError(
                f"level {level}: keys must be strictly ascending "
                "(sorted and unique)"
            )
        if cells is None:
            remoteness = np.asarray(remoteness)
            if remoteness.size and (
                int(remoteness.min()) < 0
                or int(remoteness.max()) > MAX_REMOTENESS
            ):
                raise DbFormatError(
                    f"level {level}: remoteness outside [0, "
                    f"{MAX_REMOTENESS}] would not survive the cell packing"
                )
            cells = pack_cells_np(np.asarray(values), remoteness)
        cells = np.asarray(cells, dtype=np.uint32)
        if cells.shape != states.shape:
            raise DbFormatError(
                f"level {level}: {cells.shape[0]} cells for "
                f"{states.shape[0]} keys"
            )
        if self.compress:
            self._enqueue_level(
                level, self._blocked_level_job(level, states, cells),
                level_key_blocks_name(level),
            )
            return
        keys_name = level_key_name(level)
        cells_name = level_cell_name(level)

        def job(level=level, states=states, cells=cells):
            # One-pass save+hash: a post-save re-read would double
            # export I/O per level (save_npy_hashed streams the hash).
            return {
                "count": int(states.shape[0]),
                "keys": keys_name,
                "cells": cells_name,
                "keys_sha256": save_npy_hashed(
                    self.dir / keys_name, states
                ),
                "cells_sha256": save_npy_hashed(
                    self.dir / cells_name, cells
                ),
            }

        self._enqueue_level(level, job, keys_name)

    def _blocked_level_job(self, level: int, states, cells):
        """Format v2 level write job (runs on the write-behind worker —
        block encoding is the expensive half of a compressed export, so
        it overlaps the solver, not just the fsync): framed key/cell
        block streams + the per-block index (and per-block first keys,
        the probe's block router) destined for the manifest. Keys and
        cells share one blocking so block b of cells scores block b of
        keys."""
        bp = self.block_positions

        def job(level=level, states=states, cells=cells, bp=bp):
            keys_index, key_blobs = encode_array(states, bp,
                                                 KEY_CANDIDATES)
            cells_index, cell_blobs = encode_array(cells, bp,
                                                   CELL_CANDIDATES)
            keys_name = level_key_blocks_name(level)
            cells_name = level_cell_blocks_name(level)
            # One-pass save+hash, same discipline as the v1 path.
            keys_sha = save_blocks_hashed(self.dir / keys_name, key_blobs)
            cells_sha = save_blocks_hashed(self.dir / cells_name,
                                           cell_blobs)
            return {
                "count": int(states.shape[0]),
                "keys": keys_name,
                "cells": cells_name,
                "keys_sha256": keys_sha,
                "cells_sha256": cells_sha,
                "keys_blocks": keys_index,
                "cells_blocks": cells_index,
                # Per-block first key: the reader's block router (one
                # searchsorted over this small resident array finds the
                # only block a canonical key can live in). JSON holds
                # full uint64 range exactly — Python ints are arbitrary
                # precision.
                "first_keys": [
                    int(states[b]) for b in range(0, states.shape[0], bp)
                ],
                "raw_bytes": int(states.nbytes + cells.nbytes),
                "stored_bytes": int(
                    sum(keys_index["lengths"])
                    + sum(cells_index["lengths"])
                ),
            }

        return job

    def add_level_table(self, level: int, table) -> None:
        """Engine hook adapter: consumes a solve/engine.LevelTable. Its
        int64-carrier states become the game's reference dtype here, the
        one conversion on the export path (an INT64_MAX entry becomes the
        reference's sentinel, which add_level refuses)."""
        self.add_level(level, to_reference(table.states, self.game),
                       table.values, table.remoteness)

    def abort(self) -> None:
        """Discard an unfinalized export: removes the staging directory
        (overwrite path) so a failed re-export leaves no orphan; a
        fresh-directory export keeps its partial files (unreadable — no
        manifest — and possibly useful for debugging)."""
        if self._finalized or self.dir == self.final_dir:
            return
        try:
            # Never rmtree under an in-flight payload write.
            self.store.drain()
        except Exception:  # noqa: BLE001 - aborting anyway
            pass
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)

    def finalize(self, extra: dict | None = None) -> dict:
        """Seal the DB: write the manifest (atomically, last). -> manifest.

        Every write-behind ticket resolves FIRST (payload on disk,
        hashes known), then the manifest lands — the same
        payload-before-seal order the synchronous writer had."""
        if not self._levels:
            raise DbFormatError("no levels written — refusing an empty DB")
        for level in list(self._levels):
            self.level_record(level)
        manifest = {
            "format": FORMAT_NAME,
            "version": (
                FORMAT_VERSION_BLOCKS if self.compress else FORMAT_VERSION
            ),
            "game": self.game.name,
            "spec": self.spec,
            "state_dtype": np.dtype(self.game.state_dtype).name,
            "sym": bool(getattr(self.game, "sym", False)),
            "num_positions": sum(
                rec["count"] for rec in self._levels.values()
            ),
            "levels": {
                str(k): self._levels[k] for k in sorted(self._levels)
            },
        }
        # Compiled gamedsl games carry their rules' identity: the canonical
        # spec document makes the DB self-describing (the reader rebuilds
        # the game even if the original .json moved), and the sha256 makes
        # `check_db --same-as` fail loudly across a rules change.
        if getattr(self.game, "spec_hash", None) is not None:
            manifest["spec_sha256"] = self.game.spec_hash
            manifest["game_spec"] = self.game.spec_doc
        if self.compress:
            manifest["compression"] = {
                "block_positions": self.block_positions,
                "raw_bytes": sum(
                    rec["raw_bytes"] for rec in self._levels.values()
                ),
                "stored_bytes": sum(
                    rec["stored_bytes"] for rec in self._levels.values()
                ),
            }
        if extra:
            manifest.update(extra)
        write_manifest(self.dir, manifest)
        if self.dir != self.final_dir:
            # Overwrite swap: the staged DB is complete (manifest and all),
            # so replace the old directory wholesale.
            import shutil

            shutil.rmtree(self.final_dir)
            os.rename(self.dir, self.final_dir)
            self.dir = self.final_dir
        self._finalized = True
        return manifest


def export_result(result, directory, spec: str, *,
                  overwrite: bool = False, compress: bool = False) -> dict:
    """One-shot export of an in-memory SolveResult's tables. -> manifest.

    For memory-bounded exports of big solves, prefer the streaming hook:
    Solver(game, level_sink=DbWriter(...).add_level_table,
    store_tables=False) — see solve/engine.py.
    """
    writer = DbWriter(directory, result.game, spec, overwrite=overwrite,
                      compress=compress)
    try:
        for level in sorted(result.levels):
            writer.add_level_table(level, result.levels[level])
        return writer.finalize()
    except BaseException:  # incl. KeyboardInterrupt: drop the staging dir
        writer.abort()
        raise


def export_checkpoint(checkpointer, game, spec: str, directory, *,
                      overwrite: bool = False, logger=None,
                      compress: bool = False) -> dict:
    """Convert an existing --checkpoint-dir into a servable DB. -> manifest.

    Consumes classic-engine checkpoints, sealed by either package and
    by either engine: a sharded level's shard files are merged into one
    sorted table by ``load_level``, so the files equal a classic export's.
    Dense checkpoints are refused: their flat per-index cell arrays cover
    the encodable superset, including fabricated classes the engine
    itself refuses to answer for.
    """
    manifest = checkpointer.load_manifest()
    if manifest.get("dense_levels"):
        raise DbFormatError(
            "dense checkpoint directories hold encodable-superset cells by "
            "perfect index, not reachable sorted states — serve those via "
            "the solver's --query path, or re-solve with the classic engine"
        )
    bound = manifest.get("game")
    if bound is not None and bound != game.name:
        raise DbFormatError(
            f"checkpoint directory belongs to game {bound!r}, not "
            f"{game.name!r}"
        )
    levels = checkpointer.completed_levels()
    if not levels:
        raise DbFormatError(
            f"{checkpointer.dir}: no completed levels to convert"
        )
    if levels != list(range(min(levels), max(levels) + 1)):
        import sys

        print(
            f"warning: checkpoint levels {levels} are not contiguous — "
            "the DB will answer 'not found' for the gaps",
            file=sys.stderr,
        )
    writer = DbWriter(directory, game, spec, overwrite=overwrite,
                      compress=compress)
    try:
        counts = {}
        for level in levels:
            table = checkpointer.load_level(level)
            writer.add_level_table(level, table)
            counts[level] = int(table.states.shape[0])
        manifest_out = writer.finalize()
        if logger is not None:
            # After finalize: every ticket has resolved, so the per-level
            # figures cost no ticket wait (logging during the loop would
            # block on each just-enqueued write).
            for level in levels:
                record = {"phase": "export_db", "level": level,
                          "n": counts[level]}
                rec = writer.level_record(level)
                if "stored_bytes" in rec:
                    record["raw_bytes"] = rec["raw_bytes"]
                    record["stored_bytes"] = rec["stored_bytes"]
                logger.log(record)
        return manifest_out
    except BaseException:  # incl. KeyboardInterrupt: drop the staging dir
        writer.abort()
        raise
