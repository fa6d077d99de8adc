"""Resident opening book: the head of the query distribution, in RAM
(port of gamesmanmpi_tpu/db/book.py; ``book.gmb`` byte for byte the
reference's).

Query traffic over a solved game is overwhelmingly head-heavy — the 7x6
Connect-Four service (PAPERS.md) answers most real queries within the
first few plies. This module precomputes (value, remoteness, best move)
for every RAW position reachable within ``GAMESMAN_BOOK_PLIES`` moves of
the initial position and seals the table as ``book.gmb`` next to the
levels, recorded in the manifest like any other payload (file + sha256).
A book hit is answered entirely from resident arrays: no canonicalize,
no block decode (serve/server.py answers it that way).

RAW positions on purpose: clients hold raw states (they play raw moves
from the raw initial position — ``lookup_best``'s best children are raw
by contract), so storing the BFS set's raw spellings lets a book hit
skip canonicalization entirely. Value/remoteness/best are scored
through ``DbReader.lookup_best`` (the BFS expands through the reader's
torch expansion, on the reader's device), so the book is definitionally
consistent with the slow path it shadows; ``verify_book`` re-proves
that entry-by-entry.

Building the book rewrites the manifest (atomically): the DB's identity
(its manifest's sha256) changes with it.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import struct

import numpy as np

from gamesmanmpi_tpu_torch.core.host import pack_cells_np, unpack_cells_np
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.db.format import (
    DbFormatError,
    file_sha256,
    read_manifest,
    write_manifest,
)

__all__ = ["BOOK_NAME", "OpeningBook", "build_book", "verify_book"]

BOOK_NAME = "book.gmb"
_MAGIC = b"GMBK1\x00\x00\x00"


def _children_of(reader, batch: np.ndarray) -> np.ndarray:
    """Unique raw children of a raw-position batch (terminal positions
    expand to nothing), via the reader's expansion on its device."""
    raw, _canon, mask, _clv = reader._expand(batch)
    kids = np.unique(raw[mask])
    return kids[kids != reader.game.sentinel]


def _bfs_positions(reader, plies: int) -> np.ndarray:
    """Sorted unique raw positions within `plies` moves of the initial
    position (the initial position itself is ply 0)."""
    dtype = np.dtype(reader.game.state_dtype)
    seen = np.asarray([int(reader.game.initial_state())], dtype=dtype)
    frontier = seen
    for _ in range(int(plies)):
        if frontier.size == 0:
            break
        kids = _children_of(reader, frontier)
        frontier = np.setdiff1d(kids, seen, assume_unique=False)
        seen = np.union1d(seen, frontier)
    return seen


# Payload streams to its final name; the caller records the returned
# sha256 in the manifest, which write_manifest replaces atomically — the
# same write-then-seal contract as format.save_npy_hashed.
# sealed-write: GM801 write-then-seal payload helper (see above)
def _write_book_file(path, header: dict, positions, cells, best) -> str:
    blob = json.dumps(header, sort_keys=True).encode()
    h = hashlib.sha256()
    with open(path, "wb") as fh:
        for chunk in (
            _MAGIC,
            struct.pack("<I", len(blob)),
            blob,
            np.ascontiguousarray(positions).astype(
                positions.dtype.newbyteorder("<"), copy=False).tobytes(),
            np.ascontiguousarray(cells).astype("<u4", copy=False).tobytes(),
            np.ascontiguousarray(best).astype(
                best.dtype.newbyteorder("<"), copy=False).tobytes(),
        ):
            h.update(chunk)
            fh.write(chunk)
    return h.hexdigest()


def build_book(directory, plies: int, *, game=None, device="cuda") -> dict:
    """Build + seal the opening book of a finalized DB -> the manifest
    ``book`` record. Runs AFTER finalize (it opens a reader over the
    directory) and rewrites the manifest atomically — callers do this
    before serving, never under it.
    """
    from gamesmanmpi_tpu_torch.db.reader import DbReader

    plies = int(plies)
    if plies < 0:
        raise ValueError(f"book plies must be >= 0, got {plies}")
    directory = pathlib.Path(directory)
    reader = DbReader(directory, game, device=device)
    try:
        positions = _bfs_positions(reader, plies)
        values, rem, found, best = reader.lookup_best(positions)
        # A finalized strong solve answers every reachable position;
        # drop (don't invent) anything it does not — a book must never
        # hold an entry the slow path would refuse.
        positions = positions[found]
        best = best[found]
        cells = pack_cells_np(values[found], rem[found])
        header = {
            "game": reader.game.name,
            "plies": plies,
            "count": int(positions.size),
            "state_dtype": np.dtype(reader.game.state_dtype).name,
            "sentinel": int(reader.game.sentinel),
        }
        sha = _write_book_file(
            directory / BOOK_NAME, header, positions, cells, best
        )
        manifest = dict(reader.manifest)
        manifest["book"] = {
            "file": BOOK_NAME,
            "sha256": sha,
            "plies": plies,
            "count": int(positions.size),
        }
        write_manifest(directory, manifest)
        return manifest["book"]
    finally:
        reader.close()


class OpeningBook:
    """Resident, immutable (positions, cells, best) arrays + searchsorted
    lookup — the whole book lives in process memory once loaded."""

    __slots__ = ("positions", "cells", "best", "plies", "sentinel")

    def __init__(self, positions, cells, best, *, plies: int,
                 sentinel: int):
        self.positions = positions
        self.cells = cells
        self.best = best
        self.plies = int(plies)
        self.sentinel = sentinel

    @classmethod
    def load(cls, directory, manifest: dict | None = None, *,
             verify: bool = True):
        """Load a sealed book, or None when the manifest records none.
        ``verify`` re-hashes the file against the manifest seal (cheap:
        books are head-of-distribution small) — a mismatch raises
        DbFormatError so a worker warm start refuses the directory
        instead of serving a tampered fast path."""
        directory = pathlib.Path(directory)
        if manifest is None:
            manifest = read_manifest(directory)
        rec = manifest.get("book")
        if not rec:
            return None
        path = directory / rec["file"]
        if not path.exists():
            raise DbFormatError(
                f"{directory}: manifest records book {rec['file']!r} "
                "but the file is missing"
            )
        if verify and file_sha256(path) != rec["sha256"]:
            raise DbFormatError(
                f"{path}: sha256 mismatch vs manifest book seal"
            )
        # store-io: sealed opening-book payload read (sha-verified above)
        blob = path.read_bytes()
        if blob[: len(_MAGIC)] != _MAGIC:
            raise DbFormatError(f"{path}: not a GMBK1 opening book")
        (hlen,) = struct.unpack_from("<I", blob, len(_MAGIC))
        off = len(_MAGIC) + 4
        try:
            header = json.loads(blob[off: off + hlen])
        except ValueError as e:
            raise DbFormatError(f"{path}: bad book header: {e}") from e
        off += hlen
        count = int(header["count"])
        sdt = np.dtype(header["state_dtype"]).newbyteorder("<")
        positions = np.frombuffer(blob, dtype=sdt, count=count, offset=off)
        off += positions.nbytes
        cells = np.frombuffer(blob, dtype="<u4", count=count, offset=off)
        off += cells.nbytes
        best = np.frombuffer(blob, dtype=sdt, count=count, offset=off)
        if best.size != count:
            raise DbFormatError(f"{path}: truncated book payload")
        return cls(
            positions, cells, best,
            plies=int(header["plies"]),
            sentinel=np.dtype(sdt.newbyteorder("="))
            .type(header["sentinel"]),
        )

    def __len__(self) -> int:
        return int(self.positions.size)

    def lookup(self, states):
        """Batched resident probe: raw positions -> (values, remoteness,
        found, best) with the exact shapes/miss semantics of
        ``DbReader.lookup_best`` (UNDECIDED/0/sentinel on miss)."""
        q = np.asarray(states, dtype=self.positions.dtype)
        k = int(q.shape[0])
        if k == 0 or self.positions.size == 0:
            return (
                np.full(k, UNDECIDED, dtype=np.uint8),
                np.zeros(k, dtype=np.int32),
                np.zeros(k, dtype=bool),
                np.full(k, self.sentinel, dtype=self.positions.dtype),
            )
        idx = np.searchsorted(self.positions, q)
        np.clip(idx, 0, self.positions.size - 1, out=idx)
        found = self.positions[idx] == q
        values, rem = unpack_cells_np(self.cells[idx])
        values = np.where(found, values, UNDECIDED).astype(np.uint8)
        rem = np.where(found, rem, 0).astype(np.int32)
        best = np.where(found, self.best[idx], self.sentinel).astype(
            self.positions.dtype
        )
        return values, rem, found, best


def verify_book(directory, *, game=None, batch: int = 8192,
                device="cuda") -> list:
    """Re-probe EVERY book entry through the reader's slow path ->
    problem strings ([] = the book answers exactly what the DB does).
    The deep half of the serving gate: db/check.py checks the seal
    structurally; this proves the shadowed answers, so the hot path
    keeps check_db's "never a wrong answer" guarantee."""
    from gamesmanmpi_tpu_torch.db.reader import DbReader

    directory = pathlib.Path(directory)
    manifest = read_manifest(directory)
    if not manifest.get("book"):
        return [f"{directory}: manifest records no book to verify"]
    problems: list = []
    book = OpeningBook.load(directory, manifest)
    reader = DbReader(directory, game, device=device)
    try:
        for lo in range(0, len(book), batch):
            pos = np.asarray(book.positions[lo: lo + batch])
            bv, br = unpack_cells_np(np.asarray(book.cells[lo: lo + batch]))
            bb = np.asarray(book.best[lo: lo + batch])
            rv, rr, rfound, rb = reader.lookup_best(pos)
            bad = (
                ~rfound | (bv != rv) | (br != rr) | (bb != rb)
            )
            for i in np.nonzero(bad)[0][:20]:
                problems.append(
                    f"book entry {hex(int(pos[i]))}: book says "
                    f"(v={int(bv[i])}, r={int(br[i])}, "
                    f"best={hex(int(bb[i]))}), reader says "
                    f"(v={int(rv[i])}, r={int(rr[i])}, "
                    f"best={hex(int(rb[i]))}, found={bool(rfound[i])})"
                )
            nbad = int(bad.sum())
            if nbad > 20:
                problems.append(
                    f"... +{nbad - 20} more mismatched book entries "
                    f"in batch at {lo}"
                )
    finally:
        reader.close()
    return problems


def main(argv=None) -> int:
    """Build (or rebuild) the opening book of a finalized DB: the twin
    of tools/build_book.py, its flags, lines and exit codes::

        python -m gamesmanmpi_tpu_torch.db.book DB_DIR --plies N
            [--verify] [--device cuda|cpu]

    --plies defaults to GAMESMAN_BOOK_PLIES. Exit 0 = sealed (and
    verified when asked), 1 = verification problems, 2 = usage error
    (no card without --device cpu among them)."""
    import argparse
    import sys

    from gamesmanmpi_tpu_torch.db.format import DbFormatError
    from gamesmanmpi_tpu_torch.utils.device import (
        DeviceUnavailable,
        resolve_device,
    )
    from gamesmanmpi_tpu_torch.utils.env import env_int

    p = argparse.ArgumentParser(
        description="Build (or rebuild) the resident opening book of a "
        "finalized DB.")
    p.add_argument("db_dir", help="finalized DB directory (from export-db)")
    p.add_argument("--plies", type=int, default=None, metavar="N",
                   help="book depth: every position within N plies of "
                   "the initial position. Default from GAMESMAN_BOOK_PLIES")
    p.add_argument("--verify", action="store_true",
                   help="after sealing, re-probe every book entry "
                   "through the reader and exit 1 on any mismatch")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the reader that scores the book "
                   "(default cuda)")
    args = p.parse_args(argv)
    plies = (env_int("GAMESMAN_BOOK_PLIES", 0) if args.plies is None
             else int(args.plies))
    if plies <= 0:
        print("error: --plies N (or GAMESMAN_BOOK_PLIES) must be > 0",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
        rec = build_book(args.db_dir, plies, device=device)
    except (DeviceUnavailable, DbFormatError, FileNotFoundError,
            ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"book sealed: {rec['count']} entries to {rec['plies']} plies "
          f"({rec['file']}, sha256 {rec['sha256'][:12]}…)")
    if args.verify:
        problems = verify_book(args.db_dir, device=device)
        for problem in problems:
            print(f"PROBLEM: {problem}", file=sys.stderr)
        if problems:
            print(f"{args.db_dir}: {len(problems)} problem(s)",
                  file=sys.stderr)
            return 1
        print("book verified: every entry matches the reader")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
