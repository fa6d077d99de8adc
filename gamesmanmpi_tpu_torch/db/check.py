"""Database integrity validation (port of gamesmanmpi_tpu/db/check.py).

Structural checks only — no game construction, no kernels, no torch
(numpy and stdlib only) — so the checker runs in seconds on any host,
and a corrupted DB is caught before a serving process ever mmaps it:

* manifest parses, format/version/fields are right (db/format.read_manifest)
* every level's shard files exist and match their sha256 checksums
* keys are strictly ascending (sorted + unique, the probe's contract),
  hold no padding sentinel, and match the manifest dtype and count
* cells are uint32, parallel to the keys, and every cell decodes to a
  DECIDED value (an UNDECIDED cell in a solved DB is a solver bug —
  lookups would report found-but-valueless)
* **format v2** levels additionally prove the block machinery: index
  structure vs real stream bytes, per-block crc32 + decoded position
  counts, manifest first_keys vs the decoded blocks — checked
  block-by-block in O(one block) memory (the same invariant set as v1;
  the storage changed, the contract did not, and the gate must run on
  replica nodes sized for the compressed artifact)
* a manifest-recorded opening book (``book.gmb``) exists, matches its
  sha256 seal, parses, and holds sorted-unique decided entries — the
  structural half only; the answer-level re-probe (every entry vs the
  reader's slow path) needs game kernels and lives in
  db/book.py ``verify_book``, which tools/check_db.py runs

``db_stats`` folds the per-level size/ratio table (tools/check_db.py,
bench BENCH_DB_COMPRESS); ``db_equal`` proves two DBs logically
identical across storage versions (the compressed-migration gate);
``db_equal_fast`` is its O(manifest) digest screen — same sealed
sha256s means same content with zero decode, anything else falls back
to the streamed compare.

The command line (the twin of tools/check_db.py: its flags, lines and
exit codes)::

    python -m gamesmanmpi_tpu_torch.db.check DB_DIR [--quiet]
        [--stats-json F] [--same-as OTHER_DB] [--deep]
        [--skip-book-probe] [--device cuda|cpu]

checks the directory, then re-probes a sealed opening book through a
DbReader on --device (the only step that needs a device; without the
card it exits 2 unless --device cpu), and prints the per-level size and
ratio table. Exit 0 = clean, 1 = problems (one ``PROBLEM:`` line each on
stderr), 2 = usage error.
"""

from __future__ import annotations

import pathlib

import numpy as np

from gamesmanmpi_tpu_torch.utils.env import env_bool

from gamesmanmpi_tpu_torch.compress import (
    BlockCorruptError,
    block_bounds,
    decode_block,
    index_offsets,
    num_blocks,
    validate_index,
)  # block-streamed v2 checks: O(one block) memory at any DB scale
from gamesmanmpi_tpu_torch.core.host import sentinel_for, unpack_cells_np
from gamesmanmpi_tpu_torch.core.values import UNDECIDED
from gamesmanmpi_tpu_torch.db.format import (
    DbFormatError,
    file_sha256,
    level_is_blocked,
    read_manifest,
)


def check_db(directory, verbose=None) -> list[str]:
    """Validate one DB directory; returns a list of problems (empty = OK).

    verbose: optional callable taking one progress line per level.
    """
    directory = pathlib.Path(directory)
    problems: list[str] = []
    try:
        manifest = read_manifest(directory)
    except DbFormatError as e:
        return [str(e)]
    try:
        dt = np.dtype(manifest["state_dtype"])
        sentinel = sentinel_for(dt)
    except TypeError as e:
        return [f"manifest state_dtype: {e}"]
    total = 0
    for key in sorted(manifest["levels"], key=int):
        rec = manifest["levels"][key]
        tag = f"level {key}"
        ok = True
        for kind in ("keys", "cells"):
            path = directory / rec[kind]
            if not path.exists():
                problems.append(f"{tag}: missing file {rec[kind]}")
                ok = False
                continue
            digest = file_sha256(path)
            if digest != rec[f"{kind}_sha256"]:
                problems.append(
                    f"{tag}: {kind} checksum mismatch "
                    f"({digest[:12]}… != {rec[f'{kind}_sha256'][:12]}…)"
                )
                ok = False
        if not ok:
            continue
        if level_is_blocked(rec):
            n = _check_blocked_level(
                directory, rec, dt, sentinel, tag, problems
            )
            if n is not None:
                total += n
                if verbose is not None:
                    verbose(f"{tag}: {n} positions OK (blocked)")
            continue
        # The integrity gate must see exactly what is on disk, never a
        # cached decode, so it bypasses the block store by design.
        # store-io: integrity gate reads raw payload bytes on purpose
        keys = np.load(directory / rec["keys"], mmap_mode="r")
        cells = np.load(directory / rec["cells"], mmap_mode="r")  # store-io: raw gate read
        if keys.dtype != dt:
            problems.append(
                f"{tag}: keys dtype {keys.dtype}, manifest says {dt}"
            )
            continue
        if keys.shape[0] != rec["count"]:
            problems.append(
                f"{tag}: {keys.shape[0]} keys, manifest says {rec['count']}"
            )
        if cells.dtype != np.uint32 or cells.shape != keys.shape:
            problems.append(
                f"{tag}: cells are {cells.dtype}{list(cells.shape)}, "
                f"expected uint32[{keys.shape[0]}]"
            )
            continue
        if keys.shape[0]:
            if not np.all(keys[1:] > keys[:-1]):
                problems.append(f"{tag}: keys not strictly ascending")
            if keys[-1] == sentinel:
                problems.append(f"{tag}: keys contain the padding sentinel")
        # Decode through the one codec (not a private mask copy): a cell
        # layout change must not silently let the gate validate old bits.
        cell_values, _ = unpack_cells_np(np.asarray(cells))
        undecided = int(np.count_nonzero(cell_values == UNDECIDED))
        if undecided:
            problems.append(f"{tag}: {undecided} UNDECIDED cells")
        total += int(keys.shape[0])
        if verbose is not None:
            verbose(f"{tag}: {keys.shape[0]} positions OK")
    declared = manifest.get("num_positions")
    if declared is not None and declared != total:
        problems.append(
            f"manifest num_positions {declared} != shard total {total}"
        )
    problems += _check_book(directory, manifest, verbose)
    return problems


def _check_book(directory, manifest, verbose=None) -> list[str]:
    """Structural opening-book check — still game-free: seal (sha256),
    magic/header parse, entry count vs manifest, sorted-unique
    positions, decided cells. OpeningBook.load does the seal+parse
    (raising DbFormatError exactly like a worker warm start would)."""
    rec = manifest.get("book")
    if not rec:
        return []
    from gamesmanmpi_tpu_torch.db.book import OpeningBook
    try:
        book = OpeningBook.load(directory, manifest, verify=True)
    except (DbFormatError, KeyError, ValueError, OSError) as e:
        return [f"book: {e}"]
    problems: list[str] = []
    if len(book) != int(rec.get("count", -1)):
        problems.append(
            f"book: {len(book)} entries, manifest says {rec.get('count')}"
        )
    pos = np.asarray(book.positions)
    if pos.size and not np.all(pos[1:] > pos[:-1]):
        problems.append("book: positions not strictly ascending")
    values, _ = unpack_cells_np(np.asarray(book.cells))
    undecided = int(np.count_nonzero(values == UNDECIDED))
    if undecided:
        problems.append(f"book: {undecided} UNDECIDED entries")
    if verbose is not None and not problems:
        verbose(f"book: {len(book)} entries OK (plies {rec.get('plies')})")
    return problems


def _check_blocked_level(directory, rec, dt, sentinel, tag, problems):
    """Validate one v2 level block-by-block in O(one block) memory —
    the gate runs on replica nodes sized for the COMPRESSED artifact,
    so materializing a decoded multi-GB level (as a naive decode-all
    would) could OOM exactly where this check matters most.

    Per block: crc32 + codec decode + count (decode_block), dtype,
    in-block strict ascent, cross-boundary ascent against the previous
    block's last key, the manifest's first_keys router entry, cells
    parallel/uint32/decided. Plus the structural whole-level checks:
    index-vs-file sizes, keys-vs-cells counts, manifest count and
    stored_bytes. Returns the verified position count, or None after
    appending problems (one per level is enough: the first corrupt
    block ends the level's scan)."""
    kindex, cindex = rec.get("keys_blocks"), rec.get("cells_blocks")
    kpath, cpath = directory / rec["keys"], directory / rec["cells"]
    try:
        validate_index(kindex, stream_bytes=kpath.stat().st_size)
        validate_index(cindex, stream_bytes=cpath.stat().st_size)
    except (BlockCorruptError, OSError, TypeError) as e:
        problems.append(f"{tag}: block index invalid: {e}")
        return None
    if int(kindex["count"]) != int(cindex["count"]):
        problems.append(
            f"{tag}: {kindex['count']} keys vs {cindex['count']} cells "
            "in the block index"
        )
        return None
    if int(kindex["count"]) != int(rec["count"]):
        problems.append(
            f"{tag}: block index holds {kindex['count']} positions, "
            f"manifest says {rec['count']}"
        )
        return None
    first = [int(k) for k in rec.get("first_keys", [])]
    if len(first) != num_blocks(kindex):
        problems.append(
            f"{tag}: {len(first)} first_keys for "
            f"{num_blocks(kindex)} blocks"
        )
        return None
    stored = kpath.stat().st_size + cpath.stat().st_size
    if "stored_bytes" in rec and int(rec["stored_bytes"]) != stored:
        problems.append(
            f"{tag}: stored_bytes {rec['stored_bytes']} != {stored}"
        )
    koffs, coffs = index_offsets(kindex), index_offsets(cindex)
    prev_last = None
    total = 0
    undecided = 0
    try:
        # store-io: block-by-block gate reads the raw streams on purpose
        with open(kpath, "rb") as kf, open(cpath, "rb") as cf:
            for b in range(num_blocks(kindex)):
                keys, cells = _read_block_pair(
                    kf, cf, kindex, cindex, koffs, coffs, b
                )
                if keys.dtype != dt:
                    problems.append(
                        f"{tag}: keys dtype {keys.dtype}, manifest "
                        f"says {dt}"
                    )
                    return None
                if cells.dtype != np.uint32 or cells.shape != keys.shape:
                    problems.append(
                        f"{tag}: block {b} cells are "
                        f"{cells.dtype}{list(cells.shape)}, expected "
                        f"uint32[{keys.shape[0]}]"
                    )
                    return None
                if keys.shape[0]:
                    if int(keys[0]) != first[b]:
                        problems.append(
                            f"{tag}: manifest first_keys disagree with "
                            "the decoded blocks — the probe's block "
                            "router would misroute"
                        )
                        return None
                    if not np.all(keys[1:] > keys[:-1]) or (
                        prev_last is not None and not keys[0] > prev_last
                    ):
                        problems.append(
                            f"{tag}: keys not strictly ascending "
                            f"(block {b})"
                        )
                        return None
                    prev_last = keys[-1]
                cell_values, _ = unpack_cells_np(cells)
                undecided += int(
                    np.count_nonzero(cell_values == UNDECIDED)
                )
                total += int(keys.shape[0])
    except (BlockCorruptError, OSError) as e:
        problems.append(f"{tag}: block stream invalid: {e}")
        return None
    if prev_last is not None and prev_last == sentinel:
        problems.append(f"{tag}: keys contain the padding sentinel")
    if undecided:
        problems.append(f"{tag}: {undecided} UNDECIDED cells")
    return total


def db_stats(directory) -> dict:
    """Per-level size/ratio summary of a (valid) DB directory, shared by
    the tools/check_db.py table, bench.py's BENCH_DB_COMPRESS gate, and
    the serving docs' shipping math. Raises DbFormatError on an
    unreadable manifest; file-size figures come from disk, ratios from
    the v2 manifest records (v1 levels report ratio 1.0).

    -> {"version", "num_positions", "raw_bytes", "stored_bytes",
        "ratio", "levels": [{level, count, raw_bytes, stored_bytes,
        ratio, codecs}]}
    """
    directory = pathlib.Path(directory)
    manifest = read_manifest(directory)
    rows = []
    for key in sorted(manifest["levels"], key=int):
        rec = manifest["levels"][key]
        if level_is_blocked(rec):
            # raw/stored_bytes are optional in the record (check_db
            # treats them as such — a foreign writer may omit them);
            # fall back to disk sizes / the dtype arithmetic instead of
            # KeyError-ing after a clean check.
            stored = int(rec.get("stored_bytes", sum(
                (directory / rec[kind]).stat().st_size
                for kind in ("keys", "cells")
                if (directory / rec[kind]).exists()
            )))
            raw = int(rec.get("raw_bytes", int(rec["count"]) * (
                np.dtype(manifest["state_dtype"]).itemsize + 4
            )))
            codecs = sorted(
                set(rec["keys_blocks"]["codecs"])
                | set(rec["cells_blocks"]["codecs"])
            )
        else:
            stored = raw = sum(
                (directory / rec[kind]).stat().st_size
                for kind in ("keys", "cells")
                if (directory / rec[kind]).exists()
            )
            codecs = ["none"]
        rows.append({
            "level": int(key),
            "count": int(rec["count"]),
            "raw_bytes": raw,
            "stored_bytes": stored,
            "ratio": raw / stored if stored else 1.0,
            "codecs": codecs,
        })
    raw = sum(r["raw_bytes"] for r in rows)
    stored = sum(r["stored_bytes"] for r in rows)
    return {
        "version": int(manifest["version"]),
        "num_positions": sum(r["count"] for r in rows),
        "raw_bytes": raw,
        "stored_bytes": stored,
        "ratio": raw / stored if stored else 1.0,
        "levels": rows,
    }


class _LevelRangeReader:
    """Uniform `[lo, hi)` access to one level's (keys, cells) across
    storage versions: v1 slices the mmap (no copy), v2 decodes only the
    blocks covering the range. Lets db_equal stream a comparison in
    O(chunk) memory instead of materializing multi-GB decoded levels."""

    def __init__(self, directory, rec):
        self.count = int(rec["count"])
        self._blocked = level_is_blocked(rec)
        if self._blocked:
            self._kindex = rec["keys_blocks"]
            self._cindex = rec["cells_blocks"]
            validate_index(
                self._kindex,
                stream_bytes=(directory / rec["keys"]).stat().st_size,
            )
            validate_index(
                self._cindex,
                stream_bytes=(directory / rec["cells"]).stat().st_size,
            )
            self._koffs = index_offsets(self._kindex)
            self._coffs = index_offsets(self._cindex)
            self._kf = self._cf = None
            try:
                # The equality verdict must not share a cache with the
                # readers it is auditing.
                # store-io: streaming compare reads raw bytes on purpose
                self._kf = open(directory / rec["keys"], "rb")
                self._cf = open(directory / rec["cells"], "rb")  # store-io: raw gate read
            except BaseException:
                # A half-built reader is never returned to the caller's
                # close() bookkeeping — release what DID open.
                self.close()
                raise
        else:
            # store-io: raw gate read (see above)
            self._keys = np.load(directory / rec["keys"], mmap_mode="r")  # store-io: raw gate read
            self._cells = np.load(directory / rec["cells"], mmap_mode="r")  # store-io: raw gate read

    def _block(self, b):
        return _read_block_pair(
            self._kf, self._cf, self._kindex, self._cindex,
            self._koffs, self._coffs, b,
        )

    def range(self, lo, hi):
        """-> (keys[lo:hi], cells[lo:hi])."""
        if not self._blocked:
            return self._keys[lo:hi], self._cells[lo:hi]
        bp = int(self._kindex["block_positions"])
        ks, cs = [], []
        for b in range(lo // bp, (max(hi, lo + 1) - 1) // bp + 1):
            keys, cells = self._block(b)
            start, _ = block_bounds(self._kindex, b)
            a = max(lo - start, 0)
            z = min(hi - start, keys.shape[0])
            ks.append(keys[a:z])
            cs.append(cells[a:z])
        return np.concatenate(ks), np.concatenate(cs)

    def close(self):
        if self._blocked:
            for fh in (self._kf, self._cf):
                if fh is not None:
                    fh.close()
            self._kf = self._cf = None


def _read_block_pair(kf, cf, kindex, cindex, koffs, coffs, b):
    """Seek+read+decode block b of a (keys, cells) .gmb stream pair —
    the one block-stream access sequence both the streaming checker and
    _LevelRangeReader share."""
    kf.seek(int(koffs[b]))
    keys = decode_block(kindex, b, kf.read(int(koffs[b + 1] - koffs[b])))
    cf.seek(int(coffs[b]))
    cells = decode_block(cindex, b, cf.read(int(coffs[b + 1] - coffs[b])))
    return keys, cells


def db_equal(dir_a, dir_b) -> list[str]:
    """Logical equality of two DBs' solved content — same games, levels,
    keys, and cells, regardless of storage version. Returns differences
    (empty = identical); the migration gate that proves a compressed
    re-export answers every position identically to its v1 twin without
    sampling."""
    dir_a, dir_b = pathlib.Path(dir_a), pathlib.Path(dir_b)
    try:
        ma, mb = read_manifest(dir_a), read_manifest(dir_b)
    except DbFormatError as e:
        return [str(e)]
    diffs = []
    # spec_sha256 is the gamedsl rules hash: absent on both sides for
    # registry games (None == None), it only gates compiled-spec DBs —
    # where a rules change must fail --same-as even before the tables
    # are compared.
    for field in ("game", "spec", "state_dtype", "sym", "spec_sha256"):
        if ma.get(field) != mb.get(field):
            diffs.append(
                f"{field}: {ma.get(field)!r} != {mb.get(field)!r}"
            )
    la, lb = set(ma["levels"]), set(mb["levels"])
    for missing in sorted(la ^ lb, key=int):
        diffs.append(f"level {missing}: present in only one DB")
    if diffs:
        return diffs
    # Chunked comparison (multiple of the default block size, so v2
    # sides decode each block once): O(chunk) memory at any DB scale.
    chunk = 1 << 20
    for key in sorted(la, key=int):
        readers = []
        try:
            try:
                ra = _LevelRangeReader(dir_a, ma["levels"][key])
                readers.append(ra)
                rb = _LevelRangeReader(dir_b, mb["levels"][key])
                readers.append(rb)
            except (BlockCorruptError, OSError, KeyError) as e:
                diffs.append(f"level {key}: unreadable: {e}")
                continue
            if ra.count != rb.count:
                diffs.append(
                    f"level {key}: {ra.count} vs {rb.count} positions"
                )
                continue
            for lo in range(0, max(ra.count, 1), chunk):
                hi = min(lo + chunk, ra.count)
                if hi <= lo:
                    break
                try:
                    ka, ca = ra.range(lo, hi)
                    kb, cb = rb.range(lo, hi)
                except (BlockCorruptError, OSError) as e:
                    diffs.append(f"level {key}: unreadable: {e}")
                    break
                if not np.array_equal(ka, kb):
                    diffs.append(f"level {key}: keys differ")
                    break
                if not np.array_equal(np.asarray(ca), np.asarray(cb)):
                    diffs.append(f"level {key}: cells differ")
                    break
        finally:
            for r in readers:
                r.close()
    return diffs


def db_equal_fast(dir_a, dir_b):
    """O(manifest) equality screen: compare the two DBs' sealed
    per-level sha256 digests (plus identity fields, level sets, counts
    and v2 block routing) without decoding a single payload byte.

    -> ``(verdict, diffs)`` where verdict is

    * ``"same"`` — identity fields, level structure, and every sealed
      digest match: the stored bytes are identical, so the solved
      content is too;
    * ``"different"`` — the manifests disagree on identity, levels, or
      counts: no decode can reconcile that;
    * ``"unknown"`` — digests differ (or the sides use different
      storage versions / codecs). Digest inequality is NOT a logical
      verdict — the same solved table stored v1 vs v2 hashes
      differently — so callers needing an answer fall back to the full
      streamed :func:`db_equal` (tools/check_db.py ``--same-as`` does
      exactly that; ``--deep`` skips the screen).

    ``diffs`` names what disagreed (empty for ``"same"``).
    """
    dir_a, dir_b = pathlib.Path(dir_a), pathlib.Path(dir_b)
    try:
        ma, mb = read_manifest(dir_a), read_manifest(dir_b)
    except DbFormatError as e:
        return "different", [str(e)]
    diffs = []
    for field in ("game", "spec", "state_dtype", "sym", "spec_sha256"):
        if ma.get(field) != mb.get(field):
            diffs.append(f"{field}: {ma.get(field)!r} != {mb.get(field)!r}")
    la, lb = set(ma["levels"]), set(mb["levels"])
    for missing in sorted(la ^ lb, key=int):
        diffs.append(f"level {missing}: present in only one DB")
    if diffs:
        return "different", diffs
    needs_deep = []
    for key in sorted(la, key=int):
        ra, rb = ma["levels"][key], mb["levels"][key]
        if int(ra["count"]) != int(rb["count"]):
            diffs.append(
                f"level {key}: {ra['count']} vs {rb['count']} positions"
            )
            continue
        if level_is_blocked(ra) != level_is_blocked(rb):
            needs_deep.append(
                f"level {key}: storage differs (v1 vs blocked v2); "
                "digests are not comparable"
            )
            continue
        for kind in ("keys", "cells"):
            if ra[f"{kind}_sha256"] != rb[f"{kind}_sha256"]:
                needs_deep.append(
                    f"level {key}: {kind} digests differ (content OR "
                    "encoding — deep compare decides)"
                )
        if level_is_blocked(ra) and ra.get("first_keys") != \
                rb.get("first_keys"):
            needs_deep.append(f"level {key}: block routing differs")
    if diffs:
        return "different", diffs + needs_deep
    if needs_deep:
        return "unknown", needs_deep
    return "same", []


def verify_for_serving(directory, verbose=None) -> bool:
    """Warm-start gate: the full :func:`check_db` pass a serving worker
    runs before it joins the ready set (ROADMAP: "warm replica start
    verified by check_db").

    Returns True when the DB was checked clean, False when verification
    is switched off (``GAMESMAN_SERVE_VERIFY=0`` — read-heavy restarts
    on trusted storage, where re-hashing a multi-GB DB per worker spawn
    is the wrong trade). Raises :class:`DbFormatError` on any problem:
    a worker must never start answering from a DB it cannot prove
    intact — the supervisor treats the failed spawn like any other
    worker death (backoff, storm breaker), so one rotted replica
    degrades to a restart loop instead of serving corrupt values.
    """
    if not env_bool("GAMESMAN_SERVE_VERIFY", True):
        return False
    problems = check_db(directory, verbose=verbose)
    if problems:
        raise DbFormatError(
            f"{directory}: serving verification failed: {problems[0]}"
            + (f" (+{len(problems) - 1} more)" if len(problems) > 1 else "")
        )
    return True


def format_stats_table(stats: dict) -> str:
    """The per-level size/ratio table (db_stats record -> text)."""
    lines = [
        f"{'level':>5}  {'positions':>10}  {'stored_MB':>11}  "
        f"{'raw_MB':>11}  {'ratio':>6}  codecs"
    ]
    for row in stats["levels"]:
        lines.append(
            f"{row['level']:>5}  {row['count']:>10}  "
            f"{row['stored_bytes'] / 1e6:>11.2f}  "
            f"{row['raw_bytes'] / 1e6:>11.2f}  "
            f"{row['ratio']:>5.1f}x  {','.join(row['codecs'])}"
        )
    lines.append(
        f"{'TOTAL':>5}  {stats['num_positions']:>10}  "
        f"{stats['stored_bytes'] / 1e6:>11.2f}  "
        f"{stats['raw_bytes'] / 1e6:>11.2f}  "
        f"{stats['ratio']:>5.1f}x  (format v{stats['version']})"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    """The checker's entry point (module docstring)."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        description="Solved-position DB integrity checker (CI-runnable).")
    p.add_argument("db_dir", help="database directory (from export-db)")
    p.add_argument("--quiet", action="store_true",
                   help="print problems only — no per-level OK lines, "
                   "no summary table")
    p.add_argument("--stats-json", default=None, metavar="FILE",
                   help="also write the db_stats record (per-level "
                   "sizes/ratios) as JSON")
    p.add_argument("--same-as", default=None, metavar="OTHER_DB",
                   help="additionally require logical equality with "
                   "another DB directory (storage-version-agnostic); the "
                   "sealed manifest sha256s are compared first, and only "
                   "an inconclusive screen streams the full compare")
    p.add_argument("--deep", action="store_true",
                   help="with --same-as: always run the full streamed "
                   "decode compare")
    p.add_argument("--skip-book-probe", action="store_true",
                   help="skip the opening-book deep re-probe (the only "
                   "check that needs a device); the structural "
                   "seal/parse check still runs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the book re-probe's reader (default "
                   "cuda)")
    args = p.parse_args(argv)

    problems = check_db(args.db_dir, verbose=None if args.quiet else print)
    if args.same_as:
        verdict = "unknown"
        if not args.deep:
            verdict, fast_diffs = db_equal_fast(args.db_dir, args.same_as)
            if verdict == "same" and not args.quiet:
                print(f"same-as {args.same_as}: manifest digests match "
                      "(fast path)")
            elif verdict == "different":
                problems += [f"differs from {args.same_as}: {d}"
                             for d in fast_diffs]
        if verdict == "unknown":
            problems += [f"differs from {args.same_as}: {d}"
                         for d in db_equal(args.db_dir, args.same_as)]
    if not problems and not args.skip_book_probe:
        try:
            has_book = bool(read_manifest(args.db_dir).get("book"))
        except DbFormatError:
            has_book = False
        if has_book:
            from gamesmanmpi_tpu_torch.db.book import verify_book
            from gamesmanmpi_tpu_torch.utils.device import (
                DeviceUnavailable,
                resolve_device,
            )

            try:
                device = resolve_device(args.device)
            except DeviceUnavailable as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            problems += verify_book(args.db_dir, device=device)
            if not args.quiet and not problems:
                print("book: deep re-probe OK (every entry matches the "
                      "reader)")
    for problem in problems:
        print(f"PROBLEM: {problem}", file=sys.stderr)
    if problems:
        print(f"{args.db_dir}: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    try:
        stats = db_stats(args.db_dir)
    except (DbFormatError, OSError) as e:
        # check_db passed, so this is a race (a file vanished).
        print(f"PROBLEM: stats: {e}", file=sys.stderr)
        return 1
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(stats, fh, indent=1)
    if not args.quiet:
        print(format_stats_table(stats))
        print(f"{args.db_dir}: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
