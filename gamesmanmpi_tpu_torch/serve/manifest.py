"""Fleet manifest: one supervisor routing many game databases (port of
gamesmanmpi_tpu/serve/manifest.py).

A fleet manifest is a JSON file naming the solved-position DBs one
serving fleet answers for::

    {
      "version": 1,
      "games": [
        {"name": "c4_54", "db": "dbs/c4_54.db"},
        {"name": "ttt",   "db": "dbs/ttt.db"}
      ]
    }

``name`` is the URL routing key (``POST /query/<name>``) and must be a
single url-safe token; ``db`` is an export-db directory, resolved
relative to the manifest file's own directory so a manifest can ship
next to its DBs. Validation here is structural only (names unique and
well-formed, directories present) — DB *integrity* is the worker
warm-start gate's job (db/check.verify_for_serving), re-run by every
worker before it joins the ready set.
"""

from __future__ import annotations

import json
import pathlib
import re

from gamesmanmpi_tpu_torch.db.format import MANIFEST_NAME

#: Routing keys must survive a URL path segment un-escaped.
_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]+$")

FLEET_VERSION = 1


class FleetEntry:
    """One (routing name, DB directory) pair of a serving fleet."""

    __slots__ = ("name", "db")

    def __init__(self, name: str, db: str):
        self.name = name
        self.db = str(db)

    def __repr__(self) -> str:  # tests / log lines
        return f"FleetEntry(name={self.name!r}, db={self.db!r})"


def load_fleet_manifest(path) -> list[FleetEntry]:
    """Parse + validate a fleet manifest; raises ValueError on junk.

    A malformed manifest must fail the *reload/launch*, loudly, before
    any worker is restarted against it — a half-validated fleet config
    is how a rolling reload takes a healthy fleet down.
    """
    path = pathlib.Path(path)
    try:
        doc = json.loads(path.read_text())
    except OSError as e:
        raise ValueError(f"cannot read fleet manifest {path}: {e}") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"fleet manifest {path} is not JSON: {e}") from None
    if not isinstance(doc, dict) or doc.get("version") != FLEET_VERSION:
        raise ValueError(
            f"fleet manifest {path}: expected "
            f'{{"version": {FLEET_VERSION}, "games": [...]}}'
        )
    games = doc.get("games")
    if not isinstance(games, list) or not games:
        raise ValueError(f"fleet manifest {path}: 'games' must be a "
                         "non-empty list")
    entries: list[FleetEntry] = []
    seen: set[str] = set()
    for i, rec in enumerate(games):
        if not isinstance(rec, dict) or not rec.get("name") \
                or not rec.get("db"):
            raise ValueError(
                f"fleet manifest {path}: games[{i}] needs 'name' and 'db'"
            )
        name = str(rec["name"])
        if not _NAME_RE.match(name):
            raise ValueError(
                f"fleet manifest {path}: game name {name!r} is not a "
                "url-safe token"
            )
        if name in seen:
            raise ValueError(
                f"fleet manifest {path}: duplicate game name {name!r}"
            )
        seen.add(name)
        db = pathlib.Path(rec["db"])
        if not db.is_absolute():
            db = path.parent / db
        if not db.is_dir():
            raise ValueError(
                f"fleet manifest {path}: games[{i}] ({name}): no such DB "
                f"directory {db}"
            )
        # A directory without a readable DB manifest is a half-landed
        # pull (or a typo'd path) — reject it HERE, naming the entry,
        # before any worker is drained against it. The full integrity
        # gate (db/check.verify_for_serving) still runs per worker;
        # this is the cheap fail-early half.
        dbm = db / MANIFEST_NAME
        try:
            present = dbm.is_file()
        except OSError as e:  # unreadable parent (perms, stale mount)
            raise ValueError(
                f"fleet manifest {path}: games[{i}] ({name}): DB "
                f"directory {db} is unreadable ({e})"
            ) from None
        if not present:
            raise ValueError(
                f"fleet manifest {path}: games[{i}] ({name}): {db} has "
                f"no {MANIFEST_NAME} — not a finalized DB (half-landed "
                "pull or export?)"
            )
        entries.append(FleetEntry(name, str(db)))
    return entries


def single_db_entries(db) -> list[FleetEntry]:
    """The degenerate fleet of a bare ``serve DB`` invocation: one DB on
    the default route (empty name — ``POST /query`` with no suffix)."""
    return [FleetEntry("", str(db))]
