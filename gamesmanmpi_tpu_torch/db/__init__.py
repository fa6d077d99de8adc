"""db: the persistent, immutable solved-position database (port of
gamesmanmpi_tpu/db/, the offline half: format, writer, reader, checker,
opening book).

Per-level shards of (sorted canonical keys, packed value+remoteness
cells), a JSON manifest with per-shard checksums, a strict writer fed
from a live solve (the engine's level_sink) or an existing checkpoint
directory, and an mmap-backed reader whose batched lookup canonicalizes
through the game's symmetry (in torch, on the reader's device) before
probing. Either package reads the other's databases, and both write the
same bytes for the same game.

Reader, writer and book are loaded lazily (PEP 562): they pull in
torch, while the format helpers and the integrity checker do not — so a
DB validates with numpy alone.
"""

from gamesmanmpi_tpu_torch.db.format import (
    DbFormatError,
    parse_position,
    probe_sorted_np,
)

# The checker is lazy too, so `python -m gamesmanmpi_tpu_torch.db.check`
# runs the module once, as __main__.
_LAZY = {
    "check_db": "gamesmanmpi_tpu_torch.db.check",
    "DbReader": "gamesmanmpi_tpu_torch.db.reader",
    "DbWriter": "gamesmanmpi_tpu_torch.db.writer",
    "export_checkpoint": "gamesmanmpi_tpu_torch.db.writer",
    "export_result": "gamesmanmpi_tpu_torch.db.writer",
}

__all__ = [
    "DbFormatError",
    "DbReader",
    "DbWriter",
    "check_db",
    "export_checkpoint",
    "export_result",
    "parse_position",
    "probe_sorted_np",
]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
