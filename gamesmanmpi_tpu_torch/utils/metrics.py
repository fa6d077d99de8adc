"""Structured per-level records (port of gamesmanmpi_tpu/utils/metrics.py).

One record per solve phase per level — level, frontier size, seconds —
emitted as JSONL (``--jsonl``) and optionally as human-readable lines
(``-v``): ``JsonlLogger``, ``StdoutLogger`` and ``TeeLogger``.
``TagLogger`` stamps constant fields, the serving fleet's
``worker=<id>``; ``RankLogger`` stamps ``rank=<i>`` on each process of a
multi-process solve.
"""

from __future__ import annotations

import json
import os
import sys
import time


class _ClosingLogger:
    """Context-manager protocol shared by every logger: `with` guarantees
    the file handle closes on exceptions (long-lived consumers — the CLI,
    the query server — would otherwise leak handles / lose buffered tail
    records on an aborted solve)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class JsonlLogger(_ClosingLogger):
    """Appends one JSON object per record to a file."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        rec = {"t": round(time.time() - self._t0, 6), **record}
        self._fh.write(json.dumps(rec, default=str) + "\n")

    def close(self) -> None:
        """Flush-and-fsync, tolerating double-close: an aborted solve's
        teardown may close both via the context manager and an explicit
        close, and the tail records (the evidence of WHERE it died) must
        be durable on disk, not in a lost OS buffer."""
        if self._fh.closed:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            pass  # fs without fsync / already-invalid fd: best effort
        finally:
            self._fh.close()


class TagLogger(_ClosingLogger):
    """Stamp every record with constant fields (a record's own value for
    a key wins over the stamp). The serving fleet stamps ``worker=<id>``
    on each worker's JSONL stream so tools/obs_report.py can merge N
    workers' ``serve_batch`` records without ambiguity."""

    def __init__(self, inner, **tags):
        self.inner = inner
        self.tags = tags

    def log(self, record: dict) -> None:
        merged = {**self.tags, **record}
        self.inner.log(merged)

    def close(self) -> None:
        self.inner.close()


class StdoutLogger(_ClosingLogger):
    """Human-readable per-level progress lines (debug flag analog)."""

    def log(self, record: dict) -> None:
        phase = record.get("phase", "?")
        level = record.get("level", "-")
        parts = [
            f"{k}={v}" for k, v in record.items() if k not in ("phase", "level")
        ]
        print(f"[{phase}] level={level} " + " ".join(parts), file=sys.stderr)

    def close(self) -> None:
        pass


class TeeLogger(_ClosingLogger):
    """Fan a record out to several loggers."""

    def __init__(self, *loggers):
        self.loggers = [l for l in loggers if l is not None]

    def log(self, record: dict) -> None:
        for l in self.loggers:
            l.log(record)

    def close(self) -> None:
        for l in self.loggers:
            l.close()


class RankLogger(TagLogger):
    """Stamp every record with the emitting process's rank.

    A multi-process solve writes one JSONL stream per rank (same
    schema); without the stamp the merged streams are rank-ambiguous and
    tools/obs_report.py cannot tell "two ranks timed the same level"
    (wall-clock: take the max) from "one rank retried it" (accumulate).
    """

    def __init__(self, inner, rank: int):
        super().__init__(inner, rank=int(rank))
