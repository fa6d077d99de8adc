"""The program's `serve` CLI with a fault planted in its DB reader, for
the benchmark's tests only:

    python h100bench/tests/faulty_serve.py answer|half SERVE-ARGS...

answer: one answer in seven altered where it is produced
(DbReader.lookup_best); half: half of each flushed batch left unanswered.
The fleet's workers fork from this process and keep the fault.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def plant(fault: str) -> None:
    from gamesmanmpi_tpu_torch.db.reader import DbReader

    plain = DbReader.lookup_best

    def altered(self, queries):
        values, rem, found, best = plain(self, queries)
        if fault == "answer":
            rem = rem.copy()
            rem[3::7] += 1
        elif len(found) > 1:
            found = found.copy()
            found[len(found) // 2:] = False
        return values, rem, found, best

    DbReader.lookup_best = altered


if __name__ == "__main__":
    plant(sys.argv[1])
    from gamesmanmpi_tpu_torch.cli import main

    sys.exit(main(["serve", *sys.argv[2:]]))
