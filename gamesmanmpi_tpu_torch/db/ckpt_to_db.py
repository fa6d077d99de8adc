"""Convert an existing --checkpoint-dir into a servable solved-position DB
(the twin of tools/ckpt_to_db.py: its flags and exit codes).

    python -m gamesmanmpi_tpu_torch.db.ckpt_to_db CKPT_DIR OUT_DIR
        --game 'connect4:w=5,h=4' [--overwrite] [--compress] [-v]
        [--device cuda|cpu]

A positional spelling of ``python -m gamesmanmpi_tpu_torch export-db
GAME --out OUT --from-checkpoint CKPT`` that delegates to it: one
conversion path (db/writer.export_checkpoint), two front doors. Classic
checkpoints, global or sharded, convert; dense ones are refused. The
--game spec must name the configuration the checkpoint was solved with;
the manifest's bound game name is checked against it.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert an existing --checkpoint-dir into a servable "
        "solved-position DB.")
    p.add_argument("checkpoint_dir", help="existing --checkpoint-dir")
    p.add_argument("out_dir", help="DB output directory")
    p.add_argument("--game", required=True,
                   help="built-in game spec the checkpoint was solved with "
                   "(e.g. tictactoe, 'connect4:w=5,h=4,sym=1')")
    p.add_argument("--overwrite", action="store_true",
                   help="replace an existing DB in out_dir")
    p.add_argument("--compress", action="store_true",
                   help="write format v2 (block-compressed levels, "
                   "decompress-on-probe serving); see export-db --compress")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-level progress to stderr")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the export (default cuda)")
    args = p.parse_args(argv)

    from gamesmanmpi_tpu_torch.cli import main as cli_main

    forward = ["export-db", args.game, "--out", args.out_dir,
               "--from-checkpoint", args.checkpoint_dir,
               "--device", args.device]
    if args.overwrite:
        forward.append("--overwrite")
    if args.compress:
        forward.append("--compress")
    if args.verbose:
        forward.append("--verbose")
    return cli_main(forward)


if __name__ == "__main__":
    sys.exit(main())
