"""`python -m gamesmanmpi_tpu_torch solve GAME ...` (see cli.py)."""

import sys

from gamesmanmpi_tpu_torch.cli import main

sys.exit(main())
