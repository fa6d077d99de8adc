"""The one home for os.environ reads in the torch port.

gamesman-lint's GM301 allows raw ``os.environ`` reads only in a file
ending ``utils/env.py``; the port keeps its own copy of the reference
helper it needs rather than importing ``gamesmanmpi_tpu``. The port
prefers constructor arguments to environment knobs, so the only read is
the CUDA toolkit location the kernel build looks for.
"""

from __future__ import annotations

import os
from typing import Optional


def env_opt(name: str) -> Optional[str]:
    """The variable's value, or None when it is unset."""
    return os.environ.get(name)
