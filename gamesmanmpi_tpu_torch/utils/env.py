"""The one home for os.environ reads in the torch port.

gamesman-lint's GM301 allows raw ``os.environ`` reads only in a file
ending ``utils/env.py``; the port keeps its own copies of the reference
helpers it needs (gamesmanmpi_tpu/utils/env.py) rather than importing
``gamesmanmpi_tpu``. Every ``GAMESMAN_*`` name read through them is one
``docs/CONFIG.md`` already lists.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional


def env_opt(name: str) -> Optional[str]:
    """The variable's value, or None when it is unset."""
    return os.environ.get(name)


def env_int(name: str, default: int) -> int:
    """Integer knob; a malformed value warns and gives the default."""
    raw = os.environ.get(name, str(default))
    try:
        return int(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not an integer; using {default}")
        return default


def env_int_strict(name: str, default: int) -> int:
    """Integer knob that fails fast: a malformed value raises ValueError
    naming it (where a silent default would run the wrong
    configuration)."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def env_float(name: str, default: float) -> float:
    """Numeric knob; a malformed value warns and gives the default."""
    raw = os.environ.get(name, str(default))
    try:
        return float(raw)
    except ValueError:
        warnings.warn(f"{name}={raw!r} is not a number; using {default}")
        return default


def env_str(name: str, default: str) -> str:
    """The variable's value, or `default` when it is unset."""
    return os.environ.get(name, default)


def env_bool(name: str, default: bool) -> bool:
    """On/off knob: "0"/"off"/"false"/"no" (any case) is False,
    "1"/"on"/"true"/"yes" is True; anything else warns and gives the
    default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    low = raw.strip().lower()
    if low in ("0", "off", "false", "no"):
        return False
    if low in ("1", "on", "true", "yes"):
        return True
    warnings.warn(f"{name}={raw!r} is not a boolean; using {default}")
    return default
