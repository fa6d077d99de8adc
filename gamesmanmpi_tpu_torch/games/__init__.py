"""Game registry of the torch port (port of gamesmanmpi_tpu/games/__init__.py).

Spec grammar, as in the reference: "name" or "name:key=value,...", e.g.
    connect4:w=5,h=4     connect4:w=3,h=3,connect=3

Only the Connect-4 family is ported so far; the reference's other
built-in games (and GameSpec .json files) raise :class:`NotPortedError`,
which the CLI reports with exit 2.
"""

from __future__ import annotations

from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.games.connect4 import Connect4

#: Game names the reference accepts that the port has not reached yet.
_NOT_PORTED = ("tictactoe", "ttt", "mnk", "subtract", "1210", "tentozero",
               "nim", "chomp")


class NotPortedError(ValueError):
    """A game or engine the reference has and the port does not yet."""


def _parse_kwargs(spec: str) -> dict:
    out = {}
    if not spec:
        return out
    for item in spec.split(","):
        k, _, v = item.partition("=")
        out[k.strip()] = v.strip()
    return out


def get_game(spec: str) -> TensorGame:
    """Construct a built-in game from a spec string (see module docstring)."""
    if spec.strip().lower().endswith(".json"):
        raise NotPortedError(
            f"game spec files ({spec!r}) are not yet ported "
            "(ROADMAP Queue 1)")
    name, _, rest = spec.partition(":")
    kw = _parse_kwargs(rest)
    name = name.strip().lower()

    def _flag(key):
        v = kw.get(key, "0").strip().lower()
        if v in ("0", "false", "no", "off", ""):
            return False
        if v in ("1", "true", "yes", "on"):
            return True
        raise ValueError(f"bad boolean for {key!r} in spec {spec!r}: {v!r}")

    if name in ("connect4", "c4", "win4", "connectn"):
        return Connect4(
            width=int(kw.get("w", kw.get("width", 7))),
            height=int(kw.get("h", kw.get("height", 6))),
            connect=int(kw.get("k", kw.get("connect", 4))),
            sym=_flag("sym"),
        )
    if name in _NOT_PORTED:
        raise NotPortedError(
            f"game {name!r} is not yet ported to the torch package "
            "(ROADMAP Queue 1)")
    raise KeyError(f"unknown game spec {spec!r}")


__all__ = ["TensorGame", "Connect4", "NotPortedError", "get_game"]
