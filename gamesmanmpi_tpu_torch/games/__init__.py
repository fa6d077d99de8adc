"""Game registry of the torch port (port of gamesmanmpi_tpu/games/__init__.py).

Spec grammar, as in the reference: "name" or "name:key=value,...", e.g.
    tictactoe            tictactoe:m=4,n=4,k=4,sym=1
    connect4:w=5,h=4     subtract:total=10,moves=1-2,misere=1
    nim:heaps=3-4-5      nim:heaps=1-2-10,misere=1
    chomp:w=4,h=3        chomp:w=3,h=3,sym=1

A path ending ``.json`` is a declarative GameSpec file, compiled by
gamedsl (gamedsl/compiler.py) as the reference compiles it; an
unreadable file or a bad spec is a ValueError.
"""

from __future__ import annotations

from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.games.chomp import Chomp
from gamesmanmpi_tpu_torch.games.connect4 import Connect4
from gamesmanmpi_tpu_torch.games.nim import Nim
from gamesmanmpi_tpu_torch.games.subtract import Subtract
from gamesmanmpi_tpu_torch.games.tictactoe import TicTacToe


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


def _intlist(v: str):
    return tuple(int(x) for x in v.replace("-", " ").split())


def get_game(spec: str) -> TensorGame:
    """Construct a built-in game from a spec string (see module docstring)."""
    if spec.strip().lower().endswith(".json"):
        # A declarative GameSpec file: compile it. SpecError subclasses
        # ValueError, so callers' bad-spec handling covers both paths.
        from gamesmanmpi_tpu_torch.gamedsl.compiler import compile_spec

        try:
            return compile_spec(spec.strip())
        except OSError as e:
            raise ValueError(
                f"cannot read game spec file {spec!r}: {e}") from e
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

    if name in ("tictactoe", "ttt", "mnk"):
        return TicTacToe(
            m=int(kw.get("m", 3)), n=int(kw.get("n", 3)),
            k=int(kw.get("k", 3)), sym=_flag("sym"),
        )
    if name in ("connect4", "c4", "win4", "connectn"):
        return Connect4(
            width=int(kw.get("w", kw.get("width", 7))),
            height=int(kw.get("h", kw.get("height", 6))),
            connect=int(kw.get("k", kw.get("connect", 4))),
            sym=_flag("sym"),
        )
    if name in ("subtract", "1210", "tentozero"):
        return Subtract(
            total=int(kw.get("total", kw.get("n", 10))),
            moves=_intlist(kw.get("moves", "1-2")),
            misere=_flag("misere"),
        )
    if name == "nim":
        return Nim(
            heaps=_intlist(kw.get("heaps", "3-4-5")),
            misere=_flag("misere"),
        )
    if name == "chomp":
        return Chomp(
            width=int(kw.get("w", kw.get("width", 4))),
            height=int(kw.get("h", kw.get("height", 3))),
            sym=_flag("sym"),
        )
    raise KeyError(f"unknown game spec {spec!r}")


__all__ = ["TensorGame", "TicTacToe", "Subtract", "Nim", "Connect4",
           "Chomp", "NotPortedError", "get_game"]
