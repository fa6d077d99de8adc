"""Pure-Python oracle: memoized negamax over the reference's scalar game API
(port of gamesmanmpi_tpu/solve/oracle.py, stdlib and core/values only).

This is the ~50-line reference solver SURVEY.md §4.2 prescribes as the parity
axis: an implementation-independent ground truth with the same observable
semantics as the reference's distributed solve (value + remoteness of every
reachable position). It consumes *unmodified reference-style modules* —
`initial_position`, `gen_moves`/`generate_moves`, `do_move`, `primitive` —
and is also the execution path of the compat shim for arbitrary plugin
modules (gamesmanmpi_tpu_torch.compat).

Primitive return values are normalized: the reference's string constants
("WIN"/"LOSE"/"TIE"/"UNDECIDED", SURVEY.md §2.2 "Constants"), our uint8
constants, or None for undecided are all accepted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from gamesmanmpi_tpu_torch.core.values import (
    WIN,
    LOSE,
    TIE,
    UNDECIDED,
    MAX_REMOTENESS,
)

_STRING_VALUES = {
    "WIN": WIN,
    "LOSE": LOSE,
    "LOSS": LOSE,
    "TIE": TIE,
    "DRAW": TIE,
    "UNDECIDED": UNDECIDED,
}


def normalize_value(v) -> int:
    """Map a primitive() return (str/int/None) onto the uint8 constants."""
    if v is None:
        return UNDECIDED
    if isinstance(v, str):
        try:
            return _STRING_VALUES[v.upper()]
        except KeyError:
            raise ValueError(f"unrecognized primitive value {v!r}") from None
    v = int(v)
    if v not in (WIN, LOSE, TIE, UNDECIDED):
        raise ValueError(f"unrecognized primitive value {v!r}")
    return v


def module_api(module):
    """Extract (initial_position, gen_moves, do_move, primitive) from a module.

    Accepts both spellings of the move generator (SURVEY.md §2.1.1 flags the
    reference's exact name as gen_moves vs generate_moves — support both).
    """
    gen = getattr(module, "gen_moves", None) or getattr(module, "generate_moves", None)
    if gen is None:
        raise AttributeError("game module needs gen_moves or generate_moves")
    for attr in ("initial_position", "do_move", "primitive"):
        if not hasattr(module, attr):
            raise AttributeError(f"game module needs {attr}")
    return module.initial_position, gen, module.do_move, module.primitive


def combine_host(child_results) -> Tuple[int, int]:
    """Host twin of ops/combine.combine_children for one parent.

    child_results: list of (value, remoteness) in child perspective.
    """
    lose = [r for v, r in child_results if v == LOSE]
    tie = [r for v, r in child_results if v == TIE]
    if lose:
        return WIN, 1 + min(lose)
    if tie:
        return TIE, 1 + max(tie)
    if not child_results:
        return LOSE, 0
    return LOSE, 1 + max(r for _, r in child_results)


def oracle_solve(module) -> Tuple[int, int, Dict[object, Tuple[int, int]]]:
    """Strongly solve a scalar game module.

    Returns (root_value, root_remoteness, table) where table maps every
    reachable position to its (value, remoteness). Iterative DFS (explicit
    stack) so deep games don't hit the recursion limit; raises on cycles
    (the reference's recursion assumes acyclic games, SURVEY.md §2.1.5).
    """
    initial, gen_moves, do_move, primitive = module_api(module)
    table: Dict[object, Tuple[int, int]] = {}
    on_stack = set()
    # Stack frames: (pos, children list or None, next child index, results).
    stack = [[initial, None, 0, []]]
    on_stack.add(initial)
    while stack:
        frame = stack[-1]
        pos, children, idx, results = frame
        if children is None:
            value = normalize_value(primitive(pos))
            if value != UNDECIDED:
                table[pos] = (value, 0)
                on_stack.discard(pos)
                stack.pop()
                continue
            frame[1] = children = [do_move(pos, m) for m in gen_moves(pos)]
        if idx < len(children):
            child = children[idx]
            frame[2] += 1
            if child in table:
                results.append(table[child])
            elif child in on_stack:
                raise ValueError(
                    f"cycle detected at position {child!r}; oracle (like the "
                    "reference) requires acyclic games"
                )
            else:
                stack.append([child, None, 0, []])
                on_stack.add(child)
            continue
        # All children resolved.
        missing = len(children) - len(results)
        if missing:
            # Children solved after we pushed them: collect now.
            results = [table[c] for c in children]
        value, remoteness = combine_host(results)
        if remoteness > MAX_REMOTENESS:
            raise ValueError("remoteness overflow")
        table[pos] = (value, remoteness)
        on_stack.discard(pos)
        stack.pop()
    root_value, root_rem = table[initial]
    return root_value, root_rem, table
