"""GameSpec -> TensorGame lowering (port of
gamesmanmpi_tpu/gamedsl/compiler.py).

`compile_spec` turns a validated GameSpec into a generated TensorGame
whose expand/primitive/canonicalize/level_of are batched torch over the
port's int64 carrier (core/bitops.py), built from topology-derived
bitboard masks instead of hand-derived ones:

* family "drop"  -> the guard-column encoding of games/connect4.py:
  column c occupies bits [c*(h+1), c*(h+1)+h], guard = column msb,
  whole-word masked down-smear decompose. The k-in-line fold's shift
  strides are DERIVED from the spec's adjacency directions — direction
  (dcol, drow) shifts the packed word by dcol*(h+1) + drow — which for
  the full compass {e, n, ne, se} reproduces connect4's hand-coded
  {h+1, 1, h+2, h} exactly.
* family "place" -> the two-plane encoding of games/tictactoe.py:
  X plane bits [0, m*n), O plane [m*n, 2*m*n), cell = r*n + c; the win
  predicate is a fold over topology-enumerated k-window masks, with an
  optional per-window forbid mask implementing the exact-k overline
  rule (win.exact) that the hand-written module cannot express.

Elementwise equality with the reference's compiled games (children,
masks, primitives, levels and canonical forms, state for state) and
byte parity of the solved tables with the hand-written modules are the
correctness contract (tests/test_torch_gamedsl.py).

The carrier. States are int64 below 2^63 (the spec refuses more than 63
state bits, GS101), so torch's arithmetic ``>>`` is a logical shift on
every real state, and every mask is a Python int below 2^63. The port's
padding sentinel is the all-ones 63-bit word, INT64_MAX; neither family
can reach it:

* place: state_bits = 2 * cells is even, so at most 62: every state is
  below 2^62;
* drop: a state uses (h+1)*w <= 63 bits, so only a 63-bit board (7 wide
  and 8 high, or 9 wide and 6 high) has the word at all, and there it
  would be every column full with every stone the mover's; a full board
  holds both players' stones (w*h >= 2 cells), so no reachable state is
  the sentinel.

The compiled game keeps `cache_key`, `spec_hash` and `spec_doc`: the
port has no kernel cache to key, but the hash is the rules' identity
that db/writer.py persists into the manifest (`spec_sha256`,
`game_spec`) and `check_db --same-as` compares.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import popcount
from gamesmanmpi_tpu_torch.core.values import LOSE, TIE, UNDECIDED, WIN
from gamesmanmpi_tpu_torch.games.base import TensorGame
from gamesmanmpi_tpu_torch.gamedsl.spec import (
    DIRECTION_VECTORS,
    GameSpec,
    SpecError,
    load_spec,
    spec_problems,
)


def compile_spec(spec) -> TensorGame:
    """Lower a GameSpec (or a path to one) into a generated TensorGame.

    Refuses (SpecError) when the spec has error-severity problems; the
    message carries every finding so a CLI user sees the whole list.
    """
    if isinstance(spec, str):
        spec = load_spec(spec)
    if not isinstance(spec, GameSpec):
        spec = GameSpec.from_dict(spec)
    errors = [
        p for p in spec_problems(spec) if p["severity"] == "error"
    ]
    if errors:
        raise SpecError(
            f"spec {spec.name!r} is not compilable:\n" + "\n".join(
                f"  {p['code']}: {p['message']}" for p in errors
            )
        )
    cls = _DropGame if spec.family == "drop" else _PlaceGame
    return cls(spec)


def _terminal_values(lined, full, misere: bool):
    """Primitive value from the mover's perspective: a completed line
    loses for the mover (the opponent made it), or wins under misere,
    where completing a line loses for its maker; else a full board ties;
    else UNDECIDED."""
    out = torch.full(lined.shape, UNDECIDED, dtype=torch.uint8,
                     device=lined.device)
    out = out.masked_fill(full, TIE)
    return out.masked_fill(lined, WIN if misere else LOSE)


class _CompiledGame(TensorGame):
    """Shared shell: identity, spec plumbing, and the cache-key contract."""

    uniform_level_jump = True  # both families add exactly one stone per move

    def __init__(self, spec: GameSpec):
        self.spec = spec
        self.name = spec.name
        self.spec_hash = spec.spec_hash
        self.spec_doc = spec.to_doc()
        self.sym = bool(spec.symmetry)
        self.num_levels = spec.cells + 1
        self.max_level_jump = 1
        self.state_bits = spec.state_bits

    @property
    def cache_key(self):
        # The sha256 of the canonical spec is the rules' identity (the
        # reference keys its kernel caches on it); the name alone is not.
        return ("gamedsl", self.name, self.state_bits, self.spec_hash)


class _DropGame(_CompiledGame):
    """Gravity games (connect4 family): guard-column bitboard encoding."""

    def __init__(self, spec: GameSpec):
        super().__init__(spec)
        width, height = spec.width, spec.height
        self.width, self.height = width, height
        self.k = spec.k
        self.max_moves = width
        h1 = height + 1
        self._col_masks = [((1 << h1) - 1) << (c * h1) for c in range(width)]
        self._top_bits = [1 << (c * h1 + height) for c in range(width)]
        self._full_mask = sum(((1 << height) - 1) << (c * h1)
                              for c in range(width))
        self._bottom_mask = sum(1 << (c * h1) for c in range(width))
        # Topology-derived line strides: direction (dcol, drow) moves one
        # step along a line, which in the packed word is a right-shift by
        # dcol*(h+1) + drow (columns are h+1 bits apart, cells 1 bit).
        # Sorted-deduped over the full compass this is {1, h, h+1, h+2} —
        # connect4's hand-coded set.
        self._dirs = tuple(sorted({
            DIRECTION_VECTORS[d][0] * h1 + DIRECTION_VECTORS[d][1]
            for d in spec.directions_with_windows()
        }))
        # Masks of the masked whole-word down-smear (games/connect4.py
        # derives them): shifting right by i moves a column's bottom bits
        # into the column below, always to in-column offset >= h1-i, while
        # every legitimate smear stays below h1-i. Height 1 runs no smear
        # step but still needs the i=1 mask for the guards.
        self._smear_keep = {}
        i = 1
        while i <= max(height, 1):
            self._smear_keep[i] = sum(((1 << (h1 - i)) - 1) << (c * h1)
                                      for c in range(width))
            i <<= 1

    def initial_state(self) -> int:
        return self._bottom_mask

    def _mirror(self, states):
        h1 = self.height + 1
        out = torch.zeros_like(states)
        for c in range(self.width):
            col = (states >> (c * h1)) & self._col_masks[0]
            out = out | (col << ((self.width - 1 - c) * h1))
        return out

    def canonicalize(self, states):
        if not self.sym:
            return states
        return torch.minimum(states, self._mirror(states))

    def _decompose(self, states):
        """-> (guards, filled, current, opponent) int64 bitboards."""
        smear = states
        i = 1
        while i <= self.height:
            smear = smear | ((smear >> i) & self._smear_keep[i])
            i <<= 1
        guards = smear ^ ((smear >> 1) & self._smear_keep[1])
        filled = smear ^ guards
        current = states ^ guards
        opponent = filled ^ current
        return guards, filled, current, opponent

    def expand(self, states):
        guards, _, _, opponent = self._decompose(states)
        children = []
        masks = []
        for c in range(self.width):
            g = guards & self._col_masks[c]
            children.append(opponent | (guards + g))
            masks.append((guards & self._top_bits[c]) == 0)
        return torch.stack(children, dim=-1), torch.stack(masks, dim=-1)

    def _connected(self, stones):
        won = torch.zeros(stones.shape, dtype=torch.bool,
                          device=stones.device)
        for d in self._dirs:
            x = stones
            for i in range(1, self.k):
                x = x & (stones >> (d * i))
            won = won | (x != 0)
        return won

    def primitive(self, states):
        _, filled, _, opponent = self._decompose(states)
        return _terminal_values(self._connected(opponent),
                                filled == self._full_mask, self.spec.misere)

    def level_of(self, states):
        _, filled, _, _ = self._decompose(states)
        return popcount(filled)

    def describe(self, state) -> str:
        s = int(state)
        h1 = self.height + 1
        cols = [(s >> (c * h1)) & ((1 << h1) - 1) for c in range(self.width)]
        heights = [cv.bit_length() - 1 for cv in cols]
        total = sum(heights)
        cur_char, opp_char = ("X", "O") if total % 2 == 0 else ("O", "X")
        rows = []
        for r in range(self.height - 1, -1, -1):
            row = ""
            for c in range(self.width):
                if r >= heights[c]:
                    row += "."
                elif (cols[c] >> r) & 1:
                    row += cur_char
                else:
                    row += opp_char
            rows.append(row)
        return "\n".join(rows)


class _PlaceGame(_CompiledGame):
    """Free-placement games (m,n,k family): two-bit-plane encoding."""

    def __init__(self, spec: GameSpec):
        super().__init__(spec)
        self.m, self.n = spec.height, spec.width
        self.cells = spec.cells
        self.k = spec.k
        self.max_moves = self.cells
        lines = []
        for cells, forbid in spec.line_windows():
            win_mask = 0
            for r, c in cells:
                win_mask |= 1 << (r * self.n + c)
            forbid_mask = 0
            for r, c in forbid:
                forbid_mask |= 1 << (r * self.n + c)
            lines.append((win_mask, forbid_mask))
        lines = sorted(set(lines))
        self._lines = [w for w, _ in lines]
        self._forbids = [f for _, f in lines]
        self._has_forbids = bool(spec.exact)
        self._plane_mask = (1 << self.cells) - 1
        # Each group element (perm[dst] = src over cells) moves every bit
        # a fixed distance dst - src on both planes: one masked shift per
        # distinct distance, the same image as the reference's per-cell
        # moves.
        self._sym_shifts = []
        if self.sym:
            for perm in spec.symmetry_group():
                by_shift: dict = {}
                for dst, src in enumerate(perm):
                    bits = (1 << src) | (1 << (self.cells + src))
                    by_shift[dst - src] = by_shift.get(dst - src, 0) | bits
                self._sym_shifts.append(sorted(by_shift.items()))

    def initial_state(self) -> int:
        return 0

    def canonicalize(self, states):
        """Min over the spec's symmetry group applied to both planes."""
        if not self.sym:
            return states
        best = states
        for shifts in self._sym_shifts:
            out = torch.zeros_like(states)
            for d, mask in shifts:
                part = states & mask
                out = out | (part << d if d >= 0 else part >> -d)
            best = torch.minimum(best, out)
        return best

    def _planes(self, states):
        return (states & self._plane_mask,
                (states >> self.cells) & self._plane_mask)

    def _x_to_move(self, x, o):
        return popcount(x) == popcount(o)

    def expand(self, states):
        x, o = self._planes(states)
        occupied = (x | o).unsqueeze(-1)
        bits = 1 << torch.arange(self.cells, dtype=torch.int64,
                                 device=states.device)
        # The mover's stone lands at cell i on their own plane.
        shift = torch.where(self._x_to_move(x, o), 0,
                            self.cells).to(torch.int64).unsqueeze(-1)
        children = states.unsqueeze(-1) | (bits << shift)
        return children, (occupied & bits) == 0

    def _lined(self, stones):
        dev = stones.device
        lines = torch.tensor(self._lines, dtype=torch.int64, device=dev)
        s = stones.unsqueeze(-1)
        hit = (s & lines) == lines
        if self._has_forbids:
            # exact-k (overline) rule: the window only wins when neither
            # on-board extension cell belongs to the mover.
            forbids = torch.tensor(self._forbids, dtype=torch.int64,
                                   device=dev)
            hit = hit & ((s & forbids) == 0)
        return hit.any(dim=-1)

    def primitive(self, states):
        x, o = self._planes(states)
        # The last mover is the player NOT to move.
        last = torch.where(self._x_to_move(x, o), o, x)
        return _terminal_values(self._lined(last),
                                (x | o) == self._plane_mask,
                                self.spec.misere)

    def level_of(self, states):
        return popcount(states)

    def describe(self, state) -> str:
        s = int(state)
        rows = []
        for r in range(self.m):
            row = ""
            for c in range(self.n):
                i = r * self.n + c
                if (s >> i) & 1:
                    row += "X"
                elif (s >> (self.cells + i)) & 1:
                    row += "O"
                else:
                    row += "."
            rows.append(row)
        return "\n".join(rows)
