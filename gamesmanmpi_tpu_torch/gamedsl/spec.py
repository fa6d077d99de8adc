"""GameSpec: the declarative half of the game compiler (port of
gamesmanmpi_tpu/gamedsl/spec.py, stdlib only).

A GameSpec describes a two-player perfect-information game on a
width x height grid in four orthogonal pieces — board topology, a move
family, a win predicate, and symmetry generators — instead of bespoke
kernels (docs/GAMEDSL.md has the schema and a worked example):

    {"gamedsl": 1,
     "name": "gomoku_4x3x3",
     "board": {"width": 4, "height": 3},
     "moves": {"family": "place"},
     "win": {"kind": "k_in_line", "k": 3, "exact": true},
     "symmetry": ["mirror_h", "mirror_v"]}

The port keeps its own copy: it imports nothing of the JAX package, not
even a module of it that is stdlib only. Parsing, the canonical form,
validation and its messages are the reference's line for line, so a
spec's problems and its hash are the same in both packages. The lowering
to a TensorGame lives in gamesmanmpi_tpu_torch.gamedsl.compiler.

Identity: `spec_hash` is the sha256 of the canonical JSON form (all
defaults materialized, keys sorted, aliases resolved). The compiler
folds it into the generated game's `cache_key`, and db/writer.py records
it in the manifest, so `check_db --same-as` fails loudly when a DB was
exported from different rules than the spec now on disk. Both packages
compute the same hash for the same spec.

The linter (the twin of tools/spec_lint.py, its flags, lines and exit
codes)::

    python -m gamesmanmpi_tpu_torch.gamedsl.spec [SPEC.json ...]
                                                 [--errors-only]

lints the named files, or every committed spec under examples/specs/,
one line per finding; exit 0 = no errors (warnings are advisory), 1 =
error findings, 2 = usage error.

Directions are named on the compass; opposite names denote the same
undirected line family and collapse to a canonical representative
(w->e, s->n, sw->ne, nw->se). Vectors are (dcol, drow) with rows
growing north.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

SCHEMA_VERSION = 1

#: canonical direction name -> (dcol, drow)
DIRECTION_VECTORS = {
    "e": (1, 0),
    "n": (0, 1),
    "ne": (1, 1),
    "se": (1, -1),
}

#: compass aliases: the opposite ray is the same undirected line family
DIRECTION_ALIASES = {"w": "e", "s": "n", "sw": "ne", "nw": "se"}

DEFAULT_DIRECTIONS = ("e", "n", "ne", "se")

MOVE_FAMILIES = ("drop", "place")

WIN_KINDS = ("k_in_line",)
#: schema-reserved predicate kinds (documented, not yet compilable)
RESERVED_WIN_KINDS = ("count", "capture")

#: generator name -> (square_only, coord map (r, c, m, n) -> (r', c'))
SYMMETRY_GENERATORS = {
    "mirror_h": (False, lambda r, c, m, n: (r, n - 1 - c)),
    "mirror_v": (False, lambda r, c, m, n: (m - 1 - r, c)),
    "rot180": (False, lambda r, c, m, n: (m - 1 - r, n - 1 - c)),
    "transpose": (True, lambda r, c, m, n: (c, r)),
    "anti_transpose": (True, lambda r, c, m, n: (n - 1 - c, m - 1 - r)),
    "rot90": (True, lambda r, c, m, n: (c, m - 1 - r)),
    "rot270": (True, lambda r, c, m, n: (n - 1 - c, r)),
}

#: the only generator compatible with gravity (drop games): column mirror
DROP_SYMMETRY_GENERATORS = ("mirror_h",)

#: fused value-table backward gate (ops/fused.py `_bwdt`, default
#: GAMESMAN_FUSED_TABLE_BITS): wider states still solve, but lose that path
FUSED_TABLE_BITS = 26


class SpecError(ValueError):
    """A GameSpec document is structurally or semantically invalid."""


def _require(cond: bool, msg: str):
    if not cond:
        raise SpecError(msg)


def canonical_direction(name: str) -> str:
    n = str(name).strip().lower()
    n = DIRECTION_ALIASES.get(n, n)
    _require(
        n in DIRECTION_VECTORS,
        f"unknown direction {name!r} (use {sorted(DIRECTION_VECTORS)} "
        f"or aliases {sorted(DIRECTION_ALIASES)})",
    )
    return n


@dataclasses.dataclass(frozen=True)
class GameSpec:
    """A parsed, canonicalized game description (see module docstring)."""

    name: str
    width: int
    height: int
    family: str = "place"
    k: int = 3
    misere: bool = False
    exact: bool = False
    directions: tuple = DEFAULT_DIRECTIONS
    symmetry: tuple = ()

    # ---------------------------------------------------------- construction

    @staticmethod
    def from_dict(doc: dict) -> "GameSpec":
        """Strict parse of a spec document; SpecError on any problem."""
        _require(isinstance(doc, dict), "spec document must be a JSON object")
        known = {"gamedsl", "name", "board", "moves", "win", "symmetry"}
        extra = sorted(set(doc) - known)
        _require(not extra, f"unknown top-level spec keys: {extra}")
        version = doc.get("gamedsl", SCHEMA_VERSION)
        _require(
            version == SCHEMA_VERSION,
            f"unsupported gamedsl schema version {version!r} "
            f"(this build reads version {SCHEMA_VERSION})",
        )
        name = doc.get("name")
        _require(
            isinstance(name, str) and name.strip() != "",
            "spec needs a non-empty string 'name'",
        )
        name = name.strip()

        board = doc.get("board")
        _require(
            isinstance(board, dict), "spec needs a 'board' object"
        )
        bad = sorted(set(board) - {"width", "height"})
        _require(not bad, f"unknown board keys: {bad}")
        width, height = board.get("width"), board.get("height")
        for label, v in (("width", width), ("height", height)):
            _require(
                isinstance(v, int) and not isinstance(v, bool) and v >= 1,
                f"board.{label} must be an integer >= 1, got {v!r}",
            )

        moves = doc.get("moves", {"family": "place"})
        _require(isinstance(moves, dict), "'moves' must be an object")
        bad = sorted(set(moves) - {"family"})
        _require(not bad, f"unknown moves keys: {bad}")
        family = str(moves.get("family", "place")).strip().lower()
        _require(
            family in MOVE_FAMILIES,
            f"unknown move family {family!r} (supported: {MOVE_FAMILIES})",
        )

        win = doc.get("win")
        _require(isinstance(win, dict), "spec needs a 'win' object")
        bad = sorted(set(win) - {"kind", "k", "misere", "exact", "directions"})
        _require(not bad, f"unknown win keys: {bad}")
        kind = str(win.get("kind", "k_in_line")).strip().lower()
        if kind in RESERVED_WIN_KINDS:
            raise SpecError(
                f"win kind {kind!r} is schema-reserved but not yet "
                f"compilable (supported: {WIN_KINDS})"
            )
        _require(
            kind in WIN_KINDS,
            f"unknown win kind {kind!r} (supported: {WIN_KINDS})",
        )
        k = win.get("k", 3)
        _require(
            isinstance(k, int) and not isinstance(k, bool) and k >= 1,
            f"win.k must be an integer >= 1, got {k!r}",
        )
        misere = win.get("misere", False)
        exact = win.get("exact", False)
        for label, v in (("misere", misere), ("exact", exact)):
            _require(
                isinstance(v, bool), f"win.{label} must be a boolean"
            )
        raw_dirs = win.get("directions", list(DEFAULT_DIRECTIONS))
        _require(
            isinstance(raw_dirs, (list, tuple)) and len(raw_dirs) > 0,
            "win.directions must be a non-empty list of direction names",
        )
        directions = tuple(
            sorted(set(canonical_direction(d) for d in raw_dirs))
        )

        symmetry = doc.get("symmetry", [])
        _require(
            isinstance(symmetry, (list, tuple)),
            "'symmetry' must be a list of generator names",
        )
        gens = []
        for g in symmetry:
            gname = str(g).strip().lower()
            _require(
                gname in SYMMETRY_GENERATORS,
                f"unknown symmetry generator {g!r} "
                f"(supported: {sorted(SYMMETRY_GENERATORS)})",
            )
            gens.append(gname)
        return GameSpec(
            name=name, width=width, height=height, family=family, k=k,
            misere=misere, exact=exact, directions=directions,
            symmetry=tuple(sorted(set(gens))),
        )

    # ------------------------------------------------------------- identity

    def to_doc(self) -> dict:
        """The canonical document: every default materialized, every alias
        resolved. Parsing the result reproduces this spec exactly."""
        return {
            "gamedsl": SCHEMA_VERSION,
            "name": self.name,
            "board": {"width": self.width, "height": self.height},
            "moves": {"family": self.family},
            "win": {
                "kind": "k_in_line",
                "k": self.k,
                "misere": self.misere,
                "exact": self.exact,
                "directions": list(self.directions),
            },
            "symmetry": list(self.symmetry),
        }

    def canonical_json(self) -> str:
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    @property
    def spec_hash(self) -> str:
        """sha256 of the canonical JSON — the rules' identity. Flows into
        the compiled game's cache_key and the DB manifest."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()

    # ------------------------------------------------------------- geometry

    @property
    def cells(self) -> int:
        return self.width * self.height

    @property
    def state_bits(self) -> int:
        """Packed width of the compiled encoding (see compiler docstrings):
        drop = guard-column encoding, place = two bit-planes."""
        if self.family == "drop":
            return (self.height + 1) * self.width
        return 2 * self.cells

    def line_windows(self):
        """All k-windows of the win predicate as ((cells...), (forbid...))
        pairs of (r, c) coordinates, deduplicated.

        `cells` are the k stones of a line; `forbid` are the (on-board)
        extension cells immediately before and after the window — empty
        unless exact=True, where a window only wins if neither extension
        belongs to the mover (the gomoku overline rule).
        """
        m, n = self.height, self.width
        out = set()
        for d in self.directions:
            dc, dr = DIRECTION_VECTORS[d]
            for r in range(m):
                for c in range(n):
                    rr, cc = r + dr * (self.k - 1), c + dc * (self.k - 1)
                    if not (0 <= rr < m and 0 <= cc < n):
                        continue
                    cells = tuple(
                        (r + dr * i, c + dc * i) for i in range(self.k)
                    )
                    forbid = ()
                    if self.exact:
                        forbid = tuple(
                            (fr, fc)
                            for fr, fc in ((r - dr, c - dc),
                                           (r + dr * self.k, c + dc * self.k))
                            if 0 <= fr < m and 0 <= fc < n
                        )
                    out.add((tuple(sorted(cells)), tuple(sorted(forbid))))
        return sorted(out)

    def directions_with_windows(self):
        """The subset of self.directions that admits at least one k-window."""
        m, n = self.height, self.width
        alive = []
        for d in self.directions:
            dc, dr = DIRECTION_VECTORS[d]
            span_c = abs(dc) * (self.k - 1)
            span_r = abs(dr) * (self.k - 1)
            if span_c < n and span_r < m:
                alive.append(d)
        return tuple(alive)

    def symmetry_group(self):
        """Closure of the symmetry generators as cell permutations
        (cell = r * width + c), identity excluded, sorted.

        Matches games/tictactoe.py's `_board_symmetries` convention:
        perm[dst] = src, i.e. applying a perm p to a board reads bit p[dst]
        into position dst.
        """
        m, n = self.height, self.width
        ident = tuple(range(self.cells))
        gens = set()
        for gname in self.symmetry:
            _, f = SYMMETRY_GENERATORS[gname]
            perm = [0] * self.cells
            for r in range(m):
                for c in range(n):
                    sr, sc = f(r, c, m, n)
                    perm[r * n + c] = sr * n + sc
            gens.add(tuple(perm))
        group = {ident} | gens
        while True:
            new = {
                tuple(a[b[i]] for i in range(self.cells))
                for a in group for b in group
            }
            if new <= group:
                break
            group |= new
        return sorted(group - {ident})


def load_spec(path: str) -> GameSpec:
    """Parse a GameSpec JSON file; SpecError on malformed content."""
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise SpecError(f"{path}: not valid JSON: {e}") from e
    return GameSpec.from_dict(doc)


# --------------------------------------------------------------- validation


def _problem(severity: str, code: str, message: str) -> dict:
    return {"severity": severity, "code": code, "message": message}


def spec_problems(spec: GameSpec) -> list:
    """Semantic findings for a parsed spec: list of {severity, code,
    message} dicts, errors first.

    Errors make the spec uncompilable (compile_spec refuses); warnings
    flag legal-but-suspect constructs. Codes are stable (GS1xx) — see
    docs/GAMEDSL.md for the catalogue.
    """
    problems = []
    bits = spec.state_bits
    if bits > 63:
        problems.append(_problem(
            "error", "GS101",
            f"packed state needs {bits} bits (> 63): the board does not "
            f"fit the engine's uint64 encoding — shrink the board",
        ))
    elif bits > FUSED_TABLE_BITS:
        problems.append(_problem(
            "warning", "GS102",
            f"packed state needs {bits} bits (> {FUSED_TABLE_BITS}): "
            f"outside the fused value-table backward's default "
            f"GAMESMAN_FUSED_TABLE_BITS gate — fused solves will take "
            f"the provenance backward instead",
        ))
    if spec.exact and spec.family == "drop":
        problems.append(_problem(
            "error", "GS108",
            "win.exact (the overline rule) is only compilable for the "
            "'place' family — drop games have no exact-k lowering",
        ))
    alive = spec.directions_with_windows()
    if not alive:
        problems.append(_problem(
            "error", "GS103",
            f"win predicate is unreachable: no direction fits a "
            f"{spec.k}-in-a-line window on a "
            f"{spec.width}x{spec.height} board",
        ))
    else:
        for d in sorted(set(spec.directions) - set(alive)):
            problems.append(_problem(
                "warning", "GS104",
                f"direction {d!r} admits no {spec.k}-window on a "
                f"{spec.width}x{spec.height} board (dead direction)",
            ))
    if spec.k == 1:
        problems.append(_problem(
            "warning", "GS109",
            "win.k == 1: the first move always wins — the predicate is "
            "trivial",
        ))

    if spec.family == "drop":
        bad = sorted(set(spec.symmetry) - set(DROP_SYMMETRY_GENERATORS))
        if bad:
            problems.append(_problem(
                "error", "GS105",
                f"symmetry generators {bad} do not commute with gravity: "
                f"drop games support only {list(DROP_SYMMETRY_GENERATORS)}",
            ))
    else:
        bad = sorted(
            g for g in spec.symmetry
            if SYMMETRY_GENERATORS[g][0] and spec.width != spec.height
        )
        if bad:
            problems.append(_problem(
                "error", "GS105",
                f"symmetry generators {bad} need a square board "
                f"(got {spec.width}x{spec.height})",
            ))

    # Closure check: every element of the generated group must map the win
    # predicate's window set onto itself, or canonicalize would merge
    # positions with different values.
    if spec.symmetry and not any(
        p["code"] in ("GS105", "GS103") for p in problems
    ):
        windows = set(spec.line_windows())
        m, n = spec.height, spec.width
        for perm in spec.symmetry_group():
            # perm[dst] = src; the image of src is dst
            image = [0] * spec.cells
            for dst, src in enumerate(perm):
                image[src] = dst
            mapped = set()
            for cells, forbid in windows:
                mapped.add((
                    tuple(sorted(
                        divmod(image[r * n + c], n) for r, c in cells
                    )),
                    tuple(sorted(
                        divmod(image[r * n + c], n) for r, c in forbid
                    )),
                ))
            if mapped != windows:
                problems.append(_problem(
                    "error", "GS106",
                    f"symmetry closure broken: a group element maps the "
                    f"win-line set off itself (directions "
                    f"{list(spec.directions)} are not closed under "
                    f"generators {list(spec.symmetry)}) — canonicalize "
                    f"would merge positions with different values",
                ))
                break
    order = {"error": 0, "warning": 1}
    problems.sort(key=lambda p: (order[p["severity"]], p["code"]))
    return problems


def lint_file(path: str) -> list:
    """spec_problems for a file on disk; parse failures come back as a
    single GS001 error finding instead of an exception (lint-friendly)."""
    try:
        spec = load_spec(path)
    except OSError as e:
        return [_problem("error", "GS001", f"cannot read spec: {e}")]
    except SpecError as e:
        return [_problem("error", "GS001", f"invalid spec: {e}")]
    return spec_problems(spec)


def main(argv=None) -> int:
    """The spec linter's entry point (module docstring)."""
    import argparse
    import glob
    import os
    import sys

    p = argparse.ArgumentParser(
        prog="spec_lint",
        description="Validate declarative GameSpec files "
        "(docs/GAMEDSL.md).",
    )
    p.add_argument("specs", nargs="*",
                   help="GameSpec .json files (default: examples/specs/*)")
    p.add_argument("--errors-only", action="store_true",
                   help="suppress warning-severity findings")
    args = p.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = args.specs or sorted(
        glob.glob(os.path.join(repo, "examples", "specs", "*.json")))
    if not paths:
        print("error: no spec files to lint", file=sys.stderr)
        return 2
    errors = 0
    for path in paths:
        findings = lint_file(path)
        for f in findings:
            if args.errors_only and f["severity"] != "error":
                continue
            print(f"{path}: {f['code']} {f['severity']}: {f['message']}")
            if f["severity"] == "error":
                errors += 1
        if not findings:
            print(f"{path}: OK")
    if errors:
        print(f"{errors} error finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
