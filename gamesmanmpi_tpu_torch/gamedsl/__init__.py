"""gamedsl: declarative game descriptions compiled to torch games (port
of gamesmanmpi_tpu/gamedsl/).

Split in two so static tooling stays light:

* gamedsl.spec — stdlib only: GameSpec parsing, canonical hashing,
  validation (spec_problems / lint_file).
* gamedsl.compiler — the lowering to the port's int64-carrier
  TensorGames (compile_spec -> TensorGame), which imports torch.

Every name is re-exported lazily: importing gamedsl does not pull torch
until a spec is actually compiled, and `python -m
gamesmanmpi_tpu_torch.gamedsl.spec` (the spec linter) runs its module
once, as __main__.
"""

_SPEC_NAMES = ("GameSpec", "SpecError", "lint_file", "load_spec",
               "spec_problems")

__all__ = [
    "GameSpec",
    "SpecError",
    "compile_spec",
    "lint_file",
    "load_spec",
    "spec_problems",
]


def __getattr__(name):
    if name == "compile_spec":
        from gamesmanmpi_tpu_torch.gamedsl.compiler import compile_spec
        return compile_spec
    if name in _SPEC_NAMES:
        from gamesmanmpi_tpu_torch.gamedsl import spec
        return getattr(spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
