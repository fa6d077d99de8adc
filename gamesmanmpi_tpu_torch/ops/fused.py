"""The backward's pipeline mode (port of gamesmanmpi_tpu/ops/fused.py
``pipeline_mode``).

This module holds only :func:`pipeline_mode`. The rest of the
reference's ``fused.py`` (the fused megakernels behind
``GAMESMAN_FUSED*`` and their ``callback``/``scatterinv`` lowerings)
chooses XLA lowerings and bounds compiled shapes; eager torch has
neither, so it stays unported by design (ROADMAP, Queue 1 "Not ported,
by design").
"""

from __future__ import annotations

from gamesmanmpi_tpu_torch.utils.env import env_str


def pipeline_mode() -> str:
    """GAMESMAN_PIPELINE: 'level' (default: each backward level's host
    work runs before the next level is enqueued) or 'pingpong' (level N's
    downloads, export and checkpoint seal run after level N-1's resolve
    is enqueued, overlapping them with the device; the deferred seconds
    are reported as stats ``overlap_secs``). Anything else raises
    ValueError."""
    v = env_str("GAMESMAN_PIPELINE", "level")
    if v not in ("level", "pingpong"):
        raise ValueError(
            f"GAMESMAN_PIPELINE={v!r}: expected 'level' or 'pingpong'")
    return v
