"""Hand-written CUDA kernels of the torch port and their launch counts.

Each kernel wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel, and nowhere else (not when it takes the plain version
for a CPU tensor), so a run can show that its main path went through the
kernels: reset the counts, drive the path, read them.
"""

from __future__ import annotations

from typing import Dict

#: kernel name -> launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {"monotone_window_gather": 0, "double_u32": 0,
                            "dense_step": 0, "reach_step": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
