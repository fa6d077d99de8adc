"""Solved-table files (port of the ``--table-out`` writer in
gamesmanmpi_tpu/utils/checkpoint.py, ``save_result_npz``).

One plain npz with ``states_LLLL`` (the reference's state dtype) and
``cells_LLLL`` (uint32 packed cells) per level, so a file from the port
and one from the reference hold the same keys, dtypes and arrays. The
write is atomic (tmp + os.replace); an extension-less path gets ``.npz``
appended, as np.savez does; zip-level DEFLATE applies below 64 MB, as in
the reference's default. Checkpoints and the block store are a later
slice.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from gamesmanmpi_tpu_torch.core.bitops import to_reference
from gamesmanmpi_tpu_torch.core.codec import pack_cells_np

_COMPRESS_BELOW = 64 << 20


def save_result_npz(path, result) -> pathlib.Path:
    """Dump a SolveResult's tables as one npz; returns the path written."""
    arrays = {}
    for level, table in sorted(result.levels.items()):
        arrays[f"states_{level:04d}"] = to_reference(table.states, result.game)
        arrays[f"cells_{level:04d}"] = pack_cells_np(table.values,
                                                     table.remoteness)
    path = pathlib.Path(path)
    if path.suffix != ".npz":  # np.savez's contract for such paths
        path = path.with_name(path.name + ".npz")
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    total = sum(a.nbytes for a in arrays.values())
    save = np.savez_compressed if total < _COMPRESS_BELOW else np.savez
    try:
        save(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path
