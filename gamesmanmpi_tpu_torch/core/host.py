"""The numpy half of core/: what host-side code needs without torch.

The reference's state dtypes and all-ones sentinels (re-exported by
core/bitops.py) and the cell codec's numpy twins (re-exported by
core/codec.py). The DB's format helpers and integrity checker
(db/format.py, db/check.py) import this module and nothing that pulls
in torch, so validating a database stays a numpy-only job.
"""

from __future__ import annotations

import numpy as np

from gamesmanmpi_tpu_torch.core.values import MAX_REMOTENESS

#: The reference's sentinels, all ones in its unsigned state dtypes.
SENTINEL64 = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
SENTINEL32 = np.uint32(0xFFFF_FFFF)

#: The cell layout: the value in the low 2 bits, the remoteness above.
VALUE_BITS = 2
VALUE_MASK = (1 << VALUE_BITS) - 1


def sentinel_for(dtype) -> np.number:
    """The reference's all-ones sentinel of a state dtype (uint32/uint64)."""
    dtype = np.dtype(dtype)
    if dtype == np.uint64:
        return SENTINEL64
    if dtype == np.uint32:
        return SENTINEL32
    raise TypeError(f"unsupported state dtype {dtype}")


def state_dtype_for(bits: int):
    """The reference's state dtype for a game of `bits` state bits."""
    if bits <= 31:
        return np.uint32
    if bits <= 63:
        return np.uint64
    raise ValueError(f"state does not fit 63 bits: {bits}")


def pack_cells_np(values, remoteness) -> np.ndarray:
    """NumPy twin of core/codec.pack_cells for host-side code."""
    v = np.asarray(values).astype(np.uint32) & VALUE_MASK
    r = np.clip(remoteness, 0, MAX_REMOTENESS).astype(np.uint32)
    return v | (r << np.uint32(VALUE_BITS))


def unpack_cells_np(cells):
    """NumPy twin of core/codec.unpack_cells."""
    cells = np.asarray(cells)
    return ((cells & VALUE_MASK).astype(np.uint8),
            (cells >> VALUE_BITS).astype(np.int32))
