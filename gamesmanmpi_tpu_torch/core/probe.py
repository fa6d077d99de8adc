"""Host-side sorted-table probe (port of gamesmanmpi_tpu/core/probe.py).

The numpy binary search every host query route shares; the port's
checkpoint point queries (utils/checkpoint.py) probe through it.
"""

from __future__ import annotations

import numpy as np


def probe_sorted_np(keys: np.ndarray, queries: np.ndarray):
    """Vectorized binary search of queries in one sorted level.

    keys: [N] sorted strictly ascending, no sentinel entries. queries: [K]
    of the same dtype. Returns (idx [K] int64 clipped in range, hit [K]
    bool).
    """
    queries = np.asarray(queries)
    n = int(np.asarray(keys).shape[0])
    if n == 0:
        shape = queries.shape
        return np.zeros(shape, dtype=np.int64), np.zeros(shape, dtype=bool)
    idx = np.minimum(np.searchsorted(keys, queries), n - 1).astype(np.int64)
    hit = np.asarray(keys[idx]) == queries
    return idx, hit
