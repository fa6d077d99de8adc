"""Solved-level lookup (port of gamesmanmpi_tpu/ops/lookup.py).

Solved levels are sorted int64 state arrays with parallel values and
remoteness; a frontier's child queries become one ``torch.searchsorted``
per level of the lookup window. Torch has no searchsorted for uint32 or
uint64, which is one reason the port carries states in int64.

The reference's TPU choices (a sort-merge join instead of a binary
search, one fused u64 payload gather) answer the TPU's costs and are not
carried over: the binary search, then a gather of the state, the value
and the remoteness at the found index, is what the port runs.
"""

from __future__ import annotations

import torch

from gamesmanmpi_tpu_torch.core.bitops import SENTINEL
from gamesmanmpi_tpu_torch.core.values import UNDECIDED


def lookup_sorted(keys, table_states, table_values, table_remoteness):
    """Look keys up in one sorted solved level.

    keys: [...] int64 (SENTINEL entries allowed; they miss).
    table_states: [N] int64 sorted ascending (a SENTINEL tail allowed).
    Returns (values uint8, UNDECIDED on a miss; remoteness int32, 0 on a
    miss; hit bool), each shaped like keys.
    """
    n = table_states.numel()
    if n == 0:
        return (torch.full(keys.shape, UNDECIDED, dtype=torch.uint8,
                           device=keys.device),
                torch.zeros(keys.shape, dtype=torch.int32, device=keys.device),
                torch.zeros(keys.shape, dtype=torch.bool, device=keys.device))
    idx = torch.searchsorted(table_states, keys.reshape(-1)).clamp_(max=n - 1)
    idx = idx.reshape(keys.shape)
    hit = (table_states[idx] == keys) & (keys != SENTINEL)
    values = torch.where(hit, table_values[idx].to(torch.uint8), UNDECIDED)
    remoteness = torch.where(hit, table_remoteness[idx].to(torch.int32), 0)
    return values, remoteness, hit


def lookup_window(keys, window):
    """Look keys up across a window of solved levels.

    window: sequence of (states, values, remoteness) triples (each as in
    lookup_sorted). Each key hits at most one level (a state's level is a
    function of the state). Returns (values, remoteness, hit).
    """
    values = torch.full(keys.shape, UNDECIDED, dtype=torch.uint8,
                        device=keys.device)
    remoteness = torch.zeros(keys.shape, dtype=torch.int32,
                             device=keys.device)
    hit = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for ts, tv, tr in window:
        v, r, h = lookup_sorted(keys, ts, tv, tr)
        values = torch.where(h, v, values)
        remoteness = torch.where(h, r, remoteness)
        hit = hit | h
    return values, remoteness, hit
