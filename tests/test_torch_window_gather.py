"""Torch port's monotone-window gather against the JAX Pallas kernel.

The port's plain version (ops/window_gather.monotone_window_gather_ref,
also what the wrapper takes for a CPU tensor) is held against
gamesmanmpi_tpu.ops.pallas_gather.monotone_window_gather run in Pallas
interpret mode, on the same seeded numpy inputs: every element the TPU
kernel hits is identical, the miss count is equal, and the port is exact
even where the TPU kernel leaves garbage (out == table[clip(idx)]). The
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerance zero throughout: integer gathers.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    from _mini_hypothesis import given, settings, st

from gamesmanmpi_tpu.ops import pallas_gather as jax_gather
from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.ops import window_gather as port


def _case(m, n, seed, span=None, tdtype=np.uint32, idtype=np.int32):
    rng = np.random.default_rng(seed)
    hi = 256 if tdtype == np.uint8 else 1 << 30
    table = rng.integers(0, hi, size=m).astype(tdtype)
    if span is None:
        idx = np.sort(rng.integers(0, m, size=n))
    else:
        # Bounded local span: the index drifts forward like the dense
        # child gathers do (expansion ratio <= 2).
        idx = np.minimum(np.cumsum(rng.integers(0, span, size=n)), m - 1)
    return table, idx.astype(idtype)


def _ok_mask(table, idx, block, window):
    """The reference's hit predicate, recomputed independently."""
    n = idx.shape[0]
    ok = np.zeros(n, bool)
    nwin = max(-(-table.shape[0] // window), 2)
    for b in range(-(-n // block)):
        lo, hi = b * block, min((b + 1) * block, n)
        base = min(max(int(idx[lo]) // window, 0), nwin - 2) * window
        off = idx[lo:hi].astype(np.int64) - base
        ok[lo:hi] = (off >= 0) & (off < 2 * window)
    return ok


def _both(table, idx, block, window):
    jout, jmiss = jax_gather.monotone_window_gather(
        table, idx, block=block, window=window, interpret=True)
    pout, pmiss = port.monotone_window_gather(
        torch.from_numpy(table), torch.from_numpy(idx), block, window)
    return np.asarray(jout), int(jmiss), pout.numpy(), int(pmiss)


def _assert_parity(table, idx, block, window):
    jout, jmiss, pout, pmiss = _both(table, idx, block, window)
    assert pout.dtype == table.dtype
    assert pmiss == jmiss
    # The port is exact everywhere ...
    np.testing.assert_array_equal(
        pout, table[np.clip(idx, 0, table.shape[0] - 1)])
    # ... and equal to the TPU kernel wherever that one hits.
    ok = _ok_mask(table, idx, block, window)
    np.testing.assert_array_equal(pout[ok], jout[ok])
    return pmiss, ok


@pytest.mark.parametrize("tdtype", [np.uint8, np.uint32])
@pytest.mark.parametrize("idtype", [np.int32, np.int64])
def test_hits_exact(tdtype, idtype):
    table, idx = _case(1 << 16, 5000, 0, span=3, tdtype=tdtype,
                       idtype=idtype)
    nmiss, _ = _assert_parity(table, idx, 256, 2048)
    assert nmiss == 0


@pytest.mark.parametrize("tdtype", [np.uint8, np.uint32])
@pytest.mark.parametrize("idtype", [np.int32, np.int64])
def test_wide_jumps_counted_and_still_exact(tdtype, idtype):
    table, idx = _case(1 << 18, 4096, 1, tdtype=tdtype, idtype=idtype)
    nmiss, ok = _assert_parity(table, idx, 256, 1024)
    assert nmiss > 0
    assert nmiss == int((~ok).sum())


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2049, 5000])
def test_ragged_lengths(n):
    table, idx = _case(1 << 14, n, n, span=2)
    nmiss, _ = _assert_parity(table, idx, 256, 2048)
    assert nmiss == 0


def test_tail_replicas_counted_like_reference():
    # A missing LAST element is counted once per pad replica of the last
    # block, exactly as the reference pads idx with idx[-1].
    table = np.arange(1 << 14, dtype=np.uint32)
    idx = np.zeros(300, np.int64)
    idx[-1] = (1 << 14) - 1
    nmiss, _ = _assert_parity(table, idx, 256, 1024)
    assert nmiss == 1 + (-300 % 256)


@settings(max_examples=10, deadline=None)
@given(
    logm=st.integers(10, 15),
    n=st.integers(1, 3000),
    block=st.sampled_from([128, 256, 512]),
    window=st.sampled_from([1024, 2048, 4096]),
    local=st.booleans(),
    seed=st.integers(0, 2**31),
)
def test_property_matches_interpret_kernel(logm, n, block, window, local,
                                           seed):
    table, idx = _case(1 << logm, n, seed, span=3 if local else None,
                       idtype=np.int64)
    _assert_parity(table, idx, block, window)


@pytest.mark.parametrize("m", [1, 100, 8191, 8192, 8193, 1 << 20])
@pytest.mark.parametrize("window", [1024, 8192])
def test_padded_table_len_matches_reference(m, window):
    assert port.padded_table_len(m, window) == jax_gather.padded_table_len(
        m, window)


def test_cells_table_gather_matches_reference():
    rng = np.random.default_rng(5)
    cells = rng.integers(0, 1 << 30, size=1000, dtype=np.uint32)
    idx = rng.integers(-50, 1100, size=(64, 4)).astype(np.int64)
    valid = rng.random((64, 4)) < 0.7
    ref = np.asarray(jax_gather.cells_table_gather(cells, idx, valid))
    got = port.cells_table_gather(torch.from_numpy(cells),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensor_takes_plain_version_without_launch():
    table, idx = _case(1 << 12, 700, 2, span=3, tdtype=np.uint8)
    kernels.reset_launches()
    out, nmiss = port.monotone_window_gather(torch.from_numpy(table),
                                             torch.from_numpy(idx))
    ref, nref = port.monotone_window_gather_ref(torch.from_numpy(table),
                                                torch.from_numpy(idx))
    assert kernels.LAUNCHES["monotone_window_gather"] == 0
    assert torch.equal(out, ref) and int(nmiss) == int(nref)


def test_rejects_what_the_kernel_does_not_take():
    t = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(TypeError):
        port.monotone_window_gather(t, torch.zeros(4, dtype=torch.int16))
    with pytest.raises(TypeError):
        port.monotone_window_gather(torch.zeros(16, dtype=torch.int64),
                                    torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        port.monotone_window_gather(t, torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        port.monotone_window_gather(t, torch.zeros(4, dtype=torch.int64),
                                    block=0)
    with pytest.raises(RuntimeError):
        port.monotone_window_gather(t.to("meta"),
                                    torch.zeros(4, dtype=torch.int64,
                                                device="meta"))
