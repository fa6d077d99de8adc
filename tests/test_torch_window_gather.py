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


# -- the CUDA kernel's launch arithmetic (kernels/csrc/window_gather.cu) --


def _emulate_kernel(table, idx, block, window, plan, table_ptr=0):
    """What window_gather.cu computes, CTA by CTA: the run of each CTA from
    run_bounds, the miss count against each element's reference block
    (the pad replicas added once, by the last CTA), and the values read
    from the staged span where it holds them, else from the table.
    Returns (out, nmiss, times each index was covered)."""
    m, n, tb = table.shape[0], idx.shape[0], table.itemsize
    nwin = port.padded_table_len(m, window) // window

    def base_of(b):
        return min(max(int(idx[b * block]) // window, 0), nwin - 2) * window

    out = np.zeros(n, table.dtype)
    covered = np.zeros(n, np.int64)
    nmiss = 0
    for cta in range(plan.grid):
        start, stop = port.run_bounds(plan, cta)
        pos = np.arange(start, stop)
        covered[start:stop] += 1
        v = idx[start:stop].astype(np.int64)
        bases = np.array([base_of(b) for b in
                          range(start // block, (stop - 1) // block + 1)])
        off = v - bases[pos // block - start // block]
        nmiss += int(((off < 0) | (off >= 2 * window)).sum())
        c = np.clip(v, 0, m - 1)
        lo, ln = port.staged_span(plan, int(idx[start]), int(idx[stop - 1]),
                                  m, table_ptr, tb)
        vals = table[c]
        held = (c >= lo) & (c < lo + ln)
        vals[held] = table[lo:lo + ln][c[held] - lo]
        out[start:stop] = vals
        if cta == plan.grid - 1:
            nblk = -(-n // block)
            last = int(idx[n - 1]) - base_of(nblk - 1)
            if not 0 <= last < 2 * window:
                nmiss += nblk * block - n
    return out, nmiss, covered


@pytest.mark.parametrize("idx_off", [0, 8])
@pytest.mark.parametrize("n", [1, 15, 4095, 4096, 4097, 8191, 8192, 8193,
                               3 * 8192 + 5])
def test_plan_covers_every_index_once(n, idx_off):
    # idx_off 8: an int64 idx view one element in, so every tile is scalar.
    plan = port.gather_plan(n, 1, 256 + idx_off, 512)
    assert plan.run == port.RUN == 2 * port.TILE
    covered = np.zeros(n, np.int64)
    for cta in range(plan.grid):
        start, stop = port.run_bounds(plan, cta)
        assert start < stop and start % port.TILE == 0
        covered[start:stop] += 1
        for t0 in range(start, stop, port.TILE):
            # A vector tile is whole and aligned; the scalar path takes
            # the rest.
            assert port.tile_is_vector(plan, t0) == (
                idx_off == 0 and t0 + port.TILE <= n)
    assert (covered == 1).all()
    assert port.run_bounds(plan, plan.grid)[0] >= n


@pytest.mark.parametrize("idx_bytes", [4, 8])
@pytest.mark.parametrize("table_bytes", [1, 2, 4])
def test_vector_tile_lane_mapping(idx_bytes, table_bytes):
    """A vector tile's loads (16-byte index vectors, coalesced over the
    warp) and stores (16 consecutive outputs per lane, rotated) each cover
    the tile once, and the rotated reads of the per-warp buffer put the 8
    lanes of each shared-memory phase on distinct banks."""
    e_per, r = 16 // idx_bytes, table_bytes
    loads = np.zeros(port.TILE, np.int64)
    stores = np.zeros(port.TILE, np.int64)
    for warp in range(port.THREADS // 32):
        w0 = warp * 32 * port.LANE_ELEMS
        for j in range(r):
            banks = []
            for lane in range(32):
                k = (j + lane // (8 // r)) % r
                word = lane * r + k  # 16-byte word of the warp buffer
                first = w0 + word * 16 // table_bytes
                stores[first:first + 16 // table_bytes] += 1
                banks.append(word % 8)  # 8 words of 16 B span the 32 banks
            for phase in range(4):
                assert len(set(banks[8 * phase:8 * phase + 8])) == 8
        for lane in range(32):
            for s in range(port.LANE_ELEMS // e_per):
                first = w0 + (s * 32 + lane) * e_per
                loads[first:first + e_per] += 1
    assert (loads == 1).all() and (stores == 1).all()


@pytest.mark.parametrize("table_bytes", [1, 2, 4])
def test_plan_shared_memory_fits(table_bytes):
    """Span budget plus per-warp buffers: at most 48 KiB, within the
    227 KiB a CTA can have on an H100, and 4 CTAs fit on an SM."""
    plan = port.gather_plan(1 << 20, table_bytes, 0, 0)
    assert plan.smem <= 48 * 1024 and 4 * plan.smem <= 227 * 1024
    assert 0 < plan.budget <= port.SPAN_BUDGET_MAX and plan.budget % 16 == 0
    assert plan.budget >= plan.run * table_bytes  # one entry per index
    assert plan.smem == plan.budget + port.TILE * table_bytes


def test_plan_vector_path_needs_both_pointers_aligned():
    assert port.gather_plan(8192, 1, 256, 512).vector
    assert not port.gather_plan(8192, 1, 256 + 8, 512).vector  # idx view
    assert not port.gather_plan(8192, 1, 256, 512 + 4).vector  # out view


@pytest.mark.parametrize("table_bytes", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4))
def test_staged_span_is_aligned_inside_table_and_budget(seed, table_bytes):
    rng = np.random.default_rng(seed)
    plan = port.gather_plan(1 << 16, table_bytes, 0, 0)
    for _ in range(200):
        m = int(rng.integers(1, 1 << 16))
        first = int(rng.integers(-50, m + 50))
        last = first + int(rng.integers(0, 3 * plan.budget // table_bytes))
        lo, ln = port.staged_span(plan, first, last, m, 0, table_bytes)
        if ln == 0:
            continue
        assert (lo * table_bytes) % 16 == 0
        assert ((lo + ln) * table_bytes) % 16 == 0
        assert 0 <= lo and lo + ln <= m and ln * table_bytes <= plan.budget
        c_first, c_last = min(max(first, 0), m - 1), min(max(last, 0), m - 1)
        assert lo <= c_first
        end16 = m * table_bytes // 16 * 16 // table_bytes
        if (c_last - lo + 1) * table_bytes <= plan.budget and c_last < end16:
            assert c_last < lo + ln  # the whole run's span is held
    # Nothing staged for a table off 16-byte alignment, or a run whose
    # ends are out of order.
    assert port.staged_span(plan, 0, 100, 1000, 4, table_bytes) == (0, 0)
    assert port.staged_span(plan, 100, 0, 1000, 0, table_bytes) == (0, 0)


@pytest.mark.parametrize("tdtype", [np.uint8, np.uint32])
@pytest.mark.parametrize("block,window", [(2048, 8192), (256, 1024),
                                          (100, 512)])
@pytest.mark.parametrize("kind", ["hits", "misses"])
@pytest.mark.parametrize("n", [1, 2049, 3 * 4096 + 17, 20000])
def test_per_run_miss_accounting_matches_reference(n, kind, block, window,
                                                   tdtype):
    """The kernel's per-run miss count, emulated over its own split,
    equals the reference's (_ok_mask plus the pad replicas); its values
    equal table[clip(idx)]."""
    table, idx = _case(1 << 16, n, n + block, tdtype=tdtype,
                       idtype=np.int64,
                       span=3 if kind == "hits" else None)
    if kind == "misses":
        idx[: max(n // 50, 1)] = -7  # a clamped head, missing its window
    plan = port.gather_plan(n, table.itemsize, 0, 0)
    out, nmiss, covered = _emulate_kernel(table, idx, block, window, plan)
    assert (covered == 1).all()
    np.testing.assert_array_equal(out, table[np.clip(idx, 0,
                                                     table.shape[0] - 1)])
    _, ref_miss = port.monotone_window_gather_ref(
        torch.from_numpy(table), torch.from_numpy(idx), block, window)
    npad = -n % block
    ok = _ok_mask(table, idx, block, window)
    nblk = -(-n // block)
    nwin = port.padded_table_len(table.shape[0], window) // window
    base = min(max(int(idx[(nblk - 1) * block]) // window, 0),
               nwin - 2) * window
    pad_miss = 0 if 0 <= int(idx[-1]) - base < 2 * window else npad
    assert nmiss == int(ref_miss) == int((~ok).sum()) + pad_miss
    if kind == "misses":
        assert nmiss > 0


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
