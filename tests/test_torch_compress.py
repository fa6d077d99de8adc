"""Torch port's compress/ and store/ against the JAX package.

Every codec, block frame and block-framed checkpoint npz of the port is
byte for byte the reference's on the same input, and each package decodes
the other's. The block store's read, prefetch and write-behind contracts
are the reference's (tests/test_store.py); the block cache's LRU is the
reference's (tests/test_compress.py). Seeded numpy inputs; exact.
"""

import threading
import time

import numpy as np
import pytest

from gamesmanmpi_tpu import compress as ref_compress
from gamesmanmpi_tpu.store import sealed as ref_sealed
from gamesmanmpi_tpu.utils import checkpoint as ref_ckpt
from gamesmanmpi_tpu_torch import compress
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.store import (
    BlockStore,
    CorruptSealError,
    TORN_SEAL_ERRORS,
    TieredCache,
    default_store,
    file_crc32,
    file_key,
    loadz,
    read_npz_members,
    verify_crc,
)
from gamesmanmpi_tpu_torch.utils import checkpoint as ckpt


def _sorted_keys(n, hi, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, hi, size=n)).astype(dtype)


def _cells(n, max_rem=40, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 4, n).astype(np.uint32)
    r = rng.integers(0, max_rem + 1, n).astype(np.uint32)
    return (v | (r << np.uint32(2))).astype(np.uint32)


#: name -> array; every codec is tried on every one (a declining codec
#: must decline in both packages).
ARRAYS = {
    "keys_u64_wide": _sorted_keys(5000, 1 << 50, np.uint64),
    "keys_u64_dense": _sorted_keys(5000, 1 << 13, np.uint64),
    "keys_u32": _sorted_keys(5000, 1 << 31, np.uint32),
    "keys_dup_top_bit": np.array([7, 7, 2**63, 2**64 - 1], dtype=np.uint64),
    "cells_rem40": _cells(4097),
    "cells_rem70000": _cells(1001, max_rem=70000),
    "cells_one": _cells(1),
    "int32_ramp": np.arange(1000, dtype=np.int32),
    "u64_junk": np.random.default_rng(3).integers(0, 1 << 63, 512,
                                                   dtype=np.uint64),
    "unsorted_u64": np.array([5, 3, 9], dtype=np.uint64),
    "u8_cells": np.random.default_rng(5).integers(0, 256, 3000)
    .astype(np.uint8),
}


@pytest.mark.parametrize("codec", ["raw", "zlib", "keydelta", "cellpack"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_codec_blobs_match_reference_and_cross_decode(codec, name):
    arr = ARRAYS[name]
    got = compress.get_codec(codec).encode(arr)
    want = ref_compress.get_codec(codec).encode(arr)
    assert got == want
    if got is None:  # declined in both
        return
    for dec in (compress.get_codec(codec), ref_compress.get_codec(codec)):
        out = dec.decode(got, arr.dtype, arr.shape[0])
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)


@pytest.mark.parametrize("cands", ["KEY_CANDIDATES", "CELL_CANDIDATES",
                                   "GENERIC_CANDIDATES"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_encode_best_and_framing_match_reference(cands, name):
    arr = ARRAYS[name]
    mine, theirs = getattr(compress, cands), getattr(ref_compress, cands)
    assert mine == theirs
    assert compress.encode_best(arr, mine) == \
        ref_compress.encode_best(arr, theirs)
    index, blobs = compress.encode_array(arr, 1024, mine)
    rindex, rblobs = ref_compress.encode_array(arr, 1024, theirs)
    assert index == rindex and blobs == rblobs
    stream = b"".join(blobs)
    np.testing.assert_array_equal(compress.decode_array(index, stream), arr)
    np.testing.assert_array_equal(ref_compress.decode_array(index, stream),
                                  arr)
    compress.validate_index(index, stream_bytes=len(stream))


@pytest.mark.parametrize("cands", ["KEY_CANDIDATES", "CELL_CANDIDATES"])
@pytest.mark.parametrize("name", ["keys_u64_wide", "keys_u64_dense",
                                  "keys_u32", "cells_rem40", "u8_cells"])
def test_parallel_block_encode_is_the_references_bytes(cands, name,
                                                       monkeypatch):
    """Arrays of many blocks encode on a thread pool: the same index and
    blobs, in order, as the reference's one-thread loop."""
    from gamesmanmpi_tpu_torch.compress import blocks

    arr = ARRAYS[name]
    monkeypatch.setattr(blocks.os, "cpu_count", lambda: 4)
    assert -(-arr.shape[0] // 128) >= blocks._PARALLEL_MIN_BLOCKS
    index, blobs = compress.encode_array(arr, 128, getattr(compress, cands))
    rindex, rblobs = ref_compress.encode_array(arr, 128,
                                               getattr(ref_compress, cands))
    assert index == rindex and blobs == rblobs


def test_block_crc_catches_corruption_and_index_mismatch():
    cells = _cells(5000)
    index, blobs = compress.encode_array(cells, 512, compress.CELL_CANDIDATES)
    stream = bytearray(b"".join(blobs))
    stream[len(stream) // 2] ^= 0xFF
    with pytest.raises(compress.BlockCorruptError, match="crc32"):
        compress.decode_array(index, bytes(stream))
    with pytest.raises(compress.BlockCorruptError, match="lengths"):
        compress.decode_array(index, b"".join(blobs)[:-3])
    bad = dict(index, crc32=index["crc32"][:-1])
    with pytest.raises(compress.BlockCorruptError, match="parallel"):
        compress.decode_array(bad, b"".join(blobs))
    with pytest.raises(TORN_SEAL_ERRORS):
        compress.decode_array(index, bytes(stream))
    with pytest.raises(compress.BlockCorruptError, match="unknown block"):
        compress.get_codec("lz77")
    # One block decodes alone, ragged tail included.
    keys = ARRAYS["keys_u64_wide"]
    index, blobs = compress.encode_array(keys, 1024, compress.KEY_CANDIDATES)
    offs = compress.index_offsets(index)
    b = compress.num_blocks(index) - 1
    out = compress.decode_block(index, b, b"".join(blobs)[offs[b]:offs[b + 1]])
    np.testing.assert_array_equal(out, keys[b * 1024:])
    assert compress.block_bounds(index, b) == (b * 1024, keys.shape[0])


def test_block_cache_lru_eviction_by_bytes():
    cache = compress.BlockCache(1000)
    a, b, c = (np.zeros(50, np.uint64) for _ in range(3))  # 400 B each
    cache.put("a", a, a.nbytes)
    cache.put("b", b, b.nbytes)
    assert cache.get("a") is a  # refreshes recency: b is now LRU
    cache.put("c", c, c.nbytes)  # 1200 B > 1000: evicts b
    assert cache.get("b") is None
    assert cache.get("a") is a and cache.get("c") is c
    stats = cache.stats()
    assert stats["evictions"] == 1 and stats["blocks"] == 2
    assert stats["bytes"] == 800 and stats["hits"] == 3
    big = np.zeros(500, np.uint64)  # oversized: admitted, evicts the rest
    cache.put("big", big, big.nbytes)
    assert cache.get("big") is big and cache.stats()["blocks"] == 1
    assert cache.contains("big") and len(cache) == 1
    cache.clear()
    assert cache.stats()["bytes"] == 0


def test_block_cache_thread_hammer_accounting():
    cache = compress.BlockCache(1 << 16)
    payload = np.zeros(64, np.uint64)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(500):
                key = int(rng.integers(0, 32))
                if cache.get(key) is None:
                    cache.put(key, payload, payload.nbytes)
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] == 8 * 500
    assert stats["bytes"] <= (1 << 16)


# ------------------------------------------------------- sealed npz files


@pytest.mark.parametrize("mode", ["auto", "0", "1", "blocks"])
def test_savez_members_match_reference_and_cross_load(mode, tmp_path,
                                                      monkeypatch):
    """The same arrays through both packages' _savez in every
    GAMESMAN_CKPT_COMPRESS mode: the stored members (block-framed bytes
    and the __blocks__ index included) are equal, and each package's
    loader reads the other's file back to the input arrays."""
    monkeypatch.setenv("GAMESMAN_CKPT_COMPRESS", mode)
    monkeypatch.setenv("GAMESMAN_DB_BLOCK", "700")
    arrays = {"states": ARRAYS["keys_u32"], "cells": _cells(
        ARRAYS["keys_u32"].shape[0]), "level_0003": ARRAYS["keys_u64_wide"]}
    raw, stored = ckpt._savez(tmp_path / "mine", **arrays)
    rraw, rstored = ref_ckpt._savez(tmp_path / "theirs.npz", **arrays)
    assert raw == rraw == sum(a.nbytes for a in arrays.values())
    assert stored == (tmp_path / "mine.npz").stat().st_size
    with np.load(tmp_path / "mine.npz") as a, \
            np.load(tmp_path / "theirs.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert ("__blocks__" in a.files) == (mode == "blocks")
    for path in (tmp_path / "mine.npz", tmp_path / "theirs.npz"):
        for load in (read_npz_members, ref_sealed.read_npz_members):
            got = load(path, None, crc=file_crc32(path))
            assert sorted(got) == sorted(arrays)
            for k, want in arrays.items():
                assert got[k].dtype == want.dtype, k
                np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert not list(tmp_path.glob("*.tmp*"))


def test_savez_blocks_never_frames_table_files(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_CKPT_COMPRESS", "blocks")
    ckpt._savez(tmp_path / "t.npz", allow_block_framing=False,
                states=ARRAYS["keys_u32"])
    with np.load(tmp_path / "t.npz") as z:
        assert z.files == ["states"]
        np.testing.assert_array_equal(z["states"], ARRAYS["keys_u32"])


def test_verify_crc_and_torn_files(tmp_path):
    path = tmp_path / "level_0001.npz"
    ckpt._savez(path, states=ARRAYS["keys_u32"])
    crc = file_crc32(path)
    assert crc == ref_sealed.file_crc32(path)
    verify_crc(path, crc)
    verify_crc(path, None)  # nothing recorded: loads
    with pytest.raises(CorruptSealError, match="crc32"):
        verify_crc(path, crc ^ 1)
    assert issubclass(CorruptSealError, ValueError)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])  # torn
    with pytest.raises(TORN_SEAL_ERRORS):
        read_npz_members(path, ("states",))
    with pytest.raises(TORN_SEAL_ERRORS):
        read_npz_members(tmp_path / "missing.npz", ("states",))


def test_loadz_reads_block_framed_reference_file(tmp_path, monkeypatch):
    monkeypatch.setenv("GAMESMAN_CKPT_COMPRESS", "blocks")
    cells = _cells(3000)
    ref_ckpt._savez(tmp_path / "r.npz", cells=cells)
    with loadz(tmp_path / "r.npz") as z:
        assert z.files == ["cells"]
        np.testing.assert_array_equal(z["cells"], cells)


# ------------------------------------------------------------ block store


def test_hint_becomes_cache_hit_and_loader_runs_once():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=2)
    calls = []

    def loader():
        calls.append(1)
        return np.arange(100)

    store.hint(("a",), loader)
    deadline = time.monotonic() + 5
    while not store.cache.contains(("a",)) and time.monotonic() < deadline:
        time.sleep(0.005)
    val, hit = store.read_ex(("a",), loader)
    assert hit and len(calls) == 1 and val.shape == (100,)
    assert store.stats()["prefetch_hit_rate"] == 1.0
    store.hint(None, loader)  # an unstat-able key: never hinted
    assert store.stats()["prefetch_issued"] == 1
    store.close()


def test_hinted_but_evicted_degrades_to_sync_read():
    store = BlockStore(cache=TieredCache(256), prefetch_threads=1)
    store.hint(("victim",), lambda: np.full(64, 7, np.int64))  # 512 B > 256
    deadline = time.monotonic() + 5
    while store.stats()["prefetch_issued"] == 0 \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    store.read(("churn",), lambda: np.zeros(64, np.int64))
    val, _ = store.read_ex(("victim",), lambda: np.full(64, 7, np.int64))
    assert (val == 7).all()
    store.close()


def test_background_loader_error_reraises_on_consuming_thread():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=1)

    def torn():
        raise ValueError("crc32 mismatch — torn block")

    store.hint(("bad",), torn)
    with pytest.raises(ValueError, match="torn block"):
        for _ in range(100):
            store.read(("bad",), torn)
    store.close()


def test_concurrent_reads_count_every_read():
    store = BlockStore(cache=TieredCache(1 << 12), prefetch_threads=2)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                k = int(rng.integers(0, 16))
                if rng.random() < 0.3:
                    store.hint(("k", k), lambda k=k: np.full(32, k))
                v = store.read(("k", k), lambda k=k: np.full(32, k))
                assert (v == k).all()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    stats = store.stats()
    assert stats["prefetch_hits"] + stats["prefetch_misses"] == 8 * 300
    store.close()


def test_file_key_invalidates_on_rewrite_and_missing(tmp_path):
    p = tmp_path / "payload.bin"
    p.write_bytes(b"v1" * 100)
    k1 = file_key(p)
    assert k1 is not None
    time.sleep(0.01)
    p.write_bytes(b"v2" * 200)
    assert file_key(p) != k1
    p.unlink()
    assert file_key(p) is None


def test_sync_read_counts_as_io_wait():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0)
    val, hit = store.read_ex(("slow",),
                             lambda: (time.sleep(0.02), np.arange(4))[1])
    assert not hit and (val == np.arange(4)).all()
    assert store.stats()["io_wait_secs"] >= 0.02
    store.close()


def test_hint_is_noop_without_pool_and_after_close():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0)
    store.hint(("a",), lambda: np.arange(4))
    assert store.stats()["prefetch_issued"] == 0
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=1)
    store.close()
    store.hint(("a",), lambda: np.arange(4))
    assert store.stats()["prefetch_issued"] == 0
    val, hit = store.read_ex(("a",), lambda: np.arange(4))
    assert not hit and (val == np.arange(4)).all()


def test_default_store_rebuilds_on_env_change(monkeypatch):
    monkeypatch.setenv("GAMESMAN_STORE_CACHE_MB", "7")
    s1 = default_store()
    assert s1.cache.budget_bytes == 7 << 20
    assert default_store() is s1  # stable while the knobs are stable
    monkeypatch.setenv("GAMESMAN_STORE_CACHE_MB", "9")
    s2 = default_store()
    assert s2 is not s1 and s2.cache.budget_bytes == 9 << 20
    monkeypatch.setenv("GAMESMAN_STORE_PREFETCH_THREADS", "0")
    s3 = default_store()
    assert s3 is not s2 and s3.prefetch_threads == 0
    assert s3.writebehind
    monkeypatch.setenv("GAMESMAN_STORE_WRITEBEHIND", "0")
    s4 = default_store()
    assert s4 is not s3 and (s4.prefetch_threads, s4.writebehind) == (
        0, False)


def test_writebehind_executes_in_order_and_drain_barriers(tmp_path):
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0,
                       writebehind=True)
    order = []

    def job(i):
        def run():
            (tmp_path / f"f{i}").write_bytes(b"x" * 10)
            order.append(i)
            return (10, 10)
        return run

    tickets = [store.write(job(i), path=str(tmp_path / f"f{i}"))
               for i in range(8)]
    store.drain()
    assert order == list(range(8))  # FIFO: payload-before-seal rests on it
    assert all(t.done() and t.result() == (10, 10) for t in tickets)
    assert store.stats()["writebehind_queue_depth"] == 0
    assert store.stats()["writebehind_queue_depth_peak"] >= 1
    assert store.stats()["writebehind_writes"] == 8
    store.close()
    late = store.write(lambda: (1, 1))  # after close: runs inline
    assert late.done() and late.result() == (1, 1)


def test_writebehind_failure_surfaces_at_drain_once():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0,
                       writebehind=True)

    def boom():
        raise OSError("disk full")

    t = store.write(boom, path="doomed")
    with pytest.raises(OSError, match="disk full"):
        store.drain()
    with pytest.raises(OSError, match="disk full"):
        t.result()
    store.drain()  # the error does not poison later seals
    store.close()


@pytest.mark.parametrize("writebehind", [True, False])
def test_writebehind_injected_transient_resolves_ticket(writebehind):
    """An armed transient at store.writebehind behaves like a write
    failure: the ticket resolves with it, and the worker lives on."""
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0,
                       writebehind=writebehind)
    faults.configure("store.writebehind:transient")
    try:
        if writebehind:
            t = store.write(lambda: (1, 1), path="x")
            with pytest.raises(faults.TransientFault):
                store.drain()
            with pytest.raises(faults.TransientFault):
                t.result()
        else:
            with pytest.raises(faults.TransientFault):
                store.write(lambda: (1, 1), path="x")
        t2 = store.write(lambda: (2, 2), path="y")
        store.drain()
        assert t2.result() == (2, 2)
    finally:
        faults.clear()
        store.close()


def test_sync_mode_counts_inline_write_as_io_wait():
    store = BlockStore(cache=TieredCache(1 << 20), prefetch_threads=0,
                       writebehind=False)
    t = store.write(lambda: (time.sleep(0.02), (1, 1))[1], path=None)
    assert t.done() and t.result() == (1, 1)
    assert store.stats()["io_wait_secs"] >= 0.02
    store.close()
