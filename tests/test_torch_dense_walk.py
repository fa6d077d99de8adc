"""The level kernels' walk and launch map, on the CPU.

The CUDA kernels of ops/dense_level.py (kernels/csrc/dense_level.cu) rank
every child and parent of a lane in one descending walk over the level's
class indices, and take each level in one launch whose CTAs cover every
2,048-lane run of every rank block. What is held here, with no card and
no nvcc:

* ``fused_walk``, the numpy model of that walk, on every lane of every
  level of Connect-4 3x4 and 4x4 in 32- and 64-bit rank words: the
  player-1 stones equal ``DenseTables.unrank_np``, each child's rank
  ``DenseTables.rank_np`` and the JAX reference's
  ``_rank_all_moves_fused``, and each parent's rank (the reach step's)
  ``rank_np`` of the position with the top stone removed;
* the launch map: each run of each block covered once, lanes past C
  never written, a mesh's slices covering every block, one launch per
  level and shard, each shard's compact output merged into the level;
* the CUDA source itself, compiled with g++ under a header that emulates
  a CTA's threads as coroutines meeting at each barrier (one core),
  against the plain versions on every
  level of 3x4, 4x4 and (for the kernel's other fixed column heights)
  3x5 and 2x6.

Integers throughout: tolerance zero.
"""

import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu_torch.games import get_game
from gamesmanmpi_tpu_torch.ops import dense_level
from gamesmanmpi_tpu_torch.solve import dense

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

BOARDS = [(3, 4), (4, 4)]
CU = (pathlib.Path(dense_level.__file__).resolve().parents[1] / "kernels"
      / "csrc" / "dense_level.cu")
WORDS = (np.uint32, np.uint64)


def _lanes(t, L):
    """Every lane of level L: (rows, ranks) of the [P, C] array."""
    P, C = len(t.profiles[L]), t.class_size[L]
    return np.repeat(np.arange(P), C), np.tile(np.arange(C), P)


def _walk(t, L, word):
    rows, ranks = _lanes(t, L)
    g = dense_level.level_geom(t, L)
    return rows, ranks, dense_level.fused_walk(g, t.profiles[L][rows],
                                               ranks, word)


# ------------------------------------------------------------ the walk


@pytest.mark.parametrize("board", BOARDS)
def test_fused_walk_matches_rank_and_unrank(board):
    """Every lane of every level, both rank words: the walk's stones are
    unrank_np's, every valid move's child rank is rank_np of the child,
    and every column whose top stone is the last mover's has the parent
    rank rank_np gives with that stone removed."""
    w, h = board
    t = dense.tables_for(w, h, 4)
    lanes = 0
    for L in range(t.ncells + 1):
        rows, ranks, walk = _walk(t, L, np.uint32)
        _, _, wide = _walk(t, L, np.uint64)
        for a, b in zip(walk, wide):  # the same numbers in both words
            np.testing.assert_array_equal(a.astype(np.uint64),
                                          b.astype(np.uint64), err_msg=L)
        c = t.level_consts(L)
        prof = t.profiles[L]
        p1_moves, mover_is_p1 = L % 2 == 0, L % 2 == 1
        for i, (row, rank) in enumerate(zip(rows, ranks)):
            bits = t.unrank_np(L, row, rank)
            assert int(walk.p1[i]) == bits, (L, row, rank)
            for col in range(w):
                if L < t.ncells and c["valid"][row, col]:
                    child = (bits | int(c["newbit"][row, col]) if p1_moves
                             else bits)
                    assert int(walk.child[i, col]) == t.rank_np(
                        L + 1, int(c["move_row"][row, col]), child), (
                        L, row, rank, col)
                if prof[row, col] == 0:
                    continue
                ts = int(c["topstone"][row, col])
                assert bool(walk.top_p1[i, col]) == bool(bits & ts)
                if bool(bits & ts) == mover_is_p1:
                    parent = bits ^ ts if mover_is_p1 else bits
                    assert int(walk.parent[i, col]) == t.rank_np(
                        L - 1, int(c["parent_row"][row, col]), parent), (
                        L, row, rank, col)
        lanes += rows.size
    assert lanes == sum(len(t.profiles[L]) * t.class_size[L]
                        for L in range(t.ncells + 1))


@pytest.mark.parametrize("board", BOARDS)
def test_fused_walk_matches_reference_fused_rank(board):
    """Every lane of every level below the top: the walk's child ranks
    equal the JAX reference's _rank_all_moves_fused (its ascending
    one-walk ranking) on every valid move, in both rank words."""
    import jax.numpy as jnp
    from gamesmanmpi_tpu.solve import dense as jax_dense

    w, h = board
    t = dense.tables_for(w, h, 4)
    ref = jax_dense.DenseTables(w, h, 4)
    for word, jword in zip(WORDS, (jnp.uint32, jnp.uint64)):
        for L in range(t.ncells):
            rows, _, walk = _walk(t, L, word)
            P, C = len(t.profiles[L]), t.class_size[L]
            c = ref.level_consts(L)

            def steps_first(a):
                return jnp.asarray(np.moveaxis(a.astype(np.int32), -1, 0))

            got = jax_dense._rank_all_moves_fused(
                jnp.asarray(walk.p1.astype(ref.bits_dtype).reshape(P, C)),
                jnp.asarray(ref.binom.astype(word)),
                steps_first(c["cellidx"]), steps_first(c["snapk"]),
                [int(b) for b in ref.bitpos], jword, False, L % 2 == 0, w,
                h)
            want = np.moveaxis(np.asarray(got), 0, -1).reshape(-1, w)
            valid = c["valid"][rows]
            np.testing.assert_array_equal(np.where(valid, walk.child, 0),
                                          np.where(valid, want, 0),
                                          err_msg=f"{word.__name__} {L}")


# ------------------------------------------------------ the launch map


@pytest.mark.parametrize("P,C,cblock,nblk", [
    (1, 1, 1, 1),           # level 0
    (3, 5000, 4096, 2),     # row-aligned runs, a ragged last block
    (7, 700, 700, 1),       # runs spanning rows
    (40, 3000, 1000, 3),    # spanning runs, several blocks
    (5, 2048, 2048, 1),     # exact
])
def test_launch_map_covers_each_run_once(P, C, cblock, nblk):
    """The CTAs of one launch take each block's row-major [P, width] lanes
    in runs of RUN, each run once, as the window gather's miss partition
    splits them; together they cover [P, nblk*cblock] once, so every
    in-range lane is written once and no lane past C is."""
    lmap = dense_level.LaunchMap(P, C, cblock, nblk)
    seen = np.zeros((P, nblk * cblock), np.int64)
    for b in range(nblk):
        qs = []
        for j in range(lmap.runs):
            rows, ranks, pad = lmap.cta_lanes(b * lmap.runs + j)
            assert 0 < rows.size <= dense_level.RUN
            np.add.at(seen, (rows, ranks), 1)
            qs.append((rows, ranks))
            # Only the block's last lane counts the ragged run's padding.
            last = j == lmap.runs - 1
            assert pad[:-1].sum() == 0 and pad[-1] == (
                lmap.runs * dense_level.RUN - lmap.nlanes if last else 0)
        rows = np.concatenate([r for r, _ in qs])
        ranks = np.concatenate([k for _, k in qs])
        # The miss partition's order: the block's [P, width] row-major.
        np.testing.assert_array_equal(rows, np.repeat(np.arange(P), cblock))
        np.testing.assert_array_equal(
            ranks, np.tile(b * cblock + np.arange(cblock), P))
    assert (seen == 1).all()
    assert lmap.columns().sum() == C and lmap.grid == nblk * lmap.runs


@pytest.mark.parametrize("devices,window", [(2, True), (3, True),
                                            (4, False)])
def test_mesh_launch_maps_cover_every_block(devices, window):
    """A mesh's launches at every level: each shard's map is its slice of
    every block, and the shards together take every lane of every block
    once, so the level's [P, C] array is written once."""
    s = dense.DenseSolver(get_game("connect4:w=5,h=3"), device="cpu",
                          block_elems=1 << 12, devices=devices,
                          gather_mode="window" if window else "plain")
    t = s.tables
    for L in range(t.ncells + 1):
        for for_reach in (False, True):
            P, C = len(t.profiles[L]), t.class_size[L]
            cblock, nblk = s._cblock(L)
            maps = s._launch_maps(L, for_reach)
            assert len({i for i, _ in maps}) == len(maps) <= devices
            seen = np.zeros((P, nblk * cblock), np.int64)
            for _, lmap in maps:
                assert (lmap.cblock, lmap.nblk) == (cblock, nblk)
                for cta in range(lmap.grid):
                    rows, ranks, _ = lmap.cta_lanes(cta)
                    np.add.at(seen, (rows, ranks), 1)
                if window and not for_reach and cblock >= dense.WINDOW_BLOCK:
                    assert lmap.lo % dense.WINDOW_BLOCK == 0
                    assert lmap.width % dense.WINDOW_BLOCK == 0
            assert (seen == 1).all(), (L, for_reach)


@pytest.mark.parametrize("devices", [1, 3])
def test_one_step_per_level_and_shard(devices, monkeypatch):
    """The solve calls each level wrapper once per level and shard (one
    kernel launch each on the card): the backward at every level, the
    reach sweep at every level but 0; the plain modes call none."""
    calls = {"dense_step": 0, "reach_step": 0}

    def counted(name):
        inner = getattr(dense_level, name)

        def step(*args):
            calls[name] += 1
            return inner(*args)
        return step

    for name in calls:
        monkeypatch.setattr(dense_level, name, counted(name))
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    s = dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu",
                          block_elems=1 << 12, devices=devices)
    r = s.solve()
    nc = s.tables.ncells
    assert r.num_positions == 161029
    assert calls["dense_step"] == sum(len(s._launch_maps(L, False))
                                      for L in range(nc + 1))
    assert calls["reach_step"] == sum(len(s._launch_maps(L, True))
                                      for L in range(1, nc + 1))
    if devices == 1:
        assert calls == {"dense_step": nc + 1, "reach_step": nc}
    calls.update(dense_step=0, reach_step=0)
    dense.DenseSolver(get_game("connect4:w=4,h=4"), device="cpu",
                      gather_mode="plain", devices=devices).solve()
    assert calls == {"dense_step": 0, "reach_step": 0}


def test_merge_shard_copies_the_slices_alone():
    """A compact output holds block b's slice at columns b*width on;
    merge_shard puts each in-range lane at its rank and touches no
    other column of the level (ragged last block included)."""
    lmap = dense_level.LaunchMap(3, 5000, 2048, 3, 512, 1536, compact=True)
    assert lmap.out_cols == 3 * 1024
    part = torch.arange(3 * lmap.out_cols, dtype=torch.int64).reshape(
        3, lmap.out_cols)
    out = torch.full((3, 5000), -1, dtype=torch.int64)
    dense_level.merge_shard(lmap, part, out)
    cover = torch.from_numpy(lmap.columns())
    assert (out[:, ~cover] == -1).all()
    for rank in np.flatnonzero(lmap.columns()):
        b, col = divmod(int(rank), lmap.cblock)
        assert torch.equal(out[:, rank],
                           part[:, b * lmap.width + col - lmap.lo])


@pytest.mark.parametrize("devices", [2, 3])
def test_mesh_shards_write_compact_and_merge(devices, monkeypatch):
    """On a mesh each shard's step writes its compact [P, nblk*width]
    array, and only that crosses to the level: every launch of the
    backward and the reach sweep is merged from one shard's compact
    output, and the cells and nmiss per level equal the one-device
    solve's."""
    merged = []
    inner = dense_level.merge_shard

    def spy(lmap, part, out):
        assert lmap.compact and tuple(part.shape) == (lmap.P, lmap.out_cols)
        assert tuple(out.shape) == (lmap.P, lmap.size)
        merged.append(lmap)
        return inner(lmap, part, out)

    monkeypatch.setattr(dense_level, "merge_shard", spy)
    spec = "connect4:w=4,h=4"
    one = dense.DenseSolver(get_game(spec), device="cpu",
                            block_elems=1 << 12).solve()
    assert not merged
    # The mesh's own reach sweep too (no cached counts).
    monkeypatch.setattr(dense, "_REACH_COUNTS", {})
    monkeypatch.setenv("GAMESMAN_DENSE_COUNTS_FILE", "0")
    s = dense.DenseSolver(get_game(spec), device="cpu", block_elems=1 << 12,
                          devices=devices)
    mesh = s.solve()
    nc = s.tables.ncells
    assert len(merged) == sum(len(s._launch_maps(L, False))
                              for L in range(nc + 1)) + sum(
        len(s._launch_maps(L, True)) for L in range(1, nc + 1))
    assert (mesh.stats["gather_nmiss_per_level"]
            == one.stats["gather_nmiss_per_level"])
    for L, cells in one.cells.items():
        np.testing.assert_array_equal(mesh.cells[L], cells, err_msg=L)


def test_kernel_source_walks_class_indices():
    """The kernel reads no cell-index array and divides only 32-bit
    values, once per CTA or (in CTAs that span rows) per lane."""
    src = CU.read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "cellidx" not in code
    # The device code: up to the host's launch functions, constants aside.
    device = "\n".join(line for line in code[:code.index(
        "cudaError_t run(")].splitlines() if "constexpr" not in line)
    divisions = sorted(set(re.findall(r"[\w.()\- ]+ / [\w.]+", device)))
    assert [d.strip() for d in divisions] == [
        "(q1 - 1) / p.width", "blockIdx.x / p.runs", "q / p.width",
        "q0 / p.width"], divisions


# --------------------------------------------- the CUDA source on the CPU


STUB = r"""
// Host emulation of the CUDA built-ins dense_level.cu uses: one CTA at a
// time on the calling thread, its threads as coroutines (ucontext) that
// give way at each barrier, so the emulation runs on one core.
#pragma once
#include <stddef.h>
#include <stdint.h>
#include <ucontext.h>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct emu_dim3 { unsigned x, y, z; };
namespace emu {
inline emu_dim3 thread_idx{0, 0, 0};
inline emu_dim3 block_idx{0, 0, 0};
inline emu_dim3 block_dim{0, 1, 1};
inline unsigned char* dyn = nullptr;
inline ucontext_t host;
inline std::vector<ucontext_t> ctx;
inline std::vector<char> done;
inline const std::function<void()>* body = nullptr;

inline void entry() {
  (*body)();
  done[thread_idx.x] = 1;
}

// The CTAs in order. In each round every thread of the CTA runs to its
// next barrier (or its end); the round is the barrier, so a CTA ends when
// a round leaves no thread running, and the next reuses its static
// shared arrays.
template <typename F>
void launch(unsigned grid, unsigned threads, size_t smem, F f) {
  constexpr size_t kStack = 1 << 18;
  std::vector<unsigned long long> buf(smem / 8 + 2);
  std::unique_ptr<char[]> stacks(new char[threads * kStack]);
  const std::function<void()> fn = f;
  block_dim.x = threads;
  dyn = reinterpret_cast<unsigned char*>(buf.data());
  body = &fn;
  ctx.assign(threads, ucontext_t{});
  for (unsigned b = 0; b < grid; ++b) {
    block_idx.x = b;
    done.assign(threads, 0);
    for (unsigned t = 0; t < threads; ++t) {
      getcontext(&ctx[t]);
      ctx[t].uc_stack.ss_sp = stacks.get() + t * kStack;
      ctx[t].uc_stack.ss_size = kStack;
      ctx[t].uc_link = &host;
      makecontext(&ctx[t], entry, 0);
    }
    for (bool running = true; running;) {
      running = false;
      for (unsigned t = 0; t < threads; ++t) {
        if (done[t]) continue;
        thread_idx.x = t;
        swapcontext(&host, &ctx[t]);
        running |= !done[t];
      }
    }
  }
}
}  // namespace emu

#define threadIdx (emu::thread_idx)
#define blockIdx (emu::block_idx)
#define blockDim (emu::block_dim)
inline void __syncthreads() {
  swapcontext(&emu::ctx[threadIdx.x], &emu::host);
}
template <typename T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""


def _emulated_library(tmp_path):
    """dense_level.cu built by g++ against STUB: the dynamic shared array
    becomes the emulated CTA's buffer and each `<<<...>>>` launch a call
    of emu::launch; nothing else of the source changes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation")
    (tmp_path / "cuda_runtime.h").write_text(STUB)
    src = CU.read_text()
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
        r"unsigned char* \1 = emu::dyn;", src)
    src, n_launch = re.subn(
        r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(([^)]*)\);",
        r"emu::launch(\2, \3, \4, [&] { \1(\6); });", src)
    assert (n_smem, n_launch) == (2, 1)
    cpp, lib = tmp_path / "dense_level_emu.cpp", tmp_path / "emu.so"
    cpp.write_text(src)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-I", str(tmp_path), "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    for fn in ("dense_step_launch", "reach_step_launch"):
        getattr(so, fn).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
        getattr(so, fn).restype = ctypes.c_int
    return so


def test_kernel_source_matches_plain_versions_under_emulation(tmp_path):
    """The CUDA source, built for the CPU, launched as the solver launches
    it on every level of 3x4 connect-3 (the run-time shape; many small
    blocks, so CTAs span rows), 4x4 (one device, and a 3-shard mesh's
    slices), 3x5 and 2x6 (the fixed heights 4, 5 and 6): every cell of
    the level array, nmiss and the reach count equal the plain versions',
    in the board's words and the three 64-bit word sets."""
    so = _emulated_library(tmp_path)
    cases = [("connect4:w=3,h=4,connect=3", 64, 1, words)
             for words in (None, dense_level.Words(64, 32, 32),
                           dense_level.Words(64, 32, 64),
                           dense_level.Words(64, 64, 64))]
    cases += [("connect4:w=4,h=4", 1 << 12, 1, None),
              ("connect4:w=4,h=4", 1 << 14, 3, dense_level.Words(64, 64,
                                                                 64)),
              # The kernel's other fixed column heights, 5 and 6.
              ("connect4:w=3,h=5", 1 << 14, 1, None),
              ("connect4:w=2,h=6", 64, 1, dense_level.Words(64, 32, 64))]
    launched = 0
    solved = {}
    for spec, block, devices, words in cases:
        s = dense.DenseSolver(get_game(spec), device="cpu",
                              block_elems=block, devices=devices)
        if spec not in solved:
            solved[spec] = s.solve()
        t = s.tables
        rng = np.random.default_rng(14)
        for L in range(t.ncells + 1):
            geom = dense_level.level_geom(t, L)
            if words is not None:
                geom = dataclasses.replace(geom, words=words)
            P, C = len(t.profiles[L]), t.class_size[L]
            for for_reach in ((False, True) if L else (False,)):
                if for_reach:
                    m = len(t.profiles[L - 1]) * t.class_size[L - 1]
                    src = torch.from_numpy(
                        rng.integers(0, 2, m).astype(np.uint8))
                elif L < t.ncells:
                    src = torch.from_numpy(solved[spec].cells[L + 1]
                                           .reshape(-1))
                else:
                    src = torch.zeros(1, dtype=torch.uint8)
                pack = torch.from_numpy(dense_level.kernel_pack(
                    t, L, for_reach, geom.words))
                eager = s._level_tensors(L, for_reach)
                for _, lmap in s._launch_maps(L, for_reach):
                    got = torch.full((P, lmap.out_cols), 0xEE,
                                     dtype=torch.uint8)
                    want = got.clone()
                    counter = torch.zeros((), dtype=torch.int64)
                    args = dense_level.launch_args(geom, lmap, src, pack,
                                                   got, counter, for_reach)
                    fn = so.reach_step_launch if for_reach \
                        else so.dense_step_launch
                    assert fn((ctypes.c_longlong * len(args))(*args),
                              len(args), None) == 0
                    if for_reach:
                        n = dense_level.reach_level_ref(
                            geom, lmap, src, eager, s._binom, want)
                    else:
                        n = dense_level.dense_level_ref(
                            geom, lmap, src, eager, s._binom, want)
                    np.testing.assert_array_equal(
                        got.numpy(), want.numpy(),
                        err_msg=f"{spec} L={L} reach={for_reach} "
                                f"{lmap} {words}")
                    if n is not None:
                        assert int(counter) == int(n), (spec, L, for_reach)
                    launched += 1
    assert launched
