"""The port's op-level microbench and its u32 doubling kernel.

`double_u32_ref` (the plain version the wrapper takes for a CPU tensor)
against the reference's Pallas `pallas_double` run in interpret mode:
the function is local to tools/microbench2.py main(), so these tests
repeat its lines. Then the bench itself at a small N on the CPU, and its
refusal to run without a card unless asked for the CPU. Integers:
tolerance zero.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gamesmanmpi_tpu_torch import kernels
from gamesmanmpi_tpu_torch.bench import microbench2
from gamesmanmpi_tpu_torch.ops.elementwise import double_u32, double_u32_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 8 * 1024 * 128  # tools/microbench2.py's BlockSpec


def pallas_double(x):
    """tools/microbench2.py:207-219, in interpret mode."""

    def k_copy(x_ref, o_ref):
        o_ref[:] = x_ref[:] * jnp.uint32(2)

    return pl.pallas_call(
        k_copy,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0] // BLOCK,),
        in_specs=[pl.BlockSpec((BLOCK,), lambda i: (i,))],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        interpret=True,
    )(x)


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32)).view(torch.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def test_plain_version_matches_pallas_double():
    rng = np.random.default_rng(0)
    x = rng.integers(1 << 31, 1 << 32, size=2 * BLOCK, dtype=np.uint64)
    x = x.astype(np.uint32)
    x[:4] = [1 << 31, (1 << 31) + 5, (1 << 32) - 1, 0xDEADBEEF]
    want = np.asarray(pallas_double(jnp.asarray(x)))
    got = double_u32_ref(_u32(x))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n", [0, 1, 3, 1023, 4097])
def test_wrapper_takes_the_plain_version_on_cpu(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 32, size=n + 1, dtype=np.uint64).astype(np.uint32)
    x[-1] = (1 << 32) - 1
    before = dict(kernels.LAUNCHES)
    t = _u32(x)[1:]  # an offset view, as the kernel's scalar path takes
    got = double_u32(t)
    assert kernels.LAUNCHES == before  # no kernel ran
    assert got.shape == t.shape and got.dtype == torch.uint32
    np.testing.assert_array_equal(_np(got), (x[1:].astype(np.uint64) * 2)
                                  .astype(np.uint32))


def test_wrapper_refuses_other_devices_and_dtypes():
    with pytest.raises(RuntimeError, match="no double_u32 kernel"):
        double_u32(torch.empty(4, dtype=torch.uint32, device="meta"))
    with pytest.raises(TypeError, match="uint32"):
        double_u32(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint32"):
        double_u32_ref(torch.zeros(4, dtype=torch.int64))


def test_run_yields_every_section():
    recs = microbench2.run(n=1 << 16, quick=False, device="cpu")
    sections = [r["section"] for r in recs]
    assert sorted(set(sections)) == sorted(
        ["0", "1", "2", "3", "4", "5", "6", "6b", "6c", "7", "7b", "8"])
    for r in recs:
        assert r["best_ms"] >= 0 and r["device"] == "cpu"
        assert set(r) == {"section", "label", "best_ms", "gbps", "carrier",
                          "device"}
    assert any("elementwise 2x [64K]" in r["label"] for r in recs)
    quick = microbench2.run(n=1 << 12, quick=True, device="cpu")
    assert not {"7", "7b"} & {r["section"] for r in quick}


def test_bitonic_merge_sorts():
    rng = np.random.default_rng(3)
    a = torch.sort(torch.from_numpy(rng.integers(0, 99, 512))).values
    b = torch.sort(torch.from_numpy(rng.integers(0, 99, 512))).values
    got = microbench2.bitonic_merge(a, b)
    assert torch.equal(got, torch.sort(torch.cat([a, b])).values)


def test_module_exits_2_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the module would run on it")
    cmd = [sys.executable, "-m", "gamesmanmpi_tpu_torch.bench.microbench2",
           "--quick"]
    env = dict(os.environ, GAMESMAN_MB_N="4096")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 2
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert proc.stdout == ""
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert lines and all(r["device"] == "cpu" for r in lines)
    assert any(r["label"] == "sort u32 [4K]" for r in lines)
