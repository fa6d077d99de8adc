"""The least work a Connect-4 board's strong solve needs, and the H100's
peaks: the yardstick of the roofline metrics.

Frozen here from the count the program keeps beside its level kernels
(gamesmanmpi_tpu_torch/ops/dense_level.py, ``step_work`` and
``fold_ops``), keeping only what the problem needs and nothing of how the
program walks its tables, so any implementation is held to the same
number and no faster one can read above 100%:

- per reachable position: its cell written once (1 operation, 1 byte) and
  one win test (did the last move make a line?);
- per (reachable live position, legal move): the child's cell read and
  combined into the parent's value (4 operations: the load, the value and
  the remoteness taken apart, the running best updated);
- each reachable child's byte read once: every reachable position but the
  empty board is some live position's child.

A win test at its least is, per direction, ``connect`` in a row by
doubling (x &= x >> (s*d) while the run s doubles up to ``connect``) and
one test: 4 * (2 * ceil(log2 connect) + 1) operations (20 at connect 4).

The counts per level come from the plain reference's reachability sweep
(reference.Solution.reachable and .moves).
"""

from __future__ import annotations

#: NVIDIA H100 SXM, the data sheet: FP32 outside the tensor cores, 67
#: TFLOP/s counted as 2 per FMA; one 32-bit integer instruction per lane
#: per clock is half of that: 132 SMs x 128 lanes x 1,980 MHz.
PEAK_INT_OPS = 132 * 128 * 1.98e9
#: HBM3 bandwidth, the data sheet.
PEAK_BYTES = 3.35e12

OPS_PER_POSITION_WRITE = 1
OPS_PER_MOVE = 4


def fold_ops(connect: int) -> int:
    """One win test at its least work (module docstring)."""
    return 4 * (2 * (connect - 1).bit_length() + 1)


def least_work(reachable: dict, moves: dict, connect: int
               ) -> tuple[int, int]:
    """(integer operations, bytes) of one strong solve of a board whose
    levels hold reachable[L] positions and moves[L] (live position, legal
    move) pairs."""
    positions = sum(reachable.values())
    pairs = sum(moves.values())
    ops = (positions * (OPS_PER_POSITION_WRITE + fold_ops(connect))
           + pairs * OPS_PER_MOVE)
    nbytes = positions + (positions - reachable.get(0, 0))
    return ops, nbytes


def roofline(ops: int, nbytes: int, device_s: float) -> tuple[float, str]:
    """(share of the roofline in %, the bound that binds: 'ops' or
    'bytes') of work done in device_s seconds of device time."""
    t_ops, t_bytes = ops / PEAK_INT_OPS, nbytes / PEAK_BYTES
    bound = "ops" if t_ops >= t_bytes else "bytes"
    return 100.0 * max(t_ops, t_bytes) / device_s, bound
