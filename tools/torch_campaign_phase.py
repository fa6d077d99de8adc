"""chip_smoke.py's phase 17 (campaigns and the DB registry) alone, with
the set-up it needs, for iterating on that phase in a short call.

    python tools/torch_campaign_phase.py

On the card: builds the kernels, solves Connect-4 5x5 dense (phase 6)
and classic (phase 9), exports the streamed v1 DB (phase 12's first
export), then runs `chip_smoke.campaign_registry_phase` at full width.
Prints the `nvidia-smi` name/power-limit line first, each phase's JSON
line, and the set-up's and the whole run's seconds. Exits non-zero on any
failed check, and 1 without a card.
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_campaign_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gamesmanmpi_tpu_torch.bench.kernel_cases import nvidia_smi_line
    from gamesmanmpi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    print(nvidia_smi_line(), torch.__version__, torch.version.cuda,
          flush=True)
    build.build_all()
    _, dense = cs.dense_5x5_phase()
    classic = cs.classic_5x5_phase(dense)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="campaign_phase_"))
    try:
        cs.export_child([cs.C55, "--out", str(tmp / "v1")],
                        (69763700, "TIE", 25), 26)
        print(f"set-up secs {time.perf_counter() - t0:.3f}", flush=True)
        launches = cs.campaign_registry_phase(classic, dense, tmp,
                                              tmp / "v1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"campaign gather launches {launches}; total secs "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
