"""Measure the card's integer issue rate, pipe by pipe: the peak behind
the dense level kernels' operations bound
(`bench/kernel_cases.int32_ops_per_sec`).

    python tools/torch_int_rate.py [--iters 4096] [--out FILE]

Builds `tools/int_rate.cu` with the port's nvcc flags into
`build/torch_ext/` and runs its three forms, eight CTAs of 256 threads
on every SM (one wave): funnel shifts alone (SHF, the ALU pipe),
multiply-adds alone (IMAD, the FMA pipe), and the two in turn. For each,
one JSON line: `lanes_per_sm_clock`, the integer steps per SM per clock
of the slowest CTA (clock64), `ops_per_sec` over CUDA-event time, the
same per SM per clock at the card's maximum SM clock, and, where the
toolkit has `cuobjdump`, the SHF and IMAD instructions of each
instantiation's SASS. Then, with cuobjdump, one line per instantiation
of the dense level kernels that a 5x5 board runs (u32 words, columns of
5, both parities): its SASS instructions by the pipe they issue to (the
IMAD forms to the FMA pipe; compares, selects, logic, shifts and
three-input adds to the ALU pipe; VIADD, shared loads and the rest
apart). Then the `nvidia-smi` name/power-limit line. Everything also in
--out.

Needs an NVIDIA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SRC = REPO / "tools" / "int_rate.cu"
FORMS = ((0, "shf"), (1, "imad"), (2, "shf+imad"))
THREADS, CTAS_PER_SM = 256, 8


def _build():
    """The built library and its path (cached by source and flags)."""
    from gamesmanmpi_tpu_torch.kernels import build

    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    so = build.BUILD_DIR / f"int_rate_{h.hexdigest()[:16]}.so"
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(SRC)], check=True, capture_output=True,
                       text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    lib.int_rate_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_void_p]
    lib.int_rate_launch.restype = ctypes.c_int
    lib.int_rate_steps_per_iter.restype = ctypes.c_int
    return lib, so


def _sass_counts(so: pathlib.Path) -> dict:
    """{form: {"SHF": n, "IMAD": n, "instructions": n}} from cuobjdump's
    SASS of each instantiation, or {} without cuobjdump."""
    from gamesmanmpi_tpu_torch.kernels import build

    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"spinILi(\d)E", chunk.split("\n", 1)[0])
        if m is None:
            continue
        form = dict(FORMS)[int(m.group(1))]
        counts[form] = {
            "SHF": len(re.findall(r"\bSHF\b", chunk)),
            "IMAD": len(re.findall(r"\bIMAD\b", chunk)),
            "instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", chunk))}
    return counts


#: SASS opcodes that issue to the ALU pipe.
ALU_OPS = {"ISETP", "SEL", "LEA", "IADD3", "SHF", "LOP3", "MOV", "PLOP3",
           "PRMT", "IMNMX", "FLO", "POPC", "BREV", "IABS"}


def _level_kernel_mix() -> list:
    """The dense level kernels' 5x5 instantiations, SASS opcodes by pipe
    (static counts), or [] without cuobjdump."""
    from gamesmanmpi_tpu_torch.kernels import build

    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return []
    so = build._compile("dense_level")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    lines = []
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(dense_step|reach_step)_kernelIjjjLi5ELb([01])E",
                      chunk.split("\n", 1)[0])
        if m is None:
            continue
        mix = {"fma_imad": 0, "alu": 0, "viadd": 0, "lds": 0, "other": 0}
        for op in re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                chunk):
            key = ("fma_imad" if op == "IMAD" else "alu" if op in ALU_OPS
                   else "viadd" if op == "VIADD" else "lds" if op == "LDS"
                   else "other")
            mix[key] += 1
        lines.append(dict(kernel=m.group(1), words="u32", height=5,
                          parity=int(m.group(2)),
                          instructions=sum(mix.values()), **mix))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int_rate: no CUDA device", file=sys.stderr)
        return 1
    from gamesmanmpi_tpu_torch.bench import kernel_cases as kc

    lib, so = _build()
    sass = _sass_counts(so)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_hz = kc.int32_ops_per_sec() / (sms * kc.INT32_LANES_PER_SM)
    grid = sms * CTAS_PER_SM
    out = torch.empty(grid * THREADS, dtype=torch.int32, device=dev)
    cycles = torch.empty(grid, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = grid * THREADS * args.iters * lib.int_rate_steps_per_iter()
    lines = []
    for mode, form in FORMS:
        def run():
            code = lib.int_rate_launch(mode, out.data_ptr(),
                                       cycles.data_ptr(), grid, THREADS,
                                       args.iters, 0x9E3779B9, 7, stream)
            if code != 0:
                raise RuntimeError(f"int_rate launch failed: CUDA {code}")
        run()
        best_ms, best_cycles = None, None
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run()
            b.record()
            b.synchronize()
            ms, cyc = a.elapsed_time(b), int(cycles.max())
            if best_ms is None or ms < best_ms:
                best_ms, best_cycles = ms, cyc
        ops = steps / (best_ms / 1e3)
        lines.append(dict(
            form=form, steps=steps, ms=best_ms, cycles=best_cycles,
            lanes_per_sm_clock=steps / (sms * best_cycles),
            ops_per_sec=ops,
            lanes_per_sm_clock_at_max_clock=ops / (sms * max_clock_hz),
            sass=sass.get(form), sms=sms, max_sm_clock_hz=max_clock_hz,
            bound_lanes_per_sm_clock=kc.INT32_LANES_PER_SM))
    lines += _level_kernel_mix()
    smi = kc.nvidia_smi_line()
    text = "\n".join(json.dumps(x) for x in lines) + "\n" + smi + "\n"
    sys.stdout.write(text)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
