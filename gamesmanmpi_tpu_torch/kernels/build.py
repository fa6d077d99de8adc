"""Build and load the port's hand-written CUDA kernels.

Each source under ``kernels/csrc`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``-gencode=arch=compute_90a,code=sm_90a -O3``)
into a shared library under ``build/torch_ext/`` at the repository root
(git-ignored), then loaded with ctypes. Pointers and the stream go in as
Python ints from ``Tensor.data_ptr()`` and
``torch.cuda.current_stream().cuda_stream``.

Why nvcc + ctypes rather than ``torch.utils.cpp_extension.load``: a source
that includes PyTorch's headers takes minutes to compile, a plain CUDA
file seconds, and every fresh checkout builds anew.

The build happens at first use, never at import, and from the repository's
sources only: the library's file name carries a hash of the source and
flags, so an edited source never loads a stale build. A failed build
raises; nothing substitutes a plain PyTorch version for a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from gamesmanmpi_tpu_torch.utils.env import env_opt

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: kernel library name -> (source file, C functions with their ctypes
#: signatures: (argtypes, restype)).
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SOURCES: Dict[str, tuple] = {
    "window_gather": ("window_gather.cu", {
        "window_gather_launch": (
            [_I, _I, _P, _LL, _P, _LL, _P, _P, _LL, _LL, _LL, _LL, _I, _I,
             _LL, _I, _P], _I),
    }),
    "double_u32": ("double_u32.cu", {
        "double_u32_launch": ([_P, _P, _LL, _I, _LL, _LL, _I, _P], _I),
    }),
    # Both take the argument vector of ops/dense_level.launch_args.
    "dense_level": ("dense_level.cu", {
        "dense_step_launch": ([_P, _I, _P], _I),
        "reach_step_launch": ([_P, _I, _P], _I),
    }),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's -Xptxas=-v report per library (registers, shared memory, spills),
#: from the build or, for a cached library, from the report file the
#: build left beside it.
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    home = env_opt("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built here")
    return found


def _library_path(name: str) -> pathlib.Path:
    src = CSRC / SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _report_path(library: pathlib.Path) -> pathlib.Path:
    """`<name>_<hash>.ptxas.txt` beside `<name>_<hash>.so`."""
    return library.with_suffix(".ptxas.txt")


def _compile(name: str) -> pathlib.Path:
    out = _library_path(name)
    report = _report_path(out)
    if out.exists():
        if report.exists():
            PTXAS_REPORT[name] = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    PTXAS_REPORT[name] = (proc.stdout + proc.stderr).strip()
    # The report goes down before the library, so a library that exists
    # always has its report beside it.
    report_tmp = report.with_suffix(f".{os.getpid()}.tmp")
    report_tmp.write_text(PTXAS_REPORT[name])
    os.replace(report_tmp, report)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel source, one nvcc each, all started together."""
    with ThreadPoolExecutor(max_workers=max(len(SOURCES), 1)) as pool:
        futs = {n: pool.submit(_compile, n) for n in SOURCES}
        return {n: f.result() for n, f in futs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(_compile(name)))
    for fn, (argtypes, restype) in SOURCES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise when a launch function returned an error code."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error code {code}")
