"""Build and load the CUDA C++ kernels of ``repro_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
and loaded with ``ctypes``.  Libraries land in ``build/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  All missing libraries
are compiled in parallel, one ``nvcc`` process per source.

Nothing is built when this module is imported: the first call of a
kernel wrapper on a CUDA tensor builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "build_all", "library", "function", "BUILD_DIR",
           "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# kernel library name -> source file in csrc/ (each includes common.cuh;
# qgemm.cu (G: its decode kernel, and the Hopper tile qgemm_sm90.cuh above
# decode), qgemm_emitq.cu (E), qgemm_stats.cu (K8) and bwd_pair.cu (B and
# K9) run the tile; paged_prefill.cu (P) and flash_prefill.cu (K10) run the
# prefill walk attn_prefill_sm90.cuh; the oracle's quantize.cu (K2) and
# qmatmul.cu (K3) stand alone)
KERNELS = {
    "qgemm": "qgemm.cu",
    "qgemm_emitq": "qgemm_emitq.cu",
    "qgemm_stats": "qgemm_stats.cu",
    "bwd_pair": "bwd_pair.cu",
    "paged_decode": "paged_decode.cu",
    "paged_prefill": "paged_prefill.cu",
    "quantize": "quantize.cu",
    "qmatmul": "qmatmul.cu",
    "flash_prefill": "flash_prefill.cu",
}
_HEADERS = ("common.cuh", "qgemm_sm90.cuh", "attn_prefill_sm90.cuh")

# --fmad=false: no multiply-add is contracted behind the source's back;
# the kernels call __fmaf_rn where a fused multiply-add is intended.
# No --use_fast_math: exp2f, division and denormals stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (KERNELS[name], *_HEADERS):
        h.update((CSRC_DIR / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library (all in parallel); returns the wall
    seconds of the whole build per name that was compiled.  ``nvcc``'s
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``.  Raises with the compiler's output on
    any failure."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / KERNELS[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    dt = time.perf_counter() - t0
    return {n: dt for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: list):
    """C entry ``symbol`` of kernel ``name`` with its argument types set
    (every pointer and the stream as ``c_void_p``); it returns the
    ``cudaError_t`` of its launch as an int."""
    f = getattr(library(name), symbol)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = argtypes
    return f
