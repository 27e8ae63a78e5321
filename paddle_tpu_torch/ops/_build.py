"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points (the tensor-core
kernels share the inline-PTX helpers of ``csrc/hopper.cuh``). It is
compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``. No PyTorch headers are
included, so a build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` would.

Every C entry returns ``cudaGetLastError()`` after its launch; wrappers
raise ``RuntimeError`` when it is not 0 (a launch that is refused never
runs, and a later ``synchronize`` would not report it).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "flash_decode",
           "fused_ce", "ragged_matmul", "int8_matmul", "stochastic_round")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _lib_path(name) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name) -> bool:
    """Missing, or older than its source or a shared header of csrc/."""
    so = _lib_path(name)
    if not so.exists() or not _log_path(name).exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def _log_path(name) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def build_log(name) -> str:
    """The compiler output (ptxas' register, shared-memory and spill lines)
    of the last build of kernel library ``name``, kept beside it."""
    return _log_path(name).read_text()


def build(names=KERNELS, force=False) -> dict:
    """Compile those of ``names`` (all kernels by default) that are missing
    or older than their source (every one if ``force``), one ``nvcc``
    process per source, all started together. Returns name -> compiler
    output of what was built, also kept for ``build_log``; raises
    RuntimeError naming the sources that failed to compile."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        logs[n], _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{logs[n]}")
            continue
        _log_path(n).write_text(logs[n])
        os.replace(tmp, _lib_path(n))      # atomic against a parallel build
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of kernel library ``name`` (built if missing or
    older than its source), with ``argtypes`` set and an int return."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
