"""Build and load the hand-written Hopper kernels (``gaot_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o gaot_torch/_build/kernels/lib<name>.so <name>.cu

then loaded with ctypes. A library is rebuilt when its source is newer.
:func:`build_all` starts one ``nvcc`` per source at once. Nothing here runs
at import time, so the package imports on a host without CUDA.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build", "kernels")
KERNELS = ("multiply_reduce", "flash_attention", "fused_ffn")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_info: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return (os.path.join(SRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def _start(nvcc: str, name: str):
    src, so = _paths(name)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, so


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every stale kernel library, one nvcc per source in parallel.

    Returns the seconds each build took (0.0 for an up-to-date library).
    Raises RuntimeError with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stale = [n for n in names if _stale(n)]
    nvcc = _nvcc() if stale else ""
    t0 = time.perf_counter()
    procs = {n: _start(nvcc, n) for n in stale}
    secs = {n: 0.0 for n in names}
    failed = []
    for n, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        ptxas_info[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu ---\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
