"""Build and load the hand-written Hopper kernels (``gaot_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --split-compile=0 -o gaot_torch/_build/kernels/lib<name>.so <name>.cu

then loaded with ctypes. ``--split-compile=0`` runs the device compiler's
passes on every host core: the flash sources instantiate each kernel for
sixteen head dims. A library is rebuilt when its source, or a shared header
(``csrc/*.cuh``), is newer. :func:`build_all` starts one ``nvcc`` per source
at once. Nothing here runs at import time, so the package imports on a host
without CUDA.
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
KERNELS = ("multiply_reduce", "flash_attention", "flash_attention_bwd", "flash_wide",
           "flash_wide_f32", "fused_ffn")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}
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
    """The library is missing or older than its source or any shared header."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                    if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(map(os.path.getmtime, deps))


def _start(nvcc: str, name: str):
    src, so = _paths(name)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
           "-Xptxas", "-v", "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, so


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every stale kernel library, one nvcc per library in parallel.

    Returns the seconds each build took (0.0 for an up-to-date library).
    Raises RuntimeError with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stale = [n for n in names if _stale(n)]
    nvcc = _nvcc() if stale else ""
    secs = {n: 0.0 for n in names}
    outs = {}

    def run(n):
        # A thread per nvcc drains its pipe: the ptxas report of a flash
        # source passes the pipe's buffer.
        t0 = time.perf_counter()
        proc, tmp, so = _start(nvcc, n)
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        outs[n] = (proc.returncode, out, tmp, so)

    threads = [threading.Thread(target=run, args=(n,)) for n in stale]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = []
    for n in stale:
        rc, out, tmp, so = outs[n]
        ptxas_info[n] = out
        if rc != 0:
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


def entry(name: str, fn: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry point ``fn`` of library ``name`` (built first if needed),
    with its argument and result types set once: setting them on every call
    costs the host more than a small kernel takes on the card."""
    key = (name, fn)
    f = _entries.get(key)
    if f is None:
        f = getattr(load(name), fn)
        f.restype = restype
        f.argtypes = list(argtypes)
        _entries[key] = f
    return f


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
