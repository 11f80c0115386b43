"""Build the port's CUDA sources with nvcc at first use and load them.

`library(name)` compiles ``csrc/<name>.cu`` into a shared library with a
plain C interface (bound with ctypes), the quick route: seconds of
``nvcc``, where a source that includes PyTorch's headers takes minutes.
The output lands in ``csrc/build/`` under a name keyed by a hash of the
source and the flags, so an edited source or flag rebuilds and an
unchanged one loads at once. A failed build raises with nvcc's output.

Nothing here runs at import: the kernel wrappers call `library` at
their first launch on a CUDA tensor, never on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
# sm_90a (not sm_90): wgmma and setmaxnreg exist only for that target.
# -Xptxas -v makes ptxas report registers, spills and static shared
# memory per kernel; `build` prints that report on one line.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return path


def _ptxas_summary(log: str) -> str:
    """One line from ``ptxas -v``: each distinct register/barrier usage
    with its count of kernels, the largest static shared memory, the
    total spill bytes (dynamic shared memory is sized per launch) and the
    count of ptxas's "Potential Performance Loss" notes (a wgmma it
    serialized, for one)."""
    usage = collections.Counter(
        ", ".join(p for p in ln.split(":", 1)[1].strip().split(", ")
                  if "bytes" not in p)
        for ln in log.splitlines()
        if ln.startswith("ptxas info") and " Used " in ln)
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
    losses = log.count("Potential Performance Loss")
    kinds = " | ".join(f"{n} x {u}" for u, n in sorted(usage.items()))
    return (f"ptxas ({sum(usage.values())} kernels): {kinds}; static smem "
            f"{max(smem, default=0)} B; spills {spills} B; performance-loss "
            f"notes {losses}")


def build(name: str) -> str:
    """Path of the compiled ``csrc/<name>.cu``, compiling it if this
    source and flag set have not been built yet."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) on {src}:"
                           f"\n{proc.stdout}\n{proc.stderr}")
    print(f"[build] {name}: nvcc {time.perf_counter() - t0:.1f} s; "
          + _ptxas_summary(proc.stderr), flush=True)
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
