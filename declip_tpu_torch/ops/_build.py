"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
``sm_90a`` into ``declip_tpu_torch/_build/lib<name>-<hash>.so`` at first use
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edit rebuilds). Nothing is built at import time: the CPU tests
import every module, and a machine without a card has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -Xptxas -v reports registers, shared memory and spills per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the last build in this process
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use and need "
        "the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile each named source that has no up-to-date library, one nvcc
    per source, all started together. Returns build seconds per name."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, so, time.perf_counter())
    seconds, errors = {}, []
    for name, (proc, tmp, so, t0) in jobs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
