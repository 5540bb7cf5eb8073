"""ctypes bindings for the port's native host library (csrc/fastload.cc;
the port's copy of declip_tpu/data/native.py).

C++ data-path primitives (the reference delegates these to NVIDIA DALI,
SURVEY.md §2.9): JSONL offset scanning, JPEG decode with DCT prescale, and
a fused decode + crop + bilinear resize.

The library is built at first use with ``g++ -O3 -march=native -fPIC
-shared ... -ljpeg`` into ``declip_tpu_torch/_build/libfastload-<hash>.so``;
the hash covers the source, the flags and the host's CPU (``-march=native``
code runs only where it was built). The build writes a temporary file and
renames it, so loader workers that reach it at once each see a whole
library. It needs a C++ compiler and libjpeg's headers (``jpeglib.h``).

Unlike the JAX package, nothing falls back to PIL when the library cannot
be built: ``load`` raises with the compiler's message, and the datasets
call it when they are built with ``image_reader: {type: native}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fastload.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
LIBS = ("-ljpeg",)

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def library_path() -> str:
    h = hashlib.sha256(" ".join(
        (CXX, *CXX_FLAGS, *LIBS, platform.machine(), _cpu_model())).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastload-{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first if it is not there. Raises
    RuntimeError with the compiler's output when it cannot be built."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"image_reader native: the C++ compiler {CXX!r} was not found "
            f"({e}); the native decoder is built at first use and needs "
            f"{CXX} and libjpeg's headers (jpeglib.h)") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"image_reader native: building {SOURCE} failed (exit "
            f"{proc.returncode}; it needs {CXX} and libjpeg's headers, "
            f"jpeglib.h):\n$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return so


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises as ``build``)."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.fl_scan_offsets.restype = ctypes.c_int64
        lib.fl_scan_offsets.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
        lib.fl_free.restype = None
        lib.fl_free.argtypes = [ctypes.c_void_p]
        lib.fl_jpeg_dims.restype = ctypes.c_int
        lib.fl_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.fl_jpeg_decode.restype = ctypes.c_int
        lib.fl_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.fl_decode_crop_resize.restype = ctypes.c_int
        lib.fl_decode_crop_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def scan_offsets(path: str) -> np.ndarray:
    """Byte offsets of each non-empty line (JSONL fseek index)."""
    lib = load()
    out = ctypes.POINTER(ctypes.c_int64)()
    n = lib.fl_scan_offsets(path.encode(), ctypes.byref(out))
    if n < 0:
        raise OSError(f"fl_scan_offsets failed for {path}")
    try:
        return (np.ctypeslib.as_array(out, shape=(n,)).copy() if n
                else np.zeros((0,), np.int64))
    finally:
        if out:  # guard on the pointer, not the count
            lib.fl_free(out)


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    """(width, height) of a JPEG; ValueError if it is not one."""
    lib = load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.fl_jpeg_dims(data, len(data), ctypes.byref(w),
                        ctypes.byref(h)) != 0:
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


def decode_jpeg(data: bytes, min_side: int = 0) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3] (DCT-prescaled if min_side set);
    ValueError if the bytes do not decode."""
    lib = load()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.fl_jpeg_decode(data, len(data), int(min_side),
                            ctypes.byref(buf), ctypes.byref(w),
                            ctypes.byref(h))
    if rc != 0:
        raise ValueError("JPEG decode failed")
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.fl_free(buf)


def decode_crop_resize(data: bytes, box: Tuple[float, float, float, float],
                       out_size: Tuple[int, int]) -> np.ndarray:
    """Fused decode + crop(box=(x, y, w, h)) + bilinear resize -> uint8
    [oh, ow, 3]."""
    lib = load()
    ow, oh = out_size
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.fl_decode_crop_resize(
        data, len(data), box[0], box[1], box[2], box[3],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ow, oh)
    if rc != 0:
        raise ValueError("decode_crop_resize failed")
    return out
