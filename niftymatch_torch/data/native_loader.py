"""ctypes binding of the native C++ frame loader (``native/loader.cpp``),
the port's own counterpart of ``data/native_loader.py`` of the JAX
package: a zlib-only PNG decoder and a multi-threaded prefetching loader,
so host-side decoding overlaps the device's work.

The library is built with ``make -C native`` at first use, into
``native/build/torch/`` (git-ignored; its own directory, so a JAX-side
build running at the same time never writes the file this one loads).
:func:`available` is False only where ``make`` fails; every decoding
function raises then, and nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_BUILD_SUBDIR = os.path.join("build", "torch")
_LIB_PATH = os.path.join(_NATIVE_DIR, _BUILD_SUBDIR, "libnmloader.so")
_lock = threading.Lock()
_lib = None

_INT_P = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "nm_png_info": ([ctypes.c_char_p, _INT_P, _INT_P, _INT_P, _INT_P], ctypes.c_int),
    "nm_png_read_gray": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)], ctypes.c_int),
    "nm_png_read_raw16": ([ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16)], ctypes.c_int),
    "nm_loader_create": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int],
                         ctypes.c_void_p),
    "nm_loader_next": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                        _INT_P, _INT_P], ctypes.c_int),
    "nm_loader_destroy": ([ctypes.c_void_p], None),
}


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD_DIR={_BUILD_SUBDIR}"], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    return os.path.exists(_LIB_PATH)


def load_library():
    """The loaded library, built first if needed; None where ``make`` fails."""
    global _lib
    with _lock:
        if _lib is None and (os.path.exists(_LIB_PATH) or _build()):
            lib = ctypes.CDLL(_LIB_PATH)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _require():
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: `make -C {_NATIVE_DIR}` failed")
    return lib


def png_info(path: str):
    """(width, height, channels, bitdepth) of a PNG, or None on failure."""
    lib = _require()
    w, h, c, b = (ctypes.c_int() for _ in range(4))
    if lib.nm_png_info(path.encode(), w, h, c, b) != 0:
        return None
    return w.value, h.value, c.value, b.value


def read_gray(path: str) -> np.ndarray:
    """Decode a PNG to float32 grayscale (H, W) (RGB weighted 0.21 / 0.72 /
    0.07, as the reference does)."""
    lib = _require()
    info = png_info(path)
    if info is None:
        raise ValueError(f"bad PNG: {path}")
    w, h, _, _ = info
    out = np.empty((h, w), np.float32)
    if lib.nm_png_read_gray(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise ValueError(f"decode failed: {path}")
    return out


def read_depth16(path: str) -> np.ndarray:
    """Decode a 16-bit grayscale PNG (TUM depth maps) to uint16 (H, W)."""
    lib = _require()
    info = png_info(path)
    if info is None:
        raise ValueError(f"bad PNG: {path}")
    w, h, c, b = info
    if c != 1 or b != 16:
        raise ValueError(f"not 16-bit grayscale: {path}")
    out = np.empty((h, w), np.uint16)
    if lib.nm_png_read_raw16(path.encode(),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))):
        raise ValueError(f"decode failed: {path}")
    return out


class PrefetchLoader:
    """Frames of a path list, in order, as float32 grayscale (H, W), decoded
    ahead by ``threads`` native worker threads.  Every frame must be at
    most the size of the first.  Close it (or use it as a context
    manager) to stop the workers."""

    def __init__(self, paths, threads: int = 4):
        self._lib = _require()
        self._paths = [p.encode() for p in paths]   # alive while the workers read them
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.nm_loader_create(arr, len(self._paths), threads)
        info = png_info(paths[0]) if paths else None
        self._shape = (info[1], info[0]) if info else (0, 0)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        h, w = self._shape
        # The native side writes hi * wi floats contiguously: reshape with
        # the returned size, not the first frame's.
        out = np.empty(h * w, np.float32)
        wi, hi = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.nm_loader_next(self._handle,
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      out.size, wi, hi)
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise ValueError("decode failed in prefetch loader")
        if rc == -3:
            raise ValueError("frame larger than the first frame; use uniform sizes")
        return out[: hi.value * wi.value].reshape(hi.value, wi.value)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.nm_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()
