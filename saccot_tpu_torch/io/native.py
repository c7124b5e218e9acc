"""ctypes bridge to the repository's native C++ loader (native/loader.cpp,
native/prefetch.cpp; port of `saccot_tpu/io/native.py`).

Loads `native/libsaccot_native.so` from the repository root when present
(build with `native/build.sh`); every function returns None when the
library is unavailable, so callers read with the NumPy paths in
io/loaders.py. The package never requires the native build.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libsaccot_native.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.saccot_load_kitti_bin.restype = ctypes.c_long
    lib.saccot_load_kitti_bin.argtypes = [ctypes.c_char_p, fp, ctypes.c_long]
    lib.saccot_load_ply_xyz.restype = ctypes.c_long
    lib.saccot_load_ply_xyz.argtypes = [ctypes.c_char_p, fp, ctypes.c_long]
    lib.saccot_voxel_downsample.restype = ctypes.c_long
    lib.saccot_voxel_downsample.argtypes = [fp, ctypes.c_long, ctypes.c_float, fp, ctypes.c_long]
    if hasattr(lib, "saccot_prefetch_create"):  # older .so builds lack it
        cpp = ctypes.POINTER(ctypes.c_char_p)
        lib.saccot_prefetch_create.restype = ctypes.c_void_p
        lib.saccot_prefetch_create.argtypes = [
            cpp, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.saccot_prefetch_next.restype = ctypes.c_long
        lib.saccot_prefetch_next.argtypes = [ctypes.c_void_p, fp, ctypes.c_long]
        lib.saccot_prefetch_destroy.restype = None
        lib.saccot_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def _farray(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_kitti_bin(path: str, max_pts: int = 200_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_pts, 3), np.float32)
    n = lib.saccot_load_kitti_bin(path.encode(), _farray(out), max_pts)
    if n < 0:
        return None
    return out[:n].copy()


def load_ply_xyz(path: str, max_pts: int = 2_000_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty((max_pts, 3), np.float32)
    n = lib.saccot_load_ply_xyz(path.encode(), _farray(out), max_pts)
    if n < 0:
        return None
    return out[:n].copy()


def voxel_downsample(points: np.ndarray, voxel: float, max_out: int = 500_000) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((max_out, 3), np.float32)
    m = lib.saccot_voxel_downsample(_farray(pts), len(pts), voxel, _farray(out), max_out)
    if m < 0:
        return None
    return out[:m].copy()


class PrefetchReader:
    """Background-threaded ordered scan reader (native/prefetch.cpp).

    Iterates the given files in order, yielding [n, 3] float32 arrays (or
    None for unreadable files), while a native worker pool parses up to
    `window` scans ahead of the consumer — so disk/parse latency overlaps
    device compute in the sequence runner. Use `prefetch_reader()` to get
    either this or None when the native library is unavailable.
    """

    def __init__(self, paths, fmt: str, max_pts: int = 200_000,
                 threads: int = 4, window: int = 8):
        lib = _lib()
        if lib is None or not hasattr(lib, "saccot_prefetch_create"):
            raise RuntimeError("native prefetcher unavailable")
        self._lib = lib
        self._paths = [str(p) for p in paths]
        self._max_pts = int(max_pts)
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        fmt_code = {"kitti": 0, "bin": 0, "ply": 1}[fmt]
        self._h = lib.saccot_prefetch_create(
            arr, len(self._paths), self._max_pts, fmt_code, threads, window
        )
        if not self._h:
            raise RuntimeError("prefetcher creation failed")

    def __iter__(self):
        out = np.empty((self._max_pts, 3), np.float32)
        for _ in range(len(self._paths)):
            n = self._lib.saccot_prefetch_next(self._h, _farray(out), self._max_pts)
            if n == -2:
                return
            yield None if n < 0 else out[:n].copy()

    def close(self):
        if self._h:
            self._lib.saccot_prefetch_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def prefetch_reader(paths, fmt: str, max_pts: int = 200_000,
                    threads: int = 4, window: int = 8) -> Optional["PrefetchReader"]:
    """PrefetchReader when the native library supports it, else None."""
    lib = _lib()
    if lib is None or not hasattr(lib, "saccot_prefetch_create"):
        return None
    return PrefetchReader(paths, fmt, max_pts=max_pts, threads=threads, window=window)
