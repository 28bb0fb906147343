"""ctypes binding to the native host runtime (native/kitti_reader.cpp);
a copy of the JAX package's io/native.py, which is reached only through a
package that imports JAX.

Builds the shared library on first use (g++ via native/Makefile).  Where
no toolchain is available the callers in io/kitti.py read the files with
numpy: a host file reader, nothing of the device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libmld_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not _LIB_PATH.exists():
            try:
                subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _build_failed = True
            return None
        lib.mld_read_velodyne.restype = ctypes.c_int64
        lib.mld_read_velodyne.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.mld_loader_create.restype = ctypes.c_void_p
        lib.mld_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.mld_loader_next.restype = ctypes.c_int64
        lib.mld_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.mld_loader_destroy.restype = None
        lib.mld_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_velodyne_native(path: str, max_points: int) -> tuple[np.ndarray, int]:
    """Read one velodyne .bin into a padded [max_points, 4] array.
    Returns (xyzi, n_points).  Raises if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.zeros((max_points, 4), dtype=np.float32)
    n = lib.mld_read_velodyne(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return out, int(n)


class NativeScanLoader:
    """Ordered prefetching loader over a list of velodyne files."""

    def __init__(self, paths: list[str], max_points: int,
                 depth: int = 4, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._max_points = max_points
        blob = b"".join(p.encode() + b"\0" for p in paths)
        self._handle = lib.mld_loader_create(
            blob, len(paths), max_points, depth, threads)
        self._n = len(paths)
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, int]:
        if self._handle is None or self._consumed >= self._n:
            raise StopIteration
        out = np.empty((self._max_points, 4), dtype=np.float32)
        n = self._lib.mld_loader_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == -2:
            raise StopIteration
        self._consumed += 1
        if n < 0:
            raise IOError(f"read error at scan {self._consumed - 1}")
        return out, int(n)

    def close(self):
        if self._handle is not None:
            self._lib.mld_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
