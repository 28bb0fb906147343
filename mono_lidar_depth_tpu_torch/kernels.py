"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled with `nvcc` for `sm_90a` into a
shared library of its own with a plain C interface and bound with
`ctypes` (no PyTorch headers, so a build takes seconds).  The first use
of any kernel builds every source, one `nvcc` process each, all started
together, into `_build/<hash of the sources and flags>/` inside the
package; so a fresh checkout builds on its own and an edited source
builds anew.  Delete `_build/` to force a rebuild.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i32 = ctypes.c_int32


class GatherScale(ctypes.Structure):
    """One search scale of csrc/gather_neighbors.cu (MldGatherScale): the
    rectangle's half sizes, the static window and the output pointers."""

    _fields_ = [("half_x", _cf), ("half_y", _cf), ("ky", ctypes.c_int32),
                ("kx", ctypes.c_int32), ("mask", _vp), ("z", _vp),
                ("flags", _vp), ("points", _vp), ("count", _vp),
                ("indices", _vp)]


class LkLevel(ctypes.Structure):
    """One pyramid level of csrc/lk_track.cu (MldLkLevel): both frames'
    images, their shape and the clamp bounds of `_split_frac`."""

    _fields_ = [("prev", _vp), ("next", _vp), ("H", ctypes.c_int32),
                ("W", ctypes.c_int32), ("lo", _cf), ("hi_x", _cf),
                ("hi_y", _cf)]


class CascadeParams(ctypes.Structure):
    """The depth cascade's switches and thresholds, csrc/depth_cascade.cu
    (MldCascadeParams): window sizes, the configuration's switches as
    ints, its float32 thresholds and the pinhole's centre and focal
    length."""

    _fields_ = [("k1", _i32), ("k2", _i32), ("count_min", _i32),
                ("use_histogram", _i32), ("num_bins", _i32),
                ("hist_min_count", _i32), ("bin_width", _cf),
                ("use_pca", _i32), ("use_triangle", _i32),
                ("check_planar", _i32),
                ("planar_threshold", _cf), ("check_ortho", _i32),
                ("ortho_threshold", _cf), ("depth_enabled", _i32),
                ("depth_mode", _i32), ("depth_min", _cf), ("depth_max", _cf),
                ("local_enabled", _i32), ("local_mode", _i32),
                ("local_relative", _i32), ("local_value", _cf),
                ("cut_behind", _i32), ("pca_abs_min", _cf),
                ("pca_32_rel_max", _cf), ("pca_21_rel_min", _cf),
                ("road_estimator", _i32), ("far_veto", _i32),
                ("far_threshold", _cf), ("z_x_min", _cf), ("cx", _cf),
                ("cy", _cf), ("focal", _cf), ("collect_debug", _i32)]


# library (source stem) -> entry point -> argument types; every entry
# point returns cudaGetLastError() as an int.
_ENTRY_POINTS = {
    "windows": {"mld_slice_windows": [_vp, _vp, _vp, _vp,
                                      _ci, _ci, _ci, _ci, _ci, _ci, _vp]},
    "lk_track": {"mld_lk_track": [ctypes.POINTER(LkLevel), _ci,
                                  _vp, _vp, _vp, _vp, _vp, _vp,
                                  _ci, _ci, _ci, _cf, _vp]},
    "gather_neighbors": {"mld_gather_neighbors": [
        _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _cf, _cf, _cf,
        ctypes.POINTER(GatherScale), _ci, _vp]},
    "zncc_gate": {"mld_zncc_gate": [_vp] * 10 + [_ci] * 4 + [_cf] * 7
                  + [_vp]},
    "depth_cascade": {"mld_depth_cascade": [_vp] * 12 + [_ci, _vp, _ci, _ci]
                      + [_vp] * 8 + [ctypes.POINTER(CascadeParams), _vp]},
}

_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}  # directory, seconds and compiler logs of the build


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build_dir() -> Path:
    """Where the libraries for the current sources live."""
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):  # sources and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"libmld_{name}.so"


def build() -> Path:
    """Compile every source that this source hash has not built yet, all
    at once; returns the build directory."""
    out_dir = build_dir()
    todo = [s for s in _sources() if not library_path(s.stem).exists()]
    if not todo:  # a build made earlier in this process keeps its record
        if build_info.get("path") != str(out_dir):
            build_info.update(path=str(out_dir), seconds=0.0, log="(cached)")
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, tmp, proc in procs:  # wait for all, so none outlives a failure
        log, _ = proc.communicate()
        logs.append(f"[{src.name}]\n{log}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                          f"{log}")
        else:
            # atomic: a concurrent process sees no partial file
            os.replace(tmp, library_path(src.stem))
    if failed:
        raise RuntimeError("\n".join(failed))
    build_info.update(path=str(out_dir), seconds=time.perf_counter() - t0,
                      log="".join(logs))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (everything is built on the
    first call)."""
    if name not in _libs:
        build()
        _libs[name] = load(name, library_path(name))
    return _libs[name]


def load(name: str, path: Path) -> ctypes.CDLL:
    """A library built from csrc/<name>.cu, with its entry points typed."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _ci
    lib.mld_error_string.argtypes = [_ci]
    lib.mld_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point of `lib` returned a CUDA error."""
    if code != 0:
        msg = lib.mld_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
