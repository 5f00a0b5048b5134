"""ctypes bindings of the port's host C++ kernels (counterpart of
lidiff_tpu/native/__init__.py): farthest-point sampling, first-point-per-
voxel dedup, the viewpoint voxel filter and nearest-neighbour distances.

`src/lidiff_native.cpp` is compiled by g++ at first use into
`lidiff_tpu_torch/_build/liblidiff_native-<hash>.so`, the hash taken over
the flags and the source, so an edited source is rebuilt. The library is
written under a temporary name and moved into place, so processes that
build at the same moment never load a half-written file. A failed build
raises with the compiler's output: no caller falls back to a numpy loop.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "src", "lidiff_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# -ffp-contract=off: FPS's dx*dx + dy*dy + dz*dz stays three products and
# two adds (no FMA), the float32 arithmetic of numpy's `fps_numpy`
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"liblidiff_native-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            i64 = ctypes.c_int64
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
            lib.lidiff_fps.argtypes = [f32p, i64, i64, i64p]
            lib.lidiff_fps.restype = None
            lib.lidiff_voxel_unique.argtypes = [f32p, i64, ctypes.c_double,
                                                i64p]
            lib.lidiff_voxel_unique.restype = i64
            lib.lidiff_viewpoint_filter.argtypes = [f32p, i64, f32p, i64,
                                                    ctypes.c_double, u8p]
            lib.lidiff_viewpoint_filter.restype = None
            lib.lidiff_nn_dist.argtypes = [f32p, i64, f32p, i64,
                                           ctypes.c_double, f32p]
            lib.lidiff_nn_dist.restype = None
            _lib = lib
        return _lib


def _xyz(points: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)


def fps_native(points: np.ndarray, k: int) -> np.ndarray:
    """Indices [min(k, N)] of a farthest-point subset of points [N, >=3]:
    start at 0, each pick the first index of the largest squared distance
    to the picks so far."""
    lib = _load()
    pts = _xyz(points)
    out = np.empty(max(min(int(k), len(pts)), 0), np.int64)
    lib.lidiff_fps(pts, len(pts), len(out), out)
    return out


def voxel_unique_native(points: np.ndarray, voxel: float) -> np.ndarray:
    """Indices of the first point in each `voxel` cell (floor grid), in
    ascending order."""
    lib = _load()
    pts = _xyz(points)
    out = np.empty(len(pts), np.int64)
    n = lib.lidiff_voxel_unique(pts, len(pts), float(voxel), out)
    return out[:n]


def viewpoint_filter_native(full: np.ndarray, part: np.ndarray,
                            voxel: float = 10.0) -> np.ndarray:
    """Mask of `full` points in `voxel` cells occupied by `part`, the grid's
    origin at part's minimum corner."""
    lib = _load()
    f, p = _xyz(full), _xyz(part)
    out = np.empty(len(f), np.uint8)
    lib.lidiff_viewpoint_filter(f, len(f), p, len(p), float(voxel), out)
    return out.astype(bool)


def nn_dist_native(a: np.ndarray, b: np.ndarray,
                   cell: float = 0.5) -> np.ndarray:
    """For each point of a, the Euclidean distance to its nearest point of
    b (float32; inf where b is empty), through a uniform grid of
    `cell`-sized cells."""
    lib = _load()
    aa, bb = _xyz(a), _xyz(b)
    if len(bb) == 0:     # the shell search would walk 4096 empty shells
        return np.full(len(aa), np.inf, np.float32)
    out = np.empty(len(aa), np.float32)
    lib.lidiff_nn_dist(aa, len(aa), bb, len(bb), float(cell), out)
    return out
