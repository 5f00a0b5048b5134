"""Build and load the hand-written CUDA kernels of `lidiff_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C function and is compiled by `nvcc`
into its own shared library under `lidiff_tpu_torch/_build/`, then loaded
with ctypes. No PyTorch headers are included, so a build takes seconds.
The first kernel call builds every missing library, one `nvcc` process per
source, all started together. Library names carry a hash of the source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("kmap3_columns", "conv3_columns", "conv3_columns_dw",
           "nn_match")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: ptxas report} for the sources built by this call.
    Raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            lib.lidiff_error_string.argtypes = [ctypes.c_int]
            lib.lidiff_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    `launches` counts successful launches only; the wrappers call a kernel
    for CUDA tensors and never for CPU ones, so the count shows which path
    a run took."""

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol, self.argtypes = lib, symbol, argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library(self.lib).lidiff_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All tensors on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
