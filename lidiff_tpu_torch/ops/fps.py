"""Farthest point sampling (counterpart of lidiff_tpu/ops/fps.py).
Deterministic: start at index 0; each pick is the first index of the
largest float32 squared distance (dx*dx + dy*dy) + dz*dz to the picks so
far; k >= N gives every index.

  * `fps` on numpy input runs the port's host C++ kernel
    (`lidiff_tpu_torch.native.fps_native`), as the JAX package's does;
  * `fps_cuda` runs kernel F1 (`csrc/fps.cu`) on a CUDA tensor, the whole
    sampling in one launch of one thread-block cluster;
  * `fps_plain` is the same function in tensor code and `fps_numpy` in
    numpy: the plain versions that the kernels are held to.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lidiff_tpu_torch.native import fps_native
from lidiff_tpu_torch.ops import native

_fps_kernel = native.Kernel(
    "fps", "fps",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_fps_kernel.cluster = 0      # blocks in the cluster of its last launch


def fps_numpy(points: np.ndarray, k: int) -> np.ndarray:
    """[N,3] -> indices [k] of a farthest-point subset (O(N*k))."""
    n = len(points)
    if k >= n:
        return np.arange(n)
    p = points.astype(np.float32)
    sel = np.empty(k, np.int64)
    sel[0] = 0
    d = np.sum((p - p[0]) ** 2, -1)
    for i in range(1, k):
        j = int(np.argmax(d))
        sel[i] = j
        dj = np.sum((p - p[j]) ** 2, -1)
        np.minimum(d, dj, out=d)
    return sel


def fps_plain(points: torch.Tensor, k: int) -> torch.Tensor:
    """points [N, 3] float32 -> indices [min(k, N)] int64 on its device, in
    tensor ops that never wait for the device (the pick stays a tensor)."""
    n = points.shape[0]
    dev = points.device
    if k >= n:
        return torch.arange(n, device=dev)
    sel = torch.zeros(max(k, 0), dtype=torch.int64, device=dev)
    d = torch.full((n,), float("inf"), device=dev)
    j = sel[:1]
    for i in range(1, k):
        sq = (points - points[j]) ** 2
        d = torch.minimum(d, (sq[:, 0] + sq[:, 1]) + sq[:, 2])
        j = torch.argmax(d).reshape(1)
        sel[i:i + 1] = j
    return sel


def fps_cuda(points: torch.Tensor, k: int,
             max_cluster: int = 16) -> torch.Tensor:
    """points [N, 3] float32 -> indices [min(k, N)] int64 on its device:
    kernel F1 for a CUDA tensor (one launch; none for k >= N), `fps_plain`
    for a CPU one. F1 takes a cluster of 16 blocks where one fits, else 8;
    `max_cluster` 8 takes 8 at once (the tests' way to reach that
    cluster)."""
    if points.dim() != 2 or points.shape[1] != 3 or \
            points.dtype != torch.float32:
        raise ValueError("fps_cuda: points must be [N, 3] float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if max_cluster not in (8, 16):
        raise ValueError(f"fps_cuda: max_cluster must be 8 or 16, got "
                         f"{max_cluster}")
    if points.device.type == "cpu":
        return fps_plain(points, k)
    n = points.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"fps_cuda: {n} points do not fit int32 indices")
    dev = points.device
    if k >= n:
        return torch.arange(n, device=dev)
    if k <= 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    pts = points.contiguous()
    native.check_cuda("fps_cuda", pts)
    d = torch.empty(n, device=dev)    # where a slice outgrows shared memory
    out = torch.empty(k, dtype=torch.int64, device=dev)
    cluster = ctypes.c_int(max_cluster)
    _fps_kernel(native.ptr(pts), n, k, native.ptr(d), native.ptr(out),
                ctypes.byref(cluster), native.stream(dev))
    _fps_kernel.cluster = cluster.value
    return out


def fps(points: np.ndarray, k: int) -> np.ndarray:
    """Returns the sampled points [min(k, N), ...] (host C++ kernel)."""
    return points[fps_native(points[:, :3], k)]
