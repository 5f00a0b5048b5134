"""Farthest point sampling on the host (counterpart of
lidiff_tpu/ops/fps.py, its numpy path). Deterministic: starts from index 0,
squared-L2 metric.
"""

from __future__ import annotations

import numpy as np


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


def fps(points: np.ndarray, k: int) -> np.ndarray:
    """Returns the sampled points [k, 3]."""
    return points[fps_numpy(points[:, :3], k)]
