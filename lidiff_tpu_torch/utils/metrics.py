"""Completion metrics on the host, numpy and scipy (counterpart of
lidiff_tpu/utils/metrics.py):
  * ChamferDistance: the symmetric mean nearest-neighbour distance;
  * RMSE: the mean nearest-neighbour distance from the prediction to the
    ground truth;
  * PrecisionRecall: per-scan percentages under 100 thresholds, their
    Simpson-integrated AUC;
  * CompletionIoU: occupancy IoU at voxel sizes {0.5, 0.2, 0.1} over
    +-max_range, accumulated over scans.

Nearest neighbours come from scipy's cKDTree. CompletionIoU bins the raw
coordinates into (2 * max_range / voxel size)^3 bins exactly as
`np.histogramdd` does, but counts from the occupied bins alone: the JAX
class builds two dense float64 histograms per voxel size and scan, 8 GB
each at 0.1 m over +-50 m.
"""

from __future__ import annotations

import numpy as np
from scipy import integrate
from scipy.spatial import cKDTree


def nn_distance(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """For each src point, the Euclidean distance to the nearest tgt
    point (inf where tgt is empty)."""
    if len(tgt) == 0:
        return np.full(len(src), np.inf, np.float32)
    tree = cKDTree(tgt[:, :3])
    d, _ = tree.query(src[:, :3], k=1, workers=-1)
    return d.astype(np.float32)


class ChamferDistance:
    def __init__(self):
        self.dists: list[float] = []

    def update(self, gt: np.ndarray, pred: np.ndarray):
        d_p2g = nn_distance(pred, gt).mean()
        d_g2p = nn_distance(gt, pred).mean()
        self.dists.append((d_p2g + d_g2p) / 2.0)

    def reset(self):
        self.dists = []

    def compute(self):
        d = np.array(self.dists)
        return float(d.mean()), float(d.std())


class RMSE:
    def __init__(self):
        self.dists: list[float] = []

    def update(self, gt: np.ndarray, pred: np.ndarray):
        self.dists.append(float(nn_distance(pred, gt).mean()))

    def reset(self):
        self.dists = []

    def compute(self):
        d = np.array(self.dists)
        return float(d.mean()), float(d.std())


def occupied_bins(points: np.ndarray, bins: int, r: float) -> np.ndarray:
    """Sorted flat indices of the occupied bins of
    `np.histogramdd(points[:, :3], bins, range=[[-r, r]] * 3)`: the edges
    are `np.linspace(-r, r, bins + 1)`, a coordinate goes to
    `searchsorted(edges, x, side="right") - 1`, one on the right edge r to
    the last bin, and a point outside [-r, r] in any axis to none."""
    edges = np.linspace(-r, r, bins + 1)
    keep = np.ones(len(points), bool)
    idx = []
    for d in range(3):
        x = points[:, d]
        i = np.searchsorted(edges, x, side="right")
        i[x == edges[-1]] -= 1
        keep &= (i >= 1) & (i <= bins)
        idx.append(i - 1)
    flat = np.ravel_multi_index(tuple(i[keep] for i in idx), (bins,) * 3)
    return np.unique(flat)


class CompletionIoU:
    """Occupancy IoU accumulated over scans at several voxel sizes."""

    def __init__(self, voxel_sizes=(0.5, 0.2, 0.1), max_range: float = 50.0):
        self.voxel_sizes = list(voxel_sizes)
        self.max_range = max_range
        self.conf = np.zeros((len(self.voxel_sizes), 3), np.uint64)

    def update(self, gt: np.ndarray, pred: np.ndarray):
        r = self.max_range
        for i, vs in enumerate(self.voxel_sizes):
            bins = int(2 * r / vs)
            b_gt = occupied_bins(gt, bins, r)
            b_pr = occupied_bins(pred, bins, r)
            tp = len(np.intersect1d(b_gt, b_pr, assume_unique=True))
            self.conf[i][0] += np.uint64(tp)                    # tp
            self.conf[i][1] += np.uint64(len(b_gt) - tp)        # fn
            self.conf[i][2] += np.uint64(len(b_pr) - tp)        # fp

    def compute(self) -> dict:
        out = {}
        for i, vs in enumerate(self.voxel_sizes):
            tp, fn, fp = (float(x) for x in self.conf[i])
            out[vs] = tp / (tp + fn + fp + 1e-15)
        return out

    def reset(self):
        self.conf = np.zeros((len(self.voxel_sizes), 3), np.uint64)


class PrecisionRecall:
    def __init__(self, min_t: float, max_t: float, num: int):
        self.thresholds = np.linspace(min_t, max_t, num)
        self.reset()

    def reset(self):
        self.pr = [[] for _ in self.thresholds]
        self.re = [[] for _ in self.thresholds]
        self.f1 = [[] for _ in self.thresholds]

    def update(self, gt: np.ndarray, pred: np.ndarray):
        d_p2g = nn_distance(pred, gt)     # precision direction
        d_g2p = nn_distance(gt, pred)     # recall direction
        for i, t in enumerate(self.thresholds):
            p = 100.0 * (d_p2g < t).sum() / len(d_p2g)
            r = 100.0 * (d_g2p < t).sum() / len(d_g2p)
            f = 0.0 if (p == 0 or r == 0) else 2 * p * r / (p + r)
            self.pr[i].append(p)
            self.re[i].append(r)
            self.f1[i].append(f)

    def compute_at_all_thresholds(self):
        pr = [float(np.mean(v)) for v in self.pr]
        re = [float(np.mean(v)) for v in self.re]
        f1 = [float(np.mean(v)) for v in self.f1]
        return pr, re, f1

    def compute_auc(self):
        dx = self.thresholds[1] - self.thresholds[0]
        perfect = integrate.simpson(np.ones_like(self.thresholds), dx=dx)
        pr, re, f1 = self.compute_at_all_thresholds()
        return (float(integrate.simpson(pr, dx=dx) / perfect),
                float(integrate.simpson(re, dx=dx) / perfect),
                float(integrate.simpson(f1, dx=dx) / perfect))

    def compute_at_threshold(self, threshold: float):
        i = int(np.abs(self.thresholds - threshold).argmin())
        pr = float(np.mean(self.pr[i]))
        re = float(np.mean(self.re[i]))
        f1 = float(np.mean(self.f1[i]))
        return pr, re, f1, float(self.thresholds[i])
